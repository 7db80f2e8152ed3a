from repro_torch.configs.base import (ArchConfig, AttnConfig, MoEConfig,
                                     SSMConfig, get_arch, register)

__all__ = ["ArchConfig", "AttnConfig", "MoEConfig", "SSMConfig", "get_arch",
           "register"]
