from repro_torch.configs.base import (ArchConfig, AttnConfig, SSMConfig,
                                     get_arch, register)

__all__ = ["ArchConfig", "AttnConfig", "SSMConfig", "get_arch", "register"]
