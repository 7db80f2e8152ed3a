from repro_torch.configs.base import (ArchConfig, AttnConfig, MLAConfig,
                                     MoEConfig, SSMConfig, get_arch,
                                     register)

__all__ = ["ArchConfig", "AttnConfig", "MLAConfig", "MoEConfig", "SSMConfig",
           "get_arch", "register"]
