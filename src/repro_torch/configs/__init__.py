from repro_torch.configs.base import (ArchConfig, AttnConfig, get_arch,
                                     register)

__all__ = ["ArchConfig", "AttnConfig", "get_arch", "register"]
