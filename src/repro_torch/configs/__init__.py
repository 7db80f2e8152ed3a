from repro_torch.configs.base import (SHAPES, ArchConfig, AttnConfig,
                                     MLAConfig, MoEConfig, ShapeConfig,
                                     SSMConfig, get_arch, register,
                                     supports_shape)

__all__ = ["ArchConfig", "AttnConfig", "MLAConfig", "MoEConfig", "SSMConfig",
           "ShapeConfig", "SHAPES", "get_arch", "register", "supports_shape"]
