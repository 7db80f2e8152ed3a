from repro_torch.configs.base import (SHAPES, ArchConfig, AttnConfig,
                                     MLAConfig, MoEConfig, ShapeConfig,
                                     SSMConfig, get_arch, list_archs,
                                     register, supports_shape)

# the reference's order (repro/configs/__init__.py)
ASSIGNED_ARCHS = [
    "qwen3-4b", "zamba2-1.2b", "gemma3-12b", "deepseek-v3-671b",
    "granite-moe-3b-a800m", "mamba2-780m", "internvl2-2b", "gemma-2b",
    "hubert-xlarge", "granite-3-8b",
]
ALL_ARCHS = ASSIGNED_ARCHS + [
    "gpt3-1.3b", "gpt3-7b", "gpt3-13b", "gpt3-70b", "gpt3-175b"]

__all__ = ["ALL_ARCHS", "ASSIGNED_ARCHS", "ArchConfig", "AttnConfig",
           "MLAConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SHAPES",
           "get_arch", "list_archs", "register", "supports_shape"]
