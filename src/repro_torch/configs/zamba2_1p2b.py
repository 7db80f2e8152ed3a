"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block.
[arXiv:2411.15242]  Copied from ``repro/configs/zamba2_1p2b.py``.

Zamba2 interleaves Mamba2 layers with a *shared* (weight-tied) attention
block invoked periodically; the shared attention+MLP block runs after every
``shared_period`` mamba layers, matching the 1.2B model's 6-layer period.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, SSMConfig, register

ARCH = register(ArchConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    n_layers=38,
    d_model=2048,
    d_ff=8192,
    vocab=32000,
    attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=64),
    ssm=SSMConfig(d_state=64, head_dim=64),
    shared_period=6,
    mlp_act="gelu",
    norm="rmsnorm",
))
