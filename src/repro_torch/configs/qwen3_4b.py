"""qwen3-4b [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-8B]  Copied from
``repro/configs/qwen3_4b.py``."""
from repro_torch.configs.base import ArchConfig, AttnConfig, register

ARCH = register(ArchConfig(
    name="qwen3-4b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=36,
    d_model=2560,
    d_ff=9728,
    vocab=151936,
    attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                    qk_norm=True, rope_theta=1_000_000.0),
    mlp_act="silu",
    norm="rmsnorm",
))
