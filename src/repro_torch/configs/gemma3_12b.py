"""gemma3-12b [dense] — 5:1 local:global sliding window, 128k context.
[hf:google/gemma-3-1b-pt]  Copied from ``repro/configs/gemma3_12b.py``."""
from repro_torch.configs.base import ArchConfig, AttnConfig, register

ARCH = register(ArchConfig(
    name="gemma3-12b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=48,
    d_model=3840,
    d_ff=15360,
    vocab=262144,
    attn=AttnConfig(n_heads=16, n_kv_heads=8, head_dim=256,
                    qk_norm=True, window=1024, local_ratio=(5, 1),
                    rope_theta=1_000_000.0),
    mlp_act="gelu",
    norm="rmsnorm",
    tie_embeddings=True,
    embed_scale=True,
))
