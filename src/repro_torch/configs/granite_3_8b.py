"""granite-3-8b [dense] — GQA.  [hf:ibm-granite/granite-3.0-2b-base]
Copied from ``repro/configs/granite_3_8b.py``."""
from repro_torch.configs.base import ArchConfig, AttnConfig, register

ARCH = register(ArchConfig(
    name="granite-3-8b",
    arch_type="dense",
    source="hf:ibm-granite/granite-3.0-2b-base",
    n_layers=40,
    d_model=4096,
    d_ff=12800,
    vocab=49155,
    attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128),
    mlp_act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
))
