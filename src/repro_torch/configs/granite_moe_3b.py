"""granite-moe-3b-a800m [moe] — 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]  Copied from
``repro/configs/granite_moe_3b.py``."""
from repro_torch.configs.base import (ArchConfig, AttnConfig, MoEConfig,
                                      register)

ARCH = register(ArchConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=32,
    d_model=1536,
    d_ff=512,
    vocab=49155,
    attn=AttnConfig(n_heads=24, n_kv_heads=8, head_dim=64),
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
    mlp_act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
))
