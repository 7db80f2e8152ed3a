"""gemma-2b [dense] — GeGLU, head_dim=256, MQA.  [arXiv:2403.08295]"""
from repro_torch.configs.base import ArchConfig, AttnConfig, register

ARCH = register(ArchConfig(
    name="gemma-2b",
    arch_type="dense",
    source="arXiv:2403.08295",
    n_layers=18,
    d_model=2048,
    d_ff=16384,
    vocab=256000,
    attn=AttnConfig(n_heads=8, n_kv_heads=1, head_dim=256),
    mlp_act="gelu",
    norm="rmsnorm",
    tie_embeddings=True,
    embed_scale=True,
))
