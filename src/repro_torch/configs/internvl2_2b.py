"""internvl2-2b [vlm] — InternViT (stub frontend) + InternLM2 backbone.
[arXiv:2404.16821]

The ViT vision encoder and projector are a stub, as in the reference: the
batch carries precomputed patch embeddings (batch, n_prefix_embeds,
d_model), prepended to the token stream.
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, register

ARCH = register(ArchConfig(
    name="internvl2-2b",
    arch_type="vlm",
    source="arXiv:2404.16821",
    n_layers=24,
    d_model=2048,
    d_ff=8192,
    vocab=92553,
    attn=AttnConfig(n_heads=16, n_kv_heads=8, head_dim=128),
    modality="vision_stub",
    n_prefix_embeds=256,              # one 448x448 tile -> 256 patch tokens
    mlp_act="silu",
    norm="rmsnorm",
))
