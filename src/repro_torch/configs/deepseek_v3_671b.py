"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437]  Copied from ``repro/configs/deepseek_v3_671b.py``."""
from repro_torch.configs.base import (ArchConfig, AttnConfig, MLAConfig,
                                      MoEConfig, register)

ARCH = register(ArchConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    source="arXiv:2412.19437",
    n_layers=61,
    d_model=7168,
    d_ff=18432,                       # dense-prefix layers' FFN width
    vocab=129280,
    attn=AttnConfig(n_heads=128, n_kv_heads=128, head_dim=128),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1),
    n_dense_prefix=3,
    mtp=True,
    mlp_act="silu",
    norm="rmsnorm",
))
