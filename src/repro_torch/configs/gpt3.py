"""GPT-3 family — the paper's own workloads (Section 7.1).  Copied from
``repro/configs/gpt3.py``; shapes follow Brown et al. 2020 table 2.1.

The port's planner slice feeds these to the cost model
(``core/costmodel.TaskModel.from_arch``); the model path runs them as any
dense config (LayerNorm, the GELU MLP, a tied embedding), and at a model
axis of 16 gpt3-13b's 40 heads split in uneven blocks
(``sharding.rules.head_block``).
"""
from repro_torch.configs.base import ArchConfig, AttnConfig, register


def _gpt3(name, n_layers, d_model, n_heads):
    return register(ArchConfig(
        name=name,
        arch_type="dense",
        source="arXiv:2005.14165",
        n_layers=n_layers,
        d_model=d_model,
        d_ff=4 * d_model,
        vocab=50257,
        attn=AttnConfig(n_heads=n_heads, n_kv_heads=n_heads,
                        head_dim=d_model // n_heads),
        mlp_act="gelu",
        gated_mlp=False,
        norm="layernorm",
        tie_embeddings=True,
    ))


GPT3_1P3B = _gpt3("gpt3-1.3b", 24, 2048, 16)
GPT3_7B = _gpt3("gpt3-7b", 32, 4096, 32)
GPT3_13B = _gpt3("gpt3-13b", 40, 5120, 40)
GPT3_70B = _gpt3("gpt3-70b", 80, 8192, 64)
GPT3_175B = _gpt3("gpt3-175b", 96, 12288, 96)

GPT3_SIZES = {
    "1.3B": GPT3_1P3B, "7B": GPT3_7B, "13B": GPT3_13B,
    "70B": GPT3_70B, "175B": GPT3_175B,
}
