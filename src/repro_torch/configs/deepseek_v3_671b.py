"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437]  Copied from ``repro/configs/deepseek_v3_671b.py``.

``ONE_CHIP`` is what one H100 holds of a DeepSeek-V3 training deployment
(the configuration the port trains on one card; not registered, so the
registry keeps the published model alone).  The deployment is DeepSeek-V3's
own expert parallelism over 64 chips (arXiv:2412.19437 §3.2: 64-way EP
across 8 nodes), with the vocabulary split over 8 chips as a vocab-parallel
embedding and head split it (assumed: the paper does not say how its
embedding and head are divided).  One chip holds 4 of each MoE layer's 256
routed experts (shard 0 of 64) and an eighth of the vocabulary; the layers
left out would lie on further chips, as the stages of a pipeline.  Every
width is as published (d_model 7168, d_ff 18432, q_lora 1536, kv_lora 512,
128 heads, qk 128 + 64, v 128, expert d_ff 2048, 256 router outputs,
top-8, 1 shared expert, MTP on).  ``ONE_CHIP_REDUCED`` lists each key
changed, as [published, here]:

  * n_layers 61 -> 2 and n_dense_prefix 3 -> 1: one whole period, the
    leading dense layers counted once (one dense MLA layer, then one
    MLA-MoE layer), and the MTP block;
  * vocab 129280 -> 16160: this chip's eighth; the data draws its ids from
    the slice and the logits and the loss are over it;
  * routed experts held 256 -> 4 (``MoEConfig.expert_shards`` 64, shard
    0): the router still routes over all 256 and its aux loss is the whole
    routing's; assignments to the other 252 are computed on other chips.

That is ~1.81 B parameters: embedding and head 0.23 B, the dense MLA layer
0.58 B, the MoE layer 0.41 B (attention 0.19 B, router, shared expert and
4 experts), the MTP block 0.58 B (an ``mla_dense`` block).  At the port's
training state (bf16 params, f32 master, Adam's two moments, an f32
gradient accumulator: ~18-20 bytes a parameter) ~36 GB.  The whole model
does not fit: one dense layer with the MTP block and the full vocabulary
is already over 80 GB of such state.
"""
import dataclasses

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

EP_SHARDS = 64                        # experts over 64 chips (EP-64)
VOCAB_SHARDS = 8                      # vocabulary over 8 chips

ONE_CHIP = dataclasses.replace(
    ARCH, n_layers=2, n_dense_prefix=1, vocab=ARCH.vocab // VOCAB_SHARDS,
    moe=dataclasses.replace(ARCH.moe, expert_shards=EP_SHARDS,
                            expert_shard=0))

ONE_CHIP_REDUCED = {
    "n_layers": [ARCH.n_layers, ONE_CHIP.n_layers],
    "n_dense_prefix": [ARCH.n_dense_prefix, ONE_CHIP.n_dense_prefix],
    "vocab": [ARCH.vocab, ONE_CHIP.vocab],
    "experts_held": [ARCH.moe.n_experts, ONE_CHIP.moe.experts_held],
}
