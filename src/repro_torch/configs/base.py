"""Architecture configs for the port (own copy of ``repro/configs/base.py``:
the dense, mixture-of-experts, MLA, Mamba2 (SSD) and zamba2-hybrid stacks
and the vision and audio stubs).

The fields, ``block_pattern``, ``param_count`` and ``reduced()`` match the
reference, so a config built here describes the same model as its
``repro`` namesake.  The four input shapes (train_4k / prefill_32k /
decode_32k / long_500k) are :class:`ShapeConfig` instances in ``SHAPES``;
``supports_shape`` says which (arch, shape) pairs run.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

BLOCK_ATTN_DENSE = "attn_dense"        # attention + dense MLP
BLOCK_ATTN_MOE = "attn_moe"            # attention + MoE FFN
BLOCK_MLA_DENSE = "mla_dense"          # MLA attention + dense MLP
BLOCK_MLA_MOE = "mla_moe"              # MLA attention + MoE FFN
BLOCK_MAMBA = "mamba"                  # Mamba2 SSD block
BLOCK_HYBRID_SHARED = "hybrid_shared"  # zamba2: mamba layers + shared attn


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (GShard/DeepSeek style).

    ``expert_shards`` and ``expert_shard`` are the port's own (the
    reference's ``MoEConfig`` has neither): the routed experts are divided
    over ``expert_shards`` chips in contiguous blocks of
    ``n_experts // expert_shards`` and this chip holds block
    ``expert_shard``, as expert parallelism divides them.  The router keeps
    all ``n_experts`` outputs; see ``models.moe``."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0          # DeepSeek shared experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01    # load-balance loss weight
    router_dtype: str = "float32"
    expert_shards: int = 1
    expert_shard: int = 0

    def __post_init__(self):
        if self.expert_shards < 1 or self.n_experts % self.expert_shards \
                or not 0 <= self.expert_shard < self.expert_shards:
            raise ValueError(f"{self.n_experts} experts do not divide into "
                             f"{self.expert_shards} shards with shard "
                             f"{self.expert_shard} among them")

    @property
    def experts_held(self) -> int:
        """The routed experts this chip holds."""
        return self.n_experts // self.expert_shards


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) settings."""

    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128                   # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention settings."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class AttnConfig:
    """Plain / GQA / MQA attention settings."""

    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False              # qwen3-style per-head RMSNorm on q,k
    causal: bool = True                # False for encoder-only (hubert)
    # window > 0 means local attention; ``local_ratio`` gives (local, global)
    # layers per period, e.g. gemma3's (5, 1).
    window: int = 0
    local_ratio: Tuple[int, int] = (0, 1)
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | vlm | audio
    source: str                        # citation for the config numbers
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: AttnConfig = None
    moe: MoEConfig = None
    ssm: SSMConfig = None
    mla: MLAConfig = None
    # dense-layer prefix before MoE layers (deepseek: first 3 dense)
    n_dense_prefix: int = 0
    # zamba2: shared attention block applied every `shared_period` layers
    shared_period: int = 0
    mlp_act: str = "silu"              # silu (SwiGLU) | gelu (GeGLU)
    gated_mlp: bool = True             # False = classic 2-matrix MLP (GPT-3)
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    tie_embeddings: bool = False
    encoder_only: bool = False         # hubert: no decode step
    modality: str = "text"             # text | vision_stub | audio_stub
    n_prefix_embeds: int = 0           # VLM patch / audio frame positions
    mtp: bool = False                  # DeepSeek multi-token-prediction head
    embed_scale: bool = False          # gemma: scale embeddings by sqrt(d)
    param_dtype: str = "bfloat16"

    @property
    def block_pattern(self) -> Tuple[Tuple[str, int], ...]:
        if self.arch_type == "ssm":
            return ((BLOCK_MAMBA, self.n_layers),)
        if self.arch_type == "hybrid":
            return ((BLOCK_HYBRID_SHARED, self.n_layers),)
        if self.moe is not None and self.mla is not None:
            return ((BLOCK_MLA_DENSE, self.n_dense_prefix),
                    (BLOCK_MLA_MOE, self.n_layers - self.n_dense_prefix))
        if self.moe is not None:
            return ((BLOCK_ATTN_DENSE, self.n_dense_prefix),
                    (BLOCK_ATTN_MOE, self.n_layers - self.n_dense_prefix))
        if self.mla is not None:
            return ((BLOCK_MLA_DENSE, self.n_layers),)
        return ((BLOCK_ATTN_DENSE, self.n_layers),)

    def param_count(self) -> int:
        """Parameter count N, as the reference counts it (of the experts,
        those held here: ``MoEConfig.experts_held``)."""
        return self._count(active_only=False)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        return self._count(active_only=True)

    def _count(self, active_only: bool) -> int:
        d = self.d_model
        n = self.vocab * d
        if not self.tie_embeddings:
            n += self.vocab * d
        for kind, count in self.block_pattern:
            n += count * self._block_params(kind, active_only)
        if self.shared_period:                # zamba2 shared attn+MLP block
            n += self._attn_params() + self._mlp_params(self.d_ff) + 2 * d
        return n + d

    def _attn_params(self) -> int:
        d, a = self.d_model, self.attn
        if self.mla is not None:
            m, h = self.mla, a.n_heads
            p = d * m.q_lora_rank
            p += m.q_lora_rank * h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            p += m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
            return p + h * m.v_head_dim * d
        return d * a.n_heads * a.head_dim + 2 * d * a.n_kv_heads * a.head_dim \
            + a.n_heads * a.head_dim * d

    def _mlp_params(self, d_ff: int) -> int:
        return (3 if self.gated_mlp else 2) * self.d_model * d_ff

    def _block_params(self, kind: str, active_only: bool = False) -> int:
        d = self.d_model
        if kind in (BLOCK_MAMBA, BLOCK_HYBRID_SHARED):
            # zamba2's per-layer params are the mamba block only; its shared
            # block is weight-tied and counted once (param_count)
            s = self.ssm
            di, nh = s.d_inner(d), s.n_heads(d)
            p = d * (2 * di + 2 * s.d_state + nh)     # in_proj: z,x,B,C,dt
            p += s.d_conv * (di + 2 * s.d_state)      # conv1d
            p += nh * 2 + di + di * d                 # A_log, D; gate norm; out
            return p + d                              # + pre-norm
        p = self._attn_params() + 2 * d
        if kind in (BLOCK_ATTN_MOE, BLOCK_MLA_MOE):
            m = self.moe
            n_exp = min(m.top_k, m.experts_held) if active_only \
                else m.experts_held
            p += (n_exp + m.n_shared_experts) * self._mlp_params(
                m.d_ff_expert)
            return p + d * m.n_experts                # + router
        return p + self._mlp_params(self.d_ff)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant: 2 layers, d_model<=256, <=4 experts,
        float32."""
        attn = None
        if self.attn is not None:
            a = self.attn
            nh = min(a.n_heads, 4)
            nkv = max(1, min(a.n_kv_heads, nh))
            if a.n_kv_heads < a.n_heads:
                nkv = max(1, nh * a.n_kv_heads // a.n_heads)
            attn = dataclasses.replace(
                a, n_heads=nh, n_kv_heads=nkv, head_dim=min(a.head_dim, 64),
                window=min(a.window, 64) if a.window else 0)
        moe = None
        if self.moe is not None:
            # capacity_factor 4.0: no token dropping at smoke scale, as in
            # the reference (capacity overflow is a train-scale behavior)
            m = self.moe
            moe = dataclasses.replace(
                m, n_experts=min(m.n_experts, 4), top_k=min(m.top_k, 2),
                d_ff_expert=min(m.d_ff_expert, 128),
                n_shared_experts=min(m.n_shared_experts, 1),
                capacity_factor=4.0)
        ssm = None
        if self.ssm is not None:
            s = self.ssm
            ssm = dataclasses.replace(
                s, d_state=min(s.d_state, 16), head_dim=min(s.head_dim, 32),
                chunk=16)
        mla = None
        if self.mla is not None:
            mla = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                            qk_nope_head_dim=32, qk_rope_head_dim=16,
                            v_head_dim=32)
        return dataclasses.replace(
            self, n_layers=2, d_model=min(self.d_model, 256),
            d_ff=min(self.d_ff, 512), vocab=min(self.vocab, 1024), attn=attn,
            moe=moe, ssm=ssm, mla=mla,
            n_dense_prefix=min(self.n_dense_prefix, 1),
            shared_period=2 if self.shared_period else 0,
            n_prefix_embeds=min(self.n_prefix_embeds, 8),
            param_dtype="float32")


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def supports_shape(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is runnable; returns (ok, reason-if-not).

    Encoder-only archs have no decode step.  ``long_500k`` decode requires
    sub-quadratic attention over the 524k context: SSM / hybrid always
    qualify; dense archs qualify only with a sliding-window variant
    (gemma3's native 5:1 local:global pattern)."""
    if shape.kind == "decode" and cfg.encoder_only:
        return False, "encoder-only architecture has no autoregressive decode"
    if shape.name == "long_500k":
        subquadratic = (
            cfg.arch_type in ("ssm", "hybrid")
            or (cfg.attn is not None and cfg.attn.window > 0)
        )
        if not subquadratic:
            return False, ("full-attention architecture without sliding-window "
                           "variant; 524k KV cache rules it out (DESIGN.md)")
    return True, ""


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load_all() -> None:
    from repro_torch.configs import (  # noqa: F401
        deepseek_v3_671b, gemma3_12b, gemma_2b, gpt3, granite_3_8b,
        granite_moe_3b, hubert_xlarge, internvl2_2b, mamba2_780m, qwen3_4b,
        zamba2_1p2b)


def get_arch(name: str) -> ArchConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"{name!r} is not ported yet; ported: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list:
    _load_all()
    return sorted(_REGISTRY)
