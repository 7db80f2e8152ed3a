"""Architecture configs for the port (own copy of ``repro/configs/base.py``,
trimmed to the dense decoder this slice runs).

The fields, ``block_pattern``, ``param_count`` and ``reduced()`` match the
reference for dense archs, so a config built here describes the same model
as its ``repro`` namesake.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

BLOCK_ATTN_DENSE = "attn_dense"        # attention + dense MLP

# Features of the reference that later slices of the port bring.
_LATER = {
    "moe": "the MoE slice",
    "ssm": "the Mamba2/SSD slice",
    "mla": "the MLA slice",
}


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
    arch_type: str                     # dense (this slice)
    source: str                        # citation for the config numbers
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    attn: AttnConfig = None
    moe: object = None
    ssm: object = None
    mla: object = None
    mlp_act: str = "silu"              # silu (SwiGLU) | gelu (GeGLU)
    gated_mlp: bool = True             # False = classic 2-matrix MLP (GPT-3)
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    tie_embeddings: bool = False
    modality: str = "text"
    embed_scale: bool = False          # gemma: scale embeddings by sqrt(d)
    param_dtype: str = "bfloat16"

    def __post_init__(self):
        for feat, slice_name in _LATER.items():
            if getattr(self, feat) is not None:
                raise NotImplementedError(
                    f"{self.name}: {feat} arrives with {slice_name} of the "
                    f"port")
        if self.arch_type in ("ssm", "hybrid"):
            raise NotImplementedError(
                f"{self.name}: {self.arch_type} arrives with the Mamba2/SSD "
                f"slice of the port")
        if self.modality != "text":
            raise NotImplementedError(
                f"{self.name}: modality {self.modality!r} arrives with the "
                f"modality-stub slice of the port")

    @property
    def block_pattern(self) -> Tuple[Tuple[str, int], ...]:
        return ((BLOCK_ATTN_DENSE, self.n_layers),)

    def param_count(self) -> int:
        """Parameter count N, as the reference counts it."""
        d, a = self.d_model, self.attn
        n = self.vocab * d
        if not self.tie_embeddings:
            n += self.vocab * d
        attn = d * a.n_heads * a.head_dim + 2 * d * a.n_kv_heads * a.head_dim \
            + a.n_heads * a.head_dim * d
        mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
        n += self.n_layers * (attn + mlp + 2 * d)
        return n + d

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant: 2 layers, d_model<=256, float32."""
        a = self.attn
        nh = min(a.n_heads, 4)
        nkv = max(1, min(a.n_kv_heads, nh))
        if a.n_kv_heads < a.n_heads:
            nkv = max(1, nh * a.n_kv_heads // a.n_heads)
        attn = dataclasses.replace(
            a, n_heads=nh, n_kv_heads=nkv, head_dim=min(a.head_dim, 64),
            window=min(a.window, 64) if a.window else 0)
        return dataclasses.replace(
            self, n_layers=2, d_model=min(self.d_model, 256),
            d_ff=min(self.d_ff, 512), vocab=min(self.vocab, 1024), attn=attn,
            param_dtype="float32")


_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    from repro_torch.configs import gemma_2b, gpt3  # noqa: F401  (register)
    if name not in _REGISTRY:
        raise KeyError(f"{name!r} is not ported yet; ported: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]
