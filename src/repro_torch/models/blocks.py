"""Pre-norm residual blocks (``attn_dense`` of ``repro/models/blocks.py``).

``init_block`` builds the params of ``count`` stacked blocks (leading
``count`` axis on every leaf, the reference's vmapped init); ``block_apply``
runs one block from its unstacked params.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import BLOCK_ATTN_DENSE
from repro_torch.models import layers


def init_block(gen, count: int, cfg, kind: str, dtype, device) -> dict:
    if kind != BLOCK_ATTN_DENSE:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    d = cfg.d_model

    def norm():
        return {k: v.expand(count, d).clone() for k, v in
                layers.init_norm(d, cfg.norm, dtype, device).items()}

    return {"norm1": norm(), "norm2": norm(),
            "attn": layers.init_attention(gen, count, cfg, d, dtype, device),
            "mlp": layers.init_mlp(gen, count, d, cfg.d_ff, cfg.gated_mlp,
                                   dtype, device)}


def block_apply(p: dict, cfg, x: torch.Tensor, positions, *,
                layer_is_local: bool = False) -> torch.Tensor:
    h = layers.norm_apply(p["norm1"], x, cfg.norm)
    x = x + layers.attention_apply(p["attn"], cfg, h,
                                   layer_is_local=layer_is_local,
                                   positions=positions)
    h = layers.norm_apply(p["norm2"], x, cfg.norm)
    return x + layers.mlp_apply(p["mlp"], h, cfg.mlp_act, cfg.gated_mlp)
