"""Pre-norm residual blocks (``attn_dense``, ``mamba`` and
``hybrid_shared`` of ``repro/models/blocks.py``), and zamba2's weight-tied
shared attention+MLP block.

``init_block`` builds the params of ``count`` stacked blocks (leading
``count`` axis on every leaf, the reference's vmapped init); ``block_apply``
runs one block from its unstacked params.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.configs.base import (BLOCK_ATTN_DENSE, BLOCK_HYBRID_SHARED,
                                      BLOCK_MAMBA)
from repro_torch.models import layers, ssm

_MAMBA_KINDS = (BLOCK_MAMBA, BLOCK_HYBRID_SHARED)


def _stacked_norm(count: int, cfg, dtype, device) -> dict:
    d = cfg.d_model
    return {k: v.expand(count, d).clone() for k, v in
            layers.init_norm(d, cfg.norm, dtype, device).items()}


def _attn_mlp(gen, count: int, cfg, dtype, device) -> dict:
    d = cfg.d_model
    return {"norm1": _stacked_norm(count, cfg, dtype, device),
            "norm2": _stacked_norm(count, cfg, dtype, device),
            "attn": layers.init_attention(gen, count, cfg, d, dtype, device),
            "mlp": layers.init_mlp(gen, count, d, cfg.d_ff, cfg.gated_mlp,
                                   dtype, device)}


def init_block(gen, count: int, cfg, kind: str, dtype, device) -> dict:
    if kind in _MAMBA_KINDS:
        return {"norm": _stacked_norm(count, cfg, dtype, device),
                "mamba": ssm.init_mamba(gen, count, cfg, dtype, device)}
    if kind != BLOCK_ATTN_DENSE:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    return _attn_mlp(gen, count, cfg, dtype, device)


def init_shared_block(gen, cfg, dtype, device) -> dict:
    """zamba2's weight-tied attention+MLP block (one copy, no stack axis)."""
    return tree.tree_map(lambda t: t[0],
                         _attn_mlp(gen, 1, cfg, dtype, device))


def block_apply(p: dict, cfg, kind: str, x: torch.Tensor, positions, *,
                layer_is_local: bool = False) -> torch.Tensor:
    if kind in _MAMBA_KINDS:
        h = layers.norm_apply(p["norm"], x, cfg.norm)
        return x + ssm.mamba_apply(p["mamba"], cfg, h)
    return shared_block_apply(p, cfg, x, positions,
                              layer_is_local=layer_is_local)


def shared_block_apply(p: dict, cfg, x: torch.Tensor, positions, *,
                       layer_is_local: bool = False) -> torch.Tensor:
    """Attention + MLP (``attn_dense``'s body; zamba2's shared block runs it
    with global attention)."""
    h = layers.norm_apply(p["norm1"], x, cfg.norm)
    x = x + layers.attention_apply(p["attn"], cfg, h,
                                   layer_is_local=layer_is_local,
                                   positions=positions)
    h = layers.norm_apply(p["norm2"], x, cfg.norm)
    return x + layers.mlp_apply(p["mlp"], h, cfg.mlp_act, cfg.gated_mlp)
