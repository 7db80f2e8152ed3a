"""Pre-norm residual blocks (``attn_dense``, ``attn_moe``, ``mla_dense``,
``mla_moe``, ``mamba`` and ``hybrid_shared`` of ``repro/models/blocks.py``),
and zamba2's weight-tied shared attention+MLP block.

``init_block`` builds the params of ``count`` stacked blocks (leading
``count`` axis on every leaf, the reference's vmapped init); ``block_apply``
runs one block from its unstacked params and returns its router aux loss
(``None`` for a block without MoE).  ``block_cache`` and ``block_decode``
are the serving path's per-layer cache and one-token step; decode drops
the aux loss, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.configs.base import (BLOCK_ATTN_DENSE, BLOCK_ATTN_MOE,
                                      BLOCK_HYBRID_SHARED, BLOCK_MAMBA,
                                      BLOCK_MLA_DENSE, BLOCK_MLA_MOE)
from repro_torch.models import layers, mla, moe, ssm
from repro_torch.sharding import collectives, rules

_MAMBA_KINDS = (BLOCK_MAMBA, BLOCK_HYBRID_SHARED)
_MLA_KINDS = (BLOCK_MLA_DENSE, BLOCK_MLA_MOE)
_ATTN_KINDS = (BLOCK_ATTN_DENSE, BLOCK_ATTN_MOE) + _MLA_KINDS


# ``has_attn``, ``has_mla`` and ``has_moe``: copied from
# repro/models/blocks.py:23-31
def has_attn(kind: str) -> bool:
    return kind in (BLOCK_ATTN_DENSE, BLOCK_ATTN_MOE)


def has_mla(kind: str) -> bool:
    return kind in (BLOCK_MLA_DENSE, BLOCK_MLA_MOE)


def has_moe(kind: str) -> bool:
    return kind in (BLOCK_ATTN_MOE, BLOCK_MLA_MOE)


def _refuse_unknown(kind: str) -> None:
    if kind not in _ATTN_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")


def _stacked_norm(count: int, cfg, dtype, device) -> dict:
    d = cfg.d_model
    return {k: v.expand(count, d).clone() for k, v in
            layers.init_norm(d, cfg.norm, dtype, device).items()}


def _attn_mlp(gen, count: int, cfg, dtype, device,
              kind: str = BLOCK_ATTN_DENSE) -> dict:
    d = cfg.d_model
    p = {"norm1": _stacked_norm(count, cfg, dtype, device),
         "norm2": _stacked_norm(count, cfg, dtype, device),
         "attn": mla.init_mla(gen, count, cfg, dtype, device)
         if kind in _MLA_KINDS
         else layers.init_attention(gen, count, cfg, d, dtype, device)}
    if kind in (BLOCK_ATTN_MOE, BLOCK_MLA_MOE):
        p["moe"] = moe.init_moe(gen, count, cfg, dtype, device)
    else:
        p["mlp"] = layers.init_mlp(gen, count, d, cfg.d_ff, cfg.gated_mlp,
                                   dtype, device)
    return p


def init_block(gen, count: int, cfg, kind: str, dtype, device) -> dict:
    if kind in _MAMBA_KINDS:
        return {"norm": _stacked_norm(count, cfg, dtype, device),
                "mamba": ssm.init_mamba(gen, count, cfg, dtype, device)}
    _refuse_unknown(kind)
    return _attn_mlp(gen, count, cfg, dtype, device, kind)


def init_shared_block(gen, cfg, dtype, device) -> dict:
    """zamba2's weight-tied attention+MLP block (one copy, no stack axis)."""
    return tree.tree_map(lambda t: t[0],
                         _attn_mlp(gen, 1, cfg, dtype, device))


def block_apply(p: dict, cfg, kind: str, x: torch.Tensor, positions, *,
                layer_is_local: bool = False, groups=None):
    """Returns (x, aux): aux the MoE router's loss, ``None`` without MoE.
    With a mesh's ``groups`` (``sharding.collectives.MeshGroups``), ``p``
    holds this model rank's compute shards and each module is
    tensor-parallel where the rules split it: attention
    (``sharding.rules.attention_splits``, ``layers.attention_apply``), MLA
    (``mla_splits``, ``mla.mla_apply``), Mamba2 (``mamba_splits``,
    ``ssm.mamba_apply``), the MLP (``mlp_splits``, ``layers.mlp_apply``)
    and the MoE FFN, expert-parallel where its experts divide the model
    axis (``experts_split``, ``moe.moe_apply_ep``), else split over d_ff
    where that divides it (``expert_ffn_splits``, ``moe.moe_apply_dff``);
    a module the rules do not split computes whole.

    Under sequence parallelism (``groups.seqpar``) x is this rank's block
    of the sequence (``positions`` the whole sequence's): the norms and the
    residual adds run on the block, a split module gathers the sequence on
    entry and leaves by a reduce-scatter over it, and a module computed
    whole runs on the gathered sequence (``_whole``)."""
    n = _n_model(groups)
    if kind in _MAMBA_KINDS:
        h = layers.norm_apply(p["norm"], x, cfg.norm)
        return x + _module(groups, rules.mamba_splits(cfg, n), lambda h, g:
                           ssm.mamba_apply(p["mamba"], cfg, h, groups=g),
                           h), None
    h = layers.norm_apply(p["norm1"], x, cfg.norm)
    if kind in _MLA_KINDS:
        y = _module(groups, rules.mla_splits(cfg, n), lambda h, g:
                    mla.mla_apply(p["attn"], cfg, h, positions, groups=g), h)
    else:
        y = _module(groups, rules.attention_splits(cfg, n), lambda h, g:
                    layers.attention_apply(p["attn"], cfg, h,
                                           layer_is_local=layer_is_local,
                                           positions=positions, groups=g),
                    h)
    x = x + y
    h = layers.norm_apply(p["norm2"], x, cfg.norm)
    y, aux = _ffn(p, cfg, h, groups)
    return x + y, aux


def _module(groups, split: bool, fn, h: torch.Tensor) -> torch.Tensor:
    """``fn(h, g)``, one module of a block on its normed input ``h``: with
    ``g = groups`` where the rules ``split`` it (it enters and leaves
    through ``collectives.enter_region`` / ``leave_region``), else with
    ``g = None``, computed whole (``_whole``)."""
    if split:
        return fn(h, groups)
    return _whole(groups, lambda h: (fn(h, None), None), h)[0]


def _whole(groups, fn, h: torch.Tensor):
    """``fn(h)`` -> (y, aux) of a module computed whole, alike on every
    model rank.  Under ``groups.seqpar`` ``h`` is this rank's block of the
    sequence: the module runs on the sequence gathered over the model axis
    (whose gradient, whole and alike on every rank, gives this rank its
    block) and this rank takes its block of y (whose gradient the ranks
    gather)."""
    if groups is None or not groups.seqpar:
        return fn(h)
    model = groups.model_group
    y, aux = fn(collectives.gather_from_sequence(h, model, "block",
                                                 groups.seq_len))
    return collectives.scatter_to_sequence(y, model), aux


def _ffn(p: dict, cfg, h: torch.Tensor, groups=None):
    """The block's feed-forward: (y, aux), the MoE FFN's router loss or
    ``None`` for the dense MLP."""
    n = _n_model(groups)
    if "moe" in p:
        if groups is not None and rules.experts_split(cfg, n):
            return moe.moe_apply_ep(p["moe"], cfg, h, groups)
        if rules.expert_ffn_splits(cfg, n):
            return moe.moe_apply_dff(p["moe"], cfg, h, groups)
        return _whole(groups, lambda h: moe.moe_apply(p["moe"], cfg, h), h)
    return _module(groups, rules.mlp_splits(cfg, n), lambda h, g:
                   layers.mlp_apply(p["mlp"], h, cfg.mlp_act,
                                    cfg.gated_mlp, groups=g), h), None


def _n_model(groups) -> int:
    return 1 if groups is None else groups.n_model


def shared_block_apply(p: dict, cfg, x: torch.Tensor, positions, *,
                       layer_is_local: bool = False,
                       groups=None) -> torch.Tensor:
    """Attention + MLP (``attn_dense``'s body; zamba2's shared block runs it
    with global attention)."""
    return block_apply(p, cfg, BLOCK_ATTN_DENSE, x, positions,
                       layer_is_local=layer_is_local, groups=groups)[0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def block_cache(cfg, kind: str, batch: int, capacity: int, dtype, device,
                layer_is_local: bool = False) -> dict:
    """Zero decode cache of one layer: the Mamba2 state, MLA's latent
    buffers ({"ckv", "k_rope"}) or K/V buffers of ``capacity`` slots
    (``min(capacity, window)`` for a local layer)."""
    if kind in _MAMBA_KINDS:
        return ssm.mamba_init_state(cfg, batch, dtype, device)
    _refuse_unknown(kind)
    if kind in _MLA_KINDS:
        return mla.mla_init_cache(cfg, batch, capacity, dtype, device)
    a = cfg.attn
    cap = min(capacity, a.window) if (layer_is_local and a.window) \
        else capacity
    shape = (batch, cap, a.n_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def block_decode(p: dict, cfg, kind: str, x: torch.Tensor, cache: dict, pos,
                 *, layer_is_local: bool = False, groups=None,
                 capacity_groups=None, slot_offset: int = 0):
    """One-token decode.  x: (B,1,d).  Returns (x, new_cache).  With a
    mesh's ``groups``, ``p`` holds this model rank's compute shards and
    ``cache`` its cache shards, and each module is tensor-parallel where
    ``block_apply`` splits it, under the same rules; ``capacity_groups``
    and ``slot_offset`` say how the attention or MLA cache's slots are
    split (``layers.attention_decode``)."""
    n = _n_model(groups)
    if kind in _MAMBA_KINDS:
        h = layers.norm_apply(p["norm"], x, cfg.norm)
        split = rules.mamba_splits(cfg, n)
        y, new = ssm.mamba_decode(p["mamba"], cfg, h, cache,
                                  groups=groups if split else None)
        return x + y, new
    _refuse_unknown(kind)
    h = layers.norm_apply(p["norm1"], x, cfg.norm)
    if kind in _MLA_KINDS:
        split = rules.mla_splits(cfg, n)
        y, new = mla.mla_decode(p["attn"], cfg, h, cache, pos,
                                groups=groups if split else None,
                                capacity_groups=capacity_groups,
                                slot_offset=slot_offset)
    else:
        split = rules.attention_splits(cfg, n)
        y, nk, nv = layers.attention_decode(
            p["attn"], cfg, h, cache["k"], cache["v"], pos,
            layer_is_local=layer_is_local, groups=groups if split else None,
            capacity_groups=capacity_groups, slot_offset=slot_offset)
        new = {"k": nk, "v": nv}
    x = x + y
    h = layers.norm_apply(p["norm2"], x, cfg.norm)
    return x + _ffn(p, cfg, h, groups)[0], new


def shared_block_decode(p: dict, cfg, x: torch.Tensor, cache: dict, pos, *,
                        layer_is_local: bool = False, groups=None,
                        capacity_groups=None, slot_offset: int = 0):
    """The attention blocks' one-token step (zamba2's shared block runs it
    with global attention).  Returns (x, {"k", "v"})."""
    return block_decode(p, cfg, BLOCK_ATTN_DENSE, x, cache, pos,
                        layer_is_local=layer_is_local, groups=groups,
                        capacity_groups=capacity_groups,
                        slot_offset=slot_offset)
