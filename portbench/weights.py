"""The model's weights, which the benchmark makes itself from ``--seed`` and
hands to both sides: the program gets them in its parameter tree
(``repro_torch.models.model``'s layout: per segment a list of slots whose
leaves carry a leading axis over the stacked layers), the reference gets
the same tensors by path.

The draws follow the port's initialisation conventions (normal scaled by
1/sqrt(fan_in), the embedding at 0.02, the conv at 1/sqrt(d_conv), norms
at 1, ``A_log`` and ``dt_bias`` at 0, ``D`` at 1) but are the benchmark's
own: every random leaf is a view into one buffer drawn by a single call of
a ``torch.Generator`` on the device, in the parameter dtype.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

F32 = torch.float32


@dataclass(frozen=True)
class Leaf:
    path: str                  # "segments/0/3/mamba/w_in"
    shape: Tuple[int, ...]
    std: float                 # 0: constant ``fill``
    fill: float = 0.0
    f32: bool = False          # kept in float32 whatever the param dtype


@dataclass(frozen=True)
class Segment:
    count: int                 # stacked layers of each slot
    inner: int                 # slots
    shared_after: bool         # zamba2's shared block after each period


def segments(cfg: dict) -> List[Segment]:
    """The port's segment plan for an ``ssm`` or ``hybrid`` model: one
    slot of ``n_layers`` Mamba2 layers, or periods of ``shared_period``
    slots followed by the shared block, then the remainder."""
    n = cfg["n_layers"]
    period = cfg.get("shared_period", 0)
    if cfg["arch_type"] == "ssm" or not period:
        return [Segment(n, 1, False)]
    period = min(period, n)
    groups, rem = divmod(n, period)
    out = [Segment(groups, period, True)] if groups else []
    if rem:
        out.append(Segment(1, rem, False))
    return out


def layer_order(cfg: dict):
    """(segment, slot, index, shared_after) of each Mamba2 layer in the
    order the forward runs them; ``shared_after`` is true on the last layer
    of a period that the shared block follows."""
    for s, seg in enumerate(segments(cfg)):
        for c in range(seg.count):
            for j in range(seg.inner):
                yield s, j, c, seg.shared_after and j == seg.inner - 1


def _dense(path, shape) -> Leaf:
    return Leaf(path, tuple(shape), 1.0 / math.sqrt(shape[-2]))


def spec(cfg: dict) -> List[Leaf]:
    d, s = cfg["d_model"], cfg["ssm"]
    di = s["expand"] * d
    H, N = di // s["head_dim"], s["d_state"]
    conv = di + 2 * N
    out = [Leaf("embed/w", (cfg["vocab"], d), 0.02)]
    for si, seg in enumerate(segments(cfg)):
        for j in range(seg.inner):
            p, n = f"segments/{si}/{j}", seg.count
            out += [Leaf(f"{p}/norm/scale", (n, d), 0.0, 1.0),
                    _dense(f"{p}/mamba/w_in", (n, d, 2 * di + 2 * N + H)),
                    Leaf(f"{p}/mamba/conv_w", (n, s["d_conv"], conv),
                         1.0 / math.sqrt(s["d_conv"])),
                    Leaf(f"{p}/mamba/conv_b", (n, conv), 0.0, 0.0),
                    Leaf(f"{p}/mamba/dt_bias", (n, H), 0.0, 0.0, True),
                    Leaf(f"{p}/mamba/A_log", (n, H), 0.0, 0.0, True),
                    Leaf(f"{p}/mamba/D", (n, H), 0.0, 1.0, True),
                    Leaf(f"{p}/mamba/gate_norm", (n, di), 0.0, 1.0),
                    _dense(f"{p}/mamba/w_out", (n, di, d))]
    if any(seg.shared_after for seg in segments(cfg)):
        a, ff = cfg["attn"], cfg["d_ff"]
        q, kv = a["n_heads"] * a["head_dim"], a["n_kv_heads"] * a["head_dim"]
        out += [Leaf("shared/norm1/scale", (d,), 0.0, 1.0),
                Leaf("shared/norm2/scale", (d,), 0.0, 1.0),
                _dense("shared/attn/wq", (d, q)), _dense("shared/attn/wk", (d, kv)),
                _dense("shared/attn/wv", (d, kv)), _dense("shared/attn/wo", (q, d)),
                _dense("shared/mlp/w_in", (d, ff)), _dense("shared/mlp/w_out", (ff, d))]
        if cfg.get("gated_mlp", True):
            out.append(_dense("shared/mlp/w_gate", (d, ff)))
    out.append(Leaf("final_norm/scale", (d,), 0.0, 1.0))
    if not cfg.get("tie_embeddings", False):
        out.append(Leaf("head/w", (cfg["vocab"], d), 1.0 / math.sqrt(d)))
    return out


def make(cfg: dict, seed: int, device, dtype=None) -> Dict[str, torch.Tensor]:
    """path -> tensor.  The random leaves are views into one buffer drawn
    in ``dtype`` (default: the config's parameter dtype) by one call of a
    generator seeded with ``seed`` on ``device``, each scaled in place by
    its standard deviation; the constant leaves are filled."""
    dtype = dtype or getattr(torch, cfg["param_dtype"])
    leaves = spec(cfg)
    drawn = [leaf for leaf in leaves if leaf.std]
    total = sum(math.prod(leaf.shape) for leaf in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(total, generator=gen, dtype=dtype, device=device)
    out, at = {}, 0
    for leaf in drawn:
        n = math.prod(leaf.shape)
        out[leaf.path] = buf[at:at + n].view(leaf.shape).mul_(leaf.std)
        at += n
    for leaf in leaves:
        if not leaf.std:
            out[leaf.path] = torch.full(leaf.shape, leaf.fill,
                                        dtype=F32 if leaf.f32 else dtype,
                                        device=device)
    return {leaf.path: out[leaf.path] for leaf in leaves}


def to_tree(flat: Dict[str, torch.Tensor]):
    """The nested dicts and lists of the port's parameter tree."""
    root: dict = {}
    for path, t in flat.items():
        keys = path.split("/")
        node = root
        for k, nxt in zip(keys[:-1], keys[1:]):
            node = node.setdefault(k, {})
        node[keys[-1]] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """path -> leaf of a tree of ``to_tree``'s structure, dict keys in
    sorted order (as the port's ``tree`` orders them)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
    return out
