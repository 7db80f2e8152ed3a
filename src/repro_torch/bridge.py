"""Conversion between the flat ``{keystr: np.ndarray}`` format and the
port's trees of tensors.

The flat format is what ``repro/checkpoint/persistent._flatten`` writes:
one array per leaf, keyed by its ``jax.tree_util.keystr`` path, e.g.
``"['segments'][0][0]['attn']['wq']"``.  Key strings are parsed here, with
no JAX.  bf16 arrives either as ``ml_dtypes.bfloat16`` (a live JAX array)
or as raw 2-byte ``|V2`` records (an ``.npz`` archive); both are
reinterpreted bit for bit through a 16-bit integer view, so the round trip
is exact.  The port writes bf16 as ``|V2``, the format ``np.savez`` gives
JAX's bf16.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Union

import numpy as np
import torch

from repro_torch import tree

_TOKEN = re.compile(r"\[('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"|\d+)\]"
                    r"|\.([A-Za-z_]\w*)")
_BF16_RAW = np.dtype("V2")


def parse_keystr(key: str) -> List[Union[str, int]]:
    """``"['a'][0].b"`` -> ``['a', 0, 'b']``."""
    out: List[Union[str, int]] = []
    pos = 0
    while pos < len(key):
        m = _TOKEN.match(key, pos)
        if m is None:
            raise ValueError(f"cannot parse key path {key!r} at {pos}")
        item, attr = m.groups()
        if attr is not None:
            out.append(attr)
        elif item[0] in "'\"":
            out.append(item[1:-1])
        else:
            out.append(int(item))
        pos = m.end()
    return out


def _is_bf16_bits(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16" or arr.dtype == _BF16_RAW


def to_tensor(arr: np.ndarray, dtype: torch.dtype = None,
              device="cpu") -> torch.Tensor:
    """One flat-format array as a tensor.  bf16 bits (``ml_dtypes`` or
    ``|V2``) become bf16 exactly; ``dtype`` casts otherwise."""
    arr = np.asarray(arr)
    if _is_bf16_bits(arr):
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a flat-format array (bf16 as ``|V2`` records)."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RAW)
    return t.numpy()


def from_flat(flat: Dict[str, np.ndarray], device="cpu") -> Any:
    """Nested dicts/lists of tensors from the flat format.  Dict keys and
    NamedTuple fields both become dict keys; list indices must be dense."""
    root: Dict = {}
    for key, arr in flat.items():
        path = parse_keystr(key)
        node = root
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = to_tensor(arr, device=device)

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            if sorted(node) != list(range(len(node))):
                raise ValueError(f"sparse list indices {sorted(node)}")
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def to_flat(t: Any) -> Dict[str, np.ndarray]:
    """The inverse of ``from_flat``: ``{keystr: np.ndarray}`` in JAX's leaf
    order."""
    return {k: to_numpy(v) for k, v in tree.leaves_with_path(t)}


EXPERT_LEAVES = ("w_in", "w_gate", "w_out")


def expert_share(flat: Dict[str, np.ndarray], n_shards: int,
                 shard: int) -> Dict[str, np.ndarray]:
    """The flat params with each MoE layer's routed-expert leaves
    (``['moe']['w_in' | 'w_gate' | 'w_out']``, experts on axis -3) cut to
    the contiguous block of ``n_experts // n_shards`` experts that shard
    ``shard`` holds (``MoEConfig.expert_shards`` / ``expert_shard``), so
    that a reference's whole layer and the port's share of it start from
    the same weights.  Every other leaf, the router and the shared expert
    included, is passed on as it is."""
    out = {}
    for key, arr in flat.items():
        path = parse_keystr(key)
        if len(path) >= 2 and path[-2] == "moe" and path[-1] in EXPERT_LEAVES:
            n = arr.shape[-3]
            if n % n_shards:
                raise ValueError(f"{key}: {n} experts over {n_shards} shards")
            held = n // n_shards
            arr = arr[..., shard * held:(shard + 1) * held, :, :]
        out[key] = arr
    return out
