"""Persistent (remote-storage) checkpointing (port of
``repro/checkpoint/persistent.py``).

Trees are flattened to keystr-keyed ``ckpt_%08d.npz`` archives with a
``latest`` marker, the reference's format, so each package reads the
other's float32 checkpoints.  bf16 leaves are stored as raw ``|V2`` records
and read back bit for bit through a 16-bit view (``bridge.to_tensor``); the
reference's restore cannot read them (it casts ``|V2`` to bfloat16, which
numpy refuses).
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import bridge, tree


def save(directory: str, step: int, state: Any) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **bridge.to_flat(state))
    os.replace(tmp, path)
    with open(os.path.join(directory, "latest"), "w") as f:
        f.write(str(step))
    return path


def _scan_steps(directory: str) -> Optional[int]:
    """Newest complete archive on disk, ignoring in-flight ``.tmp.npz``
    leftovers from a writer that died mid-``save``."""
    best = None
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    for name in names:
        if not name.startswith("ckpt_") or not name.endswith(".npz"):
            continue
        if name.endswith(".tmp.npz"):
            continue
        stem = name[len("ckpt_"):-len(".npz")]
        if not stem.isdigit():
            continue
        step = int(stem)
        if best is None or step > best:
            best = step
    return best


def latest_step(directory: str) -> Optional[int]:
    """Crash-safe: the ``latest`` marker is written non-atomically after
    the archive, so a crash can leave it torn, empty, or pointing at a step
    whose archive never landed.  Any of those falls back to scanning for
    the newest complete archive."""
    marker = os.path.join(directory, "latest")
    try:
        with open(marker) as f:
            step = int(f.read().strip())
    except (OSError, ValueError):
        step = None
    if step is not None and os.path.exists(
            os.path.join(directory, f"ckpt_{step:08d}.npz")):
        return step
    return _scan_steps(directory)


def restore(directory: str, like: Any, step: Optional[int] = None) -> Any:
    """Restore into the structure, dtypes and devices of ``like``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        new = [bridge.to_tensor(data[key], leaf.dtype, leaf.device)
               for key, leaf in tree.leaves_with_path(like)]
    return tree.unflatten(like, new)


def checkpoint_nbytes(state: Any) -> int:
    """The bytes of every leaf of ``state`` (tensors, numpy arrays or
    scalars); copied from repro/checkpoint/persistent.py:98."""
    return sum(t.numel() * t.element_size() if isinstance(t, torch.Tensor)
               else np.asarray(t).nbytes for t in tree.leaves(state))
