"""Shape-and-dtype stand-ins for every model input (port of
``repro/launch/inputs.py``).

``input_specs(cfg, shape, dp)`` returns the batch of a training step
(stacked micro-batches) or a prefill step, and ``decode_specs(model, cfg,
shape)`` the (caches, tokens, pos) of a serve step, as tensors on the
``meta`` device: they carry shapes and dtypes and allocate nothing.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig


def n_micro_for(shape: ShapeConfig, dp: int) -> int:
    """Micro-batch count: keep the per-DP-rank micro batch >= 1 while
    bounding per-step activation memory.  train_4k (B=256) -> 8 micro
    batches of 32 sequences."""
    if shape.kind != "train":
        return 1
    for n in (8, 4, 2, 1):
        mb = shape.global_batch // n
        if mb % dp == 0 and mb >= dp:
            return n
    return 1


def batch_struct(cfg: ArchConfig, batch: int, seq: int,
                 stacked_micro: int = 0) -> Dict[str, torch.Tensor]:
    """Stand-in batch dict for ``loss`` / ``forward``.  ``stacked_micro``
    > 0 prepends the micro-batch dim: (n_micro, batch, ...)."""
    lead = (stacked_micro,) if stacked_micro else ()

    def s(*dims, dtype=torch.int32):
        return torch.empty(lead + dims, dtype=dtype, device="meta")

    if cfg.modality == "audio_stub":
        return {"frames": s(batch, seq, cfg.d_model, dtype=torch.float32),
                "labels": s(batch, seq),
                "loss_mask": s(batch, seq, dtype=torch.float32)}
    out = {"tokens": s(batch, seq)}
    if cfg.modality == "vision_stub":
        out["prefix_embeds"] = s(batch, cfg.n_prefix_embeds, cfg.d_model,
                                 dtype=torch.float32)
    return out


def input_specs(cfg: ArchConfig, shape: ShapeConfig, dp: int) -> Dict:
    """Stand-in inputs for the train (stacked micro-batches) or prefill step
    of (cfg, shape)."""
    if shape.kind == "train":
        n = n_micro_for(shape, dp)
        return batch_struct(cfg, shape.global_batch // n, shape.seq_len,
                            stacked_micro=n)
    return batch_struct(cfg, shape.global_batch, shape.seq_len)


def decode_specs(model, cfg: ArchConfig, shape: ShapeConfig
                 ) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """(caches, tokens, pos) for one serve step of ``shape``: the caches of
    ``global_batch`` lanes and ``seq_len`` positions in the param dtype
    from ``model``'s config built on ``meta``, tokens (B,) int32 and a 0-dim
    int32 position."""
    from repro_torch.models.model import build_model
    meta = model if model.device.type == "meta" \
        else build_model(model.cfg, "meta")
    caches = meta.init_cache(shape.global_batch, shape.seq_len,
                             getattr(torch, cfg.param_dtype))
    tokens = torch.empty((shape.global_batch,), dtype=torch.int32,
                         device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return caches, tokens, pos
