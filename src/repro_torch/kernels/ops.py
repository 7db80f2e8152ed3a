"""Differentiable wrappers around the port's kernels (counterpart of
``repro/kernels/ops.py``).

The forward runs the kernel (``flash_attention_fwd``, ``ssd_scan_fwd``,
``rmsnorm_fwd``: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors).

Attention's backward is a kernel too, the JAX package's flash custom VJP
(``repro/models/flash_vjp.py``, its ``kernel="flash"`` path): the forward
saves (q, k, v, o) and each row's log-sum-exp, and the backward
(``flash_attention_bwd``: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors) recomputes P from them, so no (Sq, Sk) tensor is
stored.  RMSNorm's backward is a kernel as well, the analytic VJP of the
reference's ``rmsnorm_fused`` (``repro/models/layers.py:_rmsnorm_fused_bwd``):
the forward saves (x, scale) and the backward (``rmsnorm_bwd``) computes
dx and dscale from them and the cotangent without re-running the
forward.  The SSD scan's backward is a kernel too ("6-bwd",
``ssd_scan_bwd``: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors), the analytic VJP of the scan: the forward saves only its
inputs, as the reference's custom VJP ``_ssd_bwd`` does, and the backward
recomputes the chunk states it needs inside the kernel, never the plain
scan.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
from repro_torch.kernels.rmsnorm import rmsnorm_fwd
from repro_torch.kernels.rmsnorm_bwd import rmsnorm_bwd
from repro_torch.kernels.ssd_scan import ssd_scan_fwd
from repro_torch.kernels.ssd_scan_bwd import ssd_scan_bwd


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        q_offset=q_offset)
        o, lse = flash_attention_fwd(q, k, v, **ctx.opts, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, g.contiguous(),
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """Attention of ``ref.flash_attention``'s contract.  Where autograd has
    nothing to record (grad off, or no input requires it: serving) the
    forward is called without the ``autograd.Function``, so it writes no
    log-sum-exp."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, softcap,
                                    q_offset)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset)


class SsdScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        # a caller that drops the final state leaves its cotangent None
        ctx.set_materialize_grads(False)
        return ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, g_y, g_state):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        if g_y is None:
            g_y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        grads = ssd_scan_bwd(x, dt, A, Bm, Cm, g_y, g_state, chunk=ctx.chunk)
        return (*grads, None)


def ssd_scan(x, dt, A, Bm, Cm, chunk: int = 128):
    """Returns (y (B,S,H,P), final_state (B,H,P,N)); see ``ref.ssd_scan``."""
    return SsdScan.apply(x, dt, A, Bm, Cm, chunk)


class RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_fwd(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, g, eps=ctx.eps)
        return dx, dscale, None


def rmsnorm(x, scale, eps: float = 1e-6) -> torch.Tensor:
    """``(x * rsqrt(mean(x^2) + eps)) * scale`` over the last dim, in x's
    dtype; see ``ref.rmsnorm``.  Where autograd has nothing to record
    (grad off, or neither input requires it) the forward is called without
    the ``autograd.Function`` around it: the same call, less host time."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RmsNorm.apply(x, scale, eps)
    return rmsnorm_fwd(x, scale, eps=eps)
