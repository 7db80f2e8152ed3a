"""Differentiable wrappers around the port's kernels (counterpart of
``repro/kernels/ops.py``).

The forward runs the kernel (``flash_attention_fwd``: the CUDA kernel for
CUDA tensors, the plain version for CPU tensors).  The backward recomputes
through the plain version, exactly as the reference's custom VJP
``_fa_bwd`` differentiates through ``ref.flash_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_fwd


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        q_offset=q_offset)
        return flash_attention_fwd(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_(True)
                   for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.flash_attention(q, k, v, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    return FlashAttention.apply(q, k, v, causal, window, softcap, q_offset)
