"""Flash-attention backward on Hopper: the ctypes wrapper around
``csrc/flash_attention_bwd.cu`` (the port of
``repro/models/flash_vjp.py:_bwd_blocked``, the backward of the JAX
package's ``kernel="flash"`` attention).

``flash_attention_bwd_cuda`` launches the kernel and takes CUDA tensors
only.  ``flash_attention_bwd`` is the entry ``ops.FlashAttention.backward``
reaches: it launches the kernel for CUDA tensors and runs the plain version
(``ref.flash_attention_bwd``) for CPU tensors, and for nothing else.  One
call is three kernels on the current stream (Dvec, then the dq pass, then
the dk, dv pass); ``LAUNCHES`` counts calls and ``LAUNCHES_BY_PASS`` each
pass.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import _DTYPE_CODE, MAX_HEAD_DIM

PASSES = ("dvec", "dq", "dkdv")

LAUNCHES = build.LaunchCounter()
LAUNCHES_BY_PASS = {name: build.LaunchCounter() for name in PASSES}


@functools.cache
def _entry():
    fn = build.load("flash_attention_bwd").repro_flash_attention_bwd
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    fn.argtypes = [P] * 10 + [I] * 8 + [L] * 15 + [I, I, F, I, F, P]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0,
                             q_offset: int = 0):
    """q, o, do: (B, Sq, H, D|Dv); k, v: (B, Sk, KV, D|Dv); lse: (B, Sq, H)
    float32; CUDA, q, k, v, o, do of one dtype (float32 or bfloat16), last
    dim contiguous, D and Dv <= 256, H % KV == 0.  Returns (dq, dk, dv),
    contiguous, in that dtype.  Launches the kernel, or raises."""
    named = (("q", q), ("k", k), ("v", v), ("o", o), ("do", do))
    for name, t in named + (("lse", lse),):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention_bwd_cuda: {name} is on "
                             f"{t.device}, not on q's CUDA device")
    for name, t in named:
        if t.dim() != 4 or t.dtype != q.dtype or t.dtype not in _DTYPE_CODE:
            raise ValueError(f"flash_attention_bwd_cuda: {name} must be 4-D "
                             f"float32 or bfloat16 like q, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention_bwd_cuda: {name}'s last dim "
                             f"must be contiguous")
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape != (B, Sk, KV, D) or v.shape[:3] != (B, Sk, KV) or \
            o.shape != (B, Sq, H, Dv) or do.shape != o.shape:
        raise ValueError(f"flash_attention_bwd_cuda: shapes q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)} disagree")
    if H % KV or D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd_cuda: needs H % KV == 0 and "
                         f"D, Dv <= {MAX_HEAD_DIM}; got H={H} KV={KV} D={D} "
                         f"Dv={Dv}")
    if lse.shape != (B, Sq, H) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd_cuda: lse must be contiguous "
                         f"float32 {(B, Sq, H)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    # the kernels write every element; with no query or no key every
    # gradient is 0 and nothing is launched
    new = torch.empty if B * Sq * H * Sk * KV else torch.zeros
    dq = new((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = new((B, Sk, KV, D), dtype=q.dtype, device=q.device)
    dv = new((B, Sk, KV, Dv), dtype=q.dtype, device=q.device)
    if new is torch.zeros:
        return dq, dk, dv
    dvec = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], B, Sq, Sk, H, KV,
        D, Dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], *do.stride()[:3], int(causal), int(window),
        float(softcap or 0.0), int(q_offset), 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES.count += 1
    for counter in LAUNCHES_BY_PASS.values():
        counter.count += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        q_offset: int = 0):
    """The kernel for CUDA tensors; the plain version for CPU tensors."""
    opts = dict(causal=causal, window=window, softcap=softcap,
                q_offset=q_offset)
    if q.is_cuda:
        return flash_attention_bwd_cuda(q, k, v, o, lse, do, **opts)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(q, k, v, o, lse, do, **opts)
    raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")
