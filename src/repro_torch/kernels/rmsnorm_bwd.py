"""RMSNorm backward on Hopper: the ctypes wrapper around
``csrc/rmsnorm_bwd.cu`` (the port of the analytic VJP
``repro/models/layers.py:_rmsnorm_fused_bwd``, the backward of kernel 2).

``rmsnorm_bwd_cuda`` launches the kernel and takes CUDA tensors only.
``rmsnorm_bwd`` is the entry ``ops.RmsNorm.backward`` reaches: it launches
the kernel for CUDA tensors and runs the plain version
(``ref.rmsnorm_bwd``) for CPU tensors, and for nothing else.  One call is
two kernels on the current stream (dx with each block's f32 partial of
dscale, then the column sums of the partials); ``LAUNCHES`` counts calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/rmsnorm_bwd.cu: a warp per row up to d = 1024 (8 rows a block of 256
# threads), a block per row above; at most MAX_BLOCKS blocks, so the f32
# workspace of partial dscale rows stays small.  The grid is a function of
# (rows, d) alone: the same inputs give the same bits.
WARP_ROW_MAX_D = 1024
MAX_BLOCKS = 528                   # 4 per SM of an H100 SXM
MAX_D = 227 * 1024 // 4            # one f32 accumulator row in shared memory

LAUNCHES = build.LaunchCounter()


@functools.cache
def _entry():
    fn = build.load("rmsnorm_bwd").repro_rmsnorm_bwd
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, L, P, L, P, P, P, P, L, I, I, I, I, ctypes.c_float, P]
    fn.restype = ctypes.c_int
    return fn


def grid(rows: int, d: int) -> int:
    """The kernel's block count for ``rows`` rows of width ``d``."""
    per_block = 8 if d <= WARP_ROW_MAX_D else 1
    return max(1, min(-(-rows // per_block), MAX_BLOCKS))


def _rows(t: torch.Tensor):
    """``t`` as (rows, d) with unit stride inside a row and one row stride,
    without a copy where its layout allows; copied to contiguous
    otherwise.  Returns (view, row stride)."""
    d = t.shape[-1]
    if t.stride(-1) == 1:
        try:
            v = t.view(-1, d)
            if v.shape[0] <= 1 or v.stride(0) >= d:
                return v, max(v.stride(0), d)
        except RuntimeError:
            pass
    return t.contiguous().view(-1, d), d


def _refuse(x, scale, g) -> None:
    """Raises the ValueError that names what ``rmsnorm_bwd_cuda`` cannot
    take."""
    for name, t in (("x", x), ("scale", scale), ("g", g)):
        if not t.is_cuda:
            raise ValueError(f"rmsnorm_bwd_cuda: {name} is on {t.device}, "
                             f"not on a CUDA device")
        if t.dtype not in _DTYPE_CODE:
            raise ValueError(f"rmsnorm_bwd_cuda: {name} has dtype {t.dtype}; "
                             f"the kernel takes float32 or bfloat16")
    if scale.device != x.device or g.device != x.device:
        raise ValueError("rmsnorm_bwd_cuda: x, scale and g on different "
                         "devices")
    if g.dtype != x.dtype or g.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd_cuda: g {g.dtype} "
                         f"{tuple(g.shape)} must match x {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.dim() >= 1 and x.shape[-1] > MAX_D:
        raise ValueError(f"rmsnorm_bwd_cuda: d = {x.shape[-1]} over the "
                         f"kernel's {MAX_D}")
    raise ValueError(f"rmsnorm_bwd_cuda: scale {tuple(scale.shape)} does "
                     f"not match the last dim of x {tuple(x.shape)}")


def rmsnorm_bwd_cuda(x, scale, g, *, eps: float = 1e-6):
    """x: (..., d) and g of x's shape and dtype, scale: (d,), float32 or
    bfloat16 each, on one CUDA device.  Returns (dx, dscale): dx
    contiguous in x's dtype and shape, dscale (d,) in scale's dtype (see
    ``ref.rmsnorm_bwd``).  x and g are read in place where their rows have
    one stride and unit stride inside (a strided slice of a wider
    projection), copied to contiguous otherwise.  Launches the kernel, or
    raises."""
    xcode, scode = _DTYPE_CODE.get(x.dtype), _DTYPE_CODE.get(scale.dtype)
    if not (x.is_cuda and scale.is_cuda and g.is_cuda) or xcode is None \
            or scode is None or g.dtype != x.dtype or g.shape != x.shape \
            or x.dim() < 1 or scale.dim() != 1 \
            or scale.shape[0] != x.shape[-1] or x.shape[-1] > MAX_D \
            or scale.get_device() != (dev := x.get_device()) \
            or g.get_device() != dev:
        _refuse(x, scale, g)
    d = x.shape[-1]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x.numel() // d if d else 0
    if rows == 0 or d == 0:
        return dx, torch.zeros_like(scale)
    if not scale.is_contiguous():
        scale = scale.contiguous()
    x2, sx = _rows(x)
    g2, sg = _rows(g)
    blocks = grid(rows, d)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    dscale = torch.empty_like(scale)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    err = _entry()(x2.data_ptr(), sx, g2.data_ptr(), sg, scale.data_ptr(),
                   dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(),
                   rows, d, blocks, xcode, scode, eps, stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm_bwd kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES.count += 1
    return dx, dscale


def rmsnorm_bwd(x, scale, g, *, eps: float = 1e-6):
    """The kernel for CUDA tensors; the plain version for CPU tensors."""
    if x.is_cuda:
        return rmsnorm_bwd_cuda(x, scale, g, eps=eps)
    if x.device.type == "cpu":
        return ref.rmsnorm_bwd(x, scale, g, eps=eps)
    raise ValueError(f"rmsnorm_bwd: no kernel for device {x.device}")
