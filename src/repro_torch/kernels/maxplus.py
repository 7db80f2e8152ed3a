"""Max-plus (tropical) convolutions on Hopper: the ctypes wrappers around
``csrc/maxplus.cu``, the port of the three Pallas kernels of
``repro/kernels/maxplus.py`` (``maxplus_conv``, ``maxplus_conv_batched``,
``maxplus_scan_chunk``) that the planner's batched and fused engines run.
Kernel 5 reaches the fused engine as ``maxplus_scan_step``: one step of the
fused program, folding and max-reducing inside the slot buffer itself.

Each public function launches its kernel for CUDA tensors and runs the
plain version (``ref.maxplus_*``) for CPU tensors, and for nothing else.
Both compute every candidate as one add and reduce with an exact max, so
the kernel equals the plain version bit for bit, in float32 and float64.
``LAUNCHES[name].count`` counts each kernel's launches (the scan step's on
``"maxplus_scan_chunk"``); kernel 3 comes in two variants (``variant()``),
each also counted on ``CONV_LAUNCHES_BY_VARIANT``.
"""
from __future__ import annotations

import ctypes
import functools
import numbers
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build, ref

LAUNCHES = {name: build.LaunchCounter() for name in
            ("maxplus_conv", "maxplus_conv_batched", "maxplus_scan_chunk")}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_MAX_ROWS = 65535                      # the kernels' grid y dimension
_MAX_BANDS = 8000                      # kernel 4's bands in its launch
#                                        parameters (csrc/maxplus.cu)
VARIANTS = ("narrow", "wide")          # kernel 3's, by their C code
# Kernel 3 is "wide" from this many candidates in its widest cell
# (csrc/maxplus.cu says what each variant does): the crossover of the two
# variants' graph times on the planner's rows of 1033 cells (chip_smoke.py,
# conv3_variant_sweep; H100 80GB HBM3, 700 W).
WIDE_MIN = 8
CONV_LAUNCHES_BY_VARIANT = {name: build.LaunchCounter() for name in VARIANTS}


@functools.cache
def _entry(name: str, dtype: torch.dtype):
    fn = getattr(build.load("maxplus"), f"repro_{name}_{_SUFFIX[dtype]}")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = {"maxplus_conv": [P, P, P, I, I, I, P],
                   "maxplus_conv_batched": [P, P, P, P, I, I, P],
                   "maxplus_scan_chunk": [P, P, P, I, I, I, P],
                   "maxplus_scan_step": [P, P] + [I] * 7 + [P]}[name]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, ndim: int, *ts) -> None:
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"{name}: input is on {t.device}, not on a CUDA "
                             f"device")
        if t.dim() != ndim:
            raise ValueError(f"{name}: inputs must be {ndim}-D, got "
                             f"{tuple(t.shape)}")
        if t.dtype != ts[0].dtype or t.dtype not in _SUFFIX:
            raise ValueError(f"{name}: inputs have dtype {t.dtype}; they "
                             f"must share float32 or float64")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: inputs on different devices")


def _launch(name: str, x: torch.Tensor, *args,
            dtype: Optional[torch.dtype] = None,
            counter: Optional[str] = None) -> None:
    # the current stream's raw handle, without a torch.cuda.Stream object
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    err = _entry(name, dtype or x.dtype)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[counter or name].count += 1


def _bands(bands, B: int, n: int) -> np.ndarray:
    """The (B,) int32 bands clamped to [0, n]; ``None`` is dense (n)."""
    if bands is None or isinstance(bands, numbers.Integral):
        return np.full(B, ref._clamp_band(bands, n), dtype=np.int32)
    bs = np.array(bands, dtype=np.float64)          # None -> nan
    if bs.shape != (B,):
        raise ValueError(f"got {bs.size} bands for a batch of {B}")
    return np.fmax(np.fmin(bs, n), 0).astype(np.int32)  # fmin(nan, n) = n


def variant(n1: int, band: int) -> str:
    """The kernel-3 variant that a CUDA call on rows of ``n1`` cells with
    this band launches: "wide" where the widest cell has at least
    ``WIDE_MIN`` candidates (``min(band, n1 - 1) + 1``), else "narrow"."""
    return "wide" if min(band, n1 - 1) + 1 >= WIDE_MIN else "narrow"


def _conv_cuda(prev, g, band: int, kind: str) -> torch.Tensor:
    """Kernel 3's ``kind`` variant on checked CUDA rows of n1 >= 1 cells
    and a band clamped to [0, n1 - 1]."""
    out = torch.empty_like(prev)
    _launch("maxplus_conv", prev, prev.data_ptr(), g.data_ptr(),
            out.data_ptr(), prev.shape[0], band, VARIANTS.index(kind))
    CONV_LAUNCHES_BY_VARIANT[kind].count += 1
    return out


def maxplus_conv_cuda(prev, g, band=None) -> torch.Tensor:
    """Kernel 3 on CUDA tensors: ``prev``, ``g`` 1-D of length n+1; the
    variant is ``variant(n+1, band)``."""
    _check("maxplus_conv", 1, prev, g)
    if prev.shape != g.shape:
        raise ValueError(f"maxplus_conv: prev {tuple(prev.shape)} and g "
                         f"{tuple(g.shape)} differ")
    n1 = prev.shape[0]
    if not n1:
        return torch.empty_like(prev)
    band = ref._clamp_band(band, n1 - 1)
    return _conv_cuda(prev, g, band, variant(n1, band))


def maxplus_conv_batched_cuda(prev, g, bands=None) -> torch.Tensor:
    """Kernel 4 on CUDA tensors: ``prev``, ``g`` (B, n+1), per-row bands
    (a sequence, or one band or ``None`` for every row)."""
    _check("maxplus_conv_batched", 2, prev, g)
    if prev.shape != g.shape:
        raise ValueError(f"maxplus_conv_batched: prev {tuple(prev.shape)} "
                         f"and g {tuple(g.shape)} differ")
    B, n1 = prev.shape
    if B > _MAX_BANDS:
        raise ValueError(f"maxplus_conv_batched: {B} rows > {_MAX_BANDS}, "
                         f"the bands its launch parameters hold")
    bs = _bands(bands, B, n1 - 1)
    out = torch.empty_like(prev)
    if B and n1:
        _launch("maxplus_conv_batched", prev, prev.data_ptr(),
                g.data_ptr(), bs.ctypes.data, out.data_ptr(), B, n1)
    return out


def maxplus_scan_chunk_cuda(wins, gs) -> torch.Tensor:
    """Kernel 5 on CUDA tensors: ``wins`` (B, n1+K-1), ``gs`` (B, K)."""
    _check("maxplus_scan_chunk", 2, wins, gs)
    B, K = gs.shape
    n1 = wins.shape[1] - (K - 1)
    if wins.shape[0] != B or K < 1 or n1 < 1:
        raise ValueError(f"maxplus_scan_chunk: wins {tuple(wins.shape)} and "
                         f"gs {tuple(gs.shape)} are not (B, n1+K-1), (B, K)")
    if B > _MAX_ROWS:
        raise ValueError(f"maxplus_scan_chunk: {B} rows > {_MAX_ROWS}")
    out = torch.empty((B, n1), dtype=wins.dtype, device=wins.device)
    if B:
        _launch("maxplus_scan_chunk", wins, wins.data_ptr(),
                gs.data_ptr(), out.data_ptr(), B, n1, K)
    return out


def maxplus_scan_step_cuda(buf, tables, step: int, K: int, n1: int,
                           padl: int, width: int, dtype) -> None:
    """Kernel 5 as the fused program's scan step, on CUDA tensors: folds
    row r of step ``step`` of ``tables`` (int32 (5, steps, G): src, gsl,
    off, band, out) in ``dtype`` and max-reduces it into the flat float64
    slot buffer ``buf`` (slots of ``width``, values at ``padl``), in place
    (``ref.maxplus_scan_step`` says what it computes).  Counted on
    ``LAUNCHES["maxplus_scan_chunk"]``."""
    name = "maxplus_scan_step"
    for t in (buf, tables):
        if not t.is_cuda:
            raise ValueError(f"{name}: input is on {t.device}, not on a "
                             f"CUDA device")
        if not t.is_contiguous() or t.device != buf.device:
            raise ValueError(f"{name}: inputs must be contiguous, on one "
                             f"device")
    if buf.dtype != torch.float64 or buf.dim() != 1:
        raise ValueError(f"{name}: the slot buffer must be 1-D float64")
    if tables.dtype != torch.int32 or tables.dim() != 3 \
            or tables.shape[0] != 5:
        raise ValueError(f"{name}: tables must be int32 (5, steps, G), got "
                         f"{tables.dtype} {tuple(tables.shape)}")
    if dtype not in _SUFFIX:
        raise ValueError(f"{name}: dtype {dtype}; float32 or float64")
    _, steps, G = tables.shape
    step, K, n1, padl, width = (int(x) for x in (step, K, n1, padl, width))
    if not 0 <= step < steps or G > _MAX_ROWS or K < 1 or n1 < 1 \
            or padl < K - 1 or padl + n1 + K > width \
            or buf.numel() % width:
        raise ValueError(f"{name}: step {step} of {steps}, G {G}, K {K}, "
                         f"n1 {n1}, padl {padl}, width {width} do not fit a "
                         f"buffer of {buf.numel()}")
    if G:
        _launch(name, buf, buf.data_ptr(), tables.data_ptr(), steps, step,
                G, K, n1, padl, width, dtype=dtype,
                counter="maxplus_scan_chunk")


def _route(cuda_fn, plain_fn, x, *args):
    if x.is_cuda:
        return cuda_fn(x, *args)
    if x.device.type == "cpu":
        return plain_fn(x, *args)
    raise ValueError(f"max-plus: no kernel for device {x.device}")


def maxplus_conv_np(prev: np.ndarray, g: np.ndarray,
                    band: Optional[int] = None) -> np.ndarray:
    """Float32 numpy oracle with the kernel's exact candidate arithmetic
    (f32 adds, order-free max); copied from
    repro/kernels/maxplus.py:111."""
    prev32 = np.asarray(prev, dtype=np.float32)
    g32 = np.asarray(g, dtype=np.float32)
    n = prev32.shape[0] - 1
    b = n if band is None else max(0, min(int(band), n))
    pad = np.concatenate([np.full(b, -np.inf, dtype=np.float32), prev32])
    win = np.lib.stride_tricks.sliding_window_view(pad, b + 1)
    return (win + g32[b::-1][None, :]).max(axis=1)


def maxplus_conv(prev, g, band=None) -> torch.Tensor:
    """``out[j] = max_{0 <= k <= min(j, band)} prev[j-k] + g[k]``: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    return _route(maxplus_conv_cuda, ref.maxplus_conv, prev, g, band)


def maxplus_conv_batched(prev, g, bands=None) -> torch.Tensor:
    """B independent banded convolutions; row r equals ``maxplus_conv(
    prev[r], g[r], bands[r])``."""
    return _route(maxplus_conv_batched_cuda, ref.maxplus_conv_batched, prev,
                  g, bands)


def maxplus_scan_chunk(wins, gs) -> torch.Tensor:
    """``out[r, j] = max_{0 <= k < K} wins[r, j+K-1-k] + gs[r, k]``."""
    return _route(maxplus_scan_chunk_cuda, ref.maxplus_scan_chunk, wins, gs)


def maxplus_scan_step(buf, tables, step: int, K: int, n1: int, padl: int,
                      width: int, dtype) -> None:
    """One step of the fused planner program, in place on the float64 slot
    buffer ``buf``: the kernel for CUDA tensors, the plain version
    (``ref.maxplus_scan_step``) for CPU tensors."""
    return _route(maxplus_scan_step_cuda, ref.maxplus_scan_step, buf, tables,
                  step, K, n1, padl, width, dtype)
