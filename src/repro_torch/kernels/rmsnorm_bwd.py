"""RMSNorm backward on Hopper: the ctypes wrapper around
``csrc/rmsnorm_bwd.cu`` (the port of the analytic VJP
``repro/models/layers.py:_rmsnorm_fused_bwd``, the backward of kernel 2).

``rmsnorm_bwd_cuda`` launches the kernel and takes CUDA tensors only.
``rmsnorm_bwd`` is the entry ``ops.RmsNorm.backward`` reaches: it launches
the kernel for CUDA tensors and runs the plain version
(``ref.rmsnorm_bwd``) for CPU tensors, and for nothing else.

The source holds two variants; ``variant`` picks one from the inputs'
layout, here and nowhere else, and the C entry launches that one or
refuses the inputs.  No failure ever falls back on the other variant.
"bulk" reads each row of x and g from HBM once through a ring of
``cp.async.bulk`` copies in shared memory; "direct" takes every other
layout.  One call is two kernels on the current stream (dx with f32
partial dscale rows in a workspace, then the workspace's column sums);
``plan`` says how each variant spreads a shape, and the workspace it
needs.  ``LAUNCHES`` counts calls, ``LAUNCHES_BY_VARIANT`` calls of each
variant.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref, work

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("direct", "bulk")       # their codes in the C entry
WAVE = 132                          # SMs of an H100 SXM
SMEM_MAX = 227 * 1024               # shared memory of one block
# csrc/rmsnorm_bwd.cu's constants (a CPU test parses the source against
# these).  "bulk": a row is `lanes` threads, one 16-byte pack a lane up to a
# warp (a power of two of lanes), BULK_PPL packs a lane over whole warps
# past it (doubled while the row needs more than BULK_MAX_WARPS warps, up
# to BULK_MAX_PPL); BULK_THREADS // lanes row groups a block; a ring of
# BULK_STAGES stages of at least one row a group and about BULK_STAGE_BYTES
# of x and g; BULK_BLOCKS_PER_SM blocks on each of the WAVE SMs at most,
# in clusters of BULK_CLUSTER, one f32 workspace row a cluster.
BULK_THREADS = 256
BULK_PPL = 2
BULK_MAX_WARPS = 8
BULK_MAX_PPL = 4
BULK_STAGES = 2
BULK_STAGE_BYTES = 24576
BULK_BLOCKS_PER_SM = 2
BULK_CLUSTER = 2
BULK_DATA_OFFSET = 128
# "direct": a warp per row up to DIRECT_WARP_ROW_MAX_D (8 rows a block of
# 256 threads), a block per row above; at most DIRECT_MAX_BLOCKS blocks,
# one f32 workspace row each
DIRECT_THREADS = 256
DIRECT_WARP_ROW_MAX_D = 1024
DIRECT_MAX_BLOCKS = 528
MAX_D = SMEM_MAX // 4               # one f32 accumulator row in shared memory

LAUNCHES = build.LaunchCounter()
LAUNCHES_BY_VARIANT = {name: build.LaunchCounter() for name in VARIANTS}

_REFUSALS = {1: "cudaErrorInvalidValue: the variant cannot take these "
                "inputs"}


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a variant spreads (rows, d): ``grid`` blocks of ``threads``,
    ``lanes`` threads a row, ``rows_per_stage`` rows in each of ``stages``
    ring stages ("bulk"; 0 for "direct"), clusters of ``cluster`` blocks,
    an f32 workspace of ``ws_rows`` rows of d, ``smem_bytes`` of dynamic
    shared memory a block.  The fields of the C entry's
    ``repro_rmsnorm_bwd_plan``, in its order."""
    variant: str
    grid: int
    threads: int
    lanes: int
    rows_per_stage: int
    stages: int
    cluster: int
    ws_rows: int
    smem_bytes: int


FIELDS = [f.name for f in dataclasses.fields(Plan)][1:]


def _bulk_row(d: int, elt: int):
    """(lanes, packs a lane) of a "bulk" row of d elements of ``elt``
    bytes, or None where "bulk" cannot take the width."""
    vec = 16 // elt
    if d < 1 or d % vec:
        return None
    packs = d // vec
    if packs <= 32:
        return 1 << (packs - 1).bit_length(), 1
    ppl = BULK_PPL
    while packs > 32 * BULK_MAX_WARPS * ppl:
        ppl *= 2
    if ppl > BULK_MAX_PPL:
        return None
    return 32 * -(-packs // (32 * ppl)), ppl


@functools.lru_cache(maxsize=256)
def plan(rows: int, d: int, dtype: torch.dtype,
         kind: str = "bulk") -> Optional[Plan]:
    """The plan of variant ``kind`` for ``rows`` rows of width ``d`` of x in
    ``dtype``, a function of these alone (so the dscale sums, and the bits,
    of a call repeat); None where the variant cannot take the shape.
    Cached: ``plan.cache_clear()`` after changing the constants above."""
    if rows < 1 or d < 1:
        return None
    if kind == "direct":
        lanes = 32 if d <= DIRECT_WARP_ROW_MAX_D else DIRECT_THREADS
        groups = DIRECT_THREADS // lanes
        blocks = min(-(-rows // groups), DIRECT_MAX_BLOCKS)
        smem = 4 * groups * d
        return Plan("direct", blocks, DIRECT_THREADS, lanes, 0, 0, 1, blocks,
                    smem) if smem <= SMEM_MAX else None
    elt = dtype.itemsize
    row = _bulk_row(d, elt)
    if row is None:
        return None
    lanes, _ = row
    groups = max(1, BULK_THREADS // lanes)
    row_bytes = 2 * d * elt
    rps = groups * max(1, BULK_STAGE_BYTES // (groups * row_bytes))
    warps = -(-lanes // 32)
    smem = BULK_DATA_OFFSET + BULK_STAGES * rps * row_bytes + 8 * rps * warps
    if smem > SMEM_MAX:
        return None
    blocks = min(-(-rows // rps), WAVE * BULK_BLOCKS_PER_SM)
    blocks = -(-blocks // BULK_CLUSTER) * BULK_CLUSTER
    return Plan("bulk", blocks, groups * lanes, lanes, rps, BULK_STAGES,
                BULK_CLUSTER, blocks // BULK_CLUSTER, smem)


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# repro_rmsnorm_bwd's parameters: x, sx, g, sg, scale, dx, ws, ws_rows,
# dscale, rows, d, x dtype, scale dtype, variant, eps, stream
ARGTYPES = [_P, _L, _P, _L, _P, _P, _P, _L, _P, _L, _I, _I, _I, _I, _F, _P]
PLAN_ARGTYPES = [_L, _I, _I, _I, _P]


@functools.cache
def _entry():
    fn = build.load("rmsnorm_bwd").repro_rmsnorm_bwd
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def c_plan(rows: int, d: int, dtype: torch.dtype, kind: str = "bulk",
           lib=None) -> Optional[Plan]:
    """The C entry's own plan (``repro_rmsnorm_bwd_plan`` of the built
    library, or of ``lib``), to hold ``plan`` against on the card; None
    where it refuses the shape."""
    fn = (lib or build.load("rmsnorm_bwd")).repro_rmsnorm_bwd_plan
    fn.argtypes, fn.restype = PLAN_ARGTYPES, ctypes.c_int
    out = (ctypes.c_longlong * len(FIELDS))()
    if fn(rows, d, _DTYPE_CODE[dtype], VARIANTS.index(kind), out) != 0:
        return None
    return Plan(kind, *out)


def _in_place(t: torch.Tensor):
    """``t`` as (rows, d) with unit stride inside a row and one row stride,
    without a copy, and that stride; None where its layout needs a copy."""
    d = t.shape[-1]
    if t.stride(-1) == 1:
        try:
            v = t.view(-1, d)
            if v.shape[0] <= 1 or v.stride(0) >= d:
                return v, max(v.stride(0), d)
        except RuntimeError:
            pass
    return None


def _rows(t: torch.Tensor):
    """``t`` as (rows, d) read in place where its layout allows, copied to
    contiguous otherwise.  Returns (view, row stride)."""
    return _in_place(t) or (t.contiguous().view(-1, t.shape[-1]),
                            t.shape[-1])


def variant(x, g, scale) -> str:
    """The kernels ``rmsnorm_bwd_cuda`` launches for these inputs, from
    their dtypes, width and layout as the kernel will see them (a tensor
    ``_rows`` copies is contiguous and aligned):

    * "bulk": x and g rows 16-byte aligned with row strides of a multiple
      of 16 bytes, d a multiple of 16 bytes and at most ``BULK_MAX_WARPS``
      x 32 x ``BULK_MAX_PPL`` packs, scale 16-byte aligned;
    * "direct": everything else."""
    d = x.shape[-1]
    if x.dtype not in _DTYPE_CODE or plan(1, d, x.dtype) is None:
        return "direct"
    vec = 16 // x.element_size()
    for t in (x, g):
        view = _in_place(t)
        if view is not None and (view[0].data_ptr() % 16 or view[1] % vec):
            return "direct"
    if scale.is_contiguous() and scale.data_ptr() % 16:
        return "direct"
    return "bulk"


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


def _check(x, scale, g) -> None:
    if not (x.is_cuda and scale.is_cuda and g.is_cuda) \
            or x.dtype not in _DTYPE_CODE or scale.dtype not in _DTYPE_CODE \
            or g.dtype != x.dtype or g.shape != x.shape \
            or x.dim() < 1 or scale.dim() != 1 \
            or scale.shape[0] != x.shape[-1] or x.shape[-1] > MAX_D \
            or scale.get_device() != (dev := x.get_device()) \
            or g.get_device() != dev:
        _refuse(x, scale, g)


def run_variant(kind: str, x, scale, g, *, eps: float = 1e-6):
    """``rmsnorm_bwd_cuda`` on the variant ``kind``, whichever ``variant``
    names: the way the card's tests hold each variant against the plain
    version.  The C entry refuses inputs ``kind`` cannot take (this
    raises); nothing falls back."""
    _check(x, scale, g)
    d = x.shape[-1]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x.numel() // d if d else 0
    if rows == 0 or d == 0:
        return dx, torch.zeros_like(scale)
    if not scale.is_contiguous():
        scale = scale.contiguous()
    x2, sx = _rows(x)
    g2, sg = _rows(g)
    pl = plan(rows, d, x.dtype, kind)
    ws = torch.empty((pl.ws_rows if pl else 1, d), dtype=torch.float32,
                     device=x.device)
    dscale = torch.empty_like(scale)
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    err = _entry()(x2.data_ptr(), sx, g2.data_ptr(), sg, scale.data_ptr(),
                   dx.data_ptr(), ws.data_ptr(), ws.shape[0],
                   dscale.data_ptr(), rows, d, _DTYPE_CODE[x.dtype],
                   _DTYPE_CODE[scale.dtype], VARIANTS.index(kind), eps,
                   stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm_bwd {kind} kernel launch failed: CUDA "
                           f"error {err} {_REFUSALS.get(err, '')}".rstrip())
    LAUNCHES.count += 1
    LAUNCHES_BY_VARIANT[kind].count += 1
    return dx, dscale


def rmsnorm_bwd_cuda(x, scale, g, *, eps: float = 1e-6):
    """x: (..., d) and g of x's shape and dtype, scale: (d,), float32 or
    bfloat16 each, on one CUDA device.  Returns (dx, dscale): dx
    contiguous in x's dtype and shape, dscale (d,) in scale's dtype (see
    ``ref.rmsnorm_bwd``).  x and g are read in place where their rows have
    one stride and unit stride inside (a strided slice of a wider
    projection), copied to contiguous otherwise.  Launches the kernels
    ``variant`` names, or raises."""
    _check(x, scale, g)
    return run_variant(variant(x, g, scale), x, scale, g, eps=eps)


@work.counted("rmsnorm_bwd", work.rmsnorm_bwd_call)
def rmsnorm_bwd(x, scale, g, *, eps: float = 1e-6):
    """The kernel for CUDA tensors; the plain version for CPU tensors; for
    ``meta`` tensors (the dry-run's trace) only the outputs' shapes."""
    if x.is_cuda:
        return rmsnorm_bwd_cuda(x, scale, g, eps=eps)
    if x.device.type == "cpu":
        return ref.rmsnorm_bwd(x, scale, g, eps=eps)
    if x.device.type == "meta":
        return (torch.empty(x.shape, dtype=x.dtype, device="meta"),
                torch.empty(scale.shape, dtype=scale.dtype, device="meta"))
    raise ValueError(f"rmsnorm_bwd: no kernel for device {x.device}")
