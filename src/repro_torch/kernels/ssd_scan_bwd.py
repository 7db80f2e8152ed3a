"""The backward of the Mamba2 SSD chunk scan ("6-bwd") on Hopper: the
ctypes wrapper around ``csrc/ssd_scan_bwd.cu``, the analytic VJP of
kernel 6 (``ssd_scan.py``).  It ports no TPU kernel: the reference's
custom VJP ``repro/kernels/ops.py:_ssd_bwd`` differentiates the pure-jnp
``ref.ssd_scan``.

``ssd_scan_bwd_cuda`` launches the kernel and takes CUDA tensors only.
``ssd_scan_bwd`` is the entry ``ops.SsdScan.backward`` reaches: it launches
the kernel for CUDA tensors and runs the plain version
(``ref.ssd_scan_bwd``) for CPU tensors, and for nothing else.  One call is
ten passes on the current stream (``csrc/ssd_scan_bwd.cu`` lists them)
and counts one launch on ``LAUNCHES``.

The kernel is bound by operations, most of them the (L, P, N) products
of each chunk.  Its five product passes (C.B^T, the chunk states and
local terms, dCB with S_prev.C, dx's two products, and the two terms of
dB and dC) run on ``wgmma`` tf32 in split TF32, as kernel 6's: each f32
operand is split into hi = tf32(a) and lo = tf32(a - hi) and every
k-step is lo.hi + hi.lo, then + hi.hi, because one TF32 pass keeps ~3
decimal digits and misses the plain version's 1e-4 (the test file
emulates both on dB's state term).  The tensor cores truncate as they
accumulate, so every 32-deep K slice starts a fresh sum, added to the
running one with f32 adds.  The carries and the sums over heads, head
blocks and chunks are elementwise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref, work
# the widths kernel 6 takes, which its backward takes too
from repro_torch.kernels.ssd_scan import MAX_CHUNK, MAX_D_STATE

HSPLIT = 8          # csrc/ssd_scan_bwd.cu's head blocks of dB's and dC's pass

LAUNCHES = build.LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
# repro_ssd_scan_bwd's parameters: x, dt, A, Bm, Cm, gy, gfin, dx, ddt, dA,
# dB, dC, the seven scratch tensors of scratch_shapes, B, S, H, P, G, N, L,
# stream
ARGTYPES = [_P] * 19 + [_I] * 7 + [_P]


def scratch_shapes(B, S, H, P, G, N, L):
    """The kernel's float32 scratch for one call with chunk length L, in
    the order the C entry takes it: ``vec`` five (B, H, nc, L) vectors
    (acum, exp(acum), f, da, dt da), ``cb`` C.B^T per
    (batch, chunk, group) with rows padded to Lr = L rounded up to 4,
    ``st`` each chunk's state, then the state entering it, ``ds``
    local_c, then the gradient of the state leaving chunk c (both with a
    chunk's heads together), ``dcb`` dCB per head, ``dcbg`` dCB summed
    over each group's heads (none where each group has one head),
    ``part`` dC's and dB's tiles of each of up to HSPLIT blocks of a
    group's heads."""
    nc, Lr = -(-S // L), -(-L // 4) * 4
    return {"vec": (5, B, H, nc, L), "cb": (B, nc, G, L, Lr),
            "st": (B, nc, H, P, N), "ds": (B, nc, H, P, N),
            "dcb": (B, nc, H, L, Lr),
            "dcbg": (B, nc, G, L, Lr) if H != G else (0,),
            "part": (2, min(H // G, HSPLIT), B, nc, G, L, N)}


@functools.cache
def _entry():
    fn = build.load("ssd_scan_bwd").repro_ssd_scan_bwd
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, gy, gfin=None, *, chunk: int = 128):
    """x, gy: (B,S,H,P); dt: (B,S,H); A: (H,); Bm, Cm: (B,S,G,N) with
    H % G == 0; gfin: (B,H,P,N) or None; all float32 on one CUDA device.
    The chunk length is ``min(chunk, S)`` and at most 128.  Returns (dx,
    ddt, dA, dBm, dCm), float32, the gradient of ``ssd_scan_cuda`` (see
    ``ref.ssd_scan_bwd``)."""
    named = (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
             ("gy", gy)) + ((("gfin", gfin),) if gfin is not None else ())
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"ssd_scan_bwd_cuda: {name} is on {t.device}, "
                             f"not on a CUDA device")
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_scan_bwd_cuda: {name} has dtype "
                             f"{t.dtype}; the kernel takes float32")
        if t.device != x.device:
            raise ValueError("ssd_scan_bwd_cuda: inputs on different "
                             "devices")
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"ssd_scan_bwd_cuda: x and Bm must be 4-D, got "
                         f"{tuple(x.shape)} and {tuple(Bm.shape)}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dt.shape != (B, S, H) or A.shape != (H,) or \
            Bm.shape != (B, S, G, N) or Cm.shape != (B, S, G, N) or \
            gy.shape != x.shape or \
            (gfin is not None and gfin.shape != (B, H, P, N)):
        raise ValueError(f"ssd_scan_bwd_cuda: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, gy "
                         f"{tuple(gy.shape)} disagree")
    L = min(chunk, S)
    if G < 1 or H % G or N > MAX_D_STATE or L > MAX_CHUNK or chunk < 1:
        raise ValueError(f"ssd_scan_bwd_cuda: needs H % G == 0, N <= "
                         f"{MAX_D_STATE} and a chunk of 1..{MAX_CHUNK}; got "
                         f"H={H} G={G} N={N} chunk={chunk}")
    if x.numel() == 0 or Bm.numel() == 0:
        return tuple(torch.zeros(t.shape, dtype=torch.float32,
                                 device=x.device)
                     for t in (x, dt, A, Bm, Cm))
    # the contiguous copies stay referenced until the launch has been queued
    ins = [t.contiguous() for t in (x, dt, A, Bm, Cm, gy)]
    gfin = None if gfin is None else gfin.contiguous()
    outs = tuple(torch.empty(t.shape, dtype=torch.float32, device=x.device)
                 for t in (x, dt, A, Bm, Cm))
    scratch = [torch.empty(shape, dtype=torch.float32, device=x.device)
               for shape in scratch_shapes(B, S, H, P, G, N, L).values()]
    ptrs = [t.data_ptr() for t in ins]
    ptrs.append(None if gfin is None else gfin.data_ptr())
    ptrs += [t.data_ptr() if t.numel() else None for t in (*outs, *scratch)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(*ptrs, B, S, H, P, G, N, L, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES.count += 1
    return outs


@work.counted("ssd_scan_bwd", work.ssd_scan_bwd_call)
def ssd_scan_bwd(x, dt, A, Bm, Cm, gy, gfin=None, *, chunk: int = 128):
    """The kernel for CUDA tensors; the plain version for CPU tensors; for
    ``meta`` tensors (the dry-run's trace) only the outputs' shapes."""
    if x.is_cuda:
        return ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, gy, gfin, chunk=chunk)
    if x.device.type == "cpu":
        return ref.ssd_scan_bwd(x, dt, A, Bm, Cm, gy, gfin, chunk=chunk)
    if x.device.type == "meta":
        return tuple(torch.empty(t.shape, dtype=torch.float32,
                                 device="meta")
                     for t in (x, dt, A, Bm, Cm))
    raise ValueError(f"ssd_scan_bwd: no kernel for device {x.device}")
