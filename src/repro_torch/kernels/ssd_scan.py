"""Mamba2 SSD chunk scan on Hopper: the ctypes wrapper around
``csrc/ssd_scan.cu`` (the port of the Pallas kernel
``repro/kernels/ssd_scan.py:ssd_scan_fwd``).

``ssd_scan_cuda`` launches the kernel and takes CUDA tensors only.
``ssd_scan_fwd`` is the entry the model reaches (through ``ops.SsdScan``):
it launches the kernel for CUDA tensors and runs the plain version
(``ref.ssd_scan``) for CPU tensors, and for nothing else.  Its gradient is
the kernel 6-bwd (``ssd_scan_bwd.py``), which ``ops.SsdScan.backward``
calls: no backward re-runs the plain scan on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref, work

MAX_CHUNK = 128
MAX_D_STATE = 256

LAUNCHES = build.LaunchCounter()


def scratch_shapes(B, S, H, P, G, N, L):
    """The kernel's float32 scratch for one call with chunk length L, in
    the order the C entry takes it: ``cb`` holds C.B^T per (batch, chunk,
    group) with rows padded to a multiple of 4, ``st`` each chunk's state
    (its own contribution, then the state entering it), ``at`` each chunk's
    total log-decay."""
    nc = -(-S // L)
    return {"cb": (B, nc, G, L, -(-L // 4) * 4), "st": (B, H, nc, P, N),
            "at": (B, H, nc)}


@functools.cache
def _entry():
    fn = build.load("ssd_scan").repro_ssd_scan_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 10 + [I] * 7 + [P]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_cuda(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm, Cm: (B,S,G,N) with H % G
    == 0, N <= 256, all float32 on one CUDA device.  The chunk length is
    ``min(chunk, S)`` and at most 128.  Returns (y (B,S,H,P), final_state
    (B,H,P,N)), float32."""
    named = (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"ssd_scan_cuda: {name} is on {t.device}, not "
                             f"on a CUDA device")
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_scan_cuda: {name} has dtype {t.dtype}; "
                             f"the kernel takes float32")
        if t.device != x.device:
            raise ValueError("ssd_scan_cuda: inputs on different devices")
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"ssd_scan_cuda: x and Bm must be 4-D, got "
                         f"{tuple(x.shape)} and {tuple(Bm.shape)}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dt.shape != (B, S, H) or A.shape != (H,) or \
            Bm.shape != (B, S, G, N) or Cm.shape != (B, S, G, N):
        raise ValueError(f"ssd_scan_cuda: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} disagree")
    L = min(chunk, S)
    if G < 1 or H % G or N > MAX_D_STATE or L > MAX_CHUNK or chunk < 1:
        raise ValueError(f"ssd_scan_cuda: needs H % G == 0, N <= "
                         f"{MAX_D_STATE} and a chunk of 1..{MAX_CHUNK}; got "
                         f"H={H} G={G} N={N} chunk={chunk}")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    fin = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return y, fin.zero_()
    x, dt, A, Bm, Cm = (t.contiguous() for t in (x, dt, A, Bm, Cm))
    scratch = [torch.empty(shape, dtype=torch.float32, device=x.device)
               for shape in scratch_shapes(B, S, H, P, G, N, L).values()]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(*(t.data_ptr() for t in (x, dt, A, Bm, Cm, y, fin,
                                            *scratch)),
                   B, S, H, P, G, N, L, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    LAUNCHES.count += 1
    return y, fin


@work.counted("ssd_scan", work.ssd_scan_call)
def ssd_scan_fwd(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """The kernel for CUDA tensors; the plain version for CPU tensors; for
    ``meta`` tensors (the dry-run's trace) only the outputs' shapes."""
    if x.is_cuda:
        return ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk)
    if x.device.type == "cpu":
        # in the kernel's layout, so what follows runs the same ops on
        # every device (the plain version's y is (B, H, S, P) in memory)
        return tuple(t.contiguous()
                     for t in ref.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk))
    if x.device.type == "meta":
        B, S, H, P = x.shape
        N = Bm.shape[3]
        return (torch.empty((B, S, H, P), dtype=torch.float32,
                            device="meta"),
                torch.empty((B, H, P, N), dtype=torch.float32,
                            device="meta"))
    raise ValueError(f"ssd_scan: no kernel for device {x.device}")
