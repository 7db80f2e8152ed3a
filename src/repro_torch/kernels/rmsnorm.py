"""RMSNorm forward on Hopper: the ctypes wrapper around ``csrc/rmsnorm.cu``
(the port of the Pallas kernel ``repro/kernels/rmsnorm.py:rmsnorm_fwd``).

``rmsnorm_cuda`` launches the kernel and takes CUDA tensors only.
``rmsnorm_fwd`` is the entry the model reaches (through ``ops.rmsnorm``):
it launches the kernel for CUDA tensors and runs the plain version
(``ref.rmsnorm``) for CPU tensors, and for nothing else.

The kernel's device time at a decode step's shapes is a few microseconds,
so the wrapper's own host time is most of an eager call: it checks its
inputs with a handful of attribute reads (the per-tensor messages are
built only for a refusal), copies only a tensor that is not contiguous,
and reads the raw handle of PyTorch's current stream.  Under a CUDA graph
(``serve.decode.GraphDecoder``) the host side does not run at replay.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref, work

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = build.LaunchCounter()


@functools.cache
def _entry():
    fn = build.load("rmsnorm").repro_rmsnorm_fwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, ctypes.c_longlong, I, I, I, ctypes.c_float, P]
    fn.restype = ctypes.c_int
    return fn


def _refuse(x, scale) -> None:
    """Raises the ValueError that names what ``rmsnorm_cuda`` cannot take."""
    for name, t in (("x", x), ("scale", scale)):
        if not t.is_cuda:
            raise ValueError(f"rmsnorm_cuda: {name} is on {t.device}, not on "
                             f"a CUDA device")
        if t.dtype not in _DTYPE_CODE:
            raise ValueError(f"rmsnorm_cuda: {name} has dtype {t.dtype}; the "
                             f"kernel takes float32 or bfloat16")
    if scale.device != x.device:
        raise ValueError("rmsnorm_cuda: x and scale on different devices")
    raise ValueError(f"rmsnorm_cuda: scale {tuple(scale.shape)} does not "
                     f"match the last dim of x {tuple(x.shape)}")


def rmsnorm_cuda(x, scale, *, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) and scale: (d,), float32 or bfloat16 each, on one CUDA
    device.  Returns ``(x * rsqrt(mean(x^2) + eps)) * scale`` over the last
    dim, computed in float32, in x's dtype and shape.  A non-contiguous x
    or scale is copied to a contiguous one first."""
    xcode, scode = _DTYPE_CODE.get(x.dtype), _DTYPE_CODE.get(scale.dtype)
    if not (x.is_cuda and scale.is_cuda) or xcode is None or scode is None \
            or x.dim() < 1 or scale.dim() != 1 \
            or scale.shape[0] != x.shape[-1] \
            or scale.get_device() != (dev := x.get_device()):
        _refuse(x, scale)
    if not x.is_contiguous():
        x = x.contiguous()
    if not scale.is_contiguous():
        scale = scale.contiguous()
    out = torch.empty_like(x)
    d = x.shape[-1]
    n = x.numel()
    if n == 0:
        return out
    # the current stream's raw handle, without a torch.cuda.Stream object
    stream = torch._C._cuda_getCurrentRawStream(dev)
    err = _entry()(x.data_ptr(), scale.data_ptr(), out.data_ptr(), n // d, d,
                   xcode, scode, eps, stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {err}")
    LAUNCHES.count += 1
    return out


@work.counted("rmsnorm", work.rmsnorm_call)
def rmsnorm_fwd(x, scale, *, eps: float = 1e-6) -> torch.Tensor:
    """The kernel for CUDA tensors; the plain version for CPU tensors; for
    ``meta`` tensors (the dry-run's trace) only the output's shape."""
    if x.is_cuda:
        return rmsnorm_cuda(x, scale, eps=eps)
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, eps=eps)
    if x.device.type == "meta":
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")
