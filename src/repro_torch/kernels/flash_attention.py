"""Flash-attention forward on Hopper: the ctypes wrapper around
``csrc/flash_attention.cu`` (the port of the Pallas kernel
``repro/kernels/flash_attention.py:flash_attention_fwd``).

``flash_attention_cuda`` launches the kernel and takes CUDA tensors only.
``flash_attention_fwd`` is the entry the model reaches (through
``ops.flash_attention``): it launches the kernel for CUDA tensors and runs
the plain version (``ref.flash_attention``, or ``ref.flash_attention_lse``
with ``with_lse``) for CPU tensors, and for nothing else.  With
``with_lse`` both also return each row's log-sum-exp, (B, Sq, H) float32,
which the backward (``kernels.flash_attention_bwd``) recomputes P from.

The source holds two kernels; ``variant`` picks one from the inputs alone,
here and nowhere else, and the C entry point launches that one or refuses
the inputs.  No failure ever falls back on the other variant.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, ref, work

MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("cuda_core", "wgmma")     # their codes in the C entry
# (D, Dv) the "wgmma" kernels of both directions take: every training head
# width of the port (the C entries of csrc/flash_attention.cu and
# csrc/flash_attention_bwd.cu list the same pairs)
WGMMA_WIDTHS = ((64, 64), (80, 80), (128, 128), (256, 256), (192, 128))
# the errors the C entry returns by itself, before any launch
_REFUSALS = {
    1: "cudaErrorInvalidValue: the variant cannot take these inputs",
    200: "cudaErrorInvalidKernelImage: ptxas gave the wgmma kernel another "
         "register count than its setmaxnreg split needs"}

LAUNCHES = build.LaunchCounter()
LAUNCHES_BY_VARIANT = {name: build.LaunchCounter() for name in VARIANTS}


def _aligned16(t: torch.Tensor) -> bool:
    """16-byte aligned base and (batch, seq, head) strides."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def variant(q, k, v) -> str:
    """The kernel that ``flash_attention_cuda`` launches for these inputs,
    from their dtype, head widths, base alignment and strides (and, for
    "wgmma", at least one key: a TMA map has no empty dimension):

    * "wgmma": bf16, (D, Dv) in ``WGMMA_WIDTHS``, q, k, v 16-byte
      aligned;
    * "cuda_core": everything else, float32 included."""
    D, Dv = q.shape[3], v.shape[3]
    if all(t.dtype == torch.bfloat16 and _aligned16(t) for t in (q, k, v)) \
            and (D, Dv) in WGMMA_WIDTHS and k.shape[1] > 0:
        return "wgmma"
    return "cuda_core"


@functools.cache
def _entry():
    fn = build.load("flash_attention").repro_flash_attention_fwd
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I, I] + [L] * 12 + \
        [I, I, F, I, F, P]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, q_offset: int = 0,
                         with_lse: bool = False):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D|Dv), CUDA, float32 or bfloat16,
    last dim contiguous, D and Dv <= 256, H % KV == 0.  Returns
    (B, Sq, H, Dv) in q's dtype, and with ``with_lse`` also each row's
    log-sum-exp (B, Sq, H) float32.  Launches the kernel ``variant`` names,
    or raises."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention_cuda: {name} is on {t.device}, "
                             f"not on a CUDA device")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODE:
            raise ValueError(f"flash_attention_cuda: {name} has dtype "
                             f"{t.dtype}; q, k, v must share float32 or "
                             f"bfloat16")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention_cuda: {name}'s last dim must "
                             f"be contiguous")
        if t.device != q.device:
            raise ValueError("flash_attention_cuda: q, k, v on different "
                             "devices")
    B, Sq, H, D = q.shape
    Sk, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape != (B, Sk, KV, D) or v.shape[:3] != (B, Sk, KV):
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if H % KV or D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_cuda: needs H % KV == 0 and "
                         f"D, Dv <= {MAX_HEAD_DIM}; got H={H} KV={KV} D={D} "
                         f"Dv={Dv}")
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    kind = variant(q, k, v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, _DTYPE_CODE[q.dtype],
        VARIANTS.index(kind), B, Sq, Sk, H, KV, D, Dv,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), int(window), float(softcap or 0.0), int(q_offset),
        1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {kind} kernel launch failed: "
                           f"CUDA error {err} "
                           f"{_REFUSALS.get(err, '')}".rstrip())
    LAUNCHES.count += 1
    LAUNCHES_BY_VARIANT[kind].count += 1
    return (out, lse) if with_lse else out


@work.counted("flash_attention", work.flash_attention_call)
def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0,
                        with_lse: bool = False):
    """The kernel for CUDA tensors; the plain version for CPU tensors; for
    ``meta`` tensors (the dry-run's trace) only the outputs' shapes."""
    opts = dict(causal=causal, window=window, softcap=softcap,
                q_offset=q_offset)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, **opts, with_lse=with_lse)
    if q.device.type == "cpu":
        # contiguous, as the kernel's outputs are: a caller's reshape of
        # them is then a view on every device
        if with_lse:
            o, lse = ref.flash_attention_lse(q, k, v, **opts)
            return o.contiguous(), lse.contiguous()
        return ref.flash_attention(q, k, v, **opts).contiguous()
    if q.device.type == "meta":
        B, Sq, H, _ = q.shape
        out = torch.empty((B, Sq, H, v.shape[3]), dtype=q.dtype,
                          device="meta")
        if with_lse:
            return out, torch.empty((B, Sq, H), dtype=torch.float32,
                                    device="meta")
        return out
    raise ValueError(f"flash_attention: no kernel for device {q.device}")
