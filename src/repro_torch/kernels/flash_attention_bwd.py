"""Flash-attention backward on Hopper: the ctypes wrapper around
``csrc/flash_attention_bwd.cu`` (the port of
``repro/models/flash_vjp.py:_bwd_blocked``, the backward of the JAX
package's ``kernel="flash"`` attention).

``flash_attention_bwd_cuda`` launches the kernel and takes CUDA tensors
only.  ``flash_attention_bwd`` is the entry ``ops.FlashAttention.backward``
reaches: it launches the kernel for CUDA tensors and runs the plain version
(``ref.flash_attention_bwd``) for CPU tensors, and for nothing else.

The source holds two variants; ``variant`` picks one from the inputs alone,
here and nowhere else, and the C entry point launches that one or refuses
the inputs.  No failure ever falls back on the other variant.  One call is
three kernels on the current stream (Dvec, then the dq pass, then the dk,
dv pass), and for "wgmma" with a head split (``plan``) a fourth that sums
the split's partials.  ``LAUNCHES`` counts calls, ``LAUNCHES_BY_VARIANT``
calls of each variant and ``LAUNCHES_BY_PASS`` each pass.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import build, ref, work
from repro_torch.kernels.flash_attention import (_DTYPE_CODE, _REFUSALS,
                                                 MAX_HEAD_DIM, WGMMA_WIDTHS,
                                                 _aligned16)

VARIANTS = ("cuda_core", "wgmma")     # their codes in the C entry
TILE = 64           # rows of a "wgmma" tile: query rows or keys
WAVE = 132          # SMs of an H100 SXM: blocks in one wave
PASSES = ("dvec", "dq", "dkdv", "reduce")

LAUNCHES = build.LaunchCounter()
LAUNCHES_BY_VARIANT = {name: build.LaunchCounter() for name in VARIANTS}
LAUNCHES_BY_PASS = {name: build.LaunchCounter() for name in PASSES}


def variant(q, k, v, o, do) -> str:
    """The kernels that ``flash_attention_bwd_cuda`` launches for these
    inputs, from their dtype, head widths, base alignment and strides:

    * "wgmma": bf16, (D, Dv) in ``WGMMA_WIDTHS``, at least one key (a TMA
      map has no empty dimension), q, k, v, o and do 16-byte aligned;
    * "cuda_core": everything else, float32 included."""
    D, Dv = q.shape[3], v.shape[3]
    if all(t.dtype == torch.bfloat16 and _aligned16(t)
           for t in (q, k, v, o, do)) and (D, Dv) in WGMMA_WIDTHS \
            and k.shape[1] > 0:
        return "wgmma"
    return "cuda_core"


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a "wgmma" call spreads the dk, dv pass: each of its blocks
    takes 64 keys of one KV head and ``G / split`` of the group's heads;
    with ``split`` > 1 each writes f32 partials into a workspace of
    ``workspace_bytes`` that a fourth kernel sums in split order."""
    split: int
    dkdv_blocks: int
    workspace_bytes: int
    scratch_bytes: int      # each row's lse and Dvec, (2, B, H, Sq_pad) f32


def plan(B: int, Sq: int, Sk: int, H: int, KV: int, D: int,
         Dv: int) -> Plan:
    """The head split of a "wgmma" call: the smallest divisor of the
    group G = H / KV that gives the dk, dv pass at least one full wave of
    blocks (``WAVE``), or G.  A function of the shape alone, so the sums,
    and the bits, of a call repeat."""
    G = H // KV
    kv_blocks = -(-Sk // TILE) * KV * B
    split = next(s for s in range(1, G + 1)
                 if G % s == 0 and (kv_blocks * s >= WAVE or s == G))
    ws = 4 * split * B * Sk * KV * (D + Dv) if split > 1 else 0
    sq_pad = -(-Sq // TILE) * TILE
    return Plan(split=split, dkdv_blocks=kv_blocks * split,
                workspace_bytes=ws, scratch_bytes=4 * 2 * B * H * sq_pad)


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# repro_flash_attention_bwd's parameters: 11 pointers (q, k, v, o, dout,
# lse, scratch, dq, dk, dv, ws), dtype, variant, split, B, Sq, Sk, H, KV,
# D, Dv, 15 strides, causal, window, softcap, q_offset, scale, stream
ARGTYPES = [_P] * 11 + [_I] * 10 + [_L] * 15 + [_I, _I, _F, _I, _F, _P]


@functools.cache
def _entry():
    fn = build.load("flash_attention_bwd").repro_flash_attention_bwd
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0,
                             q_offset: int = 0):
    """q, o, do: (B, Sq, H, D|Dv); k, v: (B, Sk, KV, D|Dv); lse: (B, Sq, H)
    float32; CUDA, q, k, v, o, do of one dtype (float32 or bfloat16), last
    dim contiguous, D and Dv <= 256, H % KV == 0.  Returns (dq, dk, dv),
    contiguous, in that dtype.  Launches the kernels ``variant`` names, or
    raises."""
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
    kind = variant(q, k, v, o, do)
    split, ws = 1, None
    if kind == "wgmma":
        pl = plan(B, Sq, Sk, H, KV, D, Dv)
        split = pl.split
        scratch = torch.empty(pl.scratch_bytes // 4, dtype=torch.float32,
                              device=q.device)
        if split > 1:
            ws = torch.empty(pl.workspace_bytes // 4, dtype=torch.float32,
                             device=q.device)
    else:
        scratch = torch.empty((B, Sq, H), dtype=torch.float32,
                              device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), None if ws is None else ws.data_ptr(),
        _DTYPE_CODE[q.dtype], VARIANTS.index(kind), split, B, Sq, Sk, H, KV,
        D, Dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], *do.stride()[:3], int(causal), int(window),
        float(softcap or 0.0), int(q_offset), 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd {kind} kernel launch failed:"
                           f" CUDA error {err} "
                           f"{_REFUSALS.get(err, '')}".rstrip())
    LAUNCHES.count += 1
    LAUNCHES_BY_VARIANT[kind].count += 1
    for name in PASSES[:3]:
        LAUNCHES_BY_PASS[name].count += 1
    if split > 1:
        LAUNCHES_BY_PASS["reduce"].count += 1
    return dq, dk, dv


@work.counted("flash_attention_bwd", work.flash_attention_bwd_call)
def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        q_offset: int = 0):
    """The kernel for CUDA tensors; the plain version for CPU tensors; for
    ``meta`` tensors (the dry-run's trace) only the outputs' shapes."""
    opts = dict(causal=causal, window=window, softcap=softcap,
                q_offset=q_offset)
    if q.is_cuda:
        return flash_attention_bwd_cuda(q, k, v, o, lse, do, **opts)
    if q.device.type == "cpu":
        # contiguous, as the kernel's outputs are
        return tuple(t.contiguous() for t in
                     ref.flash_attention_bwd(q, k, v, o, lse, do, **opts))
    if q.device.type == "meta":
        return tuple(torch.empty(t.shape, dtype=q.dtype, device="meta")
                     for t in (q, k, v))
    raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")
