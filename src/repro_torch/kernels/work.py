"""The work of each kernel of the training and serving paths, one formula a
kernel: the arithmetic operations it does and the bytes it must move
(each input read once, each output written once), whatever implements it.

These formulas are the kernels' roofline bounds (``chip_smoke.py`` divides
them by the card's rates) and what the dry-run (``launch.dryrun``) counts
for a kernel's call in place of the aten ops that carry it: ``counted``
wraps each kernel's entry (``flash_attention_fwd``, ``flash_attention_bwd``,
``rmsnorm_fwd``, ``rmsnorm_bwd``, ``ssd_scan_fwd``, ``ssd_scan_bwd``), and
while a counter (``launch.counters.WorkCounter``) is active it notes the
call and the formula's work, ignores the aten ops inside the call (the
plain version's on the CPU, the wrapper's allocations on the card) and
then sees the call's outputs.  So a trace on the ``meta`` device, a run on the CPU and a
run on the card count the same work.

Operations are counted as ``torch.utils.flop_counter`` counts a product,
two a multiply-add; the norms' formulas count their elementwise operations
(``rmsnorm_work``: 4 an element, ``rmsnorm_bwd_work``: 10), which an aten
elementwise op would not add.  The work of attention depends on the mask:
``live_pairs`` counts the (query, key) pairs this call's causal mask and
window leave live.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

_ELT = {torch.float32: 4, torch.bfloat16: 2}

# the active counters (``launch.counters.WorkCounter`` adds itself here)
SINKS: List = []


@functools.lru_cache(maxsize=1024)
def live_pairs(Sq: int, Sk: int, causal: bool, window: int,
               q_offset: int) -> int:
    """(query, key) pairs the mask leaves live, per (batch, head): query i
    sits at position ``q_offset + i`` and sees the keys at or before it
    (``causal``) and, with a ``window``, the last ``window`` of them."""
    qp = np.arange(q_offset, q_offset + Sq, dtype=np.int64)
    hi = np.minimum(Sk - 1, qp) if causal else np.full_like(qp, Sk - 1)
    lo = np.maximum(0, qp - window + 1) if window > 0 else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def attention_work(B, Sq, Sk, H, KV, D, Dv, causal, window, q_offset,
                   elt: int, with_lse: bool = False) -> Tuple[float, int]:
    """Kernel 1: 2 (D + Dv) operations a live pair and head (S and P V);
    q, k, v read, o (and, ``with_lse``, each row's f32 log-sum-exp)
    written."""
    ops = 2.0 * B * H * live_pairs(Sq, Sk, causal, window, q_offset) \
        * (D + Dv)
    nbytes = elt * (B * Sq * H * D + B * Sk * KV * (D + Dv)
                    + B * Sq * H * Dv)
    if with_lse:
        nbytes += 4 * B * Sq * H
    return ops, nbytes


def attention_bwd_work(B, Sq, Sk, H, KV, D, Dv, causal, window, q_offset,
                       elt: int) -> Tuple[float, int]:
    """1-bwd: S and dP recomputed, dq, dk and dv: 2 (3 D + 2 Dv)
    operations a live pair and head; q, k, v, o, dO and lse read, dq, dk,
    dv written."""
    ops = 2.0 * B * H * live_pairs(Sq, Sk, causal, window, q_offset) \
        * (3 * D + 2 * Dv)
    q_side = B * Sq * H * (D + 2 * Dv + D)          # q, o, dO in; dq out
    kv_side = 2 * B * Sk * KV * (D + Dv)            # k, v in; dk, dv out
    return ops, elt * (q_side + kv_side) + 4 * B * Sq * H


def rmsnorm_work(shape, elt: int) -> Tuple[float, int]:
    """Kernel 2: x read and out written once, scale (x's width) read once;
    ~4 f32 operations an element (square and add, two products)."""
    n = math.prod(shape)
    return 4.0 * n, 2 * n * elt + shape[-1] * elt


def rmsnorm_bwd_work(shape, elt: int, scale_elt: int) -> Tuple[float, int]:
    """2-bwd: x and g read and dx written once, scale read and dscale
    written once; ~10 f32 operations an element (two sums, dx,
    dscale)."""
    n = math.prod(shape)
    return 10.0 * n, 3 * n * elt + 2 * shape[-1] * scale_elt


def ssd_work(B, S, H, P, G, N, chunk) -> Tuple[float, int]:
    """Kernel 6: the multiply-adds of the chunked algorithm -- C.B^T once
    per group (causal half), the (L,L)x(L,P) product per head (causal
    half), C.S_prev for chunks after the first and the state update, each
    over the chunk's live tokens -- and every input read once and both
    outputs written once (f32)."""
    L = min(chunk, S)
    ops = 0.0
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        pairs = n * (n + 1) / 2
        ops += 2.0 * B * (G * pairs * N + H * pairs * P
                          + H * n * N * P * (2 if c0 else 1))
    nbytes = 4 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * G * N
                  + B * H * P * N)
    return ops, nbytes


def ssd_bwd_work(B, S, H, P, G, N, chunk,
                 with_gfin: bool) -> Tuple[float, int]:
    """6-bwd: the multiply-adds of the analytic VJP over each chunk's live
    tokens n -- per group C.B^T, and dCB times B and C (causal halves);
    per head dW = gy.x^T and the weights times gy (causal halves), the
    chunk's own state, local, dS_out.B and the state terms of dB, then,
    for chunks after the first, the state term of dC and S_prev.C -- and
    x, dt, A, Bm, Cm, gy (and gfin where given) read once, dx, ddt, dA,
    dBm, dCm written once (f32)."""
    L = min(chunk, S)
    ops = 0.0
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        pairs = n * (n + 1) / 2
        ops += 2.0 * B * (3 * G * pairs * N + 2 * H * pairs * P
                          + H * n * N * P * (6 if c0 else 4))
    nbytes = 4 * (2 * (2 * B * S * H * P + B * S * H + H
                       + 2 * B * S * G * N)
                  + (B * H * P * N if with_gfin else 0))
    return ops, nbytes


def ssd_bwd_pass_ops(B, S, H, P, G, N, chunk) -> Dict[str, float]:
    """``ssd_bwd_work``'s operations by the pass of ``csrc/ssd_scan_bwd.cu``
    that runs them: C.B^T in ``bwd_cb_kernel``, the chunk states and
    local terms in ``bwd_state_kernel``, dW and S_prev.C in
    ``bwd_dcb_kernel``, the weights times gy and dS_out.B in
    ``bwd_dx_kernel``, both terms of dB and dC in ``bwd_dbc_kernel``."""
    L = min(chunk, S)
    out = dict.fromkeys(("bwd_cb_kernel", "bwd_state_kernel",
                         "bwd_dcb_kernel", "bwd_dx_kernel",
                         "bwd_dbc_kernel"), 0.0)
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        pairs = n * (n + 1) / 2
        lpn, later = H * n * N * P, 1 if c0 else 0
        out["bwd_cb_kernel"] += 2.0 * B * G * pairs * N
        out["bwd_state_kernel"] += 2.0 * B * 2 * lpn
        out["bwd_dcb_kernel"] += 2.0 * B * (H * pairs * P + later * lpn)
        out["bwd_dx_kernel"] += 2.0 * B * (H * pairs * P + lpn)
        out["bwd_dbc_kernel"] += 2.0 * B * (2 * G * pairs * N
                                            + (1 + later) * lpn)
    return out


def ssd_bwd_recompute_ops(B, S, H, P, G, N, chunk) -> float:
    """The part of ``ssd_bwd_work``'s operations that recomputes what the
    forward had formed (6-bwd takes only the scan's inputs): C.B^T per
    group, each chunk's own state and, for chunks after the first,
    S_prev.C -- kernel 6's work less its (L,L)x(L,P) product."""
    L = min(chunk, S)
    ops = 0.0
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        ops += 2.0 * B * (G * n * (n + 1) / 2 * N
                          + H * n * N * P * (2 if c0 else 1))
    return ops


# ---- the wrappers' formulas, from the arguments of their calls ----------

def _attention_args(q, k, v):
    B, Sq, H, D = q.shape
    return B, Sq, k.shape[1], H, k.shape[2], D, v.shape[3]


def flash_attention_call(q, k, v, *, causal=True, window=0, softcap=0.0,
                         q_offset=0, with_lse=False):
    return attention_work(*_attention_args(q, k, v), causal, window,
                          q_offset, _ELT[q.dtype], with_lse)


def flash_attention_bwd_call(q, k, v, o, lse, do, *, causal=True, window=0,
                             softcap=0.0, q_offset=0):
    return attention_bwd_work(*_attention_args(q, k, v), causal, window,
                              q_offset, _ELT[q.dtype])


def rmsnorm_call(x, scale, *, eps=1e-6):
    return rmsnorm_work(tuple(x.shape), _ELT[x.dtype])


def rmsnorm_bwd_call(x, scale, g, *, eps=1e-6):
    return rmsnorm_bwd_work(tuple(x.shape), _ELT[x.dtype],
                            _ELT[scale.dtype])


def ssd_scan_call(x, dt, A, Bm, Cm, *, chunk=128):
    B, S, H, P = x.shape
    return ssd_work(B, S, H, P, Bm.shape[2], Bm.shape[3], chunk)


def ssd_scan_bwd_call(x, dt, A, Bm, Cm, gy, gfin=None, *, chunk=128):
    B, S, H, P = x.shape
    return ssd_bwd_work(B, S, H, P, Bm.shape[2], Bm.shape[3], chunk,
                        gfin is not None)


def counted(name: str, formula: Callable) -> Callable:
    """Decorates kernel ``name``'s entry: while a counter is active each
    call reports ``formula(*args, **kwargs)`` (operations, bytes) once,
    the aten ops inside the call go uncounted, and the counter then sees
    the call's outputs.  With no counter the entry runs as it is."""
    def wrap(entry):
        @functools.wraps(entry)
        def call(*args, **kwargs):
            if not SINKS:
                return entry(*args, **kwargs)
            ops, nbytes = formula(*args, **kwargs)
            sinks = list(SINKS)
            for s in sinks:
                s.enter_kernel(name, ops, nbytes)
            try:
                out = entry(*args, **kwargs)
            finally:
                for s in sinks:
                    s.exit_kernel()
            for s in sinks:
                s.kernel_outputs(out)
            return out
        return call
    return wrap


@contextlib.contextmanager
def uncounted():
    """The aten ops inside the ``with`` block go uncounted by the active
    counters: a collective backend's own copy of its result into the
    output (gloo's ``work.wait()`` on the CPU), which the collective's
    count already holds."""
    sinks = list(SINKS)
    for s in sinks:
        s.enter_uncounted()
    try:
        yield
    finally:
        for s in sinks:
            s.exit_kernel()

