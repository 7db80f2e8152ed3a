"""Frozen copies of the port's work formulas (``repro_torch/kernels/work.py``:
``live_pairs``, ``attention_work``, ``attention_bwd_work``, ``ssd_work``,
``ssd_bwd_work``, ``ssd_bwd_recompute_ops``), kept here so that a change to
the program cannot move the yardstick.  Operations count two a
multiply-add; bytes count each input read once and each output written
once."""
from __future__ import annotations

import numpy as np


def live_pairs(Sq: int, Sk: int, causal: bool, window: int,
               q_offset: int) -> int:
    """(query, key) pairs the mask leaves live, per (batch, head)."""
    qp = np.arange(q_offset, q_offset + Sq, dtype=np.int64)
    hi = np.minimum(Sk - 1, qp) if causal else np.full_like(qp, Sk - 1)
    lo = np.maximum(0, qp - window + 1) if window > 0 else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def attention_work(B, Sq, Sk, H, KV, D, Dv, causal, window, q_offset,
                   elt: int, with_lse: bool = False):
    """Kernel 1: 2 (D + Dv) operations a live pair and head."""
    ops = 2.0 * B * H * live_pairs(Sq, Sk, causal, window, q_offset) \
        * (D + Dv)
    nbytes = elt * (B * Sq * H * D + B * Sk * KV * (D + Dv)
                    + B * Sq * H * Dv)
    if with_lse:
        nbytes += 4 * B * Sq * H
    return ops, nbytes


def attention_bwd_work(B, Sq, Sk, H, KV, D, Dv, causal, window, q_offset,
                       elt: int):
    """1-bwd: S and dP recomputed, dq, dk and dv: 2 (3 D + 2 Dv)
    operations a live pair and head; q, k, v, o, dO and lse read, dq, dk,
    dv written."""
    ops = 2.0 * B * H * live_pairs(Sq, Sk, causal, window, q_offset) \
        * (3 * D + 2 * Dv)
    q_side = B * Sq * H * (D + 2 * Dv + D)
    kv_side = 2 * B * Sk * KV * (D + Dv)
    return ops, elt * (q_side + kv_side) + 4 * B * Sq * H


def attention_bwd_recompute_ops(B, Sq, Sk, H, D, causal, window,
                                q_offset) -> float:
    """The part of 1-bwd's operations that re-forms the forward's scores
    S = q k^T: 2 D a live pair and head."""
    return 2.0 * B * H * live_pairs(Sq, Sk, causal, window, q_offset) * D


def ssd_work(B, S, H, P, G, N, chunk):
    """Kernel 6: the multiply-adds of the chunked algorithm and every input
    read once and both outputs written once (f32)."""
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


def ssd_bwd_work(B, S, H, P, G, N, chunk, with_gfin: bool):
    """6-bwd: the multiply-adds of the analytic VJP over each chunk's live
    tokens, and x, dt, A, Bm, Cm, gy (and gfin where given) read once, dx,
    ddt, dA, dBm, dCm written once (f32)."""
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


def ssd_bwd_recompute_ops(B, S, H, P, G, N, chunk) -> float:
    """The part of ``ssd_bwd_work``'s operations that re-forms what the
    forward had formed: C.B^T, each chunk's own state and S_prev.C."""
    L = min(chunk, S)
    ops = 0.0
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        ops += 2.0 * B * (G * n * (n + 1) / 2 * N
                          + H * n * N * P * (2 if c0 else 1))
    return ops


def train_flops_per_token(cfg: dict, micro_batch: int, seq: int) -> float:
    """Model operations of one trained token, forward and backward: 6 a
    token for each matrix-product parameter (the Mamba2 projections, the
    shared block's at each of its calls, the head once, tied or not), plus
    the SSD scan's chunk terms (``ssd_work`` forward, ``ssd_bwd_work``
    less what it re-forms) and causal attention's score and value terms
    (2 (D + Dv) a live pair forward, 2 (2 D + 2 Dv) backward).  Nothing
    recomputed is counted."""
    from portbench.weights import layer_order   # the layer plan
    d, s = cfg["d_model"], cfg["ssm"]
    di = s["expand"] * d
    H, N, P = di // s["head_dim"], s["d_state"], s["head_dim"]
    order = list(layer_order(cfg))
    n_mamba = len(order)
    n_shared = sum(1 for *_, shared in order if shared)
    tokens = micro_batch * seq
    mm = n_mamba * (d * (2 * di + 2 * N + H) + di * d) + cfg["vocab"] * d
    flops = 6.0 * mm * tokens
    fwd, _ = ssd_work(micro_batch, seq, H, P, 1, N, s["chunk"])
    bwd, _ = ssd_bwd_work(micro_batch, seq, H, P, 1, N, s["chunk"], False)
    bwd -= ssd_bwd_recompute_ops(micro_batch, seq, H, P, 1, N, s["chunk"])
    flops += n_mamba * (fwd + bwd)
    if n_shared:
        a, ff = cfg["attn"], cfg["d_ff"]
        q, kv = a["n_heads"] * a["head_dim"], a["n_kv_heads"] * a["head_dim"]
        shared = 2 * d * q + 2 * d * kv + (3 if cfg.get("gated_mlp", True)
                                           else 2) * d * ff
        D = a["head_dim"]
        pairs = live_pairs(seq, seq, a.get("causal", True), 0, 0)
        attn = 2.0 * micro_batch * a["n_heads"] * pairs * (D + D) \
            + 2.0 * micro_batch * a["n_heads"] * pairs * (2 * D + 2 * D)
        flops += n_shared * (6.0 * shared * tokens + attn)
    return flops / tokens
