"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

They are what the CPU runs, what ``chip_smoke.py`` holds each kernel
against on the card, and what the kernels' backward passes recompute
through.  ``simple_attention`` and ``blocked_attention`` port the jnp
oracles of ``repro/models/layers.py``.
"""
from __future__ import annotations

import math
import numbers

import torch

_INT_MAX = torch.iinfo(torch.int32).max


def _mask(q_pos, k_pos, causal: bool, window: int):
    mask = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window and window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def simple_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                     q_offset=None) -> torch.Tensor:
    """Unblocked attention (materializes full scores).  q: (B, Sq, H, D);
    k, v: (B, Sk, KV, D|Dv).  Returns (B, Sq, H, Dv) in q's dtype; fully
    masked rows give 0."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[3]
    G = H // KV
    if q_offset is None:
        q_offset = Sk - Sq
    qg = q.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    s = s / math.sqrt(D)
    if softcap and softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = _mask(q_pos, k_pos, causal, window)
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


def blocked_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                      q_block=512, kv_block=1024,
                      q_offset=None) -> torch.Tensor:
    """Flash-style blocked attention: online softmax over KV blocks, so no
    (Sq, Sk) score matrix is materialized.  Same contract as
    ``simple_attention``."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[3]
    G = H // KV
    if q_offset is None:
        q_offset = Sk - Sq
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Sk)
    nq = -(-Sq // q_block)
    nk = -(-Sk // kv_block)
    pad_q, pad_k = nq * q_block - Sq, nk * kv_block - Sk
    dev = q.device
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    idx = torch.arange(nk * kv_block, device=dev)
    k_poss = torch.where(idx < Sk, idx, _INT_MAX)

    outs = []
    for iq in range(nq):
        qi = qp[:, iq * q_block:(iq + 1) * q_block]
        q_pos = q_offset + iq * q_block + torch.arange(q_block, device=dev)
        qg = qi.reshape(B, q_block, KV, G, D).float()
        acc = torch.zeros(B, KV, G, q_block, Dv, device=dev)
        m = torch.full((B, KV, G, q_block), -math.inf, device=dev)
        l = torch.zeros(B, KV, G, q_block, device=dev)
        for jk in range(nk):
            sl = slice(jk * kv_block, (jk + 1) * kv_block)
            kpos = k_poss[sl]
            s = torch.einsum("bqkgd,bskd->bkgqs", qg, kp[:, sl].float())
            s = s / math.sqrt(D)
            if softcap and softcap > 0.0:
                s = torch.tanh(s / softcap) * softcap
            mask = _mask(q_pos, kpos, causal, window)
            mask &= (kpos < _INT_MAX)[None, :]
            s = s.masked_fill(~mask, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard all-masked rows
            m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isinf(s), 0.0, p)
            corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p, vp[:, sl].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_block, H, Dv))
    return torch.cat(outs, dim=1)[:, :Sq].to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """Plain attention: blocked online softmax for long sequences, direct
    softmax for short ones (they agree to float tolerance)."""
    if q.shape[1] > 1024:
        return blocked_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap, q_offset=q_offset)
    return simple_attention(q, k, v, causal=causal, window=window,
                            softcap=softcap, q_offset=q_offset)


# ---------------------------------------------------------------------------
# Max-plus (tropical) convolutions: the planner's DP step (the plain
# versions of ``repro/kernels/maxplus.py``'s three kernels).  Generic in
# dtype; each candidate is one add and max is order-free, so a float64 run
# equals the reference's numpy kernels bit for bit and a float32 run its
# float32 Pallas kernels.  The band is folded by a loop over k — the
# (n+1, band+1) candidate matrix is never built.
# ---------------------------------------------------------------------------


def _clamp_band(band, n: int) -> int:
    return n if band is None else max(0, min(int(band), n))


def maxplus_conv(prev, g, band=None) -> torch.Tensor:
    """``out[j] = max_{0 <= k <= min(j, band)} prev[j-k] + g[k]`` for 1-D
    ``prev`` and ``g`` of length n+1; ``band=None`` is dense."""
    n = prev.shape[0] - 1
    out = prev + g[0]
    for k in range(1, _clamp_band(band, n) + 1):
        out[k:] = torch.maximum(out[k:], prev[:n + 1 - k] + g[k])
    return out


def maxplus_conv_batched(prev, g, bands=None) -> torch.Tensor:
    """Row r of the (B, n+1) result is ``maxplus_conv(prev[r], g[r],
    bands[r])``: ``g`` is masked to -inf past each row's band, as the
    reference does (a masked candidate never beats the finite k=0 one).
    ``bands``: a sequence of per-row bands (``None`` = dense), or one band
    (or ``None``) for every row."""
    B, n1 = prev.shape
    n = n1 - 1
    if bands is None or isinstance(bands, numbers.Integral):
        bands = [bands] * B
    bs = torch.tensor([_clamp_band(b, n) for b in bands], dtype=torch.long,
                      device=prev.device)
    if bs.shape[0] != B:
        raise ValueError(f"got {bs.shape[0]} bands for a batch of {B}")
    ks = torch.arange(n1, device=prev.device)
    gm = torch.where(ks[None, :] > bs[:, None], -math.inf, g)
    out = prev + gm[:, :1]
    for k in range(1, int(bs.max()) + 1 if B else 0):
        out[:, k:] = torch.maximum(out[:, k:], prev[:, :n1 - k] + gm[:, k:k + 1])
    return out


def maxplus_scan_chunk(wins, gs) -> torch.Tensor:
    """The fused planner engine's chunk step over pre-gathered windows:
    ``out[r, j] = max_{0 <= k < K} wins[r, j + K-1-k] + gs[r, k]`` for
    ``wins`` (B, n1+K-1) and ``gs`` (B, K); returns (B, n1)."""
    B, K = gs.shape
    n1 = wins.shape[1] - (K - 1)
    out = torch.full((B, n1), -math.inf, dtype=wins.dtype, device=wins.device)
    for k in range(K):
        out = torch.maximum(out, wins[:, K - 1 - k:K - 1 - k + n1]
                            + gs[:, k:k + 1])
    return out
