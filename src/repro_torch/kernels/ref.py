"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

They are what the CPU runs and what ``chip_smoke.py`` holds each kernel
against on the card.  ``simple_attention`` and ``blocked_attention`` port
the jnp oracles of ``repro/models/layers.py``; ``flash_attention_lse`` and
``flash_attention_bwd`` have the mathematics of
``repro/models/flash_vjp.py`` (``_fwd_blocked``, ``_bwd_blocked``);
``ssd_scan`` ports ``repro/models/ssm.py:ssd_chunked`` and
``ssd_scan_bwd`` is its analytic VJP (the reference differentiates
``ssd_scan`` with ``jax.vjp``); ``rmsnorm`` is the
one of ``repro/kernels/ref.py`` and ``rmsnorm_bwd`` its analytic backward
(``repro/models/layers.py:_rmsnorm_fused_bwd``).
"""
from __future__ import annotations

import math
import numbers

import torch

_INT_MAX = torch.iinfo(torch.int32).max
NEG = -1e30          # repro/models/flash_vjp.py's finite mask value


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


def _scores(q, k, causal, window, softcap, q_offset):
    """(s, dcap, mask), each (B, KV, G, Sq, Sk) f32: the scaled and
    soft-capped scores with masked entries at NEG, d s / d s_raw (1 without
    a soft-cap), and the mask, as ``flash_vjp``'s ``p_and_dcap``."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(D)
    if softcap and softcap > 0.0:
        t = torch.tanh(s / softcap)
        s, dcap = t * softcap, 1.0 - t * t
    else:
        dcap = torch.ones_like(s)
    mask = _mask(q_offset + torch.arange(Sq, device=q.device),
                 torch.arange(Sk, device=q.device), causal, window)
    return s.masked_fill(~mask, NEG), dcap, mask


def flash_attention_lse(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0):
    """``flash_attention``'s output and each row's log-sum-exp (B, Sq, H)
    f32: lse = m + log(max(l, 1e-30)), m the row's max over its scores with
    masked entries at NEG (so NEG for a row with no live key) and l the sum
    of exp(s - m) over its live keys, as ``flash_vjp._fwd_blocked``."""
    B, Sq, H, _ = q.shape
    s, _, mask = _scores(q, k, causal, window, softcap, q_offset)
    m = s.amax(dim=-1)
    l = torch.where(mask, torch.exp(s - m[..., None]), 0.0).sum(dim=-1)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    o = flash_attention(q, k, v, causal=causal, window=window,
                        softcap=softcap, q_offset=q_offset)
    return o, lse.permute(0, 3, 1, 2).reshape(B, Sq, H)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        q_offset: int = 0):
    """(dq, dk, dv) of attention at (q, k, v) for the output gradient
    ``do``, from the forward's ``o`` and ``lse`` (``flash_attention_lse``),
    in the inputs' dtypes; f32 arithmetic, unblocked.  The mathematics of
    ``repro/models/flash_vjp.py:_bwd_blocked``: Dvec = rowsum(do * o),
    P = exp(s - lse) on live entries (0 elsewhere), dS = P (dP - Dvec)
    dcap / sqrt(D), dq = dS K, dk = dS^T Q and dv = P^T dO, each summed
    over the G query heads of a KV head."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    s, dcap, mask = _scores(q, k, causal, window, softcap, q_offset)

    def grouped(x):           # (B, Sq, H, ...) -> (B, KV, G, Sq, ...)
        x = x.float().reshape((B, Sq, KV, G) + x.shape[3:])
        return x.permute((0, 2, 3, 1) + tuple(range(4, x.dim())))
    dof = grouped(do)
    dvec = (dof * grouped(o)).sum(dim=-1)
    p = torch.where(mask, torch.exp(s - grouped(lse)[..., None]), 0.0)
    dp = torch.einsum("bkgqd,bskd->bkgqs", dof, v.float())
    ds = p * (dp - dvec[..., None]) * dcap / math.sqrt(D)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float())
    dk = torch.einsum("bkgqs,bkgqd->bskd", ds, grouped(q))
    dv = torch.einsum("bkgqs,bkgqd->bskd", p, dof)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Mamba2 SSD chunk scan (port of ``repro/models/ssm.py:ssd_chunked``).
    x: (B,S,H,P) f32; dt: (B,S,H) f32 (>0); A: (H,) f32 (<0); Bm, Cm:
    (B,S,G,N) f32 with H % G == 0.  Returns (y (B,S,H,P), final_state
    (B,H,P,N)).

    The reference's chunking (``L = min(chunk, S)``, zero padding), head ->
    group mapping (head h reads group h // (H // G)) and inter-chunk loop,
    with one change: the intra-chunk decay ``exp(acum[l] - acum[s])`` is
    masked *before* the exponent (``exp(-inf) = 0`` for s > l).  The
    reference masks after it, and for s > l the exponent is the chunk's sum
    of ``dt * |A|``: past 88 (f32's ``exp`` limit) that entry is ``inf``.
    The forward values are the same, but the reference's gradient takes
    ``0 * inf = NaN`` there (at chunk 128 with mamba2's init it does); this
    version's gradient is finite.
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, 0, 0, pad))
    xc = x.reshape(Bsz, nc, L, H, P)
    dtc = dt.reshape(Bsz, nc, L, H)
    Bc = Bm.reshape(Bsz, nc, L, G, N)
    Cc = Cm.reshape(Bsz, nc, L, G, N)

    a = dtc * A[None, None, None, :]                    # (B,c,L,H) log-decay
    acum = torch.cumsum(a, dim=2)                       # inclusive cumsum

    # intra-chunk: Lmat[l,s] = exp(acum[l]-acum[s]) for s<=l, masked first
    diff = acum[:, :, :, None, :] - acum[:, :, None, :, :]   # (B,c,L,L,H)
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    lmat = torch.exp(diff.masked_fill(~tri[None, None, :, :, None],
                                      -math.inf))

    rep = H // G
    Bh = torch.repeat_interleave(Bc, rep, dim=3)        # (B,c,L,H,N)
    Ch = torch.repeat_interleave(Cc, rep, dim=3)
    scores = torch.einsum("bclhn,bcshn->bclsh", Ch, Bh)  # (B,c,L,L,H)
    w = scores * lmat * dtc[:, :, None, :, :]
    y_diag = torch.einsum("bclsh,bcshp->bclhp", w, xc)

    # chunk-end states: sum_s exp(acum[-1]-acum[s]) dt_s B_s x_s
    decay_st = torch.exp(acum[:, :, -1:, :] - acum)     # (B,c,L,H)
    states = torch.einsum("bcshn,bcshp->bchpn",
                          Bh * (decay_st * dtc)[..., None], xc)
    chunk_decay = torch.exp(acum[:, :, -1, :])          # (B,c,H)

    # inter-chunk recurrence: the state BEFORE each chunk
    carry = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)              # (B,c,H,P,N)

    y_off = torch.einsum("bclhn,bchpn->bclhp", Ch, prev_states) \
        * torch.exp(acum)[..., None]
    y = (y_diag + y_off).reshape(Bsz, nc * L, H, P)[:, :S]
    return y, carry


def ssd_scan_bwd(x, dt, A, Bm, Cm, gy, gfin=None, *, chunk: int = 128):
    """(dx, ddt, dA, dBm, dCm), all f32: the exact gradient of
    ``ssd_scan`` at (x, dt, A, Bm, Cm) for the cotangents ``gy`` of y
    (B,S,H,P) and ``gfin`` of the final state (B,H,P,N), or None for a
    dropped final state.  The analytic VJP in the passes of
    ``csrc/ssd_scan_bwd.cu``, with acum the in-chunk inclusive cumsum of
    a = dt A, e = exp(acum), f_s = exp(acum[L-1] - acum[s]) dt_s:

    1. the forward's C.B^T, each chunk's own state and the carry S_prev;
    2. local_c = sum_l e_l gy_l (x) C_l, the gradient y's inter-chunk
       term sends to the state entering chunk c;
    3. a reverse carry: dS_out of the last chunk is gfin, and
       dS_out(c-1) = exp(acum_c[L-1]) dS_out(c) + local_c;
    4. per chunk and head: dW = gy.x^T on s <= l, dCB = dW decay dt_s,
       dx, dB, dC, and the gradient of acum taken into dt's and A's in
       its stable form (no sum of terms that cancel): the reverse cumsum
       of d acum at token j is sum_{l>=j} gy_l.y_off_l
       + sum_{l>=j, s<j} dW[l,s] W[l,s] + sum_{s<j} f_s r_s
       + exp(acum[L-1]) <dS_out, S_prev>, r_s = x_s.(dS_out B_s).

    Head h reads group h // (H/G), so dBm and dCm sum the group's heads.
    No exp of a positive difference is formed, so the gradient is finite
    where the reference's is NaN (see ``ssd_scan``).  Tokens past S take
    dt = 0, as in the forward."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    x, dt, Bm, Cm, gy = (t.float() for t in (x, dt, Bm, Cm, gy))
    if pad:
        x, gy = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                 for t in (x, gy))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm, Cm = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                  for t in (Bm, Cm))
    xc = x.reshape(Bsz, nc, L, H, P)
    gyc = gy.reshape(Bsz, nc, L, H, P)
    dtc = dt.reshape(Bsz, nc, L, H)
    Bh = torch.repeat_interleave(Bm.reshape(Bsz, nc, L, G, N), rep, dim=3)
    Ch = torch.repeat_interleave(Cm.reshape(Bsz, nc, L, G, N), rep, dim=3)

    # 1. the forward's quantities
    acum = torch.cumsum(dtc * A[None, None, None, :], dim=2)   # (B,c,L,H)
    at = acum[:, :, -1, :]                                      # (B,c,H)
    diff = acum[:, :, :, None, :] - acum[:, :, None, :, :]     # (B,c,L,L,H)
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    tri5 = tri[None, None, :, :, None]
    decay = torch.exp(diff.masked_fill(~tri5, -math.inf))      # [l, s]
    cb = torch.einsum("bclhn,bcshn->bclsh", Ch, Bh)
    e = torch.exp(acum)
    f = torch.exp(at[:, :, None, :] - acum) * dtc
    states = torch.einsum("bcshn,bcshp->bchpn", Bh * f[..., None], xc)
    carry = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * torch.exp(at[:, c])[..., None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                             # (B,c,H,P,N)

    # 2. the inter-chunk term's gradient of each chunk's incoming state
    local = torch.einsum("bclhp,bclhn->bchpn", gyc * e[..., None], Ch)

    # 3. the reverse carry: dso[:, c] is the gradient of the state leaving
    # chunk c (entering c + 1)
    g = torch.zeros_like(carry) if gfin is None else gfin.float()
    dso = []
    for c in reversed(range(nc)):
        dso.append(g)
        g = g * torch.exp(at[:, c])[..., None, None] + local[:, c]
    dso = torch.stack(dso[::-1], dim=1)                         # (B,c,H,P,N)

    # 4. per chunk and head
    dw = torch.einsum("bclhp,bcshp->bclsh", gyc, xc) * tri5
    dcb = dw * decay * dtc[:, :, None, :, :]
    z = dw * decay * cb                         # d(dt_s) from W, per (l, s)
    q = z * dtc[:, :, None, :, :]               # d(acum) pairs dW W
    gint = torch.einsum("bclsh,bclhp->bcshp", cb * decay, gyc)
    u = torch.einsum("bcshn,bchpn->bcshp", Bh, dso)
    dx = gint * dtc[..., None] + u * f[..., None]
    r = (xc * u).sum(dim=-1)                                    # (B,c,L,H)
    dC = torch.einsum("bclsh,bcshn->bclhn", dcb, Bh) + e[..., None] * \
        torch.einsum("bclhp,bchpn->bclhn", gyc, prev)
    dB = torch.einsum("bclsh,bclhn->bcshn", dcb, Ch) + f[..., None] * \
        torch.einsum("bcshp,bchpn->bcshn", xc, dso)
    ddt = z.sum(dim=2) + torch.exp(at[:, :, None, :] - acum) * r

    # the reverse cumsum of d acum, in its stable form
    o = e * (gyc * torch.einsum("bclhn,bchpn->bclhp", Ch, prev)).sum(-1)
    rev_o = torch.flip(torch.cumsum(torch.flip(o, (2,)), dim=2), (2,))
    qex = torch.cumsum(q, dim=3) - q            # [l, j]: sum_{s<j} q[l, s]
    t = (qex * tri5).sum(dim=2)                 # [j]: sum_{l>=j}
    fr = f * r
    kc = torch.exp(at) * (dso * prev).sum(dim=(-1, -2))        # (B,c,H)
    da = rev_o + t + (torch.cumsum(fr, dim=2) - fr) + kc[:, :, None, :]
    ddt = ddt + A[None, None, None, :] * da
    dA = (dtc * da).sum(dim=(0, 1, 2))

    def tokens(v):                              # (B,c,L,...) -> (B,S,...)
        return v.reshape((Bsz, nc * L) + v.shape[3:])[:, :S]

    def grouped(v):                             # sum the group's heads
        return tokens(v.reshape(Bsz, nc, L, G, rep, N).sum(dim=4))
    return tokens(dx), tokens(ddt), dA, grouped(dB), grouped(dC)


# ---------------------------------------------------------------------------
# Max-plus (tropical) convolutions: the planner's DP step (the plain
# versions of ``repro/kernels/maxplus.py``'s three kernels).  Generic in
# dtype; each candidate is one add and max is order-free (``_max``), so a
# float64 run equals the reference's numpy kernels bit for bit and a
# float32 run its float32 Pallas kernels (on a -0.0/+0.0 tie the numpy
# kernels' sign follows their lane order; these follow the Pallas
# kernels').  The band is folded by a loop over k — the (n+1, band+1)
# candidate matrix is never built.
# ---------------------------------------------------------------------------


def _max(a, b) -> torch.Tensor:
    """``torch.maximum`` with -0.0 below +0.0 whichever operand comes
    first, as the reference's Pallas kernels (``jnp.maximum``) and the card
    order them.  The CPU's ``torch.maximum`` returns its second operand on
    a +-0 tie in vectorised lanes and its first in the scalar tail."""
    return torch.where((a == 0) & (b == 0), a + b, torch.maximum(a, b))


def rmsnorm(x, scale, *, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last dim, in float32,
    cast back to x's dtype (port of ``repro/kernels/ref.py:rmsnorm``, the
    products in its order)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd(x, scale, g, *, eps: float = 1e-6):
    """(dx, dscale) of ``rmsnorm`` at (x, scale) for the output cotangent
    ``g``: the analytic VJP of ``repro/models/layers.py:_rmsnorm_fused_bwd``
    op for op, in float32; dx in x's dtype and shape, dscale (d,) in
    scale's dtype, summed over every row of x (..., d)."""
    xf, gf = x.float(), g.float()
    d = x.shape[-1]
    ms = xf.square().mean(dim=-1, keepdim=True)
    r = torch.rsqrt(ms + eps)
    gs = gf * scale.float()
    dot = (gs * xf).sum(dim=-1, keepdim=True) / d
    dx = (r * gs - xf * (r * r * r) * dot).to(x.dtype)
    dscale = (gf * xf * r).reshape(-1, d).sum(dim=0).to(scale.dtype)
    return dx, dscale


def _clamp_band(band, n: int) -> int:
    return n if band is None else max(0, min(int(band), n))


def maxplus_conv(prev, g, band=None) -> torch.Tensor:
    """``out[j] = max_{0 <= k <= min(j, band)} prev[j-k] + g[k]`` for 1-D
    ``prev`` and ``g`` of length n+1; ``band=None`` is dense."""
    n = prev.shape[0] - 1
    out = prev + g[0]
    for k in range(1, _clamp_band(band, n) + 1):
        out[k:] = _max(out[k:], prev[:n + 1 - k] + g[k])
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
        out[:, k:] = _max(out[:, k:], prev[:, :n1 - k] + gm[:, k:k + 1])
    return out


def maxplus_scan_chunk(wins, gs) -> torch.Tensor:
    """The fused planner engine's chunk step over pre-gathered windows:
    ``out[r, j] = max_{0 <= k < K} wins[r, j + K-1-k] + gs[r, k]`` for
    ``wins`` (B, n1+K-1) and ``gs`` (B, K); returns (B, n1)."""
    B, K = gs.shape
    n1 = wins.shape[1] - (K - 1)
    out = torch.full((B, n1), -math.inf, dtype=wins.dtype, device=wins.device)
    for k in range(K):
        out = _max(out, wins[:, K - 1 - k:K - 1 - k + n1] + gs[:, k:k + 1])
    return out


def maxplus_scan_step(buf, tables, step: int, K: int, n1: int, padl: int,
                      width: int, dtype) -> None:
    """One step of the fused planner program (kernel 5 on the fused
    engine's path), in place on the flat float64 slot buffer ``buf``: slot
    s holds its values at ``buf[s*width + padl : s*width + padl + n1]``
    with -inf margins.  ``tables`` is int32 (5, steps, G): each row r of
    ``step`` is (src, gsl, off, band, out) and computes, in ``dtype``,

        acc[j] = max_{0 <= k < min(K, band-off+1)}
                     buf[src, padl-off+j-k] + buf[gsl, padl+off+k]

    then ``buf[out, padl+j] = max(buf[out, padl+j], float64(acc[j]))``.
    A dummy row (band = -1) does nothing.  No row of a step reads a slot
    that a row of the same step writes (the schedule's dependency levels),
    so taking the rows in turn is the step."""
    for src, gsl, off, band, out in tables[:, step].T.tolist():
        if band < 0:
            continue
        kc = min(K, band - off + 1)
        w0 = src * width + padl - off - (kc - 1)
        g0 = gsl * width + padl + off
        acc = maxplus_scan_chunk(buf[None, w0:w0 + n1 + kc - 1].to(dtype),
                                 buf[None, g0:g0 + kc].to(dtype))[0]
        o0 = out * width + padl
        dst = buf[o0:o0 + n1]
        dst.copy_(_max(dst, acc.to(torch.float64)))
