"""Mamba2 (SSD, state-space duality) block (port of
``repro/models/ssm.py``).  [arXiv:2405.21060]

The recurrence is

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t
    y_t = C_t . h_t + D x_t

computed over the full sequence in chunks by ``kernels.ops.ssd_scan`` (the
Hopper kernel for CUDA tensors, the plain version for CPU tensors).  There
is no ``kernel=`` switch: the reference's ``"jnp"`` and ``"pallas"`` paths
both map to that op.  ``ssd_decode_step`` is the token-serial recurrence:
the scan's second oracle, and the step of ``mamba_decode`` (the serving
path's one-token update of the conv history and the SSM state).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers

N_GROUPS = 1  # B/C projection groups


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """One-token recurrent update.
    state: (B,H,P,N); x: (B,H,P); dt: (B,H); Bm, Cm: (B,G,N).
    Returns (y (B,H,P), new_state)."""
    H = x.shape[1]
    rep = H // Bm.shape[1]
    Bh = torch.repeat_interleave(Bm, rep, dim=1)        # (B,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=1)
    decay = torch.exp(dt * A[None, :])                  # (B,H)
    new = (state * decay[:, :, None, None]
           + torch.einsum("bh,bhn,bhp->bhpn", dt, Bh, x))
    y = torch.einsum("bhn,bhpn->bhp", Ch, new)
    return y, new


def init_mamba(gen, count: int, cfg, dtype, device) -> dict:
    """Params of ``count`` stacked Mamba2 blocks (leading ``count`` axis)."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.n_heads(d)
    N = s.d_state
    conv_ch = di + 2 * N_GROUPS * N
    conv_w = torch.randn((count, s.d_conv, conv_ch), generator=gen,
                         dtype=torch.float32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": layers.init_dense(gen, (count, d, 2 * di + 2 * N_GROUPS * N
                                        + H), dtype, device),
        "conv_w": (conv_w / math.sqrt(s.d_conv)).to(dtype),
        "conv_b": torch.zeros((count, conv_ch), dtype=dtype, device=device),
        "dt_bias": torch.zeros((count, H), **f32),
        "A_log": torch.zeros((count, H), **f32),        # A = -exp(A_log) = -1
        "D": torch.ones((count, H), **f32),
        "gate_norm": torch.ones((count, di), dtype=dtype, device=device),
        "w_out": layers.init_dense(gen, (count, di, d), dtype, device),
    }


def _causal_conv(xbc, w, b):
    """Depthwise causal conv.  xbc: (B,S,C); w: (K,C).  The reference's sum
    of K shifted products, each rounded in the param dtype (F.conv1d would
    accumulate otherwise)."""
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    return out + b[None, None, :]


def _split_proj(cfg, zxbcdt):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    gn = N_GROUPS * s.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * gn]
    dt_raw = zxbcdt[..., di + di + 2 * gn:]
    return z, xbc, dt_raw


def mamba_apply(p: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward.  x: (B,S,d) -> (B,S,d)."""
    s = cfg.ssm
    B, S, d = x.shape
    di = s.d_inner(d)
    H = s.n_heads(d)
    N = s.d_state
    gn = N_GROUPS * N

    z, xbc, dt_raw = _split_proj(cfg, x @ p["w_in"])
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :di].reshape(B, S, H, s.head_dim).float()
    Bm = xbc[..., di:di + gn].reshape(B, S, N_GROUPS, N).float()
    Cm = xbc[..., di + gn:].reshape(B, S, N_GROUPS, N).float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    y, _ = ops.ssd_scan(xs, dt, A, Bm, Cm, chunk=s.chunk)
    y = y + p["D"][None, None, :, None] * xs
    y = y.reshape(B, S, di).to(x.dtype)
    y = layers.rms_norm_weighted(y * F.silu(z), p["gate_norm"])
    return y @ p["w_out"]


def mamba_init_state(cfg, batch: int, dtype=torch.float32,
                     device="cpu") -> dict:
    """Zero decode state of one Mamba2 layer: the SSM state (B,H,P,N) in
    float32 and the last ``d_conv - 1`` conv inputs (B, d_conv-1, C)."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.n_heads(d)
    return {
        "ssm": torch.zeros((batch, H, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1,
                             di + 2 * N_GROUPS * s.d_state),
                            dtype=dtype, device=device),
    }


def mamba_decode(p: dict, cfg, x: torch.Tensor, state: dict):
    """One-token decode.  x: (B,1,d); state: {"ssm", "conv"}.  Returns
    (y (B,1,d), new_state)."""
    s = cfg.ssm
    B, _, d = x.shape
    di = s.d_inner(d)
    H = s.n_heads(d)
    N = s.d_state
    gn = N_GROUPS * N

    z, xbc, dt_raw = _split_proj(cfg, x @ p["w_in"])     # (B,1,*)
    hist = torch.cat([state["conv"], xbc[:, 0][:, None]], dim=1)  # (B,K,C)
    # the reference's einsum: products summed in f32, rounded once
    out_dtype = torch.promote_types(hist.dtype, p["conv_w"].dtype)
    conv_out = (hist.float() * p["conv_w"].float()).sum(dim=1) \
        .to(out_dtype) + p["conv_b"]
    xbc_t = F.silu(conv_out)
    new_conv = hist[:, 1:]

    xs = xbc_t[:, :di].reshape(B, H, s.head_dim).float()
    Bm = xbc_t[:, di:di + gn].reshape(B, N_GROUPS, N).float()
    Cm = xbc_t[:, di + gn:].reshape(B, N_GROUPS, N).float()
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    y, new_ssm = ssd_decode_step(state["ssm"], xs, dt, A, Bm, Cm)
    y = y + p["D"][None, :, None] * xs
    y = y.reshape(B, 1, di).to(x.dtype)
    y = layers.rms_norm_weighted(y * F.silu(z), p["gate_norm"])
    return y @ p["w_out"], {"ssm": new_ssm, "conv": new_conv}
