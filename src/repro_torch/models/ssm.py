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

Tensor parallelism over a mesh's model axis (``sharding.rules.
mamba_splits``: the heads divide it): ``mamba_apply(..., groups=)`` takes
this model rank's d_inner rows of ``w_out`` and columns of ``gate_norm``
(both head-major), and ``w_in``, ``conv_w``, ``conv_b``, ``dt_bias``,
``A_log`` and ``D`` whole.  The rank projects only its heads' columns of
``w_in`` (z, x and dt of its heads, all of B and C: ``N_GROUPS`` = 1, so
every head reads them), convolves those channels, scans its heads, and
normalises the gated output over the whole d_inner by a sum of squares
all-reduced over the model axis (the reference's norm as GSPMD splits it;
kernel 2 reads whole rows, so the split path's gate norm is PyTorch ops);
x enters through ``collectives.enter_region`` and the row-parallel
``w_out`` leaves through ``leave_region`` (under sequence parallelism the
sequence gathered before ``w_in``, since the causal conv and the scan need
all of it, and reduce-scattered after ``w_out``).  ``mamba_decode(...,
groups=)`` steps the rank's heads the same way from its shard of the
state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.sharding import collectives

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


def _split_proj(cfg, zxbcdt, di=None):
    """(z, xbc, dt_raw) of the projection [z | x | B | C | dt], whose z
    and x parts are ``di`` wide (d_inner by default)."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model) if di is None else di
    gn = N_GROUPS * s.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * gn]
    dt_raw = zxbcdt[..., di + di + 2 * gn:]
    return z, xbc, dt_raw


def _heads_of(p: dict, cfg, rank: int, n: int) -> dict:
    """``p`` with the leaves held whole cut to model rank ``rank``'s block
    of ``n``: its heads' columns of ``w_in`` ([z | x | B | C | dt] -> [z_r
    | x_r | B | C | dt_r]) and channels of ``conv_w`` / ``conv_b`` ([x |
    B | C] -> [x_r | B | C]), its heads of ``dt_bias``, ``A_log``, ``D``;
    ``gate_norm`` and ``w_out`` are the rank's shards already."""
    s = cfg.ssm
    di, H = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    gn2 = 2 * N_GROUPS * s.d_state
    dl, hl = di // n, H // n
    mine = slice(rank * dl, (rank + 1) * dl)
    heads = slice(rank * hl, (rank + 1) * hl)
    w, cw, cb = p["w_in"], p["conv_w"], p["conv_b"]
    out = dict(p)
    out["w_in"] = torch.cat(
        [w[..., mine], w[..., di + mine.start:di + mine.stop],
         w[..., 2 * di:2 * di + gn2],
         w[..., 2 * di + gn2 + heads.start:2 * di + gn2 + heads.stop]], -1)
    out["conv_w"] = torch.cat([cw[..., mine], cw[..., di:]], -1)
    out["conv_b"] = torch.cat([cb[..., mine], cb[..., di:]], -1)
    for k in ("dt_bias", "A_log", "D"):
        out[k] = p[k][..., heads]
    return out


def _gate_norm_split(y: torch.Tensor, scale: torch.Tensor, d: int, groups,
                     eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over rows whose ``d`` columns lie on the model ranks of
    ``groups``, ``y`` (..., d / n) and ``scale`` (d / n,) this rank's: the
    f32 sum of squares summed over the model axis (both ways, each rank
    reading it for its columns), then ``ref.rmsnorm``'s products."""
    yf = y.float()
    model = [groups.model_group]
    ss = collectives.copy_to_region(collectives.reduce_from_region(
        yf.square().sum(dim=-1, keepdim=True), model), model)
    return (yf * torch.rsqrt(ss / d + eps) * scale.float()).to(y.dtype)


def mamba_apply(p: dict, cfg, x: torch.Tensor, groups=None) -> torch.Tensor:
    """Full-sequence forward.  x: (B,S,d) -> (B,S,d).  With a mesh's
    ``groups``, ``p`` is as the module docstring says and the output is
    summed over the model axis (under ``groups.seqpar``, x and the output
    this rank's block of the sequence)."""
    s = cfg.ssm
    if groups is not None:
        x = collectives.enter_region(x, groups)
        p = _heads_of(p, cfg, groups.model_rank, groups.n_model)
    B, S, d = x.shape
    di = p["w_out"].shape[-2]                  # this rank's d_inner
    H = di // s.head_dim
    N = s.d_state
    gn = N_GROUPS * N

    z, xbc, dt_raw = _split_proj(cfg, x @ p["w_in"], di)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :di].reshape(B, S, H, s.head_dim).float()
    Bm = xbc[..., di:di + gn].reshape(B, S, N_GROUPS, N).float()
    Cm = xbc[..., di + gn:].reshape(B, S, N_GROUPS, N).float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    y, _ = ops.ssd_scan(xs, dt, A, Bm, Cm, chunk=s.chunk)
    y = y + p["D"][None, None, :, None] * xs
    y = y.reshape(B, S, di).to(x.dtype)
    if groups is None:
        y = layers.rms_norm_weighted(y * F.silu(z), p["gate_norm"])
        return y @ p["w_out"]
    y = _gate_norm_split(y * F.silu(z), p["gate_norm"], s.d_inner(d),
                         groups)
    return collectives.leave_region(y @ p["w_out"], groups)


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


def mamba_decode(p: dict, cfg, x: torch.Tensor, state: dict, groups=None):
    """One-token decode.  x: (B,1,d); state: {"ssm", "conv"}.  Returns
    (y (B,1,d), new_state).  With a mesh's ``groups``, ``p`` is as
    ``mamba_apply`` takes it and ``state`` this rank's shard
    (``sharding.rules.cache_shards``): its heads of the SSM state and the
    [x_r | B | C] channels of the conv history.  The rank projects and
    convolves
    its heads' channels, steps its heads' recurrence, normalises the gate
    over the whole d_inner (``_gate_norm_split``) and sums the row-parallel
    ``w_out`` over the model axis."""
    s = cfg.ssm
    B, _, d = x.shape
    if groups is not None:
        p = _heads_of(p, cfg, groups.model_rank, groups.n_model)
    di = p["w_out"].shape[-2]                  # this rank's d_inner
    H = di // s.head_dim
    N = s.d_state
    gn = N_GROUPS * N

    z, xbc, dt_raw = _split_proj(cfg, x @ p["w_in"], di)  # (B,1,*)
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
    if groups is None:
        y = layers.rms_norm_weighted(y * F.silu(z), p["gate_norm"])
        return y @ p["w_out"], {"ssm": new_ssm, "conv": new_conv}
    y = _gate_norm_split(y * F.silu(z), p["gate_norm"], s.d_inner(d),
                         groups)
    return collectives.all_reduce(y @ p["w_out"], [groups.model_group]), \
        {"ssm": new_ssm, "conv": new_conv}
