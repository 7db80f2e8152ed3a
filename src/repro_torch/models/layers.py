"""Core model primitives: norms, RoPE, MLPs, attention (full sequence and
one-token decode), embedding (dense subset of ``repro/models/layers.py``).

Functional, as in the reference: ``init_*`` builds a param dict,
``*_apply`` consumes it.  Full-sequence attention always goes through
``kernels.ops.flash_attention`` and every RMSNorm through
``kernels.ops.rmsnorm``: the Hopper kernels for CUDA tensors, the plain
versions for CPU tensors.  ``attention_decode`` is the one-token step of
the serving path, plain PyTorch as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(d: int, kind: str, dtype, device) -> dict:
    if kind == "layernorm":
        return {"scale": torch.ones(d, dtype=dtype, device=device),
                "bias": torch.zeros(d, dtype=dtype, device=device)}
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def norm_apply(p: dict, x: torch.Tensor, kind: str, eps: float = 1e-6):
    if kind != "layernorm":
        return ops.rmsnorm(x, p["scale"], eps)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def rms_norm_weighted(x: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-6):
    """RMSNorm with an explicit scale vector (qk-norm, the mamba gate)."""
    return ops.rmsnorm(x, scale, eps)


# ---------------------------------------------------------------------------
# Dense / MLP
# ---------------------------------------------------------------------------


def init_dense(gen, shape, dtype, device, scale=None) -> torch.Tensor:
    """Normal init scaled by 1/sqrt(fan_in) (``shape[-2]``), drawn in f32
    and cast, as the reference does.  A leading axis stacks layers."""
    s = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * s).to(dtype)


def init_mlp(gen, count: int, d_model: int, d_ff: int, gated: bool, dtype,
             device) -> dict:
    p = {"w_in": init_dense(gen, (count, d_model, d_ff), dtype, device),
         "w_out": init_dense(gen, (count, d_ff, d_model), dtype, device)}
    if gated:
        p["w_gate"] = init_dense(gen, (count, d_model, d_ff), dtype, device)
    return p


def mlp_apply(p: dict, x: torch.Tensor, act: str, gated: bool):
    h = x @ p["w_in"]
    a = F.gelu(h, approximate="tanh") if act == "gelu" else F.silu(h)
    if gated:
        a = a * (x @ p["w_gate"])
    return a @ p["w_out"]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, D) or (..., S, D); positions: (..., S) int.  Half-split
    rotation computed in f32, cast back to x's dtype."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions.float()[..., None] * freqs               # (..., S, half)
    if x.dim() == ang.dim() + 1:                             # head dim present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA, optional qk-norm, sliding window, softcap)
# ---------------------------------------------------------------------------


def init_attention(gen, count: int, cfg, d_model: int, dtype, device) -> dict:
    a = cfg.attn
    p = {
        "wq": init_dense(gen, (count, d_model, a.n_heads * a.head_dim),
                         dtype, device),
        "wk": init_dense(gen, (count, d_model, a.n_kv_heads * a.head_dim),
                         dtype, device),
        "wv": init_dense(gen, (count, d_model, a.n_kv_heads * a.head_dim),
                         dtype, device),
        "wo": init_dense(gen, (count, a.n_heads * a.head_dim, d_model),
                         dtype, device),
    }
    if a.qk_norm:
        p["q_norm"] = torch.ones(count, a.head_dim, dtype=dtype,
                                 device=device)
        p["k_norm"] = torch.ones(count, a.head_dim, dtype=dtype,
                                 device=device)
    return p


def attention_apply(p: dict, cfg, x: torch.Tensor, *, layer_is_local: bool,
                    positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence (train / prefill) attention for one layer.
    x: (B, S, d_model); positions: (S,) absolute positions."""
    a = cfg.attn
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, a.n_heads, a.head_dim)
    k = (x @ p["wk"]).reshape(B, S, a.n_kv_heads, a.head_dim)
    v = (x @ p["wv"]).reshape(B, S, a.n_kv_heads, a.head_dim)
    if a.qk_norm:
        q = rms_norm_weighted(q, p["q_norm"])
        k = rms_norm_weighted(k, p["k_norm"])
    q = apply_rope(q, positions[None], a.rope_theta)
    k = apply_rope(k, positions[None], a.rope_theta)
    window = a.window if (a.window and layer_is_local) else 0
    o = ops.flash_attention(q, k, v, causal=a.causal, window=window,
                            softcap=a.logit_softcap)
    return o.reshape(B, S, a.n_heads * a.head_dim) @ p["wo"]


def attention_decode(p: dict, cfg, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, *, layer_is_local: bool):
    """One-token decode.  x: (B, 1, d); cache_k/v: (B, C, KV, D) where C is
    the cache capacity (full length for global layers, the window for local
    ones).  ``pos``: an int or a (B,) tensor, the absolute position of each
    lane's new token (per-lane positions serve continuous batching).

    Local (sliding-window) layers keep a ring buffer of ``window`` slots;
    global layers write slot ``min(pos, C - 1)``.  The caches are updated in
    place (one lane's slot each) and returned: (out (B,1,d), k, v)."""
    a = cfg.attn
    B = x.shape[0]
    C = cache_k.shape[1]
    pos_b = torch.as_tensor(pos, device=x.device).long().reshape(-1) \
        .expand(B)
    q = (x @ p["wq"]).reshape(B, 1, a.n_heads, a.head_dim)
    k = (x @ p["wk"]).reshape(B, 1, a.n_kv_heads, a.head_dim)
    v = (x @ p["wv"]).reshape(B, 1, a.n_kv_heads, a.head_dim)
    if a.qk_norm:
        q = rms_norm_weighted(q, p["q_norm"])
        k = rms_norm_weighted(k, p["k_norm"])
    posv = pos_b[:, None]                                   # (B, 1)
    q = apply_rope(q, posv, a.rope_theta)
    k = apply_rope(k, posv, a.rope_theta)
    local = layer_is_local and a.window > 0
    slot = pos_b % max(C, 1) if local else torch.clamp(pos_b, max=C - 1)
    lanes = torch.arange(B, device=x.device)
    cache_k[lanes, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[lanes, slot] = v[:, 0].to(cache_v.dtype)
    # validity of each cache slot, per lane: (B, C)
    slots = torch.arange(C, device=x.device)[None, :]
    if local:
        filled = slots <= posv % C
        valid = filled | (posv >= C)                        # ring fill
        base = posv - posv % C
        abs_pos = torch.where(filled, base + slots, base + slots - C)
        valid &= (abs_pos > posv - a.window) & (abs_pos >= 0)
    else:
        valid = slots <= posv
    G = a.n_heads // a.n_kv_heads
    qg = q.reshape(B, 1, a.n_kv_heads, G, a.head_dim).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, cache_k.float())
    s = s / math.sqrt(a.head_dim)
    if a.logit_softcap:
        s = torch.tanh(s / a.logit_softcap) * a.logit_softcap
    s = s.masked_fill(~valid[:, None, None, None, :], -math.inf)
    w = torch.softmax(s, dim=-1)
    w = torch.where(torch.isnan(w), 0.0, w)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, cache_v.float())
    o = o.reshape(B, 1, a.n_heads * a.head_dim).to(x.dtype)
    return o @ p["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def init_embed(gen, vocab: int, d: int, dtype, device) -> dict:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return {"w": (w * 0.02).to(dtype)}


def embed_apply(p: dict, tokens: torch.Tensor, scale: bool, d: int):
    x = F.embedding(tokens.long(), p["w"])
    if scale:
        x = x * torch.tensor(math.sqrt(d), dtype=x.dtype, device=x.device)
    return x


def logits_apply(head_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """head_w: (vocab, d) (tied layout); returns f32 logits."""
    return x.float() @ head_w.float().T
