"""Mamba2 and the zamba2 hybrid, plain PyTorch in float32: a frozen copy of
the mathematics of ``repro_torch/models/{model,blocks,layers,ssm}.py`` and
of the plain SSD scan of ``repro_torch/kernels/ref.py``, with no kernel,
cache or batching of the program.

Weights are ``weights.make``'s tree by path (stacked layers on axis 0).
The arithmetic's precision is a ``Precision``: every matrix product goes
through its ``mm`` (the head's through ``head``, which the program computes
in float32) and every activation that the program stores in its parameter
dtype (the embedding, the residual stream after each add, the conv, the
scan's output, the attention's output, the MLP's activation, the final
norm) through its ``act``.  ``F32`` is the reference: float32 products
with TF32 off (``float32_matmul``) and nothing rounded; the control
(``quant.FP8``) rounds both to float8.  Each layer is recomputed in the backward
(``torch.utils.checkpoint``), which keeps a full-depth model's activations
within the card beside its float32 state.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.weights import layer_order

EPS = 1e-6


class Precision(NamedTuple):
    mm: Callable
    head: Callable
    act: Callable


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


F32 = Precision(f32_mm, f32_mm, _same)


@contextlib.contextmanager
def float32_matmul():
    """Float32 products in float32: TF32 off for the ``with`` block."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rmsnorm(x, scale):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + EPS) \
        * scale


def ssd_scan(x, dt, A, Bm, Cm, chunk: int):
    """The chunked SSD scan: x (B,S,H,P), dt (B,S,H), A (H,), Bm, Cm
    (B,S,G,N); returns y (B,S,H,P).  The intra-chunk decay is masked
    before its exponent."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    xc = x.reshape(Bsz, nc, L, H, P)
    dtc = dt.reshape(Bsz, nc, L, H)
    rep = H // G
    Bh = torch.repeat_interleave(Bm.reshape(Bsz, nc, L, G, N), rep, dim=3)
    Ch = torch.repeat_interleave(Cm.reshape(Bsz, nc, L, G, N), rep, dim=3)
    acum = torch.cumsum(dtc * A, dim=2)
    diff = acum[:, :, :, None, :] - acum[:, :, None, :, :]
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    lmat = torch.exp(diff.masked_fill(~tri[None, None, :, :, None],
                                      -math.inf))
    scores = torch.einsum("bclhn,bcshn->bclsh", Ch, Bh)
    y_diag = torch.einsum("bclsh,bcshp->bclhp",
                          scores * lmat * dtc[:, :, None, :, :], xc)
    decay_st = torch.exp(acum[:, :, -1:, :] - acum)
    states = torch.einsum("bcshn,bcshp->bchpn",
                          Bh * (decay_st * dtc)[..., None], xc)
    chunk_decay = torch.exp(acum[:, :, -1, :])
    carry = torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    y_off = torch.einsum("bclhn,bchpn->bclhp", Ch, torch.stack(prev, 1)) \
        * torch.exp(acum)[..., None]
    return (y_diag + y_off).reshape(Bsz, nc * L, H, P)[:, :S]


def mamba(p: Dict, cfg: dict, x, prec: Precision):
    s, mm, act = cfg["ssm"], prec.mm, prec.act
    B, S, d = x.shape
    di = s["expand"] * d
    H, N, K = di // s["head_dim"], s["d_state"], s["d_conv"]
    zxbcdt = mm(x, p["w_in"])
    z, xbc, dt_raw = (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N],
                      zxbcdt[..., 2 * di + 2 * N:])
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    xbc = act(sum(pad[:, i:i + S, :] * p["conv_w"][i] for i in range(K))
              + p["conv_b"])
    xbc = act(F.silu(xbc))
    xs = xbc[..., :di].reshape(B, S, H, s["head_dim"])
    Bm = xbc[..., di:di + N].reshape(B, S, 1, N)
    Cm = xbc[..., di + N:].reshape(B, S, 1, N)
    dt = F.softplus(dt_raw + p["dt_bias"])
    y = ssd_scan(xs, dt, -torch.exp(p["A_log"]), Bm, Cm, s["chunk"])
    y = act((y + p["D"][:, None] * xs).reshape(B, S, di))
    return mm(act(rmsnorm(act(y * F.silu(z)), p["gate_norm"])), p["w_out"])


def _rope(x, theta: float):
    """Half-split rotary embedding of x (B,S,H,D) at positions 0..S-1."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p: Dict, cfg: dict, x, prec: Precision):
    a, mm, act = cfg["attn"], prec.mm, prec.act
    B, S, _ = x.shape
    H, KV, hd = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    q = act(_rope(mm(x, p["wq"]).reshape(B, S, H, hd), a["rope_theta"]))
    k = act(_rope(mm(x, p["wk"]).reshape(B, S, KV, hd), a["rope_theta"]))
    v = mm(x, p["wv"]).reshape(B, S, KV, hd)
    k = torch.repeat_interleave(k, H // KV, dim=2)
    v = torch.repeat_interleave(v, H // KV, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))        # (B,H,S,hd)
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if a.get("causal", True):
        mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~mask, -math.inf)
    o = act(mm(torch.softmax(s, dim=-1), v).transpose(1, 2))
    return mm(o.reshape(B, S, H * hd), p["wo"])


def mlp(p: Dict, cfg: dict, x, prec: Precision):
    h = prec.mm(x, p["w_in"])
    a = F.gelu(h, approximate="tanh") if cfg.get("mlp_act") == "gelu" \
        else F.silu(h)
    a = prec.act(a)
    if "w_gate" in p:
        a = prec.act(a * prec.mm(x, p["w_gate"]))
    return prec.mm(a, p["w_out"])


def _sub(params: Dict, prefix: str) -> Dict:
    """The leaves under ``prefix``, keyed by the rest of their path."""
    n = len(prefix) + 1
    out: Dict = {}
    for path, t in params.items():
        if path.startswith(prefix + "/"):
            node = out
            keys = path[n:].split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = t
    return out


def _layers(params: Dict, cfg: dict) -> List:
    """Per Mamba2 layer in forward order: (its leaves, shared after)."""
    stacked = {}
    for s, j, c, shared in layer_order(cfg):
        key = f"segments/{s}/{j}"
        if key not in stacked:
            tree = _sub(params, key)
            stacked[key] = {"norm": tree["norm"]["scale"].unbind(0),
                            "mamba": {k: v.unbind(0) for k, v in
                                      tree["mamba"].items()}}
        t = stacked[key]
        yield ({"norm": t["norm"][c],
                "mamba": {k: v[c] for k, v in t["mamba"].items()}}, shared)


def loss(params: Dict, tokens: torch.Tensor, cfg: dict,
         prec: Precision = F32, remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` (B,S)."""
    act = prec.act
    x = act(F.embedding(tokens, params["embed/w"]))
    shared = _sub(params, "shared")

    def mamba_layer(h, lp):
        return act(h + mamba(lp["mamba"], cfg, act(rmsnorm(h, lp["norm"])),
                             prec))

    def shared_block(h, *_):
        h = act(h + attention(shared["attn"], cfg,
                              act(rmsnorm(h, shared["norm1"]["scale"])),
                              prec))
        return act(h + mlp(shared["mlp"], cfg,
                           act(rmsnorm(h, shared["norm2"]["scale"])), prec))

    def run(fn, h, *args):
        return checkpoint(fn, h, *args, use_reentrant=False) if remat \
            else fn(h, *args)
    for lp, after in _layers(params, cfg):
        x = run(mamba_layer, x, lp)
        if after:
            x = run(shared_block, x)
    h = act(rmsnorm(x, params["final_norm/scale"]))
    head = params["embed/w"] if cfg.get("tie_embeddings") \
        else params["head/w"]

    def head_loss(h, head):
        logits = prec.head(h[:, :-1], head.T)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               tokens[:, 1:].reshape(-1))
    return run(head_loss, h, head)


def grads(params: Dict[str, torch.Tensor], microbatches, cfg: dict,
          prec: Precision = F32):
    """(mean loss, {path: mean gradient}) over ``microbatches`` (a list of
    (B,S) token tensors), each micro-batch's loss the mean over its
    tokens, as the program's step averages them."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total = {k: torch.zeros_like(v) for k, v in leaves.items()}
    losses = []
    for toks in microbatches:
        with torch.enable_grad():
            out = loss(leaves, toks, cfg, prec)
            gs = torch.autograd.grad(out, list(leaves.values()),
                                     allow_unused=True)
        for k, g in zip(leaves, gs):
            if g is not None:
                total[k].add_(g)
        losses.append(out.detach())
    n = len(microbatches)
    return torch.stack(losses).mean(), {k: g / n for k, g in total.items()}
