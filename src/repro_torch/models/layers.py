"""Core model primitives: norms, RoPE, MLPs, attention (full sequence and
one-token decode), embedding (dense subset of ``repro/models/layers.py``).

Functional, as in the reference: ``init_*`` builds a param dict,
``*_apply`` consumes it.  Full-sequence attention always goes through
``kernels.ops.flash_attention`` and every RMSNorm through
``kernels.ops.rmsnorm``: the Hopper kernels for CUDA tensors, the plain
versions for CPU tensors.  ``ops.RmsNorm`` is the counterpart of the
reference's ``rmsnorm_fused`` (its analytic custom VJP): its backward is
that VJP, so every RMSNorm here differentiates as ``rmsnorm_fused`` does.  ``attention_decode`` is the one-token step of
the serving path, plain PyTorch as in the reference.

Tensor parallelism over a mesh's model axis (Megatron's layout, the
sharded step's and the dry-run's forward): given the mesh's ``groups``
(``sharding.collectives.MeshGroups``), ``attention_apply`` and
``mlp_apply`` take this model rank's shards (column-parallel ``wq``,
``wk``, ``wv``, ``w_in``, ``w_gate``; row-parallel ``wo``, ``w_out``; an
attention whose heads the axis does not divide reads its
``rules.head_block`` of whole leaves); the input enters through
``copy_to_region`` and the row-parallel product leaves through
``reduce_from_region``, one all-reduce over the model axis in each
direction; under sequence parallelism (``groups.seqpar``) the input
is this rank's block of the sequence, gathered on entry, and the product
leaves by a reduce-scatter over the sequence (``collectives.enter_region``,
``leave_region``).  ``embed_apply`` and ``logits_apply`` take this rank's
rows of the vocabulary.  ``attention_decode`` splits the heads as
``attention_apply`` does and, where a cache's slots are split over ranks,
runs as flash-decoding (``decode_weights``, ``collectives.
combine_attention``).  Without ``groups`` every function computes whole.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.sharding import collectives
from repro_torch.sharding.rules import head_block

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
    and cast, as the reference does.  A leading axis stacks layers.  Scaled
    in place: one f32 transient the size of the leaf, not two."""
    s = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(s).to(dtype)


def init_mlp(gen, count: int, d_model: int, d_ff: int, gated: bool, dtype,
             device) -> dict:
    p = {"w_in": init_dense(gen, (count, d_model, d_ff), dtype, device),
         "w_out": init_dense(gen, (count, d_ff, d_model), dtype, device)}
    if gated:
        p["w_gate"] = init_dense(gen, (count, d_model, d_ff), dtype, device)
    return p


def mlp_apply(p: dict, x: torch.Tensor, act: str, gated: bool,
              groups=None):
    """With a mesh's ``groups``, ``p`` holds this model rank's columns of
    ``w_in`` / ``w_gate`` and rows of ``w_out``: the rank's part of d_ff,
    summed over the model axis (under ``groups.seqpar``, x and the result
    this rank's block of the sequence)."""
    if groups is not None:
        x = collectives.enter_region(x, groups)
    h = x @ p["w_in"]
    a = F.gelu(h, approximate="tanh") if act == "gelu" else F.silu(h)
    if gated:
        a = a * (x @ p["w_gate"])
    y = a @ p["w_out"]
    if groups is not None:
        y = collectives.leave_region(y, groups)
    return y


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, d: int, theta: float):
    """cos and sin of the RoPE angles for head width ``d``: (..., S, d/2)
    in f32 for positions (..., S) int."""
    half = d // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(theta) / half))
    ang = positions.float()[..., None] * freqs               # (..., S, half)
    return torch.cos(ang), torch.sin(ang)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (..., S, H, D) or (..., S, D) rotated by ``rope_tables``' (...,
    S, D/2).  Half-split rotation computed in f32, cast back to x's
    dtype."""
    if x.dim() == cos.dim() + 1:                             # head dim present
        cos, sin = cos[..., None, :], sin[..., None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, D) or (..., S, D); positions: (..., S) int."""
    return rope_rotate(x, *rope_tables(positions, x.shape[-1], theta))


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


def _kv_of_heads(wk, wv, a, first: int, n: int):
    """Where the KV heads do not divide the model axis, each rank holds
    ``wk`` / ``wv`` whole (the reference's KV replication) and projects only
    the KV heads that its query heads ``first`` .. ``first + n - 1`` read
    (global head h reads KV head h // G).  Returns those columns of ``wk``
    and ``wv`` and, where the rank's heads read more than one KV head, the
    index of each query head's KV head among them (else None)."""
    hd, G = a.head_dim, a.n_heads // a.n_kv_heads
    lo, hi = first // G, (first + n - 1) // G
    cols = slice(lo * hd, (hi + 1) * hd)
    index = None
    if hi > lo:
        index = torch.arange(first, first + n, device=wk.device) // G - lo
    return wk[..., cols], wv[..., cols], index


def _q_heads(wq, wo, a, first: int, n: int, m: int):
    """``wq``'s columns and ``wo``'s rows of query heads ``first`` ..
    ``first + n - 1`` where the leaves are held whole, ``wo`` scaled by
    1 / ``m`` where m ranks compute each head; column- and row-parallel
    shards, which hold the block already, as they are."""
    if wq.shape[-1] != a.n_heads * a.head_dim:
        return wq, wo
    cols = slice(first * a.head_dim, (first + n) * a.head_dim)
    wq, wo = wq[..., cols], wo[..., cols, :]
    return wq, (wo / m if m > 1 else wo)


def attention_apply(p: dict, cfg, x: torch.Tensor, *, layer_is_local: bool,
                    positions: torch.Tensor, groups=None) -> torch.Tensor:
    """Full-sequence (train / prefill) attention for one layer.
    x: (B, S, d_model); positions: (S,) absolute positions.

    With a mesh's ``groups`` (``sharding.rules.attention_splits``), the
    rank computes its ``rules.head_block`` of query heads.  Where the axis
    divides them ``p`` holds that block: its columns of ``wq`` and rows of
    ``wo``, and columns of ``wk`` / ``wv`` where the KV heads divide the
    axis too, else ``wk`` / ``wv`` whole (``_kv_of_heads``).  Where it does
    not, every leaf is whole (``PARTIAL``) and the rank slices its heads:
    either blocks that differ by one head (granite-moe's 24 over 16), or,
    where the axis is a multiple m of the heads, head r // m on rank r,
    each of the head's m ranks adding 1/m of its output to the sum.  Under
    ``groups.seqpar`` x and the result are this rank's block of the
    sequence, and ``positions`` the whole sequence's."""
    a = cfg.attn
    hd = a.head_dim
    wq, wo, wk, wv, index = p["wq"], p["wo"], p["wk"], p["wv"], None
    H = a.n_heads
    if groups is not None:
        x = collectives.enter_region(x, groups)
        first, H, m = head_block(a.n_heads, groups.n_model, groups.model_rank)
        wq, wo = _q_heads(wq, wo, a, first, H, m)
        if wk.shape[-1] == a.n_kv_heads * hd:
            wk, wv, index = _kv_of_heads(wk, wv, a, first, H)
    B, S, _ = x.shape
    KV = wk.shape[-1] // hd
    q = (x @ wq).reshape(B, S, H, hd)
    k = (x @ wk).reshape(B, S, KV, hd)
    v = (x @ wv).reshape(B, S, KV, hd)
    if a.qk_norm:
        q = rms_norm_weighted(q, p["q_norm"])
        k = rms_norm_weighted(k, p["k_norm"])
    q = apply_rope(q, positions[None], a.rope_theta)
    k = apply_rope(k, positions[None], a.rope_theta)
    if index is not None:
        k, v = k[:, :, index], v[:, :, index]
    window = a.window if (a.window and layer_is_local) else 0
    o = ops.flash_attention(q, k, v, causal=a.causal, window=window,
                            softcap=a.logit_softcap)
    y = o.reshape(B, S, H * hd) @ wo
    if groups is not None:
        y = collectives.leave_region(y, groups)
    return y


class DecodePositions:
    """One decode step's positions, (B,) per lane, and what every attention
    layer of the step derives from them alone: the RoPE tables per head
    width, and per cache capacity and locality the slot each lane writes
    and the validity of every slot.  ``decode_step`` builds one per step
    and passes it down, so each is computed once a step, not once a layer
    (and, for RoPE, not once for q and again for k).  Nothing here reads a
    device value on the host."""

    def __init__(self, pos, batch: int, device):
        self.pos = torch.as_tensor(pos, device=device).long().reshape(-1) \
            .expand(batch)
        self._rope: dict = {}
        self._slots: dict = {}

    @functools.cached_property
    def lanes(self) -> torch.Tensor:
        return torch.arange(self.pos.shape[0], device=self.pos.device)

    def rope(self, d: int, theta: float):
        """``rope_tables`` of every lane's position: (B, 1, d/2) each."""
        key = (d, theta)
        if key not in self._rope:
            self._rope[key] = rope_tables(self.pos[:, None], d, theta)
        return self._rope[key]

    def slots(self, C: int, local: bool, window: int, offset: int = 0,
              n: int = None):
        """(slot (B,), valid (B, n)) for a cache of C slots: a local layer's
        ring of ``window`` slots, or a global layer writing slot
        ``min(pos, C - 1)``.  Slots are numbered over the whole cache; the
        validity is of slots ``offset`` .. ``offset + n - 1`` (all C by
        default), a rank's part of a cache whose capacity is split."""
        n = C if n is None else n
        key = (C, local, window, offset, n)
        if key not in self._slots:
            pos, posv = self.pos, self.pos[:, None]
            slot = pos % max(C, 1) if local else torch.clamp(pos, max=C - 1)
            slots = torch.arange(offset, offset + n, device=pos.device)[None]
            if local:
                filled = slots <= posv % C
                valid = filled | (posv >= C)                 # ring fill
                base = posv - posv % C
                abs_pos = torch.where(filled, base + slots, base + slots - C)
                valid &= (abs_pos > posv - window) & (abs_pos >= 0)
            else:
                valid = slots <= posv
            self._slots[key] = (slot, valid)
        return self._slots[key]


def write_slot(buf: torch.Tensor, pos: DecodePositions, slot: torch.Tensor,
               new: torch.Tensor, offset: int = 0, split: bool = False,
               drop=None) -> None:
    """Writes each lane's ``new`` entry (B, ...) at slot ``slot`` (B,),
    numbered over the whole cache, into ``buf`` (B, C, ...), which holds
    slots ``offset`` .. ``offset + C - 1``.  Where the capacity is
    ``split`` over ranks, or a lane's write is dropped (``drop`` (B,)
    true), the write is a select on the device: a lane whose slot another
    rank holds, or whose write is dropped, keeps its entry.  No host read
    of the positions, so a CUDA graph can capture it."""
    new = new.to(buf.dtype)
    if not split and drop is None:
        buf[pos.lanes, slot] = new
        return
    C = buf.shape[1]
    i = slot - offset
    keep = (i < 0) | (i >= C)
    if drop is not None:
        keep = keep | drop
    i = torch.clamp(i, 0, C - 1)
    keep = keep.reshape((-1,) + (1,) * (new.dim() - 1))
    buf[pos.lanes, i] = torch.where(keep, buf[pos.lanes, i], new)


def decode_weights(s: torch.Tensor, valid: torch.Tensor, split: bool):
    """The attention weights of masked scores ``s`` (..., slots), ``valid``
    broadcast to them: (w, None, None), the softmax with a fully masked
    row's NaNs sent to 0 as the reference sends them, or, where the
    capacity is ``split`` (flash-decoding), (exp(s - m), m, l) of this
    rank's slots: m its row max (``collectives.MASKED_MAX`` where no slot
    is valid) and l the sum, for ``collectives.combine_attention``."""
    s = s.masked_fill(~valid, -math.inf)
    if not split:
        w = torch.softmax(s, dim=-1)
        return torch.where(torch.isnan(w), 0.0, w), None, None
    m = s.amax(dim=-1)
    m = torch.where(m == -math.inf, collectives.MASKED_MAX, m)
    e = torch.exp(s - m[..., None])
    return e, m, e.sum(dim=-1)


def slots_over_model(groups, capacity_groups) -> bool:
    """Whether a cache's slots are split over the model axis of a mesh's
    ``groups``: then every model rank's scores need every head."""
    return bool(capacity_groups) and groups is not None and any(
        g is groups.model_group for g in capacity_groups)


def _kv_read(first: int, H: int, G: int, kv_base: int):
    """How query heads ``first`` .. ``first + H - 1`` read a cache whose
    first KV head is global KV head ``kv_base`` (global head h reads KV
    head h // G): (cache heads, query heads a cache head, None) where they
    read a run of cache heads alike, else (None, 1, index) of each query
    head's cache head."""
    lo, hi = first // G - kv_base, (first + H - 1) // G - kv_base
    if (lo == hi and H <= G) or (H % G == 0 and first % G == 0):
        return slice(lo, hi + 1), H // (hi - lo + 1), None
    return None, 1, torch.arange(first, first + H) // G - kv_base


def attention_decode(p: dict, cfg, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, *, layer_is_local: bool,
                     groups=None, capacity_groups=None, slot_offset: int = 0):
    """One-token decode.  x: (B, 1, d); cache_k/v: (B, C, KV, D) where C is
    the cache capacity (full length for global layers, the window for local
    ones).  ``pos``: an int, a (B,) tensor (the absolute position of each
    lane's new token; per-lane positions serve continuous batching) or the
    step's ``DecodePositions``.

    Local (sliding-window) layers keep a ring buffer of ``window`` slots;
    global layers write slot ``min(pos, C - 1)``.  The caches are updated in
    place (one lane's slot each) and returned: (out (B,1,d), k, v).

    With a mesh's ``groups`` (``sharding.rules.attention_splits``), ``p``
    holds this model rank's shards as ``attention_apply`` takes them and
    the rank computes its ``rules.head_block`` of query heads: its
    columns of ``wq``, its rows of ``wo`` summed over the model axis
    (scaled by 1/m where m ranks compute each head).  The cache holds
    this rank's KV heads where they divide the axis, else all of them:
    every rank then projects every KV head and writes the same entry, so
    the replicas stay equal, and its heads read their KV heads of it.

    With ``capacity_groups`` the cache holds slots ``slot_offset`` ..
    ``slot_offset + C - 1`` of a capacity split over those groups' ranks
    (``sharding.rules.cache_shards``: over ``model`` under ``kv_model``,
    over the data axes under ``shard_seq``), and the step is
    flash-decoding: the rank that holds slot ``pos`` writes it, the scores
    and the softmax's partial sums are taken over the local slots and
    combined over ``capacity_groups`` (``collectives.combine_attention``).
    The heads that the local slots serve are the rank's, or every head
    where the capacity is split over the model axis, and the rank's heads
    are then taken for ``wo``: q is gathered over the axis where ``wq`` is
    column-parallel, and projected whole where ``wq`` is held whole (the
    axis a multiple of the heads, or uneven blocks, whose q's differ in
    size from rank to rank)."""
    a = cfg.attn
    B = x.shape[0]
    hd = a.head_dim
    C = cache_k.shape[1]
    split = bool(capacity_groups)
    C_all = C * collectives.ranks_of(capacity_groups) if split else C
    if not isinstance(pos, DecodePositions):
        pos = DecodePositions(pos, B, x.device)
    wq, wo, wk, wv = p["wq"], p["wo"], p["wk"], p["wv"]
    first, H, m = (0, a.n_heads, 1) if groups is None else \
        head_block(a.n_heads, groups.n_model, groups.model_rank)
    every = slots_over_model(groups, capacity_groups)
    # wq held whole (PARTIAL): with every slot's heads needed, project all
    whole_q = groups is not None and wq.shape[-1] == a.n_heads * hd
    wq_block, wo = _q_heads(wq, wo, a, first, H, m)
    if not (every and whole_q):
        wq = wq_block
    q = (x @ wq).reshape(B, 1, -1, hd)
    k = (x @ wk).reshape(B, 1, -1, hd)
    v = (x @ wv).reshape(B, 1, -1, hd)
    if a.qk_norm:
        q = rms_norm_weighted(q, p["q_norm"])
        k = rms_norm_weighted(k, p["k_norm"])
    cos, sin = pos.rope(hd, a.rope_theta)
    q = rope_rotate(q, cos, sin)
    k = rope_rotate(k, cos, sin)
    if every and not whole_q:
        q = collectives.all_gather(q, groups.model_group, dim=2)
    local = layer_is_local and a.window > 0
    slot, valid = pos.slots(C_all, local, a.window, slot_offset, C)
    write_slot(cache_k, pos, slot, k[:, 0], slot_offset, split)
    write_slot(cache_v, pos, slot, v[:, 0], slot_offset, split)
    KV, G = cache_k.shape[2], a.n_heads // a.n_kv_heads
    kv_base = 0 if KV == a.n_kv_heads else groups.model_rank * KV
    Hs, first_s = (a.n_heads, 0) if every else (q.shape[2], first)
    heads, Gs, index = _kv_read(first_s, Hs, G, kv_base)
    # only the KV heads read are widened to f32
    sel = heads if index is None else index.to(x.device)
    ck, cv = cache_k[:, :, sel].float(), cache_v[:, :, sel].float()
    qg = q.reshape(B, 1, ck.shape[2], Gs, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, ck)
    s = s / math.sqrt(hd)
    if a.logit_softcap:
        s = torch.tanh(s / a.logit_softcap) * a.logit_softcap
    w, mx, l = decode_weights(s, valid[:, None, None, None, :], split)
    if not split:
        o = torch.einsum("bkgqs,bskd->bqkgd", w, cv)
    else:
        o = collectives.combine_attention(
            mx, l, torch.einsum("bkgqs,bskd->bkgqd", w, cv),
            capacity_groups).permute(0, 3, 1, 2, 4)
    o = o.reshape(B, 1, Hs, hd)
    if every:
        o = o[:, :, first:first + H]
    o = o.reshape(B, 1, H * hd).to(x.dtype)
    y = o @ wo
    if groups is not None:
        y = collectives.all_reduce(y, [groups.model_group])
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def init_embed(gen, vocab: int, d: int, dtype, device) -> dict:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return {"w": (w * 0.02).to(dtype)}


def embed_apply(p: dict, tokens: torch.Tensor, scale: bool, d: int,
                groups=None):
    """With a mesh's ``groups``, ``p["w"]`` is this model rank's rows of the
    vocabulary: each token is looked up where its row lies, zeros
    elsewhere, summed over the model axis (then scaled, as whole); under
    ``groups.seqpar`` the sum is a reduce-scatter over the sequence, which
    leaves this rank's block of it."""
    if groups is None:
        x = F.embedding(tokens.long(), p["w"])
    else:
        n = p["w"].shape[0]
        local = tokens.long() - groups.model_rank * n
        owned = (local >= 0) & (local < n)
        x = F.embedding(torch.where(owned, local, 0), p["w"])
        x = collectives.leave_region(x.masked_fill(~owned[..., None], 0),
                                     groups)
    if scale:
        # sqrt(d) rounded to x's dtype, as the reference's
        # ``jnp.asarray(sqrt(d), x.dtype)``; filled on the device, so a
        # decode step copies nothing from the host
        x = x * torch.full((), math.sqrt(d), dtype=x.dtype, device=x.device)
    return x


def logits_apply(head_w: torch.Tensor, x: torch.Tensor,
                 groups=None) -> torch.Tensor:
    """head_w: (vocab, d) (tied layout); returns f32 logits.  With a mesh's
    ``groups``, ``head_w`` is this model rank's rows of the vocabulary and
    the logits its slice, x entering through ``collectives.enter_region``
    (under ``groups.seqpar`` x is this rank's block of the sequence and
    the logits are the whole sequence's)."""
    if groups is not None:
        x = collectives.enter_region(x, groups)
    return x.float() @ head_w.float().T
