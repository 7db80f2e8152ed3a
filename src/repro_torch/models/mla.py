"""DeepSeek-V3 Multi-head Latent Attention (port of
``repro/models/mla.py``).  [arXiv:2412.19437]

The full-sequence forward materializes K/V from the compressed latent and
runs ``kernels.ops.flash_attention`` at D = qk_nope + qk_rope and Dv =
v_head_dim, as every full-sequence attention of the port does.  Decode uses
the *absorbed* formulation: the cache holds only the (kv_lora_rank +
qk_rope_head_dim) latent per token, and W_uk / W_uv are folded into the
query and output paths, computed in f32 as the reference does.

Params carry the leading ``count`` axis of a layer stack, as
``layers.init_attention``'s do; the functions below take one layer's.

Tensor parallelism over a mesh's model axis (``sharding.rules.mla_splits``:
the heads divide it): ``mla_apply(..., groups=)`` takes this model rank's
head-major columns of ``w_uq``, ``w_uk``, ``w_uv`` and rows of ``wo``, and
``w_dq``, ``w_dkv``, ``q_norm``, ``kv_norm`` whole.  The low-rank
down-projections and their norms are computed alike on every rank (the
named fallback of a split MLA, as in Megatron's: 7168 x (1536 + 576) of
deepseek-v3-671b's ~187 M attention weights a layer), x enters through
``collectives.enter_region`` and the row-parallel product leaves through
``leave_region``: one all-reduce each way, or under sequence parallelism
the sequence gathered on entry (the down-projections computed on the whole
sequence) and a reduce-scatter over it on exit.  The head counts come from
the shards' shapes.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.sharding import collectives


def init_mla(gen, count: int, cfg, dtype, device) -> dict:
    m = cfg.mla
    d = cfg.d_model
    H = cfg.attn.n_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim

    def dense(d_in, d_out):
        return layers.init_dense(gen, (count, d_in, d_out), dtype, device)

    def ones(n):
        return torch.ones(count, n, dtype=dtype, device=device)
    return {
        "w_dq": dense(d, m.q_lora_rank),
        "q_norm": ones(m.q_lora_rank),
        "w_uq": dense(m.q_lora_rank, H * (dn + dr)),
        "w_dkv": dense(d, m.kv_lora_rank + dr),
        "kv_norm": ones(m.kv_lora_rank),
        "w_uk": dense(m.kv_lora_rank, H * dn),
        "w_uv": dense(m.kv_lora_rank, H * dv),
        "wo": dense(H * dv, d),
    }


def _project_q(p, cfg, x, cos, sin):
    """(q_nope (B,S,H,dn), q_rope (B,S,H,dr)), q_rope rotated by the RoPE
    tables ``cos``, ``sin`` (``layers.rope_tables`` at width dr); H the
    heads of ``w_uq``'s columns."""
    m = cfg.mla
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    H = p["w_uq"].shape[-1] // (dn + dr)
    B, S, _ = x.shape
    cq = layers.rms_norm_weighted(x @ p["w_dq"], p["q_norm"])
    q = (cq @ p["w_uq"]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, layers.rope_rotate(q_rope, cos, sin)


def _project_kv_latent(p, cfg, x, cos, sin):
    """(ckv (B,S,rank), k_rope (B,S,dr)): the normed latent and the shared
    rotary key."""
    m = cfg.mla
    ckv_full = x @ p["w_dkv"]
    ckv = layers.rms_norm_weighted(ckv_full[..., :m.kv_lora_rank],
                                   p["kv_norm"])
    k_rope = layers.rope_rotate(ckv_full[..., m.kv_lora_rank:], cos, sin)
    return ckv, k_rope


def mla_apply(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
              groups=None) -> torch.Tensor:
    """Full-sequence (train / prefill).  x: (B,S,d); positions: (S,).
    With a mesh's ``groups``, ``p`` holds this model rank's block of heads
    (see the module docstring) and the output is summed over the model
    axis (under ``groups.seqpar``, x and the output this rank's block of
    the sequence)."""
    m = cfg.mla
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    H = p["w_uq"].shape[-1] // (dn + dr)
    if groups is not None:
        x = collectives.enter_region(x, groups)
    B, S, _ = x.shape
    cos, sin = layers.rope_tables(positions[None], dr, cfg.attn.rope_theta)

    q_nope, q_rope = _project_q(p, cfg, x, cos, sin)
    ckv, k_rope = _project_kv_latent(p, cfg, x, cos, sin)
    k_nope = (ckv @ p["w_uk"]).reshape(B, S, H, dn)
    v = (ckv @ p["w_uv"]).reshape(B, S, H, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, dr)], dim=-1)
    # scale 1/sqrt(dn + dr): q's last dim, as the kernel takes it
    o = ops.flash_attention(q, k, v, causal=True)
    y = o.reshape(B, S, H * dv) @ p["wo"]
    if groups is not None:
        y = collectives.leave_region(y, groups)
    return y


def mla_init_cache(cfg, batch: int, capacity: int, dtype, device) -> dict:
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, capacity, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "k_rope": torch.zeros((batch, capacity, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
    }


def mla_decode(p: dict, cfg, x: torch.Tensor, cache: dict, pos, *,
               groups=None, capacity_groups=None, slot_offset: int = 0):
    """Absorbed one-token decode.  x: (B,1,d); cache: the latent buffers
    {"ckv": (B,C,rank), "k_rope": (B,C,dr)}; ``pos``: an int, a (B,)
    tensor or the step's ``layers.DecodePositions``.

    Each lane writes its latent at slot ``pos``; a lane at ``pos >= C``
    writes nothing, as the reference's out-of-range ``.at[].set`` drops
    the write, and then attends over every slot.  The write is a select on
    the device (no host read of ``pos``), so a CUDA graph can capture the
    step.  The caches are updated in place and returned: (out (B,1,d),
    {"ckv", "k_rope"}).

    With a mesh's ``groups`` (``sharding.rules.mla_splits``), ``p`` holds
    this model rank's block of heads as ``mla_apply`` takes it and the
    output is summed over the model axis; the latent is the same on every
    rank.  With ``capacity_groups`` the cache holds slots ``slot_offset``
    .. ``slot_offset + C - 1`` of a capacity split over those groups'
    ranks (``layers.attention_decode``): the rank holding slot ``pos``
    writes it, and the absorbed scores over the local slots are combined
    over ``capacity_groups`` (``collectives.combine_attention``), over
    every head where the capacity is split over the model axis (q gathered
    over it), the rank's heads then taken for ``w_uv`` and ``wo``."""
    m = cfg.mla
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    H = p["w_uq"].shape[-1] // (dn + dr)
    B = x.shape[0]
    C = cache["ckv"].shape[1]
    split = bool(capacity_groups)
    C_all = C * collectives.ranks_of(capacity_groups) if split else C
    if not isinstance(pos, layers.DecodePositions):
        pos = layers.DecodePositions(pos, B, x.device)
    cos, sin = pos.rope(dr, cfg.attn.rope_theta)

    q_nope, q_rope = _project_q(p, cfg, x, cos, sin)      # (B,1,H,dn/dr)
    ckv_t, k_rope_t = _project_kv_latent(p, cfg, x, cos, sin)
    slot, valid = pos.slots(C_all, False, 0, slot_offset, C)  # (B,), (B, C)
    dropped = pos.pos >= C_all                            # (B,)
    for name, new in (("ckv", ckv_t), ("k_rope", k_rope_t)):
        layers.write_slot(cache[name], pos, slot, new[:, 0], slot_offset,
                          split, drop=dropped)

    # absorb W_uk into q: q_lat (B,1,H,rank)
    ckv = cache["ckv"].float()
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, H, dn).float()
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_uk)
    q_rope = q_rope.float()
    every = layers.slots_over_model(groups, capacity_groups)
    if every:
        q_lat = collectives.all_gather(q_lat, groups.model_group, dim=2)
        q_rope = collectives.all_gather(q_rope, groups.model_group, dim=2)
    s = (torch.einsum("bqhr,bsr->bhqs", q_lat, ckv)
         + torch.einsum("bqhd,bsd->bhqs", q_rope,
                        cache["k_rope"].float()))
    s = s / math.sqrt(dn + dr)
    w, mx, l = layers.decode_weights(s, valid[:, None, None, :], split)
    if not split:
        ctx = torch.einsum("bhqs,bsr->bqhr", w, ckv)
    else:
        ctx = collectives.combine_attention(
            mx, l, torch.einsum("bhqs,bsr->bhqr", w, ckv),
            capacity_groups).transpose(1, 2)
    if every:
        first = groups.model_rank * H
        ctx = ctx[:, :, first:first + H]
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, H, dv).float()
    o = torch.einsum("bqhr,rhd->bqhd", ctx, w_uv)
    o = o.reshape(B, 1, H * dv).to(x.dtype)
    y = o @ p["wo"]
    if groups is not None:
        y = collectives.all_reduce(y, [groups.model_group])
    return y, {"ckv": cache["ckv"], "k_rope": cache["k_rope"]}
