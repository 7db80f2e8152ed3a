"""Mixture-of-experts FFN (port of ``repro/models/moe.py``, its flat
dispatch layout).

Tokens are routed top-k, sorted by expert id (a stable sort, so the same
tokens overflow an expert's capacity as in the reference) and scattered
into a fixed (E, C, d) capacity buffer, so the expert products are dense
batched matmuls of static shape.  Tokens beyond an expert's capacity are
dropped (GShard semantics); the router's aux loss keeps the load balanced.
Shared experts (DeepSeek) are a plain MLP over all tokens.

A chip's share of expert parallelism (``MoEConfig.expert_shards`` > 1) is
the reference's ``_moe_local`` (the body of its shard_map variant) in this
dispatch: the router keeps its published width and top-k and the aux loss
comes from the routing over all E experts, while only the
``experts_held`` experts of block ``expert_shard`` are held and computed;
assignments to the others go to the trash slot, so ``moe_apply`` returns
this chip's part of the routed result (plus the shared expert, which
every chip computes alike).  No collective: what the other chips' experts
add is left out, as a deployment's exchange would bring it.  The default
share (1 of 1) is the whole layer.

The reference's two dispatch layouts (``DISPATCH_3D``) compute the same
function; the port has one.  Its combine is deterministic on the card:
each token gathers its K slots into (T, K, d) and adds them in ascending
expert order (the order of the reference's scatter-add), and the dispatch
copies each token into its K slots by value, so neither direction
accumulates with atomics.  Nothing reads a device value on the host: the
capacity is a Python int of the shapes, so a CUDA graph can capture the
decode step.

``moe_apply_ep`` is expert parallelism over a mesh's model axis (the port
of the reference's ``moe_apply_shardmap``): each model rank runs the share
body on the expert block it holds, the partial results are summed over the
model ranks, and the router's statistics over the data ranks, so the aux
loss is the global batch's.  Where the routed experts do not divide the
model axis but their d_ff does (``sharding.rules.expert_ffn_splits``),
``moe_apply_dff`` splits every expert over d_ff instead, as the
reference's GSPMD does: the routing runs whole and alike on every rank
(the same code as ``moe_apply``, so the same tokens drop), each rank runs
the experts on its d_ff columns and the partial outputs are summed over
the model ranks.  Both paths run the shared expert as a tensor-parallel
MLP where its d_ff divides the axis (``sharding.rules.
shared_expert_splits``).  A block takes these paths when the model's
forward is given a mesh's groups (``blocks.block_apply(..., groups=)``).
Under sequence parallelism (``groups.seqpar``) both take this rank's block
of the sequence: the router runs on the tokens gathered over the model
axis (so the capacity, and which assignments drop, are those of the
unsplit layer), and the experts' partial sums (with a split shared
expert's) leave by one reduce-scatter over the sequence.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.sharding import collectives, rules


def capacity(n_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    c = int(math.ceil(n_tokens * top_k * capacity_factor / n_experts))
    return max(8, -(-c // 8) * 8)                 # round up to multiple of 8


def init_moe(gen, count: int, cfg, dtype, device) -> dict:
    """``count`` stacked MoE FFNs: a float32 router (d, E) whatever
    ``dtype`` is, as the reference's, and the experts held here stacked
    (E_held, d, f) / (E_held, f, d)."""
    m, d = cfg.moe, cfg.d_model
    E, f = m.experts_held, m.d_ff_expert
    p = {"router": layers.init_dense(gen, (count, d, m.n_experts),
                                     torch.float32, device),
         "w_in": layers.init_dense(gen, (count, E, d, f), dtype, device),
         "w_gate": layers.init_dense(gen, (count, E, d, f), dtype, device),
         "w_out": layers.init_dense(gen, (count, E, f, d), dtype, device)}
    if m.n_shared_experts:
        p["shared"] = layers.init_mlp(gen, count, d,
                                      m.n_shared_experts * f, True, dtype,
                                      device)
    return p


class Routing(NamedTuple):
    """Where each of T tokens' K assignments goes, in (token, k) order with
    each token's experts ascending: its expert (T, K), its renormalised
    router weight (T, K) f32, its slot in the flat (E_held*C + 1) buffer
    (T*K,; E_held*C, the trash slot, where dropped or held elsewhere),
    whether its expert is held here (T*K,) and whether it was kept here
    (T*K,: held and within capacity); the router's probabilities (T, E)
    f32 and the aux loss from them."""
    expert: torch.Tensor
    weight: torch.Tensor
    slot: torch.Tensor
    held: torch.Tensor
    keep: torch.Tensor
    capacity: int
    probs: torch.Tensor
    aux: torch.Tensor


def route(router: torch.Tensor, cfg, xt: torch.Tensor) -> Routing:
    """The router, the Switch aux loss and the capacity dispatch of ``xt``
    (T, d) to the experts held here, as the reference computes them
    (``moe_apply``, and ``_moe_local`` for a share)."""
    m = cfg.moe
    T = xt.shape[0]
    E, K = m.n_experts, m.top_k
    probs = torch.softmax(xt.float() @ router, dim=-1)           # (T, E)
    # jax.lax.top_k: descending, the lower index first among equal values
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # ---- load-balance aux loss (Switch-style) ----
    experts = torch.arange(E, device=xt.device)
    me = probs.mean(0)                                           # (E,)
    # one_hot by comparison: F.one_hot reads the indices' range on the host
    ce = (top_e[:, :, None] == experts).float().sum(1).mean(0)
    aux = (me * ce).sum() * E * m.router_aux_weight

    # ---- sort-based dispatch ----
    # An expert holds each token at most once, so the stable sort by
    # expert orders its assignments by token whatever the order of a
    # token's K: ordering them by expert here changes no rank and makes
    # the combine's sum over K the reference's scatter-add order.
    # Assignments to experts held elsewhere sort last, as expert E_held.
    top_e, k_order = torch.sort(top_e, dim=-1)
    top_p = top_p.gather(-1, k_order)
    C = capacity(T, E, K, m.capacity_factor)
    E_l = m.experts_held
    flat_e = top_e.reshape(T * K) - m.expert_shard * E_l
    held = (flat_e >= 0) & (flat_e < E_l)
    local_e = torch.where(held, flat_e, E_l)
    order = torch.sort(local_e, stable=True).indices
    se = local_e[order]
    seg_start = torch.searchsorted(se, experts[:E_l + 1])
    ar = torch.arange(T * K, device=xt.device)
    rank = torch.empty_like(order).scatter_(0, order, ar - seg_start[se])
    keep = held & (rank < C)                          # rank within expert
    slot = torch.where(keep, local_e * C + rank, E_l * C)  # E_l*C = trash
    return Routing(top_e, top_p, slot, held, keep, C, probs, aux)


def moe_apply(p: dict, cfg, x: torch.Tensor):
    """x: (B, S, d) -> (y (B, S, d), aux_loss scalar f32): with a share,
    the part of y the experts held here give, plus the shared expert."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    r = route(p["router"], cfg, xt)
    y = _experts(p, cfg, xt, r, r.weight)
    if cfg.moe.n_shared_experts:
        y = y + layers.mlp_apply(p["shared"], xt, cfg.mlp_act, True)
    return y.reshape(B, S, d), r.aux


def _experts(p: dict, cfg, xt: torch.Tensor, r: Routing,
             weight: torch.Tensor) -> torch.Tensor:
    """The routed experts held here on xt (T, d): dispatch by ``r``, the
    expert products, and the combine weighted by ``weight`` (T, K)."""
    T, d = xt.shape
    E, K, C = cfg.moe.experts_held, cfg.moe.top_k, r.capacity

    # each token copied into its K slots; the expand's backward sums the
    # K slots' gradients with no atomics
    xk = xt[:, None].expand(T, K, d).reshape(T * K, d)
    buf = torch.index_copy(xt.new_zeros(E * C + 1, d), 0, r.slot, xk)
    buf = buf[:E * C].view(E, C, d)

    # ---- expert computation: dense per-expert matmuls ----
    h = torch.bmm(buf, p["w_in"])
    g = torch.bmm(buf, p["w_gate"])
    h = F.silu(h) * g if cfg.mlp_act == "silu" \
        else F.gelu(h, approximate="tanh") * g
    yb = torch.bmm(h, p["w_out"]).reshape(E * C, d)

    # ---- combine back: each token's K slots, summed in expert order ----
    yb = torch.cat([yb, yb.new_zeros(1, d)])          # the trash slot, zero
    yk = (yb.index_select(0, r.slot)
          * weight.reshape(T * K, 1).to(xt.dtype)).view(T, K, d)
    y = yk[:, 0]
    for k in range(1, K):
        y = y + yk[:, k]
    return y


def moe_apply_ep(p: dict, cfg, x: torch.Tensor, mesh):
    """Expert-parallel MoE over ``mesh`` (a ``DeviceMesh`` or its
    ``MeshGroups``; the port of ``moe_apply_shardmap``).  x: (B, S, d),
    this rank's tokens, the same on every model rank; ``p``'s expert
    leaves the block of ``n_experts // n_model`` experts of this model
    rank, its router whole and its shared expert whole or, where
    ``shared_expert_splits``, this rank's d_ff part of it (column-parallel
    ``w_in`` / ``w_gate``, row-parallel ``w_out``).  Returns (y (B, S, d),
    aux): y summed over the model ranks, then the shared expert added
    once; aux
    from the router's statistics summed over the data ranks and divided by
    the global token count, the same on every rank.

    Capacity comes from this rank's token count, as in ``_moe_local``.
    Under ``g.seqpar`` x is this rank's block of the sequence and y its
    block of the result; the tokens are gathered over the model axis
    before the router, so the capacity is the unsplit layer's.

    Gradients: the model ranks' sum is the identity backward (each rank's
    loss reads the whole sum), while the dispatched tokens and the combine
    weights, which each rank reads for its own experts only, get their
    gradients summed over the model ranks; the router's statistics, whose
    sum every data rank reads, pass their gradient through as it is.  So a
    leaf held whole gets the same gradient on every model rank, and its
    gradients summed over the data ranks are those of the global batch."""
    g = mesh if isinstance(mesh, collectives.MeshGroups) \
        else collectives.MeshGroups(mesh)
    m = cfg.moe
    if m.expert_shards != 1 or m.n_experts % g.n_model:
        raise ValueError(f"{m.n_experts} experts ({m.expert_shards} shards "
                         f"in the config) over {g.n_model} model ranks")
    share = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, expert_shards=g.n_model, expert_shard=g.model_rank))
    held = share.moe.experts_held
    if p["w_in"].shape[-3] != held:
        raise ValueError(f"w_in holds {p['w_in'].shape[-3]} experts; a "
                         f"model rank's block is {held}")
    return _over_model(p, share, x, g)


def moe_apply_dff(p: dict, cfg, x: torch.Tensor, mesh):
    """The MoE FFN with every routed expert split over d_ff on ``mesh``'s
    model axis (a ``DeviceMesh`` or its ``MeshGroups``): the reference's
    GSPMD partitioning of experts that do not divide the axis.  x: (B, S,
    d), this rank's tokens, the same on every model rank; ``p``'s expert
    leaves this model rank's d_ff columns of ``w_in`` / ``w_gate`` (E, d,
    f / n) and rows of ``w_out`` (E, f / n, d), its router and shared
    expert as ``moe_apply_ep`` takes them.  Returns (y (B, S, d), aux) as
    ``moe_apply_ep`` does: the routing (router, capacity dispatch) is
    ``moe_apply``'s on every rank, each rank's experts give their d_ff
    part of every slot, summed over the model ranks, and the aux loss
    comes from the router's statistics summed over the data ranks.  The
    gradients of the dispatched tokens and of the combine weights, which
    each rank reads for its part of d_ff, are summed over the model
    ranks.  Under ``g.seqpar`` x and y are this rank's blocks of the
    sequence, as ``moe_apply_ep`` takes them."""
    g = mesh if isinstance(mesh, collectives.MeshGroups) \
        else collectives.MeshGroups(mesh)
    m = cfg.moe
    if m.expert_shards != 1 or p["w_in"].shape[-3] != m.n_experts \
            or p["w_in"].shape[-1] * g.n_model != m.d_ff_expert:
        raise ValueError(f"w_in {tuple(p['w_in'].shape)}: a model rank's "
                         f"d_ff columns of {m.n_experts} experts of "
                         f"{m.d_ff_expert} over {g.n_model} ranks")
    return _over_model(p, cfg, x, g)


def _over_model(p: dict, cfg, x: torch.Tensor, g):
    """(y, aux) of the routed experts of ``cfg`` that ``p`` holds, their
    parts summed over ``g``'s model ranks, plus the shared expert; the aux
    loss from the router's statistics summed over the data ranks.

    Under ``g.seqpar`` x is this rank's block of the sequence: the router
    reads the tokens gathered over the model axis and trimmed to
    ``g.seq_len`` (never a pad row, so the capacity and the drops are the
    unsplit layer's), computed alike on every model rank (the gather's
    gradient this rank's block of it), the experts' partial sums, and a
    split shared expert's, leave by one reduce-scatter over the sequence,
    and a shared expert computed whole is added by its block."""
    model = [g.model_group]
    if g.seqpar:
        x = collectives.gather_from_sequence(x, g.model_group, "block",
                                             g.seq_len)
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    r = route(p["router"], cfg, xt)
    xin = collectives.copy_to_region(xt, model)
    y = _experts(p, cfg, xin, r, collectives.copy_to_region(r.weight, model))
    if not g.seqpar:
        y = collectives.reduce_from_region(y, model)
        return _add_shared(p, cfg, xt, y, g).reshape(B, S, d), \
            _global_aux(r, cfg, g)
    shared = cfg.moe.n_shared_experts
    split = shared and rules.shared_expert_splits(cfg, g.n_model)
    if split:
        y = y + layers.mlp_apply(p["shared"], xin, cfg.mlp_act, True)
    y = collectives.reduce_scatter_to_sequence(y.reshape(B, S, d),
                                               g.model_group)
    if shared and not split:
        y = y + collectives.scatter_to_sequence(layers.mlp_apply(
            p["shared"], xt, cfg.mlp_act, True).reshape(B, S, d),
            g.model_group)
    return y, _global_aux(r, cfg, g)


def _global_aux(r: Routing, cfg, g) -> torch.Tensor:
    """The Switch aux loss of the routing ``r`` of this rank's tokens from
    the router's statistics summed over ``g``'s data ranks and divided by
    the global token count, the same on every rank."""
    m = cfg.moe
    T, E = r.probs.shape
    experts = torch.arange(E, device=r.probs.device)
    me_sum = collectives.reduce_from_region(r.probs.sum(0), g.data_groups)
    ce_sum = collectives.all_reduce(
        (r.expert[:, :, None] == experts).float().sum((0, 1)),
        g.data_groups)
    t_global = T * g.n_data
    return (me_sum / t_global * (ce_sum / t_global)).sum() * E \
        * m.router_aux_weight


def _add_shared(p: dict, cfg, xt: torch.Tensor, y: torch.Tensor, g):
    """``y`` plus the shared expert on ``xt``, tensor-parallel over ``g``'s
    model axis where its d_ff divides it."""
    if not cfg.moe.n_shared_experts:
        return y
    split = rules.shared_expert_splits(cfg, g.n_model)
    return y + layers.mlp_apply(p["shared"], xt, cfg.mlp_act, True,
                                groups=g if split else None)
