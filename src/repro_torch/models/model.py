"""Building the models (port of ``repro/models/model.py``: dense, MoE, MLA,
Mamba2, zamba2-hybrid and the vision and audio stubs).

``build_model(cfg, device)`` returns a :class:`Model` bundle of functions:

  init(seed)                 -> params
  forward(params, batch)     -> (logits, extras)
  loss(params, batch)        -> (scalar, metrics)
  init_cache(batch, capacity) -> caches
  decode_step(params, caches, tokens, pos) -> (logits, caches)
  cache_shards(batch, capacity, mesh=) -> a rank's CacheShard per leaf

Params keep the reference's tree: per segment a list of slots, each a dict
whose leaves carry a leading ``count`` axis over the stacked layers, so JAX
key paths map 1:1 onto the port's (see ``repro_torch.bridge``).  The
reference's ``lax.scan`` over that axis is a Python loop here, and
``remat=True`` wraps each scan step in ``torch.utils.checkpoint``.  zamba2's
weight-tied attention+MLP block (``params["shared"]``) runs after the slots
of each period of a ``shared_after`` segment.  DeepSeek's multi-token
prediction head (``params["mtp"]``: one unstacked ``mla_dense`` block and
a norm) runs on the last layer's output in ``forward`` (``extras[
"mtp_logits"]``) and adds ``MTP_WEIGHT`` times its cross-entropy against
the token two ahead to ``loss``; decode does not run it, as in the
reference.  The modality stubs enter in ``forward``: an ``audio_stub``
model takes ``batch["frames"]`` in place of token embeddings (its
``embed`` leaf is never read) and its loss is the masked cross-entropy
against ``batch["labels"]`` with no shift; a ``vision_stub`` model puts
``batch["prefix_embeds"]`` ahead of the token embeddings and scores only
the last T positions.  Decode embeds text tokens only, as in the
reference.  Decode caches keep the same
layout: per segment ``{"slots": [...], "shared": ...}`` with leaves of
shape (count, batch, ...), so axis 1 of every cache leaf is the lane.
``decode_step`` updates them in place and returns them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import (ArchConfig, BLOCK_ATTN_DENSE,
                                     BLOCK_HYBRID_SHARED, BLOCK_MLA_DENSE)
from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.sharding import collectives, rules

MTP_WEIGHT = 0.3

# ---------------------------------------------------------------------------
# Segment plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Segment:
    kind: str
    count: int                 # scan length (number of periods)
    inner: int                 # layers per scan step
    locality: Tuple[bool, ...]  # per-slot sliding-window flag
    shared_after: bool = False  # zamba2: apply shared block after slots

    @property
    def n_layers(self) -> int:
        return self.count * self.inner


def segment_plan(cfg: ArchConfig) -> List[Segment]:
    segs: List[Segment] = []
    for kind, count in cfg.block_pattern:
        if count == 0:
            continue
        if kind == BLOCK_HYBRID_SHARED and cfg.shared_period:
            period = min(cfg.shared_period, count)
            groups, rem = divmod(count, period)
            if groups:
                segs.append(Segment(kind, groups, period,
                                    (False,) * period, shared_after=True))
            if rem:
                segs.append(Segment(kind, 1, rem, (False,) * rem))
            continue
        a = cfg.attn
        if a is not None and a.window and a.local_ratio[0] > 0:
            loc, glob = a.local_ratio
            period = loc + glob
            pattern = (True,) * loc + (False,) * glob
            if count < period:
                segs.append(Segment(kind, 1, count, pattern[:count]))
                continue
            groups, rem = divmod(count, period)
            segs.append(Segment(kind, groups, period, pattern))
            if rem:
                segs.append(Segment(kind, 1, rem, pattern[:rem]))
            continue
        segs.append(Segment(kind, count, 1, (False,)))
    return segs


# ---------------------------------------------------------------------------
# Model bundle
# ---------------------------------------------------------------------------


@dataclass
class Model:
    cfg: ArchConfig
    init: Callable
    forward: Callable
    loss: Callable
    segments: List[Segment]
    device: torch.device
    init_cache: Callable = None
    decode_step: Callable = None
    cache_shards: Callable = None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, groups=(),
                  vocab=None):
    """Mean masked token cross-entropy.  logits f32 (..., V).  With data
    ``groups``, this rank's share of the mean over the ranks' tokens: its
    sum over the count summed over the groups.  With ``vocab`` (a mesh's
    ``MeshGroups``), ``logits`` is this model rank's slice of the
    vocabulary (``layers.logits_apply``): the max is all-reduced by max
    over the model axis, the sum of exponentials and the target's logit,
    taken where its column lies, by sum; every model rank then holds the
    same loss."""
    if vocab is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    else:
        model = [vocab.model_group]
        n = logits.shape[-1]
        top = collectives.all_reduce(logits.detach().amax(dim=-1), model,
                                     op=torch.distributed.ReduceOp.MAX)
        lse = torch.log(collectives.reduce_from_region(
            torch.exp(logits - top[..., None]).sum(dim=-1), model)) + top
        local = targets.long() - vocab.model_rank * n
        owned = (local >= 0) & (local < n)
        ll = torch.gather(logits, -1,
                          torch.where(owned, local, 0)[..., None])[..., 0]
        ll = collectives.reduce_from_region(ll.masked_fill(~owned, 0.0),
                                            model)
    nll = lse - ll
    if groups:
        if mask is None:
            mask = torch.ones_like(nll)
        mask = mask.float()
        count = collectives.all_reduce(mask.sum(), groups)
        return (nll * mask).sum() / torch.clamp(count, min=1.0)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def build_model(cfg: ArchConfig, device="cuda") -> Model:
    device = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    segs = segment_plan(cfg)
    mtp_kind = BLOCK_MLA_DENSE if cfg.mla else segs[0].kind

    def init(seed: int = 0) -> dict:
        """Random params of the reference's shapes and dtypes, drawn from a
        ``torch.Generator`` seeded with ``seed`` (not JAX's bits).  On the
        ``meta`` device nothing is drawn or allocated: the tree holds only
        shapes and dtypes."""
        gen = None if device.type == "meta" \
            else torch.Generator(device=device).manual_seed(seed)
        params: dict = {"embed": layers.init_embed(gen, cfg.vocab,
                                                   cfg.d_model, dtype,
                                                   device)}
        params["segments"] = [
            [blocks.init_block(gen, seg.count, cfg, seg.kind, dtype, device)
             for _ in range(seg.inner)] for seg in segs]
        if cfg.shared_period:
            params["shared"] = blocks.init_shared_block(gen, cfg, dtype,
                                                        device)
        params["final_norm"] = layers.init_norm(cfg.d_model, cfg.norm,
                                                dtype, device)
        if not cfg.tie_embeddings:
            params["head"] = {"w": layers.init_dense(
                gen, (cfg.d_model, cfg.vocab), dtype, device).T.contiguous()}
        if cfg.mtp:
            params["mtp"] = {
                "block": tree.tree_map(lambda t: t[0], blocks.init_block(
                    gen, 1, cfg, mtp_kind, dtype, device)),
                "norm": layers.init_norm(cfg.d_model, cfg.norm, dtype,
                                         device)}
        return params

    def _head_w(params):
        return params["embed"]["w"] if cfg.tie_embeddings \
            else params["head"]["w"]

    def _unstack(tree, count):
        """Per-layer views of a stacked slot: ``count`` trees of slices.
        ``unbind`` keeps the backward one stack per leaf."""
        if isinstance(tree, dict):
            parts = {k: _unstack(v, count) for k, v in tree.items()}
            return [{k: parts[k][i] for k in tree} for i in range(count)]
        return list(tree.unbind(0))

    def _run_segments(params, x, positions, remat, groups):
        """Returns (x, aux): the layers' router aux losses summed in f32 in
        layer order, as the reference's scan carry sums them."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for seg, slot_params in zip(segs, params["segments"]):
            per_slot = [_unstack(sp, seg.count) for sp in slot_params]
            for c in range(seg.count):
                def body(h, a, c=c, seg=seg, per_slot=per_slot):
                    for j in range(seg.inner):
                        h, aj = blocks.block_apply(
                            per_slot[j][c], cfg, seg.kind, h, positions,
                            layer_is_local=seg.locality[j], groups=groups)
                        if aj is not None:
                            a = a + aj
                    if seg.shared_after:
                        h = blocks.shared_block_apply(params["shared"], cfg,
                                                      h, positions,
                                                      groups=groups)
                    return h, a
                x, aux = checkpoint(body, x, aux, use_reentrant=False) \
                    if remat else body(x, aux)
        return x, aux

    def _vocab_groups(groups):
        """The mesh's groups where the embedding, head and cross-entropy
        are vocab-parallel (``sharding.rules.vocab_splits``), else None."""
        return groups if groups is not None and rules.vocab_splits(
            cfg, groups.n_model) else None

    def _embed_inputs(params, batch, vocab, seq):
        """The first block's input: whole, or with ``seq`` (the mesh's
        groups under sequence parallelism) this rank's block of the
        sequence, the vision prefix's included.  A vocab-parallel
        embedding of tokens alone leaves by its reduce-scatter over the
        sequence (``layers.embed_apply``); anything else is split after
        it is made whole."""
        if cfg.modality == "audio_stub":
            x = batch["frames"].to(dtype)
        elif seq is not None and vocab is not None \
                and cfg.modality != "vision_stub":
            return layers.embed_apply(params["embed"], batch["tokens"],
                                      cfg.embed_scale, cfg.d_model,
                                      groups=vocab)
        else:
            if vocab is not None and vocab.seqpar:
                vocab = vocab.with_seqpar(False)
            x = layers.embed_apply(params["embed"], batch["tokens"],
                                   cfg.embed_scale, cfg.d_model,
                                   groups=vocab)
            if cfg.modality == "vision_stub":
                x = torch.cat([batch["prefix_embeds"].to(x.dtype), x],
                              dim=1)
        if seq is not None:
            x = collectives.scatter_to_sequence(x, seq.model_group)
        return x

    def _seq_len(batch) -> int:
        """The whole sequence's length: the audio frames, or the tokens
        after the vision prefix."""
        if cfg.modality == "audio_stub":
            return batch["frames"].shape[1]
        n = batch["tokens"].shape[1]
        if cfg.modality == "vision_stub":
            n += batch["prefix_embeds"].shape[1]
        return n

    def _to_head(h, vocab, seq):
        """The head's input: under sequence parallelism the ranks' blocks
        gathered over the sequence, where the head is whole (a vocabulary
        that does not divide the axis) with the gradient's block taken, as
        for a module computed whole; a vocab-parallel head gathers them
        itself (``layers.logits_apply``)."""
        if seq is not None and vocab is None:
            return collectives.gather_from_sequence(h, seq.model_group,
                                                    "block", seq.seq_len)
        return h

    def forward(params, batch, *, remat: bool = False, groups=None,
                last_logits_only: bool = False):
        """(logits, extras).  With a mesh's ``groups`` (the sharded step's,
        ``params`` this rank's compute shards, ``train.sharded.
        compute_params``), every block, the MTP block's and zamba2's
        shared block too, is tensor-parallel where the rules split it
        (``blocks.block_apply``) and a head held split is vocab-parallel:
        the logits (and MTP logits) are this model rank's vocabulary
        slice.
        With ``last_logits_only`` (serving prefill) only the last
        position's logits are made, (B, 1, vocab), gathered whole over the
        model axis, and extras is ``{"aux"}`` alone (no MTP logits), as in
        the reference.

        With groups whose ``seqpar`` is set (sequence parallelism), the
        residual between the blocks is this rank's block of the sequence,
        ``sharding.rules.seq_block`` rows, padded where the axis does not
        divide the sequence (the gathers trim to ``groups.seq_len``, set
        here): the embedding (or the frames, or the tokens after the
        vision prefix) is split, every block's norms and residual adds and
        the final norm run on the block, and the head's input is gathered
        over the sequence, so the logits and the losses are the whole
        sequence's as without it.  The MTP block takes the split pre-norm
        output.  With ``last_logits_only`` only the last position is
        brought to the head: every rank brings its row at the position's
        offset in its block, and the owner's (rank (S - 1) // c) is
        kept."""
        S = _seq_len(batch)
        if groups is not None and groups.seqpar:
            groups = groups.with_seq_len(S)
        vocab = _vocab_groups(groups)
        seq = groups if groups is not None and groups.seqpar else None
        x = _embed_inputs(params, batch, vocab, seq)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        x, aux = _run_segments(params, x, positions, remat, groups)
        h = layers.norm_apply(params["final_norm"], x, cfg.norm)
        if last_logits_only:
            if seq is None:
                logits = layers.logits_apply(_head_w(params), h[:, -1:],
                                             vocab)
            else:
                # position S - 1 is row (S - 1) % c of rank (S - 1) // c:
                # each rank's row at that offset, gathered untrimmed (n
                # blocks of one row), and the owner's kept
                c = rules.seq_block(S, seq.n_model)
                owner, row = divmod(S - 1, c)
                tail = seq.with_seq_len(seq.n_model)
                tail_vocab = tail if vocab is not None else None
                logits = layers.logits_apply(
                    _head_w(params),
                    _to_head(h[:, row:row + 1], tail_vocab, tail),
                    tail_vocab)[:, owner:owner + 1]
            if vocab is not None:
                logits = collectives.gather_from_region(logits,
                                                        vocab.model_group)
            return logits, {"aux": aux}
        logits = layers.logits_apply(_head_w(params), _to_head(h, vocab, seq),
                                     vocab)
        extras = {"aux": aux}
        if cfg.mtp:
            # the MTP block on the last layer's (pre-norm) output; its aux
            # loss is dropped, as the reference drops it
            hm, _ = blocks.block_apply(params["mtp"]["block"], cfg, mtp_kind,
                                       x, positions, groups=groups)
            hm = layers.norm_apply(params["mtp"]["norm"], hm, cfg.norm)
            extras["mtp_logits"] = layers.logits_apply(
                _head_w(params), _to_head(hm, vocab, seq), vocab)
        return logits, extras

    def loss(params, batch, *, remat: bool = False, groups=None):
        """(total, metrics).  With a mesh's ``groups`` (the sharded step's,
        ``batch`` this rank's rows), the forward is ``forward``'s with
        groups, each cross-entropy is vocab-parallel where the head is and,
        over more than one data rank, this rank's share of the mean over
        the ranks' tokens (``cross_entropy``)."""
        data_groups = groups.data_groups \
            if groups is not None and groups.n_data > 1 else ()
        vocab = _vocab_groups(groups)
        logits, extras = forward(params, batch, remat=remat, groups=groups)
        mask = batch.get("loss_mask")
        if cfg.modality == "audio_stub":
            ce = cross_entropy(logits, batch["labels"], mask, data_groups,
                               vocab)
        else:
            toks = batch["tokens"]
            T = toks.shape[1]
            if cfg.modality == "vision_stub":
                logits = logits[:, -T:]
            ce = cross_entropy(logits[:, :-1], toks[:, 1:],
                               None if mask is None else mask[:, 1:],
                               data_groups, vocab)
        total = ce + extras["aux"]
        metrics = {"ce": ce, "aux": extras["aux"]}
        if "mtp_logits" in extras:
            ml = extras["mtp_logits"]
            if cfg.modality == "vision_stub":
                ml = ml[:, -T:]
            mtp_ce = cross_entropy(ml[:, :-2], toks[:, 2:],
                                   groups=data_groups, vocab=vocab)
            total = total + MTP_WEIGHT * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = total
        return total, metrics

    # ---------------- decode ----------------

    def _caches(batch_size, capacity, cdt, dev):
        def stacked(one, count):
            return {k: v[None].repeat((count,) + (1,) * v.dim())
                    for k, v in one.items()}
        caches = []
        for seg in segs:
            entry = {"slots": [stacked(blocks.block_cache(
                cfg, seg.kind, batch_size, capacity, cdt, dev,
                layer_is_local=seg.locality[j]), seg.count)
                for j in range(seg.inner)]}
            if seg.shared_after:
                entry["shared"] = stacked(blocks.block_cache(
                    cfg, BLOCK_ATTN_DENSE, batch_size, capacity, cdt, dev),
                    seg.count)
            caches.append(entry)
        return caches

    def cache_shards(batch_size: int, capacity: int, cache_dtype=None, *,
                     mesh, kv_model: bool = False, shard_seq: bool = False):
        """This rank's ``sharding.rules.CacheShard`` of each leaf of
        ``init_cache(batch_size, capacity)`` on ``mesh`` (a ``DeviceMesh``
        or a ``Layout`` whose last axis is ``model``), the tree
        ``decode_step`` reads the split of each cache's slots from."""
        whole = _caches(batch_size, capacity, cache_dtype or dtype,
                        torch.device("meta"))
        return rules.cache_shards(whole, cfg, mesh, kv_model=kv_model,
                                  shard_seq=shard_seq)

    def init_cache(batch_size: int, capacity: int, cache_dtype=None, *,
                   mesh=None, kv_model: bool = False,
                   shard_seq: bool = False):
        """Zero decode caches for ``batch_size`` lanes of ``capacity``
        positions, in ``cache_dtype`` (default: the param dtype; the SSM
        state is float32).  With a ``mesh``, this rank's shards of them
        (``cache_shards``): the lanes over the data axes, KV heads over
        ``model`` where they divide it, else with ``kv_model`` the slots,
        with ``shard_seq`` (long context, one lane) the slots over the data
        axes, and Mamba2's state by heads."""
        cdt = cache_dtype or dtype
        if mesh is None:
            return _caches(batch_size, capacity, cdt, device)
        whole = _caches(batch_size, capacity, cdt, torch.device("meta"))
        return tree.tree_map(
            lambda t, s: torch.zeros(s.shape, dtype=t.dtype, device=device),
            whole, rules.cache_shards(whole, cfg, mesh, kv_model=kv_model,
                                      shard_seq=shard_seq))

    def _slot_split(shard_entry, groups):
        """(capacity_groups, slot_offset) of one layer's cache leaves from
        their ``CacheShard``s: the groups its slots are split over and
        this rank's first slot, or (None, 0)."""
        if not shard_entry:
            return None, 0
        for name in ("k", "ckv"):
            s = shard_entry.get(name)
            if s is None or not s.capacity_axes:
                continue
            C = s.shape[2]                       # (count, B, C, ...)
            if s.capacity_axes == ("model",):
                return [groups.model_group], groups.model_rank * C
            if set(s.capacity_axes) != set(groups.data_axes):
                raise ValueError(f"slots split over {s.capacity_axes}")
            return groups.data_groups, groups.data_rank * C
        return None, 0

    def decode_step(params, caches, tokens, pos, groups=None, shards=None):
        """tokens: (B,) int; pos: an int or a (B,) tensor of absolute
        positions.  Returns (logits (B, vocab) f32, caches), the caches
        updated in place.  With ``pos`` a tensor on the caches' device the
        step copies nothing from the host and reads nothing back, so a
        CUDA graph can capture it (``serve.decode.GraphDecoder``).

        With a mesh's ``groups`` the step is tensor-parallel as ``forward``
        is: ``params`` are this rank's compute shards (``train.sharded.
        compute_params``), ``caches`` its ``init_cache(..., mesh=)`` shards
        and ``shards`` their ``cache_shards``, ``tokens`` its lanes; each
        block splits where ``block_apply`` does (``blocks.block_decode``),
        an attention or MLA layer whose slots are split runs as
        flash-decoding, and where the head is vocab-split the logits are
        this model rank's slice of the vocabulary.  Decode ignores
        ``groups.seqpar``: the reference's decode does not split the
        residual by sequence."""
        B = tokens.shape[0]
        if shards is not None and groups is None:
            raise ValueError("cache shards need the mesh's groups")
        if groups is not None and groups.seqpar:
            groups = groups.with_seqpar(False)
        pos = layers.DecodePositions(pos, B, tokens.device)
        vocab = _vocab_groups(groups)
        x = layers.embed_apply(params["embed"], tokens[:, None],
                               cfg.embed_scale, cfg.d_model, groups=vocab)
        for i, (seg, slot_params, cache) in enumerate(
                zip(segs, params["segments"], caches)):
            per_slot = [_unstack(sp, seg.count) for sp in slot_params]
            seg_shards = shards[i] if shards is not None else {}
            splits = [_slot_split(s, groups)
                      for s in seg_shards.get("slots", [None] * seg.inner)]
            shared_split = _slot_split(seg_shards.get("shared"), groups)
            for c in range(seg.count):
                for j in range(seg.inner):
                    layer_cache = {k: v[c]
                                   for k, v in cache["slots"][j].items()}
                    x, new = blocks.block_decode(
                        per_slot[j][c], cfg, seg.kind, x, layer_cache, pos,
                        layer_is_local=seg.locality[j], groups=groups,
                        capacity_groups=splits[j][0],
                        slot_offset=splits[j][1])
                    _write_back(layer_cache, new)
                if seg.shared_after:
                    layer_cache = {k: v[c] for k, v in cache["shared"].items()}
                    x, new = blocks.shared_block_decode(
                        params["shared"], cfg, x, layer_cache, pos,
                        groups=groups, capacity_groups=shared_split[0],
                        slot_offset=shared_split[1])
                    _write_back(layer_cache, new)
        h = layers.norm_apply(params["final_norm"], x, cfg.norm)
        logits = layers.logits_apply(_head_w(params), h, vocab)[:, 0]
        return logits, caches

    return Model(cfg=cfg, init=init, forward=forward, loss=loss,
                 segments=segs, device=device, init_cache=init_cache,
                 decode_step=decode_step, cache_shards=cache_shards)


def _write_back(layer_cache: dict, new: dict) -> None:
    """Copy a layer's new cache leaves into its views of the stacked
    caches.  The K/V buffers come back as the same tensors, already updated
    in place by ``attention_decode``."""
    for k, v in new.items():
        if v is not layer_cache[k]:
            layer_cache[k].copy_(v)
