"""The sharded training step over ``torch.distributed`` (the port of the
reference's step jitted with ``in_shardings`` of ``train_state_specs`` and
``batch_specs``, ``tests/test_sharding.py``): ZeRO-1 over the data axes,
tensor and expert parallelism over the model axis.

* **Storage.**  Each leaf of the state is a ``DTensor`` over the mesh,
  placed by ``sharding.train_state_specs``: parameters by their
  ``param_specs`` (with ``fsdp``, their ``opt_specs``), ``mu``, ``nu`` and
  ``master`` by their ``opt_specs`` (ZeRO-1).  ``shard_train_state`` makes
  such a state from a whole one and ``full_train_state`` gathers it back.
* **Forward and backward** run on plain local tensors, each leaf
  brought to its compute placement before the micro-batches
  (``compute_uses``, by ``sharding.rules.compute_use``), where the rules
  split a module: attention by query heads, MLA by heads, Mamba2 by SSM
  heads, MLPs and shared experts by d_ff (column-parallel ``wq``, ``wk``,
  ``wv``, ``w_uq``, ``w_uk``, ``w_uv``, ``w_in``, ``w_gate``, ``gate_norm``,
  row-parallel ``wo``, ``w_out``; one all-reduce over the model axis in
  each direction), the embedding, head and cross-entropy by the
  vocabulary, and the MoE routed experts by blocks where they divide the
  axis (``models.moe.moe_apply_ep``), else by d_ff
  (``models.moe.moe_apply_dff``); these leaves reach the forward as the
  rank's shard, with no gather.  ``PARTIAL`` leaves are held whole and
  read by the rank's heads only, so their gradients are partial sums over
  the model ranks, summed once a step in f32: ``wk`` / ``wv`` whose KV
  heads do not divide the axis, the norms of a split attention, every
  leaf of an attention whose query heads the axis does not divide (one
  head on several ranks, or uneven blocks: ``rules.head_block``), a split
  MLA's down-projections and their norms, a split Mamba2's ``w_in``,
  ``conv_w``, ``conv_b``, ``dt_bias``, ``A_log`` and ``D``.  Everything
  else (modules whose heads or d_ff do not divide, norms, the router) is
  gathered whole and computed alike on every model rank.  A leaf stored
  split over the model axis but computed whole is gathered by a plain
  ``all_gather_into_tensor`` (``sharding.collectives.all_gather``) and a
  ``PARTIAL`` one's gradient summed back to the stored shard by a plain
  ``reduce_scatter_tensor``, not by DTensor's ``redistribute`` (whose
  Shard-to-Replicate kills a gloo rank on CUDA tensors,
  ``launch/gloo_probe.py``); the data axes (ZeRO-1, ``fsdp``) stay
  DTensor's.  With ``seqpar`` (sequence parallelism) the residual between
  the split regions is each model rank's block of the sequence
  (``models.model``'s forward): each region's all-reduce becomes an
  all-gather and a reduce-scatter over the sequence, and the norms on the
  residual, which each rank runs on its rows, are ``PARTIAL`` too.  The
  kernels take raw pointers, so no ``DTensor`` reaches them.  Each rank
  takes its rows of every micro-batch (dim 1 of the stacked batch) by
  ``batch_specs``;
  with more than one data rank each cross-entropy is the rank's share of
  the micro-batch's global mean.
* **Update.**  The accumulated gradients are reduce-scattered over the data
  axes to each rank's ZeRO-1 shard (``Partial`` to ``Shard``), the global
  gradient norm is summed over the shards, each element once, and AdamW
  (``optim.adamw``, its arithmetic unchanged) updates the local shards of
  ``mu``, ``nu`` and ``master`` (of the parameter itself where there is no
  master); the new parameters are all-gathered back into their storage
  placement.

The step raises, and never runs single-process instead, when no process
group is initialised or the mesh does not cover the world.  With one data
rank and one model rank it computes what ``train.step.make_train_step``
computes, in the same order.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.optim import AdamW
from repro_torch.sharding import collectives
from repro_torch.sharding.rules import (PARTIAL, SPLIT_USES, batch_specs,
                                        compute_use, expert_ffn_splits,
                                        experts_split, is_spec, param_specs,
                                        path_names, to_placements,
                                        train_state_specs)
from repro_torch.train.state import TrainState, abstract_train_state


def check_world(mesh) -> None:
    """Raises unless a process group is initialised and ``mesh`` covers
    its world."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("the sharded step needs an initialised "
                           "torch.distributed process group")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh has {mesh.size()} ranks; the world has "
                         f"{dist.get_world_size()}")


def _dtensor():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    return DTensor, Partial, Replicate, Shard


def _place(t: torch.Tensor, mesh, placements) -> "DTensor":
    """A whole tensor, held alike on every rank, as a DTensor of its own
    storage (a copy) at ``placements``."""
    DTensor, _, Replicate, _ = _dtensor()
    full = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
    local = full.redistribute(mesh, placements).to_local().clone()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.contiguous().stride())


def _from_local(local: torch.Tensor, like) -> "DTensor":
    DTensor = _dtensor()[0]
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def shard_train_state(state: TrainState, mesh, *,
                      fsdp: bool = False) -> TrainState:
    """``state`` (whole, the same on every rank, on the mesh's device) with
    each leaf a DTensor placed by ``train_state_specs``; the step counters
    stay plain tensors."""
    check_world(mesh)
    specs = train_state_specs(state, mesh, fsdp=fsdp)

    def one(t, spec):
        if t.dim() == 0:
            return t.clone()
        return _place(t, mesh, to_placements(spec, mesh))
    return tree.tree_map(one, state, specs)


def full_train_state(state: TrainState) -> TrainState:
    """The whole state on every rank: each DTensor leaf gathered."""
    DTensor = _dtensor()[0]
    return tree.tree_map(
        lambda t: t.full_tensor() if isinstance(t, DTensor) else t.clone(),
        state)


def compute_uses(params_shape, cfg, n_model: int,
                 seqpar: bool = False) -> List[Tuple]:
    """``(names, use, dim)`` of each leaf of ``params_shape`` (in leaf
    order) over a model axis of ``n_model``: its ``compute_use`` (with
    ``seqpar``) and the dim it reaches the forward split along over the
    model axis, else None."""
    out = []
    for (k, leaf), spec in zip(
            tree.leaves_with_path(params_shape),
            tree.leaves(param_specs(params_shape, n_model), is_leaf=is_spec)):
        names = path_names(k)
        use = compute_use(names, cfg, n_model, seqpar)
        out.append((names, use,
                    spec.index("model") if use in SPLIT_USES else None))
    return out


def compute_params(params, cfg, groups):
    """This model rank's compute shards of whole ``params`` (the same on
    every rank) over ``groups``' model axis: each leaf as the sharded step
    hands it to the forward, a copy of the rank's chunk where it is split
    (``compute_uses``), else the leaf itself.  For a forward without the
    step, such as the dry-run's prefill, and for tensor-parallel decode,
    which reads every leaf as the forward does (``model.decode_step``)."""
    leaves = tree.leaves(params)
    uses = compute_uses(params, cfg, groups.n_model, groups.seqpar)
    out = [t if dim is None else
           t.chunk(groups.n_model, dim)[groups.model_rank].clone()
           for t, (_, _, dim) in zip(leaves, uses)]
    return tree.unflatten(params, out)


class _Leaf:
    """One parameter leaf's placements: stored, for the optimizer (ZeRO-1),
    for the forward (``compute_uses``: its model-axis shard where it is
    split, else gathered), and of its local gradient (partial over the
    data axes; over the model axis the forward's shard, a partial sum for
    a ``PARTIAL`` leaf, else the same on every rank); ``gather``, the dim
    of a leaf stored split over the model axis and computed whole (else
    None), which the step gathers and, for a ``PARTIAL`` leaf, sums the
    gradient back along by plain collectives; and whether this rank
    counts its optimizer shard in the global norm (the first copy of
    each)."""

    def __init__(self, use, dim, pspec, ospec, mesh, groups):
        _, Partial, Replicate, Shard = _dtensor()
        n_data_axes = len(groups.data_axes)
        self.param = to_placements(pspec, mesh)
        self.opt = to_placements(ospec, mesh)
        self.use = use
        model = Replicate() if dim is None else Shard(dim)
        self.compute = [Replicate()] * n_data_axes + [model]
        self.grad = [Partial()] * n_data_axes + [
            Partial() if use == PARTIAL else model]
        stored = self.param[-1]
        self.gather = stored.dim if dim is None \
            and isinstance(stored, Shard) else None
        self.owner = all(
            mesh.get_local_rank(axis) == 0
            for axis, pl in zip(mesh.mesh_dim_names, self.opt)
            if isinstance(pl, Replicate))


def make_sharded_train_step(model, optimizer: AdamW, n_micro: int, mesh, *,
                            fsdp: bool = False, remat: bool = False,
                            seqpar: bool = False) -> Callable:
    """The sharded counterpart of ``make_train_step``: ``step(state, batch)
    -> (state, metrics)`` on a ``shard_train_state`` state over ``mesh``
    (a ``DeviceMesh`` whose last axis is ``model``).  ``batch`` is the
    whole stacked batch, the same on every rank (leaves (n_micro,
    micro_batch, ...)); the metrics are the global micro-batches' means,
    as the single-process step reports them.  ``remat`` recomputes each
    layer's activations in the backward (``model.loss(..., remat=True)``,
    as ``train.step.make_train_step`` passes it).  ``seqpar`` splits the
    residual by sequence over the model axis (``collectives.MeshGroups``);
    at one model rank it changes nothing."""
    check_world(mesh)
    groups = collectives.MeshGroups(mesh, seqpar=seqpar)
    shapes = abstract_train_state(model, optimizer)
    specs = train_state_specs(shapes, mesh, fsdp=fsdp)
    leaves: List[_Leaf] = [
        _Leaf(use, dim, p, o, mesh, groups) for (_, use, dim), p, o in zip(
            compute_uses(shapes.params, model.cfg, groups.n_model,
                         groups.seqpar),
            tree.leaves(specs.params, is_leaf=is_spec),
            tree.leaves(specs.opt.mu, is_leaf=is_spec))]
    if model.cfg.moe is not None and not (
            experts_split(model.cfg, groups.n_model)
            or expert_ffn_splits(model.cfg, groups.n_model)):
        raise ValueError("the MoE experts' leaves are not on the model "
                         "axis: neither their count nor their d_ff "
                         "divides it")
    data_groups = groups.data_groups if groups.n_data > 1 else ()

    def local_rows(batch) -> Dict[str, torch.Tensor]:
        if groups.n_data == 1:
            return batch
        bspecs = batch_specs(batch, groups.data_axes, groups.n_data,
                             stacked=True)
        out = {}
        for k, v in batch.items():
            if bspecs[k][1] is None:
                raise ValueError(f"batch[{k!r}]: {v.shape[1]} rows a "
                                 f"micro-batch do not divide over "
                                 f"{groups.n_data} data ranks")
            rows = v.shape[1] // groups.n_data
            out[k] = v[:, groups.data_rank * rows:
                       (groups.data_rank + 1) * rows]
        return out

    def global_metrics(metrics) -> Dict[str, torch.Tensor]:
        """Each rank's metrics are its shares of the cross-entropies (and
        the aux loss, global already): summed over the data ranks."""
        out = {k: v.detach() for k, v in metrics.items()}
        if not data_groups:
            return out
        aux = out["aux"]
        for k, v in out.items():
            if k != "aux":
                out[k] = collectives.all_reduce(
                    v - aux if k == "loss" else v.clone(), data_groups)
        out["loss"] = out["loss"] + aux
        return out

    def grads_of(params, mb):
        local = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            loss, metrics = model.loss(tree.unflatten(shapes.params, local),
                                       mb, remat=remat, groups=groups)
            grads = torch.autograd.grad(loss, local, allow_unused=True)
        return grads, global_metrics(metrics)

    def compute_local(p, leaf: _Leaf) -> torch.Tensor:
        """The stored DTensor ``p`` at ``leaf.compute``, as a local tensor:
        the data axes by ``redistribute``, a model-axis gather by a plain
        all-gather."""
        if leaf.gather is None:
            return p.redistribute(mesh, leaf.compute).to_local()
        part = p.redistribute(mesh, leaf.compute[:-1] + [p.placements[-1]])
        return collectives.all_gather(part.to_local(), groups.model_group,
                                      leaf.gather)

    def local_grad(acc: torch.Tensor, leaf: _Leaf) -> "DTensor":
        """The accumulated gradient as a DTensor at ``leaf.grad``; a
        ``PARTIAL`` leaf stored split is first summed to its stored shard
        over the model axis by a plain reduce-scatter."""
        DTensor, Partial, _, Shard = _dtensor()
        placements = leaf.grad
        if leaf.gather is not None and isinstance(placements[-1], Partial):
            acc = collectives.reduce_scatter(acc, groups.model_group,
                                             leaf.gather)
            placements = placements[:-1] + [Shard(leaf.gather)]
        return DTensor.from_local(acc, mesh, placements, run_check=False)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        check_world(mesh)
        stored = tree.leaves(state.params)
        params = [compute_local(p, leaf) for p, leaf in zip(stored, leaves)]
        batch = local_rows(batch)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params]
        per_mb = []
        for i in range(n_micro):
            grads, metrics = grads_of(params,
                                      {k: v[i] for k, v in batch.items()})
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g.float())
            del grads
            per_mb.append(metrics)
        del params
        with torch.no_grad():
            grads = []
            for i, leaf in enumerate(leaves):
                g = local_grad(acc[i], leaf)
                acc[i] = None
                grads.append(g.redistribute(mesh, leaf.opt).to_local()
                             / n_micro)
            total = torch.zeros((), dtype=torch.float32,
                                device=grads[0].device)
            for g, leaf in zip(grads, leaves):
                if leaf.owner:
                    total = total + g.float().square().sum()
            dist.all_reduce(total)
            gnorm = torch.sqrt(total)
            # AdamW updates the optimizer shards in place through their
            # local views (``to_local`` aliases a DTensor's storage), and
            # the parameter's shard in a copy gathered back after
            like = shapes.params
            local = lambda t: tree.tree_map(  # noqa: E731
                lambda x: x.to_local(), t)
            shards = [p.redistribute(mesh, leaf.opt).to_local().clone()
                      for p, leaf in zip(stored, leaves)]
            _, opt = optimizer.update(
                tree.unflatten(like, grads),
                type(state.opt)(state.opt.step, local(state.opt.mu),
                                local(state.opt.nu),
                                None if state.opt.master is None
                                else local(state.opt.master)),
                tree.unflatten(like, shards), gnorm=gnorm)
            opt = type(opt)(opt.step, state.opt.mu, state.opt.nu,
                            state.opt.master)
            new_params = [
                _from_local(s, mu).redistribute(mesh, leaf.param)
                for s, mu, leaf in zip(shards, tree.leaves(state.opt.mu),
                                       leaves)]
            out = {k: torch.stack([m[k] for m in per_mb]).mean()
                   for k in per_mb[0]}
            out["grad_norm"] = gnorm
        return TrainState(tree.unflatten(like, new_params), opt,
                          state.step + 1), out

    return train_step
