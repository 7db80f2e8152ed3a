"""The rank bodies of the port's multi-rank tests
(``tests/test_torch_sharded_step.py``, ``tests/test_torch_moe_ep.py``,
``tests/test_torch_dryrun.py``, ``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_tp_ssm_mla_moe.py``, ``tests/test_torch_tp_decode.py``,
``tests/test_torch_seqpar.py``, ``tests/test_torch_seqpar_ssm_mla_moe.py``,
``tests/test_torch_tp_uneven_heads.py``, ``tests/test_torch_seqpar_pad.py``,
``tests/test_torch_remat_fsdp_tp.py``,
``tests/test_torch_shard_seq_refusal.py``).
Holds no tests of its own and imports no JAX: ``launch.sharded.spawn``
starts each rank in a new process, which imports this module by name.

A parent writes each case's inputs with ``torch.save`` into a directory;
every rank reads them, runs its share, and rank 0 writes the gathered
results beside them for the parent to compare.
"""
import dataclasses
from pathlib import Path

import torch

from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharded import init_rank


def reduced(arch, **moe):
    """The port's reduced ``arch`` with ``moe`` replaced into its MoE
    config."""
    cfg = get_arch(arch).reduced()
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def job_cfg(job):
    """A step job's reduced config: ``job["moe"]`` replaced into its MoE
    config, ``job["attn"]`` (if any) into its attention config and
    ``job["vocab"]`` (if any) as its vocabulary."""
    cfg = reduced(job["arch"], **job.get("moe", {}))
    if job.get("attn"):
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, **job["attn"]))
    if job.get("vocab"):
        cfg = dataclasses.replace(cfg, vocab=job["vocab"])
    return cfg


def mesh_name(*sizes):
    return "x".join(str(n) for n in sizes)


def host_mesh(sizes):
    """``make_host_mesh`` of (data, model) or (pod, data, model) sizes."""
    return make_host_mesh(sizes[-1], pods=sizes[0] if len(sizes) == 3
                          else 1)


def sharded_steps(rank, world, store_path, sizes, job_dir, cases):
    """Each case's steps through ``make_sharded_train_step`` on the mesh of
    ``sizes`` ((data, model) or (pod, data, model)), sequence-parallel
    where the job says ``seqpar``, with ``remat`` where it says so; rank 0
    saves every step's metrics and the gathered parameters as
    ``{case}_{mesh}.out``, with the MoE assignments dropped at capacity
    over every rank (``count_drops``) where the job says ``count_drops``.
    A job's ``mutate``: True, ``unsum_partial_grads``; "norms",
    ``unsum_norm_grads``; "floor_blocks", ``floor_kv_blocks``;
    "router_pad", ``router_reads_padding`` (the last two around the
    steps, since they act in the forward).  A job's ``pad_fill``: the
    value of the seqpar blocks' pad rows forward (``collectives.
    PAD_FILL``)."""
    import torch.distributed as dist
    from repro_torch.sharding import collectives
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW, cosine_with_warmup
    from repro_torch.train.sharded import (full_train_state,
                                           make_sharded_train_step,
                                           shard_train_state)
    from repro_torch.train.state import TrainState
    init_rank(rank, world, store_path, "cpu")
    mesh = host_mesh(sizes)
    job_dir = Path(job_dir)
    for case in cases:
        job = torch.load(job_dir / f"{case}.in")
        cfg = job_cfg(job)
        model = build_model(cfg, "cpu")
        opt = AdamW(lr=cosine_with_warmup(*job["lr"]))
        params = job["params"]
        state = shard_train_state(
            TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32)), mesh,
            fsdp=job["fsdp"])
        mutate = job.get("mutate")
        undo = unsum_partial_grads() if mutate is True \
            else unsum_norm_grads() if mutate == "norms" else None
        try:
            step = make_sharded_train_step(model, opt, job["n_micro"], mesh,
                                           fsdp=job["fsdp"],
                                           seqpar=job.get("seqpar", False),
                                           remat=job.get("remat", False))
        finally:
            if undo is not None:
                undo()
        undos = [floor_kv_blocks(sizes[-1], rank % sizes[-1])] \
            if mutate == "floor_blocks" else [router_reads_padding()] \
            if mutate == "router_pad" else []
        drops = []
        if job.get("count_drops"):
            undos.append(count_drops(drops))
        fill = collectives.PAD_FILL
        collectives.PAD_FILL = job.get("pad_fill", fill)
        out = []
        try:
            for batch in job["batches"]:
                drops.clear()
                state, metrics = step(state, batch)
                full = full_train_state(state)
                out.append({"metrics": {k: v.clone() for k, v in
                                        metrics.items()},
                            "params": dict(tree.leaves_with_path(
                                full.params)),
                            "step": int(state.step)})
                if job.get("count_drops"):
                    n = torch.tensor(sum(drops))
                    dist.all_reduce(n)
                    out[-1]["drops"] = int(n)
        finally:
            collectives.PAD_FILL = fill
            for undo in undos:
                undo()
        if rank == 0:
            torch.save(out, job_dir / f"{case}_{mesh_name(*sizes)}.out")


def count_drops(drops):
    """Wraps ``moe.route`` to append, for each routing, the assignments
    to the experts held here that the capacity dropped to ``drops``;
    returns the function that undoes it."""
    from repro_torch.models import moe
    route = moe.route

    def counted(router, cfg, xt):
        r = route(router, cfg, xt)
        drops.append(int((r.held & ~r.keep).sum()))
        return r
    moe.route = counted
    return lambda: setattr(moe, "route", route)


def router_reads_padding():
    """The mutation of the padded sequence parallelism that its tests must
    catch: every gather over the sequence whose gradient is the block (a
    module computed whole, and the MoE router's tokens) keeps the pad
    rows, so the router routes them.  Returns the function that undoes
    it."""
    from repro_torch.sharding import collectives
    gather = collectives.gather_from_sequence

    def mutated(x, group, grad="reduce_scatter", seq_len=None):
        return gather(x, group, grad, None if grad == "block" else seq_len)
    collectives.gather_from_sequence = mutated
    return lambda: setattr(collectives, "gather_from_sequence", gather)


def moe_ep(rank, world, store_path, model_size, job_dir):
    """``moe_apply_ep`` forward and backward on a (world // model_size,
    model_size) mesh: each rank takes its rows of ``x``, its block of
    experts and, where ``shared_expert_splits``, its d_ff part of the
    shared expert, and the objective is scale * sum(y * w) + aux (summed
    over the ranks' rows, the global objective).  Rank 0 saves y and x's
    gradient over all rows, the aux loss, the router's gradient summed
    over the data ranks, and the expert blocks' and the shared expert's
    gradients summed over the data ranks and, where split, gathered over
    the model ranks."""
    import torch.distributed as dist
    from repro_torch.models import moe
    from repro_torch.sharding import collectives, rules
    init_rank(rank, world, store_path, "cpu")
    mesh = make_host_mesh(model_size)
    g = collectives.MeshGroups(mesh)
    job_dir = Path(job_dir)
    job = torch.load(job_dir / f"moe_{mesh_name(g.n_data, g.n_model)}.in")
    cfg = reduced(job["arch"], **job["moe"])
    held = cfg.moe.n_experts // g.n_model
    rows = job["x"].shape[0] // g.n_data
    sl = slice(g.data_rank * rows, (g.data_rank + 1) * rows)
    p = {k: (v[g.model_rank * held:(g.model_rank + 1) * held]
             if k in ("w_in", "w_gate", "w_out") else v)
         for k, v in job["p"].items()}
    # the shared expert's d_ff: w_in / w_gate columns, w_out rows
    shared_dim = {"w_in": -1, "w_gate": -1, "w_out": -2}
    split = "shared" in p and rules.shared_expert_splits(cfg, g.n_model)
    if split:
        p["shared"] = {k: v.chunk(g.n_model, shared_dim[k])[g.model_rank]
                       for k, v in p["shared"].items()}
    leaves = [t.clone().requires_grad_(True) for t in tree.leaves(p)]
    x = job["x"][sl].clone().requires_grad_(True)
    y, aux = moe.moe_apply_ep(tree.unflatten(p, leaves), cfg, x, mesh)
    obj = (y * job["w"][sl]).sum() * job["scale"] + aux
    grads = torch.autograd.grad(obj, leaves + [x])
    gp = dict(zip([k for k, _ in tree.leaves_with_path(p)], grads[:-1]))

    def gather(t, group, n, dim=0):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim)
    out = {"aux": aux.detach()}
    data = g.data_groups[0]
    out["y"] = gather(y.detach(), data, g.n_data)
    out["dx"] = gather(grads[-1], data, g.n_data)
    for k, t in gp.items():
        t = collectives.all_reduce(t.clone(), g.data_groups)
        if any(k == f"['{e}']" for e in ("w_in", "w_gate", "w_out")):
            t = gather(t, g.model_group, g.n_model)
        elif split and k.startswith("['shared']"):
            t = gather(t, g.model_group, g.n_model,
                       shared_dim[k.split("'")[-2]])
        out["grad" + k] = t
    if rank == 0:
        torch.save(out, job_dir / f"moe_{mesh_name(g.n_data, g.n_model)}"
                                  f".out")


def dryrun_counts(rank, world, store_path, model_size, job_dir, archs,
                  shape, n_micro, moe=None):
    """Each arch's (reduced) train step of ``launch.dryrun.build_pair`` run
    for real on CPU tensors over a (world // model_size, model_size) mesh
    under a ``WorkCounter``, with ``moe[arch]`` (if given) replaced into
    its MoE config; rank 0 saves each one's counts as
    ``dryrun_{arch}.out``."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import build_pair, count_step
    init_rank(rank, world, store_path, "cpu")
    mesh = make_host_mesh(model_size)
    for arch in archs:
        cfg = reduced(arch, **(moe or {}).get(arch, {}))
        step, args, _ = build_pair(cfg, ShapeConfig(*shape), mesh,
                                   n_micro=n_micro, device="cpu")
        counter, _ = count_step(step, args, mesh)
        if rank == 0:
            torch.save({"flops": counter.flops,
                        "hbm_bytes": counter.hbm_bytes,
                        "collectives": counter.collectives,
                        "kernel_calls": dict(counter.kernel_calls)},
                       Path(job_dir) / f"dryrun_{arch}.out")


# ---------------------------------------------------------------------------
# tensor-parallel modules (tests/test_torch_tensor_parallel.py)
# ---------------------------------------------------------------------------

TP_PARENT = {"attention": "attn", "mlp": "mlp", "vocab": "embed"}


def tp_cfg(job):
    """The port's reduced config of a job, with its attention fields and
    vocabulary replaced where the job says."""
    cfg = get_arch(job["arch"]).reduced()
    if job.get("attn"):
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, **job["attn"]))
    if job.get("vocab"):
        cfg = dataclasses.replace(cfg, vocab=job["vocab"])
    return cfg


def tp_module(job, cfg, groups=None):
    """``job["module"]`` forward and backward on this model rank's compute
    shards of ``job["params"]`` (by ``compute_use``; whole without
    ``groups``), through the split path where the rules put it as
    ``blocks.block_apply`` and ``model.forward`` do: attention (objective
    sum(y * probe)), the MLP (the same), or the vocab-parallel embedding,
    logits and cross-entropy (objective ce + sum(embedding * probe)).
    Returns each leaf's use, the outputs whole (logits gathered) and every
    gradient whole: a split leaf's gathered, a ``PARTIAL`` leaf's summed
    over the model ranks."""
    import torch.distributed as dist
    from repro_torch.models import layers
    from repro_torch.models.model import cross_entropy
    from repro_torch.sharding import collectives, rules
    n = 1 if groups is None else groups.n_model
    parent = TP_PARENT[job["module"]]
    uses, dims, local = {}, {}, {}
    for name, t in job["params"].items():
        spec = rules.param_spec((parent, name), tuple(t.shape), n)
        uses[name] = rules.compute_use((parent, name), cfg, n)
        if uses[name] in rules.SPLIT_USES:
            dims[name] = spec.index("model")
            t = t.chunk(n, dims[name])[groups.model_rank]
        local[name] = t.clone().requires_grad_(True)
    x = job["x"].clone().requires_grad_(True)
    if job["module"] == "attention":
        split = groups if rules.attention_splits(cfg, n) else None
        y = layers.attention_apply(
            local, cfg, x, layer_is_local=False, groups=split,
            positions=torch.arange(x.shape[1], dtype=torch.int32))
        outs, obj = {"y": y}, (y * job["probe"]).sum()
    elif job["module"] == "mlp":
        split = groups if rules.mlp_splits(cfg, n) else None
        y = layers.mlp_apply(local, x, cfg.mlp_act, cfg.gated_mlp,
                             groups=split)
        outs, obj = {"y": y}, (y * job["probe"]).sum()
    else:
        split = groups if uses["w"] == rules.VOCAB else None
        emb = layers.embed_apply(local, job["tokens"], cfg.embed_scale,
                                 cfg.d_model, groups=split)
        logits = layers.logits_apply(local["w"], x, split)
        ce = cross_entropy(logits, job["targets"], job.get("mask"),
                           vocab=split)
        outs = {"emb": emb, "logits": logits, "ce": ce}
        obj = ce + (emb * job["probe"]).sum()
    grads = torch.autograd.grad(obj, list(local.values()) + [x])

    def gather(t, dim):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=groups.model_group)
        return torch.cat(parts, dim)
    res = {"uses": uses, "split": split is not None}
    for k, v in outs.items():
        res[k] = gather(v.detach(), -1) if k == "logits" and split \
            else v.detach()
    for name, grad in zip(local, grads):
        if name in dims:
            grad = gather(grad, dims[name])
        elif uses[name] == rules.PARTIAL:
            grad = collectives.all_reduce(grad.clone(),
                                          [groups.model_group])
        res["d" + name] = grad
    res["dx"] = grads[-1]
    return res


def tp_modules(rank, world, store_path, job_dir, cases):
    """``tp_module`` of each case on a (1, world) mesh; rank 0 saves each
    result as ``tp_{case}_{world}.out``."""
    from repro_torch.sharding import collectives
    init_rank(rank, world, store_path, "cpu")
    groups = collectives.MeshGroups(make_host_mesh(world))
    job_dir = Path(job_dir)
    for case in cases:
        job = torch.load(job_dir / f"tp_{case}.in")
        res = tp_module(job, tp_cfg(job), groups)
        if rank == 0:
            torch.save(res, job_dir / f"tp_{case}_{world}.out")


# ---------------------------------------------------------------------------
# tensor-parallel Mamba2, MLA and MoE (tests/test_torch_tp_ssm_mla_moe.py)
# ---------------------------------------------------------------------------

TP_BLOCK_PARENT = {"mamba": "mamba", "mla": "attn", "moe": "moe"}


def tp_block_cfg(job):
    """The port's reduced config of a job, its MoE fields replaced where
    the job says."""
    return reduced(job["arch"], **job.get("moe", {}))


def tp_block(job, cfg, groups=None):
    """``job["module"]`` forward and backward on this model rank's compute
    shards of ``job["params"]`` (by ``compute_use``; whole without
    ``groups``), through the path ``blocks.block_apply`` takes: Mamba2
    (``ssm.mamba_apply``), MLA (``mla.mla_apply``) or the MoE FFN
    (``moe_apply``, ``moe_apply_ep`` or ``moe_apply_dff``, the shared
    expert inside).  Objective sum(y * probe) (plus the aux loss for MoE).
    Returns each leaf's use, the path taken, the outputs and every
    gradient whole: a split leaf's gathered, a ``PARTIAL`` leaf's summed
    over the model ranks."""
    import torch.distributed as dist
    from repro_torch.models import mla, moe, ssm
    from repro_torch.sharding import collectives, rules
    from repro_torch.sharding.rules import path_names
    n = 1 if groups is None else groups.n_model
    parent = TP_BLOCK_PARENT[job["module"]]
    keys, uses, dims, local = [], {}, {}, []
    for k, t in tree.leaves_with_path(job["params"]):
        names = (parent,) + path_names(k)
        key = "/".join(names[1:])
        spec = rules.param_spec(names, tuple(t.shape), n)
        uses[key] = rules.compute_use(names, cfg, n)
        if uses[key] in rules.SPLIT_USES and groups is not None:
            dims[key] = spec.index("model")
            t = t.chunk(n, dims[key])[groups.model_rank]
        keys.append(key)
        local.append(t.clone().requires_grad_(True))
    p = tree.unflatten(job["params"], local)
    x = job["x"].clone().requires_grad_(True)
    aux = None
    if job["module"] == "mamba":
        path = "split" if rules.mamba_splits(cfg, n) else "whole"
        y = ssm.mamba_apply(p, cfg, x,
                            groups=groups if path == "split" else None)
    elif job["module"] == "mla":
        path = "split" if rules.mla_splits(cfg, n) else "whole"
        y = mla.mla_apply(p, cfg, x, torch.arange(x.shape[1]),
                          groups=groups if path == "split" else None)
    elif groups is not None and rules.experts_split(cfg, n):
        path = "ep"
        y, aux = moe.moe_apply_ep(p, cfg, x, groups)
    elif rules.expert_ffn_splits(cfg, n):
        path = "dff"
        y, aux = moe.moe_apply_dff(p, cfg, x, groups)
    else:
        path = "whole"
        y, aux = moe.moe_apply(p, cfg, x)
    obj = (y * job["probe"]).sum()
    if aux is not None:
        obj = obj + aux
    grads = torch.autograd.grad(obj, local + [x])

    def gather(t, dim):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=groups.model_group)
        return torch.cat(parts, dim)
    res = {"uses": uses, "path": path, "y": y.detach()}
    if aux is not None:
        res["aux"] = aux.detach()
    for key, grad in zip(keys, grads):
        if key in dims:
            grad = gather(grad, dims[key])
        elif uses[key] == rules.PARTIAL:
            grad = collectives.all_reduce(grad.clone(),
                                          [groups.model_group])
        res["d" + key] = grad
    res["dx"] = grads[-1]
    return res


def tp_blocks(rank, world, store_path, job_dir, cases):
    """``tp_block`` of each case on a (1, world) mesh; rank 0 saves each
    result as ``block_{case}_{world}.out``."""
    from repro_torch.sharding import collectives
    init_rank(rank, world, store_path, "cpu")
    groups = collectives.MeshGroups(make_host_mesh(world))
    job_dir = Path(job_dir)
    for case in cases:
        job = torch.load(job_dir / f"block_{case}.in")
        res = tp_block(job, tp_block_cfg(job), groups)
        if rank == 0:
            torch.save(res, job_dir / f"block_{case}_{world}.out")


def unsum_partial_grads():
    """The mutation of the sharded step that its tests must catch: each
    ``PARTIAL`` leaf's gradient taken as the forward's placement over the
    model axis (replicated) instead of a partial sum, so no rank sums
    it.  Returns the function that undoes it."""
    from repro_torch.sharding.rules import PARTIAL
    from repro_torch.train import sharded
    init = sharded._Leaf.__init__

    def mutated(self, use, *args):
        init(self, use, *args)
        if use == PARTIAL:
            self.grad[-1] = self.compute[-1]
    sharded._Leaf.__init__ = mutated
    return lambda: setattr(sharded._Leaf, "__init__", init)


def floor_kv_blocks(n_model, model_rank):
    """The mutation of uneven head blocks that their tests must catch: each
    rank's query heads are still ``rules.head_block``'s (``tensor_split``'s
    blocks, the larger ones first), but the KV heads it projects and reads
    for them are those of the floor convention's block, which starts at
    head ``model_rank * (n_heads // n_model)``.  Returns the function that
    undoes it."""
    from repro_torch.models import layers
    kv = layers._kv_of_heads

    def mutated(wk, wv, a, first, n):
        return kv(wk, wv, a, model_rank * (a.n_heads // n_model), n)
    layers._kv_of_heads = mutated
    return lambda: setattr(layers, "_kv_of_heads", kv)


def unsum_norm_grads():
    """The mutation of the sequence-parallel step that its tests must
    catch: the norms on the residual (``rules.RESIDUAL_NORMS``), which
    each rank runs on its block of the sequence, used as without
    ``seqpar`` (``WHOLE``), so their partial gradients are left unsummed
    over the model axis.  Returns the function that undoes it."""
    from repro_torch.sharding import rules
    from repro_torch.train import sharded
    uses = sharded.compute_uses

    def mutated(params_shape, cfg, n_model, seqpar=False):
        return [(names, rules.WHOLE if seqpar and use == rules.PARTIAL
                 and names[-2] in rules.RESIDUAL_NORMS else use, dim)
                for names, use, dim in uses(params_shape, cfg, n_model,
                                            seqpar)]
    sharded.compute_uses = mutated
    return lambda: setattr(sharded, "compute_uses", uses)


# ---------------------------------------------------------------------------
# sequence parallelism (tests/test_torch_seqpar.py)
# ---------------------------------------------------------------------------

def seqpar_regions(job, groups, whole_grad: str = "block"):
    """The sequence-parallel region functions on this rank of ``groups``'
    model axis (``groups.seqpar``), each forward and backward: (1)
    ``scatter_to_sequence`` of the whole ``x``, (2)
    ``gather_from_sequence`` of x's block, gradient reduce-scattered, read
    by each rank through its own probe (a split module), (3) the same with
    the gradient's block (a module computed whole, one probe), (4)
    ``reduce_scatter_to_sequence`` of the partials (rank + 1) x; and a
    layer of them, ``layer``: x split, an RMSNorm on the block, an MLP split
    over d_ff between ``enter_region`` and ``leave_region``, the residual
    add, a product computed whole between ``gather_from_sequence(...,
    whole_grad)`` and ``scatter_to_sequence``, the residual add, objective
    sum(out * probe).  Returns each output gathered whole over the
    sequence and each gradient whole (x's and the whole product's as they
    are, the norm's summed over the model ranks, the split MLP's gathered);
    keys "{part}/y" and "{part}/d{leaf}"."""
    from repro_torch.models import layers
    from repro_torch.sharding import collectives as c
    model, n, r = groups.model_group, groups.n_model, groups.model_rank
    x, probe, probes = job["x"], job["probe"], job["probes"]
    size = x.shape[1] // n
    mine = slice(r * size, (r + 1) * size)

    def gather(t, dim=1):
        return c.all_gather(t.detach().contiguous(), model, dim)
    out = {}
    # (1) scatter
    xw = x.clone().requires_grad_(True)
    y = c.scatter_to_sequence(xw, model)
    (y * probe[:, mine]).sum().backward()
    out.update({"scatter/y": gather(y), "scatter/dx": xw.grad})
    # (2), (3) gather, the gradient reduce-scattered or this rank's block
    for grad, p in (("reduce_scatter", probes[r]), ("block", probe)):
        xb = x[:, mine].clone().requires_grad_(True)
        y = c.gather_from_sequence(xb, model, grad)
        (y * p).sum().backward()
        out.update({f"gather_{grad}/y": y.detach(),
                    f"gather_{grad}/dx": gather(xb.grad)})
    # (4) reduce-scatter of partial sums
    xp = (x * (r + 1)).clone().requires_grad_(True)
    y = c.reduce_scatter_to_sequence(xp, model)
    (y * probe[:, mine]).sum().backward()
    out.update({"reduce_scatter/y": gather(y), "reduce_scatter/dx": xp.grad})
    # the layer
    f = job["w_in"].shape[-1] // n
    leaves = {"x": x, "scale": job["scale"],
              "w_in": job["w_in"][:, r * f:(r + 1) * f],
              "w_out": job["w_out"][r * f:(r + 1) * f], "w": job["w"]}
    leaves = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    xb = c.scatter_to_sequence(leaves["x"], model)
    h = layers.rms_norm_weighted(xb, leaves["scale"])
    a = torch.nn.functional.silu(c.enter_region(h, groups) @ leaves["w_in"])
    res = xb + c.leave_region(a @ leaves["w_out"], groups)
    z = c.gather_from_sequence(res, model, whole_grad) @ leaves["w"]
    y = res + c.scatter_to_sequence(z, model)
    (y * probe[:, mine]).sum().backward()
    out["layer/y"] = gather(y)
    for k, t in leaves.items():
        g = t.grad
        if k == "scale":
            g = c.all_reduce(g.clone(), [model])
        elif k in ("w_in", "w_out"):
            g = gather(g, -1 if k == "w_in" else 0)
        out[f"layer/d{k}"] = g
    return out


def seqpar_region_ranks(rank, world, store_path, job_dir):
    """``seqpar_regions`` on a (1, world) mesh, sound and with the whole
    product's gather reduce-scattering its gradient (the mutation a split
    module's backward would be); rank 0 saves both as
    ``regions_{world}.out``."""
    from repro_torch.sharding import collectives
    init_rank(rank, world, store_path, "cpu")
    groups = collectives.MeshGroups(make_host_mesh(world), seqpar=True)
    job = torch.load(Path(job_dir) / "regions.in")
    res = {"sound": seqpar_regions(job, groups),
           "mutant": seqpar_regions(job, groups, "reduce_scatter")}
    if rank == 0:
        torch.save(res, Path(job_dir) / f"regions_{world}.out")


def seqpar_compare(rank, world, store_path, job_dir, arch, mutate):
    """``launch.sharded.compare`` of reduced ``arch``'s sequence-parallel
    sharded step against the fused one on a (1, world) mesh, under
    ``unsum_norm_grads`` where ``mutate``; rank 0 saves the records as
    ``compare_{arch}_{mutate}.out``."""
    from repro_torch.launch.sharded import compare
    init_rank(rank, world, store_path, "cpu")
    undo = unsum_norm_grads() if mutate else None
    try:
        recs = compare(reduced(arch), make_host_mesh(world), steps=2,
                       seq=32, batch=4, n_micro=2, seqpar=True)
    finally:
        if undo is not None:
            undo()
    if rank == 0:
        torch.save(recs, Path(job_dir) / f"compare_{arch}_{mutate}.out")


def seqpar_forwards(rank, world, store_path, job_dir, cases):
    """Each case's forward on a (1, world) mesh, sequence-parallel, from
    this rank's compute shards of the job's whole parameters: the logits
    (and MTP logits) gathered over the vocabulary where it is split, and
    ``last_logits_only``'s; and the same of a sequence one position
    longer, which the axis does not divide (its blocks padded), under
    "longer/".  Rank 0 saves each as ``prefill_{case}_{world}.out``."""
    from repro_torch.models.model import build_model
    from repro_torch.sharding import collectives, rules
    from repro_torch.train.sharded import compute_params
    init_rank(rank, world, store_path, "cpu")
    g = collectives.MeshGroups(make_host_mesh(world), seqpar=True)
    job_dir = Path(job_dir)
    for case in cases:
        job = torch.load(job_dir / f"prefill_{case}.in")
        cfg = job_cfg(job)
        model = build_model(cfg, "cpu")
        params = compute_params(job["params"], cfg, g)
        vocab = rules.vocab_splits(cfg, g.n_model)
        res = {}
        for prefix, batch in (("", job["batch"]),
                              ("longer/", longer_batch(job["batch"]))):
            with torch.no_grad():
                logits, extras = model.forward(params, batch, groups=g)
                last, _ = model.forward(params, batch, groups=g,
                                        last_logits_only=True)
            res.update({prefix + "last": last, prefix + "aux": extras["aux"]})
            for k, v in (("logits", logits),
                         ("mtp_logits", extras.get("mtp_logits"))):
                if v is not None:
                    res[prefix + k] = collectives.all_gather(
                        v, g.model_group, -1) if vocab else v
        if rank == 0:
            torch.save(res, job_dir / f"prefill_{case}_{world}.out")


def seqpar_variants(rank, world, store_path, job_dir, seq):
    """A bf16 sequence-parallel forward and backward of reduced gemma-2b
    (64-wide heads) on a (1, world) mesh at ``seq`` tokens, 2 rows, from
    this rank's compute shards: records the ``variant`` each kernel-1,
    1-bwd and 2-bwd call's inputs select, the sequence length kernel 1
    sees and the (rows, positions) 2-bwd sees; rank 0 saves them as
    ``variants.out``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm_bwd as rb
    from repro_torch.models.model import build_model
    from repro_torch.sharding import collectives
    from repro_torch.train.sharded import compute_params
    init_rank(rank, world, store_path, "cpu")
    g = collectives.MeshGroups(make_host_mesh(world), seqpar=True)
    cfg = reduced("gemma-2b")
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                              attn=dataclasses.replace(cfg.attn,
                                                       head_dim=64))
    model = build_model(cfg, "cpu")
    params = tree.tree_map(
        lambda t: t.detach().clone().requires_grad_(t.is_floating_point()),
        compute_params(model.init(0), cfg, g))
    seen = {k: [] for k in ("flash_attention", "flash_attention_bwd",
                            "rmsnorm_bwd", "attention_seq", "rmsnorm_rows")}
    fwd, bwd, norm_bwd = (ops.flash_attention_fwd, ops.flash_attention_bwd,
                          ops.rmsnorm_bwd)

    def rec_fwd(q, k, v, **kw):
        seen["flash_attention"].append(fa.variant(q, k, v))
        seen["attention_seq"].append(q.shape[1])
        return fwd(q, k, v, **kw)

    def rec_bwd(q, k, v, o, lse, do, **kw):
        seen["flash_attention_bwd"].append(fb.variant(q, k, v, o, do))
        return bwd(q, k, v, o, lse, do, **kw)

    def rec_norm_bwd(x, scale, gr, **kw):
        seen["rmsnorm_bwd"].append(rb.variant(x, gr, scale))
        seen["rmsnorm_rows"].append(tuple(x.shape[:2]))
        return norm_bwd(x, scale, gr, **kw)
    ops.flash_attention_fwd, ops.flash_attention_bwd, ops.rmsnorm_bwd = \
        rec_fwd, rec_bwd, rec_norm_bwd
    try:
        tokens = torch.randint(0, cfg.vocab, (2, seq),
                               generator=torch.Generator().manual_seed(1),
                               dtype=torch.int32)
        loss, _ = model.loss(params, {"tokens": tokens}, groups=g)
        loss.backward()
    finally:
        ops.flash_attention_fwd, ops.flash_attention_bwd, \
            ops.rmsnorm_bwd = fwd, bwd, norm_bwd
    if rank == 0:
        torch.save(seen, Path(job_dir) / "variants.out")


def longer_batch(batch):
    """``batch`` one position longer: its last token (or frame, label and
    mask entry) repeated; a vision prefix as it is."""
    return {k: torch.cat([v, v[:, -1:]], 1) if k != "prefix_embeds" else v
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# tensor-parallel decode (tests/test_torch_tp_decode.py)
# ---------------------------------------------------------------------------

def tp_decode_cfg(job):
    """The port's reduced config of a decode job, its attention fields
    replaced where the job says."""
    cfg = get_arch(job["arch"]).reduced()
    if job.get("attn"):
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, **job["attn"]))
    return cfg


def unscaled_combine():
    """The mutation of flash-decoding that its tests must catch: the ranks'
    partial sums added without rescaling each to the max over the ranks.
    Returns the function that undoes it."""
    from repro_torch.sharding import collectives
    combine = collectives.combine_attention

    def mutated(m, l, o, groups):
        parts = torch.cat([o, l[..., None]], -1).contiguous()
        parts = collectives.all_reduce(parts, groups)
        total = parts[..., -1:]
        return torch.where(total > 0, parts[..., :-1] / total, 0.0)
    collectives.combine_attention = mutated
    return lambda: setattr(collectives, "combine_attention", combine)


def _cache_checks(cfg, caches, batch, capacity, groups, kv_model,
                  shard_seq):
    """(shapes, replicas): whether every leaf of this rank's ``caches``
    has the local shape of ``cache_specs`` (each dim divided by the sizes
    of the axes its spec names; a split Mamba2's ``conv`` holding [x_r | B
    | C]), and whether each attention or MLA leaf held whole over
    ``model`` is bitwise the same on every model rank."""
    from repro_torch.models.model import build_model
    from repro_torch.sharding import collectives, rules
    lay = rules.layout_of(groups.mesh)
    whole = build_model(cfg, "meta").init_cache(batch, capacity)
    specs = rules.cache_specs(whole, groups.data_axes, groups.n_data,
                              groups.n_model, shard_seq=shard_seq,
                              kv_model=kv_model)

    def axes(part):
        return () if part is None else \
            part if isinstance(part, tuple) else (part,)
    shapes_ok, replicas_ok = True, True
    for (k, leaf), spec, got in zip(
            tree.leaves_with_path(whole),
            tree.leaves(specs, is_leaf=rules.is_spec), tree.leaves(caches)):
        want = []
        for d, part in zip(leaf.shape, spec):
            for a in axes(part):
                d //= lay.size(a)
            want.append(d)
        name = rules.path_names(k)[-1]
        if name == "conv" and rules.mamba_splits(cfg, groups.n_model):
            s = cfg.ssm
            want[-1] = s.d_inner(cfg.d_model) // groups.n_model \
                + 2 * s.d_state
        shapes_ok &= tuple(got.shape) == tuple(want)
        if name in ("k", "v", "ckv", "k_rope") and not any(
                "model" in axes(p) for p in spec):
            parts = collectives.all_gather(got, groups.model_group, 0)
            replicas_ok &= all(torch.equal(p, got)
                               for p in parts.chunk(groups.n_model, 0))
    return shapes_ok, replicas_ok


def tp_decode(rank, world, store_path, sizes, job_dir, cases):
    """Each case's ``serve.decode.generate`` tensor-parallel on the mesh of
    ``sizes`` (data, model): every rank takes its compute shards of the
    job's whole parameters and decodes its lanes of the prompt; rank 0
    saves the tokens, each step's logits made whole (gathered over the
    vocabulary and the lanes), and whether every rank's caches passed
    ``_cache_checks`` after the last step, as ``decode_{case}_{mesh}.out``.
    A job with ``mutate`` runs under ``unscaled_combine``.  On the (1, 2)
    mesh rank 0 also saves ``argmax_over_vocab`` of constructed ties."""
    import torch.distributed as dist
    from repro_torch.models.model import build_model
    from repro_torch.serve.decode import gather_lanes, generate
    from repro_torch.sharding import collectives, rules
    from repro_torch.train.sharded import compute_params
    init_rank(rank, world, store_path, "cpu")
    g = collectives.MeshGroups(host_mesh(sizes))
    job_dir = Path(job_dir)
    name = mesh_name(*sizes)
    for case in cases:
        job = torch.load(job_dir / f"decode_{case}.in")
        cfg = tp_decode_cfg(job)
        model = build_model(cfg, "cpu")
        prompt = job["prompt"]
        B = prompt.shape[0]
        steps, seen = [], {}

        def record(decoder, run):
            logits = run()
            seen["decoder"] = decoder
            full = logits
            if rules.vocab_splits(cfg, g.n_model):
                full = collectives.all_gather(logits, g.model_group, -1)
            steps.append(gather_lanes(full, B, g))
            return logits
        undo = unscaled_combine() if job.get("mutate") else None
        try:
            tokens = generate(model, compute_params(job["params"], cfg, g),
                              prompt, job["n_new"], job["capacity"],
                              wrap=record, groups=g,
                              kv_model=job["kv_model"],
                              shard_seq=job["shard_seq"])
        finally:
            if undo is not None:
                undo()
        checks = torch.tensor([float(c) for c in _cache_checks(
            cfg, seen["decoder"].caches, B, job["capacity"], g,
            job["kv_model"], job["shard_seq"])])
        dist.all_reduce(checks, op=dist.ReduceOp.MIN)
        if rank == 0:
            torch.save({"tokens": tokens, "logits": steps,
                        "shapes_ok": bool(checks[0]),
                        "replicas_equal": bool(checks[1])},
                       job_dir / f"decode_{case}_{name}.out")
    if sizes == (1, 2):
        logits = torch.load(job_dir / "ties.in")[g.model_rank]
        got = collectives.argmax_over_vocab(logits, g)
        if rank == 0:
            torch.save(got, job_dir / "ties.out")


def shard_seq_refusal(rank, world, store_path, sizes, job_dir, cases):
    """Each case's ``shard_seq`` decode on the mesh of ``sizes`` (data,
    model): ``generate`` of its two lanes and ``launch.sharded.
    serve_compare`` with two lanes, whose ``ValueError`` messages are
    kept (None where nothing raised), and ``generate`` of its first lane
    alone, whose tokens are kept; rank 0 saves them as
    ``refusal_{case}_{mesh}.out``."""
    from repro_torch.launch.sharded import serve_compare
    from repro_torch.models.model import build_model
    from repro_torch.serve.decode import generate
    from repro_torch.sharding import collectives
    from repro_torch.train.sharded import compute_params
    init_rank(rank, world, store_path, "cpu")
    mesh = host_mesh(sizes)
    g = collectives.MeshGroups(mesh)
    for case in cases:
        job = torch.load(Path(job_dir) / f"refusal_{case}.in")
        cfg = tp_decode_cfg(job)
        model = build_model(cfg, "cpu")
        params = compute_params(job["params"], cfg, g)
        prompt = job["prompt"]

        def message(fn):
            try:
                fn()
            except ValueError as e:
                return str(e)
            return None
        out = {"generate": message(lambda: generate(
                   model, params, prompt, job["n_new"], job["capacity"],
                   groups=g, shard_seq=True)),
               "serve_compare": message(lambda: serve_compare(
                   cfg, mesh, prompt_len=prompt.shape[1],
                   n_new=job["n_new"], batch=prompt.shape[0],
                   shard_seq=True))}
        out["one_lane"] = generate(model, params, prompt[:1], job["n_new"],
                                   job["capacity"], groups=g,
                                   shard_seq=True)
        if rank == 0:
            torch.save(out, Path(job_dir)
                       / f"refusal_{case}_{mesh_name(*sizes)}.out")


def serve_compare_ranks(rank, world, store_path, job_dir, arch):
    """``launch.sharded.serve_compare`` of reduced ``arch`` on a (1, world)
    mesh, with the whole run of every rank but 0 handing back other
    tokens than it fed itself (each token one higher): the divergence two
    processes' whole runs can show at a near tie.  Every rank saves its
    records as ``serve_{rank}.out``."""
    from repro_torch.launch import sharded
    init_rank(rank, world, store_path, "cpu")
    generate = sharded.generate
    cfg = reduced(arch)
    if rank:
        sharded.generate = lambda *a, **kw: (generate(*a, **kw) + 1) \
            % cfg.vocab
    try:
        recs = sharded.serve_compare(cfg, make_host_mesh(world),
                                     prompt_len=6, n_new=6, batch=2)
    finally:
        sharded.generate = generate
    torch.save(recs, Path(job_dir) / f"serve_{rank}.out")
