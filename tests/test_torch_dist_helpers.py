"""The rank bodies of the port's multi-rank tests
(``tests/test_torch_sharded_step.py``, ``tests/test_torch_moe_ep.py``,
``tests/test_torch_dryrun.py``).
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


def mesh_name(data, model):
    return f"{data}x{model}"


def sharded_steps(rank, world, store_path, model_size, job_dir, cases):
    """Each case's steps through ``make_sharded_train_step`` on a
    (world // model_size, model_size) mesh; rank 0 saves every step's
    metrics and the gathered parameters as ``{case}_{mesh}.out``."""
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW, cosine_with_warmup
    from repro_torch.train.sharded import (full_train_state,
                                           make_sharded_train_step,
                                           shard_train_state)
    from repro_torch.train.state import TrainState
    init_rank(rank, world, store_path, "cpu")
    mesh = make_host_mesh(model_size)
    job_dir = Path(job_dir)
    for case in cases:
        job = torch.load(job_dir / f"{case}.in")
        cfg = reduced(job["arch"], **job["moe"])
        model = build_model(cfg, "cpu")
        opt = AdamW(lr=cosine_with_warmup(*job["lr"]))
        params = job["params"]
        state = shard_train_state(
            TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32)), mesh,
            fsdp=job["fsdp"])
        step = make_sharded_train_step(model, opt, job["n_micro"], mesh,
                                       fsdp=job["fsdp"])
        out = []
        for batch in job["batches"]:
            state, metrics = step(state, batch)
            full = full_train_state(state)
            out.append({"metrics": {k: v.clone() for k, v in
                                    metrics.items()},
                        "params": dict(tree.leaves_with_path(full.params)),
                        "step": int(state.step)})
        if rank == 0:
            torch.save(out, job_dir /
                       f"{case}_{mesh_name(world // model_size, model_size)}"
                       f".out")


def moe_ep(rank, world, store_path, model_size, job_dir):
    """``moe_apply_ep`` forward and backward on a (world // model_size,
    model_size) mesh: each rank takes its rows of ``x`` and its block of
    experts, and the objective is scale * sum(y * w) + aux (summed over
    the ranks' rows, the global objective).  Rank 0 saves y
    and x's gradient over all rows, the aux loss, the expert blocks'
    gradients gathered over the model ranks, and the router's and shared
    expert's gradients summed over the data ranks."""
    import torch.distributed as dist
    from repro_torch.models import moe
    from repro_torch.sharding import collectives
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
        if any(k == f"['{e}']" for e in ("w_in", "w_gate", "w_out")):
            t = gather(collectives.all_reduce(t.clone(), g.data_groups),
                       g.model_group, g.n_model)
        else:
            t = collectives.all_reduce(t.clone(), g.data_groups)
        out["grad" + k] = t
    if rank == 0:
        torch.save(out, job_dir / f"moe_{mesh_name(g.n_data, g.n_model)}"
                                  f".out")


def dryrun_counts(rank, world, store_path, model_size, job_dir, archs,
                  shape, n_micro):
    """Each arch's (reduced) train step of ``launch.dryrun.build_pair`` run
    for real on CPU tensors over a (world // model_size, model_size) mesh
    under a ``WorkCounter``; rank 0 saves each one's counts as
    ``dryrun_{arch}.out``."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import build_pair, count_step
    init_rank(rank, world, store_path, "cpu")
    mesh = make_host_mesh(model_size)
    for arch in archs:
        step, args, _ = build_pair(reduced(arch), ShapeConfig(*shape), mesh,
                                   n_micro=n_micro, device="cpu")
        counter, _ = count_step(step, args, mesh)
        if rank == 0:
            torch.save({"flops": counter.flops,
                        "hbm_bytes": counter.hbm_bytes,
                        "collectives": counter.collectives,
                        "kernel_calls": dict(counter.kernel_calls)},
                       Path(job_dir) / f"dryrun_{arch}.out")
