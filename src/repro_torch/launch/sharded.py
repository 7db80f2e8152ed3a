"""Sharded training over ``torch.distributed`` (``train/sharded.py``), held
against the single-process fused step from the same parameters and
batches; with ``--serve``, tensor-parallel decode (``serve.decode.
ShardedDecoder``) held against the whole graphed decode (``serve_compare``).

One process per rank on one host; the ranks meet through a ``FileStore``
(no TCP port).  On the CPU the backend is gloo, on GPUs NCCL with one rank
per GPU, or gloo with several ranks on one card (``--backend gloo``):

    PYTHONPATH=src python -m repro_torch.launch.sharded --arch gemma-2b \\
        --reduced --device cpu --world 4 --model 2
    PYTHONPATH=src python -m repro_torch.launch.sharded \\
        --arch granite-moe-3b-a800m --reduced --device cpu --world 2
    PYTHONPATH=src python -m repro_torch.launch.sharded --arch qwen3-4b \\
        --reduced --world 2 --model 2 --backend gloo
    PYTHONPATH=src python -m repro_torch.launch.sharded --arch gemma-2b \\
        --reduced --device cpu --world 4 --model 4 --seqpar
    PYTHONPATH=src python -m repro_torch.launch.sharded --serve \\
        --arch gemma-2b --reduced --device cpu --world 2 --model 2 --kv-model

Rank 0 prints each step's loss and gradient norm from both steps and the
largest difference of the loss, the norm and every parameter leaf; with
``--serve``, each decode step's greedy tokens from both, the logits'
largest difference and both steps' seconds.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Dict, List

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticLM, stack_microbatches
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import launch_counts
from repro_torch.models.model import build_model
from repro_torch.optim import AdamW, cosine_with_warmup
from repro_torch.serve.decode import (ShardedDecoder, gather_lanes,
                                      generate, greedy, lanes_of)
from repro_torch.sharding import collectives, rules
from repro_torch.train.sharded import (compute_params,
                                       make_sharded_train_step,
                                       shard_train_state)
from repro_torch.train.state import init_train_state
from repro_torch.train.step import make_train_step


def init_rank(rank: int, world: int, store_path: str, device: str,
              backend: str = None) -> None:
    """Joins the world of ``world`` ranks meeting at ``store_path``: gloo
    for ``cpu``, NCCL on GPU ``rank`` for ``cuda``.  ``backend="gloo"``
    with ``cuda`` puts rank r on GPU r modulo the GPUs there are, so
    several ranks can share one card (NCCL refuses two ranks on one GPU);
    its mesh is ``make_host_mesh(..., device_type="cuda")``."""
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if device == "cuda":
        torch.cuda.set_device(rank if backend == "nccl"
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)


def _entry(rank: int, fn: Callable, world: int, store_path: str, *args):
    torch.set_num_threads(1)
    try:
        fn(rank, world, store_path, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# imported once by the fork server, ahead of every rank it forks
PRELOAD = ("torch", "torch._dynamo", "torch.distributed.tensor",
           "repro_torch.launch.sharded")


def spawn(fn: Callable, world: int, *args, store_dir: str = None,
          timeout: float = 300.0) -> None:
    """Runs ``fn(rank, world, store_path, *args)`` in ``world`` new
    processes (``fn`` and ``args`` picklable; ``store_path`` a fresh file
    under ``store_dir`` for ``init_rank``).  Raises with a rank's error if
    one fails, and kills them all and raises if they are not done within
    ``timeout`` seconds.

    The ranks are forked from Python's fork server, a fresh process that
    imports ``PRELOAD`` once (the first call in a process starts it), so
    neither they nor it inherit this process's threads or device
    state."""
    import multiprocessing
    import torch.multiprocessing as mp
    multiprocessing.set_forkserver_preload(list(PRELOAD))
    store_dir = store_dir or tempfile.mkdtemp(prefix="sharded_store_")
    store_path = os.path.join(store_dir, f"store_{os.getpid()}_"
                                         f"{time.monotonic_ns()}")
    ctx = mp.start_processes(_entry, args=(fn, world, store_path) + args,
                             nprocs=world, join=False,
                             start_method="forkserver")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks not done in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _param_diff(sharded, whole) -> tuple:
    """(largest |difference|, the worst leaf's mean |difference|, bitwise
    equal) of the parameter DTensors ``sharded`` and the whole tensors
    ``whole`` (the same on every rank), over every element: each rank
    holds its shards against the same cut of ``whole`` (a
    Replicate-to-Shard redistribute cuts locally), a leaf's mean is over
    the rank's shard of it, and the ranks' results are all-reduced by max.
    No all-gather runs: gloo refuses DTensor's on CUDA tensors."""
    from torch.distributed.tensor import DTensor, Replicate
    worst = torch.zeros(3, dtype=torch.float32, device=whole[0].device)
    for p, w in zip(sharded, whole):
        mesh = p.device_mesh
        want = DTensor.from_local(w, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False).redistribute(
            mesh, p.placements).to_local()
        got = p.to_local()
        d = (got.float() - want.float()).abs()
        worst[0] = torch.maximum(worst[0], d.max())
        worst[1] = torch.maximum(worst[1], d.mean())
        if not torch.equal(got, want):
            worst[2] = 1.0
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return float(worst[0]), float(worst[1]), not bool(worst[2])


def _replicas_equal(state) -> bool:
    """Whether every DTensor of the sharded train ``state`` (parameters,
    moments, master copies) held whole over its mesh's model axis
    (``Replicate`` there) is bitwise the same on every model rank, as the
    step must keep it: its elementwise max and min over the model ranks
    (two all-reduces a leaf, no all-gather) are equal.  A partial gradient
    left unsummed over the model axis updates each replica by its own part,
    and they part: in the moments at once, in a bf16 parameter once the
    updates pass half its ulp."""
    from torch.distributed.tensor import DTensor, Replicate
    same = True
    for p in tree.leaves(state):
        if not isinstance(p, DTensor):
            continue
        mesh = p.device_mesh
        if not isinstance(p.placements[-1], Replicate) \
                or mesh.size(mesh.ndim - 1) == 1:
            continue
        group = mesh.get_group(mesh.ndim - 1)
        t = p.to_local().float()
        hi, lo = t.clone(), t.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        same &= bool(torch.equal(hi, lo))
    return same


def compare(cfg, mesh, *, steps: int = 2, seq: int = 32, batch: int = 8,
            n_micro: int = 2, lr: float = 1e-3, seed: int = 0,
            fsdp: bool = False, seqpar: bool = False) -> List[Dict]:
    """``steps`` sharded steps over ``mesh`` and as many fused steps of one
    process, from the same parameters (seed ``seed``) and batches, on the
    mesh's device type (``cuda`` for NCCL or for gloo on a ``cuda`` mesh,
    ``cpu`` for gloo).  The fused steps run first, each step's parameters
    kept, and their state is freed before the start is made again and
    sharded, so the two states never share the device.  Returns one record
    a step: each step's metrics, seconds, tokens/s, kernel launches and
    (CUDA) peak GB, the largest |difference| of the loss, the gradient
    norm and every parameter leaf, the worst leaf's mean |difference|
    (``_param_diff``), and whether every leaf held whole over the model
    axis is the same on every model rank (``_replicas_equal``).
    ``seqpar``: the sharded step is also sequence-parallel over the model
    axis."""
    device = mesh.device_type
    model = build_model(cfg, device)
    opt = AdamW(lr=cosine_with_warmup(lr, 2, steps))
    fused_state = init_train_state(model, opt, seed)
    data = SyntheticLM(cfg, seq_len=seq, global_batch=batch, seed=seed,
                       device=str(model.device))
    batches = [stack_microbatches(data.batch(s), n_micro)
               for s in range(steps)]
    tokens = batch * (seq + cfg.n_prefix_embeds)

    def timed(fn, state, b):
        if model.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        state, m = fn(state, b)
        _sync(device)
        secs = time.perf_counter() - t0
        rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "aux": float(m["aux"]), "seconds": secs,
               "tokens_per_s": tokens / secs,
               "launches": _launches_since(before)}
        if model.device.type == "cuda":
            rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        return state, rec

    out = [{"step": s} for s in range(steps)]
    fused, kept = make_train_step(model, opt, n_micro), []
    for rec, b in zip(out, batches):
        fused_state, rec["fused"] = timed(fused, fused_state, b)
        kept.append([t.clone() for t in tree.leaves(fused_state.params)])
    del fused_state
    # the same start again (the init is seeded), sharded
    state = shard_train_state(init_train_state(model, opt, seed), mesh,
                              fsdp=fsdp)
    sharded = make_sharded_train_step(model, opt, n_micro, mesh, fsdp=fsdp,
                                      seqpar=seqpar)
    for rec, b, want in zip(out, batches, kept):
        state, rec["sharded"] = timed(sharded, state, b)
        diff, leaf_mean, equal = _param_diff(tree.leaves(state.params),
                                             want)
        rec["max_abs_diff"] = {
            "loss": abs(rec["fused"]["loss"] - rec["sharded"]["loss"]),
            "grad_norm": abs(rec["fused"]["grad_norm"]
                             - rec["sharded"]["grad_norm"]),
            "params": diff}
        rec["params_worst_leaf_mean_abs_diff"] = leaf_mean
        rec["params_bitwise_equal"] = equal
        rec["replicas_equal"] = _replicas_equal(state)
    return out


@torch.no_grad()
def serve_compare(cfg, mesh, *, prompt_len: int = 16, n_new: int = 16,
                  batch: int = 2, capacity: int = None,
                  kv_model: bool = False, shard_seq: bool = False,
                  seed: int = 0) -> List[Dict]:
    """The same prompts (``batch`` x ``prompt_len`` tokens from ``seed``)
    decoded whole and tensor-parallel over ``mesh`` from one seeded set of
    parameters, on the mesh's device type.  The whole run is ``generate``
    (its ``GraphDecoder``: a CUDA graph on the card); the sharded one,
    eager through ``ShardedDecoder`` over its ``init_cache(..., mesh=,
    kv_model=, shard_seq=)`` shards, is fed the tokens the whole run fed,
    so each step's logits are the same function of the same history (rank
    0's whole run, broadcast to every rank).
    Returns one record a step (prefill included): both greedy tokens of
    every lane, whether they match, the logits' largest |difference|
    (gathered over the vocabulary and the lanes) and the whole logits'
    largest |value|, whether this rank's own whole run took rank 0's
    tokens, and both steps' seconds and kernel launches (the whole step's
    counted through its graph's replays).  ``shard_seq`` with
    more than one lane that the data axes divide raises ``ValueError``
    before anything runs (``sharding.rules.cache_shards``)."""
    device = mesh.device_type
    cap = capacity or (prompt_len + n_new)
    kw = dict(mesh=mesh, kv_model=kv_model, shard_seq=shard_seq)
    shards = build_model(cfg, "meta").cache_shards(batch, cap, **kw)
    model = build_model(cfg, device)
    params = model.init(seed)
    groups = collectives.MeshGroups(mesh)
    gen = torch.Generator(device=str(model.device)).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                           device=model.device, dtype=torch.int32)
    whole, seconds, launches = [], [], []

    def timed(decoder, run):
        before = launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        logits = run()
        _sync(device)
        seconds.append(time.perf_counter() - t0)
        launches.append(_launches_since(before))
        whole.append(logits.clone())
        return logits
    tokens = generate(model, params, prompt, n_new, cap, wrap=timed)
    # every rank feeds the sharded decoder rank 0's whole run and holds it
    # against rank 0's logits: two processes' whole runs on one card can
    # round apart in the last bits and so take another greedy token at a
    # near tie, and ranks fed other tokens would sum parts of other
    # histories
    own = tokens.clone()
    for t in [tokens] + whole:
        dist.broadcast(t, src=0)
    as_rank0 = bool(torch.equal(own, tokens))
    fed = torch.cat([prompt, tokens], dim=1)
    decoder = ShardedDecoder(model, compute_params(params, cfg, groups),
                             model.init_cache(batch, cap, **kw), shards,
                             groups)
    del params
    vocab = rules.vocab_splits(cfg, groups.n_model)
    mine = lanes_of(batch, groups)
    out = []
    for t in range(prompt_len + n_new):
        before = launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        logits = decoder.step(fed[mine, t], t)
        _sync(device)
        secs = time.perf_counter() - t0
        counted = _launches_since(before)
        tok = gather_lanes(greedy(model, logits, groups), batch, groups)
        if vocab:
            logits = collectives.all_gather(logits, groups.model_group, -1)
        logits = gather_lanes(logits, batch, groups)
        want = torch.argmax(whole[t], dim=-1).int()
        out.append({"step": t, "tokens": {"whole": want.tolist(),
                                          "sharded": tok.tolist()},
                    "tokens_match": bool(torch.equal(tok, want)),
                    "whole_as_rank0": as_rank0,
                    "max_abs_diff": float((logits - whole[t]).abs().max()),
                    "max_abs_logit": float(whole[t].abs().max()),
                    "seconds": {"whole": seconds[t], "sharded": secs},
                    "launches": {"whole": launches[t], "sharded": counted}})
    return out


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before[k] for k, n in launch_counts().items()}


def _rank_main(rank, world, store_path, args) -> None:
    init_rank(rank, world, store_path, args.device, args.backend)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = make_host_mesh(args.model, device_type=args.device)
    if args.serve:
        for rec in serve_compare(cfg, mesh, prompt_len=args.prompt_len,
                                 n_new=args.n_new, batch=args.batch,
                                 kv_model=args.kv_model,
                                 shard_seq=args.shard_seq):
            if rank == 0:
                print(f"step {rec['step']} tokens match "
                      f"{rec['tokens_match']} max|diff| "
                      f"{rec['max_abs_diff']:.3e} of "
                      f"{rec['max_abs_logit']:.3e} seconds "
                      f"{rec['seconds']}", flush=True)
        return
    for rec in compare(cfg, mesh, steps=args.steps, seq=args.seq,
                       batch=args.batch, n_micro=args.n_micro, lr=args.lr,
                       fsdp=args.fsdp, seqpar=args.seqpar):
        if rank == 0:
            f, s = rec["fused"], rec["sharded"]
            print(f"step {rec['step']} loss {f['loss']:.6f} / "
                  f"{s['loss']:.6f} grad_norm {f['grad_norm']:.6f} / "
                  f"{s['grad_norm']:.6f} max|diff| {rec['max_abs_diff']}",
                  flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the 2-layer smoke variant")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--model", type=int, default=1,
                    help="the model axis' size; data gets world // model")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--seqpar", action="store_true",
                    help="the residual split by sequence over the model "
                         "axis too (sequence parallelism)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--serve", action="store_true",
                    help="tensor-parallel decode against the whole one")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--n-new", type=int, default=16)
    ap.add_argument("--kv-model", action="store_true",
                    help="--serve: the caches' slots over the model axis "
                         "where the KV heads do not divide it")
    ap.add_argument("--shard-seq", action="store_true",
                    help="--serve: the slots over the data axes (long "
                         "context): one lane, or a --batch the data axes "
                         "do not divide; else it raises")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.serve and args.shard_seq:
        _refuse_shard_seq(args)
    spawn(_rank_main, args.world, args)


def _refuse_shard_seq(args) -> None:
    """Raises ``ValueError`` before any rank starts where ``--shard-seq``
    would split the lanes and the slots over the same data axes
    (``sharding.rules.cache_shards`` on the CLI's layout)."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    layout = rules.Layout(("data", "model"),
                          (args.world // args.model, args.model))
    build_model(cfg, "meta").cache_shards(
        args.batch, args.prompt_len + args.n_new, mesh=layout,
        kv_model=args.kv_model, shard_seq=True)


if __name__ == "__main__":
    main()
