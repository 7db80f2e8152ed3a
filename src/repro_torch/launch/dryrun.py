"""Multi-pod dry-run (port of ``repro/launch/dryrun.py``).

Traces one step of one (architecture x input shape x mesh) as rank 0 of a
fake process group of the layout's world, on the ``meta`` device: nothing
is allocated and no rank but this one exists.  ``launch.counters.
WorkCounter`` counts the step's FLOPs, HBM bytes, peak live bytes and the
result bytes of its collectives by kind and mesh axis, with the kernels'
work counted once by formula (``kernels/work.py``).  The reference reads
these from XLA's partitioned HLO (``hlo_analysis.py``); here they come from
torch's own dispatch, so ``hlo_analysis.py`` and ``hlo_stats.py`` have no
port.

* **train** pairs run ``make_sharded_train_step(..., fsdp=..., remat=True)``
  on ``shard_train_state(abstract_train_state(...))`` over ``input_specs``;
* **prefill** pairs ``forward(..., groups=..., last_logits_only=True)`` on
  the rank's compute shards (``train.sharded.compute_params``) and the
  argmax over the rank's data rows;
* **decode** pairs ``make_serve_step(model, groups, shards)``: ``decode_step``
  on the rank's compute shards and its ``init_cache(..., mesh=)`` shards of
  its lanes (``sharding.rules.cache_shards``: KV heads over ``model`` where
  they divide it, else with "cachemodel" the slots; for long_500k, one
  lane, the slots over the data axes, as the reference's ``shard_seq``),
  and the greedy token over the vocabulary.

Every pair is tensor-parallel over the model axis as the sharded step is
(``train/sharded.py``): attention (in uneven blocks of heads where the
axis does not divide them, ``sharding.rules.head_block``), MLA and Mamba2
split by heads, MLPs and shared experts by d_ff, the embedding, head and
cross-entropy by the vocabulary, the routed experts by blocks where they
divide the axis and else by d_ff; a decode step whose cache slots are
split runs its attention as flash-decoding over them.  A row says
``"tp_compute": true`` where every attention, MLP, Mamba2 and MoE leaf of
the pair's parameters has a split use (``train.sharded.compute_uses``,
which the step and the prefill hand the forward its shards by) or the
fallback its rule names
(``PARTIAL``: KV heads held whole, every leaf of an attention whose
heads the axis does not divide (at 16x16, granite-moe's 24 and gpt3-13b's
40 in uneven blocks), MLA's down-projections and their norms, Mamba2's
concatenated input projection and conv); a vocabulary that does not
divide is the embedding's and head's fallback.  Else ``"tp_whole"`` lists
the modules a rank computes whole (``whole_compute``): attention with
fewer heads than ranks that do not divide the axis, MLA or Mamba2 whose
heads do not divide it, an MLP or shared expert whose d_ff does not, and
experts that divide neither way; no registered config at 16x16 has one.
A pair whose peak exceeds ``HBM_BYTES`` is flagged ``"fits": false``, not
skipped.  With the "seqpar" variant the train and prefill pairs are also
sequence-parallel over the model axis (the residual split by sequence
between the split regions, ``collectives.MeshGroups(..., seqpar=True)``),
padded as GSPMD pads a sequence the axis does not divide; decode pairs
run as without it, as the reference's decode does; each traced row says
``"seqpar"``, whether its step ran so, and a seqpar row ``"seq_block"``,
each rank's rows (``sharding.rules.seq_block``), and ``"seq_pad"``, the
pad rows of the last ranks.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k [--multi-pod | --mesh DxM] \\
        [--variant fsdp|cachemodel|seqpar] [--json out.jsonl]

``check_pair`` holds the prediction against the same step run for real on
the card (or, for the tests, the CPU): at world size 1, or as rank 0 of a
fake group of the layout's world (counts and peak; a fake group moves no
data, so values are not compared).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_arch, supports_shape
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.launch.counters import WorkCounter
from repro_torch.launch.inputs import (batch_struct, decode_specs,
                                      input_specs, n_micro_for)
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, IB_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16, _mesh,
                                     production_layout)
from repro_torch.sharding.rules import (WHOLE, Layout, data_axes_of,
                                        seq_block)

# variant tokens of the reference that are the port's only path: recorded
NATIVE = ("baseline", "", "flash", "fusednorm", "moe3d", "moesm")


@dataclasses.dataclass(frozen=True)
class Variant:
    cfg: ArchConfig
    fsdp: bool = False
    kv_model: bool = False          # decode caches' slots over ``model``
    seqpar: bool = False            # train and prefill split by sequence


def apply_variant(cfg: ArchConfig, variant: str) -> Variant:
    """The reference's perf variants (``dryrun.py:43``), tokens joined by
    '+'.  "baseline", "flash", "fusednorm", "moe3d" and "moesm" are the
    port's only paths and change nothing; "fsdp" shards the parameters
    over the data axes too (train pairs); "cachemodel" splits the decode
    caches' slots over the model axis where their KV heads do not divide
    it (decode pairs, ``cache_specs(kv_model=True)``); "ep48" pads
    granite-moe's 40 experts to 48 with the capacity factor scaled to keep
    the FLOPs (and, as in the reference, is unknown for an arch without
    MoE); "seqpar" splits the residual of the train and prefill steps by
    sequence over the model axis (sequence parallelism).  Any other token
    raises."""
    fsdp, kv_model, seqpar = False, False, False
    for tok in variant.split("+"):
        if tok in NATIVE:
            continue
        if tok == "fsdp":
            fsdp = True
        elif tok == "cachemodel":
            kv_model = True
        elif tok == "seqpar":
            seqpar = True
        elif tok == "ep48" and cfg.moe is not None:
            m = cfg.moe
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                m, n_experts=48,
                capacity_factor=m.capacity_factor * m.n_experts / 48))
        else:
            raise ValueError(f"unknown variant token {tok!r}")
    return Variant(cfg, fsdp, kv_model, seqpar)


def mesh_layout(multi_pod: bool = False, mesh: str = None
                ) -> Tuple[str, Layout]:
    """The layout's name and axes: ``16x16`` (one pod), ``2x16x16`` (two
    pods, ``multi_pod``) or ``mesh`` = "DxM", ``(D, M)`` named ``("data",
    "model")``."""
    if mesh is None:
        lay = production_layout(multi_pod=multi_pod)
        return "x".join(map(str, lay.sizes)), lay
    sizes = tuple(int(n) for n in mesh.split("x"))
    if len(sizes) != 2 or min(sizes) < 1:
        raise ValueError(f"--mesh takes DxM, got {mesh!r}")
    return mesh, Layout(("data", "model"), sizes)


def world_of(layout: Layout) -> int:
    n = 1
    for s in layout.sizes:
        n *= s
    return n


@contextlib.contextmanager
def process_group(backend: str, world: int = 1):
    """A process group of ``world`` ranks as rank 0 for the ``with`` block,
    destroyed after it: ``"fake"`` (no rank but this one exists, every
    collective returns at once), or ``"gloo"`` / ``"nccl"`` at world size
    1.  Raises if a group is already initialised."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    else:
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# one pair's step and inputs
# ---------------------------------------------------------------------------


def _random_like(t: torch.Tensor, gen, vocab: int, device) -> torch.Tensor:
    if t.dtype in (torch.int32, torch.int64):
        return torch.randint(0, vocab, t.shape, generator=gen,
                             dtype=t.dtype, device=device)
    return torch.randn(t.shape, generator=gen, dtype=t.dtype, device=device)


def _real_batch(cfg, specs, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return {k: torch.ones(v.shape, dtype=v.dtype, device=device)
            if k == "loss_mask" else _random_like(v, gen, cfg.vocab, device)
            for k, v in specs.items()}


def _random_shards(state, device, seed):
    """``state`` (a ``shard_train_state`` of ``meta`` leaves) with each
    DTensor's local shard made on ``device``: the parameters and the f32
    master copies random (0.02 normal), the moments and the step counter
    zero.  Its values mean nothing; its shapes, placements and bytes are
    this rank's."""
    from torch.distributed.tensor import DTensor
    from repro_torch import tree
    gen = torch.Generator(device=device).manual_seed(seed)

    def fill(zero):
        def one(t):
            local = t.to_local() if isinstance(t, DTensor) else t
            new = torch.zeros(local.shape, dtype=local.dtype, device=device)
            if not zero:
                new.normal_(0.0, 0.02, generator=gen)
            if not isinstance(t, DTensor):
                return new
            return DTensor.from_local(new, t.device_mesh, t.placements,
                                      run_check=False, shape=t.shape,
                                      stride=t.stride())
        return one
    opt = state.opt
    master = None if opt.master is None \
        else tree.tree_map(fill(False), opt.master)
    return type(state)(
        tree.tree_map(fill(False), state.params),
        type(opt)(fill(True)(opt.step), tree.tree_map(fill(True), opt.mu),
                  tree.tree_map(fill(True), opt.nu), master),
        fill(True)(state.step))


def _random_leaves(tree_, device, seed):
    """``tree_`` of ``meta`` tensors with each leaf made on ``device``,
    0.02 normal from ``seed``: its values mean nothing, its shapes and
    bytes are this rank's."""
    from repro_torch import tree
    gen = torch.Generator(device=device).manual_seed(seed)
    return tree.tree_map(lambda t: torch.empty(
        t.shape, dtype=t.dtype, device=device).normal_(0.0, 0.02,
                                                       generator=gen),
        tree_)


def _rows(batch: int, dp: int) -> int:
    """The rank's rows of a batch: a 1/dp share where the batch divides
    over the data axes (as ``batch_specs`` shards it), else all of
    them."""
    return batch // dp if batch % dp == 0 and batch > 1 else batch


# the modules whose matmuls the model axis splits where the rules let it;
# the MoE router is computed whole on every rank (the reference's too)
_TP_MODULES = {"attn", "mlp", "mamba", "moe"}


def whole_compute(uses, kind: str, tp: int) -> list:
    """What a rank of a ``tp``-wide model axis computes whole, alike on
    every model rank, in a ``kind`` step (train, prefill or decode, which
    split alike): sorted, the modules of
    attention, MLP, Mamba2 and MoE leaves whose ``uses``
    (``train.sharded.compute_uses`` of the step's parameters) are
    ``WHOLE``; empty where the step is tensor-parallel.  The rules' own
    fallbacks are not listed: the ``PARTIAL`` leaves (KV heads held whole,
    each rank reading its query heads' KV heads; a split MLA's
    down-projections and their norms, computed alike on every rank as in
    Megatron's MLA; a split Mamba2's input projection and conv, each rank
    reading its heads' columns) and a vocabulary that does not divide the
    axis."""
    if tp == 1:
        return ["a model axis of 1"]
    return sorted({"/".join(names[:-1]) for names, use, _ in uses
                   if use == WHOLE and names[-1] != "router"
                   and _TP_MODULES.intersection(names[:-1])})


def build_pair(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
               fsdp: bool = False, n_micro: int = None, kv_model: bool = False,
               seqpar: bool = False, device="meta",
               seed: int = 0) -> Tuple[Callable, tuple, dict]:
    """``(step, args, meta)``: rank 0's step of ``(cfg, shape)`` over
    ``mesh`` (a ``DeviceMesh`` whose last axis is ``model``) and its
    arguments, on ``device``: the ``meta`` device's stand-ins, or random
    inputs of the same shapes from ``seed`` on a real device.  A decode
    pair's caches are split as ``cache_shards`` splits them, with
    ``kv_model`` and, for long_500k, ``shard_seq``.  ``seqpar``: a train
    or prefill step is sequence-parallel over the model axis (a decode
    step ignores it); ``meta["seqpar"]`` says whether the step is."""
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamW, constant
    from repro_torch.train.sharded import (make_sharded_train_step,
                                           shard_train_state)
    from repro_torch.train.state import abstract_train_state

    from repro_torch.serve.decode import make_serve_step
    from repro_torch.sharding.collectives import MeshGroups
    from repro_torch.train.sharded import compute_params, compute_uses

    device = torch.device(device)
    real = device.type != "meta"
    _, dp = data_axes_of(mesh)
    tp = int(mesh.mesh.shape[-1])
    model = build_model(cfg, device)
    seqpar = seqpar and shape.kind != "decode" and tp > 1
    meta = {"kind": shape.kind, "dp": dp, "tp": tp, "seqpar": seqpar}
    if seqpar:
        # each model rank's rows of the residual, and the pad rows of the
        # last ranks where tp does not divide the sequence
        S = shape.seq_len + (cfg.n_prefix_embeds
                             if cfg.modality == "vision_stub" else 0)
        meta["seq_block"] = seq_block(S, tp)
        meta["seq_pad"] = tp * meta["seq_block"] - S
    if shape.kind == "train":
        opt = AdamW(lr=constant(3e-4))
        # only this rank's shards are made, never the whole state: a whole
        # state of deepseek-v3-671b's MoE layer would not fit on one card
        state = abstract_train_state(model, opt)
        meta["tp_whole"] = whole_compute(
            compute_uses(state.params, cfg, tp, seqpar), shape.kind, tp)
        state = shard_train_state(state, mesh, fsdp=fsdp)
        if real:
            state = _random_shards(state, device, seed)
        n = n_micro or n_micro_for(shape, dp)
        specs = batch_struct(cfg, shape.global_batch // n, shape.seq_len,
                             stacked_micro=n)
        batch = _real_batch(cfg, specs, device, seed) if real else specs
        meta["n_micro"] = n
        step = make_sharded_train_step(model, opt, n, mesh, fsdp=fsdp,
                                       remat=True, seqpar=seqpar)
        return step, (state, batch), meta
    # a decode pair over more than one rank makes only this rank's shards
    # (``_random_leaves``): a whole deepseek-v3-671b MoE layer is 22.5 GB
    shards_only = real and shape.kind == "decode" and dp * tp > 1
    params = build_model(cfg, "meta").init(seed) if shards_only \
        else model.init(seed)
    meta["tp_whole"] = whole_compute(compute_uses(params, cfg, tp),
                                     shape.kind, tp)
    if shape.kind == "prefill":
        specs = input_specs(cfg, dataclasses.replace(
            shape, global_batch=_rows(shape.global_batch, dp)), dp)
        batch = _real_batch(cfg, specs, device, seed) if real else specs
        groups = MeshGroups(mesh, seqpar=seqpar) if tp > 1 else None
        if groups is not None:
            params = compute_params(params, cfg, groups)

        @torch.no_grad()
        def prefill_step(params, batch):
            logits, _ = model.forward(params, batch, groups=groups,
                                      last_logits_only=True)
            return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return prefill_step, (params, batch), meta
    lanes = _rows(shape.global_batch, dp)
    local = dataclasses.replace(shape, global_batch=lanes)
    caches, tokens, pos = decode_specs(model, cfg, local)
    groups = shards = None
    if dp * tp > 1:
        # the reference's long-context mode: one lane, slots over data
        kw = dict(mesh=mesh, kv_model=kv_model,
                  shard_seq=shape.name == "long_500k")
        groups = MeshGroups(mesh)
        params = compute_params(params, cfg, groups)
        if shards_only:
            params = _random_leaves(params, device, seed)
        shards = model.cache_shards(shape.global_batch, shape.seq_len, **kw)
        caches = model.init_cache(shape.global_batch, shape.seq_len, **kw)
    elif real:
        caches = model.init_cache(lanes, shape.seq_len)
    if real:
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        tokens = _random_like(tokens, gen, cfg.vocab, device)
        pos = torch.tensor(shape.seq_len // 2, dtype=torch.int32,
                           device=device)
    serve = make_serve_step(model, groups, shards)

    def serve_step(params, caches, tokens, pos):
        return serve(params, caches, tokens, pos)[0]
    return serve_step, (params, caches, tokens, pos), meta


def count_step(step: Callable, args: tuple, mesh) -> Tuple[WorkCounter,
                                                             dict]:
    """Runs ``step(*args)`` once under a ``WorkCounter`` with ``args`` as
    the step's arguments; returns the counter and the memory dict."""
    counter = WorkCounter(mesh)
    counter.arguments(*args)
    with counter:
        out = step(*args)
    # a train step returns the new state: the stored parameters are new
    out_bytes = counter.new_bytes(out)
    memory = {"argument_size_in_bytes": counter.argument_bytes,
              "output_size_in_bytes": out_bytes,
              "temp_size_in_bytes": max(0, counter.peak
                                        - counter.argument_bytes
                                        - out_bytes),
              "peak_bytes": counter.peak}
    return counter, memory


def roofline_terms(flops: float, hbm_bytes: float,
                   link_bytes: Dict[str, float]) -> dict:
    """Three roofline terms in seconds for one rank of H100 SXM GPUs
    (``launch/mesh.py``'s published figures): its FLOPs at the bf16 peak,
    its HBM bytes at the HBM rate, and its collectives' result bytes at
    ``NVLINK_BW`` where a collective's group lies within one block of 8
    consecutive ranks (one node) and at ``IB_BW`` otherwise."""
    return {"compute_s": flops / PEAK_FLOPS_BF16,
            "memory_s": hbm_bytes / HBM_BW,
            "collective_s": link_bytes["nvlink"] / NVLINK_BW
            + link_bytes["ib"] / IB_BW}


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6 N_active D for one step's tokens; 2 N D for inference (the
    reference's MODEL_FLOPS)."""
    n = shape.global_batch * shape.seq_len if shape.kind != "decode" \
        else shape.global_batch
    mf = 6.0 * cfg.active_param_count() * n
    return mf / 3.0 if shape.kind != "train" else mf


def _measured(counter: WorkCounter, memory: dict, trace_s: float) -> dict:
    """The row's fields that the trace measures."""
    return {
        "status": "ok",
        "trace_s": round(trace_s, 2),
        "flops": counter.flops,
        "hbm_bytes": counter.hbm_bytes,
        "collective_bytes": counter.collective_bytes,
        "collectives": counter.collectives,
        "bytes_by_op": dict(sorted(counter.bytes_by_op.items(),
                                   key=lambda kv: -kv[1])),
        "flops_by_op": dict(sorted(counter.flops_by_op.items(),
                                   key=lambda kv: -kv[1])),
        "kernel_calls": dict(counter.kernel_calls),
        "memory": memory,
        "fits": memory["peak_bytes"] <= HBM_BYTES,
        "roofline": roofline_terms(counter.flops, counter.hbm_bytes,
                                   counter.link_bytes),
    }


def trace_pair(cfg: ArchConfig, shape: ShapeConfig, layout: Layout, *,
               fsdp: bool = False, n_micro: int = None,
               kv_model: bool = False, seqpar: bool = False) -> dict:
    """Rank 0's step of ``(cfg, shape)`` on ``layout`` traced on ``meta``
    inside an initialised process group of the layout's world: the row's
    measured fields, with ``kind``, ``dp``, ``tp``, ``seqpar`` (and
    ``n_micro``)."""
    t0 = time.perf_counter()
    mesh = _mesh(layout)
    step, args, meta = build_pair(cfg, shape, mesh, fsdp=fsdp,
                                  n_micro=n_micro, kv_model=kv_model,
                                  seqpar=seqpar, device="meta")
    counter, memory = count_step(step, args, mesh)
    return {**meta, **_measured(counter, memory, time.perf_counter() - t0),
            "tp_compute": not meta["tp_whole"]}


def pair_fields(arch: str, shape_name: str, *, multi_pod: bool = False,
                mesh: str = None, variant: str = "baseline") -> dict:
    """The row's fields that need no trace: the reference's skip row for
    a pair ``supports_shape`` refuses; else the pair, its layout's ``dp``
    and ``tp`` (and ``n_micro``), the parameter counts and
    ``model_flops``."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    mesh_name, layout = mesh_layout(multi_pod, mesh)
    ok, reason = supports_shape(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skip", "reason": reason}
    var = apply_variant(cfg, variant)
    _, dp = data_axes_of(layout)
    tp = layout.size("model")
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "dp": dp, "tp": tp, "variant": variant}
    if shape.kind == "train":
        row["n_micro"] = n_micro_for(shape, dp)
    row.update(param_count=var.cfg.param_count(),
               active_param_count=var.cfg.active_param_count(),
               model_flops=model_flops(var.cfg, shape))
    return row


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh: str = None, variant: str = "baseline",
             verbose: bool = True) -> dict:
    """One row: ``pair_fields`` and, for a pair that runs, its step traced
    as rank 0 of a fake process group of the layout's world."""
    row = pair_fields(arch, shape_name, multi_pod=multi_pod, mesh=mesh,
                      variant=variant)
    if "status" in row:
        return row
    var = apply_variant(get_arch(arch), variant)
    _, layout = mesh_layout(multi_pod, mesh)
    world = world_of(layout)
    with process_group("fake", world):
        row.update(trace_pair(var.cfg, SHAPES[shape_name], layout,
                              fsdp=var.fsdp and row["kind"] == "train",
                              kv_model=var.kv_model
                              and row["kind"] == "decode",
                              seqpar=var.seqpar))
    total = row["flops"] * world
    row["model_flops_ratio"] = row["model_flops"] / total if total else 0.0
    if verbose:
        print(json.dumps(row, indent=2), flush=True)
    return row


# ---------------------------------------------------------------------------
# the prediction against a real step
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_pair(cfg: ArchConfig, shape: ShapeConfig, *, device="cuda",
               n_micro: int = None, seed: int = 0,
               layout: Layout = None, kv_model: bool = False,
               seqpar: bool = False) -> dict:
    """The dry-run's prediction for ``(cfg, shape)`` on ``layout`` (default
    the (1, 1) mesh, world size 1), beside the same step run for real on
    ``device`` (CUDA by default; raises without it).  The trace runs on
    ``meta`` in a fake group; the real step, from random inputs of the
    same shapes, in an NCCL group (gloo on the CPU) at world size 1, else
    as rank 0 of a fake group of the layout's world, whose collectives
    move no data (its values mean nothing; its counts, launches, peak and
    time are rank 0's): once to warm up, once under the same counter, once
    timed with nothing around it.  Returns both sides'
    FLOPs, HBM bytes, collectives and kernel calls (to be equal), the
    kernels' launches in the counted run (to equal the calls), the
    predicted peak above the arguments beside ``max_memory_allocated``
    above the bytes allocated before the timed step (CUDA), and the timed
    step beside ``max(compute_s, memory_s)``, and the modules computed
    whole (``tp_whole``); ``seqpar`` makes both sides sequence-parallel
    (``build_pair``)."""
    from repro_torch.launch.train import launch_counts
    device = resolve_device(device)
    layout = layout or Layout(("data", "model"), (1, 1))
    world = world_of(layout)
    with process_group("fake", world):
        pred = trace_pair(cfg, shape, layout, n_micro=n_micro,
                          kv_model=kv_model, seqpar=seqpar)
    backend = "fake" if world > 1 \
        else "nccl" if device.type == "cuda" else "gloo"
    with process_group(backend, world):
        mesh = _mesh(layout, device.type)
        step, args, _ = build_pair(cfg, shape, mesh, n_micro=n_micro,
                                   kv_model=kv_model, seqpar=seqpar,
                                   device=device, seed=seed)
        step(*args)                                      # warm-up
        _sync(device)
        before = launch_counts()
        counter, _ = count_step(step, args, mesh)
        _sync(device)
        launches = {k: n - before[k] for k, n in launch_counts().items()
                    if n - before[k]}
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        step(*args)
        _sync(device)
        secs = time.perf_counter() - t0
        peak_above = torch.cuda.max_memory_allocated(device) - base \
            if device.type == "cuda" else None
        del step, args
    predicted_above = pred["memory"]["peak_bytes"] \
        - pred["memory"]["argument_size_in_bytes"]
    bound_s = max(pred["roofline"]["compute_s"], pred["roofline"]["memory_s"])
    out = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "layout": dict(zip(layout.axis_names, layout.sizes)),
        "n_micro": pred.get("n_micro"), "tp_compute": pred["tp_compute"],
        "tp_whole": pred["tp_whole"], "seqpar": pred["seqpar"],
        "seq_block": pred.get("seq_block"), "seq_pad": pred.get("seq_pad"),
        "predicted": {k: pred[k] for k in ("flops", "hbm_bytes",
                                           "collective_bytes", "collectives",
                                           "kernel_calls")},
        "measured": {"flops": counter.flops, "hbm_bytes": counter.hbm_bytes,
                     "collective_bytes": counter.collective_bytes,
                     "collectives": counter.collectives,
                     "kernel_calls": dict(counter.kernel_calls)},
        "launches": launches,
        "peak_above_arguments": {"predicted": predicted_above,
                                 "measured": peak_above},
        "step_s": secs, "roofline_s": bound_s,
        "roofline": pred["roofline"], "trace_s": pred["trace_s"],
    }
    # the plain versions on the CPU launch nothing
    out["equal"] = out["predicted"] == out["measured"] and (
        device.type != "cuda" or launches == out["predicted"]["kernel_calls"])
    if peak_above:
        out["peak_gap"] = (predicted_above - peak_above) / peak_above
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="DxM: a (data, model) layout of D*M ranks in "
                         "place of the production one")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--json", default=None, help="append result to file")
    args = ap.parse_args()

    res = run_pair(args.arch, args.shape, multi_pod=args.multi_pod,
                   mesh=args.mesh, variant=args.variant)
    if res.get("status") != "ok":
        print(json.dumps(res, indent=2), flush=True)
    if args.json:
        with open(args.json, "a") as f:
            f.write(json.dumps(res) + "\n")
    sys.exit(0 if res.get("status") in ("ok", "skip") else 1)


if __name__ == "__main__":
    main()
