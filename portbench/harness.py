"""The benchmark's harness: reads a cell (``workloads/<cell>.json``), its
configuration (``configs/<config>.json``) and its loop (``loops/<loop>.py``),
builds the port's training job from the seed, warms it up through the
window's own step, runs the window for ``--seconds``, reads the metrics
that ``BENCHMARK.json`` lists for the cell (``metrics/<metric>.py``), holds
what the job produced against the plain reference (``check.py``) and
prints the result line.

Everything of one configuration, traffic mix, loop or metric is a file
found by its name, so a later change adds a cell or a metric by adding
files and entries.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WINDOW_SPAN = "portbench.traced"      # trace.WINDOW


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    the trace, the per-layer ones with it."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` of the configuration file: its registered
    architecture with every size the file states."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import SSMConfig
    arch = get_arch(cfg["arch"])
    fields = {f.name for f in dataclasses.fields(arch)}
    over = {k: v for k, v in cfg.items() if k in fields
            and k not in ("name", "source", "ssm", "attn")}
    if "ssm" in cfg:
        over["ssm"] = SSMConfig(**cfg["ssm"])
    if "attn" in cfg:
        over["attn"] = dataclasses.replace(arch.attn, **cfg["attn"])
    return dataclasses.replace(arch, **over)


class Job:
    """The port's training job of one cell: model, optimizer, state, data
    and the fused step, built once and driven by set-up and the window
    alike.  Records one dict per step."""

    def __init__(self, cell: dict, cfg: dict, seed: int, device):
        import torch
        from repro_torch.data.pipeline import SyntheticLM
        from repro_torch.models.model import build_model
        from repro_torch.optim import AdamW, constant
        from repro_torch.train.state import TrainState
        from repro_torch.train.step import make_grad_fn, make_train_step
        from portbench import weights

        self.torch = torch
        self.cell, self.cfg, self.seed = cell, cfg, seed
        self.arch = arch_config(cfg)
        self.model = build_model(self.arch, device)
        self.device = self.model.device
        hp = cell["optimizer"]
        self.opt = AdamW(lr=constant(hp["lr"]), b1=hp["b1"], b2=hp["b2"],
                         eps=hp["eps"], weight_decay=hp["weight_decay"],
                         grad_clip=hp["grad_clip"])
        params = weights.to_tree(weights.make(cfg, seed, self.device))
        self.state = TrainState(params, self.opt.init(params),
                                torch.zeros((), dtype=torch.int32))
        t = cell["traffic"]
        self.seq, self.n_micro = t["seq_len"], t["n_micro"]
        self.micro_batch = t["micro_batch"]
        self.batch = self.n_micro * self.micro_batch
        self.data = SyntheticLM(self.arch, seq_len=self.seq,
                                global_batch=self.batch, seed=seed,
                                device=str(self.device))
        self.fused = make_train_step(self.model, self.opt, self.n_micro)
        self.grad_fn = make_grad_fn(self.model)
        self.records: List[dict] = []
        self.opt_events: List = []
        self.cuda = self.device.type == "cuda"
        self.root_dir = ROOT

    # -- timing helpers -------------------------------------------------
    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated(self.device) \
            if self.cuda else 0

    def span(self, name: str):
        return self.torch.profiler.record_function(f"portbench.{name}")

    def tokens(self) -> int:
        return self.batch * self.seq

    # -- the window's step ----------------------------------------------
    def fused_step(self, step: int) -> dict:
        """One step as Unicron's trainer runs it: the batch from the data
        layer, the fused step, one synchronise on its loss."""
        from repro_torch.data.pipeline import stack_microbatches
        self.reset_peak()
        t0 = time.perf_counter()
        with self.span("data"):
            batch = stack_microbatches(self.data.batch(step), self.n_micro)
        t_data = time.perf_counter()
        with self.span("step"):
            self.state, metrics = self.fused(self.state, batch)
            loss = metrics["loss"].item()
        t1 = time.perf_counter()
        rec = {"step": step, "kind": "fused", "t0": t0, "t1": t1,
               "seconds": t1 - t0, "data_s": t_data - t0, "loss": loss,
               "tokens": self.tokens(), "peak_bytes": self.peak()}
        self.records.append(rec)
        return rec

    def time_optimizer(self) -> None:
        """CUDA events around every ``AdamW.update`` of this job's
        optimizer instance from now on (the traced run's)."""
        torch, update = self.torch, self.opt.update

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = update(*args, **kwargs)
            end.record()
            self.opt_events.append((start, end))
            return out
        object.__setattr__(self.opt, "update", timed)

    # -- readings of the state ------------------------------------------
    def leaf_norms(self, tree) -> Dict[str, float]:
        from portbench import weights
        flat = weights.flatten(tree)
        norms = self.torch.stack([t.float().norm() for t in flat.values()])
        return dict(zip(flat, norms.tolist()))

    def master(self):
        m = self.state.opt.master
        return self.state.params if m is None else m


def launch_counts() -> Dict[str, int]:
    """Calls so far of each kernel that a roofline metric reads."""
    from repro_torch.kernels import flash_attention_bwd, ssd_scan, ssd_scan_bwd
    return {"ssd_scan": ssd_scan.LAUNCHES.count,
            "ssd_scan_bwd": ssd_scan_bwd.LAUNCHES.count,
            "flash_attention_bwd": flash_attention_bwd.LAUNCHES.count}


def warm_up(job: Job, loop, ctx) -> dict:
    """The set-up steps, each through the loop's own call
    (``loop.setup_step``: the window's fused step or, in a managed cell,
    its recovered step) and feed on rows that all differ: the program's
    readings that the reference follows (each step's loss, the first
    gradient as the optimizer got it, its first moment after step 1
    itself, kept on the host in bfloat16, a recovered step's gradient
    norm, the change of the parameters after the last)."""
    import torch
    from portbench import weights
    n = job.cell["warmup_steps"]
    out = {"losses": []}
    for step in range(1, n + 1):
        rec = loop.setup_step(job, ctx, step)
        out["losses"].append(rec["loss"])
        if rec["kind"] == "recovered":
            out["recovered"] = {"step": step, "gnorm": rec["gnorm"]}
        if step == 1:
            b1 = job.cell["optimizer"]["b1"]
            out["g1"] = {k: v / (1 - b1) for k, v in
                         job.leaf_norms(job.state.opt.mu).items()}
            out["mu1"] = {k: v.to("cpu", torch.bfloat16) for k, v in
                          weights.flatten(job.state.opt.mu).items()}
    init = weights.make(job.cfg, job.seed, job.device)
    master = weights.flatten(job.master())
    out["change"] = job.leaf_norms(
        {k: master[k].float() - init[k].float() for k in master})
    del init
    job.records.clear()
    return out


class Tracer:
    """Starts the profiler before measured step ``first`` and stops it
    after ``first + count - 1`` (or where the window closes first); counts
    the kernels' launches in between."""

    def __init__(self, job: Job, first: int, count: int):
        self.job, self.first, self.last = job, first, first + count - 1
        self.prof, self.span, self.launches = None, None, {}
        self.running = False

    def before(self, measured: int) -> None:
        if measured == self.first:
            from torch.profiler import ProfilerActivity, profile
            self.job.sync()
            acts = [ProfilerActivity.CPU]
            if self.job.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.span = self.job.torch.profiler.record_function(WINDOW_SPAN)
            self.span.__enter__()
            self.launches = launch_counts()
            self.running = True

    def after(self, measured: int) -> None:
        if measured == self.last:
            self.stop()

    def stop(self) -> None:
        if not self.running:
            return
        self.running = False
        self.job.sync()
        self.span.__exit__(None, None, None)
        self.prof.stop()
        now = launch_counts()
        self.launches = {k: now[k] - self.launches[k] for k in now}

    def traced(self, measured: int) -> bool:
        return self.prof is not None and self.first <= measured <= self.last

    def summary(self):
        """The ``trace.Trace`` of the traced steps, or None where the
        window closed before the first of them."""
        from portbench import trace
        self.stop()
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return trace.load(path)
        finally:
            os.unlink(path)


def run_window(job: Job, loop, ctx, seconds: float,
               tracer: Optional[Tracer]) -> None:
    """Drive ``loop.iteration`` from measured step 1 until ``seconds`` have
    passed at the start of an iteration that begins a period of the loop
    (``loop.period``: the window holds whole periods, so a managed loop's
    window holds as many snapshots per step whatever its length)."""
    first = job.cell["warmup_steps"] + 1
    period = loop.period(job)
    start = time.perf_counter()
    measured = 0
    while measured % period or time.perf_counter() - start < seconds:
        measured += 1
        if tracer is not None:
            tracer.before(measured)
        loop.iteration(job, ctx, first + measured - 1, measured)
        if tracer is not None:
            tracer.after(measured)


def free_program(job: Job) -> None:
    torch = job.torch
    job.state = job.model = job.fused = job.grad_fn = None
    if job.cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, breakdown: Optional[dict],
                checks: dict) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def device_info(job: Job, chips: int, peak: int) -> dict:
    torch = job.torch
    if job.cuda:
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": 0}


def main(argv=None, *, t_start: Optional[float] = None,
         require_cuda: bool = True, device: str = "cuda",
         cell_override: Optional[dict] = None,
         cfg_override: Optional[dict] = None, out=None) -> int:
    """One run of a cell.  ``require_cuda=False`` and the overrides are for
    the CPU tests, which drive the whole run at a tiny size."""
    t_start = time.time() if t_start is None else t_start
    out = out or sys.stdout
    args = parse(argv)
    cell = cell_override or load_json("workloads", args.workload)
    cfg = cfg_override or load_json("configs", cell["config"])
    import torch
    if require_cuda:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            print(f"portbench: {cell['chips']} CUDA device(s) needed, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    from portbench import check
    seed = args.seed % (1 << 63)
    bench = benchmark() if cell_override is None else None
    loop = load_module("loops", cell["loop"])

    job = Job(cell, cfg, seed, device)
    ctx = loop.start(job)
    readings = warm_up(job, loop, ctx)
    job.sync()
    setup_peak = job.peak()
    setup_s = time.time() - t_start

    tracer = None
    if args.trace:
        t = cell["trace_steps"]
        tracer = Tracer(job, t[0], t[1])
        if job.cuda:
            job.time_optimizer()
    run_window(job, loop, ctx, args.seconds, tracer)
    job.sync()
    peak = max([setup_peak] + [r["peak_bytes"] for r in job.records])
    trace = tracer.summary() if tracer is not None else None
    run = SimpleNamespace(
        cell=cell, cfg=cfg, records=list(job.records), setup_s=setup_s,
        trace=trace, launches=tracer.launches if tracer else {},
        traced=[r for i, r in enumerate(job.records, 1)
                if tracer and tracer.traced(i)],
        opt_ms=[s.elapsed_time(e) for s, e in job.opt_events],
        loop=ctx, peaks=json.loads((HERE / "peaks.json").read_text()))
    if cell_override is not None:
        listed = cell_override.get("metrics", [])
    else:
        listed = [m["name"] for m in cell_metrics(bench, args.workload,
                                                  bool(args.trace))]
    metrics = {}
    units = {m["name"]: m["unit"] for m in (bench["end_to_end"]
                                            + bench["per_layer"])} \
        if bench else {}
    for name in listed:
        value = load_module("metrics", name).read(run)
        if value is not None:
            metrics[name] = {"value": value,
                             "unit": units.get(name, "")}
    info = device_info(job, cell["chips"], peak)
    breakdown = None
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
        breakdown = {"device_ops": trace.top_ops(),
                     "idle_gaps": trace.top_gaps()}

    program = loop.readings(job, ctx, readings)
    free_program(job)
    ref = check.reference(cell, cfg, seed, job.device, program)
    checks = check.compare(cell, program, ref)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package loaded: "
              f"{found}", file=sys.stderr)
        return 3
    steps = len(run.records)
    print(f"portbench: setup_s {setup_s!r}, window {steps} steps",
          file=sys.stderr)
    # each window step's seconds (and a save's), for the spread's causes
    print("portbench: steps " + " ".join(
        f"{r['kind'][0]}{r['seconds']:.3f}"
        + (f"+s{r['save_s']:.3f}" if "save_s" in r else "")
        for r in run.records), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(result_line(correct, steps, 0, metrics, info, breakdown, checks),
          file=out, flush=True)
    return 0
