"""Unicron's replanning on failures, through the port's planner kernels.

    python -m repro_torch.launch.plan [--device cpu] [--steps 12]

Two workloads, each run for the ``batched`` and ``fused`` plan engines:

* **fig11** — the paper's Fig. 11 deployment (the port of
  ``examples/multitask_cluster.py``'s coordinator section): six GPT-3
  tasks on 128 A800 GPUs; the coordinator replans the whole cluster on
  each of the first SEV1 events of trace-b (one 8-GPU node lost each).
* **churn** — the planner at fleet scale (``bench_planner_scale``'s
  churn walk): 1024 workers, 64 GPT-3 tasks capped at their fair share.
  Each step rebuilds the whole scenario table of the current state
  through a shared ``PlannerCache``, dispatches one ``fault`` and one
  ``finish`` plan, and shifts three assignments (seeded draws within
  the caps, so the schedule signature never changes).

``replan`` returns per-step records: the plans, every scenario total,
rebuild seconds, launches of each max-plus kernel, device dispatches and,
on the fused engine, how its program ran (eager, capture or replay of its
CUDA graph).
"""
from __future__ import annotations

import argparse
import json
import random
import statistics
import time
from typing import Dict, List

import torch

from repro_torch.configs import get_arch
from repro_torch.core.coordinator import UnicronCoordinator
from repro_torch.core.costmodel import A800, TaskModel
from repro_torch.core.planner import PlannerCache
from repro_torch.core.traces import trace_b
from repro_torch.core.waf import Task
from repro_torch.device import resolve_device
from repro_torch.kernels import maxplus

ENGINES = ("batched", "fused")

# examples/multitask_cluster.py:25-29 (Table 3 Case #5)
FIG11_SIZES = ["gpt3-1.3b"] * 3 + ["gpt3-7b"] * 2 + ["gpt3-13b"]
FIG11_WEIGHTS = [2.0, 1.7, 1.4, 1.1, 0.8, 0.5]
FIG11_ASSIGNMENT = [16, 16, 16, 24, 24, 32]
FIG11_WORKERS = 128
FIG11_EVENTS = 3                      # SEV1 events replayed
WORKERS_PER_NODE = 8

# benchmarks/common.py fleet_tasks: the fleet every cluster bench shares
FLEET_SIZES = ["gpt3-1.3b", "gpt3-7b", "gpt3-13b", "gpt3-70b"]
CHURN_DRAWS = (4, 8, 12, 16)          # within the fair-share cap n // m
D_RUNNING, D_TRANSITION = 3600.0, 120.0


def fig11_tasks() -> List[Task]:
    return [Task(model=TaskModel.from_arch(get_arch(s), global_batch=128),
                 weight=w) for s, w in zip(FIG11_SIZES, FIG11_WEIGHTS)]


def fleet_tasks(m: int, max_workers=None) -> List[Task]:
    """m heterogeneous tasks cycling the GPT-3 family with varied weights
    and batch sizes, each capped at ``max_workers``."""
    return [Task(model=TaskModel.from_arch(
                     get_arch(FLEET_SIZES[i % len(FLEET_SIZES)]),
                     global_batch=128 if i % 2 else 256),
                 weight=0.5 + 0.1 * (i % 16),
                 max_workers=max_workers) for i in range(m)]


def launch_counts() -> Dict[str, int]:
    """Launches of each max-plus kernel so far."""
    return {name: c.count for name, c in maxplus.LAUNCHES.items()}


def launch_delta(before: Dict[str, int]) -> Dict[str, int]:
    """Launches of each max-plus kernel since ``before``."""
    return {name: c - before[name] for name, c in launch_counts().items()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fig11(device, engine: str) -> List[dict]:
    """The coordinator's decisions on the first SEV1 events of trace-b:
    each loses one node and replans every task."""
    device = resolve_device(device)
    tasks = fig11_tasks()
    coord = UnicronCoordinator(tasks, FIG11_ASSIGNMENT, A800,
                               plan_engine=engine, device=device)
    sev1 = [e for e in trace_b() if e.repair_s is not None][:FIG11_EVENTS]
    n = FIG11_WORKERS
    records = []
    for e in sev1:
        n -= WORKERS_PER_NODE
        before = launch_counts()
        dispatches = coord.plan_stats.device_dispatches
        faulted = e.node % len(tasks)
        plan = coord.reconfigure(n, faulted_task=faulted)
        sync(device)
        records.append({
            "time_h": e.time / 3600, "kind": e.kind.value,
            "faulted_task": faulted, "n_workers": n,
            "assignment": list(plan.assignment),
            "total_reward": plan.total_reward, "waf": plan.waf,
            "rebuild_s": coord.plan_stats.last_rebuild_s,
            "launches": launch_delta(before),
            "device_dispatches": (coord.plan_stats.device_dispatches
                                  - dispatches)})
    return records


def churn(device, engine: str, *, n: int = 1024, m: int = 64,
          steps: int = 12, dtype: torch.dtype = torch.float64) -> List[dict]:
    """The fleet-scale churn walk; its fixed seed gives identical states
    and lookup keys on every engine and device."""
    device = resolve_device(device)
    tasks = fleet_tasks(m, max_workers=n // m)
    cache = PlannerCache()
    assignment = [n // m] * m
    rng = random.Random(0)
    records = []
    for step in range(steps):
        state = list(assignment)
        table = cache.table(tasks, assignment, A800, D_RUNNING,
                            D_TRANSITION, n_budget=n + WORKERS_PER_NODE,
                            engine=engine, device=device, dtype=dtype)
        before = launch_counts()
        dispatches = table.batch_stats["device_dispatches"]
        t0 = time.perf_counter()
        totals = table.rebuild_values()
        sync(device)
        rebuild_s = time.perf_counter() - t0
        launches = launch_delta(before)
        rec = {"step": step, "assignment": state, "totals": totals,
               "rebuild_s": rebuild_s, "launches": launches,
               "device_dispatches": (table.batch_stats["device_dispatches"]
                                     - dispatches),
               "fused_run": table.fused_run, "lookups": {}}
        for key in (f"fault:{rng.randrange(m)}",
                    f"finish:{rng.randrange(m)}"):
            plan = table.lookup(key)
            rec["lookups"][key] = {"assignment": list(plan.assignment),
                                   "total_reward": plan.total_reward,
                                   "waf": plan.waf}
        records.append(rec)
        for _ in range(3):
            assignment[rng.randrange(m)] = rng.choice(CHURN_DRAWS)
    return records


def replan(device="cuda", *, churn_steps: int = 12, n: int = 1024,
           m: int = 64) -> dict:
    """Both workloads on both engines, in float64:
    ``{"fig11": {engine: records}, "churn": {engine: records}}``."""
    return {"fig11": {e: fig11(device, e) for e in ENGINES},
            "churn": {e: churn(device, e, n=n, m=m, steps=churn_steps)
                      for e in ENGINES}}


def summary(result: dict) -> dict:
    """Per engine: the Fig. 11 plans, and the churn walk's median rebuild
    seconds, kernel launches per rebuild and device dispatches."""
    out = {}
    for engine, recs in result["churn"].items():
        out[engine] = {
            "fig11_plans": [r["assignment"] for r in
                            result["fig11"][engine]],
            "churn_steps": len(recs),
            "rebuild_s_median": statistics.median(r["rebuild_s"]
                                                  for r in recs),
            "launches_per_rebuild": [r["launches"] for r in recs],
            "device_dispatches": [r["device_dispatches"] for r in recs]}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--workers", type=int, default=1024)
    ap.add_argument("--tasks", type=int, default=64)
    args = ap.parse_args()
    result = replan(args.device, churn_steps=args.steps, n=args.workers,
                    m=args.tasks)
    for engine, recs in result["fig11"].items():
        for r in recs:
            print(f"[{engine}] t={r['time_h']:7.1f}h {r['kind']:18s} -> "
                  f"plan {tuple(r['assignment'])} (cluster WAF "
                  f"{r['waf'] / 1e12:.0f} TFLOP/s)")
    print(json.dumps(summary(result)))


if __name__ == "__main__":
    main()
