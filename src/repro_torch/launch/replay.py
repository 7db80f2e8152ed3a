"""The policy replay (Fig. 11b/d): accumulated WAF of every recovery policy
over a failure trace, through the port's simulator, with Unicron's lanes
replanning through the port's planner kernels.

    python -m repro_torch.launch.replay [--device cpu] [--seeds N]
                                        [--config paper_scale|quick]

Three parts, each a port of the reference's own run:

* **fig11** — the second half of ``examples/multitask_cluster.py``:
  ``run_policies`` over trace-b on the Fig. 11 deployment (Table 3 Case
  #5: six GPT-3 tasks on 16 nodes of 8 A800 GPUs), one ``TraceSimulator``
  run per policy.
* **serving** — the example's mixed training and serving fleet: four of
  those tasks and a ``ServingSLO`` task at 120 rps replan after one node
  is lost, then again after the offered load steps to 240 rps.
* **fleet** — ``benchmarks/bench_cluster_sim.py``'s ``mixed_fleet``
  Monte-Carlo (``CONFIGS``): independent, correlated, slow-node and
  preemption failures plus task churn over ``run_monte_carlo``.
  ``paper_scale`` is 128 nodes x 8 GPUs, 32 tasks, 30 days, 16 seeds;
  ``quick`` is 16 nodes, 6 tasks, 7 days, 4 seeds.

Each part returns records with its results, wall seconds and the
launches of each max-plus kernel it made.  The paper-scale fleet on the
CPU runs the plain max-plus versions for every plan (tens of seconds a
seed); ``--config quick`` is a seconds-long CPU run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional, Sequence

from repro_torch.core import scenarios
from repro_torch.core.coordinator import UnicronCoordinator
from repro_torch.core.costmodel import A800
from repro_torch.core.planner import PlannerCache
from repro_torch.core.simulator import (SimResult, run_monte_carlo,
                                        run_policies)
from repro_torch.core.traces import trace_b
from repro_torch.core.waf import ServingSLO, Task
from repro_torch.device import resolve_device
from repro_torch.launch.plan import (FIG11_ASSIGNMENT, fig11_tasks,
                                     fleet_tasks, launch_counts,
                                     launch_delta, sync)

GPN = 8
# benchmarks/bench_cluster_sim.py:66-71: n_nodes, m, span_days, seeds,
# mtbf_days, bursts, degradations, preemption waves
CONFIGS = {
    "quick": (16, 6, 7, 4, 20, 1, 3, 1),
    "paper_scale": (128, 32, 30, 16, 30, 3, 8, 2),
}
# examples/multitask_cluster.py:53-83
SERVING_ASSIGNMENT = [24, 24, 24, 32, 24]
SERVING_WORKERS = 128
SERVING_RATES = (120.0, 240.0)


def case5_tasks():
    """Table 3 Case #5 (``benchmarks/common.py:51``): the tasks and
    assignment of the Fig. 11 trace experiments."""
    return fig11_tasks(), list(FIG11_ASSIGNMENT)


def result_record(r: SimResult) -> dict:
    return {"accumulated_waf": r.accumulated_waf,
            "downtime_s": r.downtime_s, "n_reconfigs": int(r.n_reconfigs),
            "n_events": r.n_events,
            "n_degraded_drains": r.n_degraded_drains,
            "timeline": [list(p) for p in r.timeline]}


def fig11(device="cuda") -> dict:
    """``run_policies`` over trace-b on Case #5: per policy its result
    record and unicron's WAF over its own."""
    device = resolve_device(device)
    tasks, assignment = case5_tasks()
    before = launch_counts()
    t0 = time.perf_counter()
    res = run_policies(tasks, assignment, trace_b(), device=device)
    sync(device)
    secs = time.perf_counter() - t0
    out = {p: result_record(r) for p, r in res.items()}
    uni = res["unicron"].accumulated_waf
    for rec in out.values():
        rec["unicron_over"] = uni / rec["accumulated_waf"]
    return {"policies": out, "seconds": secs, "launches": launch_delta(before)}


def serving(device="cuda") -> dict:
    """The example's mixed training and serving fleet: the replan after one
    lost node, and the replan after the serving task's offered load steps
    from 120 to 240 rps."""
    device = resolve_device(device)
    tasks, _ = case5_tasks()
    # weight = FLOP-equivalents per served request (the example's choice)
    slo = ServingSLO(rate_rps=SERVING_RATES[0], capacity_rps=8.0)
    serve = Task(model=tasks[0].model, weight=1e14, max_workers=40,
                 objective=slo)
    before = launch_counts()
    t0 = time.perf_counter()
    coord = UnicronCoordinator(tasks[:4] + [serve], SERVING_ASSIGNMENT, A800,
                               n_cluster_workers=SERVING_WORKERS,
                               device=device)
    n = SERVING_WORKERS - GPN                       # one node lost
    plans = []
    plan = coord.reconfigure(n, faulted_task=0)
    plans.append((serve, plan))
    surge = dataclasses.replace(
        serve, objective=slo.with_rate(SERVING_RATES[1]))
    coord.task_updated(len(plan.assignment) - 1, surge)
    plans.append((surge, coord.reconfigure(n, faulted_task=None)))
    sync(device)
    secs = time.perf_counter() - t0
    records = []
    for (task, p), rate in zip(plans, SERVING_RATES):
        records.append({
            "rate_rps": rate, "assignment": list(p.assignment),
            "total_reward": p.total_reward, "waf": p.waf,
            "served_rps": task.objective.value(task, p.assignment[-1], A800)
            / task.weight})
    return {"plans": records, "seconds": secs, "launches": launch_delta(before)}


def scenario_fn(config: str, tasks: Sequence[Task]):
    """``bench_cluster_sim.py``'s ``_scenario_fn`` for ``config``: one
    seeded ``mixed_fleet`` per seed, churn drawn from ``tasks[:4]``."""
    n_nodes, m, span_days, _, mtbf_days, bursts, degr, waves = \
        CONFIGS[config]

    def make(seed):
        return scenarios.mixed_fleet(
            n_nodes=n_nodes, span_s=span_days * scenarios.DAY, seed=seed,
            gpus_per_node=GPN, m_initial=m, candidates=tasks[:4],
            mtbf_node_s=mtbf_days * scenarios.DAY, group_size=8,
            n_bursts=bursts, n_degradations=degr, n_waves=waves,
            wave_fraction=0.1)
    return make


def fleet_setup(config: str):
    """(tasks, assignment, n_nodes) of ``config``: ``fleet_tasks(m)`` at
    an equal node-granular share each (``bench_cluster_sim.py:85-87``)."""
    n_nodes, m = CONFIGS[config][:2]
    per = (n_nodes * GPN // m) // GPN * GPN
    return fleet_tasks(m), [per] * m, n_nodes


def fleet(device="cuda", *, config: str = "paper_scale",
          seeds: Optional[Sequence[int]] = None, engine: str = "batched",
          plan_engine: str = "batched",
          plan_cache: Optional[PlannerCache] = None) -> dict:
    """``run_monte_carlo`` over ``config``'s mixed fleet (its seed count
    unless ``seeds`` is given) on a fresh ``PlannerCache`` unless one is
    passed: per policy its per-seed WAF, reconfigurations and downtime,
    with the plan tables built and hit, the fused programs the tables ran
    (``device_dispatches``) and the kernel launches."""
    device = resolve_device(device)
    tasks, assignment, n_nodes = fleet_setup(config)
    if seeds is None:
        seeds = range(CONFIGS[config][3])
    cache = plan_cache if plan_cache is not None else PlannerCache()
    stats0 = cache.stats()
    disp0 = device_dispatches(cache)
    before = launch_counts()
    t0 = time.perf_counter()
    mc = run_monte_carlo(tasks, assignment, scenario_fn(config, tasks),
                         list(seeds), n_nodes=n_nodes,
                         gpus_per_node=GPN, plan_cache=cache, engine=engine,
                         plan_engine=plan_engine, device=device)
    sync(device)
    secs = time.perf_counter() - t0
    stats = cache.stats()
    return {
        "config": config, "workers": n_nodes * GPN, "tasks": len(tasks),
        "seeds": list(seeds), "engine": engine, "plan_engine": plan_engine,
        "policies": {p: {"per_seed": r.per_seed, "waf_mean": r.waf_mean,
                         "waf_std": r.waf_std,
                         "n_reconfigs": int(r.n_reconfigs),
                         "downtime_s": r.downtime_s}
                     for p, r in mc.items()},
        "seconds": secs, "launches": launch_delta(before),
        "tables_built": stats["misses"]["tables"]
        - stats0["misses"]["tables"],
        "table_hits": stats["hits"]["tables"] - stats0["hits"]["tables"],
        "device_dispatches": device_dispatches(cache) - disp0}


def device_dispatches(cache: PlannerCache) -> int:
    """Fused programs run by the tables ``cache`` holds."""
    return sum(t.batch_stats["device_dispatches"]
               for t in list(cache._tables.values()))


def replay(device="cuda", *, config: str = "paper_scale",
           seeds: Optional[Sequence[int]] = None) -> dict:
    """All three parts: ``{"fig11": ..., "serving": ..., "fleet": ...}``."""
    return {"fig11": fig11(device), "serving": serving(device),
            "fleet": fleet(device, config=config, seeds=seeds)}


def summary(result: dict) -> dict:
    """Per part: the WAF per policy, unicron's ratios, downtime and
    reconfigurations; the serving plans; the fleet's mean WAF per policy,
    tables and launches."""
    fig = result["fig11"]["policies"]
    fl = result["fleet"]
    return {
        "fig11": {p: {"accumulated_waf": r["accumulated_waf"],
                      "unicron_over": r.get("unicron_over"),
                      "downtime_h": r["downtime_s"] / 3600,
                      "n_reconfigs": r["n_reconfigs"]}
                  for p, r in fig.items()},
        "serving": [{k: r[k] for k in ("rate_rps", "assignment",
                                       "served_rps")}
                    for r in result["serving"]["plans"]],
        "fleet": {"config": fl["config"], "workers": fl["workers"],
                  "tasks": fl["tasks"], "seeds": len(fl["seeds"]),
                  "waf_mean": {p: r["waf_mean"]
                               for p, r in fl["policies"].items()},
                  "seconds": fl["seconds"],
                  "tables_built": fl["tables_built"],
                  "table_hits": fl["table_hits"],
                  "launches": fl["launches"]}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default="paper_scale", choices=CONFIGS)
    ap.add_argument("--seeds", type=int, default=None,
                    help="Monte-Carlo seeds 0..N-1 (default: the "
                         "config's)")
    args = ap.parse_args()
    seeds = None if args.seeds is None else range(args.seeds)
    result = replay(args.device, config=args.config, seeds=seeds)
    for p, r in sorted(result["fig11"]["policies"].items(),
                       key=lambda kv: -kv[1]["accumulated_waf"]):
        print(f"  {p:17s} acc_waf={r['accumulated_waf']:.3e}  unicron is "
              f"{r['unicron_over']:4.2f}x  (downtime "
              f"{r['downtime_s'] / 3600:.1f}h, {r['n_reconfigs']} "
              f"reconfigs)")
    print(json.dumps(summary(result)))


if __name__ == "__main__":
    main()
