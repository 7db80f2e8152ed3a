"""The control plane at the reference benches' scales: agents, the sharded
status monitor, the control loop and the coordinator, with every SEV1
replanning through the port's planner kernels.

    python -m repro_torch.launch.controlplane [--device cpu]
                                              [--config full|quick]

Two parts, each a port of a reference bench's own run:

* **chaos** — ``benchmarks/bench_chaos.py``'s reconvergence suite: three
  GPT-3 tasks on 6 nodes x 4 A800 GPUs run ``demo_world`` through
  ``ChaosHarness``, first chaos-free, then under each ``chaos_suite`` class
  (drop, delay_dup, partition, crash, full).  Each class gives the bench's
  row (converged, waf_delta, reconverge_s and the chaos counters) beside
  its ``HarnessResult`` and the control loop's event stream.
* **fleet** — ``benchmarks/bench_controlplane.py``'s stack: 100k agents of
  one GPU each, 8 fleet tasks capped at 64 workers, each stack's
  coordinator on its own ``PlannerCache``.  Ingestion drives ticks of 100k
  heartbeats plus immediate SEV3 reports through ``ControlLoop.tick`` on
  the legacy and the sharded store; dispatch injects SEV1 (``ECC_ERROR``)
  faults on assigned nodes, one tick each, and times report -> dispatched
  plan.

The bench constants are copied here with their source lines; nothing of
``benchmarks/`` is imported.
"""
from __future__ import annotations

import argparse
import gc
import json
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.core.chaos import ChaosHarness, demo_world, world_windows
from repro_torch.core.cluster import Cluster
from repro_torch.core.controlloop import ControlLoop
from repro_torch.core.coordinator import UnicronCoordinator
from repro_torch.core.costmodel import A800, TaskModel
from repro_torch.core.detection import ErrorKind
from repro_torch.core.handling import Action
from repro_torch.core.kvstore import KVStore, LegacyKVStore
from repro_torch.core.planner import PlannerCache
from repro_torch.core.scenarios import chaos_suite
from repro_torch.core.waf import Task
from repro_torch.device import resolve_device
from repro_torch.launch.plan import (fleet_tasks, launch_counts,
                                     launch_delta, sync)

# benchmarks/bench_chaos.py:27-29
SPAN = 2600.0
SUITE_SEED = 3
HARNESS_SEED = 7
N_NODES = 6                                 # ChaosHarness's default

# benchmarks/bench_controlplane.py:42-54
N_AGENTS = 100_000
M_TASKS = 8
CAP = 64                      # per-task worker cap: banded planner kernels
HB_TTL = 6.0
TICK_S = 2.0
CONFIGS = {
    "quick": dict(errors=64, ticks_sharded=24, ticks_legacy=3, faults=4),
    "full": dict(errors=128, ticks_sharded=80, ticks_legacy=5, faults=10),
}


# ---- chaos: bench_chaos.py ------------------------------------------------

def chaos_fleet():
    """``bench_chaos.py:32-38``: three GPT-3 tasks on [8, 8, 4] workers and
    the task ``demo_world`` launches."""
    def mk(size, w):
        return Task(model=TaskModel.from_arch(get_arch(size),
                                              global_batch=128), weight=w)
    tasks = [mk("gpt3-1.3b", 2.0), mk("gpt3-7b", 1.4), mk("gpt3-1.3b", 1.0)]
    return tasks, [8, 8, 4], mk("gpt3-1.3b", 0.7)


def run_harness(world, device, schedule=None, seed=0):
    """``bench_chaos.py:41-47``: one harness on a fresh fleet, run to the
    span (or past the schedule's horizon)."""
    tasks, assignment, _ = chaos_fleet()
    h = ChaosHarness(tasks=tasks, assignment=assignment, hw=A800,
                     schedule=schedule, seed=seed, device=device)
    until = SPAN if schedule is None else max(SPAN,
                                              schedule.horizon() + 120.0)
    return h, h.run(world, until=until)


def chaos(device="cuda") -> dict:
    """The chaos-free world, then every ``chaos_suite`` class
    (``bench_chaos.py:50-79``): ``{"free": ..., "classes": {name: ...}}``,
    each with its ``HarnessResult`` (``result``) and the loop's events
    (``events``), each class also with its bench row (``row``); plus wall
    seconds and the max-plus launches."""
    device = resolve_device(device)
    # the world's tasks come from their own chaos_fleet() call, as in the
    # bench: each harness below builds a fresh fleet
    tasks, _, launch = chaos_fleet()
    world = demo_world(tasks[2], launch)
    last_world_t = max(ev.time for ev in world)
    before = launch_counts()
    t0 = time.perf_counter()
    h, free = run_harness(world, device)
    out = {"free": {"result": free, "events": h.events}, "classes": {}}
    suite = chaos_suite(seed=SUITE_SEED, span_s=SPAN, n_nodes=N_NODES,
                        avoid=world_windows(world))
    for name, sched in suite.items():
        h, res = run_harness(world, device, schedule=sched,
                             seed=HARNESS_SEED)
        converged = (res.assignment == free.assignment
                     and abs(res.waf - free.waf) < 1e-6
                     and h.quiesced())
        row = {
            "case": name,
            "converged": float(converged),
            "waf_delta": abs(res.waf - free.waf),
            "reconverge_s": max(0.0, res.last_event_t - last_world_t),
            "n_crashes": res.n_crashes,
            "n_partitions": len(sched.partitions),
            **{k: res.chaos_stats[k] for k in
               ("dropped", "delayed", "duplicated", "rejected")},
        }
        out["classes"][name] = {"result": res, "events": h.events,
                                "row": row}
    sync(device)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = launch_delta(before)
    return out


# ---- fleet: bench_controlplane.py -----------------------------------------

@contextmanager
def _gc_paused():
    """Collect once, then keep the cyclic GC out of the timed windows
    (``bench_controlplane.py:57-72``)."""
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def fleet_stack(kv_cls, device):
    """``bench_controlplane.py:75-89``: (kv, coordinator, cluster, loop)
    on a fresh ``PlannerCache``, with no agent objects (the ingestion
    drives the store directly)."""
    tasks = fleet_tasks(M_TASKS, max_workers=CAP)
    assignment = [CAP] * M_TASKS
    kv = kv_cls()
    coord = UnicronCoordinator(tasks, assignment, A800, kv=kv,
                               plan_cache=PlannerCache(),
                               n_cluster_workers=N_AGENTS,
                               workers_per_node=1, device=device)
    cluster = Cluster(N_AGENTS, gpus_per_node=1)
    cluster.assign(assignment)
    return kv, coord, cluster, ControlLoop(coord, cluster, {})


def _beat_all(kv, ids, t):
    """Every agent's heartbeat: one array scatter on the sharded store, a
    formatted per-agent put on the legacy one (``:92-99``)."""
    if isinstance(kv, LegacyKVStore):
        for i in range(ids.size):
            kv.put(f"/nodes/{i}/alive", t, ttl=HB_TTL, now=t)
    else:
        kv.heartbeat_batch(ids, t, ttl=HB_TTL)


def _inject_errors(kv, n_agents, t, count, seq):
    """``count`` immediately-visible SEV3 reports, nodes spread over the
    whole id space (``:105-116``)."""
    kind = ErrorKind.CONNECTION_REFUSED.value
    for j in range(count):
        node = ((seq + j) * 997) % n_agents
        kv.put(f"/errors/{node}/{t:.3f}", {
            "node": node, "kind": kind, "severity": 3,
            "method": "process_supervision", "raised_at": t,
            "visible_at": t}, now=t)
    return count


def _ingestion(stack, ids, ticks, errors):
    """Two warm-up ticks, then ``ticks`` timed ticks of every heartbeat
    plus ``errors`` SEV3 reports (``:119-149``)."""
    kv, _, _, loop = stack
    for w in range(2):
        t = TICK_S * w
        _beat_all(kv, ids, t)
        loop.tick(t)
    fired, seq = 0, 0
    with _gc_paused():
        t0 = time.perf_counter()
        for i in range(ticks):
            t = TICK_S * (2 + i)
            _beat_all(kv, ids, t)
            seq += _inject_errors(kv, ids.size, t, errors, seq)
            fired += len(loop.tick(t))
        wall = time.perf_counter() - t0
    if fired != errors * ticks or not all(
            e.action is Action.REATTEMPT for e in loop.events[-fired:]):
        raise AssertionError(f"ingestion fired {fired} events, expected "
                             f"{errors * ticks} reattempts")
    events = (ids.size + errors) * ticks
    return {"ticks": ticks, "events_per_tick": ids.size + errors,
            "events": events, "loop_events": fired, "wall_s": wall,
            "events_per_sec": events / wall}


def sev1_report(kv, node, t):
    """An immediately-visible SEV1 (``ECC_ERROR``) report from ``node``
    (``:158-161``)."""
    kv.put(f"/errors/{node}/{t:.3f}", {
        "node": node, "kind": ErrorKind.ECC_ERROR.value, "severity": 1,
        "method": "exception_propagation", "raised_at": t,
        "visible_at": t}, now=t)


def _dispatch(stack, ids, faults, t, device):
    """SEV1 faults on assigned nodes, one tick each: per fault the wall
    from visible report to dispatched plan and cluster reassignment, the
    max-plus launches of that tick and the cluster WAF after it
    (``:152-177``)."""
    kv, coord, _, loop = stack
    samples, launches, events, wafs = [], [], [], []
    with _gc_paused():
        for node in range(faults):          # nodes 0.. are assigned
            t += TICK_S
            kv.heartbeat_batch(ids, t, ttl=HB_TTL)
            sev1_report(kv, node, t)
            before = launch_counts()
            t0 = time.perf_counter()
            evs = loop.tick(t)
            sync(device)
            samples.append(time.perf_counter() - t0)
            launches.append(launch_delta(before))
            if len(evs) != 1 or evs[0].action is not Action.RECONFIGURE \
                    or evs[0].plan is None:
                raise AssertionError(f"SEV1 on node {node} gave {evs}")
            events += evs
            wafs.append(coord.cluster_waf())
    return samples, launches, events, wafs


def fleet(device="cuda", *, config: str = "full",
          ticks: Optional[dict] = None) -> dict:
    """Ingestion on the legacy and the sharded store, then SEV1 dispatch on
    the sharded stack (``bench_controlplane.py:180-207``).  ``ticks``
    ({"sharded": n, "legacy": n}) cuts the config's tick counts, never its
    agents, tasks or faults.

    Per store: events, loop events, wall seconds and events/s; their ratio;
    p50 and p99 report -> dispatch ms; each SEV1's max-plus launches and
    the cluster WAF after it; the plan tables built; and both loops' event
    streams."""
    device = resolve_device(device)
    cfg = dict(CONFIGS[config])
    for store, n in (ticks or {}).items():
        cfg[f"ticks_{store}"] = n
    ids = np.arange(N_AGENTS)
    before = launch_counts()
    t0 = time.perf_counter()
    out = {"config": config, "agents": N_AGENTS, "tasks": M_TASKS,
           "cap": CAP, "stores": {}}
    stacks = {}
    for store, kv_cls in (("legacy", LegacyKVStore), ("sharded", KVStore)):
        stacks[store] = fleet_stack(kv_cls, device)
        out["stores"][store] = _ingestion(stacks[store], ids,
                                          cfg[f"ticks_{store}"],
                                          cfg["errors"])
    out["ingest_speedup"] = (out["stores"]["sharded"]["events_per_sec"]
                             / out["stores"]["legacy"]["events_per_sec"])
    t_start = TICK_S * (2 + cfg["ticks_sharded"])
    samples, launches, sev1, wafs = _dispatch(stacks["sharded"], ids,
                                              cfg["faults"], t_start, device)
    ms = np.asarray(samples) * 1e3
    out.update({
        "p50_event_ms": float(np.percentile(ms, 50)),
        "p99_event_ms": float(np.percentile(ms, 99)),
        "dispatch_ms": ms.tolist(),
        "sev1_replans": len(sev1),
        "sev1_plans": [e.plan for e in sev1],
        "sev1_waf": wafs,
        "launches_per_dispatch": launches,
        "launches": launch_delta(before),
        "tables_built": sum(s[1].plan_cache.stats()["misses"]["tables"]
                            for s in stacks.values()),
        "seconds": time.perf_counter() - t0})
    out["events"] = {store: s[3].events for store, s in stacks.items()}
    return out


def summary(chaos_out: dict, fleet_out: dict) -> dict:
    """Each chaos class's bench row, and the fleet's numbers without its
    event streams."""
    return {"chaos": [c["row"] for c in chaos_out["classes"].values()],
            "chaos_seconds": chaos_out["seconds"],
            "fleet": {k: v for k, v in fleet_out.items()
                      if k not in ("events", "sev1_plans", "sev1_waf",
                                   "dispatch_ms")}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default="full", choices=CONFIGS)
    args = ap.parse_args()
    c = chaos(args.device)
    for row in (r["row"] for r in c["classes"].values()):
        print(f"  {row['case']:10s} converged={row['converged']:.0f} "
              f"reconverge_s={row['reconverge_s']:.0f} "
              f"crashes={row['n_crashes']} rejected={row['rejected']}")
    f = fleet(args.device, config=args.config)
    print(f"  [{args.config}] n={f['agents']}: sharded "
          f"{f['stores']['sharded']['events_per_sec']:.3g} ev/s vs legacy "
          f"{f['stores']['legacy']['events_per_sec']:.3g} ev/s -> "
          f"{f['ingest_speedup']:.1f}x; dispatch p50 "
          f"{f['p50_event_ms']:.1f} ms, p99 {f['p99_event_ms']:.1f} ms")
    print(json.dumps(summary(c, f)))


if __name__ == "__main__":
    main()
