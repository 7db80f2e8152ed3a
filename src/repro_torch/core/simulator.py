"""Discrete-event cluster simulator (§7.5) driving the REAL Unicron code.
Copied from ``repro/core/simulator.py``; the only change is ``device``:
where the planner lanes' plan tables run their max-plus kernels.  The
simulator's own state stays host numpy float64, op for op as in the
reference, so every total is bitwise the reference's.

The simulator replaces wall-clock time and GPUs only: detection latencies
come from ``core.detection``, recovery decisions from the severity
workflow, reconfiguration plans from the real DP planner through
``UnicronCoordinator``, and transition durations from ``core.transition``.
Baselines are recovery *policies* with their published behaviours:

  megatron   restart-from-checkpoint + hot spare; 30-min watchdog
             detection for non-node-loss failures; reconfigures only the
             affected task (down-scales on node loss until repair).
  oobleck    dynamic reconfiguration (no checkpoint reload), pipeline
             templates; lower normal-case efficiency (Fig. 3a).
  bamboo     redundant computation: keeps running through failures but
             pays a constant throughput tax; lowest efficiency.
  varuna     job morphing + checkpoint restart; low efficiency.
  unicron    everything in this repo: in-band detection, lookup-table
             plans over ALL tasks, partial-result reuse.

Three modern recovery techniques (PAPERS.md: FFTrainer, GEMINI-style
tiered checkpointing, replication-based continuation) are policy peers
of the paper's five — the frontier ``benchmarks/bench_frontier.py``
sweeps:

  fftrainer          reserved hot-spare pool (``fftrainer_pool``): a
                     spare substitutes for a failed node in seconds with
                     state from the DP replica; the spares are capacity
                     no task may use, so the trade-off is standing WAF
                     for near-zero failover.  In-band detection.
  hierarchical_ckpt  tiered restore (in-memory ring, demoted to the
                     persistent store when a correlated burst also took
                     the ring neighbor); affected-task reconfiguration,
                     in-band detection, small standing efficiency tax
                     for the per-iteration snapshots.
  redundant          redundancy-based continuation: zero-cost
                     transitions (survivors absorb the work instantly)
                     paid for by the largest standing efficiency tax;
                     failures still shrink capacity until repair.

Inputs are either a plain failure trace (``core.traces``) or a
:class:`~repro_torch.core.scenarios.ClusterScenario`, which adds slow-node
degradation (§4.1 statistical monitor), correlated/preemption failures,
and task join/finish churn (Figure 7 triggers 5/6).

Three integrators share one decision engine:

* ``TraceSimulator`` — the scalar reference loop: per-event Python with
  piecewise-midpoint WAF integration and the eager, uncached coordinator.
  One policy per run; the ground truth every other engine must match.
* ``VectorSimulator`` — the per-(policy, seed) cluster-scale engine:
  identical decisions (same handlers, plans float-identical via the lazy
  cached planner), but WAF is integrated as one numpy segment product and
  plan tables are chain-cached across rebuilds and Monte-Carlo seeds
  (``planner.PlannerCache``).  Still one policy per run — the measured
  baseline of the batched engine.
* ``BatchSimulator`` — the batched multi-policy engine: one event pass
  per trace carrying EVERY recovery policy as stacked numpy state
  (per-policy worker/blocked/placement matrices, downtime vectors, WAF
  accumulators).  Each event is decoded once; its per-policy consequences
  are one array op over the policy axis through the array-native models
  (``detection.detection_times``, ``transition.estimate_batch``,
  ``detection.FleetMonitor``), while planner-backed lanes drive the same
  ``UnicronCoordinator`` the scalar loop uses, so plans stay identical.

``run_monte_carlo(engine=...)`` batches seeds over a shared cache:
``"batched"`` (default) runs each seed once through ``BatchSimulator``;
``"vector"`` keeps the per-(policy, seed) path as the measured
baseline.  ``benchmarks/bench_cluster_sim.py`` asserts the >= 50x
vector-vs-scalar and >= 3x batched-vs-vector engine speedups and 1e-6
WAF agreement at (n=1024, m=32).

WAF is integrated over the trace (the Fig. 11 y-axis); ``accumulated``
at the end of the run is the Fig. 11b/d number.
"""
from __future__ import annotations

import dataclasses
import heapq
import time as _time
from bisect import bisect_left, bisect_right
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core import costmodel, transition, waf as waf_mod
from repro_torch.core.cluster import Cluster
from repro_torch.core.coordinator import UnicronCoordinator
from repro_torch.core.detection import (INBAND_POLICIES, ErrorKind,
                                        FleetMonitor, Severity, classify,
                                        detection_time, detection_times)
from repro_torch.core.handling import Trigger
from repro_torch.core.planner import PlannerCache
from repro_torch.core.scenarios import (ClusterScenario, DegradationEvent,
                                        RateChangeEvent, TaskArrival,
                                        TaskFinish)
from repro_torch.core.traces import FailureEvent, trace_span
from repro_torch.core.waf import Task
from repro_torch.device import resolve_device

# Normal-case training efficiency relative to Megatron (Figure 3a: the
# resilience-first systems run at a fraction of Megatron's throughput).
EFFICIENCY = {
    "unicron": 1.00,        # inherits all Megatron optimizations
    "megatron": 1.00,
    "oobleck": 0.38,
    "bamboo": 0.30,         # includes the redundant-computation tax
    "varuna": 0.29,
    "fftrainer": 1.00,      # spare cost is modeled as reserved capacity
    "hierarchical_ckpt": 0.98,   # per-iteration in-memory snapshots
    "redundant": 0.90,      # standing replication tax
}

# Megatron's deployment keeps hot-spare nodes that substitute for failed
# ones (paper §7.3 footnote 1): capacity is preserved while a spare is
# available, at the cost of idling the spare.  Unicron instead re-plans
# and uses every healthy node productively.
HOT_SPARES = {"megatron": 1}


def fftrainer_pool(n_nodes: int) -> int:
    """Reserved hot-spare pool size for the fftrainer policy: one spare
    per 16 nodes (at least one), never the whole fleet.  Unlike
    megatron's off-book spare, these are nodes the planner can never
    assign — the standing WAF cost of the near-zero failover."""
    if n_nodes <= 1:
        return 0
    return min(max(1, n_nodes // 16), n_nodes - 1)


def fit_assignment(assignment: List[int], capacity: int,
                   gpn: int) -> List[int]:
    """Trim an assignment to ``capacity`` workers by repeatedly shaving
    one node's worth off the largest task (deterministic: first max
    wins) — how the fftrainer lanes fund their reserved spares."""
    w = list(assignment)
    total = sum(w)
    while total > capacity:
        i = max(range(len(w)), key=lambda j: w[j])
        if w[i] < gpn:
            break
        w[i] -= gpn
        total -= gpn
    return w

Trace = Union[List[FailureEvent], ClusterScenario]


@dataclass
class SimTask:
    task: Task
    workers: int
    avg_iter_s: float = 30.0
    blocked_until: float = 0.0          # transitioning/restarting until t
    affected_first: bool = False        # baselines: reconfigure priority
    active: bool = True                 # False once the task finished
    # undetected slow-node windows: (start, end, iteration-time multiplier)
    slow: List[Tuple[float, float, float]] = field(default_factory=list)


@dataclass
class SimResult:
    policy: str
    accumulated_waf: float              # integral of WAF dt
    timeline: List[Tuple[float, float]]  # (t, cluster WAF) samples
    n_reconfigs: int
    downtime_s: float                   # total task-seconds blocked
    n_events: int = 0
    n_degraded_drains: int = 0          # slow nodes caught by the monitor


@dataclass
class MonteCarloResult:
    policy: str
    waf_mean: float
    waf_std: float
    per_seed: List[float]
    wall_s: float                       # engine wall-clock for all seeds
    n_reconfigs: int
    downtime_s: float


# ---------------------------------------------------------------------------
# Shared event normalization + segment integration (all engines)
# ---------------------------------------------------------------------------


def _resolve_trace_span(trace: Trace, span_s: Optional[float]) -> float:
    if span_s is not None:
        return span_s
    if isinstance(trace, ClusterScenario):
        return trace.span_s
    return trace_span(trace)


def _check_trace_shape(trace: Trace, n_nodes: int, gpn: int) -> None:
    if isinstance(trace, ClusterScenario):
        assert (trace.n_nodes, trace.gpus_per_node) == (n_nodes, gpn), (
            f"scenario shaped for {trace.n_nodes}x"
            f"{trace.gpus_per_node}, simulator is {n_nodes}x{gpn}")


def _event_entries(trace: Trace,
                   span: float) -> Tuple[List[Tuple[float, int, str, object]],
                                         int]:
    """(time, seq, kind, payload) entries + next seq: failure/repair first
    (preserving the historical same-time ordering), then degradations and
    churn; handlers may push synthetic events past these."""
    if isinstance(trace, ClusterScenario):
        failures, degradations, churn = (trace.failures,
                                         trace.degradations, trace.churn)
    else:
        failures, degradations, churn = trace, [], []
    entries: List[Tuple[float, int, str, object]] = []
    seq = 0
    for e in failures:
        if e.time <= span:
            entries.append((e.time, seq, "fail", e))
            seq += 1
    for e in failures:
        if e.repair_s is not None and e.time + e.repair_s <= span:
            entries.append((e.time + e.repair_s, seq, "repair", e))
            seq += 1
    for d in degradations:
        if d.time <= span:
            entries.append((d.time, seq, "degrade", d))
            seq += 1
    for c in churn:
        if c.time <= span:
            if isinstance(c, TaskArrival):
                kind = "arrive"
            elif isinstance(c, RateChangeEvent):
                kind = "rate"
            else:
                kind = "finish"
            entries.append((c.time, seq, kind, c))
            seq += 1
    return entries, seq


def _rate_epoch_stack(tasks: List[Task],
                      rate_log: List[Tuple[float, int, Task, Task]],
                      n: int, hw) -> Tuple[np.ndarray, np.ndarray]:
    """Per-epoch WAF matrices for a trace whose tasks swapped objectives
    mid-span (``RateChangeEvent``): returns ``(epoch_t, F)`` where
    ``epoch_t[e]`` is when epoch ``e`` begins and ``F[e]`` is its
    (m, n+1) reward matrix.  ``tasks`` is the FINAL task list;
    ``rate_log`` holds (time, slot, old, new) entries in dispatch order
    and is rewound to recover each epoch's task list."""
    cur = list(tasks)
    for _, slot, old, _new in reversed(rate_log):
        cur[slot] = old
    epoch_t = [0.0]
    lists = [list(cur)]
    for t, slot, _old, new in rate_log:
        cur = list(cur)
        cur[slot] = new
        epoch_t.append(t)
        lists.append(cur)
    F = np.stack([waf_mod.waf_matrix(ts, n, hw) for ts in lists])
    return np.asarray(epoch_t), F


def _integrate_segments(snap_t: List[float], snap_w: List[List[int]],
                        blocks: List[Tuple[int, float, float]],
                        slows: List[List[Tuple[float, float, float]]],
                        span: float, F: np.ndarray,
                        epoch_t: Optional[np.ndarray] = None):
    """One numpy pass over one policy's recorded step functions: segment
    boundaries from events + block expiries + slow-window edges; rates are
    a gather out of the eff-scaled (m, n+1) WAF matrix ``F``, masked by
    blocks, divided by slow factors.  With ``epoch_t``, ``F`` is an
    (E, m, n+1) epoch stack (reward rows changed mid-trace via rate
    events) and each segment gathers from the epoch holding its start.
    Returns (accumulated, timeline)."""
    m = F.shape[-2]
    edges = {0.0, span}
    edges.update(t for t in snap_t if 0.0 < t < span)
    if epoch_t is not None:
        edges.update(float(t) for t in epoch_t if 0.0 < t < span)
    for _, start, until in blocks:
        if start < span:
            edges.add(max(start, 0.0))
            if until < span:
                edges.add(until)
    for wins in slows:
        for start, end, _ in wins:
            if 0.0 < start < span:
                edges.add(start)
            if 0.0 < end < span:
                edges.add(end)
    bounds = np.array(sorted(edges))
    dt = np.diff(bounds)
    # per-segment worker counts: latest snapshot at or before seg start
    st_arr = np.array(snap_t)
    idx = np.searchsorted(st_arr, bounds[:-1], side="right") - 1
    W = np.zeros((len(snap_t), m), dtype=np.int64)
    for r, w in enumerate(snap_w):
        W[r, :len(w)] = w
    Wseg = W[idx]                                   # (S, m)
    if epoch_t is None:
        rate = F[np.arange(m)[None, :], Wseg]       # (S, m)
    else:
        eidx = np.searchsorted(epoch_t, bounds[:-1], side="right") - 1
        rate = F[eidx[:, None], np.arange(m)[None, :], Wseg]
    scale = np.ones_like(rate)
    for slot, start, until in blocks:
        if start >= span:
            continue
        lo = np.searchsorted(bounds, start, side="left")
        hi = np.searchsorted(bounds, min(until, span), side="left")
        scale[lo:hi, slot] = 0.0
    for slot, wins in enumerate(slows):
        for start, end, factor in wins:
            if start >= span:
                continue
            lo = np.searchsorted(bounds, max(start, 0.0), side="left")
            hi = np.searchsorted(bounds, min(end, span), side="left")
            seg = scale[lo:hi, slot]
            np.minimum(seg, 1.0 / factor,
                       where=seg > 0.0, out=seg)
    eff_rate = rate * scale
    acc = float(eff_rate @ np.ones(m) @ dt) if m else 0.0
    row = eff_rate.sum(axis=1) if m else np.zeros(len(dt))
    # timeline samples at event boundaries (rate of the segment that
    # starts there), matching the reference loop's post-event samples
    timeline = [(0.0, float(row[0]) if len(row) else 0.0)]
    for t in snap_t[1:]:
        si = min(np.searchsorted(bounds, t, side="left"), len(row) - 1)
        timeline.append((t, float(row[si])))
    timeline.append((span, float(row[-1]) if len(row) else 0.0))
    return acc, timeline


def _integrate_policies(snap_t: List[float], snaps: List[np.ndarray],
                        blocks, slows, span: float, F: np.ndarray,
                        effs: np.ndarray,
                        timeline_t: Optional[List[float]] = None,
                        epoch_t: Optional[np.ndarray] = None):
    """The multi-policy counterpart of ``_integrate_segments``: one shared
    edge set (the union of every policy's breakpoints — extra edges only
    split constant segments, so totals agree with the per-policy pass to
    float reordering), one (S, P, m) gather, per-policy block/slow masks.
    ``blocks[p]`` is a (slots, starts, untils) triple of parallel lists.
    With ``epoch_t``, ``F`` is an (E, m, n+1) rate-epoch stack (see
    ``_integrate_segments``).  Returns (accs (P,), timelines per policy)."""
    P, m = effs.size, F.shape[-2]
    st_arr = np.array(snap_t)
    parts = [st_arr, np.array((0.0, span))]
    if epoch_t is not None:
        parts.append(epoch_t[(epoch_t > 0.0) & (epoch_t < span)])
    barrs = []
    for p in range(P):
        bslots, bstarts, buntils = blocks[p]
        sl = np.array(bslots, dtype=np.int64)
        st = np.array(bstarts)
        un = np.array(buntils)
        barrs.append((sl, st, un))
        if sl.size:
            parts.append(np.maximum(st, 0.0))
            parts.append(un[un < span])
        for slot, wins in enumerate(slows[p]):
            for start, end, _ in wins:
                parts.append(np.array((max(start, 0.0), min(end, span))))
    bounds = np.unique(np.concatenate(parts))
    bounds = bounds[(bounds >= 0.0) & (bounds <= span)]
    dt = np.diff(bounds)
    idx = np.searchsorted(st_arr, bounds[:-1], side="right") - 1
    W = np.zeros((len(snap_t), P, m), dtype=np.int64)
    for r, w in enumerate(snaps):
        W[r, :, :w.shape[1]] = w
    Wseg = W[idx]                                   # (S, P, m)
    if epoch_t is None:
        rate = F[np.arange(m)[None, None, :], Wseg] * effs[None, :, None]
    else:
        eidx = np.searchsorted(epoch_t, bounds[:-1], side="right") - 1
        rate = (F[eidx[:, None, None], np.arange(m)[None, None, :], Wseg]
                * effs[None, :, None])
    scale = np.ones_like(rate)
    for p in range(P):
        sl, st, un = barrs[p]
        if sl.size:
            lo_a = np.searchsorted(bounds, st, side="left")
            hi_a = np.searchsorted(bounds, np.minimum(un, span),
                                   side="left")
            live = st < span
            for slot, lo, hi in zip(sl[live].tolist(), lo_a[live].tolist(),
                                    hi_a[live].tolist()):
                scale[lo:hi, p, slot] = 0.0
        for slot, wins in enumerate(slows[p]):
            for start, end, factor in wins:
                if start >= span:
                    continue
                lo = np.searchsorted(bounds, max(start, 0.0), side="left")
                hi = np.searchsorted(bounds, min(end, span), side="left")
                seg = scale[lo:hi, p, slot]
                np.minimum(seg, 1.0 / factor,
                           where=seg > 0.0, out=seg)
    rate *= scale
    rows = rate.sum(axis=2)                         # (S, P)
    accs = rows.T @ dt if m else np.zeros(P)
    # timeline samples at event times (the rate of the segment holding or
    # starting at each sample), shared across policies
    samples = snap_t[1:] if timeline_t is None else timeline_t
    sis = (np.clip(np.searchsorted(bounds, samples, side="right") - 1,
                   0, len(dt) - 1)
           if len(dt) else np.zeros(0, dtype=int))
    timelines = []
    for p in range(P):
        row = rows[:, p]
        first = float(row[0]) if len(row) else 0.0
        last = float(row[-1]) if len(row) else 0.0
        timeline = [(0.0, first)]
        timeline += [(t, float(row[si]))
                     for t, si in zip(samples, sis)]
        timeline.append((span, last))
        timelines.append(timeline)
    return accs, timelines


class TraceSimulator:
    """Scalar reference loop: per-event Python decisions + piecewise
    midpoint WAF integration (the baseline the vectorized engine must
    match to 1e-6 and beat by >= 50x)."""

    def __init__(self, tasks: List[Task], assignment: List[int],
                 policy: str, hw=costmodel.A800, n_nodes: int = 16,
                 gpus_per_node: int = 8, *,
                 plan_cache: Optional[PlannerCache] = None,
                 plan_engine: str = "batched",
                 ablate_detection: bool = False,
                 ablate_transition: bool = False,
                 ablate_replan: bool = False,
                 chaos=None, device="cuda"):
        """``ablate_*``: component ablations for the unicron policy —
        swap one Unicron mechanism for its baseline counterpart to
        measure that component's contribution (benchmarks/bench_ablation).
        ``plan_cache``: share a ``PlannerCache`` across runs (lazy plan
        tables, chains reused across rebuilds; plans stay identical).
        ``plan_engine``: the coordinator's incremental PlanTable engine
        (``"batched"`` default; ``"segtree"``/``"chain"`` are the
        measured baselines — all three produce float-identical plans).
        ``chaos``: a ``chaos.ChaosSchedule`` (duck-typed: only
        ``crash_times`` is read) — each listed time becomes a
        ``coord_crash`` event that kills the unicron coordinator
        mid-trace and rebuilds a successor from its ``/coord/journal/*``
        keys via ``UnicronCoordinator.recover``.  Message-level chaos
        (drop/delay/duplication/partitions) lives in ``chaos.ChaosHarness``,
        which drives the real agent->KV->control-loop path; this engine's
        event stream bypasses message transport, so only the crash
        component of a schedule applies here.
        ``device``: where the coordinator's plan tables run their
        max-plus kernels — ``"cuda"`` (default; raises without CUDA) or
        ``"cpu"`` (the plain PyTorch versions)."""
        self.device = resolve_device(device)
        self.policy = policy
        self.ablate_detection = ablate_detection
        self.ablate_transition = ablate_transition
        self.ablate_replan = ablate_replan
        self._chaos = chaos
        self._plan_cache = plan_cache
        self._plan_engine = plan_engine
        self.hw = hw
        self.eff = EFFICIENCY[policy]
        # WAF timeline sampling reads F(t, ·) straight off the memoized
        # cost-model curves; one vector per distinct task for the whole run
        self._n_total = n_nodes * gpus_per_node
        self._waf_curves: Dict[Task, object] = {}
        self.cluster = Cluster(n_nodes, gpus_per_node)
        self.gpn = gpus_per_node
        if policy == "fftrainer":
            # the reserved spare pool is funded up front: the initial
            # assignment is trimmed to the capacity that remains
            pool = fftrainer_pool(n_nodes)
            assignment = fit_assignment(
                list(assignment), (n_nodes - pool) * gpus_per_node,
                gpus_per_node)
        self.tasks = [SimTask(task=t, workers=x)
                      for t, x in zip(tasks, assignment)]
        # §4.1 statistical monitor: one primed ring-buffer row per task
        # (replaces the per-event OnlineStatMonitor deques; same status)
        self._fleet = FleetMonitor.primed([t.avg_iter_s
                                           for t in self.tasks])
        self.cluster.assign([t.workers for t in self.tasks])
        self.coord: Optional[UnicronCoordinator] = None
        if policy == "unicron":
            self.coord = UnicronCoordinator(
                tasks, assignment, hw, plan_cache=plan_cache,
                n_cluster_workers=self._n_total,
                workers_per_node=gpus_per_node,
                plan_engine=plan_engine, device=self.device)
        # coordinator entry index per simulator slot (diverges under churn)
        self._ci: List[Optional[int]] = list(range(len(self.tasks)))
        self.spares = (fftrainer_pool(n_nodes) if policy == "fftrainer"
                       else HOT_SPARES.get(policy, 0))
        self.n_reconfigs = 0
        self.downtime = 0.0
        self.n_degraded_drains = 0
        self._heap: List[Tuple[float, int, str, object]] = []
        self._seq = 0
        self._span = float("inf")
        # objective swaps applied so far: (time, slot, old_task, new_task)
        self._rate_log: List[Tuple[float, int, Task, Task]] = []

    # ---- instantaneous cluster WAF ----------------------------------------

    def _waf(self, task: Task, x: int) -> float:
        """F(t, x) via the per-task curve (vector lookup; scalar fallback
        for worker counts beyond the cluster size)."""
        if 0 <= x <= self._n_total:
            F = self._waf_curves.get(task)
            if F is None:
                F = waf_mod.waf_curve(task, self._n_total, self.hw)
                self._waf_curves[task] = F
            return float(F[x])
        return waf_mod.waf(task, x, self.hw)

    @staticmethod
    def _slow_factor(st: SimTask, now: float) -> float:
        """Iteration-time multiplier from undetected slow nodes (the task
        runs at the pace of its slowest worker)."""
        s = 1.0
        for start, end, factor in st.slow:
            if start <= now < end and factor > s:
                s = factor
        return s

    def cluster_waf(self, now: float) -> float:
        total = 0.0
        for st in self.tasks:
            if not st.active or now < st.blocked_until or st.workers <= 0:
                continue
            total += (self._waf(st.task, st.workers) * self.eff
                      / self._slow_factor(st, now))
        return total

    # ---- policy behaviours -------------------------------------------------

    def _detect_s(self, kind: ErrorKind, avg_iter: float) -> float:
        unicron = (self.policy in INBAND_POLICIES
                   and not self.ablate_detection)
        return detection_time(kind, avg_iter, unicron=unicron)

    def _transition_s(self, st: SimTask, detect_s: float,
                      sev: Severity, replica_lost: bool = False) -> float:
        state_bytes = waf_mod.state_bytes(st.task)
        if self.policy == "unicron" and self.ablate_transition:
            c = transition.estimate_baseline(
                state_bytes, detect_s, dynamic_reconfig=False,
                ckpt_restart=True)
            return c.total
        if self.policy == "unicron":
            dp = max(st.workers // 8, 1)
            c = transition.estimate_unicron(
                state_bytes, st.avg_iter_s, dp_degree=dp, detect_s=detect_s,
                lookup_hit=True, replica_lost=replica_lost)
            return c.total
        if self.policy == "fftrainer":
            return transition.estimate_fftrainer(
                state_bytes, st.avg_iter_s, detect_s).total
        if self.policy == "hierarchical_ckpt":
            return transition.estimate_hierarchical(
                state_bytes, st.avg_iter_s, detect_s,
                replica_lost=replica_lost).total
        if self.policy == "redundant":
            # continuation: survivors absorb the work with zero stoppage
            return transition.estimate_redundant().total
        if self.policy in ("megatron", "varuna"):
            c = transition.estimate_baseline(
                state_bytes, detect_s, dynamic_reconfig=False,
                ckpt_restart=True)
            return c.total
        # oobleck / bamboo: dynamic reconfiguration
        c = transition.estimate_baseline(
            state_bytes, detect_s, dynamic_reconfig=True, ckpt_restart=False)
        # bamboo's redundancy rides through SEV2/3 without interruption
        if self.policy == "bamboo" and sev is not Severity.SEV1:
            return 0.0
        return c.total

    def _use_planner(self) -> bool:
        return (self.policy == "unicron" and self.coord is not None
                and not self.ablate_replan)

    def _avail_workers(self) -> int:
        """Workers the policy may assign: healthy capacity minus the
        fftrainer spare pool (reserved nodes no task can use)."""
        avail = self.cluster.healthy_workers()
        if self.policy == "fftrainer":
            avail -= self.spares * self.gpn
        return avail

    def _apply_unicron_plan(self) -> None:
        """Sync slot worker counts from the coordinator's entries."""
        for slot, ci in enumerate(self._ci):
            if ci is not None:
                self.tasks[slot].workers = self.coord.entries[ci].n_workers

    def _reconfigure(self, now: float, faulted_task: Optional[int]) -> None:
        """Node-count change: redistribute workers."""
        n_avail = self._avail_workers()
        self.n_reconfigs += 1
        if self._use_planner():
            ft = self._ci[faulted_task] if faulted_task is not None else None
            self.coord.reconfigure(n_avail, ft)
            self._apply_unicron_plan()
        else:
            # baselines only touch the directly-affected task: it shrinks
            # to what is left after the others keep their nodes
            others = sum(st.workers for i, st in enumerate(self.tasks)
                         if i != faulted_task)
            if faulted_task is not None:
                st = self.tasks[faulted_task]
                st.workers = max(0, min(st.workers, n_avail - others))
                st.workers -= st.workers % self.gpn
                st.affected_first = True
        self.cluster.assign([t.workers for t in self.tasks])

    def _node_rejoin(self, now: float) -> None:
        n_avail = self._avail_workers()
        self.n_reconfigs += 1
        if self._use_planner():
            self.coord.reconfigure(n_avail, None,
                                   trigger=Trigger.NODE_JOIN)
            self._apply_unicron_plan()
        else:
            # restore the first-affected task toward its original size
            assigned = sum(st.workers for st in self.tasks)
            spare = n_avail - assigned
            for st in self.tasks:
                if st.affected_first and spare >= self.gpn:
                    st.workers += self.gpn
                    spare -= self.gpn
                    st.affected_first = False
                    break
        self.cluster.assign([t.workers for t in self.tasks])

    # ---- event normalization ----------------------------------------------

    def _event_heap(self, trace: Trace,
                    span: float) -> List[Tuple[float, int, str, object]]:
        """(time, seq, kind, payload) heap (``_event_entries``); handlers
        may push synthetic events via ``_push``."""
        entries, self._seq = _event_entries(trace, span)
        heapq.heapify(entries)
        return entries

    def _push(self, t: float, kind: str, payload: object) -> None:
        if t <= self._span:
            self._seq += 1
            heapq.heappush(self._heap, (t, self._seq, kind, payload))

    def _dispatch(self, now: float, kind: str, ev: object) -> None:
        if kind == "fail":
            self._on_failure(now, ev)
        elif kind == "repair":
            self._on_repair(now, ev)
        elif kind == "degrade":
            self._on_degradation(now, ev)
        elif kind == "arrive":
            self._on_arrival(now, ev)
        elif kind == "finish":
            self._on_finish(now, ev)
        elif kind == "rate":
            self._on_rate(now, ev)
        elif kind == "coord_crash":
            self._on_coord_crash(now)

    def _push_crash_events(self) -> None:
        """Schedule the chaos plan's coordinator crashes as heap events
        (after the heap for a run exists)."""
        if self._chaos is not None and self.coord is not None:
            for ct in getattr(self._chaos, "crash_times", ()):
                self._push(float(ct), "coord_crash", None)

    def _on_coord_crash(self, now: float) -> None:
        """The coordinator process dies; a successor rebuilds itself from
        the ``/coord/journal/*`` keys.  The journal carries the complete
        planner-relevant state, so the successor's plans — and therefore
        the trace outcome — are identical to the crash-free run; the old
        incarnation is fenced out should it ever wake up."""
        if self.coord is None:
            return
        self.coord = UnicronCoordinator.recover(
            self.coord.kv, self.hw, plan_cache=self._plan_cache,
            n_cluster_workers=self._n_total, workers_per_node=self.gpn,
            plan_engine=self._plan_engine, device=self.device)

    # ---- main loop ---------------------------------------------------------

    def _resolve_span(self, trace: Trace,
                      span_s: Optional[float]) -> float:
        return _resolve_trace_span(trace, span_s)

    def _check_shape(self, trace: Trace) -> None:
        _check_trace_shape(trace, len(self.cluster.nodes), self.gpn)

    def run(self, trace: Trace, span_s: Optional[float] = None) -> SimResult:
        self._check_shape(trace)
        span = self._span = self._resolve_span(trace, span_s)
        self._heap = heap = self._event_heap(trace, span)
        self._push_crash_events()
        acc, last_t = 0.0, 0.0
        n_events = 0
        timeline: List[Tuple[float, float]] = [(0.0, self.cluster_waf(0.0))]
        while heap:
            t, _, kind, ev = heapq.heappop(heap)
            acc, last_t = self._integrate(acc, last_t, t)
            self._dispatch(t, kind, ev)
            n_events += 1
            timeline.append((t, self.cluster_waf(t)))
        acc, last_t = self._integrate(acc, last_t, span)
        timeline.append((span, self.cluster_waf(span)))
        return SimResult(self.policy, acc, timeline, self.n_reconfigs,
                         self.downtime, n_events, self.n_degraded_drains)

    def _integrate(self, acc: float, last_t: float,
                   t: float) -> Tuple[float, float]:
        """Integrate WAF piecewise up to t: block expiries and slow-window
        edges create breakpoints; each sub-segment is constant, so the
        midpoint sample is exact."""
        if t <= last_t:
            return acc, last_t
        breaks = {t}
        for st in self.tasks:
            if last_t < st.blocked_until < t:
                breaks.add(st.blocked_until)
            for start, end, _ in st.slow:
                if last_t < start < t:
                    breaks.add(start)
                if last_t < end < t:
                    breaks.add(end)
        for b in sorted(breaks):
            acc += self.cluster_waf((last_t + b) / 2) * (b - last_t)
            last_t = b
        return acc, last_t

    # ---- event handlers ----------------------------------------------------

    def _on_failure(self, now: float, ev: FailureEvent) -> None:
        node = ev.node % len(self.cluster.nodes)
        sev = ev.severity
        owner = self.cluster.placement.get(node)
        if owner is None:
            owners = [i for i, st in enumerate(self.tasks) if st.workers > 0]
            owner = owners[node % len(owners)] if owners else None
        if owner is None:
            return
        st = self.tasks[owner]
        detect = self._detect_s(ev.kind, st.avg_iter_s)
        # replica loss (SEV1 only): a correlated burst already took the
        # failed node's in-memory ring neighbor, so tier-aware restores
        # (unicron at dp==1, hierarchical_ckpt) demote to persistent
        replica_lost = False
        if sev is Severity.SEV1:
            nb = (node + 1) % len(self.cluster.nodes)
            replica_lost = not self.cluster.nodes[nb].healthy
        trans = self._transition_s(st, detect, sev,
                                   replica_lost=replica_lost)
        if sev is Severity.SEV1:
            if self.policy == "fftrainer":
                # the node is really lost, but a reserved spare (if any)
                # substitutes: capacity is constant (healthy-1, pool-1)
                # and the task keeps its workers; with the pool dry the
                # affected task shrinks like any baseline
                self.cluster.fail_node(node, now + (ev.repair_s or 0.0))
                if self.spares > 0:
                    self.spares -= 1
                    self.cluster.assign([t.workers for t in self.tasks])
                else:
                    self._reconfigure(now, owner)
                st.blocked_until = max(st.blocked_until, now + trans)
                self.downtime += trans
                return
            if self.spares > 0:
                # hot spare substitutes: capacity preserved, transition
                # (restart-from-checkpoint onto the spare) still paid
                self.spares -= 1
                st.blocked_until = max(st.blocked_until, now + trans)
                self.downtime += trans
                return
            self.cluster.fail_node(node, now + (ev.repair_s or 0.0))
            self._reconfigure(now, owner)
            st.blocked_until = max(st.blocked_until, now + trans)
            self.downtime += trans
        else:
            # SEV2/SEV3: restart/reattempt in place, no capacity change
            st.blocked_until = max(st.blocked_until, now + trans)
            self.downtime += trans

    def _on_repair(self, now: float, ev: FailureEvent) -> None:
        node = ev.node % len(self.cluster.nodes)
        if self.policy == "fftrainer":
            # the node really failed (unlike megatron's off-book spare):
            # recover it, then either refill the pool (capacity constant
            # again) or fund the down-scaled task's restore
            self.cluster.recover_node(node)
            if not any(st.affected_first for st in self.tasks):
                self.spares += 1
                self.cluster.assign([t.workers for t in self.tasks])
            else:
                self._node_rejoin(now)
            return
        if HOT_SPARES.get(self.policy, 0) and not any(
                st.affected_first for st in self.tasks):
            # no task was down-scaled: the repaired node refills
            # the spare pool instead of joining a task
            self.spares += 1
            return
        self.cluster.recover_node(node)
        self._node_rejoin(now)

    def _on_degradation(self, now: float, ev: DegradationEvent) -> None:
        """Slow node (§4.1): Unicron's statistical monitor flags anything
        past the 1.1x margin and drains the node through the real
        severity workflow (TASK_HANG -> failed restart -> SEV1); policies
        without in-band detection crawl at the slow worker's pace."""
        node = ev.node % len(self.cluster.nodes)
        owner = self.cluster.placement.get(node)
        if owner is None or not self.tasks[owner].active:
            return
        st = self.tasks[owner]
        flagged = int(self._fleet.statuses([owner],
                                           ev.slowdown * st.avg_iter_s)[0])
        in_band = self.policy == "unicron" and not self.ablate_detection
        if in_band and flagged:
            if self.coord is not None:
                case = f"degrade:{node}:{now}"
                self.coord.on_error(case, ErrorKind.TASK_HANG)
                self.coord.on_action_failed(case)   # restart can't fix slow
                self.coord.close_case(case)
            detect = self._detect_s(ErrorKind.TASK_HANG, st.avg_iter_s)
            trans = (self._transition_s(st, detect, Severity.SEV1)
                     + transition.RESPAWN_UNICRON_S)  # the failed restart
            self.cluster.fail_node(node, now + ev.duration_s)
            self._reconfigure(now, owner)
            st.blocked_until = max(st.blocked_until, now + trans)
            self.downtime += trans
            self.n_degraded_drains += 1
            self._push(now + ev.duration_s, "repair",
                       FailureEvent(time=now, node=node,
                                    kind=ErrorKind.LOST_CONNECTION,
                                    repair_s=ev.duration_s))
        else:
            st.slow.append((now, now + ev.duration_s, ev.slowdown))

    def _on_arrival(self, now: float, ev: TaskArrival) -> None:
        st = SimTask(task=ev.task, workers=0,
                     avg_iter_s=getattr(ev, "avg_iter_s", 30.0))
        self.tasks.append(st)
        self._fleet.grow(st.avg_iter_s)
        if self._use_planner():
            self.coord.task_launched(ev.task,
                                     self.cluster.healthy_workers())
            self._ci.append(len(self.coord.entries) - 1)
            self._apply_unicron_plan()
            self.n_reconfigs += 1
        else:
            # baselines: grant from the free pool, node-granular, capped
            # at the task's worker ceiling (workers past it would idle)
            self._ci.append(None)
            assigned = sum(t.workers for t in self.tasks)
            free = max(self._avail_workers() - assigned, 0)
            grant = min(ev.workers_hint, free)
            if ev.task.max_workers is not None:
                grant = min(grant, ev.task.max_workers)
            st.workers = grant - grant % self.gpn
        self.cluster.assign([t.workers for t in self.tasks])

    def _on_rate(self, now: float, ev: RateChangeEvent) -> None:
        """Reward-only objective swap (serving rate step): no workers
        move and no transition is charged — the slot's task is replaced
        so sampling/integration read the new reward rows, and the
        coordinator's lookahead tables refresh so the NEXT failure's
        replan trades against the current offered load."""
        if not 0 <= ev.slot < len(self.tasks):
            return
        st = self.tasks[ev.slot]
        if not st.active:
            return
        old = st.task
        new = dataclasses.replace(old, objective=ev.objective)
        if new == old:
            return
        st.task = new
        self._rate_log.append((now, ev.slot, old, new))
        if self._use_planner():
            ci = self._ci[ev.slot]
            if ci is not None:
                self.coord.task_updated(ci, new)

    def _on_finish(self, now: float, ev: TaskFinish) -> None:
        if not 0 <= ev.slot < len(self.tasks):
            return
        st = self.tasks[ev.slot]
        if not st.active:
            return
        st.active = False
        st.workers = 0
        if self._use_planner():
            ci = self._ci[ev.slot]
            self._ci[ev.slot] = None
            self.coord.task_finished(ci, self.cluster.healthy_workers())
            for slot, other in enumerate(self._ci):
                if other is not None and other > ci:
                    self._ci[slot] = other - 1
            self._apply_unicron_plan()
            self.n_reconfigs += 1
        else:
            self._ci[ev.slot] = None
        self.cluster.assign([t.workers for t in self.tasks])


class VectorSimulator(TraceSimulator):
    """Cluster-scale engine: the same decision handlers (and, through the
    lazy cached planner, float-identical plans) as ``TraceSimulator``, but

    * WAF accumulation is one vectorized numpy pass over the recorded
      worker/blocked/slow step functions instead of per-breakpoint Python;
    * the coordinator runs on a ``PlannerCache`` — lazy plan tables whose
      reward rows and prefix/suffix DPs are reused across rebuilds and,
      when the cache is shared via ``run_monte_carlo``, across seeds.

    Accumulated WAF matches the scalar reference loop up to float
    reordering (rel. ~1e-12; the benchmark asserts 1e-6).
    """

    def __init__(self, tasks: List[Task], assignment: List[int],
                 policy: str, hw=costmodel.A800, n_nodes: int = 16,
                 gpus_per_node: int = 8, *,
                 plan_cache: Optional[PlannerCache] = None,
                 plan_engine: str = "batched",
                 ablate_detection: bool = False,
                 ablate_transition: bool = False,
                 ablate_replan: bool = False,
                 chaos=None, device="cuda"):
        if policy == "unicron" and plan_cache is None:
            plan_cache = PlannerCache()
        super().__init__(tasks, assignment, policy, hw, n_nodes,
                         gpus_per_node, plan_cache=plan_cache,
                         plan_engine=plan_engine,
                         ablate_detection=ablate_detection,
                         ablate_transition=ablate_transition,
                         ablate_replan=ablate_replan,
                         chaos=chaos, device=device)

    def run(self, trace: Trace, span_s: Optional[float] = None) -> SimResult:
        self._check_shape(trace)
        span = self._span = self._resolve_span(trace, span_s)
        self._heap = heap = self._event_heap(trace, span)
        self._push_crash_events()
        snap_t: List[float] = [0.0]
        snap_w: List[List[int]] = [[st.workers for st in self.tasks]]
        blocks: List[Tuple[int, float, float]] = []  # (slot, start, until)
        n_events = 0
        while heap:
            t, _, kind, ev = heapq.heappop(heap)
            before = [st.blocked_until for st in self.tasks]
            was_active = ([st.active for st in self.tasks]
                          if kind == "finish" else None)
            self._dispatch(t, kind, ev)
            n_events += 1
            for slot, prev in enumerate(before):
                if self.tasks[slot].blocked_until > prev:
                    blocks.append((slot, t,
                                   self.tasks[slot].blocked_until))
            if was_active is not None:
                # a finished task produces no WAF ever again, even if a
                # later baseline rejoin hands its slot idle workers (the
                # scalar loop skips inactive tasks at sampling time)
                for slot, prev in enumerate(was_active):
                    if prev and not self.tasks[slot].active:
                        blocks.append((slot, t, float("inf")))
            snap_t.append(t)
            snap_w.append([st.workers for st in self.tasks])
        acc, timeline = self._integrate_vector(snap_t, snap_w, blocks, span)
        return SimResult(self.policy, acc, timeline, self.n_reconfigs,
                         self.downtime, n_events, self.n_degraded_drains)

    def _integrate_vector(self, snap_t: List[float],
                          snap_w: List[List[int]],
                          blocks: List[Tuple[int, float, float]],
                          span: float):
        """One numpy pass: segment boundaries from events + block expiries
        + slow-window edges; per-segment rates are a gather out of the
        (m, n+1) WAF matrix, masked by blocks, divided by slow factors.
        Rate events promote the matrix to an (E, m, n+1) epoch stack."""
        slows = [st.slow for st in self.tasks]
        if self._rate_log:
            epoch_t, F = _rate_epoch_stack(
                [st.task for st in self.tasks], self._rate_log,
                self._n_total, self.hw)
            return _integrate_segments(snap_t, snap_w, blocks, slows,
                                       span, F * self.eff, epoch_t=epoch_t)
        F = waf_mod.waf_matrix([st.task for st in self.tasks],
                               self._n_total, self.hw) * self.eff
        return _integrate_segments(snap_t, snap_w, blocks, slows, span, F)


class BatchSimulator:
    """Batched multi-policy engine: ONE event pass per trace carrying every
    recovery policy as stacked numpy state.

    Per-policy worker matrices, downtime vectors, blocked-until windows,
    spare pools, node-health/placement maps and WAF accumulators advance
    together: each event is decoded once, detection latencies come from
    the (kinds x policies) ``detection.detection_times`` lookup, transition
    durations from the (policy x component) ``transition.estimate_batch``
    matrix, slow-node checks from the ``detection.FleetMonitor`` ring
    buffer, and consequences land as array ops over the policy axis.
    Planner-backed lanes (``"unicron"``) drive the same lazily-cached
    ``UnicronCoordinator`` call sequence as the scalar reference loop, so
    plans — and therefore per-policy decisions — are identical to a
    per-policy ``TraceSimulator``/``VectorSimulator`` run; accumulated WAF
    agrees to float reordering (~1e-12; the benchmark asserts 1e-6).

    Component ablations stay on the per-policy engines — a lane here is a
    published policy, not an ablation variant."""

    def __init__(self, tasks: List[Task], assignment: List[int],
                 policies: Optional[List[str]] = None, hw=costmodel.A800,
                 n_nodes: int = 16, gpus_per_node: int = 8, *,
                 plan_cache: Optional[PlannerCache] = None,
                 plan_engine: str = "batched",
                 model_cache: Optional[Dict] = None, device="cuda"):
        """``model_cache``: share memoized detection/transition model rows
        across simulators (``run_monte_carlo`` passes one per sweep) —
        entries are keyed by task identity, kind and DP degree, so they
        are scenario-independent.  ``plan_engine``: the planner lanes'
        incremental PlanTable engine (see ``TraceSimulator``).
        ``device``: as for ``TraceSimulator``."""
        self.device = resolve_device(device)
        self.policies = list(policies or EFFICIENCY)
        P = len(self.policies)
        self.hw = hw
        self.n_nodes = n_nodes
        self.gpn = gpus_per_node
        self._n_total = n_nodes * gpus_per_node
        self._effs = np.array([EFFICIENCY[p] for p in self.policies])
        self._planner_lane = np.array([p == "unicron"
                                       for p in self.policies])
        self._planner_idx = [p for p, pol in enumerate(self.policies)
                             if pol == "unicron"]
        self._bamboo_lane = np.array([p == "bamboo"
                                      for p in self.policies])
        self._ckpt_lane = np.array(
            [p in transition.CKPT_RESTART_POLICIES for p in self.policies])
        self._fft_lane = np.array([p == "fftrainer"
                                   for p in self.policies])
        self._fft_set = {p for p, pol in enumerate(self.policies)
                         if pol == "fftrainer"}
        self._hier_lane = np.array([p == "hierarchical_ckpt"
                                    for p in self.policies])
        self._hier_idx = [p for p, pol in enumerate(self.policies)
                          if pol == "hierarchical_ckpt"]
        self._red_lane = np.array([p == "redundant"
                                   for p in self.policies])
        self._has_spares = [p in HOT_SPARES for p in self.policies]
        self._spares = [fftrainer_pool(n_nodes) if p == "fftrainer"
                        else HOT_SPARES.get(p, 0) for p in self.policies]
        self._tasks: List[Task] = list(tasks)
        M = len(self._tasks)
        self._avg = np.full(M, 30.0)              # SimTask.avg_iter_s
        self._sbytes = np.array([waf_mod.state_bytes(t)
                                 for t in self._tasks])
        self._workers = np.tile(np.asarray(assignment, dtype=np.int64),
                                (P, 1))
        for p in self._fft_set:
            # fftrainer lanes fund their reserved spare pool up front
            self._workers[p] = fit_assignment(
                list(assignment),
                (n_nodes - self._spares[p]) * gpus_per_node,
                gpus_per_node)
        self._blocked = [[0.0] * M for _ in range(P)]
        self._active = np.ones(M, dtype=bool)
        self._affected = np.zeros((P, M), dtype=bool)
        self._health = np.ones((P, n_nodes), dtype=bool)
        self._slows = [[[] for _ in range(M)] for _ in range(P)]
        # per lane: parallel (slots, starts, untils) lists of block windows
        self._blocks = [([], [], []) for _ in range(P)]
        self.n_reconfigs = np.zeros(P, dtype=np.int64)
        self._downtime = [0.0] * P
        self.n_degraded_drains = np.zeros(P, dtype=np.int64)
        self.n_events = np.zeros(P, dtype=np.int64)
        self._fleet = FleetMonitor.primed(self._avg)
        self._coords: Dict[int, UnicronCoordinator] = {}
        self._cis: Dict[int, List[Optional[int]]] = {}
        cache = plan_cache
        for p, pol in enumerate(self.policies):
            if pol != "unicron":
                continue
            if cache is None:
                cache = PlannerCache()
            self._coords[p] = UnicronCoordinator(
                list(tasks), list(assignment), hw, plan_cache=cache,
                n_cluster_workers=self._n_total,
                workers_per_node=gpus_per_node,
                plan_engine=plan_engine, device=self.device)
            self._cis[p] = list(range(M))
        P_range = list(range(P))
        self._all_list = P_range
        self._all_lanes = np.ones(P, dtype=bool)
        self._n_healthy = [n_nodes] * P          # healthy-node counters
        self._healthy_ids: List[Optional[np.ndarray]] = [None] * P
        self._cums: List[Optional[np.ndarray]] = [None] * P
        self._assigned = [int(self._workers[p].sum()) for p in range(P)]
        self._aff_count = [0] * P
        self._reconfigs = [0] * P
        self._kind_T: Dict[ErrorKind, np.ndarray] = {}
        shared = model_cache if model_cache is not None else {}
        self._uni_cache = shared.setdefault("uni", {})
        self._class_cache = shared.setdefault("class", {})
        # intern tasks once: model-cache keys hash small ints per event,
        # not task dataclasses (a Task hash cascades through its model)
        sigs = shared.setdefault("task_ids", {})
        self._tids = [sigs.setdefault(t, len(sigs)) for t in self._tasks]
        self._task_sigs = sigs
        self._heap: List[tuple] = []
        self._seq = 0
        self._span = float("inf")
        self._mutated = False
        # objective swaps applied so far: (time, slot, old_task, new_task)
        self._rate_log: List[Tuple[float, int, Task, Task]] = []

    # ---- per-lane cluster state -------------------------------------------

    def _healthy_workers(self, p: int) -> int:
        return self._n_healthy[p] * self.gpn

    def _avail_lane(self, p: int) -> int:
        """Assignable capacity: healthy workers minus the lane's
        reserved fftrainer spare pool (scalar ``_avail_workers``)."""
        avail = self._n_healthy[p] * self.gpn
        if p in self._fft_set:
            avail -= self._spares[p] * self.gpn
        return avail

    def _fail_node(self, p: int, node: int) -> None:
        if self._health[p, node]:
            self._health[p, node] = False
            self._n_healthy[p] -= 1
            ids = self._healthy_ids[p]
            if ids is not None:
                ids.pop(bisect_left(ids, node))

    def _recover_node(self, p: int, node: int) -> None:
        if not self._health[p, node]:
            self._health[p, node] = True
            self._n_healthy[p] += 1
            ids = self._healthy_ids[p]
            if ids is not None:
                ids.insert(bisect_left(ids, node), node)

    def _owner_list(self, node: int) -> List[int]:
        """Per-policy owner of ``node`` (-1 = free/unhealthy), computed by
        rank instead of materializing placement maps: ``Cluster.assign``
        packs tasks in index order onto healthy nodes in id order, so the
        owner of the node at healthy-rank r is the first task whose
        cumulative node need exceeds r."""
        out = []
        for p in self._all_list:
            ids = self._healthy_ids[p]
            if ids is None:
                ids = self._healthy_ids[p] = \
                    np.flatnonzero(self._health[p]).tolist()
            r = bisect_left(ids, node)
            if r >= len(ids) or ids[r] != node:
                out.append(-1)                  # unhealthy: no owner
                continue
            cums = self._cums[p]
            if cums is None:
                acc, cums = 0, []
                for x in self._workers[p].tolist():
                    acc += x // self.gpn
                    cums.append(acc)
                self._cums[p] = cums
            if not cums or r >= cums[-1]:
                out.append(-1)                  # past the assigned span
            else:
                out.append(bisect_right(cums, r))
        return out

    def _apply_plan(self, p: int) -> None:
        coord, cis = self._coords[p], self._cis[p]
        w = self._workers[p]
        entries = coord.entries
        vals = np.array([-1 if ci is None else entries[ci].n_workers
                         for ci in cis], dtype=np.int64)
        upd = vals >= 0
        w[upd] = vals[upd]
        self._assigned[p] = int(w.sum())
        self._cums[p] = None
        self._mutated = True

    def _reconfigure_lane(self, p: int, faulted: Optional[int]) -> None:
        n_avail = self._avail_lane(p)
        self._reconfigs[p] += 1
        if p in self._coords:
            ft = self._cis[p][faulted] if faulted is not None else None
            self._coords[p].reconfigure(n_avail, ft)
            self._apply_plan(p)
        elif faulted is not None:
            # baselines only touch the directly-affected task
            w = self._workers[p]
            old = int(w[faulted])
            grant = max(0, min(old, n_avail - (self._assigned[p] - old)))
            grant -= grant % self.gpn
            w[faulted] = grant
            self._assigned[p] += grant - old
            self._cums[p] = None
            self._mutated = True
            if not self._affected[p, faulted]:
                self._affected[p, faulted] = True
                self._aff_count[p] += 1

    def _rejoin_lane(self, p: int) -> None:
        n_avail = self._avail_lane(p)
        self._reconfigs[p] += 1
        if p in self._coords:
            self._coords[p].reconfigure(n_avail, None,
                                        trigger=Trigger.NODE_JOIN)
            self._apply_plan(p)
        elif self._aff_count[p] and n_avail - self._assigned[p] >= self.gpn:
            # restore the first-affected task toward its original size
            aff = self._affected[p]
            slot = int(aff.argmax())
            self._workers[p, slot] += self.gpn
            self._assigned[p] += self.gpn
            self._cums[p] = None
            self._mutated = True
            aff[slot] = False
            self._aff_count[p] -= 1

    # ---- array-native per-event models ------------------------------------

    def _class_matrix(self, kind: ErrorKind) -> np.ndarray:
        """(policy, task) transition-total matrix for one error kind,
        built lazily from one ``estimate_batch`` call per recovery class
        over the task axis (policies of one class share every formula
        input except the owner task) and cached per (kind, task,
        avg_iter_s) in the shared model cache — the iteration time is in
        the key because the same task may be re-admitted with a
        different hint, and the in-band rows scale with it — so churn
        only computes the admitted task's column.  Planner-lane rows are placeholders — their totals depend
        on the live DP degree and are overwritten per event by
        ``_trans_row``."""
        T = self._kind_T.get(kind)
        if T is None:
            M = len(self._tasks)
            cache = self._class_cache
            missing = [i for i in range(M)
                       if (kind, self._tids[i], float(self._avg[i]))
                       not in cache]
            if missing:
                k = len(missing)
                sb = self._sbytes[missing]
                avg = self._avg[missing]
                det = detection_times([kind], avg,
                                      np.zeros(k, dtype=bool))[0]
                det_in = detection_times([kind], avg,
                                         np.ones(k, dtype=bool))[0]
                ckpt = transition.batch_total(transition.estimate_batch(
                    ["megatron"] * k, sb, avg, 1, det))
                dyn = transition.batch_total(transition.estimate_batch(
                    ["oobleck"] * k, sb, avg, 1, det))
                fft = transition.batch_total(transition.estimate_batch(
                    ["fftrainer"] * k, sb, avg, 1, det_in))
                hier = transition.batch_total(transition.estimate_batch(
                    ["hierarchical_ckpt"] * k, sb, avg, 1, det_in))
                hier_l = transition.batch_total(transition.estimate_batch(
                    ["hierarchical_ckpt"] * k, sb, avg, 1, det_in,
                    replica_lost=True))
                for j, i in enumerate(missing):
                    cache[(kind, self._tids[i], float(avg[j]))] = (
                        float(ckpt[j]), float(dyn[j]), float(fft[j]),
                        float(hier[j]), float(hier_l[j]))
            vals = [cache[(kind, tid, float(a))]
                    for tid, a in zip(self._tids, self._avg)]
            ckpt_v = np.array([v[0] for v in vals])
            dyn_v = np.array([v[1] for v in vals])
            fft_v = np.array([v[2] for v in vals])
            hier_v = np.array([v[3] for v in vals])
            if classify(kind)[1] is not Severity.SEV1:
                # bamboo's redundancy rides through SEV2/3 failures
                dyn_bam = np.zeros(M)
            else:
                dyn_bam = dyn_v
            # hierarchical rows bake replica_lost=False; ``_trans_row``
            # overrides a lane from the cache's tier-demoted totals when
            # the event really took the ring neighbor too.  redundant
            # rows are identically zero (continuation).
            T = np.where(
                self._ckpt_lane[:, None], ckpt_v[None, :],
                np.where(self._bamboo_lane[:, None], dyn_bam[None, :],
                         np.where(self._fft_lane[:, None], fft_v[None, :],
                                  np.where(self._hier_lane[:, None],
                                           hier_v[None, :],
                                           np.where(self._red_lane[:, None],
                                                    0.0,
                                                    dyn_v[None, :])))))
            self._kind_T[kind] = T
        return T

    def _trans_row(self, kind: ErrorKind, owners: List[int],
                   rl: Optional[np.ndarray] = None) -> List[float]:
        """Detection + transition totals per policy: one gather out of the
        per-kind (policy, task) class matrix, with planner lanes filled
        from a (kind, owner, dp, replica_lost)-memoized
        ``estimate_unicron`` total — state sizes and iteration times are
        fixed per task, so those keys pin every input of the scalar
        formulas.  ``rl`` is the per-lane replica-loss vector (SEV1
        events only): hierarchical lanes swap to the cache's
        tier-demoted totals, planner lanes carry it into the key."""
        T = self._class_matrix(kind)
        tot = [T[p, o if o >= 0 else 0] for p, o in enumerate(owners)]
        if rl is not None:
            for p in self._hier_idx:
                if rl[p]:
                    o = owners[p] if owners[p] >= 0 else 0
                    tot[p] = self._class_cache[
                        (kind, self._tids[o], float(self._avg[o]))][4]
        for p in self._planner_idx:
            o = owners[p]
            if o < 0:
                o = 0
            dp = int(self._workers[p, o]) // 8
            rl_p = bool(rl[p]) if rl is not None else False
            # the key carries the slot's iteration time too: the same Task
            # may be admitted with different avg_iter_s hints, and both
            # detection and recompute scale with it
            ukey = (kind, self._tids[o], dp, float(self._avg[o]), rl_p)
            val = self._uni_cache.get(ukey)
            if val is None:
                det = detection_time(kind, float(self._avg[o]),
                                     unicron=True)
                val = transition.estimate_unicron(
                    float(self._sbytes[o]), float(self._avg[o]),
                    dp_degree=max(dp, 1), detect_s=det,
                    lookup_hit=True, replica_lost=rl_p).total
                self._uni_cache[ukey] = val
            tot[p] = val
        return tot

    def _block_and_charge(self, now: float, lanes: List[int],
                          owners: List[int],
                          trans: List[float]) -> None:
        downtime = self._downtime
        for p in lanes:
            slot = owners[p]
            tr = trans[p]
            row = self._blocked[p]
            until = now + tr
            if until > row[slot]:
                row[slot] = until
                bs, bt, bu = self._blocks[p]
                bs.append(slot)
                bt.append(now)
                bu.append(until)
            downtime[p] += tr

    # ---- event handlers ----------------------------------------------------

    def _on_failure(self, now: float, ev: FailureEvent,
                    mask: np.ndarray) -> None:
        node = ev.node % self.n_nodes
        owners = self._owner_list(node)
        if -1 in owners:
            # unplaced node: round-robin over tasks with workers
            for p in self._all_list:
                if owners[p] < 0 and mask[p]:
                    cand = np.flatnonzero(self._workers[p] > 0)
                    owners[p] = (int(cand[node % cand.size])
                                 if cand.size else -1)
        if mask is self._all_lanes:
            valid = [p for p in self._all_list if owners[p] >= 0]
        else:
            valid = [p for p in self._all_list
                     if mask[p] and owners[p] >= 0]
        if not valid:
            return
        rl = None
        if ev.severity is Severity.SEV1:
            # replica loss per lane: the in-memory ring neighbor of the
            # failed node is already unhealthy (read BEFORE this event's
            # fail lands, matching the scalar reference)
            nb = (node + 1) % self.n_nodes
            rl = ~self._health[:, nb]
        trans = self._trans_row(ev.kind, owners, rl)
        if ev.severity is Severity.SEV1:
            # hot spare substitutes: capacity preserved, transition still
            # paid; everyone else drains the node and replans.  fftrainer
            # really loses the node and burns a reserved spare (healthy-1,
            # pool-1: assignable capacity constant) until the pool is dry
            spares = self._spares
            for p in valid:
                if p in self._fft_set:
                    self._fail_node(p, node)
                    if spares[p] > 0:
                        spares[p] -= 1
                    else:
                        self._reconfigure_lane(p, owners[p])
                elif spares[p] > 0:
                    spares[p] -= 1
                else:
                    self._fail_node(p, node)
                    self._reconfigure_lane(p, owners[p])
        self._block_and_charge(now, valid, owners, trans)

    def _on_repair(self, now: float, ev: FailureEvent,
                   mask: np.ndarray) -> None:
        node = ev.node % self.n_nodes
        lanes = (self._all_list if mask is self._all_lanes
                 else np.flatnonzero(mask).tolist())
        for p in lanes:
            if p in self._fft_set:
                # the node really failed: recover it, then refill the
                # pool (capacity constant) or fund the affected task
                self._recover_node(p, node)
                if not self._aff_count[p]:
                    self._spares[p] += 1
                else:
                    self._rejoin_lane(p)
                continue
            if self._has_spares[p] and not self._aff_count[p]:
                # no task was down-scaled: the repaired node refills
                # the spare pool instead of joining a task
                self._spares[p] += 1
                continue
            self._recover_node(p, node)
            self._rejoin_lane(p)

    def _on_degradation(self, now: float, ev: DegradationEvent,
                        mask: np.ndarray) -> None:
        node = ev.node % self.n_nodes
        owners = self._owner_list(node)
        valid = [p for p in self._all_list
                 if mask[p] and owners[p] >= 0 and self._active[owners[p]]]
        if not valid:
            return
        o_arr = np.array([owners[p] for p in valid])
        codes = self._fleet.statuses(o_arr, ev.slowdown * self._avg[o_arr])
        drain = set()
        for i, p in enumerate(valid):
            if codes[i] and self._planner_lane[p]:
                drain.add(p)
        for p in drain:
            owner = owners[p]
            coord = self._coords[p]
            case = f"degrade:{node}:{now}"
            coord.on_error(case, ErrorKind.TASK_HANG)
            coord.on_action_failed(case)       # restart can't fix slow
            coord.close_case(case)
            avg = float(self._avg[owner])
            det = detection_time(ErrorKind.TASK_HANG, avg, unicron=True)
            dp = max(int(self._workers[p, owner]) // 8, 1)
            cost = transition.estimate_batch(
                ["unicron"], self._sbytes[owner], avg, dp, det)
            trans = (float(transition.batch_total(cost)[0])
                     + transition.RESPAWN_UNICRON_S)  # the failed restart
            self._fail_node(p, node)
            self._reconfigure_lane(p, owner)
            tr = [0.0] * len(self.policies)
            tr[p] = trans
            self._block_and_charge(now, [p], owners, tr)
            self.n_degraded_drains[p] += 1
            one = np.zeros(len(self.policies), dtype=bool)
            one[p] = True
            self._push(now + ev.duration_s, "repair",
                       FailureEvent(time=now, node=node,
                                    kind=ErrorKind.LOST_CONNECTION,
                                    repair_s=ev.duration_s), one)
        for p in valid:
            if p not in drain:
                self._slows[p][owners[p]].append(
                    (now, now + ev.duration_s, ev.slowdown))

    def _on_arrival(self, now: float, ev: TaskArrival,
                    mask: np.ndarray) -> None:
        P = len(self.policies)
        avg = getattr(ev, "avg_iter_s", 30.0)
        self._tasks.append(ev.task)
        self._avg = np.append(self._avg, avg)
        self._sbytes = np.append(self._sbytes,
                                 waf_mod.state_bytes(ev.task))
        self._active = np.append(self._active, True)
        self._workers = np.concatenate(
            [self._workers, np.zeros((P, 1), dtype=np.int64)], axis=1)
        for row in self._blocked:
            row.append(0.0)
        self._affected = np.concatenate(
            [self._affected, np.zeros((P, 1), dtype=bool)], axis=1)
        for p in range(P):
            self._slows[p].append([])
        self._fleet.grow(avg)
        self._tids.append(self._task_sigs.setdefault(ev.task,
                                                     len(self._task_sigs)))
        self._kind_T.clear()                   # task axis grew a column
        slot = len(self._tasks) - 1
        lanes = (self._all_list if mask is self._all_lanes
                 else np.flatnonzero(mask).tolist())
        for p, coord in self._coords.items():
            if p not in lanes:
                continue
            coord.task_launched(ev.task, self._healthy_workers(p),
                                avg_iter_s=avg)
            self._cis[p].append(len(coord.entries) - 1)
            self._apply_plan(p)
            self._reconfigs[p] += 1
        blane_list = [p for p in lanes if not self._planner_lane[p]]
        if blane_list:
            # baselines: grant from the free pool, node-granular, capped
            assigned = np.array([self._assigned[p] for p in blane_list])
            avail = np.array([self._avail_lane(p) for p in blane_list])
            grant = np.minimum(ev.workers_hint,
                               np.maximum(avail - assigned, 0))
            if ev.task.max_workers is not None:
                grant = np.minimum(grant, ev.task.max_workers)
            grant -= grant % self.gpn
            self._workers[blane_list, slot] = grant
            for p, g in zip(blane_list, grant):
                self._assigned[p] += int(g)
        for p in self._all_list:
            self._cums[p] = None          # the task axis grew a slot
        self._mutated = True

    def _on_finish(self, now: float, ev: TaskFinish,
                   mask: np.ndarray) -> None:
        if not 0 <= ev.slot < len(self._tasks):
            return
        if not self._active[ev.slot]:
            return
        self._active[ev.slot] = False
        lanes = (self._all_list if mask is self._all_lanes
                 else np.flatnonzero(mask).tolist())
        old = self._workers[:, ev.slot]
        for p in lanes:
            self._assigned[p] -= int(old[p])
            self._cums[p] = None
            # finished tasks produce no WAF ever again, even if a later
            # baseline rejoin hands the slot idle workers (scalar skips
            # inactive tasks at sampling time)
            bs, bt, bu = self._blocks[p]
            bs.append(ev.slot)
            bt.append(now)
            bu.append(float("inf"))
        self._workers[lanes, ev.slot] = 0
        self._mutated = True
        for p, coord in self._coords.items():
            if p not in lanes:
                continue
            cis = self._cis[p]
            ci = cis[ev.slot]
            cis[ev.slot] = None
            coord.task_finished(ci, self._healthy_workers(p))
            for s, other in enumerate(cis):
                if other is not None and other > ci:
                    cis[s] = other - 1
            self._apply_plan(p)
            self._reconfigs[p] += 1

    def _on_rate(self, now: float, ev: RateChangeEvent,
                 mask: np.ndarray) -> None:
        """Reward-only objective swap (see ``TraceSimulator._on_rate``).
        The task list is shared across lanes, so a rate step always
        applies fleet-wide; only planner lanes carry extra state (their
        coordinators' lookahead tables refresh for the next replan)."""
        if not 0 <= ev.slot < len(self._tasks):
            return
        if not self._active[ev.slot]:
            return
        old = self._tasks[ev.slot]
        new = dataclasses.replace(old, objective=ev.objective)
        if new == old:
            return
        self._tasks[ev.slot] = new
        self._sbytes[ev.slot] = waf_mod.state_bytes(new)
        self._tids[ev.slot] = self._task_sigs.setdefault(
            new, len(self._task_sigs))
        self._kind_T.clear()               # transition column changed
        self._rate_log.append((now, ev.slot, old, new))
        lanes = (self._all_list if mask is self._all_lanes
                 else np.flatnonzero(mask).tolist())
        for p, coord in self._coords.items():
            if p not in lanes:
                continue
            ci = self._cis[p][ev.slot]
            if ci is not None:
                coord.task_updated(ci, new)

    # ---- main loop ---------------------------------------------------------

    def _push(self, t: float, kind: str, payload: object,
              lanes: np.ndarray) -> None:
        if t <= self._span:
            self._seq += 1
            heapq.heappush(self._heap, (t, self._seq, kind, payload, lanes))

    def _dispatch(self, now: float, kind: str, ev: object,
                  mask: np.ndarray) -> None:
        if kind == "fail":
            self._on_failure(now, ev, mask)
        elif kind == "repair":
            self._on_repair(now, ev, mask)
        elif kind == "degrade":
            self._on_degradation(now, ev, mask)
        elif kind == "arrive":
            self._on_arrival(now, ev, mask)
        elif kind == "finish":
            self._on_finish(now, ev, mask)
        elif kind == "rate":
            self._on_rate(now, ev, mask)

    def run(self, trace: Trace,
            span_s: Optional[float] = None) -> Dict[str, SimResult]:
        _check_trace_shape(trace, self.n_nodes, self.gpn)
        span = self._span = _resolve_trace_span(trace, span_s)
        entries, self._seq = _event_entries(trace, span)
        self._heap = [(t, s, k, p, None) for t, s, k, p in entries]
        heapq.heapify(self._heap)
        all_lanes = self._all_lanes
        n_shared = 0
        snap_t: List[float] = [0.0]
        snaps: List[np.ndarray] = [self._workers.copy()]
        event_t: List[float] = []
        while self._heap:
            t, _, kind, ev, lanes = heapq.heappop(self._heap)
            if lanes is None:
                self._dispatch(t, kind, ev, all_lanes)
                n_shared += 1
            else:
                self._dispatch(t, kind, ev, lanes)
                self.n_events += lanes
            event_t.append(t)
            if self._mutated:               # workers changed: new step
                snap_t.append(t)
                snaps.append(self._workers.copy())
                self._mutated = False
        self.n_events += n_shared
        self.n_reconfigs = np.array(self._reconfigs, dtype=np.int64)
        self.downtime = np.array(self._downtime)
        if self._rate_log:
            epoch_t, F = _rate_epoch_stack(self._tasks, self._rate_log,
                                           self._n_total, self.hw)
        else:
            epoch_t = None
            F = waf_mod.waf_matrix(self._tasks, self._n_total, self.hw)
        accs, timelines = _integrate_policies(snap_t, snaps, self._blocks,
                                              self._slows, span, F,
                                              self._effs, event_t,
                                              epoch_t=epoch_t)
        return {pol: SimResult(pol, float(accs[p]), timelines[p],
                               self._reconfigs[p],
                               self._downtime[p],
                               int(self.n_events[p]),
                               int(self.n_degraded_drains[p]))
                for p, pol in enumerate(self.policies)}


def run_policies(tasks: List[Task], assignment: List[int],
                 trace: Trace,
                 policies: Optional[List[str]] = None,
                 hw=costmodel.A800, device="cuda") -> Dict[str, SimResult]:
    """One ``TraceSimulator`` run per policy over ``trace`` (Fig. 11b/d);
    ``device`` as for ``TraceSimulator``."""
    device = resolve_device(device)
    out = {}
    for p in policies or list(EFFICIENCY):
        sim = TraceSimulator(tasks, list(assignment), p, hw, device=device)
        out[p] = sim.run(trace)
    return out


def _mc_result(policy: str, results: List[SimResult],
               wall: float) -> MonteCarloResult:
    wafs = [r.accumulated_waf for r in results]
    arr = np.array(wafs)
    return MonteCarloResult(policy, float(arr.mean()), float(arr.std()),
                            wafs, wall,
                            sum(r.n_reconfigs for r in results),
                            sum(r.downtime_s for r in results))


def run_monte_carlo(tasks: List[Task], assignment: List[int],
                    scenario_fn, seeds, policies: Optional[List[str]] = None,
                    hw=costmodel.A800, n_nodes: int = 16,
                    gpus_per_node: int = 8,
                    plan_cache: Optional[PlannerCache] = None,
                    threads: Optional[int] = None,
                    engine: str = "batched",
                    plan_engine: str = "batched", device="cuda"
                    ) -> Dict[str, MonteCarloResult]:
    """Batched Monte-Carlo sweep: ``scenario_fn(seed)`` generates one
    seeded ``ClusterScenario`` per seed; all runs share ONE
    ``PlannerCache`` — a cluster state reached in any seed is never
    re-planned in another.

    ``engine="batched"`` (default) runs each seed ONCE through
    ``BatchSimulator`` with every policy stacked on the policy axis; each
    policy's ``wall_s`` is its even share of the joint pass, so suite
    totals still sum correctly.  ``engine="vector"`` keeps the
    per-(policy, seed) ``VectorSimulator`` path — the measured baseline
    of the batched engine.  Both produce identical decisions (shared
    planner) and WAF totals equal to float reordering.

    ``threads`` applies to the vector engine only — with
    ``engine="vector"``, seeds of one policy may run on a thread pool
    (numpy's convolutions release the GIL): results are deterministic
    regardless of scheduling because every cache entry is fully
    determined by its key.  The batched engine is one sequential pass
    per seed and ignores ``threads``.

    ``plan_engine`` selects the planner lanes' incremental PlanTable
    engine (``"batched"`` default — level-synchronous stacked merges
    with lazy traceback, the cold-path win ``bench_cluster_sim``'s
    ``cold_*_wall_s`` columns measure; ``"segtree"``/``"chain"`` keep
    the per-merge baselines).  Plans are float-identical across
    engines, so WAF totals do not depend on the choice.

    ``device``: as for ``TraceSimulator``.  ``threads > 1`` runs on the
    CPU only and raises for CUDA: the kernels' launch counters and the
    fused engine's CUDA graph captures are not safe across host threads,
    and a serial run in their place would hide that."""
    device = resolve_device(device)
    if engine not in ("batched", "vector"):
        raise ValueError(f"unknown Monte-Carlo engine {engine!r}")
    if engine == "vector" and (threads or 1) > 1 and device.type == "cuda":
        raise ValueError(f"run_monte_carlo: threads={threads} on "
                         f"{device}; seeds run on host threads on the CPU "
                         f"only")
    cache = plan_cache if plan_cache is not None else PlannerCache()
    scenarios = [scenario_fn(s) for s in seeds]
    pols = list(policies or EFFICIENCY)
    out: Dict[str, MonteCarloResult] = {}

    if engine == "batched":
        per_policy: Dict[str, List[SimResult]] = {p: [] for p in pols}
        model_cache: Dict = {}
        t0 = _time.perf_counter()
        for sc in scenarios:
            sim = BatchSimulator(tasks, list(assignment), pols, hw,
                                 n_nodes=n_nodes,
                                 gpus_per_node=gpus_per_node,
                                 plan_cache=cache,
                                 plan_engine=plan_engine,
                                 model_cache=model_cache, device=device)
            for p, res in sim.run(sc).items():
                per_policy[p].append(res)
        share = (_time.perf_counter() - t0) / max(len(pols), 1)
        return {p: _mc_result(p, per_policy[p], share) for p in pols}

    # engine == "vector": per-(policy, seed) runs over the shared cache.
    # Sequential by default: on few-core hosts the GIL-held decision glue
    # plus duplicated cold builds outweigh the parallel convolutions.
    n_threads = threads or 1

    def one(policy, scenario):
        sim = VectorSimulator(tasks, list(assignment), policy, hw,
                              n_nodes=n_nodes,
                              gpus_per_node=gpus_per_node,
                              plan_cache=cache,
                              plan_engine=plan_engine, device=device)
        return sim.run(scenario)

    for p in pols:
        t0 = _time.perf_counter()
        if n_threads > 1 and len(scenarios) > 1:
            with ThreadPoolExecutor(max_workers=n_threads) as pool:
                results = list(pool.map(lambda sc: one(p, sc), scenarios))
        else:
            results = [one(p, sc) for sc in scenarios]
        out[p] = _mc_result(p, results, _time.perf_counter() - t0)
    return out
