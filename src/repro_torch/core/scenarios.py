"""Failure-scenario library — seeded, parameterized cluster traces.
Copied from ``repro/core/scenarios.py``: the same seed makes the same
events as the reference's generators, draw for draw.

Each generator returns a :class:`ClusterScenario` whose events all flow
through the real detection -> severity -> planner -> transition path in
``core.simulator``.  Mapping to the paper and the related fleet studies
(PAPERS.md):

``independent_failures``
    Per-node Poisson faults with the §2.2 severity mix (73% transient) —
    the generalization of the §7.5 trace-a/trace-b workloads behind
    Fig. 11, scaled to arbitrary (nodes, span, MTBF).
``correlated_failures``
    Switch/rack-domain bursts: every failure in a burst lands inside one
    node group and the group returns together, the dominant correlated
    mode in ByteDance's robust-training report and Meta's reliability
    characterization.
``slow_nodes``
    Slow-node degradation feeding the §4.1 online statistical monitor
    (Fig. 6): a sub-3x slowdown is invisible to baseline watchdogs but
    trips Unicron's 1.1x degradation margin.
``preemption_waves``
    Spot/preemption waves: a fraction of nodes is reclaimed at once and
    re-provisioned later — beyond the paper, standard in spot fleets.
``task_churn``
    Multi-task join/finish churn, the Figure 7 reconfiguration triggers
    (5) task finished and (6) task launched at cluster scale (§5.2).
``diurnal_load`` / ``traffic_spikes``
    Request-rate traces for serving tasks (``waf.ServingSLO``): a
    sinusoidal day/night cycle sampled as piecewise-constant steps, and
    short multiplicative traffic spikes.  Each step is a
    :class:`RateChangeEvent` that swaps the slot's objective (rate only;
    workers are untouched), so the planner's next failure replan trades
    training WAF against the *current* serving goodput.
``mixed_fleet``
    All of the above superimposed — the §7.5-style multi-task sweep at
    (n=1024, m=32) that ``benchmarks/bench_cluster_sim.py`` reproduces.
``calibrated_failures`` / ``calibrated_slow_nodes`` /
``calibrated_bursts`` / ``calibrated_preemption`` / ``calibrated_fleet``
    The trace-calibrated family: rates and category mixes come from the
    committed :mod:`repro_torch.core.calibration` tables instead of free
    parameters.  Per-category event rates (NVLink / ECC / NIC-class
    hardware, software crashes, transient network, hangs), SEV1 repair
    ranges, slow-node and correlated-burst rates, and the 1/n
    MTTF-vs-fleet-size scaling are pinned to the Acme datacenter
    characterization (arXiv 2403.07648) and Meta's reliability study
    (arXiv 2410.21680) — see ``calibration.py`` for the provenance of
    every number.  ``tests/test_calibration.py`` statistically asserts
    the generated streams match the tables (Poisson counts, category
    shares, exponential inter-arrival KS, MTTF scaling), and
    ``benchmarks/bench_frontier.py`` drives the recovery-policy
    cost/WAF frontier over ``calibrated_fleet`` traces.
``chaos_schedule`` / ``chaos_suite``
    Control-plane fault schedules (``core.chaos.ChaosSchedule``): message
    drop / delayed visibility / duplication, per-node partition windows,
    and scheduled coordinator crashes — the transport- and
    coordinator-level faults the ByteDance and Meta fleet reports put
    above hardware faults in operational pain.  Partition windows are
    placed sequentially with heal slack and away from caller-supplied
    ``avoid`` windows (the reference's ``chaos.world_windows``), which is what makes the
    chaos convergence property (``tests/test_chaos.py``) decidable.

Generators draw from ``numpy.random.default_rng(seed)`` only: identical
seeds produce identical scenarios, and batches of Monte-Carlo seeds are
vectorized draws, not per-event Python loops.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.calibration import (DEFAULT_CALIBRATION,
                                          FleetCalibration)
from repro_torch.core.chaos import ChaosSchedule
from repro_torch.core.detection import ErrorKind
from repro_torch.core.traces import (DAY, NON_SEV1_KINDS, SEV1_KINDS,
                                     FailureEvent, poisson_times,
                                     sample_kinds)
from repro_torch.core.waf import Objective, ServingSLO, Task


@dataclass(frozen=True)
class DegradationEvent:
    """A node turns slow (not dead): iteration time inflates by
    ``slowdown`` for ``duration_s`` seconds (§4.1 / Fig. 6)."""
    time: float
    node: int
    slowdown: float            # iteration-time multiplier, >= 1
    duration_s: float


@dataclass(frozen=True)
class TaskArrival:
    """A new task is admitted to the cluster (Figure 7 trigger 6)."""
    time: float
    task: Task
    workers_hint: int = 0      # baseline policies grant min(hint, free)
    avg_iter_s: float = 30.0   # steady-state iteration time hint


@dataclass(frozen=True)
class TaskFinish:
    """Task in simulator slot ``slot`` completes (Figure 7 trigger 5)."""
    time: float
    slot: int


@dataclass(frozen=True)
class RateChangeEvent:
    """The offered load of the task in simulator slot ``slot`` changes:
    the slot's task swaps to an identical task carrying ``objective``
    (typically a :class:`~repro_torch.core.waf.ServingSLO` at a new
    ``rate_rps``).  Reward-only — no workers move, no transition cost is
    paid, and no replan is triggered; the updated reward rows simply
    shape the planner's *next* reconfiguration."""
    time: float
    slot: int
    objective: Objective


@dataclass(frozen=True)
class NodeGroups:
    """Failure domains (switch/rack): ``groups[g]`` lists node ids that
    share fate under a correlated failure."""
    groups: Tuple[Tuple[int, ...], ...]

    @classmethod
    def contiguous(cls, n_nodes: int, group_size: int) -> "NodeGroups":
        return cls(tuple(
            tuple(range(lo, min(lo + group_size, n_nodes)))
            for lo in range(0, n_nodes, group_size)))

    def group_of(self, node: int) -> int:
        for gi, g in enumerate(self.groups):
            if node in g:
                return gi
        raise ValueError(f"node {node} not in any group")


@dataclass
class ClusterScenario:
    """One seeded cluster trace: failures + degradations + task churn."""
    name: str
    n_nodes: int
    gpus_per_node: int
    span_s: float
    failures: List[FailureEvent] = field(default_factory=list)
    degradations: List[DegradationEvent] = field(default_factory=list)
    churn: List[object] = field(default_factory=list)   # TaskArrival/Finish
    groups: Optional[NodeGroups] = None
    seed: Optional[int] = None

    def merged(self, other: "ClusterScenario",
               name: Optional[str] = None) -> "ClusterScenario":
        assert (self.n_nodes, self.gpus_per_node) == \
            (other.n_nodes, other.gpus_per_node)
        return ClusterScenario(
            name=name or f"{self.name}+{other.name}",
            n_nodes=self.n_nodes, gpus_per_node=self.gpus_per_node,
            span_s=max(self.span_s, other.span_s),
            failures=sorted(self.failures + other.failures,
                            key=lambda e: e.time),
            degradations=sorted(self.degradations + other.degradations,
                                key=lambda e: e.time),
            churn=sorted(self.churn + other.churn, key=lambda e: e.time),
            groups=self.groups or other.groups, seed=self.seed)

    @property
    def n_events(self) -> int:
        return (len(self.failures) + len(self.degradations)
                + len(self.churn))


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------


def independent_failures(*, n_nodes: int, span_s: float, seed: int,
                         gpus_per_node: int = 8,
                         mtbf_node_s: float = 60 * DAY,
                         sev1_fraction: float = 0.27,
                         repair_s: Tuple[float, float] = (2 * 3600.0,
                                                          12 * 3600.0)
                         ) -> ClusterScenario:
    """Per-node Poisson faults, §2.2 mix (default 27% SEV1 node loss)."""
    rng = np.random.default_rng(seed)
    times = poisson_times(rng, n_nodes / mtbf_node_s, span_s)
    n = times.size
    nodes = rng.integers(0, n_nodes, size=n)
    is_sev1 = rng.random(n) < sev1_fraction
    sev1_kinds = sample_kinds(rng, SEV1_KINDS, int(is_sev1.sum()))
    other_kinds = sample_kinds(rng, NON_SEV1_KINDS, int(n - is_sev1.sum()))
    repairs = rng.uniform(repair_s[0], repair_s[1], size=n)
    events, i1, i2 = [], 0, 0
    for i in range(n):
        if is_sev1[i]:
            kind, rep = sev1_kinds[i1], float(repairs[i])
            i1 += 1
        else:
            kind, rep = other_kinds[i2], None
            i2 += 1
        events.append(FailureEvent(time=float(times[i]),
                                   node=int(nodes[i]), kind=kind,
                                   repair_s=rep))
    return ClusterScenario("independent", n_nodes, gpus_per_node, span_s,
                           failures=events, seed=seed)


def correlated_failures(*, n_nodes: int, span_s: float, seed: int,
                        gpus_per_node: int = 8, group_size: int = 8,
                        n_bursts: int = 4, burst_span_s: float = 120.0,
                        hit_fraction: float = 0.75,
                        outage_s: Tuple[float, float] = (1800.0, 4 * 3600.0)
                        ) -> ClusterScenario:
    """Switch-domain bursts: each burst drops ``hit_fraction`` of one node
    group within ``burst_span_s`` and the whole group returns together."""
    rng = np.random.default_rng(seed)
    groups = NodeGroups.contiguous(n_nodes, group_size)
    onsets = np.sort(rng.uniform(0, span_s, size=n_bursts))
    events: List[FailureEvent] = []
    for onset in onsets:
        gi = int(rng.integers(0, len(groups.groups)))
        outage = float(rng.uniform(*outage_s))
        members = np.array(groups.groups[gi])
        hit = members[rng.random(members.size) < hit_fraction]
        offsets = rng.uniform(0, burst_span_s, size=hit.size)
        for node, off in zip(hit, offsets):
            t = float(onset + off)
            events.append(FailureEvent(
                time=t, node=int(node), kind=ErrorKind.LOST_CONNECTION,
                repair_s=max(float(onset) + outage - t, 60.0)))
    events.sort(key=lambda e: e.time)
    return ClusterScenario("correlated", n_nodes, gpus_per_node, span_s,
                           failures=events, groups=groups, seed=seed)


def slow_nodes(*, n_nodes: int, span_s: float, seed: int,
               gpus_per_node: int = 8, n_events: int = 8,
               slowdown: Tuple[float, float] = (1.15, 2.5),
               duration_s: Tuple[float, float] = (3600.0, 8 * 3600.0)
               ) -> ClusterScenario:
    """Slow-node degradation for the §4.1 statistical monitor: slowdowns
    default to >= 1.15x so every event clears the 1.1x margin (Fig. 6)
    while staying below the 3x failure threshold."""
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0, span_s, size=n_events))
    nodes = rng.integers(0, n_nodes, size=n_events)
    slows = rng.uniform(slowdown[0], slowdown[1], size=n_events)
    durs = rng.uniform(duration_s[0], duration_s[1], size=n_events)
    events = [DegradationEvent(time=float(t), node=int(nd),
                               slowdown=float(s), duration_s=float(d))
              for t, nd, s, d in zip(times, nodes, slows, durs)]
    return ClusterScenario("slow_nodes", n_nodes, gpus_per_node, span_s,
                           degradations=events, seed=seed)


def preemption_waves(*, n_nodes: int, span_s: float, seed: int,
                     gpus_per_node: int = 8, n_waves: int = 3,
                     wave_fraction: float = 0.2,
                     reprovision_s: Tuple[float, float] = (1800.0, 7200.0)
                     ) -> ClusterScenario:
    """Spot-preemption waves: ``wave_fraction`` of the fleet is reclaimed
    near-simultaneously and re-provisioned after a delay."""
    rng = np.random.default_rng(seed)
    onsets = np.sort(rng.uniform(0, span_s, size=n_waves))
    events: List[FailureEvent] = []
    for onset in onsets:
        k = max(1, int(round(wave_fraction * n_nodes)))
        nodes = rng.choice(n_nodes, size=k, replace=False)
        reprov = rng.uniform(reprovision_s[0], reprovision_s[1], size=k)
        offsets = rng.uniform(0, 30.0, size=k)     # reclaim skew
        for node, off, rep in zip(nodes, offsets, reprov):
            events.append(FailureEvent(
                time=float(onset + off), node=int(node),
                kind=ErrorKind.LOST_CONNECTION, repair_s=float(rep)))
    events.sort(key=lambda e: e.time)
    return ClusterScenario("preemption", n_nodes, gpus_per_node, span_s,
                           failures=events, seed=seed)


def task_churn(*, span_s: float, seed: int, n_nodes: int,
               gpus_per_node: int = 8, m_initial: int,
               candidates: Sequence[Task], n_arrivals: int = 2,
               n_finishes: int = 2, workers_hint: int = 32
               ) -> ClusterScenario:
    """Join/finish churn (Figure 7 triggers 5 and 6): ``n_finishes``
    distinct initial slots complete, ``n_arrivals`` tasks from the
    candidate catalog are admitted.  Cap-aware: an arriving task with a
    ``max_workers`` ceiling never hints for more than its cap (the
    planner's banded reward rows make the excess worthless anyway)."""
    rng = np.random.default_rng(seed)
    n_finishes = min(n_finishes, m_initial)
    churn: List[object] = []
    slots = rng.choice(m_initial, size=n_finishes, replace=False)
    for slot, t in zip(slots, rng.uniform(0.2 * span_s, 0.9 * span_s,
                                          size=n_finishes)):
        churn.append(TaskFinish(time=float(t), slot=int(slot)))
    picks = rng.integers(0, len(candidates), size=n_arrivals)
    for pick, t in zip(picks, rng.uniform(0.1 * span_s, 0.8 * span_s,
                                          size=n_arrivals)):
        cand = candidates[int(pick)]
        hint = workers_hint
        if cand.max_workers is not None:
            hint = min(hint, cand.max_workers)
        churn.append(TaskArrival(time=float(t), task=cand,
                                 workers_hint=hint))
    churn.sort(key=lambda e: e.time)
    return ClusterScenario("churn", n_nodes, gpus_per_node, span_s,
                           churn=churn, seed=seed)


def diurnal_load(*, n_nodes: int, span_s: float, seed: int, slot: int,
                 base: ServingSLO, gpus_per_node: int = 8,
                 amplitude: float = 0.5, period_s: float = DAY,
                 step_s: float = 3600.0, jitter: float = 0.05
                 ) -> ClusterScenario:
    """Diurnal request-rate trace for one serving slot: a day/night sine
    around ``base.rate_rps`` (peak-to-trough set by ``amplitude``),
    sampled as piecewise-constant ``step_s`` steps with seeded
    multiplicative jitter.  Each step is a reward-only
    :class:`RateChangeEvent`."""
    rng = np.random.default_rng(seed)
    times = np.arange(step_s, span_s, step_s)
    phase = float(rng.uniform(0.0, period_s))
    level = 1.0 + amplitude * np.sin(2.0 * np.pi * (times + phase)
                                     / period_s)
    noise = np.clip(rng.normal(1.0, jitter, size=times.size), 0.1, None)
    rates = np.maximum(base.rate_rps * level * noise, 1e-3)
    churn: List[object] = [
        RateChangeEvent(time=float(t), slot=slot,
                        objective=base.with_rate(float(r)))
        for t, r in zip(times, rates)]
    return ClusterScenario("diurnal", n_nodes, gpus_per_node, span_s,
                           churn=churn, seed=seed)


def traffic_spikes(*, n_nodes: int, span_s: float, seed: int, slot: int,
                   base: ServingSLO, gpus_per_node: int = 8,
                   n_spikes: int = 3, spike_factor: float = 4.0,
                   spike_s: float = 1800.0) -> ClusterScenario:
    """Short traffic spikes for one serving slot: ``n_spikes`` disjoint
    windows of ``spike_s`` seconds at ``spike_factor`` times the base
    rate; each window's trailing edge restores ``base`` exactly."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.uniform(0.05 * span_s, 0.85 * span_s,
                                 size=n_spikes))
    churn: List[object] = []
    prev_end = -np.inf
    for onset in starts:
        t0 = max(float(onset), prev_end + 60.0)
        t1 = min(t0 + spike_s, span_s - 1.0)
        if t1 <= t0:
            continue
        churn.append(RateChangeEvent(
            time=t0, slot=slot,
            objective=base.with_rate(base.rate_rps * spike_factor)))
        churn.append(RateChangeEvent(time=t1, slot=slot, objective=base))
        prev_end = t1
    return ClusterScenario("spikes", n_nodes, gpus_per_node, span_s,
                           churn=churn, seed=seed)


def mixed_fleet(*, n_nodes: int, span_s: float, seed: int,
                gpus_per_node: int = 8, m_initial: int = 0,
                candidates: Sequence[Task] = (),
                mtbf_node_s: float = 60 * DAY, group_size: int = 8,
                n_bursts: int = 2, n_degradations: int = 6,
                n_waves: int = 2, wave_fraction: float = 0.2,
                n_arrivals: int = 2, n_finishes: int = 2
                ) -> ClusterScenario:
    """Everything at once — the cluster-scale workload of
    ``benchmarks/bench_cluster_sim.py`` (§7.5 at n=1024, m=32)."""
    base = independent_failures(
        n_nodes=n_nodes, span_s=span_s, seed=seed * 10 + 1,
        gpus_per_node=gpus_per_node, mtbf_node_s=mtbf_node_s)
    out = base.merged(correlated_failures(
        n_nodes=n_nodes, span_s=span_s, seed=seed * 10 + 2,
        gpus_per_node=gpus_per_node, group_size=group_size,
        n_bursts=n_bursts))
    out = out.merged(slow_nodes(
        n_nodes=n_nodes, span_s=span_s, seed=seed * 10 + 3,
        gpus_per_node=gpus_per_node, n_events=n_degradations))
    out = out.merged(preemption_waves(
        n_nodes=n_nodes, span_s=span_s, seed=seed * 10 + 4,
        gpus_per_node=gpus_per_node, n_waves=n_waves,
        wave_fraction=wave_fraction))
    if m_initial and len(candidates) and (n_arrivals or n_finishes):
        out = out.merged(task_churn(
            span_s=span_s, seed=seed * 10 + 5, n_nodes=n_nodes,
            gpus_per_node=gpus_per_node, m_initial=m_initial,
            candidates=candidates, n_arrivals=n_arrivals,
            n_finishes=n_finishes))
    out.name, out.seed = "mixed_fleet", seed
    return out


def scenario_suite(*, n_nodes: int, span_s: float, seed: int,
                   gpus_per_node: int = 8, m_initial: int = 0,
                   candidates: Sequence[Task] = ()) -> dict:
    """One representative scenario per class, all on the same cluster
    shape — the sweep ``bench_cluster_sim`` and the tests iterate."""
    return {
        "independent": independent_failures(
            n_nodes=n_nodes, span_s=span_s, seed=seed,
            gpus_per_node=gpus_per_node),
        "correlated": correlated_failures(
            n_nodes=n_nodes, span_s=span_s, seed=seed,
            gpus_per_node=gpus_per_node),
        "slow_nodes": slow_nodes(
            n_nodes=n_nodes, span_s=span_s, seed=seed,
            gpus_per_node=gpus_per_node),
        "preemption": preemption_waves(
            n_nodes=n_nodes, span_s=span_s, seed=seed,
            gpus_per_node=gpus_per_node),
        "mixed_fleet": mixed_fleet(
            n_nodes=n_nodes, span_s=span_s, seed=seed,
            gpus_per_node=gpus_per_node, m_initial=m_initial,
            candidates=candidates),
    }


# ---- trace-calibrated family (core.calibration tables) --------------------


def calibrated_failures(*, n_nodes: int, span_s: float, seed: int,
                        gpus_per_node: int = 8,
                        calib: FleetCalibration = DEFAULT_CALIBRATION
                        ) -> ClusterScenario:
    """Per-category Poisson faults at the committed calibrated rates.

    The fleet event rate is ``calib.failure_rate_s(n_nodes)`` (per-node
    MTBF superposed, so fleet MTTF scales as 1/n), each event's category
    is drawn by the committed shares, its kind uniformly within the
    category, and SEV1 categories carry a repair time from their
    calibrated range (non-SEV1 events release the node immediately)."""
    rng = np.random.default_rng(seed)
    times = poisson_times(rng, calib.failure_rate_s(n_nodes), span_s)
    n = times.size
    nodes = rng.integers(0, n_nodes, size=n)
    cats = calib.categories
    shares = np.array([c.share for c in cats])
    cat_idx = rng.choice(len(cats), size=n, p=shares / shares.sum())
    events: List[FailureEvent] = []
    for i in range(n):
        cat = cats[int(cat_idx[i])]
        kind = cat.kinds[int(rng.integers(0, len(cat.kinds)))]
        rep = None
        if cat.repair_range_s is not None:
            rep = float(rng.uniform(*cat.repair_range_s))
        events.append(FailureEvent(time=float(times[i]),
                                   node=int(nodes[i]), kind=kind,
                                   repair_s=rep))
    return ClusterScenario("calibrated_failures", n_nodes, gpus_per_node,
                           span_s, failures=events, seed=seed)


def calibrated_slow_nodes(*, n_nodes: int, span_s: float, seed: int,
                          gpus_per_node: int = 8,
                          calib: FleetCalibration = DEFAULT_CALIBRATION
                          ) -> ClusterScenario:
    """Slow-node degradations at the calibrated per-node straggler rate;
    slowdowns sit between the 1.1x margin and the 3x threshold."""
    rng = np.random.default_rng(seed)
    times = poisson_times(rng, n_nodes * calib.slow_rate_per_node_s,
                          span_s)
    n = times.size
    nodes = rng.integers(0, n_nodes, size=n)
    slows = rng.uniform(*calib.slow_slowdown_range, size=n)
    durs = rng.uniform(*calib.slow_duration_range_s, size=n)
    events = [DegradationEvent(time=float(t), node=int(nd),
                               slowdown=float(s), duration_s=float(d))
              for t, nd, s, d in zip(times, nodes, slows, durs)]
    return ClusterScenario("calibrated_slow", n_nodes, gpus_per_node,
                           span_s, degradations=events, seed=seed)


def calibrated_bursts(*, n_nodes: int, span_s: float, seed: int,
                      gpus_per_node: int = 8,
                      calib: FleetCalibration = DEFAULT_CALIBRATION
                      ) -> ClusterScenario:
    """Correlated switch/PSU-domain bursts at the calibrated rate: a
    whole node group loses ``burst_hit_fraction`` of its members within
    two minutes and returns together.  Adjacent nodes failing together
    is precisely the replica-loss case the tier-aware cost model charges
    (the GEMINI ring neighbor is gone too)."""
    rng = np.random.default_rng(seed)
    groups = NodeGroups.contiguous(n_nodes, calib.burst_group_size)
    onsets = poisson_times(rng, n_nodes * calib.burst_rate_per_node_s,
                           span_s)
    events: List[FailureEvent] = []
    for onset in onsets:
        gi = int(rng.integers(0, len(groups.groups)))
        outage = float(rng.uniform(*calib.burst_repair_range_s))
        members = np.array(groups.groups[gi])
        hit = members[rng.random(members.size) < calib.burst_hit_fraction]
        offsets = rng.uniform(0, 120.0, size=hit.size)
        for node, off in zip(hit, offsets):
            t = float(onset + off)
            events.append(FailureEvent(
                time=t, node=int(node), kind=ErrorKind.LOST_CONNECTION,
                repair_s=max(float(onset) + outage - t, 60.0)))
    events.sort(key=lambda e: e.time)
    return ClusterScenario("calibrated_bursts", n_nodes, gpus_per_node,
                           span_s, failures=events, groups=groups,
                           seed=seed)


def calibrated_preemption(*, n_nodes: int, span_s: float, seed: int,
                          gpus_per_node: int = 8,
                          calib: FleetCalibration = DEFAULT_CALIBRATION
                          ) -> ClusterScenario:
    """Scheduler preemption waves at the calibrated fleet-level rate:
    each wave reclaims a calibrated fraction of the fleet at once."""
    rng = np.random.default_rng(seed)
    onsets = poisson_times(rng, calib.preempt_wave_rate_s, span_s)
    events: List[FailureEvent] = []
    for onset in onsets:
        frac = float(rng.uniform(*calib.preempt_fraction_range))
        k = max(1, int(round(frac * n_nodes)))
        nodes = rng.choice(n_nodes, size=k, replace=False)
        reprov = rng.uniform(*calib.preempt_outage_range_s, size=k)
        offsets = rng.uniform(0, 30.0, size=k)     # reclaim skew
        for node, off, rep in zip(nodes, offsets, reprov):
            events.append(FailureEvent(
                time=float(onset + off), node=int(node),
                kind=ErrorKind.LOST_CONNECTION, repair_s=float(rep)))
    events.sort(key=lambda e: e.time)
    return ClusterScenario("calibrated_preemption", n_nodes,
                           gpus_per_node, span_s, failures=events,
                           seed=seed)


def calibrated_fleet(*, n_nodes: int, span_s: float, seed: int,
                     gpus_per_node: int = 8, m_initial: int = 0,
                     candidates: Sequence[Task] = (),
                     n_arrivals: int = 0, n_finishes: int = 0,
                     calib: FleetCalibration = DEFAULT_CALIBRATION,
                     intensity: float = 1.0) -> ClusterScenario:
    """The calibrated 30-day workload: per-category failures, slow
    nodes, correlated bursts and preemption waves superimposed, all at
    the committed rates (``intensity`` scales every rate uniformly for
    stress/quick configurations; shares and ranges are untouched)."""
    if intensity != 1.0:
        calib = calib.scaled(intensity)
    out = calibrated_failures(
        n_nodes=n_nodes, span_s=span_s, seed=seed * 10 + 1,
        gpus_per_node=gpus_per_node, calib=calib)
    out = out.merged(calibrated_slow_nodes(
        n_nodes=n_nodes, span_s=span_s, seed=seed * 10 + 2,
        gpus_per_node=gpus_per_node, calib=calib))
    out = out.merged(calibrated_bursts(
        n_nodes=n_nodes, span_s=span_s, seed=seed * 10 + 3,
        gpus_per_node=gpus_per_node, calib=calib))
    out = out.merged(calibrated_preemption(
        n_nodes=n_nodes, span_s=span_s, seed=seed * 10 + 4,
        gpus_per_node=gpus_per_node, calib=calib))
    if m_initial and len(candidates) and (n_arrivals or n_finishes):
        out = out.merged(task_churn(
            span_s=span_s, seed=seed * 10 + 5, n_nodes=n_nodes,
            gpus_per_node=gpus_per_node, m_initial=m_initial,
            candidates=candidates, n_arrivals=n_arrivals,
            n_finishes=n_finishes))
    out.name, out.seed = "calibrated_fleet", seed
    return out


# ---- control-plane chaos schedules (core.chaos) ---------------------------

def chaos_schedule(*, seed: int, span_s: float, n_nodes: int,
                   drop_p: float = 0.15, delay_p: float = 0.3,
                   max_delay_s: float = 15.0, dup_p: float = 0.15,
                   n_partitions: int = 2,
                   partition_s: Tuple[float, float] = (10.0, 45.0),
                   n_crashes: int = 1,
                   avoid: Sequence[Tuple[float, float]] = ()
                   ) -> ChaosSchedule:
    """One seeded control-plane fault schedule.

    Injection stops at ``end_s = 0.6 * span_s`` so the trace tail is a
    quiescence window.  Partition windows are disjoint and sequential,
    padded with heal slack (max delay + outbox backoff cap) and placed
    outside the caller's ``avoid`` windows (typically
    the reference's ``chaos.world_windows(world)``): a partition that swallows a world
    event's delivery would turn a bounded-lag re-delivery into an
    unbounded one and make convergence against the chaos-free run
    undecidable.  Coordinator crashes are uniform over the injection
    span — crash placement needs no exclusion because recovery rebuilds
    identical coordinator state from the journal."""
    rng = np.random.default_rng(seed)
    end_s = 0.6 * span_s
    guard = max_delay_s + 30.0          # heal slack: delay + backoff cap
    parts: List[Tuple[int, float, float]] = []
    cursor = 0.05 * span_s
    for _ in range(n_partitions):
        dur = float(rng.uniform(*partition_s))
        if cursor + dur + guard >= end_s:
            break
        placed = None
        for _ in range(64):
            start = float(rng.uniform(cursor, end_s - dur - guard))
            lo, hi = start - guard, start + dur + guard
            if all(hi < a or lo > b for a, b in avoid):
                placed = start
                break
        if placed is None:
            break
        node = int(rng.integers(0, n_nodes))
        parts.append((node, placed, placed + dur))
        cursor = placed + dur + guard
    crashes = tuple(sorted(
        float(t) for t in rng.uniform(0.1 * span_s, end_s,
                                      size=n_crashes))) if n_crashes else ()
    return ChaosSchedule(seed=seed, drop_p=drop_p, delay_p=delay_p,
                         max_delay_s=max_delay_s, dup_p=dup_p,
                         partitions=tuple(parts), crash_times=crashes,
                         end_s=end_s)


def chaos_suite(*, seed: int, span_s: float, n_nodes: int,
                avoid: Sequence[Tuple[float, float]] = ()) -> dict:
    """One schedule per chaos class on the same cluster shape — the
    sweep ``bench_chaos`` and the soak test iterate: pure message drop,
    delay + duplication (reordering falls out of unequal delays),
    partitions, a lone coordinator crash, and everything at once."""
    base = dict(span_s=span_s, n_nodes=n_nodes, avoid=avoid)
    return {
        "drop": chaos_schedule(seed=seed * 10 + 1, drop_p=0.3,
                               delay_p=0.0, max_delay_s=0.0, dup_p=0.0,
                               n_partitions=0, n_crashes=0, **base),
        "delay_dup": chaos_schedule(seed=seed * 10 + 2, drop_p=0.0,
                                    delay_p=0.5, max_delay_s=20.0,
                                    dup_p=0.3, n_partitions=0,
                                    n_crashes=0, **base),
        "partition": chaos_schedule(seed=seed * 10 + 3, drop_p=0.1,
                                    delay_p=0.2, max_delay_s=10.0,
                                    dup_p=0.1, n_partitions=2,
                                    n_crashes=0, **base),
        "crash": chaos_schedule(seed=seed * 10 + 4, drop_p=0.0,
                                delay_p=0.0, max_delay_s=0.0, dup_p=0.0,
                                n_partitions=0, n_crashes=1, **base),
        "full": chaos_schedule(seed=seed * 10 + 5, **base),
    }
