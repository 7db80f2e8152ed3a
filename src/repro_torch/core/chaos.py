"""Copied from ``repro/core/chaos.py``: the chaos-engineering layer for the
coordinator<->agent control plane.

The status monitor in ``kvstore.py`` is a perfect in-process store; real
fleets (ByteDance's robust-training report, Meta's reliability study —
PAPERS.md) see lost heartbeats, delayed/duplicated reports, switch
partitions and coordinator restarts as the *norm*.  This module injects
exactly those faults from a seeded :class:`ChaosSchedule` so the
hardened protocol (at-least-once publish, idempotent consume, journal +
incarnation fencing — see the ``kvstore.py`` docstring) can be driven to
its convergence property: after the chaos horizon passes, the cluster
assignment and WAF must equal the chaos-free run's within 1e-6.

Fault model
-----------

* **drop / delay / duplicate** apply per message to node-*bound* clients
  (``ChaosKVStore.bind``) — the agent report path.  Delayed messages sit
  in a delivery heap pumped by ``advance``/``expire`` and land out of
  send order, which is how *reordering* arises.  Heartbeat keys
  (``/nodes/``) are exempt from per-message faults: the lease keepalive
  channel retries below this abstraction, and its failure mode is the
  partition.
* **partitions** are per-node windows during which every operation of
  that node's bound client raises ``KVUnavailable`` — heartbeats
  included, so the coordinator's lease expiry (correctly) raises
  LOST_CONNECTION and later revokes it when the node reappears.
* **coordinator crashes** (``crash_times``) discard the coordinator and
  control-loop process state; recovery goes through
  ``UnicronCoordinator.recover`` + the KV-backed consumption markers.

Unbound operations (the co-located coordinator / control loop) are
always faithful — chaos models the agent->monitor network, not the
monitor's own storage.

Convergence invariants (enforced by ``scenarios.chaos_schedule`` for
generated schedules, documented here for hand-built ones):

* world events are spaced further apart than the worst-case delivery lag
  (max delay + partition span + retry backoff cap + detection latency),
  so chaos shifts *when* each decision fires, never its inputs;
* partition windows are disjoint and avoid churn/failure event windows,
  so a false-positive drain is always revoked by the exact pre-drain
  assignment (no epoch or capacity drift in between);
* the control loop's marker retention exceeds max delay + partition
  span, so late duplicates always meet their processed marker.
"""
from __future__ import annotations

import heapq
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.agent import UnicronAgent, heartbeat_cohort
from repro_torch.core.cluster import Cluster
from repro_torch.core.controlloop import ControlLoop
from repro_torch.core.coordinator import UnicronCoordinator
from repro_torch.core.detection import ErrorKind
from repro_torch.core.kvstore import (KVStore, KVUnavailable,
                                      PLAN_EPOCH_KEY)
from repro_torch.core.waf import Task


@dataclass(frozen=True)
class ChaosSchedule:
    """One seeded chaos trace for the control plane.

    ``end_s`` is the injection horizon: no drop/delay/dup after it (the
    settle window the convergence property needs).  Partitions and
    crashes carry their own times and may end later than ``end_s``; the
    overall quiet point is :meth:`horizon`."""
    seed: int = 0
    drop_p: float = 0.0
    delay_p: float = 0.0
    max_delay_s: float = 0.0
    dup_p: float = 0.0
    # (node, start_s, end_s) windows; generators keep them disjoint
    partitions: Tuple[Tuple[int, float, float], ...] = ()
    crash_times: Tuple[float, ...] = ()
    end_s: float = 0.0

    def horizon(self) -> float:
        """Last instant any injection can still be active."""
        h = self.end_s + self.max_delay_s
        for _, _, end in self.partitions:
            h = max(h, end)
        for t in self.crash_times:
            h = max(h, t)
        return h


class _ChaosClient:
    """A node's view of the status monitor: same interface as
    ``KVStore`` for the ops agents use, with the schedule applied."""

    def __init__(self, store: "ChaosKVStore", node_id: int):
        self._store = store
        self.node_id = node_id

    def put(self, key, value, *, ttl=None, now=0.0):
        self._store.chaotic_put(self.node_id, key, value, ttl=ttl, now=now)

    def get(self, key, default=None):
        self._store.check_link(self.node_id, self._store.clock)
        return self._store.get(key, default)

    def prefix(self, pre):
        self._store.check_link(self.node_id, self._store.clock)
        return self._store.prefix(pre)

    def delete(self, key):
        self._store.check_link(self.node_id, self._store.clock)
        self._store.delete(key)

    def cas(self, key, expect, value):
        self._store.check_link(self.node_id, self._store.clock)
        return self._store.cas(key, expect, value)


class ChaosKVStore(KVStore):
    """``KVStore`` whose node-bound clients traverse a chaotic network.

    The store itself (unbound access) is faithful; ``bind(node)``
    returns the client agents must use.  ``advance(now)`` delivers
    matured delayed/duplicated messages and is folded into ``expire`` so
    the control loop's normal tick pumps the network."""

    def __init__(self, schedule: ChaosSchedule):
        super().__init__()
        self.schedule = schedule
        self._rng = random.Random(schedule.seed)
        self._pending: List[Tuple[float, int, str, object,
                                  Optional[float], float]] = []
        self._pseq = 0
        self.clock = 0.0                   # last time seen by advance()
        self.stats = {"dropped": 0, "delayed": 0, "duplicated": 0,
                      "rejected": 0, "delivered": 0}

    # ---- topology ----------------------------------------------------------

    def bind(self, node_id: int) -> _ChaosClient:
        return _ChaosClient(self, node_id)

    def partitioned(self, node_id: int, now: float) -> bool:
        return any(n == node_id and start <= now < end
                   for n, start, end in self.schedule.partitions)

    def check_link(self, node_id: int, now: float) -> None:
        if self.partitioned(node_id, now):
            self.stats["rejected"] += 1
            raise KVUnavailable(f"node {node_id} partitioned at {now:.1f}")

    # ---- chaotic write path ------------------------------------------------

    def chaotic_put(self, node_id: int, key: str, value, *,
                    ttl=None, now: float = 0.0) -> None:
        self.clock = max(self.clock, now)
        self.check_link(node_id, now)
        s, rng = self.schedule, self._rng
        # heartbeats only face the partition (lease keepalives retry
        # below this layer); everything else gets the full treatment
        inject = now < s.end_s and not key.startswith("/nodes/")
        if inject and s.drop_p and rng.random() < s.drop_p:
            self.stats["dropped"] += 1
            return
        deliver_at = now
        if inject and s.delay_p and rng.random() < s.delay_p:
            deliver_at = now + rng.uniform(0.0, s.max_delay_s)
            self.stats["delayed"] += 1
        if inject and s.dup_p and rng.random() < s.dup_p:
            echo_at = now + rng.uniform(0.0, max(s.max_delay_s, 1.0))
            self._pseq += 1
            heapq.heappush(self._pending,
                           (echo_at, self._pseq, key, value, ttl, now))
            self.stats["duplicated"] += 1
        if deliver_at <= now:
            super().put(key, value, ttl=ttl, now=now)
            self.stats["delivered"] += 1
        else:
            self._pseq += 1
            heapq.heappush(self._pending,
                           (deliver_at, self._pseq, key, value, ttl, now))

    def advance(self, now: float) -> int:
        """Deliver matured in-flight messages; returns how many."""
        self.clock = max(self.clock, now)
        n = 0
        while self._pending and self._pending[0][0] <= now:
            _, _, key, value, ttl, sent = heapq.heappop(self._pending)
            super().put(key, value, ttl=ttl, now=sent)
            self.stats["delivered"] += 1
            n += 1
        return n

    def expire(self, now: float):
        self.advance(now)
        return super().expire(now)

    @property
    def in_flight(self) -> int:
        return len(self._pending)


# ---------------------------------------------------------------------------
# Scripted world + convergence harness
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WorldEvent:
    """One scripted ground-truth event the harness feeds the agents.

    kinds: ``error`` (in-band report of ``error`` on ``node``), ``kill``
    (node dies, heartbeats stop), ``repair`` (ops crew finishes fixing
    ``node``), ``finish`` (the workload owner declares ``task`` done),
    ``launch`` (a new ``task`` asks for admission)."""
    time: float
    kind: str
    node: int = 0
    error: Optional[ErrorKind] = None
    task: Optional[Task] = None
    avg_iter_s: float = 30.0


def demo_world(finish_task: Task, launch_task: Task, *, t0: float = 40.0,
               spacing: float = 180.0) -> List[WorldEvent]:
    """The standard convergence script: an in-band SEV2, a node loss, a
    task finish, a task launch, and the repair — each ``spacing`` apart
    so chaos can shift fire times without reordering decisions."""
    t = [t0 + i * spacing for i in range(5)]
    return [
        WorldEvent(t[0], "error", node=1, error=ErrorKind.CUDA_ERROR),
        WorldEvent(t[1], "kill", node=2),
        WorldEvent(t[2], "finish", task=finish_task),
        WorldEvent(t[3], "launch", task=launch_task, avg_iter_s=12.0),
        WorldEvent(t[4], "repair", node=2),
    ]


def world_windows(world: Sequence[WorldEvent],
                  lag_s: float = 150.0) -> List[Tuple[float, float]]:
    """Exclusion windows around world events for partition placement:
    [t - 10, t + lag] covers the worst-case delivery+decision lag."""
    return [(ev.time - 10.0, ev.time + lag_s) for ev in world]


@dataclass
class HarnessResult:
    assignment: Dict[str, int]         # task label -> workers
    waf: float
    healthy_workers: int
    last_event_t: float
    n_crashes: int
    n_events: int
    chaos_stats: Optional[Dict[str, int]] = None


@dataclass
class ChaosHarness:
    """Tick-driven closed world: agents + chaotic status monitor +
    control loop + coordinator, fed a scripted ``WorldEvent`` list.

    The harness plays the roles outside the control plane: the workload
    owner (announcing finish/launch intents through an agent until the
    coordinator's task set reflects them — the application-level
    re-announcement the epoch staleness guard requires), the ops crew
    (scheduled repairs), and the fault injector (scheduled coordinator
    crashes, recovered via ``UnicronCoordinator.recover`` plus a fresh
    ``ControlLoop`` whose consumption state comes from the KV markers).
    The shared ``Cluster`` object is the physical ground truth."""

    tasks: List[Task]
    assignment: List[int]
    hw: object
    n_nodes: int = 6
    gpus_per_node: int = 4
    schedule: Optional[ChaosSchedule] = None
    tick_s: float = 2.0
    marker_retention_s: float = 600.0
    seed: int = 0
    labels: Optional[Dict[int, str]] = None
    events: List[object] = field(default_factory=list)
    n_crashes: int = 0
    last_event_t: float = 0.0
    # chaos-free store override (e.g. kvstore.LegacyKVStore for the
    # legacy-vs-sharded equivalence suite); chaos runs always use
    # ChaosKVStore, which wraps the sharded store
    kv_factory: Optional[object] = None
    # where every coordinator the harness builds runs its plan tables'
    # max-plus kernels: the first one and each one ``recover`` rebuilds
    # after a scheduled crash ("cuda", or "cpu" for the plain versions)
    device: object = "cuda"

    def __post_init__(self):
        self.kv = (ChaosKVStore(self.schedule) if self.schedule
                   else (self.kv_factory() if self.kv_factory
                         else KVStore()))
        self.coord = UnicronCoordinator(
            list(self.tasks), list(self.assignment), self.hw, kv=self.kv,
            n_cluster_workers=self.n_nodes * self.gpus_per_node,
            workers_per_node=self.gpus_per_node, device=self.device)
        self.cluster = Cluster(self.n_nodes, self.gpus_per_node)
        self.cluster.assign(list(self.assignment))
        chaotic = isinstance(self.kv, ChaosKVStore)
        self.agents = {
            i: UnicronAgent(i, self.kv.bind(i) if chaotic else self.kv,
                            n_gpus=self.gpus_per_node,
                            seed=self.seed * 1000 + i)
            for i in range(self.n_nodes)}
        self.loop = ControlLoop(self.coord, self.cluster, self.agents,
                                marker_retention_s=self.marker_retention_s)
        if self.labels is None:
            self.labels = {}
        for t in self.tasks:
            self._label(t)
        self._crashes = sorted(self.schedule.crash_times) \
            if self.schedule else []
        self._pending_repairs: Dict[int, float] = {}
        self._finish_intents: List[Task] = []
        self._launch_intents: List[Tuple[Task, float]] = []

    def _label(self, task: Task) -> str:
        return self.labels.setdefault(id(task),
                                      f"task{len(self.labels)}")

    # ---- world-side actors -------------------------------------------------

    def _fire_world(self, ev: WorldEvent, now: float) -> None:
        if ev.kind == "error":
            self.agents[ev.node].report(ev.error, now)
        elif ev.kind == "kill":
            self.agents[ev.node].kill()
        elif ev.kind == "repair":
            self._pending_repairs[ev.node] = ev.time
        elif ev.kind == "finish":
            self._label(ev.task)
            self._finish_intents.append(ev.task)
        elif ev.kind == "launch":
            self._label(ev.task)
            self._launch_intents.append((ev.task, ev.avg_iter_s))
        else:
            raise ValueError(f"unknown world event kind {ev.kind!r}")

    def _repair_crew(self, now: float) -> None:
        for node, due in list(self._pending_repairs.items()):
            n = self.cluster.nodes[node]
            if due <= now and not n.healthy:
                n.repair_done_at = now     # hardware fixed; loop rejoins
                del self._pending_repairs[node]

    def _reporter(self) -> Optional[UnicronAgent]:
        """First alive agent with a working link (any worker of a task
        may announce churn; the choice only affects key names)."""
        for nid in sorted(self.agents):
            a = self.agents[nid]
            if not a.alive:
                continue
            try:
                a.kv.get(PLAN_EPOCH_KEY)
            except KVUnavailable:
                continue
            return a
        return None

    def _announce_intents(self, now: float) -> None:
        """Re-announce unsatisfied churn intents against the current
        epoch — the submitter side of the staleness guard: a record
        consumed-without-firing (stale epoch) is simply announced again
        until the coordinator's task set reflects the intent."""
        a = self._reporter()
        if a is None:
            return
        epoch = a.kv.get(PLAN_EPOCH_KEY, 0)
        live = {id(e.task): i for i, e in enumerate(self.coord.entries)}
        for t in list(self._finish_intents):
            idx = live.get(id(t))
            if idx is None:                        # satisfied
                self._finish_intents.remove(t)
                continue
            a.report_task_finished(idx, now, epoch)
        for t, avg in list(self._launch_intents):
            if id(t) in live:                      # satisfied
                self._launch_intents.remove((t, avg))
                continue
            a.request_task_launch(t, now, epoch, avg_iter_s=avg)

    def _crash_coordinator(self) -> None:
        """Coordinator + control-loop process dies; everything in-memory
        is lost.  Recovery: journal -> entries/epoch/cases, KV markers ->
        consumption state, incarnation fence deposes the old process."""
        self.events += self.loop.events
        self.coord = UnicronCoordinator.recover(
            self.kv, self.hw,
            n_cluster_workers=self.n_nodes * self.gpus_per_node,
            workers_per_node=self.gpus_per_node, device=self.device)
        self.loop = ControlLoop(self.coord, self.cluster, self.agents,
                                marker_retention_s=self.marker_retention_s)
        self.n_crashes += 1

    # ---- main loop ---------------------------------------------------------

    def run(self, world: Sequence[WorldEvent],
            until: float) -> HarnessResult:
        script = sorted(world, key=lambda e: e.time)
        wi = 0
        t = 0.0
        while t <= until:
            while self._crashes and self._crashes[0] <= t:
                self._crashes.pop(0)
                self._crash_coordinator()
            while wi < len(script) and script[wi].time <= t:
                self._fire_world(script[wi], t)
                wi += 1
            self._repair_crew(t)
            heartbeat_cohort(self.agents, t)
            for a in self.agents.values():
                a.flush_outbox(t)
            self._announce_intents(t)
            if self.loop.tick(t):
                self.last_event_t = t
            t += self.tick_s
        self.events += self.loop.events
        return self.result()

    def result(self) -> HarnessResult:
        assign = {self._label(e.task): e.n_workers
                  for e in self.coord.entries}
        stats = dict(self.kv.stats) \
            if isinstance(self.kv, ChaosKVStore) else None
        return HarnessResult(
            assignment=assign, waf=self.coord.cluster_waf(),
            healthy_workers=self.cluster.healthy_workers(),
            last_event_t=self.last_event_t, n_crashes=self.n_crashes,
            n_events=len(self.events), chaos_stats=stats)

    def quiesced(self) -> bool:
        """No unacknowledged publishes, no in-flight deliveries."""
        if any(a.outbox_size for a in self.agents.values()):
            return False
        if isinstance(self.kv, ChaosKVStore) and self.kv.in_flight:
            return False
        return not self._finish_intents and not self._launch_intents
