"""Copied from ``repro/core/controlloop.py``: the Unicron control loop —
operational glue between agents and the coordinator (§3, Figure 5),
event-driven at fleet scale.

Agents publish heartbeats and error reports into the status monitor (the
etcd-like KV store); the control loop is the coordinator-side consumer
that turns that stream into decisions:

  1. expire heartbeat leases -> LOST_CONNECTION (SEV1) for silent nodes,
  2. collect in-band error reports whose detection latency has elapsed,
  3. classify severity and decide the action (reattempt / restart /
     reconfigure) with escalation on repeated failure,
  4. on SEV1: drain the node in the cluster state and fetch the
     reconfiguration plan (lookup table first, fresh solve on miss),
  5. on node repair or reappearance: rejoin + replan (or restore).

Event-driven tick (the consumer side of the sharded-store contract in
``kvstore.py``): each drain family is consumed from its append-cursor
event queue — the loop reads ``queue_slice(family, cursor)``, consumes
the visible records, and advances a *conservative* cursor (the index of
the first entry that is neither consumed nor deleted, i.e. the oldest
record still waiting out its detection latency).  The cursor is
persisted under ``CURSOR_PREFIX + family``, so a recovered loop resumes
at the dead loop's position instead of rescanning history; because the
cursor never passes an unresolved record, a crash between consume and
cursor write only re-reads — the ``/consumed`` markers make the replay
a no-op.  A tick whose queues are all empty does **zero** prefix scans
and zero sort allocations (``tick_stats`` counts them); marker GC runs
every ``gc_interval_s`` instead of scanning ``/consumed/`` per tick
(sound because the at-least-once contract already requires retention to
exceed the worst re-delivery lag — GC timing is bounded-residency
bookkeeping, not correctness).  On a store without queues
(``LegacyKVStore``) the loop falls back to the original
scan+sort+delete drains with identical observable semantics — the
equivalence suite replays one trace through both and asserts byte-equal
event streams.

Delivery semantics: agents publish at-least-once, so every record (and
every queue entry) may arrive more than once and out of order.  The
loop is idempotent under that: a record is *consumed* by deleting it
and writing a processed marker under ``CONSUMED_PREFIX + key`` (the
producer-visible ack); a re-delivered record whose marker exists is
deleted without re-firing.  All consumption state lives in the KV — a
restarted loop (after a coordinator crash) inherits the markers and
never double-fires a trigger.  Markers are garbage-collected after
``marker_retention_s`` (which must exceed the transport's maximum
re-delivery lag); records themselves are deleted on consume, so KV
residency stays bounded over arbitrarily long traces.

False-positive drains: a partition can silence a healthy node's
heartbeats long enough to expire its lease.  Before draining on
LOST_CONNECTION the loop snapshots the pre-drain assignment under
``/coord/lost/<node>``; when the node's heartbeat *reappears* (a beat
newer than the drain), the loop rejoins it and — if the plan state is
otherwise unchanged — restores that exact assignment instead of
replanning.  Restoring matters because the planner's reward is
hysteretic (transition penalties make it sticky): replanning after a
spurious drain would not return to the pre-drain optimum, so restore is
what makes chaos runs converge to the chaos-free state exactly.  The
loop tracks outstanding snapshots in memory (seeded from one
``/coord/lost/`` scan at construction), so the reappearance sweep is
free when nothing is drained.

The loop is deliberately synchronous and driven by an external clock so
the discrete-event simulator and the real examples share it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.agent import UnicronAgent
from repro_torch.core.cluster import Cluster
from repro_torch.core.coordinator import UnicronCoordinator
from repro_torch.core.detection import ErrorKind
from repro_torch.core.handling import Action, Trigger
from repro_torch.core.kvstore import (CONSUMED_PREFIX, CURSOR_PREFIX,
                                      PLAN_EPOCH_KEY, QUEUE_FAMILIES)

LOST_PREFIX = "/coord/lost/"

ERRORS_FAMILY, FINISHED_FAMILY, LAUNCH_FAMILY = QUEUE_FAMILIES


@dataclass
class LoopEvent:
    """One decision taken by the control loop (for logs / tests)."""
    time: float
    node: int
    kind: Optional[ErrorKind]                # None: task churn, not an error
    action: Action
    plan: Optional[Tuple[int, ...]] = None
    plan_latency_s: Optional[float] = None   # dispatch latency (lookup/solve)
    # batched planner-engine counters at event time (cumulative
    # coordinator.PlanStats values: level sweeps, stacked kernel
    # launches, lazily materialized tracebacks); None when the event
    # produced no plan or the coordinator runs a non-batched plan engine
    plan_levels: Optional[int] = None
    plan_launches: Optional[int] = None
    plan_tracebacks: Optional[int] = None


class ControlLoop:
    def __init__(self, coordinator: UnicronCoordinator, cluster: Cluster,
                 agents: Dict[int, UnicronAgent],
                 marker_retention_s: float = 600.0,
                 gc_interval_s: float = 60.0):
        self.coord = coordinator
        self.cluster = cluster
        self.agents = agents
        self.kv = coordinator.kv
        self.events: List[LoopEvent] = []
        self.marker_retention_s = marker_retention_s
        self.gc_interval_s = gc_interval_s
        self._last_gc: Optional[float] = None
        self._case_seq = 0
        # per-loop tick-cost counters (regression-tested: a quiet tick
        # must do zero prefix scans and zero drain sorts on a queued
        # store — the event-driven guarantee)
        self.tick_stats = {"ticks": 0, "prefix_scans": 0,
                           "drain_sorts": 0, "queue_reads": 0,
                           "records_consumed": 0, "gc_runs": 0}
        # queue-cursor drains when the store offers append queues,
        # scan+sort fallback otherwise (LegacyKVStore)
        self._queued = callable(getattr(self.kv, "queue_slice", None))
        self._cursors: Dict[str, int] = {}
        if self._queued:
            for fam in QUEUE_FAMILIES:
                self._cursors[fam] = int(self.kv.get(CURSOR_PREFIX + fam, 0))
        # outstanding false-positive-drain snapshots (one scan here;
        # incrementally maintained so the reappearance sweep is free
        # when nothing is drained)
        self._lost_nodes: Set[int] = {
            int(key[len(LOST_PREFIX):])
            for key in self.kv.prefix(LOST_PREFIX)}

    def _stamped(self, ev: LoopEvent) -> LoopEvent:
        """Stamp plan-producing events with the coordinator's cumulative
        batched-engine counters (like ``plan_latency_s``, a point-in-time
        read of ``PlanStats``).  Non-batched plan engines have no such
        counters — those events stay None rather than reading as
        zero-cost batched dispatches in mixed-engine logs."""
        if ev.plan is not None and self.coord.plan_engine == "batched":
            ps = self.coord.plan_stats
            ev.plan_levels = ps.batched_levels
            ev.plan_launches = ps.batched_launches
            ev.plan_tracebacks = ps.lazy_tracebacks
        return ev

    # ---- idempotent consumption (KV-backed processed markers) --------------

    def _consumed(self, key: str) -> bool:
        return self.kv.get(CONSUMED_PREFIX + key) is not None

    def _consume(self, key: str, now: float) -> None:
        """Delete-on-consume + processed marker: the delete bounds KV
        residency, the marker is both the re-delivery guard and the
        producer-visible acknowledgement (outbox retirement)."""
        self.kv.delete(key)
        self.kv.put(CONSUMED_PREFIX + key, now, now=now)

    def _gc_markers(self, now: float) -> None:
        """Purge expired processed markers, amortized to one
        ``/consumed/`` sweep per ``gc_interval_s``.  Late duplicates are
        unaffected: the at-least-once contract requires
        ``marker_retention_s`` to exceed the worst re-delivery lag, so
        any marker a duplicate could still need is never GC-eligible —
        the interval only delays reclaiming provably dead markers."""
        if self._last_gc is not None \
                and now - self._last_gc < self.gc_interval_s:
            return
        self._last_gc = now
        self.tick_stats["gc_runs"] += 1
        self.tick_stats["prefix_scans"] += 1
        for key, t in self.kv.prefix(CONSUMED_PREFIX).items():
            if now - float(t) > self.marker_retention_s:
                self.kv.delete(key)

    # ---- drain-family consumption ------------------------------------------

    def _due_records(self, family: str, now: float) -> List[Tuple[str, Dict]]:
        """Consume every visible, unconsumed record of one drain family;
        returns (key, record) pairs in sorted key order (the legacy drain
        order — lexicographic == chronological for these key schemas).

        Queue path: read appended keys from the persisted cursor,
        resolve each (duplicate -> delete, not-yet-visible -> leave,
        visible -> consume), and advance the cursor past the resolved
        head.  The cursor is conservative — it never passes a record
        still waiting out its detection latency — so the re-read tail is
        bounded by the in-flight window, not history."""
        if not self._queued:
            self.tick_stats["prefix_scans"] += 1
            records = self.kv.prefix(family)
            if not records:
                return []
            self.tick_stats["drain_sorts"] += 1
            out = []
            for key in sorted(records):
                if self._consumed(key):
                    self.kv.delete(key)        # re-delivered duplicate
                    continue
                rec = records[key]
                if rec["visible_at"] > now:
                    continue
                self._consume(key, now)
                out.append((key, rec))
            self.tick_stats["records_consumed"] += len(out)
            return out

        cursor = self._cursors[family]
        if self.kv.queue_len(family) == cursor:
            return []                          # family idle: zero work
        self.tick_stats["queue_reads"] += 1
        out = []
        resolved_head = 0
        at_head = True
        for i, key in enumerate(self.kv.queue_slice(family, cursor)):
            rec = self.kv.get(key)
            if rec is None:
                # consumed earlier (marker holds the ack) or deleted:
                # either way resolved
                if at_head:
                    resolved_head = i + 1
                continue
            if self._consumed(key):
                self.kv.delete(key)            # re-delivered duplicate
                if at_head:
                    resolved_head = i + 1
                continue
            if rec["visible_at"] > now:
                at_head = False                # cursor must wait for it
                continue
            self._consume(key, now)
            out.append((key, rec))
            if at_head:
                resolved_head = i + 1
        if resolved_head:
            self._cursors[family] = cursor + resolved_head
            self.kv.put(CURSOR_PREFIX + family, cursor + resolved_head)
        if out:
            self.tick_stats["drain_sorts"] += 1
            out.sort(key=lambda kr: kr[0])
        self.tick_stats["records_consumed"] += len(out)
        return out

    # ---- one tick of the loop ---------------------------------------------

    def tick(self, now: float) -> List[LoopEvent]:
        self.tick_stats["ticks"] += 1
        out: List[LoopEvent] = []
        out += self._expire_heartbeats(now)
        out += self._drain_error_reports(now)
        out += self._drain_task_reports(now)
        out += self._drain_launch_requests(now)
        out += self._rejoin_repaired(now)
        out += self._rejoin_reappeared(now)
        self._gc_markers(now)
        self.events += out
        return out

    def _expire_heartbeats(self, now: float) -> List[LoopEvent]:
        out = []
        for key in self.kv.expire(now):
            if not key.startswith("/nodes/"):
                continue
            node = int(key.split("/")[2])
            out.append(self._handle(now, node, ErrorKind.LOST_CONNECTION))
        return out

    def _drain_error_reports(self, now: float) -> List[LoopEvent]:
        out = []
        for key, rec in self._due_records(ERRORS_FAMILY, now):
            out.append(self._handle(now, rec["node"],
                                    ErrorKind(rec["kind"])))
        return out

    def _drain_task_reports(self, now: float) -> List[LoopEvent]:
        """Agent-announced task completions (``/tasks/finished/`` keys):
        deduplicate per coordinator task index — every worker of a task
        may report — and fire the ``task_finished`` trigger, highest
        index first so the remaining indices stay valid as entries pop.

        Reports are positional, so only those stamped with the current
        plan epoch are honored: once any finish/launch shifts the task
        set, still-queued reports refer to indices that no longer name
        the same task and are consumed without firing (their workers
        re-report against the new epoch if the task is genuinely done)."""
        due = self._due_records(FINISHED_FAMILY, now)
        if not due:
            return []
        epoch = self.kv.get(PLAN_EPOCH_KEY, 0)
        done = set()
        for key, rec in due:
            if rec.get("epoch", epoch) != epoch:
                continue                       # stale: indices have shifted
            done.add(int(rec["task"]))
        out = []
        for idx in sorted(done, reverse=True):
            if 0 <= idx < len(self.coord.entries):
                out.append(self._task_finished_event(now, idx))
        return out

    def _drain_launch_requests(self, now: float) -> List[LoopEvent]:
        """Agent-announced task launches (``/tasks/launch/`` keys): the
        task_arrival trigger (Figure 7 trigger 6), deduplicated per task
        per tick and guarded by the same published plan-epoch check as
        ``task_finished`` — a request computed against a superseded plan
        state is consumed without firing (its submitter re-announces
        against the new epoch if the launch still stands)."""
        due = self._due_records(LAUNCH_FAMILY, now)
        if not due:
            return []
        epoch = self.kv.get(PLAN_EPOCH_KEY, 0)
        pending: Dict[object, Dict] = {}
        for key, rec in due:
            if rec.get("epoch", epoch) != epoch:
                continue                       # stale: plan state moved on
            pending.setdefault(rec["task"], rec)
        out = []
        for task, rec in pending.items():
            plan = self.coord.task_launched(
                task, self.cluster.healthy_workers(),
                avg_iter_s=rec.get("avg_iter_s", 30.0))
            self.cluster.assign(list(plan.assignment))
            out.append(self._stamped(LoopEvent(
                now, rec["node"], None, Action.RESUME, plan.assignment,
                self.coord.plan_stats.last_dispatch_s)))
        return out

    def _rejoin_repaired(self, now: float) -> List[LoopEvent]:
        out = []
        for node in self.cluster.repair_due(now):
            self.cluster.recover_node(node.node_id)
            if node.node_id in self.agents:
                self.agents[node.node_id].alive = True
            # a repaired node is a fresh join, not a reappearance:
            # drop any pending lost-node snapshot so the restore path
            # cannot fire once its heartbeats resume
            self.kv.delete(f"{LOST_PREFIX}{node.node_id}")
            self._lost_nodes.discard(node.node_id)
            plan = self.coord.reconfigure(
                self.cluster.healthy_workers(),
                trigger=Trigger.NODE_JOIN)
            self.cluster.assign(list(plan.assignment))
            out.append(self._stamped(LoopEvent(
                now, node.node_id, ErrorKind.LOST_CONNECTION,
                Action.RESUME, plan.assignment,
                self.coord.plan_stats.last_dispatch_s)))
        return out

    def _rejoin_reappeared(self, now: float) -> List[LoopEvent]:
        """Undo false-positive drains: a node drained for LOST_CONNECTION
        whose heartbeat resumes (a beat strictly newer than the drain)
        was partitioned, not dead.  Rejoin it and restore the exact
        pre-drain assignment when the plan state is unchanged (same
        epoch, same task count, same healthy capacity after rejoin);
        otherwise fall back to an ordinary join replan."""
        if not self._lost_nodes:
            return []
        out = []
        for node in sorted(self._lost_nodes):
            key = f"{LOST_PREFIX}{node}"
            saved = self.kv.get(key)
            if saved is None:
                self._lost_nodes.discard(node)
                continue
            if self.cluster.nodes[node].healthy:
                self.kv.delete(key)            # repaired through other path
                self._lost_nodes.discard(node)
                continue
            hb = self.kv.get(f"/nodes/{node}/alive")
            if hb is None or float(hb) <= saved["drained_at"]:
                continue                       # still silent
            self.kv.delete(key)
            self._lost_nodes.discard(node)
            self.cluster.recover_node(node)
            if node in self.agents:
                self.agents[node].alive = True
            restorable = (
                saved["epoch"] == self.coord.plan_epoch
                and len(saved["assignment"]) == len(self.coord.entries)
                and self.cluster.healthy_workers() == saved["healthy_workers"])
            if restorable:
                self.coord.restore_assignment(saved["assignment"])
                plan, plan_s = tuple(saved["assignment"]), None
            else:
                p = self.coord.reconfigure(self.cluster.healthy_workers(),
                                           trigger=Trigger.NODE_JOIN)
                plan = p.assignment
                plan_s = self.coord.plan_stats.last_dispatch_s
            self.cluster.assign(list(plan))
            out.append(self._stamped(LoopEvent(
                now, node, ErrorKind.LOST_CONNECTION, Action.RESUME,
                plan, plan_s)))
        return out

    # ---- decision path -----------------------------------------------------

    def _drain_and_replan(self, now: float, node: int,
                          kind: ErrorKind) -> Tuple[Tuple[int, ...], float]:
        """SEV1 drain: snapshot the pre-drain state (for the reappearance
        restore path), fail the node, and fetch the reconfiguration plan."""
        if kind is ErrorKind.LOST_CONNECTION:
            self.kv.put(f"{LOST_PREFIX}{node}", {
                "drained_at": now,
                "healthy_workers": self.cluster.healthy_workers(),
                "assignment": tuple(e.n_workers for e in self.coord.entries),
                "epoch": self.coord.plan_epoch,
            }, now=now)
            self._lost_nodes.add(node)
        owner = self.cluster.placement.get(node)
        self.cluster.fail_node(node, repair_done_at=now + 86400.0)
        p = self.coord.reconfigure(self.cluster.healthy_workers(),
                                   faulted_task=owner,
                                   trigger=Trigger.ERROR)
        self.cluster.assign(list(p.assignment))
        return p.assignment, self.coord.plan_stats.last_dispatch_s

    def _handle(self, now: float, node: int, kind: ErrorKind) -> LoopEvent:
        self._case_seq += 1
        # case ids carry the wall clock so they stay unique across a
        # coordinator crash (the per-loop sequence restarts at 0)
        case_id = f"{node}:{kind.value}:{now:.3f}:{self._case_seq}"
        decision = self.coord.on_error(case_id, kind)
        plan, plan_s = None, None
        if decision.action is Action.RECONFIGURE \
                and self.cluster.nodes[node].healthy:
            # the healthy guard makes duplicate SEV1s on an
            # already-drained node (e.g. a delayed heartbeat re-creating
            # then re-expiring a lease) a no-op instead of a double drain
            plan, plan_s = self._drain_and_replan(now, node, kind)
        self.coord.close_case(case_id)
        return self._stamped(LoopEvent(now, node, kind, decision.action,
                                       plan, plan_s))

    # ---- task churn entry points (Figure 7 triggers 5 and 6) --------------

    def _task_finished_event(self, now: float, task_index: int) -> LoopEvent:
        plan = self.coord.task_finished(task_index,
                                        self.cluster.healthy_workers())
        self.cluster.assign(list(plan.assignment))
        return self._stamped(LoopEvent(
            now, -1, None, Action.RESUME, plan.assignment,
            self.coord.plan_stats.last_dispatch_s))

    def task_finished(self, now: float, task_index: int) -> LoopEvent:
        """A task completed: free its workers and replan the remainder.
        Direct entry point; agent-announced completions arrive through
        the KV store instead (``_drain_task_reports`` in ``tick``)."""
        ev = self._task_finished_event(now, task_index)
        self.events.append(ev)
        return ev

    def task_launched(self, now: float, task,
                      avg_iter_s: float = 30.0) -> LoopEvent:
        """A new task was admitted: replan the whole cluster around it."""
        plan = self.coord.task_launched(task,
                                        self.cluster.healthy_workers(),
                                        avg_iter_s=avg_iter_s)
        self.cluster.assign(list(plan.assignment))
        ev = self._stamped(LoopEvent(
            now, -1, None, Action.RESUME, plan.assignment,
            self.coord.plan_stats.last_dispatch_s))
        self.events.append(ev)
        return ev

    # ---- escalation entry point (agents report an action failed) ----------

    def action_failed(self, now: float, node: int,
                      kind: ErrorKind) -> LoopEvent:
        """A reattempt/restart did not fix it: escalate one level."""
        self._case_seq += 1
        case_id = f"{node}:{kind.value}:{now:.3f}:esc{self._case_seq}"
        self.coord.on_error(case_id, kind)
        decision = self.coord.on_action_failed(case_id)
        plan, plan_s = None, None
        if decision.action is Action.RECONFIGURE \
                and self.cluster.nodes[node].healthy:
            plan, plan_s = self._drain_and_replan(now, node, kind)
        self.coord.close_case(case_id)
        ev = self._stamped(LoopEvent(now, node, kind, decision.action,
                                     plan, plan_s))
        self.events.append(ev)
        return ev
