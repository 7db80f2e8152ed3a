"""Copied from ``repro/core/agent.py``: the Unicron agent (§3.1), one per
machine.

Responsibilities: (i) persistent heartbeat to the coordinator through the
status monitor (node health detection), (ii) one monitoring thread per GPU
(process supervision + exception propagation), (iii) executing recovery
actions — including restoring training state from the nearest checkpoint
tier (``recover_checkpoint``), (iv) managing the GEMINI-style in-memory
checkpoint tier.

Delivery semantics (the producer side of the contract in ``kvstore.py``):
every report — errors, task finishes, launch admissions — is published
*at least once*.  The agent keeps each record in a local outbox and
re-publishes it with seeded exponential backoff + jitter until the
control loop acknowledges consumption by writing the record's
``CONSUMED_PREFIX`` marker; during a partition (``KVUnavailable``) the
outbox simply queues and flushes on heal (graceful degradation).  Keys
are deterministic per report, so a re-publish can never double-fire a
trigger: the consumer's marker makes re-delivery a no-op.  Heartbeats
are NOT outboxed — a lost beat is superseded by the next one, and a
stale beat must not refresh a lease.

In this reproduction the agent's timing behavior runs inside the
discrete-event simulator; its *state machine* is the real code below.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.detection import (ErrorKind, OnlineStatMonitor,
                                        classify, detection_time)
from repro_torch.core.kvstore import CONSUMED_PREFIX, KVStore, KVUnavailable

HEARTBEAT_INTERVAL_S = 2.0
HEARTBEAT_TTL_S = 6.0

# outbox re-publish backoff: base * 2^attempt, capped, with seeded
# jitter in [0.5, 1.5).  The cap keeps the worst-case re-publish lag
# (and therefore the spacing the chaos convergence harness needs
# between world events) small.
BACKOFF_BASE_S = 1.0
BACKOFF_CAP_S = 8.0


def heartbeat_cohort(agents, now: float) -> None:
    """Publish heartbeats for a whole agent cohort in one array write
    per shared store (``KVStore.heartbeat_batch`` — the fleet-scale
    ingestion path).  Agents whose client offers no batch entry point
    (chaos-bound node clients, the legacy store) beat individually, so
    partition semantics and the legacy path are unchanged.  ``agents``
    is the usual node-id -> agent mapping; dead agents are skipped
    (same contract as ``UnicronAgent.heartbeat``)."""
    singles = []
    batches: Dict[int, Tuple[object, list]] = {}
    for agent in agents.values():
        if not agent.alive:
            continue
        batch = getattr(agent.kv, "heartbeat_batch", None)
        if batch is None:
            singles.append(agent)
        else:
            batches.setdefault(id(agent.kv), (agent.kv, []))[1].append(
                agent.node_id)
    for store, node_ids in batches.values():
        store.heartbeat_batch(node_ids, now, ttl=HEARTBEAT_TTL_S)
    for agent in singles:
        agent.heartbeat(now)


@dataclass
class GPUMonitor:
    """Dedicated CPU monitoring thread for one GPU (§3.1)."""
    gpu_id: int
    healthy: bool = True
    last_exception: Optional[ErrorKind] = None

    def observe_exception(self, kind: ErrorKind) -> ErrorKind:
        self.last_exception = kind
        self.healthy = False
        return kind


@dataclass
class _OutboxItem:
    record: Dict
    created: float
    next_retry: float
    attempts: int = 0


class UnicronAgent:
    def __init__(self, node_id: int, kv: KVStore, n_gpus: int = 8,
                 seed: Optional[int] = None):
        self.node_id = node_id
        self.kv = kv
        self.monitors = [GPUMonitor(g) for g in range(n_gpus)]
        self.stat_monitor = OnlineStatMonitor()
        self.alive = True
        self._launch_seq = 0
        self._rng = random.Random(node_id if seed is None else seed)
        self._outbox: Dict[str, _OutboxItem] = {}

    # ---- heartbeat / node health -------------------------------------------

    def heartbeat(self, now: float) -> None:
        if not self.alive:
            return
        try:
            self.kv.put(f"/nodes/{self.node_id}/alive", now,
                        ttl=HEARTBEAT_TTL_S, now=now)
        except KVUnavailable:
            pass          # partitioned: the lease lapses; next beat retries

    def kill(self) -> None:
        """Simulated node loss: heartbeats stop; the coordinator's lease
        expiry raises LOST_CONNECTION."""
        self.alive = False

    # ---- at-least-once publication (outbox) --------------------------------

    @property
    def outbox_size(self) -> int:
        return len(self._outbox)

    def _backoff(self, attempts: int) -> float:
        base = min(BACKOFF_CAP_S, BACKOFF_BASE_S * (2.0 ** attempts))
        return base * (0.5 + self._rng.random())

    def _publish(self, key: str, record: Dict, now: float) -> None:
        self._outbox[key] = _OutboxItem(record=record, created=now,
                                        next_retry=now)
        self.flush_outbox(now)

    def flush_outbox(self, now: float) -> None:
        """Re-publish every unacknowledged record that is due.  A record
        retires when its processed marker appears (the control loop's
        delete-on-consume ack); until then each attempt re-puts the SAME
        key, so duplicates collapse at the consumer."""
        for key, item in list(self._outbox.items()):
            if item.next_retry > now:
                continue
            try:
                if self.kv.get(CONSUMED_PREFIX + key) is not None:
                    del self._outbox[key]          # acked: retire
                    continue
                self.kv.put(key, item.record, now=now)
            except KVUnavailable:
                pass                # partitioned: stay queued, back off
            item.attempts += 1
            item.next_retry = now + self._backoff(item.attempts)

    # ---- in-band error reporting ---------------------------------------

    def report(self, kind: ErrorKind, now: float,
               avg_iter_s: float = 30.0) -> Dict:
        """Detect + publish an error to the status monitor.  Returns the
        record including when the coordinator will see it."""
        method, sev = classify(kind)
        latency = detection_time(kind, avg_iter_s, unicron=True)
        record = {"node": self.node_id, "kind": kind.value,
                  "severity": int(sev), "method": method.value,
                  "raised_at": now, "visible_at": now + latency}
        self._publish(f"/errors/{self.node_id}/{now:.3f}", record, now)
        return record

    # ---- task churn reports (Figure 7 trigger 5) -------------------------

    def report_task_finished(self, task_index: int, now: float,
                             epoch: int) -> Dict:
        """Announce through the status monitor that the coordinator task
        this node participates in has completed (Figure 7 trigger 5).
        Completion is in-band and immediate — no detection latency — and
        every worker of the task may report; the control loop deduplicates
        per task per tick before firing ``task_finished``.

        ``epoch`` MUST be the plan epoch under which the agent learned
        ``task_index`` — index and epoch travel together in a plan
        dispatch (``PLAN_EPOCH_KEY`` at dispatch time), and pairing a
        dispatch-time index with a fresher epoch would defeat the
        staleness guard.  Task indices are positional, so the control
        loop drops any report whose epoch predates a task-set change
        instead of resolving it against shifted indices."""
        record = {"node": self.node_id, "task": int(task_index),
                  "epoch": int(epoch), "finished_at": now,
                  "visible_at": now}
        self._publish(f"/tasks/finished/{now:.3f}/{self.node_id}",
                      record, now)
        return record

    # ---- task launch admission (Figure 7 trigger 6) ----------------------

    def request_task_launch(self, task, now: float, epoch: int,
                            avg_iter_s: float = 30.0) -> Dict:
        """Announce through the status monitor that a new task asks to be
        admitted to the cluster (Figure 7 trigger 6) — the agent-side
        counterpart of ``report_task_finished`` that closes the ROADMAP
        churn gap: launches previously only entered through the
        scenario/simulator side.  Worker counts are NOT part of the request:
        admission sizing is the planner's decision (the coordinator
        replans the whole cluster around the new task).

        ``epoch`` MUST be the plan epoch the requester computed its
        admission request against: the control loop drops requests whose
        epoch predates a task-set change (the same staleness guard as
        finish reports — a request sized against a stale plan state is
        re-announced by its submitter against the new epoch).  Multiple
        nodes may announce the same launch; the control loop deduplicates
        per task per tick before firing ``task_launched``."""
        self._launch_seq += 1
        record = {"node": self.node_id, "task": task,
                  "epoch": int(epoch), "avg_iter_s": float(avg_iter_s),
                  "requested_at": now, "visible_at": now}
        # Key carries a per-agent sequence (two distinct launches from one
        # node at the same timestamp must not overwrite each other) and a
        # zero-padded timestamp: the control loop drains keys in sorted
        # order, and admission order determines coordinator entry order
        # and which record wins the per-task dedup, so lexicographic must
        # equal chronological across digit-width boundaries.
        self._publish(
            f"/tasks/launch/{now:017.3f}/{self.node_id}/{self._launch_seq}",
            record, now)
        return record

    # ---- recovery: nearest-tier checkpoint restore (§6.3 / GEMINI) -------

    def recover_checkpoint(self, store, task: str, rank: int, *,
                           persist_dir: Optional[str] = None,
                           template=None) -> Tuple[object, int, str]:
        """Restore a rank's training state along the recovery preference
        order: local host RAM -> ring-neighbor replica (both via the
        GEMINI ``InMemoryStore``) -> persistent remote tier.  Returns
        (state, step, source).  Raises ``FileNotFoundError`` when no tier
        holds the state (fresh start)."""
        hit = store.get(task, rank)
        if hit is not None:
            step, tree, src = hit
            return tree, step, src
        if persist_dir is not None:
            from repro_torch.checkpoint import persistent
            step = persistent.latest_step(persist_dir)
            if step is not None:
                return (persistent.restore(persist_dir, template), step,
                        "persistent")
        raise FileNotFoundError(
            f"no checkpoint for task={task!r} rank={rank} in any tier")

    # ---- iteration statistics (online statistical monitoring) -----------

    def observe_iteration(self, seconds: float) -> None:
        self.stat_monitor.observe(seconds)

    def check_progress(self, waited_s: float) -> str:
        return self.stat_monitor.status(waited_s)
