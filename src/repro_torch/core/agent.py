"""Unicron agent (§3.1), the part the training loop calls: in-band error
reports published at least once through an outbox, and iteration
statistics for the online statistical monitor.

Copied from ``repro/core/agent.py`` (``UnicronAgent.report``,
``flush_outbox``, ``observe_iteration``).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.detection import (ErrorKind, OnlineStatMonitor,
                                        classify, detection_time)
from repro_torch.core.kvstore import CONSUMED_PREFIX, KVStore, KVUnavailable

# outbox re-publish backoff: base * 2^attempt, capped, with seeded jitter
BACKOFF_BASE_S = 1.0
BACKOFF_CAP_S = 8.0


@dataclass
class _OutboxItem:
    record: Dict
    created: float
    next_retry: float
    attempts: int = 0


class UnicronAgent:
    def __init__(self, node_id: int, kv: KVStore,
                 seed: Optional[int] = None):
        self.node_id = node_id
        self.kv = kv
        self.stat_monitor = OnlineStatMonitor()
        self._rng = random.Random(node_id if seed is None else seed)
        self._outbox: Dict[str, _OutboxItem] = {}

    def _backoff(self, attempts: int) -> float:
        base = min(BACKOFF_CAP_S, BACKOFF_BASE_S * (2.0 ** attempts))
        return base * (0.5 + self._rng.random())

    def _publish(self, key: str, record: Dict, now: float) -> None:
        self._outbox[key] = _OutboxItem(record=record, created=now,
                                        next_retry=now)
        self.flush_outbox(now)

    def flush_outbox(self, now: float) -> None:
        """Re-publish every unacknowledged record that is due; a record
        retires when its consumed marker appears."""
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

    def observe_iteration(self, seconds: float) -> None:
        self.stat_monitor.observe(seconds)
