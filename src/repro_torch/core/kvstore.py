"""In-process etcd-like KV store (the coordinator's status monitor): put,
get and TTL leases driven by the caller's clock.

A plain-dict subset of ``repro/core/kvstore.py`` (whose ``LegacyKVStore``
has the same semantics); the sharded fleet-scale layout is needed by
neither the training loop nor the coordinator.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

# The coordinator's task-set epoch: bumped whenever the entry list mutates
# (finish/launch), so positional task indices in agent churn reports can be
# checked for freshness.
PLAN_EPOCH_KEY = "/plan/epoch"

# The control loop acknowledges a consumed record by writing
# ``CONSUMED_PREFIX + key``; agents poll the marker to retire outbox entries.
CONSUMED_PREFIX = "/consumed"


class KVUnavailable(Exception):
    """The store is unreachable from this client (network partition)."""


class KVStore:
    def __init__(self):
        self._data: Dict[str, Tuple[Any, Optional[float]]] = {}

    def put(self, key: str, value: Any, *, ttl: Optional[float] = None,
            now: float = 0.0) -> None:
        self._data[key] = (value, now + ttl if ttl else None)

    def get(self, key: str, default: Any = None) -> Any:
        e = self._data.get(key)
        return default if e is None else e[0]

    def expire(self, now: float) -> List[str]:
        """Drop entries whose lease lapsed; returns their keys, sorted."""
        dead = sorted(k for k, (_, exp) in self._data.items()
                      if exp is not None and exp <= now)
        for k in dead:
            del self._data[k]
        return dead
