"""Copied from ``repro/core/kvstore.py``: the etcd-like distributed KV store
(the coordinator's *status monitor*), sharded for fleet scale.

Single-process stand-in for etcd [11]: prefix watches, leases with TTL
(expiry driven by the simulator clock), and compare-and-swap.  The
coordinator consolidates agent-reported process statuses here (§3.2).

Sharded layout (fleet-scale contract)
-------------------------------------

The namespace is partitioned into per-prefix **shard buckets** so every
hot-path operation touches only the keys that could match:

* A static registry of control-plane namespaces (``/errors/``,
  ``/tasks/finished/``, ``/coord/journal/``, ...) routes each key to its
  namespace by longest prefix match; keys outside every registered
  namespace land in a catch-all shard.
* Namespaces whose next path segment is a node id (``/errors/<node>/``,
  ``/nodes/<node>/``, ``/coord/lost/<node>``) are further split into
  node-group buckets of ``NODE_GROUP_SIZE`` ids, so ``prefix()`` over a
  single node's keys scans one bucket, and ``prefix()`` over a whole
  family merges only that family's buckets — O(matching keys), never
  O(store).
* Heartbeat keys (``/nodes/<id>/alive``) bypass the dict shards
  entirely and live in an array-native ``detection.HeartbeatTable``:
  beat values and lease deadlines sit in per-node-group numpy arrays,
  ``expire()`` is one vectorized comparison + argwhere per group, and
  ``heartbeat_batch()`` ingests a whole agent cohort's beats as one
  array scatter.  Leases on ordinary keys live in a per-bucket
  ``_LeaseLedger`` (parallel numpy deadline array + slot map), expired
  the same vectorized way.

Event queues (cursor-consume contract)
--------------------------------------

Each drain family (``/errors/``, ``/tasks/finished/``,
``/tasks/launch/``) additionally has an **append-cursor event queue**:
every ``put`` of a key in the family appends the key to the family's
append-only log, and the control loop consumes from a cursor it
persists under ``CURSOR_PREFIX + family`` instead of scanning,
sorting, and deleting the whole prefix each tick.  The queue is an
*index*, not the source of truth: records, ``/consumed`` markers and
delete-on-consume stay exactly as below, so a consumer that crashes
mid-drain replays the un-cursored tail idempotently, and a scan-based
consumer (``LegacyKVStore``) sees identical semantics.  Entries below
the persisted cursor are compacted away lazily.

Delivery-semantics contract (shared with ``agent.py``/``controlloop.py``,
exercised by ``core.chaos``):

* **At-least-once publish.**  An agent ``put`` may be dropped, delayed,
  duplicated, or rejected during a partition (``KVUnavailable``) by a
  chaotic transport (``chaos.ChaosKVStore``).  Producers therefore keep
  every report in a local outbox and re-publish with seeded exponential
  backoff until the consumer acknowledges it; a record may consequently
  be delivered more than once, and may re-appear *after* it was deleted
  (each re-delivery re-appends to the family queue — queue entries are
  at-least-once too).
* **Idempotent consume.**  The control loop deletes a record on consume
  (bounding KV residency) and writes a processed marker under
  ``CONSUMED_PREFIX + key`` whose value is the consume time.  The marker
  doubles as the producer-visible acknowledgement; a re-delivered record
  whose marker exists is deleted without re-firing.  Markers are
  garbage-collected after a retention window that must exceed the
  transport's maximum delay + partition span (``chaos.ChaosSchedule``
  generators guarantee this for generated schedules).
* **Epoch fencing.**  The coordinator journals its state under
  ``/coord/journal/*`` and claims an incarnation epoch; writes from a
  deposed incarnation raise (``coordinator.StaleCoordinatorError``), so
  a crashed-and-recovered coordinator can never be shadowed by its
  predecessor.

``KVStore`` is the sharded store; ``LegacyKVStore`` keeps the original
flat-dict implementation as the equivalence baseline (identical
observable semantics, O(store) scans).  Both are *perfect* stores (no
loss, no delay); ``chaos.ChaosKVStore`` wraps the sharded store and
injects the failure modes while preserving this interface.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.detection import HeartbeatTable

# Well-known status-monitor keys shared by coordinator, control loop and
# agents.  PLAN_EPOCH_KEY holds the coordinator's task-set epoch: bumped
# whenever the entry list mutates (finish/launch), so positional task
# indices in agent churn reports can be checked for freshness.
PLAN_EPOCH_KEY = "/plan/epoch"

# Processed-marker namespace: the control loop acknowledges a consumed
# record by writing ``CONSUMED_PREFIX + key`` = consume time (and deletes
# the record itself).  Agents poll the marker to retire outbox entries.
CONSUMED_PREFIX = "/consumed"

# Families with an append-cursor event queue (the control loop's drain
# sources).  The loop persists its consume cursor per family under
# ``CURSOR_PREFIX + family`` so a recovered loop resumes where the dead
# one stopped instead of rescanning history.
QUEUE_FAMILIES = ("/errors/", "/tasks/finished/", "/tasks/launch/")
CURSOR_PREFIX = "/cursors"

# Node-id-bucketed namespaces split into groups of this many ids.
NODE_GROUP_SIZE = 1024

# Longest-match namespace registry (order: longest first).  Second
# element: does the segment after the prefix carry a node id (-> group
# buckets)?  The catch-all "" namespace is implicit.
_NAMESPACES: Tuple[Tuple[str, bool], ...] = (
    ("/consumed/tasks/finished/", False),
    ("/consumed/tasks/launch/", False),
    ("/consumed/errors/", True),
    ("/consumed/", False),
    ("/tasks/finished/", False),
    ("/tasks/launch/", False),
    ("/coord/journal/", False),
    ("/coord/lost/", True),
    ("/cursors/", False),
    ("/errors/", True),
    ("/nodes/", True),
)

_HB_PRE = "/nodes/"
_HB_SUF = "/alive"


class KVUnavailable(Exception):
    """The store is unreachable from this client (network partition).

    Raised only by chaotic transports (``chaos.ChaosKVStore`` node
    clients); the base in-process store never raises it.  Producers
    treat it as a queue-locally signal and flush on heal."""


def _hb_node(key: str) -> Optional[int]:
    """Node id for a heartbeat key ``/nodes/<id>/alive``, else None."""
    if key.startswith(_HB_PRE) and key.endswith(_HB_SUF):
        mid = key[len(_HB_PRE):-len(_HB_SUF)]
        if mid.isdigit():
            return int(mid)
    return None


class _LeaseLedger:
    """Array-native lease deadlines for one shard bucket.

    The ``detection.FleetMonitor`` idiom applied to leases: deadlines
    live in a numpy array indexed by slot, keys map to slots through a
    dict + free list, and expiry is one vectorized comparison +
    argwhere instead of a per-entry Python scan.  Capacity doubles
    geometrically."""

    __slots__ = ("_deadline", "_keys", "_slot", "_free", "_n")

    def __init__(self, cap: int = 8):
        self._deadline = np.full(cap, np.inf)
        self._keys: List[Optional[str]] = [None] * cap
        self._slot: Dict[str, int] = {}
        self._free: List[int] = list(range(cap - 1, -1, -1))
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def set(self, key: str, deadline: float) -> None:
        slot = self._slot.get(key)
        if slot is None:
            if not self._free:
                cap = self._deadline.size
                grown = np.full(2 * cap, np.inf)
                grown[:cap] = self._deadline
                self._deadline = grown
                self._keys.extend([None] * cap)
                self._free = list(range(2 * cap - 1, cap - 1, -1))
            slot = self._free.pop()
            self._slot[key] = slot
            self._keys[slot] = key
            self._n += 1
        self._deadline[slot] = deadline

    def drop(self, key: str) -> None:
        slot = self._slot.pop(key, None)
        if slot is not None:
            self._deadline[slot] = np.inf
            self._keys[slot] = None
            self._free.append(slot)
            self._n -= 1

    def expired(self, now: float) -> List[str]:
        if not self._n:
            return []
        hits = np.nonzero(self._deadline <= now)[0]
        out = []
        for slot in hits:
            key = self._keys[slot]
            if key is not None:
                out.append(key)
        for key in out:
            self.drop(key)
        return out


class _Bucket:
    """One shard: a plain dict of key -> value plus a lazily created
    lease ledger for the (rare) leased non-heartbeat keys."""

    __slots__ = ("data", "leases")

    def __init__(self):
        self.data: Dict[str, Any] = {}
        self.leases: Optional[_LeaseLedger] = None

    def ledger(self) -> _LeaseLedger:
        if self.leases is None:
            self.leases = _LeaseLedger()
        return self.leases


class KVStore:
    """Sharded status monitor (see module docstring for the layout)."""

    def __init__(self):
        # namespace -> {group-or-None -> _Bucket}
        self._shards: Dict[str, Dict[Optional[int], _Bucket]] = {
            ns: {} for ns, _ in _NAMESPACES}
        self._shards[""] = {}
        self._heartbeats = HeartbeatTable(group_size=NODE_GROUP_SIZE)
        # family -> (compacted base index, live tail of appended keys)
        self._qbase: Dict[str, int] = {f: 0 for f in QUEUE_FAMILIES}
        self._qlog: Dict[str, List[str]] = {f: [] for f in QUEUE_FAMILIES}
        self._watches: List[Tuple[str, Callable[[str, str, Any], None]]] = []

    # ---- routing -----------------------------------------------------------

    @staticmethod
    def _route(key: str) -> Tuple[str, Optional[int]]:
        """(namespace, node-group) for a key; ("", None) = catch-all."""
        for ns, grouped in _NAMESPACES:
            if key.startswith(ns):
                if grouped:
                    seg = key[len(ns):]
                    cut = seg.find("/")
                    if cut >= 0:
                        seg = seg[:cut]
                    if seg.isdigit():
                        return ns, int(seg) // NODE_GROUP_SIZE
                return ns, None
        return "", None

    def _bucket(self, ns: str, group: Optional[int]) -> _Bucket:
        shards = self._shards[ns]
        b = shards.get(group)
        if b is None:
            b = shards[group] = _Bucket()
        return b

    # ---- basic ops ---------------------------------------------------------

    def put(self, key: str, value: Any, *, ttl: Optional[float] = None,
            now: float = 0.0) -> None:
        node = _hb_node(key)
        if node is not None:
            self._heartbeats.beat(node, value,
                                  now + ttl if ttl else np.inf)
            self._notify("put", key, value)
            return
        ns, group = self._route(key)
        b = self._bucket(ns, group)
        b.data[key] = value
        if ttl:
            b.ledger().set(key, now + ttl)
        elif b.leases is not None:
            b.leases.drop(key)
        if ns in self._qbase:
            self._qlog[ns].append(key)
        self._notify("put", key, value)

    def get(self, key: str, default: Any = None) -> Any:
        node = _hb_node(key)
        if node is not None:
            return self._heartbeats.get(node, default)
        ns, group = self._route(key)
        b = self._shards[ns].get(group)
        if b is None:
            return default
        return b.data.get(key, default)

    def delete(self, key: str) -> None:
        node = _hb_node(key)
        if node is not None:
            if self._heartbeats.pop(node):
                self._notify("delete", key, None)
            return
        ns, group = self._route(key)
        b = self._shards[ns].get(group)
        if b is not None and key in b.data:
            del b.data[key]
            if b.leases is not None:
                b.leases.drop(key)
            self._notify("delete", key, None)

    def prefix(self, pre: str) -> Dict[str, Any]:
        """All key -> value pairs under ``pre`` — O(matching keys): only
        shard buckets whose namespace can intersect the prefix are
        visited, and a namespace fully inside the prefix is merged
        without per-key filtering."""
        out: Dict[str, Any] = {}
        for ns, shards in self._shards.items():
            if ns and ns.startswith(pre):
                # whole namespace matches: bulk-merge its buckets
                for b in shards.values():
                    out.update(b.data)
                continue
            if ns and not pre.startswith(ns):
                continue
            if ns == "" and pre:
                # catch-all: must filter (cheap — hot families are
                # registered namespaces, the catch-all stays small)
                for b in shards.values():
                    for k, v in b.data.items():
                        if k.startswith(pre):
                            out[k] = v
                continue
            # pre lies inside this namespace: narrow to one group bucket
            # when the next segment is a complete node id
            buckets: Iterable[_Bucket] = shards.values()
            if ns:
                seg = pre[len(ns):]
                cut = seg.find("/")
                if cut >= 0 and seg[:cut].isdigit():
                    b = shards.get(int(seg[:cut]) // NODE_GROUP_SIZE)
                    buckets = (b,) if b is not None else ()
            for b in buckets:
                for k, v in b.data.items():
                    if k.startswith(pre):
                        out[k] = v
        if _HB_PRE.startswith(pre) or pre.startswith(_HB_PRE):
            for node, value in self._heartbeats.items():
                k = f"{_HB_PRE}{node}{_HB_SUF}"
                if k.startswith(pre):
                    out[k] = value
        return out

    def cas(self, key: str, expect: Any, value: Any) -> bool:
        """Compare-and-swap the *value* only: a successful swap on a
        leased key (e.g. a heartbeat) keeps its existing lease instead of
        silently clearing the expiry."""
        node = _hb_node(key)
        if node is not None:
            if self._heartbeats.cas(node, expect, value):
                self._notify("put", key, value)
                return True
            return False
        ns, group = self._route(key)
        b = self._bucket(ns, group)
        if b.data.get(key) == expect:
            b.data[key] = value
            if ns in self._qbase:
                self._qlog[ns].append(key)
            self._notify("put", key, value)
            return True
        return False

    # ---- leases (heartbeats) -----------------------------------------------

    def heartbeat_batch(self, node_ids, now: float,
                        ttl: Optional[float] = None) -> None:
        """Ingest a whole agent cohort's heartbeats as one array write:
        equivalent to ``put(f"/nodes/<id>/alive", now, ttl=ttl, now=now)``
        per id, minus the per-key Python overhead."""
        deadline = now + ttl if ttl else np.inf
        self._heartbeats.beat_batch(node_ids, now, deadline)
        if self._watches:
            for node in node_ids:
                self._notify("put", f"{_HB_PRE}{int(node)}{_HB_SUF}", now)

    def expire(self, now: float) -> List[str]:
        """Drop entries whose lease lapsed; returns the expired keys in
        sorted order.  Heartbeats expire through one vectorized
        comparison per node-group array; ordinary leased keys through
        each bucket's ledger.  The coordinator treats an expired
        /nodes/<id>/alive key as a lost connection -> SEV1 (Table 1)."""
        dead = [f"{_HB_PRE}{node}{_HB_SUF}"
                for node in self._heartbeats.expired(now)]
        for shards in self._shards.values():
            for b in shards.values():
                if b.leases is None or not len(b.leases):
                    continue
                for key in b.leases.expired(now):
                    b.data.pop(key, None)
                    dead.append(key)
        dead.sort()
        for k in dead:
            self._notify("expire", k, None)
        return dead

    # ---- event queues (drain families) -------------------------------------

    def queue_len(self, family: str) -> int:
        """Total appends ever made to a family queue (monotonic)."""
        return self._qbase[family] + len(self._qlog[family])

    def queue_slice(self, family: str, start: int) -> List[str]:
        """Appended keys from absolute index ``start`` onward.  Entries
        below ``start`` are compacted away (the caller's persisted
        cursor guarantees it will never ask for them again)."""
        base = self._qbase[family]
        if start > base:
            del self._qlog[family][:start - base]
            self._qbase[family] = base = start
        return self._qlog[family][start - base:]

    # ---- watches -----------------------------------------------------------

    def watch(self, pre: str, cb: Callable[[str, str, Any], None]) -> None:
        self._watches.append((pre, cb))

    def _notify(self, op: str, key: str, value: Any) -> None:
        for pre, cb in self._watches:
            if key.startswith(pre):
                cb(op, key, value)


# ---------------------------------------------------------------------------
# Legacy flat-dict store (equivalence baseline)
# ---------------------------------------------------------------------------


@dataclass
class _Entry:
    value: Any
    lease_expires: Optional[float] = None       # absolute sim time


class LegacyKVStore:
    """The original O(store)-scan implementation: one flat dict, every
    ``prefix()`` a full scan, every lease a Python object.  Kept as the
    behavioural baseline — the control loop falls back to scan-based
    drains on stores without queues, and the equivalence suite replays
    identical traces through both stores to prove the sharded path
    changes no observable semantics (``launch.controlplane.fleet``
    measures what that costs at fleet scale)."""

    def __init__(self):
        self._data: Dict[str, _Entry] = {}
        self._watches: List[Tuple[str, Callable[[str, str, Any], None]]] = []

    # ---- basic ops ---------------------------------------------------------

    def put(self, key: str, value: Any, *, ttl: Optional[float] = None,
            now: float = 0.0) -> None:
        self._data[key] = _Entry(value, now + ttl if ttl else None)
        self._notify("put", key, value)

    def get(self, key: str, default: Any = None) -> Any:
        e = self._data.get(key)
        return default if e is None else e.value

    def delete(self, key: str) -> None:
        if key in self._data:
            del self._data[key]
            self._notify("delete", key, None)

    def prefix(self, pre: str) -> Dict[str, Any]:
        return {k: e.value for k, e in self._data.items()
                if k.startswith(pre)}

    def cas(self, key: str, expect: Any, value: Any) -> bool:
        """Compare-and-swap the *value* only: a successful swap on a
        leased key (e.g. a heartbeat) keeps its existing lease instead of
        silently clearing the expiry."""
        e = self._data.get(key)
        if (e.value if e is not None else None) == expect:
            self._data[key] = _Entry(value,
                                     e.lease_expires if e else None)
            self._notify("put", key, value)
            return True
        return False

    # ---- leases (heartbeats) -----------------------------------------------

    def expire(self, now: float) -> List[str]:
        """Drop entries whose lease lapsed; returns the expired keys in
        sorted order (matching the sharded store, whose shard iteration
        order is not insertion order)."""
        dead = sorted(k for k, e in self._data.items()
                      if e.lease_expires is not None
                      and e.lease_expires <= now)
        for k in dead:
            del self._data[k]
            self._notify("expire", k, None)
        return dead

    # ---- watches -----------------------------------------------------------

    def watch(self, pre: str, cb: Callable[[str, str, Any], None]) -> None:
        self._watches.append((pre, cb))

    def _notify(self, op: str, key: str, value: Any) -> None:
        for pre, cb in self._watches:
            if key.startswith(pre):
                cb(op, key, value)
