"""Unicron coordinator (§3.2) — cluster-level decisions.  Copied from
``repro/core/coordinator.py``; the only change is the ``device`` its plan
tables run their max-plus kernels on.

Consumes agent status from the KV store, classifies failures, decides
actions (handling.py), and generates reconfiguration plans (planner.py)
over *all* tasks in the cluster.  The discrete-event simulator provides
time; every decision here is the real algorithm.

Crash-recovery: the coordinator journals its durable state — task set,
per-task assignment/status, plan epoch, and open failure cases — to
``/coord/journal/*`` in the status monitor on every mutation, and
``UnicronCoordinator.recover(kv, hw, ...)`` rebuilds an equivalent
coordinator (entries, epoch, cases, and a refreshed ``PlanTable``) from
that journal after a crash.  Each instance claims an incarnation epoch
under ``/coord/incarnation`` at construction; journal and plan-epoch
writes are fenced on it, so a deposed predecessor that wakes up after a
recovery raises ``StaleCoordinatorError`` instead of shadowing its
successor's state.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core import planner, waf as waf_mod
from repro_torch.core.costmodel import Hardware
from repro_torch.core.detection import ErrorKind, Severity
from repro_torch.core.handling import (FailureCase, HandlingDecision,
                                       Trigger, decide)
from repro_torch.core.kvstore import KVStore, PLAN_EPOCH_KEY
from repro_torch.core.planner import Plan, PlanInput, PlanTable
from repro_torch.core.waf import Task
from repro_torch.device import resolve_device

# Coordinator journal: rewritten in full on every mutation (task churn,
# reconfiguration, case open/close).  Small — O(tasks + open cases) —
# so full rewrite beats a log that would need compaction.
JOURNAL_TASKS_KEY = "/coord/journal/tasks"
JOURNAL_EPOCH_KEY = "/coord/journal/epoch"
JOURNAL_CASES_KEY = "/coord/journal/cases"
INCARNATION_KEY = "/coord/incarnation"


class StaleCoordinatorError(RuntimeError):
    """A deposed coordinator incarnation tried to write journaled state
    after a successor claimed the incarnation key (fencing, §3.2)."""


@dataclass
class TaskEntry:
    """Coordinator-side record of a running task (the 'task set')."""
    task: Task
    n_workers: int
    status: str = "running"            # running | transitioning | waiting
    avg_iter_s: float = 30.0
    state_bytes: float = 0.0


@dataclass
class PlanStats:
    """Planner-engine accounting: how long plan generation takes and how
    often failure-time dispatch was an O(1) table hit (the §5.2 claim the
    vectorized engine has to uphold at scale).

    The ``batched_*``/``lazy_tracebacks`` counters mirror the batched
    PlanTable engine's ``batch_stats``: tree/complement levels merged,
    stacked max-plus kernel launches issued, and plans materialized by
    on-demand argmax traceback.  They accumulate the deltas observed
    through THIS coordinator's table handle — under a cache-shared table
    another coordinator's work lands on whichever handle reads it first,
    so sums over all coordinators remain exact."""
    table_rebuilds: int = 0
    table_rebuild_s: float = 0.0       # cumulative
    last_rebuild_s: float = 0.0
    lookup_hits: int = 0
    fresh_solves: int = 0
    fresh_solve_s: float = 0.0         # cumulative
    last_dispatch_s: float = 0.0       # latency of the last plan_for()
    task_launches: int = 0
    task_finishes: int = 0
    batched_levels: int = 0            # level-synchronous merge sweeps
    batched_launches: int = 0          # stacked max-plus kernel launches
    lazy_tracebacks: int = 0           # plans materialized by traceback
    device_dispatches: int = 0         # fused-engine programs run


class UnicronCoordinator:
    def __init__(self, tasks: List[Task], assignment: List[int],
                 hw: Hardware, kv: Optional[KVStore] = None,
                 mtbf_per_worker_s: float = 30 * 86400.0,
                 d_transition_s: float = 120.0,
                 plan_cache: Optional[planner.PlannerCache] = None,
                 n_cluster_workers: Optional[int] = None,
                 workers_per_node: int = 8,
                 plan_engine: str = "batched",
                 prebuild_scenarios: bool = False,
                 journal: bool = True, device="cuda"):
        """``plan_cache``: share a ``PlannerCache`` across coordinators —
        plan tables become lazy (scenarios assembled on first lookup) and
        rows/prefix-suffix DPs/solves are reused across rebuilds, with
        plans float-identical to the eager uncached build.

        ``n_cluster_workers``: total cluster capacity.  When given,
        D_running (Eq. 3) is the expected time to the next failure of the
        WHOLE cluster — failures arrive per node over the full fleet, not
        just the assigned workers — and the planner's DP arrays are sized
        once for that capacity, which keeps plan values comparable (and
        cache keys identical) across rebuilds at different totals.

        ``plan_engine``: incremental PlanTable engine — ``"batched"``
        (default: level-synchronous stacked merges, value-only assembly,
        lazy traceback), ``"fused"`` (the whole-table value rebuild as
        ONE fused program; same-signature churn reuses the cached
        program, ``device_dispatches`` counts the executions),
        ``"segtree"`` (dyadic segment tree, O(log m) churn invalidation,
        one kernel call per merge) or ``"chain"`` (host prefix/suffix
        chains).  ``prebuild_scenarios`` composes with any of them.

        ``prebuild_scenarios``: run the whole-table value rebuild on
        every plan-table refresh (including the churn triggers, where the
        task set shifts and ANY scenario may fire next) — on the batched
        engine a constant number of stacked launches per tree level, so
        every subsequent dispatch is a memo read plus one lazy traceback.
        Off by default: the Monte-Carlo engines keep lazy tables (most
        intermediate states are never consulted).

        ``journal``: persist task set / epoch / open cases to
        ``/coord/journal/*`` on every mutation so ``recover`` can rebuild
        this coordinator after a crash.  On by default; benchmarks turn
        it off to measure the journaling overhead.

        ``device``: where every plan table runs its max-plus kernels —
        ``"cuda"`` (default; raises without CUDA) or ``"cpu"`` (the plain
        PyTorch versions)."""
        self.hw = hw
        self.device = resolve_device(device)
        # normalize through the registry so legacy spellings resolve (and
        # typos fail) at construction, not at the first reconfigure
        self.plan_engine = planner.resolve_engine(plan_engine)
        self.prebuild_scenarios = prebuild_scenarios
        self.kv = kv or KVStore()
        self.journal = journal
        # claim the incarnation: any still-running predecessor is deposed
        # and its next fenced write raises StaleCoordinatorError
        self.incarnation = int(self.kv.get(INCARNATION_KEY, 0)) + 1
        self.kv.put(INCARNATION_KEY, self.incarnation)
        self.entries: List[TaskEntry] = [
            TaskEntry(task=t, n_workers=x,
                      state_bytes=waf_mod.state_bytes(t))
            for t, x in zip(tasks, assignment)]
        self.mtbf = mtbf_per_worker_s
        self.d_transition = d_transition_s
        self.n_cluster = n_cluster_workers
        self.workers_per_node = workers_per_node
        self.open_cases: Dict[str, FailureCase] = {}
        self._table: Optional[PlanTable] = None
        self.plan_cache = plan_cache
        self._tids: Optional[Tuple[int, ...]] = None   # interned task ids
        self._intern_tasks()
        self.plan_stats = PlanStats()
        # batched-engine counter baseline: the table handle last synced
        # and its batch_stats snapshot at that point (cache-shared tables
        # may arrive pre-warmed; only deltas seen through this handle
        # count toward plan_stats)
        self._bstats_src: Optional[PlanTable] = None
        self._bstats_seen: Dict[str, int] = {}
        self.plan_epoch = 0
        self._fenced_put(PLAN_EPOCH_KEY, self.plan_epoch)
        self.refresh_plan_table()
        self._journal_tasks()
        self._journal_cases()

    def _intern_tasks(self) -> None:
        """Re-intern the task set in the shared plan cache (churn only):
        per-event table refreshes then reuse the tuple instead of hashing
        every task object again."""
        if self.plan_cache is not None:
            self._tids = tuple(self.plan_cache.task_id(e.task)
                               for e in self.entries)

    def _bump_epoch(self) -> None:
        """The task set changed: indices in in-flight churn reports are
        stale.  Publish the new epoch so agents stamp future reports."""
        self.plan_epoch += 1
        self._fenced_put(PLAN_EPOCH_KEY, self.plan_epoch)

    # ---- journaling + incarnation fence (crash-recovery) -------------------

    def _fenced_put(self, key: str, value) -> None:
        """Write-through guarded by the incarnation fence: a coordinator
        whose incarnation was superseded must not touch shared state."""
        if int(self.kv.get(INCARNATION_KEY, self.incarnation)) \
                != self.incarnation:
            raise StaleCoordinatorError(
                f"incarnation {self.incarnation} deposed; refusing {key}")
        self.kv.put(key, value)

    def _journal_tasks(self) -> None:
        """Persist the task set + assignment + plan epoch.  Called after
        every mutation, OUTSIDE the timed dispatch windows so
        ``last_dispatch_s`` measures planning, not persistence."""
        if not self.journal:
            return
        self._fenced_put(JOURNAL_TASKS_KEY, tuple(
            (e.task, e.n_workers, e.status, e.avg_iter_s, e.state_bytes)
            for e in self.entries))
        self._fenced_put(JOURNAL_EPOCH_KEY, self.plan_epoch)

    def _journal_cases(self) -> None:
        if not self.journal:
            return
        self._fenced_put(JOURNAL_CASES_KEY, {
            cid: (c.kind.value, int(c.severity), c.attempts)
            for cid, c in self.open_cases.items()})

    @classmethod
    def recover(cls, kv: KVStore, hw: Hardware,
                **kwargs) -> "UnicronCoordinator":
        """Rebuild a coordinator from the ``/coord/journal/*`` keys after
        a crash: task entries (with statuses and iteration stats), plan
        epoch, open failure cases, and a refreshed ``PlanTable``.  Claims
        a new incarnation, fencing out the crashed predecessor should it
        wake up again.  ``kwargs`` forward to the constructor (plan
        cache, cluster capacity, engine, ...)."""
        journaled = kv.get(JOURNAL_TASKS_KEY)
        if journaled is None:
            raise RuntimeError("no coordinator journal to recover from")
        # snapshot epoch + cases BEFORE constructing: __init__ journals
        # its own fresh state (epoch 0, no cases) and would clobber them
        epoch = int(kv.get(JOURNAL_EPOCH_KEY, 0))
        cases = dict(kv.get(JOURNAL_CASES_KEY) or {})
        tasks = [t for t, *_ in journaled]
        assignment = [int(x) for _, x, *_ in journaled]
        coord = cls(tasks, assignment, hw, kv=kv, **kwargs)
        for e, (_, _, status, avg_iter_s, state_bytes) in zip(coord.entries,
                                                              journaled):
            e.status = status
            e.avg_iter_s = avg_iter_s
            e.state_bytes = state_bytes
        coord.plan_epoch = epoch
        coord._fenced_put(PLAN_EPOCH_KEY, coord.plan_epoch)
        for cid, (kind, sev, attempts) in cases.items():
            coord.open_cases[cid] = FailureCase(kind=ErrorKind(kind),
                                                severity=Severity(sev),
                                                attempts=attempts)
        coord._journal_tasks()
        coord._journal_cases()
        return coord

    def restore_assignment(self, assignment) -> None:
        """Re-apply an exact previously-dispatched assignment (the control
        loop's false-positive-drain rollback).  Not a planner decision —
        no epoch bump (the task set is unchanged) and no dispatch stats;
        the plan table is refreshed for the restored state."""
        for e, x in zip(self.entries, assignment):
            e.n_workers = int(x)
        self.refresh_plan_table()
        self._journal_tasks()

    def _d_running(self, n_workers: int) -> float:
        return waf_mod.expected_run_duration(self.n_cluster or n_workers,
                                             self.mtbf)

    def _adopt_table(self, table: Optional[PlanTable],
                     fresh: bool) -> None:
        """Set the batched-counter baseline for a newly acquired table
        handle: zeros when this coordinator just built it (all its work
        is ours), the current snapshot when it came warm out of a shared
        cache (prior work belongs to whoever did it)."""
        stats = getattr(table, "batch_stats", None)
        if stats is None or self._bstats_src is table:
            return
        self._bstats_src = table
        self._bstats_seen = ({k: 0 for k in stats} if fresh
                             else dict(stats))

    def _sync_batch_stats(self) -> None:
        """Fold the table's batched-engine counters into ``plan_stats``
        (delta since this coordinator last read this table handle)."""
        table = self._table
        stats = getattr(table, "batch_stats", None)
        if stats is None or self._bstats_src is not table:
            return
        seen = self._bstats_seen
        self.plan_stats.batched_levels += stats["levels"] - seen["levels"]
        self.plan_stats.batched_launches += (stats["launches"]
                                             - seen["launches"])
        self.plan_stats.lazy_tracebacks += (stats["tracebacks"]
                                            - seen["tracebacks"])
        self.plan_stats.device_dispatches += (
            stats.get("device_dispatches", 0)
            - seen.get("device_dispatches", 0))
        self._bstats_seen = dict(stats)

    # ---- plan generation -------------------------------------------------

    def _plan_input(self, n_workers: int,
                    faulted_task: Optional[int]) -> PlanInput:
        tasks = tuple(e.task for e in self.entries)
        assignment = tuple(e.n_workers for e in self.entries)
        return PlanInput(tasks, assignment, n_workers,
                         self._d_running(n_workers), self.d_transition,
                         tuple(i == faulted_task
                               for i in range(len(tasks))))

    def refresh_plan_table(self) -> None:
        """Precompute one-step lookahead plans (§5.2) for O(1) dispatch,
        via the incremental vectorized build (shared reward rows +
        prefix/suffix DPs).  With a ``plan_cache`` the table is lazy and
        chain-cached across rebuilds: a recurring cluster state costs a
        dict hit, a near state only the chains past the change."""
        assignment = [e.n_workers for e in self.entries]
        d_run = self._d_running(sum(assignment))
        w = self.workers_per_node
        n_budget = (self.n_cluster + w) if self.n_cluster else None
        t0 = time.perf_counter()
        tasks = [e.task for e in self.entries]
        if self.plan_cache is not None:
            self._table = self.plan_cache.table(tasks, assignment, self.hw,
                                                d_run, self.d_transition,
                                                workers_per_fault=w,
                                                n_budget=n_budget,
                                                engine=self.plan_engine,
                                                task_ids=self._tids,
                                                device=self.device)
            self._adopt_table(self._table, fresh=False)
        else:
            self._table = PlanTable(tasks, assignment, self.hw, d_run,
                                    self.d_transition,
                                    workers_per_fault=w,
                                    n_budget=n_budget,
                                    engine=self.plan_engine,
                                    device=self.device)
            self._adopt_table(self._table, fresh=True)
        if self.prebuild_scenarios:
            self._table.rebuild_values()
        self._sync_batch_stats()
        dt = time.perf_counter() - t0
        self.plan_stats.table_rebuilds += 1
        self.plan_stats.table_rebuild_s += dt
        self.plan_stats.last_rebuild_s = dt

    def plan_for(self, n_workers: int, faulted_task: Optional[int],
                 lookup_key: Optional[str] = None) -> Tuple[Plan, bool]:
        """Returns (plan, was_lookup_hit)."""
        t0 = time.perf_counter()
        if lookup_key and self._table:
            hit = self._table.lookup(lookup_key)
            self._sync_batch_stats()
            if hit is not None:
                self.plan_stats.lookup_hits += 1
                self.plan_stats.last_dispatch_s = time.perf_counter() - t0
                return hit, True
        plan = self._fresh_plan(n_workers, faulted_task)
        self.plan_stats.last_dispatch_s = time.perf_counter() - t0
        return plan, False

    # ---- error handling ----------------------------------------------------

    def on_error(self, case_id: str, kind: ErrorKind) -> HandlingDecision:
        case = self.open_cases.get(case_id)
        if case is None:
            case = FailureCase.from_kind(kind)
            self.open_cases[case_id] = case
            self._journal_cases()
        return decide(case)

    def on_action_failed(self, case_id: str) -> HandlingDecision:
        """Escalate SEV3 -> SEV2 -> SEV1 (Figure 7)."""
        case = self.open_cases[case_id]
        case.record_failure()
        self._journal_cases()
        return decide(case)

    def close_case(self, case_id: str) -> None:
        if self.open_cases.pop(case_id, None) is not None:
            self._journal_cases()

    # ---- reconfiguration entry points (Figure 7 triggers 3..6) -----------

    def reconfigure(self, n_workers_now: int,
                    faulted_task: Optional[int] = None,
                    trigger: Trigger = Trigger.ERROR) -> Plan:
        key = None
        if trigger is Trigger.ERROR and faulted_task is not None:
            key = f"fault:{faulted_task}"
        elif trigger is Trigger.NODE_JOIN:
            key = "join:1"
        t0 = time.perf_counter()
        plan, hit = self.plan_for(n_workers_now, faulted_task, key)
        if hit and sum(plan.assignment) > n_workers_now:
            # precomputed scenario does not match reality: fresh solve.
            # The discarded hit was not a usable dispatch — uncount it and
            # charge the whole lookup-plus-solve to this dispatch.
            self.plan_stats.lookup_hits -= 1
            plan, _ = self.plan_for(n_workers_now, faulted_task, None)
            self.plan_stats.last_dispatch_s = time.perf_counter() - t0
        for e, x in zip(self.entries, plan.assignment):
            e.n_workers = x
        self.refresh_plan_table()
        self._journal_tasks()
        return plan

    # ---- task churn (Figure 7 triggers 5 and 6) ---------------------------

    def _fresh_plan(self, n_workers_now: int,
                    faulted_task: Optional[int] = None) -> Plan:
        """Single fresh-dispatch path: memoized ``solve_fast`` under a
        plan cache, plain ``solve`` otherwise, with solve-time stats."""
        t0 = time.perf_counter()
        inp = self._plan_input(n_workers_now, faulted_task)
        if self.plan_cache is not None:
            plan = self.plan_cache.solve(inp, self.hw)
        else:
            plan = planner.solve(inp, self.hw)
        self.plan_stats.fresh_solves += 1
        self.plan_stats.fresh_solve_s += time.perf_counter() - t0
        return plan

    def task_finished(self, task_index: int, n_workers_now: int) -> Plan:
        """Trigger (5): the finished task's workers return to the pool and
        the remaining tasks are replanned — lookup table first (the
        ``finish:i`` scenario), fresh solve on a scenario mismatch."""
        t0 = time.perf_counter()
        plan = None
        if self._table is not None:
            cand = self._table.lookup(f"finish:{task_index}")
            self._sync_batch_stats()
            if cand is not None and sum(cand.assignment) <= n_workers_now:
                plan = cand
                self.plan_stats.lookup_hits += 1
        self.entries.pop(task_index)
        self._intern_tasks()
        self._bump_epoch()
        if plan is None:
            plan = self._fresh_plan(n_workers_now)
        for e, x in zip(self.entries, plan.assignment):
            e.n_workers = x
        self.plan_stats.task_finishes += 1
        self.plan_stats.last_dispatch_s = time.perf_counter() - t0
        self.refresh_plan_table()
        self._journal_tasks()
        return plan

    def task_updated(self, task_index: int, task: Task) -> None:
        """Reward-only task swap (a serving task's offered load stepped —
        ``scenarios.RateChangeEvent``): workers stay put, nothing is
        dispatched and no epoch bump (slot indices are unchanged, so
        in-flight churn reports stay valid).  The entry's task and
        transition payload are replaced and the lookahead table refreshed
        so the NEXT trigger plans against the updated reward rows."""
        e = self.entries[task_index]
        e.task = task
        e.state_bytes = waf_mod.state_bytes(task)
        self._intern_tasks()
        self.refresh_plan_table()
        self._journal_tasks()

    def task_launched(self, task: Task, n_workers_now: int,
                      avg_iter_s: float = 30.0) -> Plan:
        """Trigger (6): admit a task (x_old = 0) and replan the whole
        cluster.  There is no precomputed scenario for launches, so this
        is always a fresh solve (memoized under a plan cache)."""
        self.entries.append(TaskEntry(task=task, n_workers=0,
                                      avg_iter_s=avg_iter_s,
                                      state_bytes=waf_mod.state_bytes(task)))
        self._intern_tasks()
        self._bump_epoch()
        t0 = time.perf_counter()
        plan = self._fresh_plan(n_workers_now)
        for e, x in zip(self.entries, plan.assignment):
            e.n_workers = x
        self.plan_stats.task_launches += 1
        self.plan_stats.last_dispatch_s = time.perf_counter() - t0
        self.refresh_plan_table()
        self._journal_tasks()
        return plan

    # ---- accounting --------------------------------------------------------

    def cluster_waf(self) -> float:
        return sum(waf_mod.waf(e.task, e.n_workers, self.hw)
                   for e in self.entries if e.status == "running")
