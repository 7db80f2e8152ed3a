"""Per-task objectives: the reward models behind the §5 planner.  Copied
from ``repro/core/waf.py`` (numpy).

* :class:`TrainingWAF` (the default): ``w(t) * T(t, x)`` from the
  memoized cost-model sweep — the paper's weighted achieved FLOP/s.
* :class:`ServingSLO`: goodput under a p99 latency SLO at an offered
  request rate.

``value(task, x, hw)`` is the scalar reference metric; ``curve(task, n,
hw)`` the same metric for x = 0..n as one float64 vector, elementwise
identical to ``value``.  **Band contract**: rows built by
:func:`reward_curve` are flat past the task's ``max_workers`` cap, which
is what lets the planner's banded max-plus kernels stay exact.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core import costmodel
from repro_torch.core.costmodel import Hardware, TaskModel


class Objective:
    """Protocol for per-task reward models.  Implementations are frozen
    and hashable (Task is a cache key) and keep ``value``/``curve``
    elementwise identical."""

    def value(self, task: "Task", x: int, hw: Hardware) -> float:
        """Weighted scalar metric at ``x`` workers (no floor/cap)."""
        raise NotImplementedError

    def curve(self, task: "Task", n: int, hw: Hardware) -> np.ndarray:
        """Weighted metric for x = 0..n as one fresh float64 vector."""
        return np.array([self.value(task, x, hw) for x in range(n + 1)],
                        dtype=np.float64)

    def state_bytes(self, task: "Task") -> float:
        """Bytes that must move when the task is reconfigured."""
        raise NotImplementedError

    def necessary(self, task: "Task", hw: Hardware) -> int:
        """Default requirement floor when ``task.min_workers`` is None."""
        raise NotImplementedError

    def vector_capable(self, task: "Task") -> bool:
        """Whether ``curve`` is safe for this task (planner fast path)."""
        return True


@dataclass(frozen=True)
class TrainingWAF(Objective):
    """The paper's §5.1 objective: weighted achieved aggregate FLOP/s."""

    def value(self, task: "Task", x: int, hw: Hardware) -> float:
        return task.weight * costmodel.achieved_flops(task.model, x, hw)

    def curve(self, task: "Task", n: int, hw: Hardware) -> np.ndarray:
        sweep = costmodel.throughput_curve(task.model, n, hw,
                                           cap=task.max_workers)
        return task.weight * sweep.flops[:n + 1]   # fresh array (not a view)

    def state_bytes(self, task: "Task") -> float:
        return 16.0 * task.model.n_params

    def necessary(self, task: "Task", hw: Hardware) -> int:
        return costmodel.min_feasible_workers(task.model, hw)

    def vector_capable(self, task: "Task") -> bool:
        return isinstance(task.model, TaskModel)


@dataclass(frozen=True)
class ServingSLO(Objective):
    """Serving objective: goodput under a p99 latency SLO, with ``x``
    replicas of ``capacity_rps`` each derated by ``lane_fail_discount``:

        goodput(x) = min(rate, capacity) * max(0, 1 - e^((rho-1)·k))

    with rho = rate / capacity and ``k = slo_latency_s / base_latency_s``."""
    rate_rps: float                     # offered request rate
    slo_latency_s: float = 0.5          # p99 latency target
    base_latency_s: float = 0.05        # zero-load service time
    capacity_rps: float = 8.0           # per-worker saturation throughput
    lane_fail_discount: float = 0.0     # fraction of lanes lost to faults

    def _goodput(self, x: np.ndarray) -> np.ndarray:
        cap_rps = self.capacity_rps * (1.0 - self.lane_fail_discount)
        c = x * cap_rps
        served = np.minimum(self.rate_rps, c)
        rho = self.rate_rps / np.where(c > 0.0, c, 1.0)
        k = self.slo_latency_s / self.base_latency_s
        with np.errstate(over="ignore"):
            attain = 1.0 - np.exp((rho - 1.0) * k)
        return np.where(c > 0.0, served * np.maximum(attain, 0.0), 0.0)

    def value(self, task: "Task", x: int, hw: Hardware) -> float:
        row = self._goodput(np.array([float(x)], dtype=np.float64))
        return float(task.weight * row[0])

    def curve(self, task: "Task", n: int, hw: Hardware) -> np.ndarray:
        return task.weight * self._goodput(
            np.arange(n + 1, dtype=np.float64))

    def state_bytes(self, task: "Task") -> float:
        # inference replicas ship fp16 weights only — no grads/optimizer
        return 2.0 * task.model.n_params

    def necessary(self, task: "Task", hw: Hardware) -> int:
        return 1                        # any non-empty replica set serves

    def with_rate(self, rate_rps: float) -> "ServingSLO":
        """New objective at a different offered load."""
        return dataclasses.replace(self, rate_rps=float(rate_rps))

    def calibrated(self, stats: dict) -> "ServingSLO":
        """New objective with ``lane_fail_discount`` refreshed from
        ``ContinuousBatcher.slo_stats`` counters (lane-failure evictions
        over all lane completions)."""
        failed = float(stats.get("lane_failures", 0))
        done = float(stats.get("completed", 0))
        frac = failed / max(failed + done, 1.0)
        return dataclasses.replace(self, lane_fail_discount=frac)


#: Module-level default: all instances compare/hash equal.
TRAINING_WAF = TrainingWAF()


@dataclass(frozen=True)
class Task:
    """A cluster task: model + priority weight + objective + worker bounds.
    ``max_workers`` is a worker ceiling: workers past it idle, so F(t, ·)
    is flat past it (the band the planner's kernels exploit)."""
    model: TaskModel
    weight: float = 1.0                    # w(t), recommended 0.5..2.0
    min_workers: Optional[int] = None      # T_necessary(t); None = auto
    max_workers: Optional[int] = None      # worker cap; None = uncapped
    objective: Objective = TRAINING_WAF    # reward model

    def necessary(self, hw: Hardware) -> int:
        if self.min_workers is not None:
            return self.min_workers
        return self.objective.necessary(self, hw)


def state_bytes(task: Task) -> float:
    """Reconfiguration payload for ``task`` (objective-defined)."""
    return task.objective.state_bytes(task)


def waf(task: Task, x: int, hw: Hardware) -> float:
    """F(t, x) = objective value if requirement satisfied else 0 (Eq. 2);
    x is clamped to ``task.max_workers`` first."""
    cap = task.max_workers
    if cap is not None:
        x = min(x, cap)
    if x < task.necessary(hw) or x <= 0:
        return 0.0
    return task.objective.value(task, x, hw)


def reward(task: Task, x_old: int, x_new: int, *, d_running: float,
           d_transition: float, worker_faulted: bool,
           hw: Hardware) -> float:
    """G(t, x') (Eq. 3): post-reconfiguration reward over the expected run
    duration, minus the reward lost during the transition when the task
    must transition (Eq. 4 indicator)."""
    g = waf(task, x_new, hw) * d_running
    if x_old != x_new or worker_faulted:
        g -= waf(task, x_old, hw) * d_transition
    return g


def waf_curve(task: Task, n: int, hw: Hardware) -> np.ndarray:
    """F(t, ·) for x = 0..n as one vector (Eq. 2): zeroed below the
    requirement floor and clamped flat past ``task.max_workers``."""
    F = task.objective.curve(task, n, hw)
    floor = max(task.necessary(hw), 1)
    cap = task.max_workers
    if cap is not None and cap < floor:
        F[:] = 0.0                      # cap below the requirement: never runs
        return F
    F[:min(floor, n + 1)] = 0.0
    if cap is not None and cap < n:
        F[cap + 1:] = F[cap]            # flat tail (band contract)
    return F


def waf_matrix(tasks, n: int, hw: Hardware) -> np.ndarray:
    """F(t_i, ·) for every task as one (m, n+1) matrix (Eq. 2 rows)."""
    if not all(type(t.objective) is TrainingWAF for t in tasks):
        if not tasks:
            return np.zeros((0, n + 1))
        return np.stack([waf_curve(t, n, hw) for t in tasks])
    F = costmodel.throughput_matrix([t.model for t in tasks], n, hw)
    for i, t in enumerate(tasks):
        F[i] *= t.weight
        floor = max(t.necessary(hw), 1)
        cap = t.max_workers
        if cap is not None and cap < floor:
            F[i] = 0.0
            continue
        F[i, :min(floor, n + 1)] = 0.0
        if cap is not None and cap < n:
            F[i, cap + 1:] = F[i, cap]
    return F


def reward_curve(task: Task, x_old: int, n: int, *, d_running: float,
                 d_transition: float, worker_faulted: bool,
                 hw: Hardware) -> np.ndarray:
    """G(t, ·) for x' = 0..n as one vector (Eq. 3/4), the same values as
    ``reward`` at every x' (the no-transition entry is recomputed
    directly, not by adding the penalty back)."""
    F = waf_curve(task, n, hw)
    g = F * d_running - waf(task, x_old, hw) * d_transition
    if not worker_faulted and 0 <= x_old <= n:
        g[x_old] = F[x_old] * d_running
    return g


def expected_run_duration(n_workers: int, mtbf_per_worker: float) -> float:
    """D_running(n'): expected time to next failure with n' workers."""
    if n_workers <= 0:
        return 0.0
    return mtbf_per_worker / n_workers
