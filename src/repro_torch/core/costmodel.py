"""Analytic throughput model T(t, x) — achieved aggregate FLOP/s of a task
on x workers (§5.1).  Copied from ``repro/core/costmodel.py`` (numpy; the
A800 preset, the scalar (dp, tp, pp) search and its vectorized sweep).

For a worker count the model enumerates (dp, tp, pp, micro_b)
configurations, checks memory feasibility, estimates iteration time from
compute + TP/PP/DP communication terms, and takes the best — which gives
the paper's Figure-4 non-linear, occasionally non-monotonic T(t, ·).

Two evaluation paths share the same formulas: the scalar reference
(``_best_plan`` / ``achieved_flops``) and ``throughput_curve``, which
evaluates every feasible configuration for all worker counts ``1..n`` in
one numpy sweep, float-identical to the scalar path and memoized per
``(task, hw)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # per worker, FLOP/s (bf16)
    hbm_bytes: float           # per worker
    hbm_bw: float              # bytes/s
    intra_bw: float            # bytes/s per worker, fast domain (NVLink/ICI)
    inter_bw: float            # bytes/s per worker, slow domain (RoCE/DCN)
    intra_size: int            # workers per fast domain (node / ICI pod)
    compute_eff: float         # achievable fraction of peak on matmuls


A800 = Hardware(name="A800", peak_flops=312e12, hbm_bytes=80e9,
                hbm_bw=2.0e12, intra_bw=200e9, inter_bw=12.5e9,
                intra_size=8, compute_eff=0.62)


@dataclass(frozen=True)
class TaskModel:
    """Static description of a training task for the cost model."""
    name: str
    n_params: float            # N
    n_layers: int
    d_model: int
    seq_len: int = 2048
    global_batch: int = 512

    @classmethod
    def from_arch(cls, cfg: ArchConfig, seq_len: int = 2048,
                  global_batch: int = 512) -> "TaskModel":
        return cls(name=cfg.name, n_params=float(cfg.param_count()),
                   n_layers=cfg.n_layers, d_model=cfg.d_model,
                   seq_len=seq_len, global_batch=global_batch)


@dataclass(frozen=True)
class PlanPoint:
    """One feasible (dp, tp, pp) evaluation."""
    dp: int
    tp: int
    pp: int
    t_iter: float              # seconds
    agg_flops: float           # achieved aggregate FLOP/s
    mem_per_worker: float      # bytes


def _mem_per_worker(task: TaskModel, tp: int, pp: int, micro_b: int,
                    hw: Hardware) -> float:
    shard = task.n_params / (tp * pp)
    static = 16.0 * shard                       # bf16 w+g, fp32 m/v/master
    # activations with selective recompute, one in-flight micro-batch per
    # stage plus pipeline depth amplification
    act = (22.0 * task.seq_len * micro_b * task.d_model
           * (task.n_layers / pp) / tp) * min(pp, 4)
    return static + act


def _iter_time(task: TaskModel, dp: int, tp: int, pp: int, micro_b: int,
               hw: Hardware) -> float:
    B, S, N, L, d = (task.global_batch, task.seq_len, task.n_params,
                     task.n_layers, task.d_model)
    m = max(1, math.ceil(B / (dp * micro_b)))   # micro-batches per DP rank
    tokens = B * S
    flops = 6.0 * N * tokens
    t_comp = flops / (dp * tp * pp * hw.peak_flops * hw.compute_eff)
    # pipeline bubble
    t_comp *= (m + pp - 1) / m
    # TP collectives: 4 all-reduces per layer of (S*micro_b*d) bf16 acts,
    # ring factor 2(tp-1)/tp, over the fast domain
    if tp > 1:
        bw = hw.intra_bw if tp <= hw.intra_size else hw.inter_bw
        tp_bytes = 4 * L / pp * (2.0 * S * micro_b * d) * m
        t_tp = tp_bytes * 2 * (tp - 1) / tp / bw
    else:
        t_tp = 0.0
    # DP gradient all-reduce of the shard, slow domain (overlapped ~50%)
    if dp > 1:
        g_bytes = 2.0 * N / (tp * pp)
        workers_per_node = hw.intra_size
        bw = hw.intra_bw if dp * tp * pp <= workers_per_node else hw.inter_bw
        t_dp = 0.5 * g_bytes * 2 * (dp - 1) / dp / bw
    else:
        t_dp = 0.0
    # imbalance when dp does not divide B
    imbalance = math.ceil(B / dp) / (B / dp)
    return (t_comp + t_tp + t_dp) * imbalance


@lru_cache(maxsize=65536)
def _best_plan(task: TaskModel, x: int, hw: Hardware) -> Optional[PlanPoint]:
    if x <= 0:
        return None
    best: Optional[PlanPoint] = None
    tps = [t for t in (1, 2, 4, 8, 16) if t <= min(x, hw.intra_size)]
    for tp in tps:
        pp = 1
        while tp * pp <= x and pp <= task.n_layers:
            if task.n_layers % pp == 0:
                dp = x // (tp * pp)
                if dp >= 1 and dp <= task.global_batch:
                    for micro_b in (1, 2, 4):
                        if micro_b * dp > task.global_batch:
                            continue
                        mem = _mem_per_worker(task, tp, pp, micro_b, hw)
                        if mem > hw.hbm_bytes:
                            continue
                        t = _iter_time(task, dp, tp, pp, micro_b, hw)
                        used_flops = (6.0 * task.n_params * task.global_batch
                                      * task.seq_len) / t
                        pt = PlanPoint(dp, tp, pp, t, used_flops, mem)
                        if best is None or pt.agg_flops > best.agg_flops:
                            best = pt
            pp *= 2
    return best


def achieved_flops(task: TaskModel, x: int,
                   hw: Hardware = A800) -> float:
    """T(t, x): achieved aggregate FLOP/s with the best feasible plan,
    0.0 if no configuration fits."""
    p = _best_plan(task, x, hw)
    return 0.0 if p is None else p.agg_flops


# ``best_plan``, ``min_feasible_workers_reference`` and ``flops_ratio``:
# copied from repro/core/costmodel.py:167, :171 and :182
def best_plan(task: TaskModel, x: int, hw: Hardware = A800):
    return _best_plan(task, x, hw)


def min_feasible_workers_reference(task: TaskModel, hw: Hardware = A800,
                                   upper: int = 4096) -> int:
    """Scalar reference: linear scan from x=1 (kept for property tests)."""
    x = 1
    while x <= upper:
        if _best_plan(task, x, hw) is not None:
            return x
        x += 1
    return upper


def flops_ratio(task: TaskModel, x: int, hw: Hardware = A800) -> float:
    """Achieved fraction of the x workers' theoretical peak (Fig. 4)."""
    t = achieved_flops(task, x, hw)
    return t / (x * hw.peak_flops) if x else 0.0


# ---------------------------------------------------------------------------
# Vectorized engine: T(t, ·) for all worker counts in one sweep
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ThroughputCurve:
    """T(t, x) for x = 0..n plus the argmax plan at every x.

    ``flops[x]`` is the achieved aggregate FLOP/s of the best feasible
    (dp, tp, pp, micro_b) configuration on x workers (0.0 when none fits);
    ``cfg[x]`` indexes into ``configs`` (-1 when infeasible)."""
    task: TaskModel
    hw: Hardware
    n: int
    flops: np.ndarray                  # (n+1,) float64
    cfg: np.ndarray                    # (n+1,) int64, -1 = infeasible
    dp: np.ndarray                     # (n+1,) int64
    t_iter: np.ndarray                 # (n+1,) float64
    mem: np.ndarray                    # (n+1,) float64
    configs: Tuple[Tuple[int, int, int], ...]   # (tp, pp, micro_b)

    def plan(self, x: int) -> Optional[PlanPoint]:
        """PlanPoint at worker count x (None if infeasible); copied from
        repro/core/costmodel.py:212."""
        if x <= 0 or x > self.n or self.cfg[x] < 0:
            return None
        tp, pp, _ = self.configs[int(self.cfg[x])]
        return PlanPoint(int(self.dp[x]), tp, pp, float(self.t_iter[x]),
                         float(self.flops[x]), float(self.mem[x]))

    def min_feasible(self) -> Optional[int]:
        """Smallest x with a feasible plan, or None if none up to n."""
        nz = np.nonzero(self.cfg[1:] >= 0)[0]
        return int(nz[0]) + 1 if nz.size else None


def _feasible_configs(task: TaskModel, n: int,
                      hw: Hardware) -> List[Tuple[int, int, int]]:
    """All (tp, pp, micro_b) memory-feasible on <= n workers, enumerated in
    the same order as the scalar reference so argmax tie-breaks agree."""
    out: List[Tuple[int, int, int]] = []
    tps = [t for t in (1, 2, 4, 8, 16) if t <= min(n, hw.intra_size)]
    for tp in tps:
        pp = 1
        while tp * pp <= n and pp <= task.n_layers:
            if task.n_layers % pp == 0:
                for micro_b in (1, 2, 4):
                    if _mem_per_worker(task, tp, pp, micro_b,
                                       hw) <= hw.hbm_bytes:
                        out.append((tp, pp, micro_b))
            pp *= 2
    return out


def _sweep(task: TaskModel, n: int, hw: Hardware) -> ThroughputCurve:
    """Evaluate every feasible config on every worker count 1..n at once,
    mirroring ``_iter_time``'s arithmetic (same operation order)."""
    B, S, N, L, d = (task.global_batch, task.seq_len, task.n_params,
                     task.n_layers, task.d_model)
    configs = _feasible_configs(task, n, hw)
    X = np.arange(n + 1, dtype=np.int64)
    if not configs:
        z = np.zeros(n + 1)
        return ThroughputCurve(task, hw, n, z,
                               np.full(n + 1, -1, dtype=np.int64),
                               np.zeros(n + 1, dtype=np.int64), z.copy(),
                               z.copy(), ())
    agg = np.zeros((len(configs), n + 1))          # achieved FLOP/s, 0 = infeasible
    dps = np.zeros((len(configs), n + 1), dtype=np.int64)
    its = np.zeros((len(configs), n + 1))
    tokens = B * S
    flops = 6.0 * N * tokens
    for ci, (tp, pp, micro_b) in enumerate(configs):
        dp = X // (tp * pp)
        ok = (dp >= 1) & (dp <= B) & (micro_b * dp <= B)
        dp_s = np.where(ok, dp, 1)                 # safe divisor
        m = np.maximum(1, np.ceil(B / (dp_s * micro_b)))
        t_comp = flops / (dp_s * tp * pp * hw.peak_flops * hw.compute_eff)
        t_comp = t_comp * ((m + pp - 1) / m)
        if tp > 1:
            bw = hw.intra_bw if tp <= hw.intra_size else hw.inter_bw
            tp_bytes = 4 * L / pp * (2.0 * S * micro_b * d) * m
            t_tp = tp_bytes * 2 * (tp - 1) / tp / bw
        else:
            t_tp = np.zeros(n + 1)
        g_bytes = 2.0 * N / (tp * pp)
        bw_dp = np.where(dp_s * tp * pp <= hw.intra_size,
                         hw.intra_bw, hw.inter_bw)
        t_dp = np.where(dp_s > 1,
                        0.5 * g_bytes * 2 * (dp_s - 1) / dp_s / bw_dp, 0.0)
        imbalance = np.ceil(B / dp_s) / (B / dp_s)
        t = (t_comp + t_tp + t_dp) * imbalance
        used = (6.0 * task.n_params * task.global_batch * task.seq_len) / t
        agg[ci] = np.where(ok, used, 0.0)
        dps[ci] = np.where(ok, dp, 0)
        its[ci] = np.where(ok, t, 0.0)
    best = np.argmax(agg, axis=0)                  # first max, like reference
    rows = np.arange(n + 1)
    best_agg = agg[best, rows]
    cfg = np.where(best_agg > 0.0, best, -1).astype(np.int64)
    mems = np.array([_mem_per_worker(task, tp, pp, mb, hw)
                     for tp, pp, mb in configs])
    mem = np.where(cfg >= 0, mems[np.maximum(cfg, 0)], 0.0)
    return ThroughputCurve(task, hw, n, best_agg, cfg, dps[best, rows],
                           its[best, rows], mem, tuple(configs))


_CURVE_CACHE: Dict[Tuple[TaskModel, Hardware], ThroughputCurve] = {}
_CURVE_CACHE_MAX = 1024                # curves are O(n) arrays; bound the set


def throughput_curve(task: TaskModel, n: int,
                     hw: Hardware = A800,
                     cap: Optional[int] = None) -> ThroughputCurve:
    """T(t, ·) vector for worker counts 0..n plus argmax plans, memoized per
    (task, hw); a larger-n request grows the cached sweep, a smaller one
    returns views into it.  ``cap``: per-task worker ceiling — past it the
    curve is flat (extra workers idle), which is what lets the planner's
    banded max-plus kernels shrink the band from n to cap+1."""
    cached = _CURVE_CACHE.pop((task, hw), None)
    if cached is None or cached.n < n:
        cached = _sweep(task, max(n, 1), hw)
    while len(_CURVE_CACHE) >= _CURVE_CACHE_MAX:      # LRU: dicts keep
        _CURVE_CACHE.pop(next(iter(_CURVE_CACHE)))    # insertion order
    _CURVE_CACHE[(task, hw)] = cached
    if cap is not None and cap < n:
        idx = np.minimum(np.arange(n + 1), max(cap, 0))
        return ThroughputCurve(task, hw, n, cached.flops[idx],
                               cached.cfg[idx], cached.dp[idx],
                               cached.t_iter[idx], cached.mem[idx],
                               cached.configs)
    if cached.n == n:
        return cached
    s = slice(0, n + 1)
    return ThroughputCurve(task, hw, n, cached.flops[s], cached.cfg[s],
                           cached.dp[s], cached.t_iter[s], cached.mem[s],
                           cached.configs)


def throughput_matrix(tasks, n: int, hw: Hardware = A800) -> np.ndarray:
    """T(t_i, x) for every task as one (m, n+1) matrix, assembled from the
    memoized per-task sweeps."""
    out = np.empty((len(tasks), n + 1))
    for i, t in enumerate(tasks):
        out[i] = throughput_curve(t, n, hw).flops[:n + 1]
    return out


def min_feasible_workers(task: TaskModel, hw: Hardware = A800,
                         upper: int = 4096) -> int:
    """Smallest x with a feasible plan (T_necessary floor): exponential
    search over the vectorized curve."""
    n = 64
    while True:
        n = min(n, upper)
        found = throughput_curve(task, n, hw).min_feasible()
        if found is not None:
            return found
        if n >= upper:
            return upper
        n *= 2
