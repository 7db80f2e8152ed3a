"""Optimal reconfiguration plan generation (§5.2).  The port of
``repro/core/planner.py``: the host code is copied as it is, and the
max-plus convolutions run through the port's kernels.

Knapsack-style dynamic program over (tasks x workers):

    S(i, j) = max_k { S(i-1, j-k) + G(t_i, k) }           (Eq. 5)

Reward rows G(t_i, ·) come from each task's objective (``core.waf``) and
satisfy the **band contract**: flat past each task's ``max_workers`` cap,
so the banded convolutions below are exact.

* ``solve`` / ``solve_fast`` / ``solve_reference`` / ``brute_force`` —
  fresh solves on the host in numpy (the scalar ``solve_reference`` is
  the ground truth), as in the reference.
* ``PlanTable`` — the one-step lookahead table (every ``fault:i``,
  ``finish:i`` and ``join:1`` scenario) with five engines: ``"batched"``
  (default: level-synchronous stacked merges, one launch of kernel 4 per
  tree level, kernel 3 for single-row levels), ``"fused"`` (the whole
  -table value rebuild as one program of ``maxplus_scan_step`` launches,
  kernel 5, over a static step table, cached per schedule signature and
  captured as one CUDA graph on the card),
  ``"segtree"`` (one kernel-3 call per node merge), ``"chain"`` (host
  numpy prefix/suffix chains) and ``"reference"`` (scalar solves).
* ``PlannerCache`` — cross-rebuild cache of reward rows, node vectors,
  lazy tables and fresh solves.

The device seam: ``PlanTable(device=, dtype=)``.  On a CUDA device every
tree-engine convolution uploads its operands in one pinned copy, launches
the Hopper kernel (``kernels/maxplus.py``) and brings the values back in
one pinned copy as float64 numpy for the host-side argmax tracebacks, as
``np.asarray`` does in the reference; on the CPU the same wrappers run
the plain PyTorch versions.
``dtype`` is the kernels' arithmetic: ``torch.float64`` (default, the
counterpart of the reference's default numpy backend) or
``torch.float32`` (the counterpart of its Pallas backend).  Each
candidate is one IEEE add and max is order-free, so every total and plan
equals the reference's bit for bit at the same precision.  There is no
switch that runs the plain versions on the card.
"""
from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import waf as waf_mod
from repro_torch.core.costmodel import Hardware
from repro_torch.core.waf import Task
from repro_torch.device import resolve_device
from repro_torch.kernels import build, maxplus

NEG = float("-inf")


@dataclass(frozen=True)
class PlanInput:
    tasks: Tuple[Task, ...]
    assignment: Tuple[int, ...]        # current workers per task (x_i)
    n_workers: int                     # n' available after the event
    d_running: float
    d_transition: float
    faulted: Tuple[bool, ...]          # per task: did one of its workers fault


@dataclass(frozen=True)
class Plan:
    assignment: Tuple[int, ...]
    total_reward: float
    waf: float                         # cluster WAF under the new assignment


def _vector_capable(tasks: Sequence) -> bool:
    """Reward rows can be built from the objective's vectorized curve
    (real ``Task``s whose objective declares itself vector-capable — the
    default ``TrainingWAF`` requires an analytic ``TaskModel``).
    Duck-typed tasks — e.g. the tabulated tasks the property tests use
    with a monkeypatched ``waf`` — fall back to the scalar row builder
    so they keep their custom semantics."""
    return all(isinstance(t, Task) and t.objective.vector_capable(t)
               for t in tasks)


def _reward_row(inp: PlanInput, i: int, hw: Hardware) -> List[float]:
    """G(t_i, k) for k = 0..n_workers (scalar reference path)."""
    t = inp.tasks[i]
    return [waf_mod.reward(t, inp.assignment[i], k,
                           d_running=inp.d_running,
                           d_transition=inp.d_transition,
                           worker_faulted=inp.faulted[i], hw=hw)
            for k in range(inp.n_workers + 1)]


def _reward_matrix(inp: PlanInput, hw: Hardware) -> np.ndarray:
    """All m reward rows as an (m, n+1) matrix."""
    if _vector_capable(inp.tasks):
        return np.stack([
            waf_mod.reward_curve(t, inp.assignment[i], inp.n_workers,
                                 d_running=inp.d_running,
                                 d_transition=inp.d_transition,
                                 worker_faulted=inp.faulted[i], hw=hw)
            for i, t in enumerate(inp.tasks)])
    return np.array([_reward_row(inp, i, hw)
                     for i in range(len(inp.tasks))], dtype=float)


def _maxplus(prev: np.ndarray, g: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One max-plus convolution step: out[j] = max_{0<=k<=j} prev[j-k] + g[k],
    plus the argmax k per j (first/lowest k on ties, matching the scalar
    DP's strict-improvement rule)."""
    n = prev.shape[0] - 1
    pad = np.concatenate([np.full(n, NEG), prev])
    win = np.lib.stride_tricks.sliding_window_view(pad, n + 1)
    vals = win[:, ::-1] + g[None, :]   # vals[j, k] = prev[j-k] + g[k]
    ch = vals.argmax(axis=1)           # one O(n^2) scan serves both outputs
    return vals[np.arange(n + 1), ch], ch


def _maxplus_vals(prev: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Value vector of one max-plus step, without the per-cell argmax.

    Same candidate set per cell as ``_maxplus`` (so the maxima are
    float-identical), but evaluated without reversing the O(n^2) window
    matrix; tracebacks recover choices per *visited* cell via
    ``_argmax_at`` instead of materializing the whole argmax matrix."""
    n = prev.shape[0] - 1
    pad = np.concatenate([np.full(n, NEG), prev])
    win = np.lib.stride_tricks.sliding_window_view(pad, n + 1)
    return (win + g[::-1][None, :]).max(axis=1)


def _maxplus_vals_fast(prev: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Bitwise-identical values to ``_maxplus_vals``, evaluated in row
    blocks that skip most of the -inf padding triangle (cell j only has
    j+1 real candidates; the rectangular kernel evaluates all n+1).
    Every real candidate is the same ``prev[j-k] + g[k]`` float and max
    is an exact, order-free reduction, so the output is unchanged.  This
    is the kernel of the cached/lazy engine path; the eager reference
    build keeps the plain kernels as the measured baseline."""
    n = prev.shape[0] - 1
    pad = np.concatenate([np.full(n, NEG), prev])
    win = np.lib.stride_tricks.sliding_window_view(pad, n + 1)
    gr = g[::-1]
    out = np.empty(n + 1)
    block = 128
    for j0 in range(0, n + 1, block):
        j1 = min(j0 + block, n + 1)
        t_lo = n - j1 + 1          # rows below j1 have no candidate before
        out[j0:j1] = (win[j0:j1, t_lo:] + gr[t_lo:]).max(axis=1)
    return out


# ---------------------------------------------------------------------------
# Engine names and the device seam of the max-plus kernels
# ---------------------------------------------------------------------------

ENGINES = ("batched", "fused", "segtree", "chain", "reference")


_ENGINE_DESCRIPTIONS = {
    "batched": "level-synchronous stacked dyadic tree; value-only "
               "rebuilds + lazy traceback (default)",
    "fused": "one-program engine: whole-table value rebuild as one "
             "program of maxplus_scan_step launches over a static step "
             "table (cached per schedule signature; one CUDA graph on "
             "the card)",
    "segtree": "per-node dyadic segment tree, O(log m) churn "
               "invalidation, one kernel call per merge",
    "chain": "prefix/suffix DP chains; the preserved churn-rebuild "
             "baseline",
    "reference": "non-incremental per-scenario solves (scalar "
                 "solve_reference by default); the ground-truth path",
}

_BACKEND_DESCRIPTIONS = {
    "cuda": "the Hopper max-plus kernels (kernels/maxplus.py), launched "
            "for PlanTable(device=) on a CUDA device",
    "plain": "the plain PyTorch versions (kernels/ref.py), run for a CPU "
             "device; float64 or float32 by PlanTable(dtype=)",
}


def engines() -> Dict[str, Dict[str, str]]:
    """The planner's engine/backend registry (repro/core/planner.py:459):
    ``{"engine": {name: description}, "backend": {...}}``.  The ``engine``
    axis is the reference's (``ENGINES``, ``PlanTable(engine=)``).  The
    port has no backend switch: its ``backend`` axis describes the
    routing of the max-plus convolutions, the kernel for CUDA tensors and
    the plain version for CPU ones."""
    return {"engine": dict(_ENGINE_DESCRIPTIONS),
            "backend": dict(_BACKEND_DESCRIPTIONS)}


def resolve_engine(engine: Optional[str] = None) -> str:
    """Validate an engine name from ``ENGINES`` (``None`` = "batched")."""
    if engine is not None and engine not in ENGINES:
        raise ValueError(f"unknown PlanTable engine {engine!r}; "
                         f"choose from {ENGINES}")
    return engine if engine is not None else "batched"


def _upload(rows: Sequence[np.ndarray], device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """The equal-length rows stacked as float64 into one host tensor,
    pinned when it is bound for CUDA, and moved to ``device`` in ``dtype``
    with one asynchronous copy."""
    host = torch.empty((len(rows), len(rows[0])), dtype=torch.float64,
                       pin_memory=device.type == "cuda")
    np.stack(rows, out=host.numpy())
    return host.to(device, non_blocking=True).to(dtype)


def _download(t: torch.Tensor) -> np.ndarray:
    """``t`` as a fresh float64 numpy array (the stores keep rows of it):
    one copy into pinned memory and one synchronisation on CUDA."""
    if t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        t = host
    return t.numpy().astype(np.float64)


def _conv_vals(prev: np.ndarray, g: np.ndarray, band: Optional[int],
               device: torch.device, dtype: torch.dtype) -> np.ndarray:
    """One banded max-plus convolution (the segment-tree engine's merge,
    kernel 3): values come back as float64 numpy, argmax recovery stays
    on the host."""
    t = _upload([prev, g], device, dtype)
    return _download(maxplus.maxplus_conv(t[0], t[1], band))


def _conv_vals_batched(prevs: Sequence[np.ndarray],
                       gs: Sequence[np.ndarray], bands,
                       device: torch.device,
                       dtype: torch.dtype) -> np.ndarray:
    """Stacked banded max-plus convolution (the batched engine's
    per-level launch, kernel 4): the operands go up in one copy, the
    values come back in one."""
    B = len(prevs)
    t = _upload(list(prevs) + list(gs), device, dtype)
    return _download(maxplus.maxplus_conv_batched(t[:B], t[B:], bands))


def _argmax_at(prev: np.ndarray, g: np.ndarray, j: int) -> int:
    """Choice k at cell j of ``_maxplus(prev, g)``: first/lowest k on ties
    (all candidates with k > j are -inf, so restricting to k <= j is
    exactly the stored-argmax matrix's answer)."""
    return int(np.argmax(prev[j::-1] + g[:j + 1]))


def _cluster_waf(tasks: Sequence[Task], assign: Sequence[int],
                 hw: Hardware) -> float:
    return sum(waf_mod.waf(t, x, hw) for t, x in zip(tasks, assign))


def solve(inp: PlanInput, hw: Hardware) -> Plan:
    """Vectorized dynamic program (Eq. 5) with traceback."""
    m, n = len(inp.tasks), inp.n_workers
    if m == 0:
        return Plan((), 0.0, 0.0)
    rows = _reward_matrix(inp, hw)
    S = np.zeros(n + 1)
    choice = np.zeros((m, n + 1), dtype=np.int64)
    for i in range(m):
        S, choice[i] = _maxplus(S, rows[i])
    assign = [0] * m
    j = int(np.argmax(S))
    total = float(S[j])
    for i in range(m - 1, -1, -1):
        k = int(choice[i, j])
        assign[i] = k
        j -= k
    return Plan(tuple(assign), total, _cluster_waf(inp.tasks, assign, hw))


def solve_fast(inp: PlanInput, hw: Hardware) -> Plan:
    """Same Plan as ``solve`` (same candidate floats, same first-max
    tie-breaking) using the value-only row-blocked kernel and
    traceback-time argmax recovery instead of per-cell argmax matrices —
    the fresh-dispatch path of the cached engine."""
    m, n = len(inp.tasks), inp.n_workers
    if m == 0:
        return Plan((), 0.0, 0.0)
    rows = _reward_matrix(inp, hw)
    S = [np.zeros(n + 1)]
    for i in range(m):
        S.append(_maxplus_vals_fast(S[i], rows[i]))
    assign = [0] * m
    j = int(np.argmax(S[m]))
    total = float(S[m][j])
    for i in range(m - 1, -1, -1):
        k = _argmax_at(S[i], rows[i], j)
        assign[i] = k
        j -= k
    return Plan(tuple(assign), total, _cluster_waf(inp.tasks, assign, hw))


def solve_reference(inp: PlanInput, hw: Hardware) -> Plan:
    """Scalar reference DP (the original implementation): property-test
    ground truth and the speedup baseline for the benchmarks."""
    m, n = len(inp.tasks), inp.n_workers
    rows = [_reward_row(inp, i, hw) for i in range(m)]
    # S[i][j]: best reward of first i tasks using j workers
    S = [[0.0] + [0.0] * n]
    choice: List[List[int]] = []
    for i in range(1, m + 1):
        row = [NEG] * (n + 1)
        ch = [0] * (n + 1)
        g = rows[i - 1]
        for j in range(n + 1):
            best, bk = NEG, 0
            for k in range(j + 1):
                v = S[i - 1][j - k] + g[k]
                if v > best:
                    best, bk = v, k
            row[j], ch[j] = best, bk
        S.append(row)
        choice.append(ch)
    # traceback from S(m, n)
    assign = [0] * m
    j = max(range(n + 1), key=lambda jj: S[m][jj])
    total = S[m][j]
    for i in range(m, 0, -1):
        k = choice[i - 1][j]
        assign[i - 1] = k
        j -= k
    return Plan(tuple(assign), total, _cluster_waf(inp.tasks, assign, hw))


def brute_force(inp: PlanInput, hw: Hardware) -> Plan:
    """Exponential reference solver (tests only)."""
    m, n = len(inp.tasks), inp.n_workers
    rows = [_reward_row(inp, i, hw) for i in range(m)]
    best: Optional[Tuple[float, Tuple[int, ...]]] = None
    for assign in itertools.product(range(n + 1), repeat=m):
        if sum(assign) > n:
            continue
        v = sum(rows[i][assign[i]] for i in range(m))
        if best is None or v > best[0]:
            best = (v, assign)
    v, assign = best
    return Plan(tuple(assign), v, _cluster_waf(inp.tasks, assign, hw))


# ---------------------------------------------------------------------------
# Fused one-program engine: schedule builder + program cache.
# ---------------------------------------------------------------------------

_FUSED_GROUP = 32   # scan step width G: chunk rows per scan step
_FUSED_ROW_COST = 4  # per-chunk-row overhead (gather/mask/scatter), in
#                      units of n1 cells — the adaptive-K cost model's
#                      only tunable


def _fused_chunk_width(bands: Sequence[int]) -> int:
    """Adaptive candidate-offset chunk width K for one schedule: minimize
    padded candidate slots + per-row overhead over the signature's actual
    band distribution.  K is static per program (it sets every gather
    width), so this is schedule-build work — e.g. a fleet
    of cap-16 tasks picks K=17 (band-16 ops become one exact chunk)
    instead of padding every 17-candidate op to a power of two."""
    if not bands:
        return 16
    best_k, best_cost = 16, None
    for k in range(8, 65):
        cost = sum(-(-(b + 1) // k) * (k + _FUSED_ROW_COST)
                   for b in bands)
        if best_cost is None or cost < best_cost:
            best_k, best_cost = k, cost
    return best_k


class _FusedSchedule:
    """Static whole-table rebuild schedule for one signature
    (m, n_max, per-task bands).

    Every banded max-plus convolution of the batched sweep is decomposed
    into ``ceil((band+1)/K)`` chunk rows — chunk ``c`` covering candidate
    offsets ``[cK, cK+K)`` — which scatter-max into the op's output slot
    (exact: the candidate set partitions over offset chunks and max is
    order-free).  Chunk rows are grouped by dependency level (merges
    bottom-up by tree depth, then the complement sweep top-down, then the
    fault combines), each level padded to a multiple of the group width
    ``G`` with inert dummy rows (band = -1), and flattened into
    ``(steps, G)`` int32 step tables one scan over the steps consumes.

    All vectors live in one (n_slots, width) slot buffer with ``K``-aware
    -inf margins on both sides, so a chunk's shifted ``prev`` window and
    its ``g`` chunk are plain gathers at
    static widths.  Operand orders and bands mirror ``_build_spans`` /
    ``_ensure_values`` exactly — outputs are bitwise-identical."""

    def __init__(self, m: int, n_max: int,
                 bands_unf: Tuple[int, ...], bands_f: Tuple[int, ...],
                 chunk: Optional[int] = None, group: int = _FUSED_GROUP):
        self.m, self.n_max = m, n_max
        self.group = group
        self.n1 = n_max + 1

        levels: List[List[Tuple[int, int]]] = []

        def walk(lo: int, hi: int, d: int) -> None:
            if len(levels) <= d:
                levels.append([])
            levels[d].append((lo, hi))
            if hi - lo > 1:
                mid = (lo + hi) // 2
                walk(lo, mid, d + 1)
                walk(mid, hi, d + 1)

        walk(0, m, 0)
        self.levels = levels
        nodes = [nd for lvl in levels for nd in lvl]
        self.v_slot = {nd: i for i, nd in enumerate(nodes)}
        base = len(nodes)
        self.c_slot = {nd: base + i for i, nd in enumerate(nodes)}
        base += len(nodes)
        self.fault_slot = {i: base + i for i in range(m)}
        base += m
        self.frow_slot = {i: base + i for i in range(m)}
        base += m
        self.scratch = base
        self.n_slots = base + 1

        sat_memo: Dict[Tuple[int, int], int] = {}

        def sat(lo: int, hi: int) -> int:
            got = sat_memo.get((lo, hi))
            if got is None:
                got = min(sum(bands_unf[lo:hi]), n_max)
                sat_memo[(lo, hi)] = got
            return got

        # op_steps: dependency-ordered groups of (prev, g, band, out).
        op_steps: List[List[Tuple[int, int, int, int]]] = []
        # V up-sweep: internal merges bottom-up, one step group per tree
        # depth (children are strictly deeper -> already reduced).
        for d in reversed(range(len(levels))):
            ops: List[Tuple[int, int, int, int]] = []
            for lo, hi in levels[d]:
                if hi - lo == 1:
                    continue
                mid = (lo + hi) // 2
                sl, sr = sat(lo, mid), sat(mid, hi)
                if sl < sr:               # band by the flatter operand
                    prev, g, band = (mid, hi), (lo, mid), sl
                else:
                    prev, g, band = (lo, mid), (mid, hi), sr
                ops.append((self.v_slot[prev], self.v_slot[g],
                            min(band, n_max), self.v_slot[(lo, hi)]))
            if ops:
                op_steps.append(ops)
        # Complement down-sweep: Comp(child) = Comp(parent) (+) V(sib).
        csat: Dict[Tuple[int, int], int] = {(0, m): 0}
        for d in range(len(levels) - 1):
            ops = []
            for lo, hi in levels[d]:
                if hi - lo == 1:
                    continue
                mid = (lo + hi) // 2
                for child, sib in (((lo, mid), (mid, hi)),
                                   ((mid, hi), (lo, mid))):
                    satc, sat_v = csat[(lo, hi)], sat(*sib)
                    csat[child] = min(satc + sat_v, n_max)
                    if satc < sat_v:      # band by the flatter operand
                        prev, g, band = (self.v_slot[sib],
                                         self.c_slot[(lo, hi)], satc)
                    else:
                        prev, g, band = (self.c_slot[(lo, hi)],
                                         self.v_slot[sib], sat_v)
                    ops.append((prev, g, min(band, n_max),
                                self.c_slot[child]))
            if ops:
                op_steps.append(ops)
        # Fault combines: Comp(leaf i) (+) faulted row i.
        ops = [(self.c_slot[(i, i + 1)], self.frow_slot[i],
                min(bands_f[i], n_max), self.fault_slot[i])
               for i in range(m)]
        if ops:
            op_steps.append(ops)

        # Static per-signature traceback metadata, bulk-copied into the
        # table's stores after a dispatch (saves the per-rebuild python
        # sweep the batched engine pays): span saturations, comp-tree
        # cumulative saturations and sibling paths.
        self.sat_map = dict(sat_memo)
        self.csat_map = csat
        csibs: Dict[Tuple[int, int], Tuple] = {(0, m): ()}
        for d in range(len(levels) - 1):
            for lo, hi in levels[d]:
                if hi - lo == 1:
                    continue
                mid = (lo + hi) // 2
                for child, sib in (((lo, mid), (mid, hi)),
                                   ((mid, hi), (lo, mid))):
                    csibs[child] = csibs[(lo, hi)] + (sib,)
        self.csibs_map = csibs

        all_bands = [op[2] for ops in op_steps for op in ops]
        self.chunk = chunk = (_fused_chunk_width(all_bands)
                              if chunk is None else chunk)
        steps: List[List[Tuple[int, int, int, int, int]]] = []
        for ops in op_steps:
            rows = [(prev, g, c, band, out)
                    for prev, g, band, out in ops
                    for c in range(0, band + 1, chunk)]
            steps.append(rows)
        # left margin sized to the widest chunk offset actually scheduled
        # (window start padl - off - (K-1) stays > 0, so a gather
        # never clamps); right margin keeps g-chunk reads past n_max in
        # -inf territory.  The scan carries the whole buffer, so every
        # saved column is saved once per step.
        max_off = max((r[2] for rows in steps for r in rows), default=0)
        self.padl = max_off + chunk
        self.width = self.padl + self.n1 + chunk

        dummy = (self.scratch, self.scratch, 0, -1, self.scratch)
        packed: List[Tuple[int, int, int, int, int]] = []
        self.real_rows = 0
        for rows in steps:
            self.real_rows += len(rows)
            rows = rows + [dummy] * (-len(rows) % group)
            packed.extend(rows)
        if not packed:
            packed = [dummy] * group
        table = np.asarray(packed, dtype=np.int32).reshape(-1, group, 5)
        self.n_steps = table.shape[0]
        self.xs = tuple(np.ascontiguousarray(table[:, :, i])
                        for i in range(5))
        self.leaf_slots = np.asarray(
            [self.v_slot[(i, i + 1)] for i in range(m)], dtype=np.int32)
        self.frow_slots = np.asarray(
            [self.frow_slot[i] for i in range(m)], dtype=np.int32)
        self.root_c_slot = self.c_slot[(0, m)]
        # scenario readout order: fault:0..m-1, finish:0..m-1, join:1
        self.scen_slots = np.asarray(
            [self.fault_slot[i] for i in range(m)]
            + [self.c_slot[(i, i + 1)] for i in range(m)]
            + [self.v_slot[(0, m)]], dtype=np.int32)


class _FusedProgram:
    """The whole-table rebuild of one schedule signature, on one device.

    ``__call__(g_unf, g_f, limits)`` takes the (m, n+1) float64 reward-row
    stacks and the (2m+1,) per-scenario argmax limits and returns host
    arrays: the (n_slots, n+1) slot values, per-scenario argmax cells and
    totals — the call contract of the reference's jitted program.  The
    step tables live on the device once per signature.  The program fills
    the float64 slot buffer (running maxima at the leaves, faulted rows,
    the root complement's zero), runs one ``maxplus_scan_step`` per scan
    step (kernel 5: it folds each chunk row's window against its reward
    chunk in ``dtype`` and max-reduces the widened result into the row's
    output slot; several rows of a step may share a slot, and the -inf
    dummy rows are skipped), and reads each scenario's first maximum up to
    its limit.

    On CUDA the program is one CUDA graph, the counterpart of the
    reference's ``jax.jit(self._program)``.  The inputs enter through
    static device buffers filled from pinned host staging, and the graph
    copies ``vals``, ``js`` and ``totals`` into pinned host buffers.  The
    first call runs the program eagerly: the warm-up that builds and loads
    the kernel library, since nothing may be built inside a capture.  The
    second call captures it and replays; every later call replays.  A
    failed capture raises: nothing on CUDA falls back to the eager program
    or to the plain step.  The kernel-5 launches recorded by the capture
    are counted on every replay (``build.capture_launches``).  On the CPU
    every call runs the same program eagerly with the plain step.

    The pinned outputs change at the next call, and callers keep views of
    the values (``PlanTable`` stores rows of ``vals``), so every call
    hands out fresh host copies.  A lock keeps calls that share the static
    buffers from interleaving.  ``close()`` frees the graph and its pool.
    """

    def __init__(self, sched: _FusedSchedule, device: torch.device,
                 dtype: torch.dtype):
        self.sched = sched
        self.device = device
        self.dtype = dtype
        m, n1, n_scen = sched.m, sched.n1, len(sched.scen_slots)

        def dev(a, dt=torch.int64):
            return torch.from_numpy(np.asarray(a)).to(device, dt)

        self._tables = dev(np.stack(sched.xs), torch.int32)  # (5, steps, G)
        self._ncols = torch.arange(n1, device=device)
        self._leaf = dev(sched.leaf_slots)
        self._frow = dev(sched.frow_slots)
        self._scen = dev(sched.scen_slots)
        pin = device.type == "cuda"

        def host(shape, dt):
            return torch.empty(shape, dtype=dt, pin_memory=pin)

        self._stage = (host((2, m, n1), torch.float64),
                       host(n_scen, torch.int64))
        self._inputs = tuple(torch.empty_like(t, device=device)
                             for t in self._stage)
        self._outputs = (host((sched.n_slots, n1), torch.float64),
                         host(n_scen, torch.int64),
                         host(n_scen, torch.float64))
        self._lock = threading.Lock()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._launches: Optional[build.GraphLaunches] = None
        self.calls = self.eager_calls = self.captures = self.replays = 0
        self.last_run: Optional[str] = None        # eager|capture|replay

    def _program(self, g_unf, g_f, limits):
        sc = self.sched
        K, n1, padl, width = sc.chunk, sc.n1, sc.padl, sc.width
        buf = torch.full((sc.n_slots, width), NEG, dtype=torch.float64,
                         device=self.device)
        inner = buf[:, padl:padl + n1]
        inner[self._leaf] = torch.cummax(g_unf, dim=1).values  # running max
        inner[self._frow] = g_f
        inner[sc.root_c_slot] = 0.0
        flat = buf.view(-1)
        for s in range(sc.n_steps):
            maxplus.maxplus_scan_step(flat, self._tables, s, K, n1, padl,
                                      width, self.dtype)
        scen = inner[self._scen]
        mask = self._ncols[None, :] <= limits[:, None]
        js = torch.argmax(torch.where(mask, scen, NEG), dim=1)  # first max
        totals = scen.gather(1, js[:, None])[:, 0]
        return inner, js, totals

    def _run(self) -> None:
        """Staging -> program -> pinned outputs, all on the stream (and in
        the graph, once captured)."""
        for dst, src in zip(self._inputs, self._stage):
            dst.copy_(src, non_blocking=True)
        g, limits = self._inputs
        for dst, src in zip(self._outputs, self._program(g[0], g[1], limits)):
            dst.copy_(src, non_blocking=True)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        with build.capture_launches() as launches, torch.cuda.graph(graph):
            self._run()
        self.graph, self._launches = graph, launches
        self.captures += 1

    def close(self) -> None:
        """Frees the graph and its private memory pool."""
        with self._lock:
            self.graph = self._launches = None

    def __call__(self, g_unf: np.ndarray, g_f: np.ndarray,
                 limits: np.ndarray):
        with self._lock:
            g, lim = (t.numpy() for t in self._stage)
            g[0], g[1], lim[:] = g_unf, g_f, limits
            if self.device.type != "cuda" or self.eager_calls == 0:
                self._run()
                self.eager_calls += 1
                self.last_run = "eager"
            else:
                self.last_run = "replay"
                if self.graph is None:
                    self._capture()
                    self.last_run = "capture"
                self.graph.replay()
                self._launches.replayed()
                self.replays += 1
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            self.calls += 1
            return tuple(t.numpy().copy() for t in self._outputs)


_FUSED_PROGRAMS: OrderedDict = OrderedDict()
_FUSED_PROGRAM_CAP = 32
_fused_lock = threading.Lock()


def _fused_program(m: int, n_max: int, bands_unf: Tuple[int, ...],
                   bands_f: Tuple[int, ...], device: torch.device,
                   dtype: torch.dtype) -> _FusedProgram:
    """Process-wide LRU of fused programs, keyed on the schedule signature
    and the device and dtype — same-signature churn rebuilds reuse the
    program and its device step tables (reward values are runtime
    inputs)."""
    key = (m, n_max, bands_unf, bands_f, device, dtype)
    with _fused_lock:
        prog = _FUSED_PROGRAMS.get(key)
        if prog is not None:
            _FUSED_PROGRAMS.move_to_end(key)
            return prog
    prog = _FusedProgram(_FusedSchedule(m, n_max, bands_unf, bands_f),
                         device, dtype)
    with _fused_lock:
        got = _FUSED_PROGRAMS.setdefault(key, prog)
        _FUSED_PROGRAMS.move_to_end(key)
        while len(_FUSED_PROGRAMS) > _FUSED_PROGRAM_CAP:
            _FUSED_PROGRAMS.popitem(last=False)[1].close()
        return got


class PlanTable:
    """Precomputed lookup table (§5.2 'Complexity'): one-step lookahead
    plans for every single-event scenario from the current configuration —
    any task losing one worker, a worker joining, a task finishing —
    giving O(1) dispatch when the event actually happens.

    Incremental build: base reward rows G(t_i, ·) at the largest scenario
    budget are computed once from the memoized cost-model curves, prefix
    DPs P[i] (tasks 0..i-1) and suffix DPs T[i] (tasks i..m-1) are each one
    max-plus pass, and every scenario is then assembled from them:

      fault:i   combine(P[i], fault-row_i, T[i+1])   (2 convolutions)
      join:1    combine(P[m//2], T[m//2])             (1 convolution)
      finish:i  combine(P[i], T[i+1])                 (1 convolution)

    ``lazy=True`` defers scenario assembly (and the node merges / chains
    feeding it) to the first ``lookup`` of each key: a table consulted for
    one scenario before the cluster state changes again only pays for that
    scenario.  A ``PlannerCache`` shares rows and node/chain vectors
    *across* rebuilds.  The batched engine additionally separates values
    from assignments: ``rebuild_values()`` materializes every scenario's
    total in a constant number of stacked kernel launches per tree level,
    and the O(m) argmax traceback runs only for keys ``lookup`` actually
    dispatches.

    ``engine="reference"`` retains the original scenario-by-scenario full
    solves (the reference path the tests compare against).
    """

    def __init__(self, tasks: Sequence[Task], assignment: Sequence[int],
                 hw: Hardware, d_running: float, d_transition: float,
                 workers_per_fault: int = 8, lazy: bool = False,
                 cache: Optional["PlannerCache"] = None,
                 n_budget: Optional[int] = None,
                 engine: Optional[str] = None,
                 device="cuda", dtype: torch.dtype = torch.float64):
        """``engine``: ``"batched"`` (default; level-synchronous stacked
        merges, shared complement sweep, value-only assembly with lazy
        traceback), ``"fused"`` (the whole-table value rebuild as one
        program of chunk-kernel launches, cached per schedule signature;
        lazy single lookups and tracebacks share the batched host
        machinery), ``"segtree"`` (per-node dyadic tree, one kernel call
        per merge), ``"chain"`` (prefix/suffix DP chains on host numpy,
        the churn-rebuild baseline) or ``"reference"`` (one scalar
        ``solve_reference`` per scenario — the all-scalar ground truth).

        ``device``: where the max-plus kernels run — ``"cuda"`` (default;
        raises without CUDA) launches the Hopper kernels, ``"cpu"`` runs
        their plain PyTorch versions.  ``dtype``: the kernels' arithmetic
        type — ``torch.float64`` (default; the reference's numpy
        precision, totals bitwise equal to it) or ``torch.float32`` (the
        reference's Pallas precision).  Argmax tracebacks and reward rows
        stay on the host in float64 either way.

        ``n_budget``: size the DP value arrays for this many workers (>=
        the largest scenario budget).  Plans are unchanged — every
        scenario argmax is sliced to its own budget — but a *fixed*
        budget (e.g. cluster capacity + one node) keeps cache keys and
        array shapes identical across rebuilds at different totals."""
        engine = resolve_engine(engine)
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"max-plus dtype must be float32 or float64, "
                             f"got {dtype}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.tasks = tuple(tasks)
        self.assignment = tuple(assignment)
        self.hw = hw
        self.d_running = d_running
        self.d_transition = d_transition
        self.workers_per_fault = workers_per_fault  # a node drain = 8 GPUs
        self.n_budget = n_budget
        self.engine = engine
        self._cache = cache
        self.table: Dict[str, Plan] = {}
        # batched/fused-engine accounting (zeros for the other engines):
        # tree/complement levels merged, stacked kernel launches issued,
        # plans materialized by on-demand traceback, and fused programs
        # executed (exactly 1 per whole-table fused rebuild).
        self.batch_stats: Dict[str, int] = {"levels": 0, "launches": 0,
                                            "tracebacks": 0,
                                            "device_dispatches": 0}
        # how the fused engine's last dispatch ran: "eager", "capture" or
        # "replay" (``_FusedProgram``); None until it dispatches
        self.fused_run: Optional[str] = None
        self._incremental = (engine != "reference"
                             and len(self.tasks) > 0
                             and _vector_capable(self.tasks))
        if self._incremental:
            self._init_incremental()
            if not lazy:
                if engine in ("batched", "fused"):
                    self._ensure_values()
                for key in self.scenario_keys():
                    self.lookup(key)
        else:
            self._precompute_reference()

    def scenario_keys(self) -> List[str]:
        m = len(self.tasks)
        return ([f"fault:{i}" for i in range(m)] + ["join:1"]
                + [f"finish:{i}" for i in range(m)])

    def _scenario_input(self, n_workers: int,
                        faulted_task: Optional[int]) -> PlanInput:
        faulted = tuple(i == faulted_task for i in range(len(self.tasks)))
        return PlanInput(self.tasks, self.assignment, n_workers,
                         self.d_running, self.d_transition, faulted)

    # ---- reference build: one full solve per scenario ---------------------

    def _precompute_reference(self) -> None:
        n_now = sum(self.assignment)
        w = self.workers_per_fault
        for ti in range(len(self.tasks)):
            key = f"fault:{ti}"
            self.table[key] = solve_reference(
                self._scenario_input(max(n_now - w, 0), ti), self.hw)
        self.table["join:1"] = solve_reference(
            self._scenario_input(n_now + w, None), self.hw)
        for ti in range(len(self.tasks)):
            # task ti finished: its workers return to the pool
            rem_tasks = self.tasks[:ti] + self.tasks[ti + 1:]
            rem_assign = self.assignment[:ti] + self.assignment[ti + 1:]
            inp = PlanInput(rem_tasks, rem_assign, n_now,
                            self.d_running, self.d_transition,
                            (False,) * len(rem_tasks))
            self.table[f"finish:{ti}"] = solve_reference(inp, self.hw)

    # ---- incremental build: shared rows + prefix/suffix DP chains ---------

    def _init_incremental(self) -> None:
        m = len(self.tasks)
        n_now = sum(self.assignment)
        w = self.workers_per_fault
        self._n_now = n_now
        self._n_join = n_now + w                # join is the largest budget
        self._n_max = max(self._n_join, self.n_budget or 0)
        self._n_fault = max(n_now - w, 0)
        self._rows: List[Optional[np.ndarray]] = [None] * m
        self._frows: Dict[int, np.ndarray] = {}
        self._P: List[Optional[np.ndarray]] = [None] * (m + 1)
        self._T: List[Optional[np.ndarray]] = [None] * (m + 1)
        self._P[0] = np.zeros(self._n_max + 1)
        self._T[m] = np.zeros(self._n_max + 1)
        # The chain engine keeps the plain numpy kernels on purpose: that
        # path IS the preserved churn-rebuild baseline whose wall-clock
        # the bench speedup floors are measured against.  The segment
        # tree runs on the banded max-plus kernel (device/dtype);
        # outputs of all kernels are bitwise identical on the same
        # candidate sets.
        self._conv = _maxplus_vals_fast if self._cache else _maxplus_vals
        self._V: Dict[Tuple[int, int], np.ndarray] = {}
        self._sat_memo: Dict[Tuple[int, int], int] = {}
        # batched engine: complement vectors per tree node (Comp(X) =
        # merge of X's root-path siblings), their cumulative saturations
        # and sibling paths, plus value-only scenario results
        # (vector, argmax cell, total) pending lazy traceback.
        self._Comp: Dict[Tuple[int, int], np.ndarray] = {}
        self._csat: Dict[Tuple[int, int], int] = {}
        self._csibs: Dict[Tuple[int, int], Tuple] = {}
        self._scen: Dict[str, Tuple[np.ndarray, int, float]] = {}
        self._level_nodes: Optional[List[List[Tuple[int, int]]]] = None
        self._tree_built = False
        self._values_built = False
        cache = self._cache
        if cache is not None:
            self._pairs = tuple((cache.task_id(t), x)
                                for t, x in zip(self.tasks,
                                                self.assignment))
            self._sig = (self.hw, self._n_max, self.d_running,
                         self.d_transition, self.dtype)

    def _pkey(self, i: int):
        return ("P", self._sig, self._pairs[:i])

    def _skey(self, i: int):
        return ("T", self._sig, self._pairs[i:])

    def _rkey(self, i: int, faulted: bool):
        return ("G", self._sig, self._pairs[i], faulted)

    def _row(self, i: int, faulted: bool = False) -> np.ndarray:
        store = self._frows if faulted else self._rows
        row = store.get(i) if faulted else store[i]
        if row is not None:
            return row

        def build() -> np.ndarray:
            return waf_mod.reward_curve(
                self.tasks[i], self.assignment[i], self._n_max,
                d_running=self.d_running, d_transition=self.d_transition,
                worker_faulted=faulted, hw=self.hw)

        if self._cache is not None:
            row = self._cache.array(self._rkey(i, faulted), build)
        else:
            row = build()
        store[i] = row
        return row

    def _prefix(self, i: int) -> np.ndarray:
        """P[i]: DP value vector over tasks 0..i-1 (cache-chained)."""
        start = i
        while self._P[start] is None:
            if self._cache is not None:
                hit = self._cache.array(self._pkey(start))
                if hit is not None:
                    self._P[start] = hit
                    break
            start -= 1
        for t in range(start + 1, i + 1):
            if self._P[t] is None:
                arr = self._conv(self._P[t - 1], self._row(t - 1))
                if self._cache is not None:
                    self._cache.array(self._pkey(t), lambda: arr)
                self._P[t] = arr
        return self._P[i]

    def _suffix(self, i: int) -> np.ndarray:
        """T[i]: DP value vector over tasks i..m-1 (cache-chained)."""
        start = i
        while self._T[start] is None:
            if self._cache is not None:
                hit = self._cache.array(self._skey(start))
                if hit is not None:
                    self._T[start] = hit
                    break
            start += 1
        for t in range(start - 1, i - 1, -1):
            if self._T[t] is None:
                arr = self._conv(self._T[t + 1], self._row(t))
                if self._cache is not None:
                    self._cache.array(self._skey(t), lambda: arr)
                self._T[t] = arr
        return self._T[i]

    def _cwaf(self, tasks: Sequence[Task], assign: Sequence[int]) -> float:
        """Cluster WAF of an assembled plan.  With a cache, reads F(t, ·)
        vectors (same floats as the scalar ``waf`` — the sweep mirrors the
        scalar arithmetic) instead of per-(task, x) model evaluations."""
        if self._cache is None:
            return _cluster_waf(tasks, assign, self.hw)
        total = 0.0
        for t, x in zip(tasks, assign):
            F = self._cache.array(
                ("F", self.hw, self._cache.task_id(t)),
                lambda t=t: waf_mod.waf_curve(t, self._n_max, self.hw))
            x = int(x)
            if x < F.shape[0]:
                total += float(F[x])
            else:
                total += waf_mod.waf(t, x, self.hw)
        return total

    def _walk_prefix(self, last: int, budget: int,
                     assign: List[int]) -> None:
        for t in range(last, -1, -1):
            k = _argmax_at(self._prefix(t), self._row(t), budget)
            assign[t] = k
            budget -= k

    def _walk_suffix(self, first: int, budget: int, assign: List[int],
                     offset: int = 0) -> None:
        for t in range(first, len(self.tasks)):
            k = _argmax_at(self._suffix(t + 1), self._row(t), budget)
            assign[t - offset] = k
            budget -= k

    def _assemble_chain(self, key: str) -> Optional[Plan]:
        """Build one scenario plan from the shared rows and P/T chains
        (same combine order and tie-breaking as the eager build)."""
        m = len(self.tasks)
        if key == "join:1":
            # combine at the mid split so both chain halves stay reusable
            # across rebuilds (a change at position i only invalidates the
            # half containing i)
            s = m // 2
            combined = self._conv(self._prefix(s), self._suffix(s))
            j = int(np.argmax(combined[:self._n_join + 1]))
            assign = [0] * m
            b = _argmax_at(self._prefix(s), self._suffix(s), j)
            self._walk_prefix(s - 1, j - b, assign)
            self._walk_suffix(s, b, assign)
            return Plan(tuple(assign), float(combined[j]),
                        self._cwaf(self.tasks, assign))
        kind, _, idx = key.partition(":")
        if not idx.isdigit():
            return None
        ti = int(idx)
        if not 0 <= ti < m:
            return None
        if kind == "fault":
            frow = self._row(ti, faulted=True)
            mid = None
            if self._cache is not None:    # P[ti] (+) fault-row, by prefix
                mid = self._cache.array(("M", self._sig,
                                         self._pairs[:ti + 1]))
            if mid is None:
                mid = self._conv(self._prefix(ti), frow)
                if self._cache is not None:
                    self._cache.array(("M", self._sig,
                                       self._pairs[:ti + 1]), lambda: mid)
            combined = self._conv(mid, self._suffix(ti + 1))
            j = int(np.argmax(combined[:self._n_fault + 1]))
            total = float(combined[j])
            assign = [0] * m
            b = _argmax_at(mid, self._suffix(ti + 1), j)   # suffix budget
            k = _argmax_at(self._prefix(ti), frow, j - b)  # faulted task
            assign[ti] = k
            self._walk_prefix(ti - 1, j - b - k, assign)
            self._walk_suffix(ti + 1, b, assign)
            return Plan(tuple(assign), total,
                        self._cwaf(self.tasks, assign))
        if kind == "finish":
            combined = self._conv(self._prefix(ti), self._suffix(ti + 1))
            j = int(np.argmax(combined[:self._n_now + 1]))
            total = float(combined[j])
            assign = [0] * (m - 1)
            b = _argmax_at(self._prefix(ti), self._suffix(ti + 1), j)
            self._walk_prefix(ti - 1, j - b, assign)
            self._walk_suffix(ti + 1, b, assign, offset=1)
            rem = self.tasks[:ti] + self.tasks[ti + 1:]
            return Plan(tuple(assign), total, self._cwaf(rem, assign))
        return None

    # ---- segment-tree engine: dyadic span merges + complement chains ------

    def _vals(self, prev: np.ndarray, g: np.ndarray,
              band: Optional[int]) -> np.ndarray:
        """One banded max-plus convolution on this table's device/dtype."""
        return _conv_vals(prev, g, band, self.device, self.dtype)

    def _band(self, i: int, faulted: bool = False) -> Optional[int]:
        """Band of task i's reward row: the row is flat past it (worker
        cap; plus the unfaulted row's no-transition spike at x_old), so
        banded convolutions with it are exact.  None = uncapped/dense."""
        cap = self.tasks[i].max_workers
        if cap is None:
            return None
        b = min(max(cap, 0), self._n_max)
        if not faulted:                    # g[x_old] spike breaks flatness
            b = min(max(b, self.assignment[i]), self._n_max)
        return b

    def _sat(self, lo: int, hi: int) -> int:
        """Saturation of span [lo, hi): V[lo, hi) is flat past the sum of
        its tasks' bands (more workers than every cap combined are idle).
        Memoized per table — the level sweeps consult every node's
        saturation repeatedly."""
        got = self._sat_memo.get((lo, hi))
        if got is not None:
            return got
        s = 0
        for i in range(lo, hi):
            b = self._band(i)
            s += self._n_max if b is None else b
            if s >= self._n_max:
                s = self._n_max
                break
        self._sat_memo[(lo, hi)] = s
        return s

    def _vkey(self, lo: int, hi: int):
        return ("V", self._sig, self._pairs[lo:hi])

    def _vvec(self, lo: int, hi: int) -> np.ndarray:
        """V[lo, hi): max-plus merge of the span's reward rows (best span
        reward using at most j workers), built by dyadic midpoint split
        and cached by span *contents* — a churn step at task u only
        invalidates the O(log m) spans containing u."""
        got = self._V.get((lo, hi))
        if got is not None:
            return got
        arr = None
        if self._cache is not None:
            arr = self._cache.array(self._vkey(lo, hi))
        if arr is None:
            if hi - lo == 1:
                arr = np.maximum.accumulate(self._row(lo))
            else:
                mid = (lo + hi) // 2
                left, right = self._vvec(lo, mid), self._vvec(mid, hi)
                sl, sr = self._sat(lo, mid), self._sat(mid, hi)
                if sl < sr:               # band by the flatter operand
                    arr = self._vals(right, left,
                                     sl if sl < self._n_max else None)
                else:
                    arr = self._vals(left, right,
                                     sr if sr < self._n_max else None)
            if self._cache is not None:
                self._cache.array(self._vkey(lo, hi), lambda: arr)
        self._V[(lo, hi)] = arr
        return arr

    def _path_sibs(self, ti: int) -> List[Tuple[int, int]]:
        """Siblings along the root -> leaf(ti) path, top-down: their
        union is every task except ti."""
        sibs: List[Tuple[int, int]] = []
        lo, hi = 0, len(self.tasks)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if ti < mid:
                sibs.append((mid, hi))
                hi = mid
            else:
                sibs.append((lo, mid))
                lo = mid
        return sibs

    def _ckey(self, sibs: Sequence[Tuple[int, int]]):
        return ("C", self._sig, tuple(self._pairs[a:b] for a, b in sibs))

    def _compl_chain(self, ti: int):
        """Complement chain of leaf ti: Cs[i] merges the first i root-path
        siblings, so Cs[-1] is the DP value vector over every task except
        ti (the ``finish:ti`` vector, and the ``fault:ti`` base)."""
        sibs = self._path_sibs(ti)
        Cs = [np.zeros(self._n_max + 1)]
        satc = 0
        for i, (a, b) in enumerate(sibs):
            C = None
            if self._cache is not None:
                C = self._cache.array(self._ckey(sibs[: i + 1]))
            if C is None:
                sat_v = self._sat(a, b)
                if satc < sat_v:          # band by the flatter operand
                    C = self._vals(self._vvec(a, b), Cs[i],
                                   satc if satc < self._n_max else None)
                else:
                    C = self._vals(Cs[i], self._vvec(a, b),
                                   sat_v if sat_v < self._n_max else None)
                if self._cache is not None:
                    self._cache.array(self._ckey(sibs[: i + 1]), lambda: C)
            satc = min(satc + self._sat(a, b), self._n_max)
            Cs.append(C)
        return sibs, Cs

    def _walk_span(self, lo: int, hi: int, budget: int,
                   assign: List[int]) -> None:
        """Traceback inside span [lo, hi): recover the per-task workers
        achieving V[lo, hi)[budget] by descending the tree (first-max
        splits, like the chain walks)."""
        if hi - lo == 1:
            assign[lo] = int(np.argmax(self._row(lo)[:budget + 1]))
            return
        mid = (lo + hi) // 2
        b = _argmax_at(self._vvec(lo, mid), self._vvec(mid, hi), budget)
        self._walk_span(mid, hi, b, assign)
        self._walk_span(lo, mid, budget - b, assign)

    def _walk_compl(self, sibs, Cs, budget: int,
                    assign: List[int]) -> None:
        for i in range(len(sibs) - 1, -1, -1):
            a, b_hi = sibs[i]
            b = _argmax_at(Cs[i], self._vvec(a, b_hi), budget)
            self._walk_span(a, b_hi, b, assign)
            budget -= b

    def _assemble_segtree(self, key: str) -> Optional[Plan]:
        """Build one scenario plan from O(log m) cached node merges."""
        m = len(self.tasks)
        if key == "join:1":
            root = self._vvec(0, m)
            j = int(np.argmax(root[:self._n_join + 1]))
            assign = [0] * m
            self._walk_span(0, m, j, assign)
            return Plan(tuple(assign), float(root[j]),
                        self._cwaf(self.tasks, assign))
        kind, _, idx = key.partition(":")
        if not idx.isdigit():
            return None
        ti = int(idx)
        if not 0 <= ti < m:
            return None
        if kind not in ("fault", "finish"):
            return None
        sibs, Cs = self._compl_chain(ti)
        C = Cs[-1]
        if kind == "fault":
            frow = self._row(ti, faulted=True)
            combined = None
            fkey = None
            if self._cache is not None:
                fkey = self._fm_key(ti)
                combined = self._cache.array(fkey)
            if combined is None:
                combined = self._vals(C, frow, self._band(ti, faulted=True))
                if self._cache is not None:
                    self._cache.array(fkey, lambda: combined)
            j = int(np.argmax(combined[:self._n_fault + 1]))
            total = float(combined[j])
            assign = [0] * m
            k = _argmax_at(C, frow, j)
            assign[ti] = k
            self._walk_compl(sibs, Cs, j - k, assign)
            return Plan(tuple(assign), total,
                        self._cwaf(self.tasks, assign))
        j = int(np.argmax(C[:self._n_now + 1]))
        total = float(C[j])
        assign = [0] * m
        self._walk_compl(sibs, Cs, j, assign)
        del assign[ti]
        rem = self.tasks[:ti] + self.tasks[ti + 1:]
        return Plan(tuple(assign), total, self._cwaf(rem, assign))

    # ---- batched engine: level-synchronous stacked sweeps + lazy traceback -

    def _fm_key(self, ti: int):
        """Cache key of the ``fault:ti`` combined vector (cache only)."""
        return ("FM", self._sig,
                (self._pairs[:ti], self._pairs[ti + 1:]), self._pairs[ti])

    def _levels(self) -> List[List[Tuple[int, int]]]:
        """Dyadic tree nodes grouped by depth (root first), memoized."""
        if self._level_nodes is None:
            out: List[List[Tuple[int, int]]] = []

            def walk(lo: int, hi: int, d: int) -> None:
                if len(out) <= d:
                    out.append([])
                out[d].append((lo, hi))
                if hi - lo > 1:
                    mid = (lo + hi) // 2
                    walk(lo, mid, d + 1)
                    walk(mid, hi, d + 1)

            walk(0, len(self.tasks), 0)
            self._level_nodes = out
        return self._level_nodes

    def _launch(self, rows: List[Tuple[np.ndarray, np.ndarray,
                                       Optional[int]]]) -> np.ndarray:
        """One stacked kernel launch over ``rows`` of (prev, g, band).
        A single-row level skips the stacking machinery — the 2-D kernel
        is the identical computation (and tiny tables are all single-row
        levels)."""
        self.batch_stats["launches"] += 1
        if len(rows) == 1:
            prev, g, band = rows[0]
            return self._vals(prev, g, band)[None, :]
        return _conv_vals_batched([r[0] for r in rows], [r[1] for r in rows],
                                  [r[2] for r in rows], self.device,
                                  self.dtype)

    def _node_hit(self, lo: int, hi: int) -> Optional[np.ndarray]:
        got = self._V.get((lo, hi))
        if got is None and self._cache is not None:
            got = self._cache.array(self._vkey(lo, hi))
            if got is not None:
                self._V[(lo, hi)] = got
        return got

    def _store_node(self, lo: int, hi: int, arr: np.ndarray) -> None:
        self._V[(lo, hi)] = arr
        if self._cache is not None:
            self._cache.array(self._vkey(lo, hi), lambda: arr)

    def _build_spans(self, roots: List[Tuple[int, int, int]]) -> None:
        """Level-synchronous V build of the given (lo, hi, depth)
        subtrees: descend pruning spans the cache already holds, build
        every missing leaf as one vectorized running-max pass, then merge
        each level's internal nodes with ONE stacked banded launch,
        bottom-up.  Same merges, operand orders and bands as ``_vvec`` —
        floats are identical.  Depths are global tree depths, so nodes of
        different subtrees land in shared level launches."""
        roots = [r for r in roots if (r[0], r[1]) not in self._V]
        if not roots:
            return
        need: List[List[Tuple[int, int]]] = [[] for _ in self._levels()]

        def visit(lo: int, hi: int, d: int) -> None:
            if self._node_hit(lo, hi) is not None:
                return
            need[d].append((lo, hi))
            if hi - lo > 1:
                mid = (lo + hi) // 2
                visit(lo, mid, d + 1)
                visit(mid, hi, d + 1)

        for lo, hi, d in roots:
            visit(lo, hi, d)
        leaves = [nd for lvl in need for nd in lvl if nd[1] - nd[0] == 1]
        if leaves:
            rows = np.stack([self._row(lo) for lo, _ in leaves])
            acc = np.maximum.accumulate(rows, axis=1)
            for r, (lo, hi) in enumerate(leaves):
                self._store_node(lo, hi, acc[r])
        for d in range(len(need) - 1, -1, -1):
            todo = [nd for nd in need[d] if nd[1] - nd[0] > 1]
            if not todo:
                continue
            stack = []
            for lo, hi in todo:
                mid = (lo + hi) // 2
                left, right = self._V[(lo, mid)], self._V[(mid, hi)]
                sl, sr = self._sat(lo, mid), self._sat(mid, hi)
                if sl < sr:               # band by the flatter operand
                    stack.append((right, left,
                                  sl if sl < self._n_max else None))
                else:
                    stack.append((left, right,
                                  sr if sr < self._n_max else None))
            out = self._launch(stack)
            self.batch_stats["levels"] += 1
            for r, (lo, hi) in enumerate(todo):
                self._store_node(lo, hi, out[r])

    def _ensure_tree(self) -> None:
        """Whole-tree V sweep (the join scenario and the whole-table
        value rebuild consume every node)."""
        if self._tree_built:
            return
        self._build_spans([(0, len(self.tasks), 0)])
        self._tree_built = True

    def _ensure_chain_spans(self, ti: int) -> None:
        """Build exactly the sibling subtrees leaf ti's complement chain
        merges — the same node set the segtree engine's recursive
        ``_vvec`` calls would touch for this scenario, but launched per
        level instead of per node.  Single cold dispatches therefore
        never pay for the root-path merges only ``join`` needs."""
        missing = [(a, b, i + 1)
                   for i, (a, b) in enumerate(self._path_sibs(ti))
                   if (a, b) not in self._V]
        if missing:
            self._build_spans(missing)

    def _comp_meta(self, child: Tuple[int, int], parent: Tuple[int, int],
                   sib: Tuple[int, int]) -> None:
        """Sibling path and cumulative saturation of a comp-tree child."""
        self._csibs[child] = self._csibs[parent] + (sib,)
        self._csat[child] = min(self._csat[parent] + self._sat(*sib),
                                self._n_max)

    def _comp_root(self) -> Tuple[int, int]:
        root = (0, len(self.tasks))
        if root not in self._Comp:
            self._Comp[root] = np.zeros(self._n_max + 1)
        self._csat.setdefault(root, 0)
        self._csibs.setdefault(root, ())
        return root

    def _total_entry(self, vec: np.ndarray,
                     limit: int) -> Tuple[np.ndarray, int, float]:
        j = int(np.argmax(vec[:limit + 1]))
        return vec, j, float(vec[j])

    def _ensure_values(self) -> None:
        """Whole-table value rebuild: the complement vector of EVERY tree
        node via one top-down level-parallel sweep (all children of a
        level in one stacked launch — the m per-leaf chains overlap in
        exactly these O(m) distinct nodes, so nothing is recomputed per
        scenario), then all m fault combines in one more launch, then
        every scenario's total.  NO argmax tracebacks — ``lookup`` runs
        those lazily for the scenario actually dispatched.

        On the fused engine the identical sweep (same operands, orders
        and bands) runs as ONE fused-program dispatch instead."""
        if self._values_built:
            return
        if self.engine == "fused":
            self._ensure_values_fused()
            return
        self._ensure_tree()
        m = len(self.tasks)
        self._comp_root()
        levels = self._levels()
        for d in range(len(levels) - 1):
            todo, stack = [], []
            for lo, hi in levels[d]:
                if hi - lo == 1:
                    continue
                mid = (lo + hi) // 2
                for child, sib in (((lo, mid), (mid, hi)),
                                   ((mid, hi), (lo, mid))):
                    self._comp_meta(child, (lo, hi), sib)
                    if child in self._Comp:
                        continue
                    C = None
                    if self._cache is not None:
                        C = self._cache.array(
                            self._ckey(self._csibs[child]))
                    if C is not None:
                        self._Comp[child] = C
                        continue
                    satc = self._csat[(lo, hi)]
                    sat_v = self._sat(*sib)
                    if satc < sat_v:      # band by the flatter operand
                        stack.append((self._vvec(*sib), self._Comp[(lo, hi)],
                                      satc if satc < self._n_max else None))
                    else:
                        stack.append((self._Comp[(lo, hi)], self._vvec(*sib),
                                      sat_v if sat_v < self._n_max else None))
                    todo.append(child)
            if todo:
                out = self._launch(stack)
                self.batch_stats["levels"] += 1
                for r, child in enumerate(todo):
                    arr = out[r]
                    self._Comp[child] = arr
                    if self._cache is not None:
                        self._cache.array(self._ckey(self._csibs[child]),
                                          lambda a=arr: a)
        todo, stack = [], []
        for ti in range(m):
            key = f"fault:{ti}"
            if key in self._scen:
                continue
            combined = None
            if self._cache is not None:
                combined = self._cache.array(self._fm_key(ti))
            if combined is not None:
                self._scen[key] = self._total_entry(combined, self._n_fault)
                continue
            stack.append((self._Comp[(ti, ti + 1)],
                          self._row(ti, faulted=True),
                          self._band(ti, faulted=True)))
            todo.append(ti)
        if todo:
            out = self._launch(stack)
            for r, ti in enumerate(todo):
                arr = out[r]
                if self._cache is not None:
                    self._cache.array(self._fm_key(ti), lambda a=arr: a)
                self._scen[f"fault:{ti}"] = self._total_entry(
                    arr, self._n_fault)
        for ti in range(m):
            self._scen.setdefault(f"finish:{ti}", self._total_entry(
                self._Comp[(ti, ti + 1)], self._n_now))
        self._scen.setdefault("join:1", self._total_entry(
            self._vvec(0, m), self._n_join))
        self._values_built = True

    def _fused_signature(self) -> Tuple:
        """Schedule signature of this table: the static inputs the
        fused program is keyed on (with the device and dtype).  Bands are
        normalized to ``n_max`` for uncapped/dense rows."""
        m = len(self.tasks)
        bu = tuple(self._n_max if b is None else b
                   for b in (self._band(i) for i in range(m)))
        bf = tuple(self._n_max if b is None else b
                   for b in (self._band(i, faulted=True)
                             for i in range(m)))
        return (m, self._n_max, bu, bf, self.device, self.dtype)

    def _ensure_values_fused(self) -> None:
        """Whole-table value rebuild as ONE fused-program dispatch:
        fetch (or build) the signature-keyed fused program, hand it the
        reward-row stacks and per-scenario argmax limits, and unpack the
        returned slot buffer into the batched engine's stores — the
        host-side lazy traceback machinery then works unchanged.  Node
        vectors are deliberately NOT written to the ``PlannerCache``
        array store: on this path the program cache is the reuse
        mechanism, and a recurring cluster state is already a whole-table
        hit at the ``PlannerCache.table`` level."""
        m = len(self.tasks)
        prog = _fused_program(*self._fused_signature())
        g_unf = np.stack([np.asarray(self._row(i), dtype=float)
                          for i in range(m)])
        g_f = np.stack([np.asarray(self._row(i, faulted=True),
                                   dtype=float) for i in range(m)])
        limits = np.asarray([self._n_fault] * m + [self._n_now] * m
                            + [self._n_join], dtype=np.int32)
        vals, js, totals = prog(g_unf, g_f, limits)
        self.batch_stats["device_dispatches"] += 1
        self.fused_run = prog.last_run
        sched = prog.sched
        for node, si in sched.v_slot.items():
            self._V[node] = vals[si]
        self._comp_root()
        for node, si in sched.c_slot.items():
            self._Comp.setdefault(node, vals[si])
        self._sat_memo.update(sched.sat_map)
        self._csat.update(sched.csat_map)
        self._csibs.update(sched.csibs_map)
        for ti in range(m):
            self._scen.setdefault(
                f"fault:{ti}", (vals[sched.fault_slot[ti]],
                                int(js[ti]), float(totals[ti])))
            self._scen.setdefault(
                f"finish:{ti}", (self._Comp[(ti, ti + 1)],
                                 int(js[m + ti]), float(totals[m + ti])))
        self._scen.setdefault("join:1", (self._V[(0, m)], int(js[2 * m]),
                                         float(totals[2 * m])))
        self._tree_built = True
        self._values_built = True

    def _chain_batched(self, ti: int):
        """(sibs, Cs) complement chain of leaf ti, reading the level-sweep
        store and computing (and storing) only missing links — the
        single-dispatch path shares every vector with the whole-table
        sweep (same operands, orders and bands: identical floats).

        Like the segtree engine's chain, a cached link costs nothing:
        the sibling V subtrees are only built — one stacked level launch
        per level, restricted to the missing siblings — past the longest
        already-known chain prefix."""
        sibs = self._path_sibs(ti)
        path = [self._comp_root()]
        for a, b in sibs:
            lo, hi = path[-1]
            mid = (lo + hi) // 2
            path.append((lo, mid) if (a, b) == (mid, hi) else (mid, hi))
        Cs = [self._Comp[path[0]]]
        known = 0
        for i, (sib, child) in enumerate(zip(sibs, path[1:])):
            self._comp_meta(child, path[i], sib)
            C = self._Comp.get(child)
            if C is None and self._cache is not None:
                C = self._cache.array(self._ckey(self._csibs[child]))
                if C is not None:
                    self._Comp[child] = C
            if C is None:
                break
            Cs.append(C)
            known = i + 1
        if known == len(sibs):
            return sibs, Cs
        self._build_spans([(a, b, i + 1)
                           for i, (a, b) in enumerate(sibs)
                           if i >= known and (a, b) not in self._V])
        for i in range(known, len(sibs)):
            a, b = sibs[i]
            child = path[i + 1]
            self._comp_meta(child, path[i], (a, b))
            C = self._Comp.get(child)
            if C is None and self._cache is not None:
                C = self._cache.array(self._ckey(self._csibs[child]))
            if C is None:
                satc = self._csat[path[i]]
                sat_v = self._sat(a, b)
                if satc < sat_v:          # band by the flatter operand
                    C = self._vals(self._vvec(a, b), Cs[-1],
                                   satc if satc < self._n_max else None)
                else:
                    C = self._vals(Cs[-1], self._vvec(a, b),
                                   sat_v if sat_v < self._n_max else None)
                if self._cache is not None:
                    self._cache.array(self._ckey(self._csibs[child]),
                                      lambda: C)
            self._Comp[child] = C
            Cs.append(C)
        return sibs, Cs

    def _fault_combined(self, ti: int, C: np.ndarray) -> np.ndarray:
        """``fault:ti`` combined vector: C(leaf ti) (+) fault-row, cache
        -shared with the whole-table sweep."""
        combined = None
        if self._cache is not None:
            combined = self._cache.array(self._fm_key(ti))
        if combined is None:
            combined = self._vals(C, self._row(ti, faulted=True),
                                  self._band(ti, faulted=True))
            if self._cache is not None:
                self._cache.array(self._fm_key(ti), lambda: combined)
        return combined

    def _parse_leaf_key(self, key: str) -> Optional[Tuple[str, int]]:
        kind, _, idx = key.partition(":")
        if kind not in ("fault", "finish") or not idx.isdigit():
            return None
        ti = int(idx)
        if not 0 <= ti < len(self.tasks):
            return None
        return kind, ti

    def _scen_entry(self, key: str
                    ) -> Optional[Tuple[np.ndarray, int, float]]:
        """Value-only scenario result (vector, argmax cell, total): from
        the whole-table sweep when built, else assembled for this key
        alone (single dispatches stay O(chain), not O(table))."""
        got = self._scen.get(key)
        if got is not None:
            return got
        if key == "join:1":
            self._ensure_tree()
            entry = self._total_entry(self._vvec(0, len(self.tasks)),
                                      self._n_join)
        else:
            parsed = self._parse_leaf_key(key)
            if parsed is None:
                return None
            kind, ti = parsed
            _, Cs = self._chain_batched(ti)
            if kind == "finish":
                entry = self._total_entry(Cs[-1], self._n_now)
            else:
                entry = self._total_entry(self._fault_combined(ti, Cs[-1]),
                                          self._n_fault)
        self._scen[key] = entry
        return entry

    def _assemble_batched(self, key: str) -> Optional[Plan]:
        """Materialize one scenario's Plan: value vectors from the batched
        store, then the lazy argmax traceback for just this key."""
        m = len(self.tasks)
        if key == "join:1":
            entry = self._scen_entry(key)
            vec, j, total = entry
            self.batch_stats["tracebacks"] += 1
            assign = [0] * m
            self._walk_span(0, m, j, assign)
            return Plan(tuple(assign), total,
                        self._cwaf(self.tasks, assign))
        parsed = self._parse_leaf_key(key)
        if parsed is None:
            return None
        kind, ti = parsed
        sibs, Cs = self._chain_batched(ti)
        entry = self._scen.get(key)
        if entry is None:
            if kind == "finish":
                entry = self._total_entry(Cs[-1], self._n_now)
            else:
                entry = self._total_entry(self._fault_combined(ti, Cs[-1]),
                                          self._n_fault)
            self._scen[key] = entry
        vec, j, total = entry
        self.batch_stats["tracebacks"] += 1
        # the argmax walks descend every sibling subtree, so build them
        # (level-launched; usually warm) even when the chain was cached
        self._ensure_chain_spans(ti)
        assign = [0] * m
        if kind == "fault":
            k = _argmax_at(Cs[-1], self._row(ti, faulted=True), j)
            assign[ti] = k
            self._walk_compl(sibs, Cs, j - k, assign)
            return Plan(tuple(assign), total,
                        self._cwaf(self.tasks, assign))
        self._walk_compl(sibs, Cs, j, assign)
        del assign[ti]
        rem = self.tasks[:ti] + self.tasks[ti + 1:]
        return Plan(tuple(assign), total, self._cwaf(rem, assign))

    def rebuild_values(self) -> Dict[str, float]:
        """Whole-table value rebuild: every scenario's value vector and
        total reward with NO assignment tracebacks.  Batched engine: a
        constant number of stacked launches per tree level; fused
        engine: ONE fused-program dispatch
        (``batch_stats["device_dispatches"]``).  Returns ``{scenario
        key: total reward}``.  The other engines (and the reference
        path) fall back to materializing every plan — that per-scenario
        cost is exactly what the whole-table churn benchmark measures
        against."""
        if self.engine in ("batched", "fused") and self._incremental:
            self._ensure_values()
            return {k: self._scen[k][2] for k in self.scenario_keys()}
        out: Dict[str, float] = {}
        for k in self.scenario_keys():
            plan = self.lookup(k)
            if plan is not None:
                out[k] = plan.total_reward
        return out

    def scenario_total(self, key: str) -> Optional[float]:
        """Total reward of one scenario without materializing its
        assignment.  Batched/fused engines: triggers the whole-table
        value sweep (totals are a whole-table product; single dispatches
        should use ``lookup``).  The other engines assemble the full
        plan."""
        if self.engine in ("batched", "fused") and self._incremental:
            hit = self.table.get(key)
            if hit is not None:
                return hit.total_reward
            self._ensure_values()
            entry = self._scen.get(key)
            return None if entry is None else entry[2]
        plan = self.lookup(key)
        return None if plan is None else plan.total_reward

    def _assemble(self, key: str) -> Optional[Plan]:
        if self.engine in ("batched", "fused"):
            # the fused engine shares the batched host-side machinery
            # for lazy single lookups and every argmax traceback
            return self._assemble_batched(key)
        if self.engine == "segtree":
            return self._assemble_segtree(key)
        return self._assemble_chain(key)

    def lookup(self, key: str) -> Optional[Plan]:
        plan = self.table.get(key)
        if plan is None and self._incremental and key not in self.table:
            plan = self._assemble(key)
            if plan is not None:
                self.table[key] = plan
        return plan


class PlannerCache:
    """Cross-rebuild planner cache (the follow-up to the
    incremental engine): reward rows, prefix/suffix DP value chains, whole
    lazy ``PlanTable``s, and fresh ``solve`` plans, shared across every
    rebuild a churn-heavy simulation issues.

    * A rebuild where only one task's assignment changed finds every P
      chain up to the change and every T chain past it already cached, and
      recomputes only the remainder.
    * A *recurring* cluster state (same task set + assignment + durations)
      is a whole-table hit — its scenarios are never reassembled.
    * Fresh solves (table misses, task launches) are memoized by their
      full ``PlanInput``.

    All stores are bounded LRUs; ``stats()`` exposes hit/miss counters for
    the benchmarks.  Plans served from the cache are float-identical to an
    uncached build: keys include every input the arrays depend on.
    """

    def __init__(self, max_arrays: int = 32768, max_tables: int = 4096,
                 max_plans: int = 32768):
        self._arrays: OrderedDict = OrderedDict()
        self._tables: OrderedDict = OrderedDict()
        self._plans: OrderedDict = OrderedDict()
        self._caps = {"arrays": max_arrays, "tables": max_tables,
                      "plans": max_plans}
        self._task_ids: Dict[object, int] = {}
        self._lock = threading.RLock()
        self.hits = {"arrays": 0, "tables": 0, "plans": 0}
        self.misses = {"arrays": 0, "tables": 0, "plans": 0}

    def task_id(self, task) -> int:
        """Intern a task: chain keys hash small ints, not task objects."""
        with self._lock:
            tid = self._task_ids.get(task)
            if tid is None:
                tid = len(self._task_ids)
                self._task_ids[task] = tid
            return tid

    def _memo(self, store: OrderedDict, name: str, key, build):
        """Thread-compatible get-or-build.  The build runs outside the
        lock: concurrent Monte-Carlo seeds may duplicate a computation,
        but every entry is fully determined by its key, so whichever
        lands is identical — results never depend on scheduling."""
        with self._lock:
            got = store.get(key)
            if got is not None:
                store.move_to_end(key)
                self.hits[name] += 1
                return got
        if build is None:
            return None
        got = build()
        with self._lock:
            if key not in store:
                self.misses[name] += 1
                store[key] = got
                if len(store) > self._caps[name]:
                    store.popitem(last=False)
            else:
                got = store[key]
        return got

    def array(self, key, build=None) -> Optional[np.ndarray]:
        return self._memo(self._arrays, "arrays", key, build)

    def table(self, tasks: Sequence[Task], assignment: Sequence[int],
              hw: Hardware, d_running: float, d_transition: float,
              workers_per_fault: int = 8,
              n_budget: Optional[int] = None,
              engine: Optional[str] = None,
              task_ids: Optional[Tuple[int, ...]] = None,
              prebuild: bool = False, device="cuda",
              dtype: torch.dtype = torch.float64) -> PlanTable:
        """A lazy PlanTable for this cluster state, memoized by state.
        ``engine``: canonical name from ``engines()["engine"]`` (default
        ``"batched"``; part of the memo key).  ``task_ids``: the
        already-interned ``task_id`` tuple for ``tasks`` (callers that
        refresh per event keep it across rebuilds — the task set only
        changes on churn).  ``prebuild=True`` runs the whole-table value
        rebuild before returning (idempotent; on the batched engine a
        constant number of stacked launches per tree level, value-only —
        no tracebacks): churn-driven coordinators use it to restore
        O(1)-ish dispatch for every scenario after a task set change.
        ``device``/``dtype``: as for ``PlanTable`` (part of the memo
        key)."""
        engine = resolve_engine(engine)
        device = resolve_device(device)
        tasks, assignment = tuple(tasks), tuple(assignment)
        if task_ids is None:
            task_ids = tuple(self.task_id(t) for t in tasks)
        key = (task_ids, assignment, hw,
               d_running, d_transition, workers_per_fault, n_budget,
               engine, device, dtype)
        table = self._memo(
            self._tables, "tables", key,
            lambda: PlanTable(tasks, assignment, hw, d_running,
                              d_transition, workers_per_fault,
                              lazy=True, cache=self, n_budget=n_budget,
                              engine=engine, device=device, dtype=dtype))
        if prebuild:
            table.rebuild_values()
        return table

    def solve(self, inp: PlanInput, hw: Hardware) -> Plan:
        """Memoized fresh dispatch (``solve_fast`` — same plans as
        ``solve``, value-chain kernel)."""
        key = (tuple(self.task_id(t) for t in inp.tasks), inp.assignment,
               inp.n_workers, inp.d_running, inp.d_transition,
               inp.faulted, hw)
        return self._memo(self._plans, "plans", key,
                          lambda: solve_fast(inp, hw))

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {"hits": dict(self.hits), "misses": dict(self.misses),
                "sizes": {"arrays": len(self._arrays),
                          "tables": len(self._tables),
                          "plans": len(self._plans)}}
