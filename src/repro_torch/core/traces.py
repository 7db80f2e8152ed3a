"""Failure traces (§7.5).  Copied from ``repro/core/traces.py`` (the
seeded ``random`` generator, so a trace is identical to the reference's,
and the numpy draws the scenario library makes).

*trace-a*: 8 weeks on a 16-node (128 GPU) cluster — 10 SEV1 node faults
plus 33 SEV2/SEV3 failures; node repair time uniform in [1, 7] days.

*trace-b*: trace-a's frequency amplified 20x, compressed to 7 days —
26 SEV1 + 80 other failures, Poisson arrivals; repaired nodes rejoin at a
similar rate (repair uniform in [2, 12] hours) to keep the pool stable.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.detection import ErrorKind, Severity, classify

DAY = 86400.0
WEEK = 7 * DAY

# §2.2: 73% of failures are transient (restart suffices).  Within the
# non-SEV1 population we mix process/exception/statistical kinds.
NON_SEV1_KINDS = [
    (ErrorKind.CUDA_ERROR, 0.22),
    (ErrorKind.EXITED_ABNORMALLY, 0.18),
    (ErrorKind.ILLEGAL_MEMORY_ACCESS, 0.10),
    (ErrorKind.OTHER_SOFTWARE_ERROR, 0.12),
    (ErrorKind.NCCL_TIMEOUT, 0.14),
    (ErrorKind.CONNECTION_REFUSED, 0.10),
    (ErrorKind.LINK_FLAPPING, 0.06),
    (ErrorKind.TASK_HANG, 0.08),
]
SEV1_KINDS = [
    (ErrorKind.LOST_CONNECTION, 0.5),
    (ErrorKind.ECC_ERROR, 0.2),
    (ErrorKind.NVLINK_ERROR, 0.15),
    (ErrorKind.GPU_DRIVER_ERROR, 0.15),
]


@dataclass(frozen=True)
class FailureEvent:
    time: float                 # seconds from trace start
    node: int
    kind: ErrorKind
    repair_s: Optional[float]   # SEV1 only: node returns after this long

    @property
    def severity(self) -> Severity:
        return classify(self.kind)[1]


def sample_kinds(rng: np.random.Generator,
                 weighted: Sequence[Tuple[ErrorKind, float]],
                 size: int) -> List[ErrorKind]:
    """Vectorized weighted kind draw (the numpy counterpart of ``_pick``,
    used by the seeded generators in ``core.scenarios``)."""
    kinds = [k for k, _ in weighted]
    w = np.array([p for _, p in weighted], dtype=float)
    idx = rng.choice(len(kinds), size=size, p=w / w.sum())
    return [kinds[i] for i in idx]


def poisson_times(rng: np.random.Generator, rate_per_s: float,
                  span_s: float) -> np.ndarray:
    """Sorted Poisson-process arrival times on [0, span): exponential
    inter-arrivals drawn in one vectorized batch (over-sample by 4 sigma,
    extend in the rare shortfall), clipped to the span."""
    if rate_per_s <= 0.0 or span_s <= 0.0:
        return np.empty(0)
    expect = rate_per_s * span_s
    n_draw = int(expect + 4.0 * np.sqrt(expect) + 16)
    gaps = rng.exponential(1.0 / rate_per_s, size=n_draw)
    t = np.cumsum(gaps)
    while t[-1] < span_s:                      # astronomically rare
        extra = rng.exponential(1.0 / rate_per_s, size=n_draw)
        t = np.concatenate([t, t[-1] + np.cumsum(extra)])
    return t[t < span_s]


def _pick(rng: random.Random, weighted) -> ErrorKind:
    r = rng.random() * sum(w for _, w in weighted)
    acc = 0.0
    for kind, w in weighted:
        acc += w
        if r <= acc:
            return kind
    return weighted[-1][0]


def _make_trace(*, span_s: float, n_sev1: int, n_other: int, n_nodes: int,
                repair_lo: float, repair_hi: float, seed: int,
                poisson: bool) -> List[FailureEvent]:
    rng = random.Random(seed)
    events: List[FailureEvent] = []

    def times(n: int) -> List[float]:
        if poisson:
            # exponential inter-arrival, rescaled to span
            gaps = [rng.expovariate(1.0) for _ in range(n)]
            total = sum(gaps)
            acc, out = 0.0, []
            for g in gaps:
                acc += g
                out.append(acc / total * span_s * rng.uniform(0.9, 1.0))
            return sorted(out)
        return sorted(rng.uniform(0, span_s) for _ in range(n))

    for t in times(n_sev1):
        events.append(FailureEvent(
            time=t, node=rng.randrange(n_nodes),
            kind=_pick(rng, SEV1_KINDS),
            repair_s=rng.uniform(repair_lo, repair_hi)))
    for t in times(n_other):
        events.append(FailureEvent(
            time=t, node=rng.randrange(n_nodes),
            kind=_pick(rng, NON_SEV1_KINDS), repair_s=None))
    return sorted(events, key=lambda e: e.time)


def trace_a(n_nodes: int = 16, seed: int = 7) -> List[FailureEvent]:
    return _make_trace(span_s=8 * WEEK, n_sev1=10, n_other=33,
                       n_nodes=n_nodes, repair_lo=1 * DAY, repair_hi=7 * DAY,
                       seed=seed, poisson=False)


def trace_b(n_nodes: int = 16, seed: int = 11) -> List[FailureEvent]:
    return _make_trace(span_s=7 * DAY, n_sev1=26, n_other=80,
                       n_nodes=n_nodes, repair_lo=2 * 3600.0,
                       repair_hi=12 * 3600.0, seed=seed, poisson=True)


def trace_span(trace: List[FailureEvent]) -> float:
    """Nominal span for WAF integration."""
    if not trace:
        return 0.0
    return 8 * WEEK if trace[-1].time > 8 * DAY else 7 * DAY
