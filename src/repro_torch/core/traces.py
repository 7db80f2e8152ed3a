"""Failure traces (§7.5).  Copied from ``repro/core/traces.py`` (the
seeded ``random`` generator, so a trace is identical to the reference's).

*trace-b*: the failure rate of 8 weeks on a 16-node (128 GPU) cluster
amplified 20x and compressed to 7 days — 26 SEV1 + 80 other failures,
Poisson arrivals; repaired nodes rejoin after 2-12 hours.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional

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


def trace_b(n_nodes: int = 16, seed: int = 11) -> List[FailureEvent]:
    return _make_trace(span_s=7 * DAY, n_sev1=26, n_other=80,
                       n_nodes=n_nodes, repair_lo=2 * 3600.0,
                       repair_hi=12 * 3600.0, seed=seed, poisson=True)


def trace_span(trace: List[FailureEvent]) -> float:
    """Nominal span for WAF integration."""
    if not trace:
        return 0.0
    return 8 * WEEK if trace[-1].time > 8 * DAY else 7 * DAY
