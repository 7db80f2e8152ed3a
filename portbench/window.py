"""Window arithmetic on step records, and the spread statistics that set
the bounds: plain functions of numbers, so the tests can feed them
synthetic records."""
from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple


def window(records: Sequence[dict]) -> Tuple[float, int]:
    """(seconds, tokens) of a window of step records ({"t0", "t1",
    "tokens"}): from the first step's start to the last step's end."""
    if not records:
        raise ValueError("the window holds no step")
    return (records[-1]["t1"] - records[0]["t0"],
            sum(r["tokens"] for r in records))


def rate(records: Sequence[dict]) -> float:
    seconds, tokens = window(records)
    return tokens / seconds


def median(values: Iterable[float]) -> float:
    return statistics.median(list(values))


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile (Python's
    ``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, sorted and disjoint."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_and_gaps(intervals: Iterable[Tuple[float, float]], start: float,
                  end: float):
    """(busy time, idle gaps [(start, end)]) of device activity
    ``intervals`` clipped to the window [start, end)."""
    clipped = [(max(a, start), min(b, end)) for a, b in intervals
               if b > start and a < end]
    merged = merge(clipped)
    busy = sum(b - a for a, b in merged)
    gaps, at = [], start
    for a, b in merged:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if end > at:
        gaps.append((at, end))
    return busy, gaps

