"""Control-plane chaos schedules.  Copied from ``repro/core/chaos.py``
(``ChaosSchedule`` only): the discrete-event simulator reads a schedule's
``crash_times`` as coordinator crashes; the message-level faults (drop,
delay, duplication, partitions) act on the control loop, which the port
does not run yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ChaosSchedule:
    """One seeded chaos trace for the control plane.

    ``end_s`` is the injection horizon: no drop/delay/dup after it (the
    settle window the convergence property needs).  Partitions and
    crashes carry their own times and may end later than ``end_s``; the
    overall quiet point is :meth:`horizon`."""
    seed: int = 0
    drop_p: float = 0.0
    delay_p: float = 0.0
    max_delay_s: float = 0.0
    dup_p: float = 0.0
    # (node, start_s, end_s) windows; generators keep them disjoint
    partitions: Tuple[Tuple[int, float, float], ...] = ()
    crash_times: Tuple[float, ...] = ()
    end_s: float = 0.0

    def horizon(self) -> float:
        """Last instant any injection can still be active."""
        h = self.end_s + self.max_delay_s
        for _, _, end in self.partitions:
            h = max(h, end)
        for t in self.crash_times:
            h = max(h, t)
        return h
