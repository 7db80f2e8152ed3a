"""The reduction of a ``torch.profiler`` trace (its Chrome JSON export) to
what the per-layer metrics and the result's ``breakdown`` read: the traced
window, the device's busy time in it, each kernel's time and calls by
name, and the idle gaps labelled by what the host was doing.

The traced window is the span ``WINDOW`` that the harness opens around the
traced steps; device activity is every kernel, copy and memset."""
from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from portbench.window import busy_and_gaps

WINDOW = "portbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
SPAN_PREFIX = "portbench."


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]          # name -> (seconds, calls)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def top_ops(self, n: int = 10) -> List[list]:
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])
        return [[name[:160], secs] for name, (secs, _) in rows[:n]]

    def top_gaps(self, n: int = 10) -> List[list]:
        return [[label, secs] for label, secs in
                sorted(self.gaps, key=lambda g: -g[1])[:n]]


def _host_label(host: List[Tuple[float, float, str, bool]], t: float) -> str:
    """The innermost benchmark span and the innermost host op at time t."""
    span, op = None, None
    for a, b, name, is_span in host:
        if a <= t <= b:
            if is_span:
                if span is None or b - a < span[0]:
                    span = (b - a, name)
            elif op is None or b - a < op[0]:
                op = (b - a, name)
    parts = [x[1] for x in (span, op) if x is not None]
    return " > ".join(parts) if parts else "no host op"


def summarize(events: List[dict]) -> Trace:
    """A ``Trace`` of the Chrome trace ``events`` (times in microseconds)."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW and e.get("cat") in HOST_CATS]
    if not win:
        raise ValueError(f"the trace has no {WINDOW!r} span")
    start = min(e["ts"] for e in win)
    end = max(e["ts"] + e["dur"] for e in win)
    device, host = [], []
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") != "X":
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            if b > start and a < end:
                device.append((a, b))
                k = kernels[e["name"]]
                k[0] += (min(b, end) - max(a, start)) / 1e6
                k[1] += 1
        elif cat in HOST_CATS and b >= start and a <= end:
            host.append((a, b, e["name"],
                         e["name"].startswith(SPAN_PREFIX)
                         and e["name"] != WINDOW))
    busy, gaps = busy_and_gaps(device, start, end)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    labelled = [(_host_label(host, (a + b) / 2), (b - a) / 1e6)
                for a, b in longest]
    return Trace(window_s=(end - start) / 1e6, busy_s=busy / 1e6,
                 kernels={k: (v[0], v[1]) for k, v in kernels.items()},
                 gaps=labelled)


def load(path: str) -> Trace:
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"])
