"""In-band error detection (§4.1): severities, methods, the Table-1 error
table, the Table-2 detection latencies and the online statistical monitor,
with their array forms over (kinds x policies) and over a fleet of tasks
(``detection_times``, ``FleetMonitor``) that the simulator's engines read.

Copied from ``repro/core/detection.py`` (all but ``HeartbeatTable``).
"""
from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional, Sequence, Tuple

import numpy as np


class Severity(enum.IntEnum):
    SEV1 = 1          # most severe: node lost / must drain
    SEV2 = 2          # process restart required
    SEV3 = 3          # transient; reattempt in place


class Method(enum.Enum):
    NODE_HEALTH = "node_health_monitoring"
    PROCESS = "process_supervision"
    EXCEPTION = "exception_propagation"
    STATISTICAL = "online_statistical_monitoring"


class ErrorKind(enum.Enum):
    LOST_CONNECTION = "lost_connection"
    EXITED_ABNORMALLY = "exited_abnormally"
    CONNECTION_REFUSED = "connection_refused_reset"
    ILLEGAL_MEMORY_ACCESS = "illegal_memory_access"
    ECC_ERROR = "ecc_error"
    INVALID_DMA_MAPPING = "invalid_dma_mapping"
    CUDA_ERROR = "cuda_error"
    NVLINK_ERROR = "nvlink_error"
    GPU_DRIVER_ERROR = "gpu_driver_error"
    OTHER_NETWORK_ERROR = "other_network_error"
    OTHER_SOFTWARE_ERROR = "other_software_error"
    NCCL_TIMEOUT = "nccl_timeout"
    LINK_FLAPPING = "link_flapping"
    TASK_HANG = "task_hang"


# Table 1: detection method and severity per error status.
ERROR_TABLE: Dict[ErrorKind, Tuple[Method, Severity]] = {
    ErrorKind.LOST_CONNECTION: (Method.NODE_HEALTH, Severity.SEV1),
    ErrorKind.EXITED_ABNORMALLY: (Method.PROCESS, Severity.SEV2),
    ErrorKind.CONNECTION_REFUSED: (Method.PROCESS, Severity.SEV3),
    ErrorKind.ILLEGAL_MEMORY_ACCESS: (Method.PROCESS, Severity.SEV2),
    ErrorKind.ECC_ERROR: (Method.EXCEPTION, Severity.SEV1),
    ErrorKind.INVALID_DMA_MAPPING: (Method.EXCEPTION, Severity.SEV1),
    ErrorKind.CUDA_ERROR: (Method.EXCEPTION, Severity.SEV2),
    ErrorKind.NVLINK_ERROR: (Method.EXCEPTION, Severity.SEV1),
    ErrorKind.GPU_DRIVER_ERROR: (Method.EXCEPTION, Severity.SEV1),
    ErrorKind.OTHER_NETWORK_ERROR: (Method.EXCEPTION, Severity.SEV3),
    ErrorKind.OTHER_SOFTWARE_ERROR: (Method.EXCEPTION, Severity.SEV2),
    ErrorKind.NCCL_TIMEOUT: (Method.STATISTICAL, Severity.SEV3),
    ErrorKind.LINK_FLAPPING: (Method.STATISTICAL, Severity.SEV3),
    ErrorKind.TASK_HANG: (Method.STATISTICAL, Severity.SEV2),
}


def classify(kind: ErrorKind) -> Tuple[Method, Severity]:
    return ERROR_TABLE[kind]


HEARTBEAT_DETECT_S = 5.6        # Unicron node-health (persistent conn)
PROCESS_DETECT_S = 1.8          # per-GPU monitor thread notices exit
EXCEPTION_DETECT_S = 0.3        # exception propagation
STAT_MULTIPLIER = 3.0           # statistical: 3 x avg iteration time
DEGRADE_MARGIN = 1.1            # Fig. 6 blue line

BASELINE_HEARTBEAT_S = 5.7      # w/o Unicron: scheduler notices node loss
BASELINE_TIMEOUT_S = 30 * 60.0  # Megatron/NCCL default watchdog

# recovery policies that run an in-band detection stack (Table-2 Unicron
# column): unicron itself plus the modern-recovery peers, all of which
# ship agent-side monitors; the paper's four baselines rely on scheduler
# heartbeats / collective timeouts
INBAND_POLICIES = frozenset({
    "unicron", "fftrainer", "hierarchical_ckpt", "redundant",
})


def detection_time(kind: ErrorKind, avg_iter_s: float,
                   unicron: bool = True) -> float:
    """Seconds from fault occurrence to detection (Table 2)."""
    method, _ = classify(kind)
    if not unicron:
        if method is Method.NODE_HEALTH:
            return BASELINE_HEARTBEAT_S
        return BASELINE_TIMEOUT_S
    return {
        Method.NODE_HEALTH: HEARTBEAT_DETECT_S,
        Method.PROCESS: PROCESS_DETECT_S,
        Method.EXCEPTION: EXCEPTION_DETECT_S,
        Method.STATISTICAL: STAT_MULTIPLIER * avg_iter_s,
    }[method]


# ---------------------------------------------------------------------------
# Array-native detection model: the Table-1/Table-2 lookup vectorized over
# (kinds x policies).  Same floats as ``detection_time`` at every cell.
# ---------------------------------------------------------------------------

_KINDS: Tuple[ErrorKind, ...] = tuple(ErrorKind)
KIND_INDEX: Dict[ErrorKind, int] = {k: i for i, k in enumerate(_KINDS)}
_METHODS: Tuple[Method, ...] = (Method.NODE_HEALTH, Method.PROCESS,
                                Method.EXCEPTION, Method.STATISTICAL)
_METHOD_INDEX = {m: i for i, m in enumerate(_METHODS)}
_STAT_CODE = _METHOD_INDEX[Method.STATISTICAL]
# per-kind method code and severity int, indexable by KIND_INDEX
KIND_METHOD = np.array([_METHOD_INDEX[ERROR_TABLE[k][0]] for k in _KINDS])
KIND_SEVERITY = np.array([int(ERROR_TABLE[k][1]) for k in _KINDS])
# per-method fixed latencies; the statistical entry is a placeholder (its
# latency scales with the average iteration time, filled in per query)
_UNICRON_BY_METHOD = np.array([HEARTBEAT_DETECT_S, PROCESS_DETECT_S,
                               EXCEPTION_DETECT_S, 0.0])
_BASELINE_BY_METHOD = np.array([BASELINE_HEARTBEAT_S, BASELINE_TIMEOUT_S,
                                BASELINE_TIMEOUT_S, BASELINE_TIMEOUT_S])


def detection_times(kinds: Sequence[ErrorKind], avg_iter_s,
                    unicron) -> np.ndarray:
    """Detection latencies for every (kind, policy) pair as one
    (len(kinds), len(unicron)) matrix (Table 2 vectorized).

    ``unicron`` is a boolean vector over the policy axis (True = in-band
    Unicron detection); ``avg_iter_s`` is a scalar or broadcastable to
    (len(kinds), len(unicron)) — statistical detection is
    ``STAT_MULTIPLIER * avg_iter_s`` per cell, exactly the scalar
    ``detection_time`` arithmetic, so every cell equals the scalar call."""
    ki = np.array([KIND_INDEX[k] for k in kinds])
    uni = np.asarray(unicron, dtype=bool)
    method = KIND_METHOD[ki][:, None]                      # (K, 1)
    avg = np.broadcast_to(np.asarray(avg_iter_s, dtype=float),
                          (ki.size, uni.size))
    uni_t = np.where(method == _STAT_CODE, STAT_MULTIPLIER * avg,
                     _UNICRON_BY_METHOD[method])
    return np.where(uni[None, :], uni_t, _BASELINE_BY_METHOD[method])


@dataclass
class OnlineStatMonitor:
    """Rolling-average iteration monitor (Fig. 6): an in-flight iteration
    is degraded past 1.1x the average and failed past 3x."""
    window: int = 64
    _hist: Deque[float] = field(default_factory=deque)

    def observe(self, iter_s: float) -> None:
        self._hist.append(iter_s)
        if len(self._hist) > self.window:
            self._hist.popleft()

    @property
    def average(self) -> Optional[float]:
        if not self._hist:
            return None
        return sum(self._hist) / len(self._hist)

    def status(self, waited_s: float) -> str:
        """'ok' | 'degraded' | 'failed' for an in-flight iteration."""
        avg = self.average
        if avg is None:
            return "ok"
        if waited_s > STAT_MULTIPLIER * avg:
            return "failed"
        if waited_s > DEGRADE_MARGIN * avg:
            return "degraded"
        return "ok"


class FleetMonitor:
    """Array-native §4.1 statistical monitor: one (tasks, window) float
    ring buffer replacing per-task ``OnlineStatMonitor`` deques inside the
    simulation engines.

    Rows hold the rolling iteration history of one task each; ``observe``
    is a vectorized scatter, ``averages``/``statuses`` are masked row
    reductions.  A row primed with a constant history reports exactly the
    scalar monitor's average (the window is a power of two, so the mean of
    identical values is exact), which is the only regime the engines
    consult — ``OnlineStatMonitor`` stays the scalar reference the
    property tests compare against."""

    def __init__(self, n_tasks: int, window: int = 64):
        self.window = window
        self._n = n_tasks
        cap = max(1, n_tasks)
        self._buf = np.zeros((cap, window))
        self._pos = np.zeros(cap, dtype=np.int64)
        self._count = np.zeros(cap, dtype=np.int64)

    @classmethod
    def primed(cls, avg_iter_s: Sequence[float],
               window: int = 64) -> "FleetMonitor":
        """One row per task, each warmed with a full window of its
        steady-state iteration time (``OnlineStatMonitor.primed`` for a
        whole fleet)."""
        avg = np.asarray(avg_iter_s, dtype=float)
        mon = cls(avg.size, window=window)
        mon._buf[:mon._n] = avg[:, None]
        mon._count[:mon._n] = window
        return mon

    @property
    def n_tasks(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        return self._buf.shape[0]

    def grow(self, avg_iter_s: float) -> int:
        """Admit one task (churn): returns its row index, primed.

        Reallocation is amortized: the ring buffer doubles geometrically
        when full, so a churn-heavy trace admitting k tasks costs O(k)
        total row copies instead of O(k^2) per-admit reallocs."""
        if self._n == self._buf.shape[0]:
            cap = max(8, 2 * self._buf.shape[0])
            buf = np.zeros((cap, self.window))
            pos = np.zeros(cap, dtype=np.int64)
            count = np.zeros(cap, dtype=np.int64)
            buf[:self._n] = self._buf
            pos[:self._n] = self._pos
            count[:self._n] = self._count
            self._buf, self._pos, self._count = buf, pos, count
        row = self._n
        self._n += 1
        self._buf[row] = float(avg_iter_s)
        self._pos[row] = 0
        self._count[row] = self.window
        return row

    def observe(self, tasks: Sequence[int], iter_s) -> None:
        """Record one completed iteration per task (vectorized scatter)."""
        ti = np.asarray(tasks, dtype=np.int64)
        self._buf[ti, self._pos[ti]] = np.asarray(iter_s, dtype=float)
        self._pos[ti] = (self._pos[ti] + 1) % self.window
        self._count[ti] = np.minimum(self._count[ti] + 1, self.window)

    def averages(self, tasks: Optional[Sequence[int]] = None) -> np.ndarray:
        """Rolling averages per task; NaN where a row has no history."""
        ti = (np.arange(self.n_tasks) if tasks is None
              else np.asarray(tasks, dtype=np.int64))
        count = self._count[ti]
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(count > 0,
                            self._buf[ti].sum(axis=1) / count, np.nan)

    def statuses(self, tasks: Sequence[int], waited_s) -> np.ndarray:
        """Status codes per (task, waited) pair: 0 ok / 1 degraded /
        2 failed — the Fig. 6 thresholds, vectorized."""
        avg = self.averages(tasks)
        waited = np.broadcast_to(np.asarray(waited_s, dtype=float),
                                 avg.shape)
        out = np.zeros(avg.shape, dtype=np.int64)
        with np.errstate(invalid="ignore"):
            out[waited > DEGRADE_MARGIN * avg] = 1
            out[waited > STAT_MULTIPLIER * avg] = 2
        return out
