"""In-band error detection (§4.1): severities, methods, the Table-1 error
table, the Table-2 detection latencies and the online statistical monitor.

Copied from ``repro/core/detection.py`` (the scalar subset the training
loop calls).
"""
from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional, Tuple


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
