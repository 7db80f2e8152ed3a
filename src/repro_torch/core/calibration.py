"""Fleet failure calibration tables — committed parameter data.  Copied
from ``repro/core/calibration.py``.

The synthetic scenario generators in ``core/scenarios.py`` draw event
times from exponential/Poisson processes; this module pins their *rates*
to published datacenter characterizations so the calibrated family
(``scenarios.calibrated_*``) reproduces real per-category failure rates
and the MTTF-vs-fleet-size scaling:

* "Characterization of Large Language Model Development in the
  Datacenter" (arXiv 2403.07648, PAPERS.md) — the Acme fleet study:
  per-category infrastructure/software failure shares, NVLink/ECC
  hardware fault taxonomy, and the observation that most interruptions
  are software or transient-network, not node-fatal hardware.
* "Revisiting Reliability in Large-Scale Machine Learning Research
  Clusters" (arXiv 2410.21680, PAPERS.md) — the Meta study: job MTTF of
  roughly 7.9 hours at 1024-GPU scale, which with 8-GPU nodes anchors a
  per-node MTBF of ~42 days, and MTTF scaling inversely with the number
  of nodes (independent Poisson superposition).

Numbers here are the single source of truth: the generators read them,
``tests/test_calibration.py`` statistically asserts the generated event
streams match them (Poisson counts, category shares, exponential
inter-arrival KS, 1/n MTTF scaling), and ``benchmarks/bench_frontier.py``
drives the recovery-policy frontier over traces drawn from them (those
are the reference's; ``tests/test_torch_scenarios.py`` holds this copy's
tables equal to it).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.detection import ErrorKind

DAY = 24 * 3600.0

# ---------------------------------------------------------------------------
# Per-category failure taxonomy (Acme Table 3 / Meta §4, collapsed onto
# the repo's ErrorKind vocabulary).  ``share`` is the fraction of all
# failure interruptions attributed to the category; shares sum to 1.
# SEV1 categories (node-fatal hardware / lost nodes) carry a repair-time
# range; software/transient categories release the node immediately.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FailureCategory:
    name: str
    share: float                              # fraction of all failures
    kinds: Tuple[ErrorKind, ...]              # ErrorKinds drawn uniformly
    repair_range_s: Optional[Tuple[float, float]] = None  # SEV1 only


CATEGORIES: Tuple[FailureCategory, ...] = (
    # -- node-fatal hardware (SEV1), ~31% in total: Acme attributes ~30%
    #    of failures to infrastructure, dominated by NVLink/ECC/network
    FailureCategory("nvlink", 0.09, (ErrorKind.NVLINK_ERROR,),
                    repair_range_s=(4 * 3600.0, 24 * 3600.0)),
    FailureCategory("ecc", 0.06, (ErrorKind.ECC_ERROR,),
                    repair_range_s=(2 * 3600.0, 12 * 3600.0)),
    FailureCategory("network_sev1", 0.12,
                    (ErrorKind.LOST_CONNECTION,
                     ErrorKind.INVALID_DMA_MAPPING),
                    repair_range_s=(1 * 3600.0, 8 * 3600.0)),
    FailureCategory("gpu_driver", 0.04, (ErrorKind.GPU_DRIVER_ERROR,),
                    repair_range_s=(1 * 3600.0, 6 * 3600.0)),
    # -- software crashes (SEV2-ish), the plurality of interruptions
    FailureCategory("software", 0.45,
                    (ErrorKind.CUDA_ERROR,
                     ErrorKind.OTHER_SOFTWARE_ERROR,
                     ErrorKind.EXITED_ABNORMALLY,
                     ErrorKind.ILLEGAL_MEMORY_ACCESS)),
    # -- transient network blips (SEV3)
    FailureCategory("network_transient", 0.16,
                    (ErrorKind.OTHER_NETWORK_ERROR,
                     ErrorKind.CONNECTION_REFUSED,
                     ErrorKind.LINK_FLAPPING)),
    # -- hangs caught by the statistical monitor
    FailureCategory("hang", 0.08,
                    (ErrorKind.NCCL_TIMEOUT, ErrorKind.TASK_HANG)),
)


@dataclass(frozen=True)
class FleetCalibration:
    """Rate table for the calibrated generators.

    ``node_mtbf_s`` anchors everything: Meta reports a ~7.9 h MTTF for
    1024-GPU (128-node) jobs; independent per-node Poisson failures give
    fleet MTTF = node_mtbf / n, so node_mtbf = 128 * 7.9 h ~ 42 days.
    """
    node_mtbf_s: float = 42.0 * DAY
    categories: Tuple[FailureCategory, ...] = CATEGORIES
    # slow-node degradation (stragglers): Acme's performance-degradation
    # anomalies; per-node rate, window length range
    slow_rate_per_node_s: float = 1.0 / (120.0 * DAY)
    slow_duration_range_s: Tuple[float, float] = (600.0, 7200.0)
    # iteration-time multiplier: above the 1.1x degradation margin,
    # below the 3x failure threshold (Fig. 6)
    slow_slowdown_range: Tuple[float, float] = (1.15, 2.5)
    # correlated bursts (switch/PSU domain): a group of nodes lost at
    # once — the replica-loss driver for tier-aware restores
    burst_rate_per_node_s: float = 1.0 / (1280.0 * DAY)
    burst_group_size: int = 8
    burst_hit_fraction: float = 0.75
    burst_repair_range_s: Tuple[float, float] = (1 * 3600.0, 6 * 3600.0)
    # preemption waves (cluster scheduler reclaims capacity): fleet-level
    # rate, fraction of nodes reclaimed per wave
    preempt_wave_rate_s: float = 1.0 / (30.0 * DAY)
    preempt_fraction_range: Tuple[float, float] = (0.1, 0.2)
    preempt_outage_range_s: Tuple[float, float] = (900.0, 3600.0)

    def failure_rate_s(self, n_nodes: int) -> float:
        """Fleet-level failure event rate (events/second)."""
        return float(n_nodes) / self.node_mtbf_s

    def mttf_s(self, n_nodes: int) -> float:
        """Expected fleet MTTF — scales as 1/n (Poisson superposition)."""
        return self.node_mtbf_s / float(n_nodes)

    def category_shares(self) -> Dict[str, float]:
        return {c.name: c.share for c in self.categories}

    def sev1_share(self) -> float:
        """Fraction of failures that are node-fatal (repair required)."""
        return sum(c.share for c in self.categories
                   if c.repair_range_s is not None)

    def scaled(self, intensity: float) -> "FleetCalibration":
        """A copy with every event rate multiplied by ``intensity``
        (shares and ranges untouched) — for stress/quick configs."""
        return dataclasses.replace(
            self,
            node_mtbf_s=self.node_mtbf_s / intensity,
            slow_rate_per_node_s=self.slow_rate_per_node_s * intensity,
            burst_rate_per_node_s=self.burst_rate_per_node_s * intensity,
            preempt_wave_rate_s=self.preempt_wave_rate_s * intensity)


DEFAULT_CALIBRATION = FleetCalibration()

# guard the committed table: shares must form a distribution
assert abs(sum(c.share for c in CATEGORIES) - 1.0) < 1e-12
