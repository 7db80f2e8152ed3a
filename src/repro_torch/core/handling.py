"""Error handling workflow (§4.2, Figure 7): severity-driven actions with
escalation, SEV3 -> reattempt, SEV2 -> restart, SEV1 -> reconfigure.

Copied from ``repro/core/handling.py``: actions, the reconfiguration
triggers, escalation, ``FailureCase`` and the coordinator's ``decide``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

from repro_torch.core.detection import ErrorKind, Severity, classify


class Action(enum.Enum):
    REATTEMPT = "reattempt_in_place"       # (1) SEV3
    RESTART = "restart_process"            # (2) SEV2
    RECONFIGURE = "reconfigure_cluster"    # (3) SEV1
    RESUME = "resume_training"             # reattempt succeeded


class Trigger(enum.Enum):
    ERROR = "error"
    NODE_JOIN = "node_join"                # (4)
    TASK_FINISHED = "task_finished"        # (5)
    TASK_LAUNCHED = "task_launched"        # (6)


def action_for(severity: Severity) -> Action:
    return {
        Severity.SEV3: Action.REATTEMPT,
        Severity.SEV2: Action.RESTART,
        Severity.SEV1: Action.RECONFIGURE,
    }[severity]


def escalate(severity: Severity) -> Severity:
    """SEV3 -> SEV2 -> SEV1 (SEV1 has no further escalation)."""
    return Severity(max(1, int(severity) - 1))


@dataclass
class FailureCase:
    """One failure instance moving through the workflow."""
    kind: ErrorKind
    severity: Severity
    attempts: int = 0

    @classmethod
    def from_kind(cls, kind: ErrorKind) -> "FailureCase":
        return cls(kind=kind, severity=classify(kind)[1])

    def next_action(self) -> Action:
        return action_for(self.severity)

    def record_failure(self) -> Action:
        """The last action did not resolve the issue: escalate."""
        self.attempts += 1
        self.severity = escalate(self.severity)
        return self.next_action()


@dataclass
class HandlingDecision:
    action: Action
    severity: Severity
    isolate_node: bool                 # SEV1: drain the faulty node
    replan_all_tasks: bool             # Unicron replans the whole cluster


def decide(case: FailureCase, *, multi_task: bool = True) -> HandlingDecision:
    act = case.next_action()
    return HandlingDecision(
        action=act,
        severity=case.severity,
        isolate_node=(act is Action.RECONFIGURE),
        replan_all_tasks=(act is Action.RECONFIGURE and multi_task),
    )
