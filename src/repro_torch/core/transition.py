"""Transition strategy (§6) — tier-aware duration model + state migration.
Copied from ``repro/core/transition.py`` (without the ``migration_source``
alias); ``migrate_state`` restores through the port's checkpoint manager.

``TransitionCost`` estimates the seconds a task spends transitioning under
each recovery policy; the components mirror Figure 2 / §7.3:

  detect -> (plan lookup) -> process respawn -> state migration
        -> partial-iteration recompute -> resume

Checkpoint-tier realism.  Restores follow the nearest principle (§6.3),
the same preference order ``checkpoint/manager.py`` implements for real
state: a healthy DP replica over the fast interconnect, else the GEMINI
in-memory ring checkpoint in a neighbor's host DRAM, else the remote
persistent store.  ``restore_tier`` picks the tier that would actually
satisfy the restore — including *replica-loss* bursts where a correlated
failure takes out both a node and its in-memory ring neighbor
(``replica_lost=True``), which demotes a dp==1 restore all the way to the
persistent tier — and ``lost_work_seconds`` charges the recompute that
tier implies: sub-iteration partial-result recovery from a replica, one
snapshot interval for the in-memory ring, half the persistent checkpoint
interval (``CKPT_INTERVAL_S``) when only the cloud FS survives.

Policies.  The paper's five (§7.3: unicron; megatron/varuna checkpoint
restart; oobleck/bamboo dynamic reconfiguration) are joined by three
modern recovery techniques as first-class peers:

* ``fftrainer`` — hot-spare failover (FFTrainer, PAPERS.md): a reserved
  spare substitutes for the failed node in ``FFTRAINER_FAILOVER_S``
  (near-zero), state arrives from the DP replica, and recompute is half
  an iteration.  The spares themselves are capacity the planner can
  never assign — the WAF cost lives in the engines, not this model.
* ``hierarchical_ckpt`` — tiered restore with per-tier bandwidth: the
  in-memory ring normally (``BW_INMEMORY``), demoted to the persistent
  tier on replica loss, with the lost-work charge following the tier.
* ``redundant`` — redundant computation that continues through failures:
  the transition cost is identically zero and the price is a standing
  throughput tax (the engines' EFFICIENCY table), like replication-based
  systems that degrade instead of stopping.

``migrate_state`` performs the real migration via CheckpointManager;
``estimate_*`` provides the simulator's timing, and ``estimate_batch``
reproduces every scalar cell bitwise on a stacked policy axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager

# ---------------------------------------------------------------------------
# Timing constants (paper §1, §7 and GEMINI-reported bandwidths)
# ---------------------------------------------------------------------------

RESPAWN_UNICRON_S = 30.0            # warm process respawn inside agent
RESPAWN_BASELINE_S = (9 + 14) * 60.0  # resubmit (9min) + env/CUDA (14min)
PLAN_LOOKUP_S = 0.1                 # O(1) lookup-table dispatch
PLAN_SOLVE_S = 2.0                  # fresh O(mn^2) solve

BW_DP_REPLICA = 150e9               # bytes/s — fast interconnect replicate
BW_INMEMORY = 25e9                  # bytes/s — host RAM / neighbor fetch
BW_PERSISTENT = 20e9                # bytes/s — cloud FS (paper: 20 GB/s)

CKPT_INTERVAL_S = 30 * 60.0         # baseline checkpoint interval
MEAN_RECOMPUTE_BASELINE_S = 15 * 60.0  # paper footnote 2

FFTRAINER_FAILOVER_S = 2.0          # hot-spare substitution (FFTrainer)
RESPAWN_HIERARCHICAL_S = 60.0       # tiered-ckpt runtime reinit
INMEMORY_SNAPSHOT_ITERS = 1.0       # GEMINI ring snapshots every iteration


@dataclass(frozen=True)
class TransitionCost:
    detect_s: float
    plan_s: float
    respawn_s: float
    migrate_s: float
    recompute_s: float

    @property
    def total(self) -> float:
        return (self.detect_s + self.plan_s + self.respawn_s
                + self.migrate_s + self.recompute_s)


def restore_tier(dp_degree: int, inmemory_available: bool = True,
                 replica_lost: bool = False) -> str:
    """Nearest principle (§6.3): healthy DP replica -> GEMINI in-memory
    ring -> persistent store.

    ``replica_lost`` models a correlated burst that took out the failed
    node's in-memory ring neighbor too — the in-memory tier cannot
    satisfy the restore, so a dp==1 task falls through to persistent."""
    if dp_degree > 1:
        return "dp_replica"
    if inmemory_available and not replica_lost:
        return "inmemory"
    return "persistent"


def migration_source(dp_degree: int, inmemory_available: bool) -> str:
    """Back-compat alias for :func:`restore_tier` (no replica loss);
    copied from repro/core/transition.py:102."""
    return restore_tier(dp_degree, inmemory_available)


def migrate_seconds(state_bytes: float, source: str) -> float:
    bw = {"dp_replica": BW_DP_REPLICA, "inmemory": BW_INMEMORY,
          "persistent": BW_PERSISTENT}[source]
    return state_bytes / bw


def lost_work_seconds(tier: str, avg_iter_s: float,
                      dp_degree: int = 1) -> float:
    """Recompute seconds implied by the tier that satisfies the restore.

    * ``dp_replica`` — partial-result reuse: survivors redo an expected
      half of the in-flight iteration, amortized across the replicas.
    * ``inmemory`` — the GEMINI ring snapshots every
      ``INMEMORY_SNAPSHOT_ITERS`` iterations, so the expected loss is
      half a snapshot interval plus the in-flight iteration.
    * ``persistent`` — half the checkpoint interval on average.
    """
    if tier == "dp_replica":
        return 0.5 * avg_iter_s * (1.0 + 1.0 / max(dp_degree - 1, 1))
    if tier == "inmemory":
        return 0.5 * avg_iter_s * (INMEMORY_SNAPSHOT_ITERS + 1.0)
    return 0.5 * CKPT_INTERVAL_S


def estimate_unicron(state_bytes: float, avg_iter_s: float,
                     dp_degree: int, detect_s: float,
                     inmemory_available: bool = True,
                     lookup_hit: bool = True,
                     replica_lost: bool = False) -> TransitionCost:
    """Unicron: restore from the nearest surviving tier; partial-results
    reuse bounds recompute by roughly one iteration when a DP replica
    survives, and the tier's snapshot cadence bounds it otherwise."""
    tier = restore_tier(dp_degree, inmemory_available, replica_lost)
    return TransitionCost(
        detect_s=detect_s,
        plan_s=PLAN_LOOKUP_S if lookup_hit else PLAN_SOLVE_S,
        respawn_s=RESPAWN_UNICRON_S,
        migrate_s=migrate_seconds(state_bytes, tier),
        recompute_s=lost_work_seconds(tier, avg_iter_s, dp_degree))


def estimate_baseline(state_bytes: float, detect_s: float, *,
                      dynamic_reconfig: bool,
                      ckpt_restart: bool) -> TransitionCost:
    """Baselines (§7.3):
    * Megatron / Varuna: full restart from the persistent checkpoint +
      mean 15 min recompute.
    * Oobleck / Bamboo: dynamic reconfiguration — no checkpoint reload,
      but they restart the iteration (lose in-flight work) and pay a
      coordination respawn.
    """
    if ckpt_restart:
        return TransitionCost(
            detect_s=detect_s, plan_s=0.0,
            respawn_s=RESPAWN_BASELINE_S,
            migrate_s=migrate_seconds(state_bytes, "persistent"),
            recompute_s=MEAN_RECOMPUTE_BASELINE_S)
    # dynamic reconfiguration without Unicron's partial-result reuse
    return TransitionCost(
        detect_s=detect_s, plan_s=PLAN_SOLVE_S,
        respawn_s=90.0 if dynamic_reconfig else RESPAWN_BASELINE_S,
        migrate_s=migrate_seconds(state_bytes, "dp_replica"),
        recompute_s=60.0)


def estimate_fftrainer(state_bytes: float, avg_iter_s: float,
                       detect_s: float) -> TransitionCost:
    """FFTrainer hot-spare failover: a reserved spare takes the failed
    node's place in seconds, state streams from the DP replica, and the
    survivors redo half an iteration.  No plan step — the substitution
    preserves the parallelization configuration."""
    return TransitionCost(
        detect_s=detect_s, plan_s=0.0,
        respawn_s=FFTRAINER_FAILOVER_S,
        migrate_s=migrate_seconds(state_bytes, "dp_replica"),
        recompute_s=0.5 * avg_iter_s)


def estimate_hierarchical(state_bytes: float, avg_iter_s: float,
                          detect_s: float, *,
                          replica_lost: bool = False) -> TransitionCost:
    """Tiered-checkpoint restore: the GEMINI in-memory ring normally,
    demoted to the persistent tier when a correlated burst also took the
    ring neighbor; lost work follows the tier's snapshot cadence."""
    tier = "persistent" if replica_lost else "inmemory"
    return TransitionCost(
        detect_s=detect_s, plan_s=0.0,
        respawn_s=RESPAWN_HIERARCHICAL_S,
        migrate_s=migrate_seconds(state_bytes, tier),
        recompute_s=lost_work_seconds(tier, avg_iter_s))


def estimate_redundant() -> TransitionCost:
    """Redundancy-based continuation: surviving replicas absorb the work
    with zero stoppage — the price is the standing EFFICIENCY tax, not a
    transition."""
    return TransitionCost(0.0, 0.0, 0.0, 0.0, 0.0)


# ---------------------------------------------------------------------------
# Array-native transition model: per-policy cost matrices for the batched
# simulator.  Rows reproduce the scalar ``estimate_*`` components exactly.
# ---------------------------------------------------------------------------

COMPONENTS = ("detect", "plan", "respawn", "migrate", "recompute")

# which scalar estimate a recovery policy maps to (the §7.3 behaviours the
# simulator encodes): unicron -> estimate_unicron; megatron/varuna ->
# checkpoint restart; oobleck/bamboo -> dynamic reconfiguration; the
# modern-recovery peers map to their dedicated estimators
CKPT_RESTART_POLICIES = frozenset({"megatron", "varuna"})
DYNAMIC_POLICIES = frozenset({"oobleck", "bamboo"})
FFTRAINER_POLICIES = frozenset({"fftrainer"})
HIERARCHICAL_POLICIES = frozenset({"hierarchical_ckpt"})
REDUNDANT_POLICIES = frozenset({"redundant"})


def estimate_batch(policies: Sequence[str], state_bytes, avg_iter_s,
                   dp_degree, detect_s, *, lookup_hit: bool = True,
                   inmemory_available: bool = True,
                   replica_lost=False) -> np.ndarray:
    """Transition costs for every policy as one
    (len(policies), len(COMPONENTS)) matrix.

    Each argument is a scalar or a (len(policies),) vector — owners (and
    so state sizes, iteration times, DP degrees, detection latencies and
    replica-loss flags) differ per policy once trajectories diverge.
    Row p equals the ``TransitionCost`` the scalar path computes for
    that policy: ``estimate_unicron`` for ``"unicron"``,
    checkpoint-restart ``estimate_baseline`` for megatron/varuna,
    dynamic-reconfiguration ``estimate_baseline`` for oobleck/bamboo,
    ``estimate_fftrainer`` / ``estimate_hierarchical`` /
    ``estimate_redundant`` for the modern-recovery peers — same formulas
    applied elementwise, so every cell is bitwise-identical to the
    scalar call.  (Bamboo's ride-through of SEV2/3 failures, fftrainer's
    spare-pool bookkeeping and redundant's capacity degradation are
    engine-level rules on top of this matrix, as in the scalar
    simulator.)"""
    P = len(policies)
    shape = (P,)
    sb = np.broadcast_to(np.asarray(state_bytes, dtype=float), shape)
    avg = np.broadcast_to(np.asarray(avg_iter_s, dtype=float), shape)
    dp = np.broadcast_to(np.asarray(dp_degree, dtype=np.int64), shape)
    det = np.broadcast_to(np.asarray(detect_s, dtype=float), shape)
    rl = np.broadcast_to(np.asarray(replica_lost, dtype=bool), shape)
    is_uni = np.array([p == "unicron" for p in policies])
    is_ckpt = np.array([p in CKPT_RESTART_POLICIES for p in policies])
    is_dyn = np.array([p in DYNAMIC_POLICIES for p in policies])
    is_fft = np.array([p in FFTRAINER_POLICIES for p in policies])
    is_hier = np.array([p in HIERARCHICAL_POLICIES for p in policies])
    is_red = np.array([p in REDUNDANT_POLICIES for p in policies])
    unknown = ~(is_uni | is_ckpt | is_dyn | is_fft | is_hier | is_red)
    if unknown.any():
        bad = [p for p, u in zip(policies, unknown) if u]
        raise ValueError(f"unknown recovery policies {bad}")
    out = np.empty((P, len(COMPONENTS)))
    out[:, 0] = det
    # plan: O(1) lookup (or fresh solve) for unicron, a solve for dynamic
    # reconfigurators, nothing for checkpoint restarts / modern peers
    out[:, 1] = np.where(is_uni,
                         PLAN_LOOKUP_S if lookup_hit else PLAN_SOLVE_S,
                         np.where(is_dyn, PLAN_SOLVE_S, 0.0))
    out[:, 2] = np.where(
        is_uni, RESPAWN_UNICRON_S,
        np.where(is_dyn, 90.0,
                 np.where(is_fft, FFTRAINER_FAILOVER_S,
                          np.where(is_hier, RESPAWN_HIERARCHICAL_S,
                                   RESPAWN_BASELINE_S))))
    # migrate: nearest surviving tier for unicron (replica loss demotes a
    # dp==1 restore to persistent), persistent for ckpt restart, dp
    # replica for dynamic reconfiguration and fftrainer failover, the
    # in-memory ring (or persistent on replica loss) for tiered restore
    uni_pers = ~(dp > 1) & (rl | (not inmemory_available))
    uni_bw = np.where(dp > 1, BW_DP_REPLICA,
                      np.where(uni_pers, BW_PERSISTENT, BW_INMEMORY))
    hier_bw = np.where(rl, BW_PERSISTENT, BW_INMEMORY)
    out[:, 3] = sb / np.where(
        is_uni, uni_bw,
        np.where(is_dyn | is_fft, BW_DP_REPLICA,
                 np.where(is_hier, hier_bw, BW_PERSISTENT)))
    # recompute: lost_work_seconds per tier, elementwise
    uni_rec = np.where(
        dp > 1, 0.5 * avg * (1.0 + 1.0 / np.maximum(dp - 1, 1)),
        np.where(uni_pers, 0.5 * CKPT_INTERVAL_S,
                 0.5 * avg * (INMEMORY_SNAPSHOT_ITERS + 1.0)))
    hier_rec = np.where(rl, 0.5 * CKPT_INTERVAL_S,
                        0.5 * avg * (INMEMORY_SNAPSHOT_ITERS + 1.0))
    out[:, 4] = np.where(
        is_uni, uni_rec,
        np.where(is_dyn, 60.0,
                 np.where(is_fft, 0.5 * avg,
                          np.where(is_hier, hier_rec,
                                   MEAN_RECOMPUTE_BASELINE_S))))
    # redundant continuation: every component is zero (the cost is the
    # engines' standing EFFICIENCY tax)
    out[is_red] = 0.0
    return out


def batch_total(costs: np.ndarray) -> np.ndarray:
    """Per-policy totals of an ``estimate_batch`` matrix, summed in the
    scalar ``TransitionCost.total`` component order (left to right) so
    the floats match the scalar property exactly."""
    total = costs[..., 0]
    for c in range(1, costs.shape[-1]):
        total = total + costs[..., c]
    return total


# ---------------------------------------------------------------------------
# Real state migration (examples / integration tests)
# ---------------------------------------------------------------------------


def migrate_state(manager: CheckpointManager, rank: int, like,
                  dp_peer_state=None, peer_step: Optional[int] = None
                  ) -> Tuple[object, int, str]:
    """Fetch recovery state through the hierarchy; returns
    (state, step, source), the state on ``like``'s devices."""
    return manager.restore(rank, like, dp_peer_state=dp_peer_state,
                           peer_step=peer_step)
