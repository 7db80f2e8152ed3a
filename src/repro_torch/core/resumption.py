"""Resuming from a failed iteration (§6.2) — exact-semantics recovery
(port of ``repro/core/resumption.py``).

A global batch of micro-batches is partitioned over DP ranks.  Gradients
accumulate per rank until the end-of-iteration all-reduce (Eq. 6).  On a
rank failure:

* **Scenario #1** (before the all-reduce): the failed rank's accumulator
  is lost; its micro-batches are redistributed round-robin to the
  survivors, which recompute them into their own accumulators (Eq. 7).
* **Scenario #2** (all-reduce already started): buckets reduced before the
  failure keep the full sum; only the unreduced buckets take the survivors'
  sums plus the recomputation.

Micro-batches are deterministic functions of (step, index), so the
recovered gradient equals the fault-free one up to f32 summation order.
All DP ranks are simulated in one process, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch import tree
from repro_torch.train.step import accumulate


@dataclass
class MicroBatchIteration:
    """Ownership and progress of the micro-batches of ONE global-batch
    iteration across DP ranks."""

    n_ranks: int
    n_micro: int
    owners: Dict[int, List[int]] = field(default_factory=dict)
    done: Dict[int, List[int]] = field(default_factory=dict)
    failed_ranks: List[int] = field(default_factory=list)

    def __post_init__(self):
        if not self.owners:
            k, r = divmod(self.n_micro, self.n_ranks)
            idx = 0
            for rank in range(self.n_ranks):
                take = k + (1 if rank < r else 0)
                self.owners[rank] = list(range(idx, idx + take))
                idx += take
        for rank in range(self.n_ranks):
            self.done.setdefault(rank, [])

    def live_ranks(self) -> List[int]:
        return [r for r in range(self.n_ranks) if r not in self.failed_ranks]

    def complete(self, rank: int, mb: int) -> None:
        if mb not in self.owners[rank]:
            raise ValueError(f"rank {rank} does not own micro-batch {mb}")
        self.done[rank].append(mb)

    def pending(self, rank: int) -> List[int]:
        return [m for m in self.owners[rank] if m not in self.done[rank]]

    def fail_rank(self, rank: int) -> List[int]:
        """Mark ``rank`` failed and redistribute ALL of its micro-batches
        round-robin to the survivors (Eq. 7).  Returns their ids."""
        if rank in self.failed_ranks:
            raise ValueError(f"rank {rank} already failed")
        self.failed_ranks.append(rank)
        orphans = list(self.owners[rank])
        self.owners[rank] = []
        self.done[rank] = []
        live = self.live_ranks()
        if not live:
            raise RuntimeError("all DP ranks failed; checkpoint restore "
                               "required")
        for i, mb in enumerate(orphans):
            self.owners[live[i % len(live)]].append(mb)
        return orphans

    def all_done(self) -> bool:
        return all(set(self.done[r]) == set(self.owners[r])
                   for r in self.live_ranks())


def run_iteration_with_failure(grad_fn: Callable, params,
                               microbatch_of: Callable[[int], dict],
                               n_ranks: int, n_micro: int,
                               fail_rank: Optional[int] = None,
                               fail_after_mb: int = 0):
    """One gradient-accumulation iteration with an optional DP-rank
    failure after the failed rank completed ``fail_after_mb``
    micro-batches.  Returns (grad_sum, n_micro) for
    ``train.finalize_step``."""
    it = MicroBatchIteration(n_ranks=n_ranks, n_micro=n_micro)
    acc: Dict[int, Optional[dict]] = {r: None for r in range(n_ranks)}

    # 1) the failing rank runs until the failure point
    if fail_rank is not None:
        for mb in it.owners[fail_rank][:fail_after_mb]:
            g, _ = grad_fn(params, microbatch_of(mb))
            acc[fail_rank] = accumulate(acc[fail_rank], g)
            it.complete(fail_rank, mb)
        # 2) failure: redistribute (Eq. 7); the accumulator is lost
        it.fail_rank(fail_rank)
        acc[fail_rank] = None

    # 3) survivors finish their (possibly grown) assignments
    for rank in it.live_ranks():
        for mb in it.pending(rank):
            g, _ = grad_fn(params, microbatch_of(mb))
            acc[rank] = accumulate(acc[rank], g)
            it.complete(rank, mb)
    if not it.all_done():
        raise RuntimeError("micro-batches left undone after redistribution")

    # 4) all-reduce over live ranks; the first accumulator is reused as the
    # sum (it is not read again)
    total = None
    for rank in it.live_ranks():
        if acc[rank] is None:
            continue
        total = acc[rank] if total is None else accumulate(total, acc[rank])
        acc[rank] = None
    return total, n_micro


def bucket_masks(params, n_buckets: int) -> List[List[bool]]:
    """Split the flattened param leaves (JAX leaf order) into ``n_buckets``
    contiguous buckets (layer segments in Megatron terms)."""
    n = len(tree.leaves(params))
    per = -(-n // n_buckets)
    return [[per * b <= i < per * (b + 1) for i in range(n)]
            for b in range(n_buckets)]


def merge_partial_reduce(like, reduced_full: List, survivor_sum: List,
                         recomputed: List, reduced_mask: Sequence[bool]):
    """Per leaf: already-reduced buckets keep the full sum (it includes the
    failed rank); unreduced buckets take the survivors' sums plus the
    recomputation.  List args are leaf lists; the result has ``like``'s
    structure."""
    out = [reduced_full[i] if is_reduced else survivor_sum[i] + recomputed[i]
           for i, is_reduced in enumerate(reduced_mask)]
    return tree.unflatten(like, out)


def run_scenario2(grad_fn: Callable, params,
                  microbatch_of: Callable[[int], dict],
                  n_ranks: int, n_micro: int, fail_rank: int,
                  n_buckets: int, buckets_reduced: int):
    """Failure after ``buckets_reduced`` of ``n_buckets`` gradient buckets
    were already all-reduced.  Returns (grad_sum, n_micro)."""
    it = MicroBatchIteration(n_ranks=n_ranks, n_micro=n_micro)
    acc: Dict[int, Optional[dict]] = {r: None for r in range(n_ranks)}
    for rank in range(n_ranks):
        for mb in it.owners[rank]:
            g, _ = grad_fn(params, microbatch_of(mb))
            acc[rank] = accumulate(acc[rank], g)
            it.complete(rank, mb)

    masks = bucket_masks(params, n_buckets)
    n_leaves = len(masks[0])
    reduced_mask = [any(masks[b][i] for b in range(buckets_reduced))
                    for i in range(n_leaves)]

    full_sum = None
    for rank in range(n_ranks):
        full_sum = accumulate(full_sum, acc[rank])
    if buckets_reduced >= n_buckets:
        # the failed worker's gradients are fully reduced: proceed
        return full_sum, n_micro

    survivor_sum = None
    for rank in range(n_ranks):
        if rank != fail_rank:
            survivor_sum = accumulate(survivor_sum, acc[rank])
    recomputed = None
    for mb in it.owners[fail_rank]:
        g, _ = grad_fn(params, microbatch_of(mb))
        recomputed = accumulate(recomputed, g)
    merged = merge_partial_reduce(
        params, tree.leaves(full_sum), tree.leaves(survivor_sum),
        tree.leaves(recomputed), reduced_mask)
    return merged, n_micro
