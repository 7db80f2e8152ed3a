"""Hierarchical checkpoint manager — the nearest principle (§6.3), port of
``repro/checkpoint/manager.py``.

Recovery preference: a healthy DP replica, then the in-memory tier (local
or ring neighbor), then the persistent tier.  ``restore`` returns
(state, step, source).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch import tree
from repro_torch.checkpoint import inmemory, persistent


class CheckpointManager:
    def __init__(self, directory: str, n_ranks: int,
                 persist_every: int = 10, *, task: str):
        self.directory = directory
        self.store = inmemory.InMemoryStore(n_ranks)
        self.persist_every = persist_every
        self.task = task

    def save(self, rank: int, step: int, state: Any) -> None:
        """In-memory snapshot every call; persistent save every
        ``persist_every`` steps (synchronous here)."""
        self.store.put(self.task, rank, step, state)
        if step % self.persist_every == 0:
            persistent.save(self.directory, step, state)

    def restore(self, rank: int, like: Any,
                dp_peer_state: Optional[Any] = None,
                peer_step: Optional[int] = None) -> Tuple[Any, int, str]:
        """Returns (state, step, source), the state on ``like``'s devices.
        ``dp_peer_state`` is the live state of a healthy DP replica, if
        one exists."""
        if dp_peer_state is not None:
            return dp_peer_state, int(peer_step or 0), "dp_replica"
        hit = self.store.get(self.task, rank)
        if hit is not None:
            step, snap, src = hit
            return tree.tree_map(lambda s, l: s.to(l.device, copy=True),
                                 snap, like), step, src
        step = persistent.latest_step(self.directory)
        if step is not None:
            return persistent.restore(self.directory, like, step), step, \
                "persistent"
        raise FileNotFoundError("no recovery source available")

    def drop_rank(self, rank: int) -> None:
        self.store.drop_rank(self.task, rank)
