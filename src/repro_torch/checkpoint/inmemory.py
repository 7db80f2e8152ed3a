"""GEMINI-style in-memory checkpointing (port of
``repro/checkpoint/inmemory.py``).

Each agent keeps the latest training-state snapshot in host RAM (CPU
tensors) and replicates it to a ring neighbor, so a node's state survives
in the neighbor's RAM when the node fails.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch import tree


def _snapshot(state: Any) -> Any:
    """Copy a tree of tensors to host memory."""
    return tree.tree_map(lambda t: t.detach().to("cpu", copy=True), state)


class InMemoryStore:
    """Ring-replicated host-RAM checkpoint store, keyed by (task, rank).
    ``get`` prefers the local copy, then the neighbor's replica."""

    def __init__(self, n_ranks: int):
        self.n_ranks = n_ranks
        self._local: Dict[Tuple[str, int], Tuple[int, Any]] = {}
        self._replica: Dict[Tuple[str, int], Tuple[int, Any]] = {}

    def neighbor(self, rank: int) -> int:
        return (rank + 1) % self.n_ranks

    def put(self, task: str, rank: int, step: int, state: Any) -> None:
        snap = _snapshot(state)
        self._local[(task, rank)] = (step, snap)
        self._replica[(task, self.neighbor(rank))] = (step, snap)

    def drop_rank(self, task: str, rank: int) -> None:
        """Simulate host loss: the local copy and any replica held on the
        failed host vanish."""
        self._local.pop((task, rank), None)
        self._replica.pop((task, rank), None)

    def get(self, task: str, rank: int) -> Optional[Tuple[int, Any, str]]:
        """Returns (step, snapshot, source) or None."""
        if (task, rank) in self._local:
            s, t = self._local[(task, rank)]
            return s, t, "inmemory_local"
        if (task, self.neighbor(rank)) in self._replica:
            s, t = self._replica[(task, self.neighbor(rank))]
            return s, t, "inmemory_replica"
        return None
