"""Cluster state: nodes, GPU workers, task placements.  Copied from
``repro/core/cluster.py``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class Node:
    node_id: int
    n_gpus: int = 8
    healthy: bool = True
    repair_done_at: Optional[float] = None   # when a failed node returns


class Cluster:
    def __init__(self, n_nodes: int = 16, gpus_per_node: int = 8):
        self.nodes: List[Node] = [Node(i, gpus_per_node)
                                  for i in range(n_nodes)]
        self.gpus_per_node = gpus_per_node
        # placement: task index per node (None = free pool)
        self.placement: Dict[int, Optional[int]] = {
            i: None for i in range(n_nodes)}
        # index of drained node ids, maintained by fail/recover so the
        # control loop's repair sweep and capacity reads are O(#unhealthy)
        # instead of O(#nodes) per tick at fleet scale
        self._unhealthy: set = set()
        self._total_gpus = sum(n.n_gpus for n in self.nodes)

    # ---- capacity ----------------------------------------------------------

    def healthy_nodes(self) -> List[Node]:
        return [n for n in self.nodes if n.healthy]

    def healthy_workers(self) -> int:
        return self._total_gpus - sum(self.nodes[i].n_gpus
                                      for i in self._unhealthy)

    def free_healthy_nodes(self) -> List[Node]:
        return [n for n in self.healthy_nodes()
                if self.placement[n.node_id] is None]

    # ---- failures / recovery ----------------------------------------------

    def fail_node(self, node_id: int, repair_done_at: float) -> Optional[int]:
        """Drain a node; returns the task index that owned it (if any)."""
        node = self.nodes[node_id]
        node.healthy = False
        node.repair_done_at = repair_done_at
        self._unhealthy.add(node_id)
        owner = self.placement[node_id]
        self.placement[node_id] = None
        return owner

    def recover_node(self, node_id: int) -> None:
        node = self.nodes[node_id]
        node.healthy = True
        node.repair_done_at = None
        self._unhealthy.discard(node_id)

    def repair_due(self, now: float) -> List[Node]:
        """Drained nodes whose repair has completed, id order — the
        control loop's rejoin sweep, O(#unhealthy) not O(#nodes)."""
        out = []
        for nid in sorted(self._unhealthy):
            n = self.nodes[nid]
            if not n.healthy and n.repair_done_at is not None \
                    and n.repair_done_at <= now:
                out.append(n)
        return out

    # ---- placement ---------------------------------------------------------

    def nodes_of(self, task: int) -> List[int]:
        return [nid for nid, t in self.placement.items() if t == task]

    def workers_of(self, task: int) -> int:
        return len(self.nodes_of(task)) * self.gpus_per_node

    def assign(self, assignment: List[int]) -> None:
        """Re-place tasks onto healthy nodes for a worker assignment
        (multiples of gpus_per_node; remainders are rounded down —
        GPU-granular placement inside a node is handled by the task's own
        parallelism config)."""
        for nid in self.placement:
            self.placement[nid] = None
        free = [n.node_id for n in self.healthy_nodes()]
        for ti, workers in enumerate(assignment):
            need = workers // self.gpus_per_node
            for _ in range(need):
                if not free:
                    break
                self.placement[free.pop(0)] = ti
