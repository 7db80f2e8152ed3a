"""Continuous-batching request scheduler over the decode path (port of
``repro/serve/scheduler.py``).

A fixed pool of batch lanes, each holding one request's progress against
the shared KV/state cache.  Every tick is ONE ``decode_step`` in which each
lane consumes its own next token at its own position: prompt tokens while
prefilling, generated tokens afterwards.  New requests join free lanes
between ticks; finished requests free their lane at once, so no request
waits for the longest one in the batch.

Every step runs through one ``GraphDecoder`` over the batcher's caches,
which never move: on the card the step is one CUDA graph replay, the
counterpart of the reference's ``jax.jit(model.decode_step)``.  The lane
reset zeroes the same cache tensors in place, outside the graph, and the
lanes' tokens and positions are copied into the decoder's buffers.  As
in the reference, each step reads the argmax back to the host once.

The scheduler tolerates lane-level failure: a poisoned request is evicted
and its lane recycled without touching the other lanes.  Lane outcomes are
counted (``slo_stats``) and feed the planner's serving objective:
``waf.ServingSLO.calibrated`` derates per-worker capacity by the observed
lane-failure fraction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch

from repro_torch.serve.decode import GraphDecoder, StepWrap


@dataclass
class Request:
    req_id: int
    prompt: torch.Tensor                # (S,) int, on the CPU
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False
    eos: Optional[int] = None


@dataclass
class _Lane:
    req: Optional[Request] = None
    pos: int = 0                        # position of the NEXT token to feed
    pending: int = 0                    # that token's id

    @property
    def free(self) -> bool:
        return self.req is None


class ContinuousBatcher:
    """Schedules requests over ``batch_size`` decode lanes."""

    def __init__(self, model, params, batch_size: int, capacity: int, *,
                 wrap: Optional[StepWrap] = None):
        self.model = model
        self.params = params
        self.batch_size = batch_size
        self.capacity = capacity
        self.lanes = [_Lane() for _ in range(batch_size)]
        self.caches = model.init_cache(batch_size, capacity)
        self.decoder = GraphDecoder(model, params, self.caches, wrap=wrap)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.steps = 0
        self.lane_failures = 0          # evicted (poisoned) requests
        self.completed = 0              # naturally finished requests

    # ---- client API --------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def run(self, max_steps: int = 100_000) -> List[Request]:
        while (self.queue or any(not ln.free for ln in self.lanes)) \
                and self.steps < max_steps:
            self.step()
        return self.finished

    def close(self) -> None:
        """Frees the decoder's CUDA graph and its memory pool (a later step
        captures again)."""
        self.decoder.close()

    # ---- scheduler core ----------------------------------------------------

    def _admit(self) -> None:
        for i, lane in enumerate(self.lanes):
            if not lane.free or not self.queue:
                continue
            req = self.queue.pop(0)
            self._reset_lane(i)
            lane.req = req
            lane.pos = 0
            lane.pending = int(req.prompt[0])

    def _reset_lane(self, i: int) -> None:
        """Zero lane i of every cache leaf (K/V, MLA's latent ``ckv`` and
        ``k_rope``, or a Mamba2 state).  Every leaf is (count, batch, ...),
        so the lane is axis 1.  (The reference picks the first axis
        whose size equals the batch size, which is the layer axis when a
        segment stacks as many layers as there are lanes.)"""
        for entry in self.caches:
            for leaves in entry["slots"] + [entry.get("shared", {})]:
                for leaf in leaves.values():
                    leaf[:, i].zero_()

    @torch.no_grad()
    def step(self) -> None:
        self._admit()
        if all(ln.free for ln in self.lanes):
            return
        toks = torch.tensor([ln.pending for ln in self.lanes],
                            dtype=torch.int32)
        poss = torch.tensor([ln.pos for ln in self.lanes], dtype=torch.int64)
        logits = self.decoder.step(toks, poss)
        nxt = torch.argmax(logits, dim=-1).tolist()       # the one sync
        for i, lane in enumerate(self.lanes):
            if lane.free:
                continue
            req = lane.req
            fed = lane.pos
            lane.pos += 1
            if fed < len(req.prompt) - 1:
                lane.pending = int(req.prompt[fed + 1])   # still prefilling
                continue
            tok = nxt[i]                                  # generated token
            req.out.append(tok)
            lane.pending = tok
            if len(req.out) >= req.max_new \
                    or (req.eos is not None and tok == req.eos) \
                    or lane.pos >= self.capacity - 1:
                req.done = True
                self.finished.append(req)
                self.completed += 1
                lane.req = None
        self.steps += 1

    # ---- failure handling --------------------------------------------------

    def evict(self, req_id: int) -> bool:
        """Lane-level recovery: drop a poisoned request, recycle the lane;
        other lanes are untouched.  Counts toward ``lane_failures`` in
        :meth:`slo_stats`."""
        for lane in self.lanes:
            if lane.req is not None and lane.req.req_id == req_id:
                lane.req.done = True
                self.finished.append(lane.req)
                lane.req = None
                self.lane_failures += 1
                return True
        return False

    def slo_stats(self) -> dict:
        """Lane-outcome counters for objective calibration, the dict
        ``waf.ServingSLO.calibrated`` consumes.  ``lane_failures`` are
        evictions (poisoned/failed requests), ``completed`` natural
        finishes; the remaining keys are load diagnostics."""
        return {
            "lane_failures": self.lane_failures,
            "completed": self.completed,
            "steps": self.steps,
            "queue_depth": len(self.queue),
            "in_flight": sum(not ln.free for ln in self.lanes),
        }
