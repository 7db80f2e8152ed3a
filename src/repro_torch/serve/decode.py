"""Serving: prefill + greedy autoregressive decode on top of
``model.decode_step`` (port of ``repro/serve/decode.py``).

``make_serve_step`` builds the one-token decode function: given the caches,
produce ONE new token per lane.  ``prefill`` and ``generate`` drive
decoding; the prompt is fed through decode steps, as the reference's
prefill does.  Greedy ``argmax`` takes the first maximum, as
``jnp.argmax`` does.

The reference compiles its decode step: ``prefill`` and ``generate`` are
``lax.scan``s and the continuous batcher runs ``jax.jit(model.decode_step)``.
The port's counterpart is ``GraphDecoder``: one CUDA graph of
``model.decode_step`` per batch shape, captured over caches that stay in
place, so a step costs its kernels' device time and not the host's time to
launch each of them.  ``prefill``, ``generate`` and ``RequestBatcher`` run
their steps through one, freed when the call returns.

Tensor-parallel decode over a mesh (``generate(..., groups=)``) runs
eagerly through ``ShardedDecoder``: its steps all-reduce over gloo or NCCL
groups, and ``GraphDecoder`` refuses groups rather than capture a gloo
collective, which a CUDA graph cannot hold.  The greedy token of a
vocab-split head is ``collectives.argmax_over_vocab``'s.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.kernels import build
from repro_torch.sharding import collectives, rules

# ``wrap(decoder, run)`` runs one step by calling ``run()`` and returns the
# logits it gave: a caller's hook to time or record every step that really
# ran, eager, captured or replayed.
StepWrap = Callable[["GraphDecoder", Callable[[], torch.Tensor]],
                    torch.Tensor]


class GraphDecoder:
    """Decode steps of ``model`` over ``caches`` (updated in place, never
    moved) through static buffers: the tokens (B,) int32 and positions (B,)
    int64 on the model's device, filled on the device before each step.
    Every cache leaf is (count, B, ...), whatever it holds: K/V buffers,
    MLA's latent ``ckv`` and ``k_rope`` buffers, or a Mamba2 state.

    On a CUDA device the first step runs ``model.decode_step`` eagerly on
    the real caches: the warm-up that loads every library and kernel, since
    nothing may be built inside a capture.  The second captures the step
    as a CUDA graph and replays it; every later one replays it.  A capture
    that fails raises: nothing on CUDA falls back to eager decoding.  The
    graph's output lives in its private pool and changes at each replay, so
    a step hands out a clone.  The kernels' launch counters count every
    replay (``build.capture_launches``).  On the CPU every step runs
    ``model.decode_step`` eagerly through the same buffers.

    ``close()`` (or leaving a ``with`` block) frees the graph and its pool.
    Given a mesh's ``groups`` it raises: the tensor-parallel step's
    collectives run through ``ShardedDecoder``, eagerly.
    """

    def __init__(self, model, params, caches, *,
                 wrap: Optional[StepWrap] = None, groups=None):
        if groups is not None:
            raise ValueError("GraphDecoder captures one process's step; "
                             "the tensor-parallel step runs eagerly "
                             "through ShardedDecoder")
        self.model, self.params, self.caches = model, params, caches
        batch = tree.leaves(caches)[0].shape[1]     # leaves: (count, B, ...)
        self.tokens = torch.zeros(batch, dtype=torch.int32,
                                  device=model.device)
        self.pos = torch.zeros(batch, dtype=torch.int64, device=model.device)
        self.wrap = wrap
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None    # the graph's logits
        self._launches: Optional[build.GraphLaunches] = None
        self.eager_steps = self.captures = self.replays = 0
        self.capture_seconds = 0.0                  # the last capture's
        self.last_step: Optional[str] = None        # eager|capture|replay

    def __enter__(self) -> "GraphDecoder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Frees the graph and its private memory pool."""
        self.graph = self._out = self._launches = None

    @torch.no_grad()
    def step(self, tokens: torch.Tensor, pos) -> torch.Tensor:
        """Feeds ``tokens`` (B,) at ``pos`` (an int for every lane, or a
        (B,) tensor) and returns the (B, vocab) float32 logits."""
        def run() -> torch.Tensor:
            self.tokens.copy_(tokens)
            if isinstance(pos, int):
                self.pos.fill_(pos)
            else:
                self.pos.copy_(pos)
            return self._run()
        return run() if self.wrap is None else self.wrap(self, run)

    def _run(self) -> torch.Tensor:
        if self.model.device.type != "cuda" or self.eager_steps == 0:
            self.eager_steps += 1
            self.last_step = "eager"
            logits, _ = self.model.decode_step(self.params, self.caches,
                                               self.tokens, self.pos)
            return logits
        self.last_step = "replay"
        if self.graph is None:
            self._capture()
            self.last_step = "capture"
        self.graph.replay()
        self._launches.replayed()
        self.replays += 1
        return self._out.clone()

    def _capture(self) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with build.capture_launches() as launches, torch.cuda.graph(graph):
            out, _ = self.model.decode_step(self.params, self.caches,
                                            self.tokens, self.pos)
        self.graph, self._out, self._launches = graph, out, launches
        self.captures += 1
        self.capture_seconds = time.perf_counter() - t0


class ShardedDecoder:
    """Decode steps of ``model`` tensor-parallel over a mesh's ``groups``
    (``collectives.MeshGroups``): ``params`` this rank's compute shards
    (``train.sharded.compute_params``), ``caches`` its ``init_cache(...,
    mesh=)`` shards (updated in place) and ``shards`` their
    ``cache_shards``.  Every step runs ``model.decode_step`` eagerly, on
    every device: a CUDA graph cannot capture its gloo collectives, so
    none is made.  ``step`` returns this rank's logits, its slice of the
    vocabulary where the head is vocab-split.  A shard whose spec names a
    mesh axis twice raises ``ValueError`` (``rules.check_spec``): no rank
    holds such a cache, as ``cache_shards`` refuses to make one."""

    def __init__(self, model, params, caches, shards, groups, *,
                 wrap: Optional[StepWrap] = None):
        for shard in tree.leaves(shards):
            rules.check_spec(shard.spec)
        self.model, self.params, self.caches = model, params, caches
        self.shards, self.groups, self.wrap = shards, groups, wrap
        self.eager_steps = 0
        self.last_step: Optional[str] = None

    @torch.no_grad()
    def step(self, tokens: torch.Tensor, pos) -> torch.Tensor:
        def run() -> torch.Tensor:
            self.eager_steps += 1
            self.last_step = "eager"
            logits, _ = self.model.decode_step(
                self.params, self.caches, tokens, pos, groups=self.groups,
                shards=self.shards)
            return logits
        return run() if self.wrap is None else self.wrap(self, run)


def greedy(model, logits: torch.Tensor, groups=None) -> torch.Tensor:
    """The greedy token (int32) of each row of ``logits``: the first
    maximum, over the whole vocabulary where a mesh's ``groups`` hold it
    split (``collectives.argmax_over_vocab``)."""
    if groups is not None and rules.vocab_splits(model.cfg, groups.n_model):
        return collectives.argmax_over_vocab(logits, groups).int()
    return torch.argmax(logits, dim=-1).int()


def make_serve_step(model, groups=None, shards=None):
    """serve_step(params, caches, tokens, pos) -> (next_tokens, caches).

    Greedy sampling; ``pos`` is the absolute position of ``tokens``.  With
    a mesh's ``groups`` (and the caches' ``shards``) the step is
    ``decode_step``'s tensor-parallel one and the token the first maximum
    over the whole vocabulary.
    """
    @torch.no_grad()
    def serve_step(params, caches, tokens, pos):
        logits, caches = model.decode_step(params, caches, tokens, pos,
                                           groups=groups, shards=shards)
        return greedy(model, logits, groups), caches
    return serve_step


def lanes_of(batch: int, groups) -> slice:
    """This rank's lanes of a batch of ``batch`` over ``groups``' data
    axes, as ``sharding.rules.batch_specs`` splits it: a 1 / n_data block
    where the batch divides and is more than one lane, else all."""
    n = groups.n_data
    if batch > 1 and batch % n == 0:
        rows = batch // n
        return slice(groups.data_rank * rows, (groups.data_rank + 1) * rows)
    return slice(0, batch)


def gather_lanes(t: torch.Tensor, batch: int, groups) -> torch.Tensor:
    """The rows of every data rank's ``t`` (its ``lanes_of`` rows on dim
    0), in order: gathered over the data axes, the innermost first."""
    mine = lanes_of(batch, groups)
    if mine.stop - mine.start == batch:
        return t
    for g in reversed(groups.data_groups):
        t = collectives.all_gather(t, g, dim=0)
    return t


def _feed(decoder: GraphDecoder, prompt: torch.Tensor, start_pos: int):
    logits = None
    for t in range(prompt.shape[1]):
        logits = decoder.step(prompt[:, t], start_pos + t)
    return logits


@torch.no_grad()
def prefill(model, params, caches, prompt: torch.Tensor, start_pos: int = 0):
    """Feed ``prompt`` (B, S) through decode steps.  Returns (caches,
    last_logits)."""
    with GraphDecoder(model, params, caches) as decoder:
        return caches, _feed(decoder, prompt, start_pos)


@torch.no_grad()
def generate(model, params, prompt: torch.Tensor, n_new: int,
             capacity: Optional[int] = None, cache_dtype=None, *,
             wrap: Optional[StepWrap] = None, groups=None,
             kv_model: bool = False, shard_seq: bool = False
             ) -> torch.Tensor:
    """Greedy generation: returns (B, n_new) new tokens (int32).  The
    prompt is prefilled even for ``n_new == 0``, which returns (B, 0), as
    the reference's scan over no steps does.  Every step, prefill
    included, goes through one ``GraphDecoder``; nothing reads a device
    value on the host until the tokens are returned.

    With a mesh's ``groups`` the decode is tensor-parallel and eager
    (``ShardedDecoder``): ``params`` are this rank's compute shards,
    ``prompt`` the whole batch, the same on every rank, of which the rank
    decodes its ``lanes_of``; the caches are its ``init_cache(...,
    mesh=, kv_model=, shard_seq=)`` shards.  Every rank returns the tokens
    of every lane.  ``shard_seq`` (long context) takes one lane, or a
    batch the data axes do not divide: else the lanes and the slots would
    both be split over the data axes, and ``init_cache`` raises
    ``ValueError`` naming the axis, as JAX refuses the reference's same
    spec."""
    B, S = prompt.shape
    cap = capacity or (S + n_new)
    if groups is not None:
        return _generate_sharded(model, params, prompt, n_new, cap,
                                 cache_dtype, wrap, groups, kv_model,
                                 shard_seq)
    caches = model.init_cache(B, cap, cache_dtype)
    with GraphDecoder(model, params, caches, wrap=wrap) as decoder:
        last_logits = _feed(decoder, prompt, 0)
        if n_new == 0:
            return torch.empty((B, 0), dtype=torch.int32,
                               device=prompt.device)
        tok = torch.argmax(last_logits, dim=-1).int()
        toks = []
        for i in range(n_new):
            toks.append(tok)
            tok = torch.argmax(decoder.step(tok, S + i), dim=-1).int()
    return torch.stack(toks, dim=1)


def _generate_sharded(model, params, prompt, n_new, cap, cache_dtype, wrap,
                      groups, kv_model, shard_seq) -> torch.Tensor:
    B, S = prompt.shape
    mine = prompt[lanes_of(B, groups)]
    kw = dict(mesh=groups.mesh, kv_model=kv_model, shard_seq=shard_seq)
    caches = model.init_cache(B, cap, cache_dtype, **kw)
    shards = model.cache_shards(B, cap, cache_dtype, **kw)
    decoder = ShardedDecoder(model, params, caches, shards, groups,
                             wrap=wrap)
    last_logits = _feed(decoder, mine, 0)
    toks = []
    tok = greedy(model, last_logits, groups)
    for i in range(n_new):
        toks.append(tok)
        tok = greedy(model, decoder.step(tok, S + i), groups)
    out = torch.stack(toks, dim=1) if toks else \
        torch.empty((mine.shape[0], 0), dtype=torch.int32,
                    device=prompt.device)
    return gather_lanes(out, B, groups)


class RequestBatcher:
    """Minimal static-batch server: pads requests to a fixed batch and
    decodes them together (the serving example's front-end)."""

    def __init__(self, model, params, batch_size: int, capacity: int, *,
                 wrap: Optional[StepWrap] = None):
        self.model = model
        self.params = params
        self.batch_size = batch_size
        self.capacity = capacity
        self.wrap = wrap

    def serve(self, prompts, n_new: int):
        """prompts: 1-D int tensors (same length for simplicity)."""
        assert len(prompts) <= self.batch_size
        S = len(prompts[0])
        pad = self.batch_size - len(prompts)
        dev = self.model.device
        batch = torch.stack([torch.as_tensor(p, device=dev).int()
                             for p in prompts]
                            + [torch.zeros(S, dtype=torch.int32,
                                           device=dev)] * pad)
        out = generate(self.model, self.params, batch, n_new,
                       capacity=self.capacity, wrap=self.wrap)
        return [out[i] for i in range(len(prompts))]
