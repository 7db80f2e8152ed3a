"""The token batches, made by the benchmark itself: a frozen copy of the
contract of ``repro_torch/data/pipeline.py``'s ``SyntheticLM`` (sequence i
of step s a pure function of (seed, s, i): Zipf-distributed over
min(vocab, 4096) ranks, each odd position the previous token plus one).
The reference trains on these; the program's window draws its own through
its data layer, so a pipeline that drifts from the contract shows as a
loss that the reference does not reproduce."""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=4)
def _zipf(n: int) -> torch.Tensor:
    ranks = torch.arange(1, n + 1, dtype=torch.float64)
    return torch.softmax(-1.1 * torch.log(ranks), dim=0)


def sequence(seed: int, step: int, index: int, seq_len: int,
             vocab: int) -> torch.Tensor:
    """(seq_len,) int64 on the CPU."""
    state = np.random.SeedSequence([seed, step, index])
    s = int(state.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))
    gen = torch.Generator().manual_seed(s)
    toks = torch.multinomial(_zipf(min(vocab, 4096)), seq_len,
                             replacement=True, generator=gen)
    even = torch.arange(seq_len) % 2 == 0
    return torch.where(even, toks, (torch.roll(toks, 1) + 1) % vocab)


def batch(seed: int, step: int, start: int, n: int, seq_len: int,
          vocab: int) -> torch.Tensor:
    """Rows [start, start + n) of step ``step``'s batch: (n, seq_len)."""
    return torch.stack([sequence(seed, step, i, seq_len, vocab)
                        for i in range(start, start + n)])
