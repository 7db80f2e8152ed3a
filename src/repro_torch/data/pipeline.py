"""Deterministic synthetic data pipeline (port of
``repro/data/pipeline.py``).

Sequence ``i`` of step ``s`` is a pure function of ``(seed, s, i)``, so any
worker regenerates any micro-batch identically, the property Unicron's
micro-batch redistribution (§6.2) relies on.  Tokens are Zipf-distributed
over ``min(vocab, 4096)`` ranks, with every odd position set to the
previous token plus one (mod vocab), so the loss has structure to learn.
The reference draws with JAX's threefry; the port draws each sequence from
a CPU ``torch.Generator`` seeded from ``(seed, step, index)``, so the two
give different tokens under the same contract.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _zipf_probs(vocab: int) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64)
    return torch.softmax(-1.1 * torch.log(ranks), dim=0)


@dataclass(frozen=True)
class SyntheticLM:
    """Deterministic synthetic language-modeling data source."""

    cfg: ArchConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    device: str = "cuda"

    def _generator(self, step: int, index: int) -> torch.Generator:
        state = np.random.SeedSequence([self.seed, step, index])
        seed = int(state.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))
        return torch.Generator().manual_seed(seed)

    def tokens(self, step: int, index: int) -> torch.Tensor:
        """One sequence (1, seq_len) int32 for (step, index), on the CPU."""
        gen = self._generator(step, index)
        probs = _zipf_probs(min(self.cfg.vocab, 4096))
        toks = torch.multinomial(probs, self.seq_len, replacement=True,
                                 generator=gen)[None]
        shifted = torch.roll(toks, 1, dims=1)
        even = (torch.arange(self.seq_len) % 2 == 0)[None]
        return torch.where(even, toks,
                           (shifted + 1) % self.cfg.vocab).to(torch.int32)

    def batch(self, step: int, start: int = 0,
              n: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Slice [start, start+n) of the global batch at ``step``."""
        n = self.global_batch if n is None else n
        toks = torch.cat([self.tokens(step, i)
                          for i in range(start, start + n)], dim=0)
        return {"tokens": toks.to(self.device)}


def microbatches(batch: Dict[str, torch.Tensor], n_micro: int):
    """Split a batch dict into ``n_micro`` equal micro-batches (list)."""
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"micro-batches")
    mb = b // n_micro
    return [{k: a[i * mb:(i + 1) * mb] for k, a in batch.items()}
            for i in range(n_micro)]


def stack_microbatches(batch: Dict[str, torch.Tensor], n_micro: int):
    """Reshape a batch into (n_micro, micro_batch, ...) per leaf."""
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"micro-batches")
    mb = b // n_micro
    return {k: a.reshape((n_micro, mb) + tuple(a.shape[1:]))
            for k, a in batch.items()}
