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

The modality stubs add leaves of the reference's shapes and types: an
``audio_stub`` batch is ``frames`` (n, S, d_model) f32 standard normal,
``labels`` (the tokens mod vocab) and ``loss_mask`` (n, S) f32 (uniform <
0.35); a ``vision_stub`` batch adds ``prefix_embeds`` (n, n_prefix_embeds,
d_model) f32 standard normal to the tokens.  Every leaf of sequence ``i``
is drawn from ``(seed, step, i)`` and the leaf's own tag, so a slice of the
batch equals the same rows of the whole batch for every leaf.  (The
reference keys these three leaves by the slice's start instead, so its
slices differ from its whole batch there.)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


# the modality leaves' tags in a sequence's seed (the tokens have none)
_FRAMES, _MASK, _PREFIX = 1, 2, 3


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

    def _generator(self, step: int, index: int, *tag: int
                   ) -> torch.Generator:
        state = np.random.SeedSequence([self.seed, step, index, *tag])
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
        rows = range(start, start + n)
        cfg, S = self.cfg, self.seq_len
        toks = torch.cat([self.tokens(step, i) for i in rows], dim=0)
        if cfg.modality == "audio_stub":
            out = {"frames": torch.stack([torch.randn(
                       (S, cfg.d_model), generator=self._generator(
                           step, i, _FRAMES)) for i in rows]),
                   "labels": toks % cfg.vocab,
                   "loss_mask": torch.stack([(torch.rand(
                       S, generator=self._generator(step, i, _MASK)) < 0.35)
                       for i in rows]).float()}
        else:
            out = {"tokens": toks}
            if cfg.modality == "vision_stub":
                out["prefix_embeds"] = torch.stack([torch.randn(
                    (cfg.n_prefix_embeds, cfg.d_model),
                    generator=self._generator(step, i, _PREFIX))
                    for i in rows])
        return {k: v.to(self.device) for k, v in out.items()}


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
