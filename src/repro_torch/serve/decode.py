"""Serving: prefill + greedy autoregressive decode on top of
``model.decode_step`` (port of ``repro/serve/decode.py``).

``make_serve_step`` builds the one-token decode function: given the caches,
produce ONE new token per lane.  ``prefill`` and ``generate`` drive
decoding.  The reference's ``lax.scan`` over positions is a Python loop of
eager steps under ``torch.no_grad()``; the prompt is fed through decode
steps, as the reference's prefill does.  Greedy ``argmax`` takes the first
maximum, as ``jnp.argmax`` does.
"""
from __future__ import annotations

from typing import Optional

import torch


def make_serve_step(model):
    """serve_step(params, caches, tokens, pos) -> (next_tokens, caches).

    Greedy sampling; ``pos`` is the absolute position of ``tokens``.
    """
    @torch.no_grad()
    def serve_step(params, caches, tokens, pos):
        logits, caches = model.decode_step(params, caches, tokens, pos)
        return torch.argmax(logits, dim=-1).int(), caches
    return serve_step


@torch.no_grad()
def prefill(model, params, caches, prompt: torch.Tensor, start_pos: int = 0):
    """Feed ``prompt`` (B, S) through decode steps.  Returns (caches,
    last_logits)."""
    logits = None
    for t in range(prompt.shape[1]):
        logits, caches = model.decode_step(params, caches, prompt[:, t],
                                           start_pos + t)
    return caches, logits


@torch.no_grad()
def generate(model, params, prompt: torch.Tensor, n_new: int,
             capacity: Optional[int] = None,
             cache_dtype=None) -> torch.Tensor:
    """Greedy generation: returns (B, n_new) new tokens (int32).  The
    prompt is prefilled even for ``n_new == 0``, which returns (B, 0), as
    the reference's scan over no steps does."""
    B, S = prompt.shape
    cap = capacity or (S + n_new)
    caches = model.init_cache(B, cap, cache_dtype)
    caches, last_logits = prefill(model, params, caches, prompt)
    if n_new == 0:
        return torch.empty((B, 0), dtype=torch.int32, device=prompt.device)
    tok = torch.argmax(last_logits, dim=-1).int()
    toks = []
    for i in range(n_new):
        toks.append(tok)
        logits, caches = model.decode_step(params, caches, tok, S + i)
        tok = torch.argmax(logits, dim=-1).int()
    return torch.stack(toks, dim=1)


class RequestBatcher:
    """Minimal static-batch server: pads requests to a fixed batch and
    decodes them together (the serving example's front-end)."""

    def __init__(self, model, params, batch_size: int, capacity: int):
        self.model = model
        self.params = params
        self.batch_size = batch_size
        self.capacity = capacity

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
                       capacity=self.capacity)
        return [out[i] for i in range(len(prompts))]
