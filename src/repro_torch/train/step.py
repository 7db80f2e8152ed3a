"""Training steps (port of ``repro/train/step.py``).

Two execution paths with identical semantics (tested):

* **Fused** (``make_train_step``): one call loops over the micro-batches,
  accumulating fp32 gradients, then applies the optimizer.
* **Resumable** (``make_grad_fn`` + ``accumulate`` + ``finalize_step``):
  per-micro-batch gradient calls with an accumulator the caller owns.
  Unicron's micro-batch scheduler (``core/resumption.py``) drives this path
  so that a mid-iteration failure resumes from partial results (§6.2).

Both update the train state in place (see ``optim.adamw``).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.optim import AdamW, global_norm
from repro_torch.train.state import TrainState


def make_loss_fn(model, remat: bool = False):
    def loss_fn(params, batch):
        return model.loss(params, batch, remat=remat)
    return loss_fn


def make_grad_fn(model, remat: bool = False):
    """Per-micro-batch gradient: (params, micro_batch) -> (grads, metrics).

    Gradients are means over the micro-batch's tokens, so accumulation
    across micro-batches is a plain sum divided by the count (Eq. 6/7).  A
    leaf the loss never reads (an ``audio_stub`` model's ``embed``) gets a
    zero gradient of its own dtype, as JAX's ``grad`` gives it, so AdamW
    still decays it."""
    loss_fn = make_loss_fn(model, remat)

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree.leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree.unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return tree.unflatten(params, grads), metrics
    return grad_fn


@torch.no_grad()
def accumulate(acc, grads):
    """Add grads into the fp32 accumulator tree.  ``acc=None`` starts a
    new accumulator (a copy); otherwise ``acc`` is updated in place and
    returned."""
    if acc is None:
        return tree.tree_map(lambda g: g.to(torch.float32, copy=True), grads)
    for a, g in zip(tree.leaves(acc), tree.leaves(grads)):
        a.add_(g.float())
    return acc


@torch.no_grad()
def finalize_step(optimizer: AdamW, state: TrainState, grad_sum,
                  count: int) -> Tuple[TrainState, torch.Tensor]:
    """Apply the accumulated (summed) gradients of ``count`` micro-batches.
    Returns (state, grad_norm) with the norm taken before clipping."""
    cnt = torch.tensor(float(count), dtype=torch.float32)
    grads = tree.tree_map(lambda g: g / cnt, grad_sum)
    params, opt = optimizer.update(grads, state.opt, state.params)
    return TrainState(params, opt, state.step + 1), global_norm(grads)


def make_train_step(model, optimizer: AdamW, n_micro: int,
                    remat: bool = False) -> Callable:
    """Fused step.  ``batch`` is stacked: every leaf has leading dims
    (n_micro, micro_batch, ...) — see ``data.stack_microbatches``.  Returns
    (state, metrics) with metrics averaged over micro-batches."""
    grad_fn = make_grad_fn(model, remat)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        acc = tree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), state.params)
        per_mb = []
        for i in range(n_micro):
            grads, metrics = grad_fn(state.params,
                                     {k: v[i] for k, v in batch.items()})
            accumulate(acc, grads)
            del grads
            per_mb.append(metrics)
        with torch.no_grad():
            grads = tree.tree_map(lambda g: g / n_micro, acc)
            del acc
            params, opt = optimizer.update(grads, state.opt, state.params)
            out = {k: torch.stack([m[k] for m in per_mb]).mean()
                   for k in per_mb[0]}
            out["grad_norm"] = global_norm(grads)
        return TrainState(params, opt, state.step + 1), out

    return train_step
