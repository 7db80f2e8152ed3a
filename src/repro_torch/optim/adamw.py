"""AdamW with fp32 master weights for low-precision params (port of
``repro/optim/adamw.py``).

Per parameter: fp32 first/second moments, plus an fp32 master copy when
the parameter is not fp32.  The arithmetic is the reference's: global-norm
clip, bias correction at the incremented step in f32, weight decay on every
leaf.

Unlike the reference, ``update`` works in place: it overwrites the
moments, the master copy and the params of the state it is given and
returns those same tensors, so a step needs no second copy of the
optimizer state (at gemma-2b's width that copy is ~13 GB).  A caller that
needs the old state keeps a clone (``train.state.clone_state``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree


class AdamWState(NamedTuple):
    step: torch.Tensor           # () int32, on the CPU
    mu: Any                      # fp32 tree
    nu: Any                      # fp32 tree
    master: Any                  # fp32 tree or None (params already fp32)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@dataclass(frozen=True)
class AdamW:
    lr: Callable                 # step -> lr  (or float)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def _lr(self, step):
        return _f32(self.lr(step) if callable(self.lr) else self.lr)

    def init(self, params) -> AdamWState:
        def zeros():
            return tree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
        needs_master = any(p.dtype != torch.float32
                           for p in tree.leaves(params))
        master = (tree.tree_map(lambda p: p.float().clone(), params)
                  if needs_master else None)
        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          mu=zeros(), nu=zeros(), master=master)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, gnorm=None):
        """Returns (new_params, new_state), updated in place (see module
        docstring).  Grads may be any float dtype; they are not modified.
        ``gnorm``: the clip's global norm where ``grads`` are shards of a
        larger tree (``train.sharded``); else it is ``grads``' own."""
        g_leaves = [g.float() for g in tree.leaves(grads)]
        if self.grad_clip and self.grad_clip > 0:
            if gnorm is None:
                gnorm = global_norm(g_leaves)
            scale = torch.clamp(self.grad_clip /
                                torch.clamp(gnorm, min=1e-12), max=1.0)
        else:
            scale = None
        step = state.step + 1
        stepf = step.float()
        b1c = 1.0 - torch.pow(_f32(self.b1), stepf)
        b2c = 1.0 - torch.pow(_f32(self.b2), stepf)
        lr = self._lr(step)
        p_leaves = tree.leaves(params)
        ref_leaves = tree.leaves(state.master) if state.master is not None \
            else p_leaves
        for g, m, v, r, p in zip(g_leaves, tree.leaves(state.mu),
                                 tree.leaves(state.nu), ref_leaves,
                                 p_leaves):
            if scale is not None:
                g = g * scale.to(g.device)
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            p32 = r.float()
            upd = (m / b1c) / (torch.sqrt(v / b2c) + self.eps) \
                + self.weight_decay * p32
            new = p32 - lr * upd
            r.copy_(new)
            if r is not p:
                p.copy_(new)
        return params, AdamWState(step, state.mu, state.nu, state.master)


def global_norm(tree_or_leaves) -> torch.Tensor:
    leaves = tree.leaves(tree_or_leaves)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        total = total + x.float().square().sum()
    return torch.sqrt(total)
