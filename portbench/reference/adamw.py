"""AdamW in float32: a frozen copy of ``repro_torch/optim/adamw.py``'s
arithmetic (global-norm clip, bias correction at the incremented step,
weight decay on every leaf)."""
from __future__ import annotations

from typing import Dict

import torch


def init(params: Dict[str, torch.Tensor]):
    return ({k: torch.zeros_like(v) for k, v in params.items()},
            {k: torch.zeros_like(v) for k, v in params.items()})


@torch.no_grad()
def step(params: Dict, grads: Dict, mu: Dict, nu: Dict, t: int,
         hp: dict) -> torch.Tensor:
    """Update ``params``, ``mu`` and ``nu`` in place for step ``t`` (1 on
    the first call); returns the gradients' global norm before the
    clip."""
    gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = torch.clamp(hp["grad_clip"] / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1, b2 = hp["b1"], hp["b2"]
    b1c, b2c = 1.0 - b1 ** t, 1.0 - b2 ** t
    for k, p in params.items():
        g = grads[k] * scale
        mu[k].mul_(b1).add_((1 - b1) * g)
        nu[k].mul_(b2).add_((1 - b2) * g * g)
        upd = (mu[k] / b1c) / (torch.sqrt(nu[k] / b2c) + hp["eps"]) \
            + hp["weight_decay"] * p
        p.sub_(hp["lr"] * upd)
    return gnorm
