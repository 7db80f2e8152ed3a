"""Train state container (port of ``repro/train/state.py``)."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree
from repro_torch.optim import AdamW, AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: torch.Tensor         # () int32 on the CPU: completed optimizer steps


def init_train_state(model, optimizer: AdamW, seed: int = 0) -> TrainState:
    params = model.init(seed)
    return TrainState(params=params, opt=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32))


def abstract_train_state(model, optimizer: AdamW) -> TrainState:
    """The train state of ``model``'s config on the ``meta`` device: every
    leaf's shape and dtype, nothing allocated (the port of the reference's
    ``jax.eval_shape`` of ``init_train_state``)."""
    from repro_torch.models.model import build_model
    return init_train_state(build_model(model.cfg, "meta"), optimizer)


def clone_state(state: TrainState) -> TrainState:
    """A copy that the in-place optimizer update does not touch."""
    return tree.tree_map(lambda t: t.clone(), state)
