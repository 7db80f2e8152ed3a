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


def clone_state(state: TrainState) -> TrainState:
    """A copy that the in-place optimizer update does not touch."""
    return tree.tree_map(lambda t: t.clone(), state)
