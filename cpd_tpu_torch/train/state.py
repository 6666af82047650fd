"""TrainState (port of `cpd_tpu/train/state.py`): everything a training
run mutates.  The module holds the fp32 master weights (``params``) and
the BN running stats (``batch_stats``); the optimizer state and the step
counter ride beside it.  The step updates all of them in place."""

from __future__ import annotations

import dataclasses
from typing import Any

from torch import nn

__all__ = ["TrainState", "create_train_state"]


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: Any

    @property
    def params(self) -> list:
        return list(self.model.parameters())

    @property
    def batch_stats(self) -> list:
        return list(self.model.buffers())


def create_train_state(model: nn.Module, opt) -> TrainState:
    """Step 0, the model's current weights, a fresh optimizer state."""
    return TrainState(step=0, model=model,
                      opt_state=opt.init(list(model.parameters())))
