"""TrainState (port of `cpd_tpu/train/state.py`): everything a training
run mutates.  The module holds the fp32 master weights (``params``) and
the BN running stats (``batch_stats``); the optimizer state and the step
counter ride beside it.  The step updates all of them in place."""

from __future__ import annotations

import dataclasses
from typing import Any

from torch import nn

__all__ = ["TrainState", "create_train_state", "reject_norm_based"]


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


def reject_norm_based(opt, where: str) -> None:
    """Refuse an optimizer whose update needs global norms (``norm_based``:
    LARS trust ratios, global-norm clipping) in a step whose update is
    shard-local (the JAX package's guard, `cpd_tpu/train/state.py`)."""
    if getattr(opt, "norm_based", False):
        raise ValueError(
            f"norm-based gradient transforms (LARS trust ratios, "
            f"clip_norm global-norm clipping) are not supported by the "
            f"{where}: they need GLOBAL norms but the update is "
            f"shard-local. Use an elementwise optimizer (sgd/nesterov/"
            f"adamw) without clip_norm here.")
