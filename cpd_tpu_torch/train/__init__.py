"""Training (port of `cpd_tpu.train`): state, SGD, schedule, steps."""

from .optim import SGD, TorchSGDState, sgd
from .schedules import warmup_step_decay
from .state import TrainState, create_train_state
from .step import (as_batch, fp32_numerics, local_gradients, make_eval_step,
                   make_train_step)

__all__ = ["SGD", "TorchSGDState", "sgd", "warmup_step_decay",
           "TrainState", "create_train_state", "as_batch", "fp32_numerics",
           "local_gradients", "make_eval_step", "make_train_step"]
