"""Training (port of `cpd_tpu.train`): state, SGD, schedule, steps."""

from .optim import SGD, TorchSGDState, sgd
from .schedules import warmup_cosine, warmup_step_decay
from .lm import lm_local_gradients, make_lm_eval_step, make_lm_train_step
from .state import TrainState, create_train_state
from .step import (as_batch, fp32_numerics, local_gradients, make_eval_step,
                   make_train_step)

__all__ = ["SGD", "TorchSGDState", "sgd", "warmup_cosine", "warmup_step_decay",
           "TrainState", "create_train_state", "as_batch", "fp32_numerics",
           "local_gradients", "make_eval_step", "make_train_step",
           "lm_local_gradients", "make_lm_eval_step", "make_lm_train_step"]
