"""Training (port of `cpd_tpu.train`): state, optimizers, loss scaling,
schedules, steps."""

from .optim import (LARS, SGD, AdamW, ClipByGlobalNorm, QuantSGD,
                    QuantSGDState, TorchSGDState, adamw, lars,
                    make_optimizer, quant_sgd, sgd)
from .scaling import (DynamicScaleState, current_scale, find_dynamic_scale,
                      with_dynamic_loss_scale)
from .schedules import warmup_cosine, warmup_step_decay
from .lm import lm_local_gradients, make_lm_eval_step, make_lm_train_step
from .state import TrainState, create_train_state
from .step import (as_batch, fp32_numerics, local_gradients, make_eval_step,
                   make_train_step)

__all__ = ["SGD", "TorchSGDState", "sgd", "LARS", "lars", "QuantSGD",
           "QuantSGDState", "quant_sgd", "AdamW", "adamw",
           "ClipByGlobalNorm", "make_optimizer",
           "with_dynamic_loss_scale", "DynamicScaleState",
           "find_dynamic_scale", "current_scale",
           "warmup_cosine", "warmup_step_decay",
           "TrainState", "create_train_state", "as_batch", "fp32_numerics",
           "local_gradients", "make_eval_step", "make_train_step",
           "lm_local_gradients", "make_lm_eval_step", "make_lm_train_step"]
