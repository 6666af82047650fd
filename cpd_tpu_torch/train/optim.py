"""SGD with torch.optim.SGD semantics on fp32 master weights (port of
`sgd` from `cpd_tpu/train/optim.py`, without Nesterov):

    d    = g + wd * w
    buf  = momentum * buf + d
    w    = w + (-lr) * buf

Each line is separate fp32 operations in that order (no fused
multiply-add), so given the same gradients the update is bitwise the
JAX one.  The port updates the weights and the momentum buffers in
place, with multi-tensor (``torch._foreach_*``) ops.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

__all__ = ["SGD", "TorchSGDState", "sgd"]


class TorchSGDState(NamedTuple):
    step: int
    momentum_buf: list


class SGD:
    """``init(params) -> state``; ``apply(grads, state, params) ->
    state`` updates ``params`` (and the state's buffers) in place."""

    def __init__(self, schedule: Callable, momentum: float = 0.9,
                 weight_decay: float = 0.0):
        self.schedule = schedule
        self.momentum = momentum
        self.weight_decay = weight_decay

    def init(self, params: Sequence[torch.Tensor]) -> TorchSGDState:
        return TorchSGDState(0, [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor], state: TorchSGDState,
              params: Sequence[torch.Tensor]) -> TorchSGDState:
        params, grads = list(params), list(grads)
        bufs = state.momentum_buf
        lr = self.schedule(state.step)
        if self.weight_decay:
            d = torch._foreach_mul(params, self.weight_decay)
            torch._foreach_add_(d, grads)
        else:
            d = grads
        torch._foreach_mul_(bufs, self.momentum)
        torch._foreach_add_(bufs, d)
        torch._foreach_add_(params, torch._foreach_mul(bufs, -lr))
        return TorchSGDState(state.step + 1, bufs)


def sgd(schedule: Callable, momentum: float = 0.9,
        weight_decay: float = 0.0) -> SGD:
    """torch.optim.SGD-semantics optimizer over a `Schedule`."""
    return SGD(schedule, momentum, weight_decay)
