"""Dynamic loss scaling (port of `cpd_tpu/train/scaling.py`): the loss
is multiplied by a state-carried scale, the wrapper unscales the
incoming (scaled) gradients, skips the update when any gradient is
non-finite, halves the scale on overflow and doubles it after
``growth_interval`` consecutive finite steps — GradScaler's policy
(growth 2.0, backoff 0.5, interval 2000, clamped to [``min_scale``,
``max_scale``]).

The policy is the reference's bit for bit: the scale and its updates are
fp32 (``scale * growth`` rounded to fp32, then clamped), ``good_steps``
resets on a non-finite step and on growth, and the unscale multiplies
by ``1/scale`` computed in fp32.  A power-of-two scale makes the unscale
exact, so with a finite trajectory the wrapped optimizer walks
bit-identically to the unwrapped one fed raw gradients.

The port's optimizers update the weights in place, so a skipped step
cannot run the inner update and mask it after, as the JAX wrapper does:
it does not call the inner ``apply`` at all, which leaves the weights
and the inner state as they were (and skips the unscale, so no
``inf * 0`` can make a NaN).  The verdict is one pass over every leaf
(`all_finite`: each leaf's largest magnitude in one multi-tensor
``_foreach_norm(inf)``, then one vector test) and one host sync a step.
The scale is held as a Python float (an fp32 value): the step reads it
for the loss without touching the card.  As with GradScaler, a skipped
step keeps the BN running stats the forward moved.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..parallel.integrity import tensor_leaves

__all__ = ["DynamicScaleState", "DynamicLossScale", "with_dynamic_loss_scale",
           "all_finite", "current_scale", "find_dynamic_scale"]


class DynamicScaleState(NamedTuple):
    scale: float      # fp32 value: multiply the loss by this
    good_steps: int   # consecutive finite steps since the last change
    inner: Any        # the wrapped optimizer's state


def all_finite(tree) -> torch.Tensor:
    """0-d bool: every element of every leaf is finite.  Each leaf's
    largest magnitude comes from one multi-tensor pass (a NaN anywhere
    makes its leaf's NaN; no sum of squares, so a large finite value
    cannot overflow into a false verdict)."""
    leaves = tensor_leaves(tree)
    if not leaves:
        return torch.tensor(True)
    return torch.stack(torch._foreach_norm(leaves, float("inf"))
                       ).isfinite().all()


def find_dynamic_scale(opt_state: Any) -> Optional[DynamicScaleState]:
    """The `DynamicScaleState` nested anywhere in ``opt_state`` (through
    tuples, named tuples, lists and dicts, e.g. a chain's state that
    holds the wrapper's one level down), or None."""
    if isinstance(opt_state, DynamicScaleState):
        return opt_state
    if isinstance(opt_state, dict):
        opt_state = list(opt_state.values())
    if isinstance(opt_state, (list, tuple)):
        for node in opt_state:
            found = find_dynamic_scale(node)
            if found is not None:
                return found
    return None


def current_scale(opt_state: Any) -> float:
    """The live scale of a `with_dynamic_loss_scale` optimizer state.
    Raises if the optimizer is not wrapped (the step multiplies the loss
    by this)."""
    node = find_dynamic_scale(opt_state)
    if node is None:
        raise TypeError(
            "dynamic loss scaling needs the optimizer wrapped with "
            "with_dynamic_loss_scale(tx); got opt state "
            f"{type(opt_state).__name__}")
    return node.scale


class DynamicLossScale:
    """An optimizer wrapped so it consumes the gradients of a
    ``scale``-multiplied loss (module docstring)."""

    def __init__(self, inner, init_scale: float = 2.0 ** 15,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 2000, max_scale: float = 2.0 ** 24,
                 min_scale: float = 1.0):
        if not (growth_factor > 1.0 and 0.0 < backoff_factor < 1.0):
            raise ValueError("need growth_factor > 1 and 0 < "
                             "backoff_factor < 1")
        self.inner = inner
        f32 = np.float32
        self.init_scale = f32(init_scale)
        self.growth_factor = f32(growth_factor)
        self.backoff_factor = f32(backoff_factor)
        self.growth_interval = growth_interval
        self.max_scale = f32(max_scale)
        self.min_scale = f32(min_scale)

    def init(self, params: Sequence[torch.Tensor]) -> DynamicScaleState:
        return DynamicScaleState(float(self.init_scale), 0,
                                 self.inner.init(params))

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor], state: DynamicScaleState,
              params: Sequence[torch.Tensor], *,
              fused: Optional[bool] = None) -> DynamicScaleState:
        scale = np.float32(state.scale)
        if not bool(all_finite(list(grads))):
            # nothing applied; the inner state stays as it was
            return DynamicScaleState(
                float(max(scale * self.backoff_factor, self.min_scale)), 0,
                state.inner)
        inv = float(np.float32(1.0) / scale)
        inner = self.inner.apply(torch._foreach_mul(list(grads), inv),
                                 state.inner, params, fused=fused)
        good = state.good_steps + 1
        if good >= self.growth_interval:
            with np.errstate(over="ignore"):   # past fp32's max: the clamp
                grown = scale * self.growth_factor
            scale, good = min(grown, self.max_scale), 0
        return DynamicScaleState(float(scale), good, inner)


def with_dynamic_loss_scale(tx, init_scale: float = 2.0 ** 15,
                            growth_factor: float = 2.0,
                            backoff_factor: float = 0.5,
                            growth_interval: int = 2000,
                            max_scale: float = 2.0 ** 24,
                            min_scale: float = 1.0) -> DynamicLossScale:
    """Wrap the optimizer ``tx`` so it consumes gradients of a
    ``scale``-multiplied loss: unscale, skip on a non-finite gradient,
    back off and grow (module docstring)."""
    return DynamicLossScale(tx, init_scale, growth_factor, backoff_factor,
                            growth_interval, max_scale, min_scale)
