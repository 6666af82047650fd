"""LR schedules (port of `warmup_step_decay` and `warmup_cosine` from
`cpd_tpu/train/schedules.py`).

A schedule maps the step to the learning rate as a Python float holding
an fp32 value, computed in fp32 with the JAX schedule's operations in
its order, so an optimizer multiplies by the same number."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

__all__ = ["warmup_step_decay", "warmup_cosine", "Schedule"]

Schedule = Callable[[int], float]


def warmup_step_decay(base_lr: float, warmup_iters: int,
                      decay_iters: Sequence[int], warmup_from: float = 0.1,
                      decay_factor: float = 0.1) -> Schedule:
    """Linear warmup from `warmup_from` to `base_lr` over `warmup_iters`,
    then multiply by `decay_factor` after each boundary in
    `decay_iters` (reference mix.py:181-198).  After two or more decays
    the fp32 power may differ from XLA's ``pow`` in the last bit."""
    f32 = np.float32
    boundaries = np.asarray(list(decay_iters), np.float32)

    def schedule(step: int) -> float:
        s = f32(step)
        warm = f32(warmup_from) + f32(base_lr - warmup_from) * (
            s / f32(max(warmup_iters, 1)))
        decays = int(np.sum(s > boundaries))
        decayed = f32(base_lr) * f32(decay_factor) ** f32(decays)
        return float(warm if s <= warmup_iters else decayed)

    return schedule


def warmup_cosine(base_lr: float, warmup_iters: int, total_iters: int,
                  final_lr: float = 0.0, warmup_from: float = 0.0) -> Schedule:
    """Linear warmup from `warmup_from` to `base_lr` over `warmup_iters`,
    then cosine decay to `final_lr` at `total_iters` (the JAX package
    delegates to optax's ``warmup_cosine_decay_schedule``; its operations
    in fp32 here, so fp32 ``cos`` may differ from XLA's in the last
    bit)."""
    if total_iters <= warmup_iters:
        raise ValueError(f"total_iters {total_iters} must exceed "
                         f"warmup_iters {warmup_iters}")
    f32 = np.float32
    alpha = 0.0 if base_lr == 0.0 else final_lr / base_lr
    decay = f32(total_iters - warmup_iters)

    def schedule(step: int) -> float:
        if step < warmup_iters:
            count = f32(min(max(step, 0), warmup_iters))
            frac = f32(1) - count / f32(warmup_iters)
            return float(f32(warmup_from - base_lr) * frac + f32(base_lr))
        count = np.minimum(f32(step - warmup_iters), decay)
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * count / decay))
        return float(f32(base_lr) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule
