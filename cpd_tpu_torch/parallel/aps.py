"""APS — Auto Precision Scaling (port of `cpd_tpu/parallel/aps.py`).

Per gradient leaf, around the low-precision reduction:

    max_exp = ceil(log2(max |g * world|)), MAX-reduced over the ranks
    shift   = (2^(exp-1) - 1) - max_exp          (0 for an all-zero leaf)
    g       = cast(g * 2^shift)  ...reduce...  g / 2^shift

Powers of two are assembled from their bits (`exp2_exact`) and the
ceil-log2 is read off frexp (`_ceil_log2_exact`), never taken from
``torch.exp2``/``log2``: a transcendental can land an ulp to either side
of an integer boundary, and the downstream ``ceil`` turns that ulp into
a whole shift unit (the JAX module's docstrings, `aps.py:42-90`).

Leaves are lists of tensors in one fixed order; the per-leaf vectors are
(n_leaves,) fp32 tensors on the leaves' device, so nothing here waits
for the card.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["exp2_exact", "aps_max_exponents", "aps_shift_factors",
           "aps_shift_factors_checked", "aps_scale", "aps_unscale"]


def exp2_exact(s: torch.Tensor) -> torch.Tensor:
    """The fp32 value of ``2.0 ** s`` for integer-valued fp32 ``s``, built
    from bits: normals for s in [-126, 127], exact subnormals down to
    2^-149, +inf above 127, +0.0 below -149."""
    si = torch.clamp(s.to(torch.float32), -150.0, 128.0).to(torch.int32)
    norm = ((torch.clamp(si, -126, 127) + 127) << 23).view(torch.float32)
    sub = torch.bitwise_left_shift(torch.ones_like(si),
                                   torch.clamp(si + 149, 0, 22))
    out = torch.where(si >= -126, norm, sub.view(torch.float32))
    out = torch.where(si >= 128, torch.inf, out)
    return torch.where(si <= -150, 0.0, out)


def _ceil_log2_exact(m: torch.Tensor) -> torch.Tensor:
    """Exact ``ceil(log2(m))`` for non-negative fp32 ``m`` (elementwise),
    from frexp: m = f * 2^e with f in [0.5, 1) gives ceil = e, or e - 1
    when m is the power of two itself (f == 0.5).  Subnormal m is
    pre-scaled by 2^24.  -inf for 0, +inf for inf, NaN for NaN."""
    is_sub = m < 2.0 ** -126
    mn = torch.where(is_sub, m * 16777216.0, m)
    f, e = torch.frexp(mn)
    ex = (e.to(torch.float32) - (f == 0.5).to(torch.float32)
          - torch.where(is_sub, 24.0, 0.0))
    ex = torch.where(m == 0, -torch.inf, ex)
    ex = torch.where(torch.isinf(m), torch.inf, ex)
    return torch.where(torch.isnan(m), torch.nan, ex)


def aps_max_exponents(leaves: Sequence[torch.Tensor],
                      world_size: int) -> torch.Tensor:
    """``ceil(log2(max |g * W|))`` per leaf, as one (n_leaves,) vector;
    -inf marks an all-zero leaf."""
    w = float(world_size)
    maxes = torch.stack([torch.amax(torch.abs(g.to(torch.float32) * w))
                         for g in leaves])
    return _ceil_log2_exact(maxes)


def aps_shift_factors_checked(max_exp: torch.Tensor,
                              grad_exp: int) -> tuple:
    """``shift = (2^(exp-1) - 1) - max_exp``, 0 where it is not finite.
    Returns ``(shifts, bad)``: ``bad`` counts the leaves whose max
    exponent is +inf or NaN (non-finite gradients; an all-zero leaf's
    -inf is healthy).  Call on the rank-MAX'd vector."""
    shift = float(2 ** (grad_exp - 1) - 1) - max_exp
    bad = (torch.isnan(max_exp) | (max_exp == torch.inf)).sum(
        dtype=torch.int32)
    return torch.where(torch.isfinite(shift), shift, 0.0), bad


def aps_shift_factors(max_exp: torch.Tensor, grad_exp: int) -> torch.Tensor:
    """`aps_shift_factors_checked` without the count."""
    return aps_shift_factors_checked(max_exp, grad_exp)[0]


def aps_scale(leaves: Sequence[torch.Tensor],
              shifts: torch.Tensor) -> list:
    """``g * 2^shift`` per leaf: an exact power-of-two scale."""
    p = exp2_exact(shifts)
    return [g * p[i] for i, g in enumerate(leaves)]


def aps_unscale(leaves: Sequence[torch.Tensor],
                shifts: torch.Tensor) -> list:
    """``g / 2^shift`` per leaf — a true fp32 divide, as the reference:
    for shifts above 127 the divisor is +inf and the leaf flushes to 0,
    which a multiply by a subnormal 2^-shift would not reproduce."""
    p = exp2_exact(shifts)
    return [g / p[i] for i, g in enumerate(leaves)]
