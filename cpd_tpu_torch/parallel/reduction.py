"""Ordered low-precision reduction (port of `cpd_tpu/parallel/reduction.py`).

The reference's emulation of a low-precision all-reduce: gather every
rank's values, then accumulate them in rank order, re-quantizing to eXmY
after every addition (optionally Kahan-compensated, every intermediate
quantized):

    res = 0;  for g in stacked: res = q(res + g)
    Kahan:    y = q(g - c); t = q(res + y); c = q(q(t - res) - y); res = t

so the result is independent of any network reduction tree.  ``q`` rounds
to nearest even, or, with a key, stochastically with bits indexed by
(key, scan step, cast site, element offset) (`_make_q`).

Every cast site is `cast_site`: on CUDA tensors one launch of K3 (RTNE)
or of the `sr_bits` kernel and K4 (SR); ``fused=False`` runs the plain
torch ops of the same functions on any device.  The SR bits of element i
are drawn at ``offset_start + i``, or at ``offsets[i]`` when an explicit
offset array is given (the JAX ``offsets`` vector: a bucket of
non-adjacent leaves, ZeRO-2's shard offsets with their pad sentinel;
the `sr_bits` kernel's offset-array arm on the card).  ``block_size``
makes every site the block-scaled cast (`numerics.cast_body_blocked`,
blocks along the last axis), ZeRO-2's blocked scan; the JAX package
casts it in XLA, and so do the plain torch ops here, the bits still
coming from the `sr_bits` kernel.  A Kahan subtraction runs
as an addition of the negated operand: ``x - y`` equals ``x + (-y)``
exactly in IEEE round-to-nearest, signed zeros included, so each of the
four Kahan sites is one fused add-and-cast.  (A NaN operand may keep
another sign bit; no cast site is fed one on the training path.)
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.quantize import (quantize_add, quantize_add_ref, quantize_add_sr,
                            quantize_add_sr_ref, quantize_cast,
                            quantize_cast_ref, quantize_cast_sr,
                            quantize_cast_sr_ref, sr_bits, sr_bits_ref)
from ..quant.numerics import cast_body_blocked
from ..quant.prng import site_key

__all__ = ["cast_site", "ordered_quantized_sum", "kahan_quantized_sum",
           "quantized_sum"]


def _use_kernel(x: torch.Tensor, fused: Optional[bool]) -> bool:
    """``fused=None`` means the kernel exactly when the data is on CUDA;
    ``fused=True`` on CPU tensors is a caller error."""
    if fused is None:
        return x.is_cuda
    if fused and not x.is_cuda:
        raise ValueError("fused=True needs CUDA tensors: the fused kernels "
                         "run on the card only")
    return bool(fused)


def cast_site(x: torch.Tensor, y: Optional[torch.Tensor], exp: int,
              man: int, *, kernel: bool, key=None, offset_start: int = 0,
              flat: bool = False, offsets=None) -> torch.Tensor:
    """``q(x [+ y])`` at one cast site: RTNE when ``key`` is None, else
    SR with the bits ``prng.sr_bits_at(key, offset_start + i)`` of each
    element i (``offsets``: at ``offsets[i]``; ``flat``:
    ``jax.random.bits(key, x.shape)``'s, the bits of
    `numerics.cast_to_format_sr`).  ``kernel``: K1/K3, or `sr_bits` +
    K2/K4; else their plain versions."""
    if key is None:
        if y is None:
            return (quantize_cast if kernel else quantize_cast_ref)(
                x, exp, man)
        return (quantize_add if kernel else quantize_add_ref)(x, y, exp, man)
    rbits = (sr_bits if kernel else sr_bits_ref)(
        key, x, offset_start=offset_start, flat=flat, offsets=offsets)
    if y is None:
        return (quantize_cast_sr if kernel else quantize_cast_sr_ref)(
            x, exp, man, rbits)
    return (quantize_add_sr if kernel else quantize_add_sr_ref)(
        x, y, exp, man, rbits)


def _make_q(exp: int, man: int, key, kernel: bool, offset_start: int = 0,
            offsets=None, block: Optional[int] = None):
    """``q(x, y, step, site) = cast(x + y)``: RTNE when ``key`` is None
    (step and site ignored), else SR keyed by ``site_key(key, step,
    site)`` with the elements' offsets ``offset_start + i`` (default:
    the reference's leaf-local ``arange``) or ``offsets``.  ``block``:
    the block-scaled cast of the sum (module docstring)."""

    def q(x, y, step, site):
        k = None if key is None else site_key(key, step, site)
        if block is None:
            return cast_site(x, y, exp, man, kernel=kernel, key=k,
                             offset_start=offset_start, offsets=offsets)
        s = x if y is None else x + y
        rbits = None if k is None else (sr_bits if kernel else sr_bits_ref)(
            k, s, offset_start=offset_start, offsets=offsets)
        return cast_body_blocked(s, exp, man, block, rbits)

    return q


def kahan_step(q, res: torch.Tensor, comp: torch.Tensor, g: torch.Tensor,
               step: int) -> tuple:
    """One Kahan step with the quantizer ``q(x, y, step, site)``; the
    subtractions add the negated operand (exact, module docstring)."""
    y = q(g, -comp, step, 0)
    t = q(res, y, step, 1)
    comp = q(q(t, -res, step, 2), -y, step, 3)
    return t, comp


def ordered_quantized_sum(stacked: torch.Tensor, exp: int, man: int,
                          key=None, *, offset_start: int = 0,
                          offsets=None, block_size: Optional[int] = None,
                          fused: Optional[bool] = None) -> torch.Tensor:
    """``res = 0; for g in stacked: res = q(res + g)`` — in order, over
    the leading axis of ``stacked`` (W, ...); scan step i draws site 0."""
    q = _make_q(exp, man, key, _use_kernel(stacked, fused), offset_start,
                offsets, block_size)
    res = torch.zeros_like(stacked[0])
    for i, g in enumerate(stacked):
        res = q(res, g, i, 0)
    return res


def kahan_quantized_sum(stacked: torch.Tensor, exp: int, man: int,
                        key=None, *, offset_start: int = 0,
                        offsets=None, block_size: Optional[int] = None,
                        fused: Optional[bool] = None) -> torch.Tensor:
    """The rank-ordered Kahan-compensated sum with every intermediate
    quantized, sites 0-3 per scan step:
    ``y = q(g - c); t = q(res + y); c = q(q(t - res) - y); res = t``."""
    q = _make_q(exp, man, key, _use_kernel(stacked, fused), offset_start,
                offsets, block_size)
    res = torch.zeros_like(stacked[0])
    comp = torch.zeros_like(stacked[0])
    for i, g in enumerate(stacked):
        res, comp = kahan_step(q, res, comp, g, i)
    return res


def quantized_sum(stacked: torch.Tensor, exp: int, man: int,
                  use_kahan: bool = False, key=None, *,
                  offset_start: int = 0, offsets=None,
                  block_size: Optional[int] = None,
                  fused: Optional[bool] = None) -> torch.Tensor:
    """The ordered (or Kahan) quantized sum; at (8, 23) without Kahan a
    plain fp32 sum, the reference's identity-format shortcut (its cast
    would flush fp32 subnormal partials, which an fp32 sum never does;
    the key is irrelevant there).  The Kahan sum has no shortcut.
    ``offsets`` (one per element of a row) index the SR bits in place
    of ``offset_start + i``; ``block_size`` casts block-scaled."""
    if block_size is not None and exp == 8 and man == 23 and not use_kahan:
        raise ValueError("block_size at (8, 23): the fp32 shortcut has no "
                         "cast to block-scale")
    kw = dict(key=key, offset_start=offset_start, offsets=offsets,
              block_size=block_size, fused=fused)
    if use_kahan:
        return kahan_quantized_sum(stacked, exp, man, **kw)
    if exp == 8 and man == 23:
        return stacked.sum(dim=0)
    return ordered_quantized_sum(stacked, exp, man, **kw)
