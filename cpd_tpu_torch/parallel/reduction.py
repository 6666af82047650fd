"""Ordered low-precision reduction (port of `cpd_tpu/parallel/reduction.py`,
RTNE only).

The reference's emulation of a low-precision all-reduce: gather every
rank's values, then accumulate them in rank order, re-quantizing to eXmY
after every addition:

    res = 0;  for g in stacked: res = cast(res + g)

so the result is independent of any network reduction tree.  On CUDA
tensors each step is one launch of the fused add-and-cast kernel (K3,
`ops.quantize.quantize_add`); ``fused=False`` runs the plain torch ops of
the same function on any device.  Kahan compensation and stochastic
rounding are not ported yet (ROADMAP Queue A, A3).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.quantize import quantize_add, quantize_add_ref

__all__ = ["ordered_quantized_sum", "quantized_sum"]


def _use_kernel(x: torch.Tensor, fused: Optional[bool]) -> bool:
    """``fused=None`` means the kernel exactly when the data is on CUDA;
    ``fused=True`` on CPU tensors is a caller error."""
    if fused is None:
        return x.is_cuda
    if fused and not x.is_cuda:
        raise ValueError("fused=True needs CUDA tensors: the fused kernels "
                         "run on the card only")
    return bool(fused)


def ordered_quantized_sum(stacked: torch.Tensor, exp: int, man: int, *,
                          fused: Optional[bool] = None) -> torch.Tensor:
    """``res = 0; for g in stacked: res = cast(res + g)`` — in order, over
    the leading axis of ``stacked`` (W, ...)."""
    step = quantize_add if _use_kernel(stacked, fused) else quantize_add_ref
    res = torch.zeros_like(stacked[0])
    for g in stacked:
        res = step(res, g, exp, man)
    return res


def quantized_sum(stacked: torch.Tensor, exp: int, man: int,
                  use_kahan: bool = False, *,
                  fused: Optional[bool] = None) -> torch.Tensor:
    """The ordered quantized sum; at (8, 23) a plain fp32 sum, the
    reference's identity-format shortcut (its cast would flush fp32
    subnormal partials, which an fp32 sum never does)."""
    if use_kahan:
        raise NotImplementedError(
            "the Kahan-compensated ordered sum is not ported yet (ROADMAP "
            "Queue A, A3)")
    if exp == 8 and man == 23:
        return stacked.sum(dim=0)
    return ordered_quantized_sum(stacked, exp, man, fused=fused)
