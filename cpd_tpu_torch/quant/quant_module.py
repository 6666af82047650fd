"""Quantized layers (port of `cpd_tpu/quant/quant_module.py`:
`quant_linear_fn`, `QuantLinear` and `QuantDense`, round to nearest).

`quant_linear_fn` is ``y = x @ Wᵀ + b`` with eXmY-accumulator GEMMs and
the reference's backward recipe (quant_module.py:36-52), as a
`torch.autograd.Function`:

    forward:  y      = qgemm(x, Wᵀ) + b
    backward: grad_x = qgemm(g, W)
              grad_W = qgemm(gᵀ, x)
              grad_b = float_quantize(g.sum(0))

`QuantDense` keeps flax Dense's contract — a ``kernel`` of shape (in,
out) — and runs the same recipe on it (`quant_dense_fn`): its forward
GEMM is ``qgemm(x, kernel)``, its input gradient ``qgemm(g, kernelᵀ)``
and its kernel gradient ``qgemm(xᵀ, g)``, bitwise the JAX module's
``qgemm(gᵀ, x)ᵀ`` (each Kahan step's product x·g is g·x exactly, in the
same k order) and contiguous in the kernel's own layout.  `QuantLinear`
keeps torch Linear's (out, in) ``weight`` and the kaiming-uniform init.
One `torch.autograd.Function` holds the recipe for both layouts.

`QuantConv`, the `Quantizer` module and stochastic rounding are not
ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from .quant_function import float_quantize, qgemm

__all__ = ["quant_linear_fn", "quant_dense_fn", "QuantDense", "QuantLinear"]


class _QuantGemmFn(torch.autograd.Function):
    """``x @ kernel + bias`` with the reference's backward recipe, the
    kernel given as ``w``: (in, out) as flax Dense holds it, or with
    ``out_in`` torch Linear's (out, in) weight, ``kernel = wᵀ``.  The
    weight gradient comes back in ``w``'s own layout, contiguous (the
    card's casts take contiguous leaves): ``qgemm(gᵀ, x)`` for (out, in),
    the reference's; ``qgemm(xᵀ, g)`` for (in, out), bitwise its
    transpose (each Kahan step's product x·g is g·x exactly, in the same
    k order)."""

    @staticmethod
    def forward(ctx, x, w, bias, exp, man, mode, out_in):
        ctx.save_for_backward(x, w)
        ctx.cfg = (exp, man, mode, bias is not None, out_in)
        out = qgemm(x, w.t() if out_in else w, exp=exp, man=man, mode=mode)
        return out if bias is None else out + bias[None, :]

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        exp, man, mode, has_bias, out_in = ctx.cfg
        grad_x = qgemm(g, w if out_in else w.t(), exp=exp, man=man,
                       mode=mode)
        grad_w = (qgemm(g.t(), x, exp=exp, man=man, mode=mode) if out_in
                  else qgemm(x.t(), g, exp=exp, man=man, mode=mode))
        grad_b = float_quantize(g.sum(0), exp, man) if has_bias else None
        return grad_x, grad_w, grad_b, None, None, None, None


def quant_linear_fn(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor], exp: int, man: int,
                    mode: str = "faithful") -> torch.Tensor:
    """``x @ weightᵀ + bias`` with eXmY-accumulator GEMMs and the
    reference's backward recipe.  x: (M, in), weight: (out, in), bias:
    (out,) or None."""
    if x.dim() != 2 or weight.dim() != 2:
        raise ValueError(f"quant_linear_fn wants x (M, in) and weight (out, "
                         f"in); got {tuple(x.shape)}, {tuple(weight.shape)}")
    return _QuantGemmFn.apply(x, weight, bias, exp, man, mode, True)


def quant_dense_fn(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor], exp: int, man: int,
                   mode: str = "faithful") -> torch.Tensor:
    """``x @ kernel + bias`` (kernel (in, out)) with eXmY-accumulator
    GEMMs and the reference's backward recipe in the kernel's layout:
    bitwise ``quant_linear_fn(x, kernelᵀ, bias, ...)`` and its
    gradients."""
    if x.dim() != 2 or kernel.dim() != 2:
        raise ValueError(f"quant_dense_fn wants x (M, in) and kernel (in, "
                         f"out); got {tuple(x.shape)}, {tuple(kernel.shape)}")
    return _QuantGemmFn.apply(x, kernel, bias, exp, man, mode, False)


class QuantDense(nn.Module):
    """Drop-in flax Dense with the eXmY-accumulator GEMM: parameter
    ``kernel`` (in, out) and optional ``bias`` (out,), so a flax param
    tree loads unchanged (`interop.load_jax_params`).  Parameters are
    left uninitialized, as the port's `Dense` leaves them."""

    def __init__(self, d_in: int, d_out: int, *, exp: int = 8,
                 man: int = 23, mode: str = "faithful",
                 use_bias: bool = False, device=None):
        super().__init__()
        self.exp, self.man, self.mode = exp, man, mode
        self.kernel = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.bias = (nn.Parameter(torch.empty(d_out, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        y = quant_dense_fn(x2, self.kernel, self.bias, self.exp, self.man,
                           self.mode)
        return y.reshape(*x.shape[:-1], self.kernel.shape[1])


class QuantLinear(nn.Module):
    """Linear layer with the eXmY-accumulator GEMM (reference
    quant_module.py:55-85): ``weight`` (out, in) and ``bias`` (out,),
    kaiming-uniform with bound 1/sqrt(in) from ``generator``."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, exp: int = 8, man: int = 23,
                 mode: str = "faithful", device=None, generator=None):
        super().__init__()
        self.exp, self.man, self.mode = exp, man, mode
        bound = 1.0 / math.sqrt(in_features)

        def init(*shape):
            u = torch.rand(shape, generator=generator, device=device)
            return nn.Parameter(u * (2 * bound) - bound)

        self.weight = init(out_features, in_features)
        self.bias = init(out_features) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        squeeze = x.dim() == 1
        x2 = x[None, :] if squeeze else x.reshape(-1, x.shape[-1])
        y = quant_linear_fn(x2, self.weight, self.bias, self.exp, self.man,
                            self.mode)
        if squeeze:
            return y[0]
        return y.reshape(*x.shape[:-1], self.weight.shape[0])
