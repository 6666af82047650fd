"""Quantized layers (port of `cpd_tpu/quant/quant_module.py`:
`quant_linear_fn`, `Quantizer`, `QuantLinear`, `QuantDense` and
`QuantConv`).

`quant_linear_fn` is ``y = x @ Wᵀ + b`` with eXmY-accumulator GEMMs and
the reference's backward recipe (quant_module.py:36-52), as a
`torch.autograd.Function`:

    forward:  y      = qgemm(x, Wᵀ) + b
    backward: grad_x = qgemm(g, W)
              grad_W = qgemm(gᵀ, x)
              grad_b = float_quantize(g.sum(0))

With a ``key`` every cast is stochastically rounded, one subkey a site
as the JAX module folds them: the forward GEMM ``fold_in(key, 0)``,
grad_x 1, grad_W 2, the bias gradient's cast 3.

`QuantDense` keeps flax Dense's contract — a ``kernel`` of shape (in,
out) — and runs the same recipe on it (`quant_dense_fn`): its forward
GEMM is ``qgemm(x, kernel)``, its input gradient ``qgemm(g, kernelᵀ)``
and, round to nearest, its kernel gradient ``qgemm(xᵀ, g)``, bitwise the
JAX module's ``qgemm(gᵀ, x)ᵀ`` (each Kahan step's product x·g is g·x
exactly, in the same k order) and contiguous in the kernel's own layout.
Stochastically rounded, the bits follow the output's flat index, so the
kernel gradient is ``qgemm(gᵀ, x)ᵀ`` itself, made contiguous.
`QuantLinear` keeps torch Linear's (out, in) ``weight`` and the
kaiming-uniform init.  One `torch.autograd.Function` holds the recipe
for both layouts.

`QuantConv` is im2col (`F.unfold`'s (C, kh, kw)-major columns, the
layout of ``lax.conv_general_dilated_patches``) and one `quant_linear_fn`
per group over the group's contiguous columns, NCHW, square kernels,
with dilation and groups.  Its input gradient goes back through
`F.fold`: where windows overlap, each pixel sums its windows' terms in
fp32 in another order than XLA's transposed convolution.

PyTorch has no flax ``make_rng``: each module takes its key per call,
``forward(x, key=...)``, a `prng` pair.  ``rounding="stochastic"``
without a key raises, as flax does without an ``'sr'`` stream; round to
nearest ignores one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .prng import fold_in
from .quant_function import float_quantize, qgemm, quantizer, quantizer_sr

__all__ = ["quant_linear_fn", "quant_dense_fn", "Quantizer", "QuantDense",
           "QuantLinear", "QuantConv"]


def _site_gemm(a, b, exp, man, mode, key, site):
    if key is None:
        return qgemm(a, b, exp=exp, man=man, mode=mode)
    return qgemm(a, b, exp=exp, man=man, mode=mode, rounding="stochastic",
                 key=fold_in(key, site))


class _QuantGemmFn(torch.autograd.Function):
    """``x @ kernel + bias`` with the reference's backward recipe, the
    kernel given as ``w``: (in, out) as flax Dense holds it, or with
    ``out_in`` torch Linear's (out, in) weight, ``kernel = wᵀ``.  The
    weight gradient comes back in ``w``'s own layout, contiguous (the
    card's casts take contiguous leaves): ``qgemm(gᵀ, x)`` for (out, in),
    the reference's; for (in, out) round to nearest ``qgemm(xᵀ, g)``,
    bitwise its transpose (each Kahan step's product x·g is g·x exactly,
    in the same k order), and with a key ``qgemm(gᵀ, x)ᵀ``, whose SR
    bits follow the (out, in) output's flat index."""

    @staticmethod
    def forward(ctx, x, w, bias, exp, man, mode, out_in, key):
        ctx.save_for_backward(x, w)
        ctx.cfg = (exp, man, mode, bias is not None, out_in, key)
        out = _site_gemm(x, w.t() if out_in else w, exp, man, mode, key, 0)
        return out if bias is None else out + bias[None, :]

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        exp, man, mode, has_bias, out_in, key = ctx.cfg
        grad_x = _site_gemm(g, w if out_in else w.t(), exp, man, mode, key,
                            1)
        if out_in:
            grad_w = _site_gemm(g.t(), x, exp, man, mode, key, 2)
        elif key is None:
            grad_w = qgemm(x.t(), g, exp=exp, man=man, mode=mode)
        else:
            grad_w = _site_gemm(g.t(), x, exp, man, mode, key,
                                2).t().contiguous()
        grad_b = None
        if has_bias:
            grad_b = (float_quantize(g.sum(0), exp, man) if key is None
                      else float_quantize(g.sum(0), exp, man,
                                          rounding="stochastic",
                                          key=fold_in(key, 3)))
        return grad_x, grad_w, grad_b, None, None, None, None, None


def _key_pair(key) -> Optional[tuple]:
    return None if key is None else (int(key[0]), int(key[1]))


def quant_linear_fn(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor], exp: int, man: int,
                    mode: str = "faithful", key=None) -> torch.Tensor:
    """``x @ weightᵀ + bias`` with eXmY-accumulator GEMMs and the
    reference's backward recipe.  x: (M, in), weight: (out, in), bias:
    (out,) or None; ``key`` (a `prng` pair) makes every cast SR, one
    site each."""
    if x.dim() != 2 or weight.dim() != 2:
        raise ValueError(f"quant_linear_fn wants x (M, in) and weight (out, "
                         f"in); got {tuple(x.shape)}, {tuple(weight.shape)}")
    return _QuantGemmFn.apply(x, weight, bias, exp, man, mode, True,
                              _key_pair(key))


def quant_dense_fn(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor], exp: int, man: int,
                   mode: str = "faithful", key=None) -> torch.Tensor:
    """``x @ kernel + bias`` (kernel (in, out)) with eXmY-accumulator
    GEMMs and the reference's backward recipe in the kernel's layout:
    bitwise ``quant_linear_fn(x, kernelᵀ, bias, ...)`` and its
    gradients."""
    if x.dim() != 2 or kernel.dim() != 2:
        raise ValueError(f"quant_dense_fn wants x (M, in) and kernel (in, "
                         f"out); got {tuple(x.shape)}, {tuple(kernel.shape)}")
    return _QuantGemmFn.apply(x, kernel, bias, exp, man, mode, False,
                              _key_pair(key))


def _rounding(rounding: str) -> str:
    if rounding not in ("nearest", "stochastic"):
        raise ValueError(f"unknown rounding mode: {rounding!r}")
    return rounding


def _module_key(rounding: str, key):
    """None for RTNE (a key is ignored); the key for SR, which needs one."""
    if _rounding(rounding) == "nearest":
        return None
    if key is None:
        raise ValueError("rounding='stochastic' needs a key: call the "
                         "module as module(x, key=...)")
    return key


class Quantizer(nn.Module):
    """Activation quantizer module (`cpd_tpu/quant/quant_module.py`
    `Quantizer`, the reference's quant_module.py:13-20):
    `quantizer`, or with ``rounding="stochastic"`` `quantizer_sr` on the
    call's key."""

    def __init__(self, forward_exp: int = 8, forward_man: int = 23,
                 backward_exp: int = 8, backward_man: int = 23,
                 rounding: str = "nearest"):
        super().__init__()
        self.fmt = (forward_exp, forward_man, backward_exp, backward_man)
        self.rounding = _rounding(rounding)

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        key = _module_key(self.rounding, key)
        if key is None:
            return quantizer(*self.fmt)(x)
        return quantizer_sr(*self.fmt)(x, key)


class QuantDense(nn.Module):
    """Drop-in flax Dense with the eXmY-accumulator GEMM: parameter
    ``kernel`` (in, out) and optional ``bias`` (out,), so a flax param
    tree loads unchanged (`interop.load_jax_params`).  Parameters are
    left uninitialized, as the port's `Dense` leaves them."""

    def __init__(self, d_in: int, d_out: int, *, exp: int = 8,
                 man: int = 23, mode: str = "faithful",
                 use_bias: bool = False, rounding: str = "nearest",
                 device=None):
        super().__init__()
        self.exp, self.man, self.mode = exp, man, mode
        self.rounding = _rounding(rounding)
        self.kernel = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.bias = (nn.Parameter(torch.empty(d_out, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        y = quant_dense_fn(x2, self.kernel, self.bias, self.exp, self.man,
                           self.mode, _module_key(self.rounding, key))
        return y.reshape(*x.shape[:-1], self.kernel.shape[1])


def _kaiming_uniform(shape, fan_in: int, generator, device) -> nn.Parameter:
    """torch's kaiming_uniform_(a=sqrt(5)): bound 1/sqrt(fan_in)."""
    bound = 1.0 / math.sqrt(fan_in)
    u = torch.rand(shape, generator=generator, device=device)
    return nn.Parameter(u * (2 * bound) - bound)


class QuantLinear(nn.Module):
    """Linear layer with the eXmY-accumulator GEMM (reference
    quant_module.py:55-85): ``weight`` (out, in) and ``bias`` (out,),
    kaiming-uniform with bound 1/sqrt(in) from ``generator``."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, exp: int = 8, man: int = 23,
                 mode: str = "faithful", rounding: str = "nearest",
                 device=None, generator=None):
        super().__init__()
        self.exp, self.man, self.mode = exp, man, mode
        self.rounding = _rounding(rounding)
        self.weight = _kaiming_uniform((out_features, in_features),
                                       in_features, generator, device)
        self.bias = (_kaiming_uniform((out_features,), in_features,
                                      generator, device)
                     if use_bias else None)

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        squeeze = x.dim() == 1
        x2 = x[None, :] if squeeze else x.reshape(-1, x.shape[-1])
        y = quant_linear_fn(x2, self.weight, self.bias, self.exp, self.man,
                            self.mode, _module_key(self.rounding, key))
        if squeeze:
            return y[0]
        return y.reshape(*x.shape[:-1], self.weight.shape[0])


class QuantConv(nn.Module):
    """2-D convolution as im2col and quantized GEMMs (reference
    quant_module.py:88-139), NCHW, square kernels, with ``dilation`` and
    ``groups`` in torch's semantics: ``weight`` (out, in/groups, k, k)
    and ``bias`` (out,), kaiming-uniform at the group's fan-in
    (in/groups)·k·k from ``generator``.  Group gi's GEMM is
    `quant_linear_fn` over its contiguous im2col columns; with a key its
    key is ``fold_in(key, gi)``, as the JAX module folds it."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, padding: int = 0,
                 dilation: int = 1, groups: int = 1, use_bias: bool = True,
                 exp: int = 8, man: int = 23, mode: str = "faithful",
                 rounding: str = "nearest", device=None, generator=None):
        super().__init__()
        if in_channels % groups or out_channels % groups:
            raise ValueError(
                f"groups={groups} must divide in_channels={in_channels} "
                f"and out_channels={out_channels}")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.dilation, self.groups = padding, dilation, groups
        self.exp, self.man, self.mode = exp, man, mode
        self.rounding = _rounding(rounding)
        fan_in = in_channels // groups * kernel_size * kernel_size
        self.weight = _kaiming_uniform(
            (out_channels, in_channels // groups, kernel_size, kernel_size),
            fan_in, generator, device)
        self.bias = (_kaiming_uniform((out_channels,), fan_in, generator,
                                      device) if use_bias else None)

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        key = _module_key(self.rounding, key)
        b, _, h, w = x.shape
        k, d, g = self.kernel_size, self.dilation, self.groups
        span = d * (k - 1) + 1
        out_h = (h + 2 * self.padding - span) // self.stride + 1
        out_w = (w + 2 * self.padding - span) // self.stride + 1
        # (B, C*k*k, L) in (C, kh, kw)-major order -> (B*L, C*k*k)
        patches = F.unfold(x.to(torch.float32), k, dilation=d,
                           padding=self.padding, stride=self.stride)
        patches = patches.transpose(1, 2).reshape(b * out_h * out_w, -1)
        cols = patches.shape[1] // g
        o_g = self.out_channels // g
        outs = []
        for gi in range(g):
            w2 = self.weight[gi * o_g:(gi + 1) * o_g].reshape(o_g, cols)
            b2 = (None if self.bias is None
                  else self.bias[gi * o_g:(gi + 1) * o_g])
            outs.append(quant_linear_fn(
                patches[:, gi * cols:(gi + 1) * cols], w2, b2, self.exp,
                self.man, self.mode,
                None if key is None else fold_in(key, gi)))
        y = outs[0] if g == 1 else torch.cat(outs, dim=-1)
        y = y.reshape(b, out_h * out_w, self.out_channels).transpose(1, 2)
        return y.reshape(b, self.out_channels, out_h, out_w)
