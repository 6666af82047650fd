"""Custom-precision quantization API (port of
`cpd_tpu/quant/quant_function.py`).

* `float_quantize` — the eXmY cast, RTNE (K1 on a CUDA tensor) or
  stochastic with a `prng` key (the flat `sr_bits` arm and K2);
  `float_quantize_stats` adds its `quant_health` counters;
* `quantizer` — a function quantizing activations on the forward pass
  and cotangents on the backward pass (a `torch.autograd.Function`), with
  the identity at (8, 23) on either side; `quantizer_sr` the same with
  SR casts (forward at site 0 of the key, backward at site 1);
  `quantizer_stats` counts both casts, the backward's health riding back
  as the gradient of a (4,) ``tap`` input;
* `qgemm(a, b, exp, man, mode, rounding, key)` — a GEMM with an eXmY
  accumulator: ``faithful`` runs the quantized Kahan scan (K8,
  `ops.qgemm`; its SR arm with a key) for every format, (8, 23)
  included, since the cast still flushes fp32 subnormal intermediates
  there; ``fast`` is an fp32 product with TF32 off, then one cast (RTNE,
  or SR with the key itself; none at (8, 23));
* `qgemm_stats` — `qgemm` and the health counters of every cast the
  mode performs (K8's stats arm in faithful mode);
* `quant_gemm`, `quant_gemm_stats` — the reference's ``(man, exp)``
  argument order, kept as the JAX package keeps it;
* `tree_quant_health` — `quant_health` summed leaf by leaf over two
  matching trees of tensors.

Keys are `prng` pairs ``(k0, k1)`` of uint32 words
(``jax.random.key_data`` of the JAX package's key).
"""

from __future__ import annotations

import torch

from .numerics import (HEALTH_FIELDS, _validate, cast_to_format,
                       cast_to_format_sr, quant_health)
from .prng import fold_in

__all__ = ["float_quantize", "float_quantize_stats", "quantizer",
           "quantizer_sr", "quantizer_stats", "qgemm", "qgemm_stats",
           "quant_gemm", "quant_gemm_stats", "tree_quant_health",
           "HEALTH_FIELDS"]


def _validate_rounding(rounding: str, key) -> bool:
    """The rounding/key contract of the JAX API; True for SR."""
    if rounding == "nearest":
        if key is not None:
            raise ValueError("a PRNG key was passed but rounding='nearest' "
                             "would ignore it; did you mean "
                             "rounding='stochastic'?")
        return False
    if rounding == "stochastic":
        if key is None:
            raise ValueError("rounding='stochastic' requires a PRNG key")
        return True
    raise ValueError(f"unknown rounding mode: {rounding!r}")


def float_quantize(x: torch.Tensor, exp: int, man: int,
                   rounding: str = "nearest", key=None) -> torch.Tensor:
    """Quantize an fp32 tensor into the eXmY format (argument order
    (exp, man) as the reference's).  ``rounding="stochastic"`` needs a
    `prng` key and draws ``jax.random.bits(key, x.shape)``'s bits."""
    x = x.contiguous()
    if _validate_rounding(rounding, key):
        return cast_to_format_sr(x, exp, man, key)
    return cast_to_format(x, exp, man)


def float_quantize_stats(x: torch.Tensor, exp: int, man: int,
                         rounding: str = "nearest", key=None) -> tuple:
    """`float_quantize` plus its health counters: ``(q, health)``, ``q``
    bitwise `float_quantize`'s and ``health`` `quant_health(x, q)`."""
    q = float_quantize(x, exp, man, rounding=rounding, key=key)
    return q, quant_health(x, q)


def _leaves(tree) -> list:
    """The tensors of a tree of dicts (keys sorted, as jax orders them),
    lists and tuples; None holds none."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [x for t in tree for x in _leaves(t)]


def tree_quant_health(before, after) -> dict:
    """`quant_health` summed over two matching trees (cast inputs and
    outputs, leaf for leaf), float32, leaf by leaf from zero as the JAX
    function sums it.  Empty trees report zeros.  (`parallel.dist` has
    the reduce's own, which counts small leaf lists in one pass.)"""
    out = {f: torch.zeros((), dtype=torch.float32) for f in HEALTH_FIELDS}
    for b, a in zip(_leaves(before), _leaves(after)):
        h = quant_health(b, a)
        out = {f: out[f].to(h[f].device) + h[f] for f in HEALTH_FIELDS}
    return out


def _health_vec(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """`quant_health` as a float32 (4,) vector in HEALTH_FIELDS order."""
    h = quant_health(x, q)
    return torch.stack([h[f] for f in HEALTH_FIELDS])


class _Quantize(torch.autograd.Function):
    """Cast on the forward pass at (fe, fm), the cotangent on the
    backward pass at (be, bm); (8, 23) is the identity on its side."""

    @staticmethod
    def forward(ctx, x, fe, fm, be, bm):
        ctx.fmt = (be, bm)
        if (fe, fm) == (8, 23):
            return x.clone()
        return cast_to_format(x.contiguous(), fe, fm)

    @staticmethod
    def backward(ctx, g):
        be, bm = ctx.fmt
        if (be, bm) != (8, 23):
            g = cast_to_format(g.contiguous(), be, bm)
        return g, None, None, None, None


def quantizer(forward_exp: int = 8, forward_man: int = 23,
              backward_exp: int = 8, backward_man: int = 23):
    """A function that quantizes activations on the forward pass and
    cotangents on the backward pass, with the identity where the format
    is (8, 23) (reference quant_function.py:33-57)."""
    _validate(forward_exp, forward_man)
    _validate(backward_exp, backward_man)

    def _round(x: torch.Tensor) -> torch.Tensor:
        return _Quantize.apply(x, forward_exp, forward_man, backward_exp,
                               backward_man)

    return _round


class _QuantizeSR(torch.autograd.Function):
    """SR cast on the forward pass at (fe, fm) with ``fold_in(key, 0)``,
    of the cotangent at (be, bm) with ``fold_in(key, 1)``; (8, 23) is the
    identity on its side."""

    @staticmethod
    def forward(ctx, x, key, fe, fm, be, bm):
        ctx.cfg = (key, be, bm)
        if (fe, fm) == (8, 23):
            return x.clone()
        return cast_to_format_sr(x.contiguous(), fe, fm, fold_in(key, 0))

    @staticmethod
    def backward(ctx, g):
        key, be, bm = ctx.cfg
        if (be, bm) != (8, 23):
            g = cast_to_format_sr(g.contiguous(), be, bm, fold_in(key, 1))
        return g, None, None, None, None, None


def quantizer_sr(forward_exp: int = 8, forward_man: int = 23,
                 backward_exp: int = 8, backward_man: int = 23):
    """Stochastic-rounding `quantizer`: ``fn(x, key)`` SR-casts the
    activations with ``fold_in(key, 0)`` and, on the backward pass, the
    cotangents with ``fold_in(key, 1)`` (`cpd_tpu/quant/quant_function.py`
    `quantizer_sr`); (8, 23) is the identity on either side."""
    _validate(forward_exp, forward_man)
    _validate(backward_exp, backward_man)

    def _round(x: torch.Tensor, key: tuple) -> torch.Tensor:
        return _QuantizeSR.apply(x, tuple(key), forward_exp, forward_man,
                                 backward_exp, backward_man)

    return _round


class _QuantizeStats(torch.autograd.Function):
    """`_Quantize` that also returns the forward cast's health vector and
    hands the backward cast's health vector back as the gradient of the
    ``tap`` input."""

    @staticmethod
    def forward(ctx, x, tap, fe, fm, be, bm):
        ctx.fmt = (be, bm)
        q = (x.clone() if (fe, fm) == (8, 23)
             else cast_to_format(x.contiguous(), fe, fm))
        h = _health_vec(x, q)
        ctx.mark_non_differentiable(h)
        return q, h

    @staticmethod
    def backward(ctx, g, _unused_health_grad):
        be, bm = ctx.fmt
        gq = g if (be, bm) == (8, 23) else cast_to_format(g.contiguous(),
                                                          be, bm)
        return gq, _health_vec(g, gq), None, None, None, None


def quantizer_stats(forward_exp: int = 8, forward_man: int = 23,
                    backward_exp: int = 8, backward_man: int = 23):
    """Stats-counting `quantizer`: ``fn(x, tap)`` with ``tap`` a float32
    (4,) tensor returns ``(y, fwd_health)``, ``y`` bitwise `quantizer`'s
    output and ``fwd_health`` the forward cast's [sat, underflow, nan,
    total].  The backward cast's health vector comes back as the gradient
    of ``tap`` (give it ``requires_grad``), ``x``'s gradient bitwise
    `quantizer`'s backward cast (`cpd_tpu/quant/quant_function.py`
    `quantizer_stats`)."""
    _validate(forward_exp, forward_man)
    _validate(backward_exp, backward_man)

    def _round(x: torch.Tensor, tap: torch.Tensor) -> tuple:
        return _QuantizeStats.apply(x, tap, forward_exp, forward_man,
                                    backward_exp, backward_man)

    return _round


def _health_dict(vec: torch.Tensor) -> dict:
    """An int64 or float (4,) count vector -> HEALTH_FIELDS float32
    scalars (exact below 2^24)."""
    vec = vec.to(torch.float32)
    return {f: vec[i] for i, f in enumerate(HEALTH_FIELDS)}


def _fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full fp32 (TF32 off on the card)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _gemm(a, b, exp, man, mode, rounding, key, with_stats):
    """The shared body of `qgemm` and `qgemm_stats` (and their
    ``(man, exp)`` shims)."""
    from ..ops import qgemm as ops

    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"quant_gemm expects (M,K)x(K,N); got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    sr = _validate_rounding(rounding, key)
    _validate(exp, man)
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if mode == "fast":
        out = _fp32_matmul(a, b)
        if (exp, man) == (8, 23):     # no cast ran: a counted no-op
            return (out, _health_dict(torch.zeros(4, device=out.device))
                    ) if with_stats else out
        cast = (cast_to_format_sr(out, exp, man, key) if sr
                else cast_to_format(out, exp, man))
        return (cast, quant_health(out, cast)) if with_stats else cast
    if mode != "faithful":
        raise ValueError(f"unknown quant_gemm mode: {mode!r}")
    if with_stats:
        out, counts = ops.qgemm_faithful_stats(a, b, exp, man,
                                               key=key if sr else None)
        return out, _health_dict(counts)
    if sr:
        return ops.qgemm_faithful_sr(a, b, exp, man, key)
    return ops.qgemm_faithful(a, b, exp, man)


def qgemm(a: torch.Tensor, b: torch.Tensor, exp: int = 8, man: int = 23,
          mode: str = "faithful", rounding: str = "nearest",
          key=None) -> torch.Tensor:
    """GEMM ``a @ b`` ((M, K) x (K, N)) with an eXmY accumulator, in the
    repo's (exp, man) order.

    ``faithful`` (default): for k = 0..K-1 in order, ``tmp = q(a·b)``,
    ``y = q(tmp - c)``, ``t = q(s + y)``, ``c = q(q(t - s) - y)``,
    ``s = t`` — K8 on a CUDA tensor, its plain scan on a CPU one, bitwise
    the JAX package's.  ``rounding="stochastic"`` (with ``key``) makes
    each cast SR, site s of step k on ``fold_in(fold_in(key, k), s)``'s
    bits (K8's SR arm).  ``fast``: the fp32 product (TF32 off), then one
    cast, SR on ``key``'s own bits.  Not differentiable by itself:
    `quant_module.quant_linear_fn` carries the reference's backward
    recipe."""
    return _gemm(a, b, exp, man, mode, rounding, key, False)


def qgemm_stats(a: torch.Tensor, b: torch.Tensor, exp: int = 8,
                man: int = 23, mode: str = "faithful",
                rounding: str = "nearest", key=None) -> tuple:
    """``(out, health)``: ``out`` bitwise `qgemm`'s and ``health`` the
    {sat, underflow, nan, total} float32 counters over every cast the
    mode performs — faithful: the five casts of every step (total =
    5·K·M·N, K8's stats arm counting exact int64s; equal to the JAX
    package's float32 running sums while 5·K·M·N < 2^24), fast: the one
    output cast (zeros at the (8, 23) no-cast shortcut)."""
    return _gemm(a, b, exp, man, mode, rounding, key, True)


def quant_gemm(a: torch.Tensor, b: torch.Tensor, man: int = 23,
               exp: int = 8, mode: str = "faithful",
               rounding: str = "nearest", key=None) -> torch.Tensor:
    """`qgemm` in the reference's positional ``(man, exp)`` order
    (quant_function.py:78-98), the JAX package's back-compat shim."""
    return qgemm(a, b, exp=exp, man=man, mode=mode, rounding=rounding,
                 key=key)


def quant_gemm_stats(a: torch.Tensor, b: torch.Tensor, man: int = 23,
                     exp: int = 8, mode: str = "faithful",
                     rounding: str = "nearest", key=None) -> tuple:
    """`qgemm_stats` in the reference's ``(man, exp)`` order."""
    return qgemm_stats(a, b, exp=exp, man=man, mode=mode,
                       rounding=rounding, key=key)
