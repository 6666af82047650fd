"""Custom-precision quantization API (port of
`cpd_tpu/quant/quant_function.py`: `float_quantize`, `quantizer`, `qgemm`
and the `quant_gemm` shim, round-to-nearest GEMMs).

* `float_quantize` — the eXmY cast, RTNE (K1 on a CUDA tensor) or
  stochastic with a `prng` key (K2);
* `quantizer` — a function quantizing activations on the forward pass
  and cotangents on the backward pass (a `torch.autograd.Function`), with
  the identity at (8, 23) on either side;
* `qgemm(a, b, exp, man, mode)` — a GEMM with an eXmY accumulator:
  ``faithful`` runs the quantized Kahan scan (K8, `ops.qgemm`) for every
  format, (8, 23) included, since the cast still flushes fp32
  subnormal intermediates there; ``fast`` is an fp32 product with TF32
  off, then one RTNE cast (none at (8, 23));
* `quant_gemm(a, b, man, exp, mode)` — the reference's ``(man, exp)``
  argument order, kept as the JAX package keeps it.

Stochastically rounded GEMMs, `quantizer_sr` and the ``_stats`` twins are
not ported yet and raise.
"""

from __future__ import annotations

import torch

from .numerics import _validate, cast_to_format, cast_to_format_sr

__all__ = ["float_quantize", "quantizer", "qgemm", "quant_gemm"]


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


def qgemm(a: torch.Tensor, b: torch.Tensor, exp: int = 8, man: int = 23,
          mode: str = "faithful", rounding: str = "nearest",
          key=None) -> torch.Tensor:
    """GEMM ``a @ b`` ((M, K) x (K, N)) with an eXmY accumulator, in the
    repo's (exp, man) order.

    ``faithful`` (default): for k = 0..K-1 in order, ``tmp = q(a·b)``,
    ``y = q(tmp - c)``, ``t = q(s + y)``, ``c = q(q(t - s) - y)``,
    ``s = t`` — K8 on a CUDA tensor, its plain scan on a CPU one, bitwise
    the JAX package's.  ``fast``: the fp32 product (TF32 off), then one
    cast.  Not differentiable by itself: `quant_module.quant_linear_fn`
    carries the reference's backward recipe."""
    from ..ops.qgemm import qgemm_faithful

    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"quant_gemm expects (M,K)x(K,N); got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if _validate_rounding(rounding, key):
        raise NotImplementedError(
            "rounding='stochastic' qgemm is not ported yet (its per-(k, "
            "site) key schedule; ROADMAP Queue A, A2)")
    _validate(exp, man)
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if mode == "fast":
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            out = a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        if (exp, man) == (8, 23):
            return out
        return cast_to_format(out, exp, man)
    if mode != "faithful":
        raise ValueError(f"unknown quant_gemm mode: {mode!r}")
    return qgemm_faithful(a, b, exp, man)


def quant_gemm(a: torch.Tensor, b: torch.Tensor, man: int = 23,
               exp: int = 8, mode: str = "faithful",
               rounding: str = "nearest", key=None) -> torch.Tensor:
    """`qgemm` in the reference's positional ``(man, exp)`` order
    (quant_function.py:78-98), the JAX package's back-compat shim."""
    return qgemm(a, b, exp=exp, man=man, mode=mode, rounding=rounding,
                 key=key)
