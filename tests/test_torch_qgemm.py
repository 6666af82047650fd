"""The port's quant API and quantized layers vs the JAX package.

BITWISE throughout, unless a docstring says otherwise: `float_quantize`
(RTNE and SR), `quantizer` forward and backward, the plain faithful
`qgemm` (K8's plain version) against JAX `qgemm(mode="faithful")` and
`qgemm_pallas` in interpret mode, and `quant_linear_fn`/`QuantDense`'s
output and gradients against the JAX custom_vjp.  ``fast`` mode
(an fp32 product in another summation order, then one cast) is held to
one ulp of the format.  Inputs come from seeded numpy with magnitudes
that keep every product |a·b| a normal fp32 number: XLA:CPU flushes
subnormal products to zero (ROADMAP Queue C), the port and the card do
not.  The K8 kernel itself needs the card: the ``cuda``-marked test
holds it to its plain version and to the generic kernel it replaced.
Its cast through the fp32 adder (``exmy::cast_fadd``) is modelled here
in numpy, from the constants the wrapper hands the kernel, and held
bitwise to `cast_body` for every format it serves on inputs at every
rounding boundary (``qgemm.cast_probe_patterns``, the card probe's
patterns).
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.ops.qgemm import qgemm_pallas
from cpd_tpu.quant import quant_function as jqf
from cpd_tpu.quant import quant_module as jqm
from cpd_tpu_torch.ops import qgemm as tqg
from cpd_tpu_torch.quant import prng
from cpd_tpu_torch.quant import quant_function as tqf
from cpd_tpu_torch.quant import quant_module as tqm
from cpd_tpu_torch.quant.numerics import cast_body, max_finite
from test_torch_threads import one_torch_thread  # noqa: F401

FORMATS = [(4, 3), (5, 2), (8, 23), (5, 10), (2, 1)]
# (M, K, N): odd tails, K = 1, and a K past the kernel's 32-step chunk
SHAPES = [(37, 29, 23), (5, 33, 40), (1, 1, 1)]
# past the tile kernel's 32 x 32 outputs in M and N, K past two chunks
TILE_SHAPES = [(70, 65, 33), (33, 40, 70)]
EXMY = os.path.join(os.path.dirname(tqg.__file__), "..", "csrc", "exmy.cuh")


def _bitwise(want, got, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert want.shape == got.shape, (want.shape, got.shape, msg)
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32),
                                  err_msg=msg)


def _operand(rng, shape, fmt):
    """Signed values with magnitudes in [2^-3, 2^3) at a small format's
    scale (so the (2,1) and (4,3) scans saturate and carry), every
    product a normal fp32 number."""
    scale = min(1.0, max_finite(*fmt) / 16)
    mag = rng.uniform(1.0, 2.0, shape) * 2.0 ** rng.integers(-3, 3, shape)
    sign = rng.choice([-1.0, 1.0], shape)
    return (sign * mag * scale).astype(np.float32)


def test_float_quantize_rtne_and_sr_bitwise():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((7, 129)) * 3).astype(np.float32)
    x[0, :6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e30]
    for fmt in [(4, 3), (5, 2), (8, 23), (2, 1)]:
        _bitwise(jqf.float_quantize(jnp.asarray(x), *fmt),
                 tqf.float_quantize(torch.from_numpy(x), *fmt), str(fmt))
        want = jqf.float_quantize(jnp.asarray(x), *fmt,
                                  rounding="stochastic",
                                  key=jax.random.PRNGKey(11))
        got = tqf.float_quantize(torch.from_numpy(x), *fmt,
                                 rounding="stochastic",
                                 key=prng.PRNGKey(11))
        _bitwise(want, got, f"SR {fmt}")
    with pytest.raises(ValueError, match="stochastic"):
        tqf.float_quantize(torch.from_numpy(x), 5, 2, key=prng.PRNGKey(0))
    with pytest.raises(ValueError, match="requires a PRNG key"):
        tqf.float_quantize(torch.from_numpy(x), 5, 2, rounding="stochastic")


@pytest.mark.parametrize("fwd,bwd", [((5, 2), (4, 3)), ((8, 23), (5, 2)),
                                     ((4, 3), (8, 23))])
def test_quantizer_forward_and_backward_bitwise(fwd, bwd):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((5, 33)) * 2).astype(np.float32)
    g = (rng.standard_normal((5, 33)) * 2).astype(np.float32)
    jfn = jqf.quantizer(*fwd, *bwd)
    y, vjp = jax.vjp(jfn, jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    yt = tqf.quantizer(*fwd, *bwd)(xt)
    yt.backward(torch.from_numpy(g))
    _bitwise(y, yt, "forward")
    _bitwise(gx, xt.grad, "backward")


@pytest.mark.parametrize("fmt", FORMATS)
def test_faithful_qgemm_bitwise_vs_jax(fmt):
    """The plain scan == JAX qgemm(mode="faithful") at every shape, and
    == qgemm_pallas in interpret mode at the first."""
    rng = np.random.default_rng(sum(fmt))
    for i, (m, k, n) in enumerate(SHAPES):
        a, b = _operand(rng, (m, k), fmt), _operand(rng, (k, n), fmt)
        got = tqf.qgemm(torch.from_numpy(a), torch.from_numpy(b), *fmt)
        want = jqf.qgemm(jnp.asarray(a), jnp.asarray(b), exp=fmt[0],
                         man=fmt[1])
        _bitwise(want, got, f"{fmt} {(m, k, n)}")
        # the reference's (man, exp) order
        _bitwise(want, tqf.quant_gemm(torch.from_numpy(a),
                                      torch.from_numpy(b), fmt[1], fmt[0]))
        if i == 0:
            pal = qgemm_pallas(jnp.asarray(a), jnp.asarray(b), fmt[0],
                               fmt[1], True)
            _bitwise(pal, got, f"pallas {fmt}")


def test_faithful_qgemm_saturates_and_carries():
    """Values past the format's max (Inf, and Inf - Inf = NaN in the Kahan
    term), at the carry, and products that land on the format's
    subnormals: still bitwise JAX, NaN bits included (e4m3)."""
    fmt = (4, 3)
    mf = max_finite(*fmt)
    a = np.array([[mf, 2 * mf, 0.5, 1.0, -mf],
                  [2.0 ** -7, 3 * 2.0 ** -8, 1.0, -0.25, 2.0 ** -3]],
                 np.float32)
    b = np.array([[1.0, 0.5], [1.0, -1.0], [2.0 ** -6, 1.0],
                  [2.0 ** -9, 0.125], [0.0625, 1.0]], np.float32)
    got = tqf.qgemm(torch.from_numpy(a), torch.from_numpy(b), *fmt)
    want = jqf.qgemm(jnp.asarray(a), jnp.asarray(b), exp=fmt[0], man=fmt[1])
    _bitwise(want, got)
    assert np.isnan(got.numpy()).any() and np.isfinite(got.numpy()).any()


@pytest.mark.parametrize("fmt", [(4, 3), (5, 2), (8, 23)])
def test_fast_qgemm_within_one_ulp(fmt):
    """fast mode: the fp32 product then one cast; the products sum in
    another order than XLA's, so a cast may round to the neighbouring
    value of the format: within one ulp of the format (exact at
    (8, 23) up to the fp32 sums' round-off, 1e-5 relative)."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((33, 70)).astype(np.float32)
    b = rng.standard_normal((70, 17)).astype(np.float32)
    got = tqf.qgemm(torch.from_numpy(a), torch.from_numpy(b), *fmt,
                    mode="fast").numpy()
    want = np.asarray(jqf.qgemm(jnp.asarray(a), jnp.asarray(b), exp=fmt[0],
                                man=fmt[1], mode="fast"))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                  - fmt[1])
    if fmt == (8, 23):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert (np.abs(got - want) <= ulp).all()


def test_unported_qgemm_options_raise():
    a = torch.ones((2, 3))
    b = torch.ones((3, 2))
    with pytest.raises(ValueError, match="mode"):
        tqf.qgemm(a, b, 5, 2, mode="exact")
    with pytest.raises(ValueError, match=r"\(M,K\)x\(K,N\)"):
        tqf.qgemm(a, a, 5, 2)


@pytest.mark.parametrize("fmt", [(4, 3), (5, 2)])
def test_quant_linear_fn_bitwise_vs_custom_vjp(fmt):
    """y = x Wᵀ + b and its three gradients, each a faithful qgemm (grad_b
    the cast of g.sum(0)): bitwise the JAX custom_vjp.  g holds small
    multiples of 2^-4, so its column sums are exact in any order."""
    rng = np.random.default_rng(4)
    x = _operand(rng, (9, 13), fmt)
    w = _operand(rng, (6, 13), fmt)
    bias = _operand(rng, (6,), fmt)
    g = (rng.integers(-16, 17, (9, 6)) / 16.0).astype(np.float32)
    y, vjp = jax.vjp(lambda x_, w_, b_: jqm.quant_linear_fn(
        x_, w_, b_, *fmt, "faithful"), jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(bias))
    gx, gw, gb = vjp(jnp.asarray(g))
    xt, wt, bt = (torch.from_numpy(t).requires_grad_() for t in (x, w, bias))
    yt = tqm.quant_linear_fn(xt, wt, bt, *fmt, "faithful")
    yt.backward(torch.from_numpy(g))
    _bitwise(y, yt, "y")
    _bitwise(gx, xt.grad, "grad_x")
    _bitwise(gw, wt.grad, "grad_w")
    _bitwise(gb, bt.grad, "grad_b")
    assert wt.grad.is_contiguous()


@pytest.mark.parametrize("use_bias", [False, True])
def test_quant_dense_bitwise_vs_flax(use_bias):
    """QuantDense (flax layout, kernel (in, out)) on a (2, 5, 12) input:
    output and the kernel, input (and bias) gradients bitwise flax's.  g
    holds small multiples of 2^-4, so the bias gradient's column sums
    are exact in any order."""
    fmt = (4, 3)
    rng = np.random.default_rng(5)
    x = _operand(rng, (2, 5, 12), fmt)
    params = {"kernel": _operand(rng, (12, 7), fmt)}
    if use_bias:
        params["bias"] = _operand(rng, (7,), fmt)
    g = (rng.integers(-16, 17, (2, 5, 7)) / 16.0).astype(np.float32)
    jd = jqm.QuantDense(7, use_bias=use_bias, exp=fmt[0], man=fmt[1])
    y, vjp = jax.vjp(lambda p_, x_: jd.apply({"params": p_}, x_),
                     {k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    td = tqm.QuantDense(12, 7, exp=fmt[0], man=fmt[1], use_bias=use_bias)
    with torch.no_grad():
        for name, v in params.items():
            getattr(td, name).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_()
    yt = td(xt)
    yt.backward(torch.from_numpy(g))
    _bitwise(y, yt, "y")
    _bitwise(gx, xt.grad, "grad_x")
    for name in params:
        _bitwise(gp[name], getattr(td, name).grad, f"grad_{name}")
    assert sorted(n for n, _ in td.named_parameters()) == sorted(params)
    # the kernel gradient lies in the kernel's layout: the card's casts
    # take contiguous tensors only
    assert td.kernel.grad.is_contiguous()


def test_quant_linear_module():
    """QuantLinear: (out, in) weight and kaiming-uniform init within
    ±1/sqrt(in); its forward is quant_linear_fn's, 1-D input squeezed."""
    gen = torch.Generator().manual_seed(0)
    ql = tqm.QuantLinear(16, 4, exp=5, man=2, generator=gen)
    assert ql.weight.shape == (4, 16) and ql.bias.shape == (4,)
    assert float(ql.weight.detach().abs().max()) <= 0.25
    x = torch.randn(3, 16, generator=gen)
    want = tqm.quant_linear_fn(x, ql.weight, ql.bias, 5, 2)
    assert torch.equal(ql(x), want)
    assert torch.equal(ql(x[0]), want[0])


@pytest.mark.parametrize("fmt", [(4, 3), (5, 2), (2, 1), (8, 23)])
def test_faithful_qgemm_tile_tails_bitwise_vs_jax(fmt):
    """The plain scan == JAX qgemm(mode="faithful") at shapes that cut the
    tile kernel's 32-output M and N tails and cross its 32-step K chunk
    twice."""
    rng = np.random.default_rng(10 + sum(fmt))
    for m, k, n in TILE_SHAPES:
        a, b = _operand(rng, (m, k), fmt), _operand(rng, (k, n), fmt)
        _bitwise(jqf.qgemm(jnp.asarray(a), jnp.asarray(b), exp=fmt[0],
                           man=fmt[1]),
                 tqf.qgemm(torch.from_numpy(a), torch.from_numpy(b), *fmt),
                 f"{fmt} {(m, k, n)}")


def _u32(x):
    return np.uint32(x)


def _add_rz(x, c):
    """fp32 x + c rounded toward zero (the card's __fadd_rz), through
    float64: exact here but for addends far below c's ulp, where the
    float64 error cannot cross an fp32 boundary either."""
    exact = x.astype(np.float64) + c.astype(np.float64)
    r = exact.astype(np.float32)
    return np.where(np.abs(r.astype(np.float64)) > np.abs(exact),
                    np.nextafter(r, np.float32(0)), r)


def cast_fadd_model(bits, f):
    """``exmy::cast_fadd<true>`` in numpy fp32 (round to nearest even):
    ct = ±max(|x|, norm), xt = (x +rz ct) - ct, m = (ct's sign and
    exponent) * kmul, r = (xt + m) - m, the sign ORed back; and the flag
    (|x| >= sat, or an fp32 subnormal) where the kernel drops the result
    and redoes the step with the reference cast."""
    u = bits & _u32(0x7FFFFFFF)
    sign = bits & _u32(0x80000000)
    flag = (u >= _u32(f.sat)) | (u - _u32(1) < _u32(0x7FFFFF))
    ct = np.maximum(u, _u32(f.norm)) | sign
    ctf = ct.view(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        m = (ct & _u32(0xFF800000)).view(np.float32) * np.float32(f.kmul)
        xt = _add_rz(bits.view(np.float32), ctf) - ctf
        r = (xt + m) - m
    return r.view(np.uint32) | sign, flag


@pytest.mark.parametrize("exp_bits", range(1, 9))
def test_bit_pattern_casts_bitwise_vs_cast_body(exp_bits):
    """For every man_bits, on 65536 patterns at the format's rounding
    boundaries (`cast_probe_patterns`): below ``tiny`` (the kernel's zero
    step) `cast_body` gives a zero, and within a binade above it not
    always; where ``fadd`` (eb <= 7, mb <= 21) the numpy model of
    cast_fadd, run from `cast_constants`, == `cast_body` bitwise on every
    input it does not flag, and it flags exactly |x| >= sat and fp32
    subnormals (other formats take the reference cast itself)."""
    for man_bits in range(24):
        f = tqg.cast_constants(exp_bits, man_bits)
        bits = tqg.cast_probe_patterns(exp_bits, man_bits)
        want = cast_body(torch.from_numpy(bits.view(np.int32)).view(
            torch.float32), exp_bits, man_bits).view(torch.int32).numpy(
            ).view(np.uint32)
        fmt = (exp_bits, man_bits)
        # below ``tiny`` every input casts to a zero: the kernel's zero
        # step takes ±0 -> itself, fp32 subnormals -> +0.0, the rest ->
        # the signed zero
        u = bits & _u32(0x7FFFFFFF)
        low = u < f.tiny
        zero = np.where(u == 0, bits, np.where(u < 0x800000, _u32(0),
                                               bits & _u32(0x80000000)))
        np.testing.assert_array_equal(want[low], zero[low],
                                      err_msg=f"tiny {fmt}")
        assert f.tiny >= 0x800000 and (u[~low] >= f.tiny).all()
        nonzero = (want & _u32(0x7FFFFFFF)) != 0
        near = (u >> 23) - (f.tiny >> 23) <= 1
        assert nonzero[near].any() or f.tiny == 0x800000, (
            f"tiny {fmt}: nothing within a binade above it casts to "
            "a nonzero")
        assert f.fadd == (exp_bits <= 7 and man_bits <= 21)
        if not f.fadd:
            continue
        got, flag = cast_fadd_model(bits, f)
        np.testing.assert_array_equal(got[~flag], want[~flag],
                                      err_msg=f"cast_fadd {fmt}")
        u = bits & _u32(0x7FFFFFFF)
        special = (u >= f.sat) | ((u > 0) & (u < 0x800000))
        np.testing.assert_array_equal(flag, special)


@pytest.mark.parametrize("fmt", [(4, 3), (2, 1), (5, 10), (7, 21)])
def test_scan_feeds_no_subnormal_to_the_later_casts(fmt):
    """cast_fadd<false> serves the step's four casts after the product:
    their inputs (tmp - c, s + y, t - s, q(t - s) - y) are sums of cast
    outputs, never fp32 subnormals, even where products are tiny or
    subnormal; the plain scan's own values, recorded."""
    rng = np.random.default_rng(sum(fmt))
    a = (rng.standard_normal((16, 40)) * 2.0 ** rng.integers(
        -70, 8, (16, 40))).astype(np.float32)
    b = (rng.standard_normal((40, 16)) * 2.0 ** rng.integers(
        -70, 8, (40, 16))).astype(np.float32)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    s = torch.zeros((16, 16))
    c = torch.zeros_like(s)
    seen = []

    def q(x, record=True):
        if record:
            seen.append(x.clone())
        return cast_body(x, *fmt)

    for k in range(40):
        tmp = q(at[:, k, None] * bt[None, k, :], record=False)
        y = q(tmp - c)
        t = q(s + y)
        c = q(q(t - s) - y)
        s = t
    u = torch.stack(seen).view(torch.int32) & 0x7FFFFFFF
    assert bool(((u > 0) & (u < 0x800000)).any()) is False
    products = (at[:, :, None] * bt[None]).view(torch.int32) & 0x7FFFFFFF
    assert bool(((products > 0) & (products < 0x800000)).any())


def test_cast_constants_struct_is_exmy_castbits():
    """`qgemm.CastBits` (the ctypes struct the wrapper passes by value)
    lists ``exmy::CastBits``'s fields in order with the same types, and
    the launchers' C signatures have as many parameters as the argtypes
    the wrapper sets."""
    src = open(EXMY).read()
    body = re.search(r"struct CastBits \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*(uint32_t|int32_t|float)\s+(\w+);", body, re.M)
    ctype = {"uint32_t": ctypes.c_uint32, "int32_t": ctypes.c_int32,
             "float": ctypes.c_float}
    assert [(n, ctype[t]) for t, n in fields] == tqg.CastBits._fields_
    cu = open(os.path.join(os.path.dirname(EXMY), "qgemm.cu")).read()
    for name, n_args in (("qgemm_launch", 8), ("qgemm_generic_launch", 9)):
        sig = re.search(rf'extern "C" int {name}\((.*?)\)', cu, re.S)
        assert len(sig.group(1).split(",")) == n_args, name


def test_generic_launcher_takes_cuda_tensors_only():
    launch = tqg.generic_launcher()
    with pytest.raises(ValueError, match="CUDA tensors"):
        launch(torch.ones((2, 3)), torch.ones((3, 2)), 4, 3)


@pytest.mark.cuda
def test_qgemm_kernel_bitwise_vs_plain_on_card():
    """K8 on the card == its plain version and == the generic kernel it
    replaced, bitwise, over the formats and the odd and tile-cutting
    shapes, on inputs that saturate, carry and underflow."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    generic = tqg.generic_launcher()
    for fmt in FORMATS:
        for m, k, n in SHAPES + TILE_SHAPES + [(300, 129, 200)]:
            a = torch.randn((m, k), generator=gen, device="cuda") * 8
            b = torch.randn((k, n), generator=gen, device="cuda")
            got = tqg.qgemm_faithful(a, b, *fmt)
            torch.cuda.synchronize()
            want = tqg.qgemm_faithful_ref(a, b, *fmt)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (fmt, m, k, n)
            assert torch.equal(got.view(torch.int32),
                               generic(a, b, *fmt).view(torch.int32)), (
                "generic", fmt, m, k, n)
