"""The rest of the port's quant package vs the JAX package, on the CPU.

BITWISE unless a docstring says otherwise, on seeded numpy inputs:

* SR `qgemm`/`quant_gemm`, faithful (the plain SR scan: bits of
  ``fold_in(fold_in(key, k), site)`` at each of the five cast sites of
  step k) and fast (fp32 product, then one SR cast on the key's bits;
  its inputs are small dyadic numbers, so the fp32 sums are exact in any
  order and the cast sees the same value as JAX's);
* the ``_stats`` twins: products bitwise the plain GEMM, counts equal to
  JAX's float32 running sums (exact: every total here is far below
  2^24), RTNE and SR, faithful and fast, with a saturating row;
* `float_quantize_stats`, `tree_quant_health`;
* `quantizer_sr` and `quantizer_stats` forward and backward (the tap's
  gradient) against ``jax.vjp``;
* `Quantizer`, `QuantLinear`, `QuantDense` with SR against the flax
  modules, the flax ``'sr'`` key recorded by wrapping
  ``cpd_tpu.quant.quant_module._rng_key_data`` with ``monkeypatch`` and
  handed to the port;
* `QuantConv` over stride/padding, dilation x groups and SR groups:
  forward, weight and bias gradients bitwise; the input gradient bitwise
  where windows do not overlap (stride >= the dilated span), and within
  2^-20 of the gradient's largest magnitude where they do (torch's
  col2im and XLA's transposed convolution add each pixel's up to k^2
  fp32 terms in different orders);
* `cast_oracle`, `cast_oracle_sr`, `kv_pool_bytes`, the package's
  ``__all__``.

Operands keep every product a normal fp32 number (XLA:CPU flushes
subnormals, ROADMAP Queue C).  Each layer's JAX parameters reach the
port through `interop.load_jax_params`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpd_tpu.quant as jquant
from cpd_tpu.quant import numerics as jnum
from cpd_tpu.quant import quant_function as jqf
from cpd_tpu.quant import quant_module as jqm
import cpd_tpu_torch.quant as tquant
from cpd_tpu_torch.interop import load_jax_params
from cpd_tpu_torch.quant import numerics as tnum
from cpd_tpu_torch.quant import quant_function as tqf
from cpd_tpu_torch.quant import quant_module as tqm
from test_torch_threads import one_torch_thread  # noqa: F401

FORMATS = [(4, 3), (5, 2), (8, 23)]


def _bitwise(want, got, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert want.shape == got.shape, (want.shape, got.shape, msg)
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32),
                                  err_msg=msg)


def _pair(jkey) -> tuple:
    """A JAX key (typed or raw) -> the port's (k0, k1) pair."""
    if jnp.issubdtype(jnp.asarray(jkey).dtype, jax.dtypes.prng_key):
        jkey = jax.random.key_data(jkey)
    return tuple(int(v) for v in np.asarray(jkey).reshape(-1))


def _operand(rng, shape, scale=1.0):
    """Signed values with magnitudes in [2^-3, 2^3) x scale: every product
    a normal fp32 number."""
    mag = rng.uniform(1.0, 2.0, shape) * 2.0 ** rng.integers(-3, 3, shape)
    return (rng.choice([-1.0, 1.0], shape) * mag * scale).astype(np.float32)


def _dyadic(rng, shape):
    """Small multiples of 2^-4: fp32 products and sums exact in any
    order at these sizes."""
    return (rng.integers(-16, 17, shape) / 16.0).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _health(h):
    return {k: float(v) for k, v in h.items()}


# ----------------------------------------------------------- SR qgemm


@pytest.mark.parametrize("fmt", FORMATS)
def test_sr_qgemm_faithful_and_fast_bitwise_vs_jax(fmt):
    rng = np.random.default_rng(sum(fmt))
    jkey = jax.random.PRNGKey(7)
    key = _pair(jkey)
    a, b = _operand(rng, (37, 29)), _operand(rng, (29, 23))
    want = jqf.qgemm(jnp.asarray(a), jnp.asarray(b), exp=fmt[0],
                     man=fmt[1], rounding="stochastic", key=jkey)
    got = tqf.qgemm(_t(a), _t(b), *fmt, rounding="stochastic", key=key)
    _bitwise(want, got, f"faithful {fmt}")
    # the (man, exp) shim, and a key that changes the bits
    _bitwise(want, tqf.quant_gemm(_t(a), _t(b), fmt[1], fmt[0],
                                  rounding="stochastic", key=key))
    other = tqf.qgemm(_t(a), _t(b), *fmt, rounding="stochastic",
                      key=_pair(jax.random.PRNGKey(8)))
    assert fmt == (8, 23) or not torch.equal(got, other)
    # fast: exact fp32 products and sums, then one SR cast on key's bits
    a, b = _dyadic(rng, (9, 40)), _dyadic(rng, (40, 11)) * 3
    want = jqf.qgemm(jnp.asarray(a), jnp.asarray(b), exp=fmt[0],
                     man=fmt[1], mode="fast", rounding="stochastic",
                     key=jkey)
    _bitwise(want, tqf.qgemm(_t(a), _t(b), *fmt, mode="fast",
                             rounding="stochastic", key=key), f"fast {fmt}")


def test_sr_qgemm_key_contract_and_mean():
    """A key is required for SR and refused for RTNE; the SR scan's mean
    over 512 independent columns sits near the exact dot (the JAX
    package's unbiasedness case), every output an e4m3 value."""
    a, b = torch.ones((2, 3)), torch.ones((3, 2))
    with pytest.raises(ValueError, match="requires a PRNG key"):
        tqf.qgemm(a, b, 4, 3, rounding="stochastic")
    with pytest.raises(ValueError, match="ignore"):
        tqf.qgemm(a, b, 4, 3, key=(0, 1))
    ulp = 2.0 ** -3
    col = np.concatenate([[1.0], np.full(10, ulp / 8)]).astype(np.float32)
    sr = tqf.qgemm(_t(col[None, :]), torch.ones((11, 512)), 4, 3,
                   rounding="stochastic", key=(0, 0))
    assert abs(float(sr.mean()) - 1.15625) < 0.05
    assert torch.equal(tnum.cast_body(sr, 4, 3), sr)


# ------------------------------------------------------------ stats twins


@pytest.mark.parametrize("mode", ["faithful", "fast"])
def test_stats_twins_bitwise_and_counts_vs_jax(mode):
    """tests/test_precision.py's cases: (4, 3) at (4, 6) x (6, 5), a row
    of 1e6 that saturates the accumulator, RTNE and SR: products bitwise
    the plain GEMM and JAX's, counters equal to JAX's; fast at (8, 23)
    is a counted no-op."""
    rng = np.random.RandomState(0)
    a = rng.randn(4, 6).astype(np.float32)
    b = rng.randn(6, 5).astype(np.float32)
    a_hot = a.copy()
    a_hot[0] = 1e6
    jkey = jax.random.PRNGKey(5)
    for x, rounding in ((a, "nearest"), (a_hot, "nearest"),
                        (a, "stochastic"), (a_hot, "stochastic")):
        jk = jkey if rounding == "stochastic" else None
        tk = _pair(jkey) if jk is not None else None
        want, wh = jqf.quant_gemm_stats(jnp.asarray(x), jnp.asarray(b),
                                        man=3, exp=4, mode=mode,
                                        rounding=rounding, key=jk)
        got, gh = tqf.quant_gemm_stats(_t(x), _t(b), 3, 4, mode=mode,
                                       rounding=rounding, key=tk)
        plain = tqf.qgemm(_t(x), _t(b), 4, 3, mode=mode, rounding=rounding,
                          key=tk)
        assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
        if mode == "faithful":
            _bitwise(want, got, rounding)
        assert _health(gh) == _health(wh), (rounding, gh, wh)
        if x is a_hot:
            assert float(gh["sat"]) > 0
        else:
            want_total = 5 * 6 * 4 * 5 if mode == "faithful" else 4 * 5
            assert float(gh["total"]) == want_total
    _, gh = tqf.qgemm_stats(_t(a), _t(b), 8, 23, mode=mode)
    _, wh = jqf.qgemm_stats(jnp.asarray(a), jnp.asarray(b), exp=8, man=23,
                            mode=mode)
    assert _health(gh) == _health(wh)


def test_stats_twins_count_underflows_at_small_formats():
    """A scan whose products land below (2, 1)'s and (4, 3)'s subnormals
    (zero steps on the card) and whose sums saturate: counts equal JAX's
    and the products bitwise, RTNE and SR."""
    rng = np.random.default_rng(11)
    a = _operand(rng, (9, 33), 2.0 ** -3)
    a[1] *= 2.0 ** 6
    b = _operand(rng, (33, 7), 2.0 ** -2)
    for fmt in [(2, 1), (4, 3)]:
        for jk in (None, jax.random.PRNGKey(3)):
            rounding = "nearest" if jk is None else "stochastic"
            want, wh = jqf.qgemm_stats(jnp.asarray(a), jnp.asarray(b),
                                       exp=fmt[0], man=fmt[1],
                                       rounding=rounding, key=jk)
            got, gh = tqf.qgemm_stats(_t(a), _t(b), *fmt, rounding=rounding,
                                      key=None if jk is None else _pair(jk))
            _bitwise(want, got, f"{fmt} {rounding}")
            assert _health(gh) == _health(wh), (fmt, rounding, gh, wh)
            assert float(gh["underflow"]) > 0


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_float_quantize_stats_and_tree_health(rounding):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((5, 40)) * 8).astype(np.float32)
    x[0, :5] = [np.inf, np.nan, 1e6, 1e-6, 0.0]
    jk = jax.random.PRNGKey(4) if rounding == "stochastic" else None
    tk = None if jk is None else _pair(jk)
    wq, wh = jqf.float_quantize_stats(jnp.asarray(x), 4, 3,
                                      rounding=rounding, key=jk)
    gq, gh = tqf.float_quantize_stats(_t(x), 4, 3, rounding=rounding,
                                      key=tk)
    _bitwise(wq, gq)
    assert _health(gh) == _health(wh)
    before = {"b": _t(x[1:]), "a": [_t(x[:1])]}
    after = {"b": tnum.cast_body(_t(x[1:]), 4, 3),
             "a": [tnum.cast_body(_t(x[:1]), 4, 3)]}
    want = jqf.tree_quant_health(
        {"b": jnp.asarray(x[1:]), "a": [jnp.asarray(x[:1])]},
        {k: jax.tree.map(lambda t: jnp.asarray(t.numpy()), v)
         for k, v in after.items()})
    assert _health(tqf.tree_quant_health(before, after)) == _health(want)
    assert _health(tqf.tree_quant_health({}, {})) == {
        "sat": 0.0, "underflow": 0.0, "nan": 0.0, "total": 0.0}


# -------------------------------------------------------------- quantizers


@pytest.mark.parametrize("fwd,bwd", [((4, 3), (5, 2)), ((8, 23), (4, 3)),
                                     ((5, 2), (8, 23))])
def test_quantizer_sr_and_stats_vs_jax_vjp(fwd, bwd):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 35)) * 4).astype(np.float32)
    g = (rng.standard_normal((6, 35)) * 4).astype(np.float32)
    x[0, :3] = [1e6, np.inf, 1e-7]
    jkey = jax.random.PRNGKey(12)
    kd = jax.random.key_data(jkey)
    y, vjp = jax.vjp(lambda t: jqf.quantizer_sr(*fwd, *bwd)(t, kd),
                     jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    yt = tqf.quantizer_sr(*fwd, *bwd)(xt, _pair(jkey))
    yt.backward(_t(g))
    _bitwise(y, yt, "SR forward")
    _bitwise(gx, xt.grad, "SR backward")

    (y, fh), vjp = jax.vjp(jqf.quantizer_stats(*fwd, *bwd), jnp.asarray(x),
                           jnp.zeros(4, jnp.float32))
    gx, bh = vjp((jnp.asarray(g), jnp.zeros(4, jnp.float32)))
    xt = _t(x).requires_grad_()
    tap = torch.zeros(4, requires_grad=True)
    yt, fht = tqf.quantizer_stats(*fwd, *bwd)(xt, tap)
    yt.backward(_t(g))
    _bitwise(y, yt, "stats forward")
    _bitwise(fh, fht, "forward health")
    _bitwise(gx, xt.grad, "stats backward")
    _bitwise(bh, tap.grad, "backward health (the tap's gradient)")


# -------------------------------------------------------------- modules


@pytest.fixture
def flax_keys(monkeypatch):
    """Records every key the flax modules draw from their 'sr' stream."""
    seen = []
    real = jqm._rng_key_data

    def recording(module, rounding):
        kd = real(module, rounding)
        if kd is not None:
            seen.append(_pair(kd))
        return kd

    monkeypatch.setattr(jqm, "_rng_key_data", recording)
    return seen


def _flax_vjp(module, params, x, g, sr_seed):
    rngs = {"sr": jax.random.PRNGKey(sr_seed)}
    y, vjp = jax.vjp(lambda p, t: module.apply({"params": p}, t, rngs=rngs),
                     jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    return y, gp, gx


def _port_grads(module, x, g, key):
    xt = _t(x).requires_grad_()
    y = module(xt, key=key)
    y.backward(_t(g))
    return y, {n: p.grad for n, p in module.named_parameters()}, xt.grad


def test_quantizer_module_sr_vs_flax(flax_keys):
    rng = np.random.default_rng(35)
    x = (rng.standard_normal((4, 32)) * 3).astype(np.float32)
    g = (rng.standard_normal((4, 32)) * 3).astype(np.float32)
    jm = jqm.Quantizer(4, 3, 5, 2, rounding="stochastic")
    y, _, gx = _flax_vjp(jm, {}, x, g, 2)
    tm = tqm.Quantizer(4, 3, 5, 2, rounding="stochastic")
    yt, _, gxt = _port_grads(tm, x, g, flax_keys[-1])
    _bitwise(y, yt, "forward")
    _bitwise(gx, gxt, "backward")
    with pytest.raises(ValueError, match="needs a key"):
        tm(_t(x))
    # round to nearest ignores a key, as flax ignores an unused stream
    _bitwise(jqf.quantizer(4, 3)(jnp.asarray(x)),
             tqm.Quantizer(4, 3)(_t(x), key=(1, 2)))


@pytest.mark.parametrize("layer", ["linear", "dense"])
@pytest.mark.parametrize("fmt", [(4, 3), (5, 2)])
def test_sr_linear_and_dense_vs_flax(layer, fmt, flax_keys):
    """QuantLinear (bias) and QuantDense (no bias, the kernel (in, out))
    with SR on a (2, 5, 12) input: the output and every gradient bitwise
    flax's, the key flax drew handed to the port.  g holds small
    multiples of 2^-4, so the bias gradient's column sums are exact in
    any order."""
    rng = np.random.default_rng(6)
    x = _operand(rng, (2, 5, 12))
    g = _dyadic(rng, (2, 5, 7))
    if layer == "linear":
        params = {"weight": _operand(rng, (7, 12)),
                  "bias": _operand(rng, (7,))}
        jm = jqm.QuantLinear(12, 7, exp=fmt[0], man=fmt[1],
                             rounding="stochastic")
        tm = tqm.QuantLinear(12, 7, exp=fmt[0], man=fmt[1],
                             rounding="stochastic")
    else:
        params = {"kernel": _operand(rng, (12, 7))}
        jm = jqm.QuantDense(7, exp=fmt[0], man=fmt[1], rounding="stochastic")
        tm = tqm.QuantDense(12, 7, exp=fmt[0], man=fmt[1],
                            rounding="stochastic")
    y, gp, gx = _flax_vjp(jm, params, x, g, 9)
    load_jax_params(tm, {"params": params})
    yt, gpt, gxt = _port_grads(tm, x, g, flax_keys[-1])
    _bitwise(y, yt, "y")
    _bitwise(gx, gxt, "grad_x")
    for name in params:
        _bitwise(gp[name], gpt[name], f"grad_{name}")
        assert gpt[name].is_contiguous()
    with pytest.raises(ValueError, match="needs a key"):
        tm(_t(x))


CONV_CASES = [  # (stride, padding, dilation, groups, rounding)
    (1, 0, 1, 1, "nearest"), (1, 1, 1, 1, "nearest"),
    (2, 1, 1, 1, "nearest"), (3, 0, 1, 1, "nearest"),
    (1, 2, 2, 1, "nearest"), (1, 1, 1, 2, "nearest"),
    (1, 2, 2, 2, "nearest"), (1, 1, 1, 2, "stochastic"),
    (3, 1, 1, 2, "stochastic")]


@pytest.mark.parametrize("stride,padding,dilation,groups,rounding",
                         CONV_CASES)
def test_quant_conv_vs_flax(stride, padding, dilation, groups, rounding,
                            flax_keys):
    """QuantConv (C 4 -> O 6, k 3, 8 x 9 images, e5m2) from flax's
    params: forward, weight and bias gradients bitwise; the input
    gradient bitwise where windows do not overlap (stride >= the dilated
    span), within 2^-20 of its largest magnitude where they do.  g holds
    small multiples of 2^-4 (exact bias sums)."""
    fmt, k, c, o = (5, 2), 3, 4, 6
    rng = np.random.default_rng(stride * 7 + padding + dilation * 3
                                + groups)
    x = _operand(rng, (2, c, 8, 9))
    params = {"weight": _operand(rng, (o, c // groups, k, k), 0.25),
              "bias": _operand(rng, (o,))}
    kw = dict(kernel_size=k, stride=stride, padding=padding,
              dilation=dilation, groups=groups, exp=fmt[0], man=fmt[1],
              rounding=rounding)
    jm = jqm.QuantConv(in_channels=c, out_channels=o, **kw)
    span = dilation * (k - 1) + 1
    oh = (8 + 2 * padding - span) // stride + 1
    ow = (9 + 2 * padding - span) // stride + 1
    g = _dyadic(rng, (2, o, oh, ow))
    y, gp, gx = _flax_vjp(jm, params, x, g, 21)
    tm = load_jax_params(tqm.QuantConv(c, o, **kw), {"params": params})
    key = flax_keys[-1] if rounding == "stochastic" else None
    yt, gpt, gxt = _port_grads(tm, x, g, key)
    _bitwise(y, yt, "forward")
    _bitwise(gp["weight"], gpt["weight"], "grad_weight")
    _bitwise(gp["bias"], gpt["bias"], "grad_bias")
    if stride >= span:
        _bitwise(gx, gxt, "grad_x without overlap")
    else:
        gx = np.asarray(gx)
        np.testing.assert_allclose(gxt.numpy(), gx, rtol=0,
                                   atol=np.abs(gx).max() * 2.0 ** -20)


def test_quant_conv_init_and_contract():
    gen = torch.Generator().manual_seed(0)
    m = tqm.QuantConv(4, 6, 3, groups=2, generator=gen)
    assert m.weight.shape == (6, 2, 3, 3) and m.bias.shape == (6,)
    assert float(m.weight.detach().abs().max()) <= 1 / np.sqrt(2 * 9)
    with pytest.raises(ValueError, match="divide"):
        tqm.QuantConv(3, 4, 3, groups=2)
    with pytest.raises(ValueError, match="rounding"):
        tqm.QuantConv(4, 4, 3, rounding="floor")


# ----------------------------------------------- numerics and the surface


def test_cast_oracles_and_kv_pool_bytes_equal_jax():
    rng = np.random.default_rng(8)
    xs = np.concatenate([
        rng.standard_normal(200) * 10.0 ** rng.integers(-40, 39, 200),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 3e-39, 1e38]]).astype(
            np.float32)
    for fmt in [(4, 3), (5, 2), (8, 23), (2, 1), (1, 0), (6, 17)]:
        shift = 23 - fmt[1]
        for x in xs:
            want = np.float32(jnum.cast_oracle(x, *fmt))
            got = np.float32(tnum.cast_oracle(x, *fmt))
            assert want.view(np.uint32) == got.view(np.uint32), (fmt, x)
            r = int(rng.integers(0, 1 << shift)) if shift else 0
            want = np.float32(jnum.cast_oracle_sr(x, *fmt, r))
            got = np.float32(tnum.cast_oracle_sr(x, *fmt, r))
            assert want.view(np.uint32) == got.view(np.uint32), (fmt, x, r)
    with pytest.raises(ValueError, match="r must be"):
        tnum.cast_oracle_sr(1.0, 4, 3, 1 << 20)
    for kw in (dict(), dict(block_size=32), dict(tp=2),
               dict(block_size=16, tp=2, shared_pages=3)):
        for fmt in [(4, 3), (5, 2), (8, 23)]:
            if fmt == (8, 23) and "block_size" in kw:
                continue
            args = (*fmt, 16, 2, 64)
            want = jnum.kv_pool_bytes(*args, n_layers=4, logical_pages=10,
                                      **kw)
            assert tnum.kv_pool_bytes(*args, n_layers=4, logical_pages=10,
                                      **kw) == want
    with pytest.raises(ValueError, match="shared_pages"):
        tnum.kv_pool_bytes(4, 3, 16, 2, 64, n_layers=1, logical_pages=1,
                           shared_pages=2)


def test_the_port_exports_every_name_of_the_jax_quant_package():
    assert set(jquant.__all__) <= set(tquant.__all__)
    for name in tquant.__all__:
        assert getattr(tquant, name) is not None
