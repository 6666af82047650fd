"""The port's native host library (`cpd_tpu_torch.native`) and the fused
augment on its data path, on the CPU.

BITWISE throughout: the cast, the faithful Kahan GEMM and the ordered
sums against the JAX package's native library (`cpd_tpu.native`) and
against the port's own torch numerics (`cast_body`, the plain K8 scan,
`parallel.reduction`'s ordered sums: there a NaN made by Inf - Inf is
NaN in both, its sign bit the hardware's); `fused_augment_np` and
`TransformPipeline.apply` against the numpy transform chain, with the
fused batches counted in ``fused_calls``; the port's CIFAR-10 pipeline
against the JAX package's, batch for batch.  Inputs include Inf, NaN,
signed zeros, fp32 subnormals and values at each format's saturation
and rounding boundaries.
"""

import os

import numpy as np
import pytest
import torch

from cpd_tpu import native as jnative
from cpd_tpu.data import cifar as jcifar
from cpd_tpu_torch import native
from cpd_tpu_torch.data import cifar as tcifar
from cpd_tpu_torch.data.augment import (Crop, Cutout, FlipLR,
                                        TransformPipeline, pad_reflect)
from cpd_tpu_torch.ops.qgemm import qgemm_faithful_ref
from cpd_tpu_torch.parallel.reduction import (kahan_quantized_sum,
                                              ordered_quantized_sum)
from cpd_tpu_torch.quant.numerics import cast_body, max_finite
from test_torch_threads import one_torch_thread  # noqa: F401

FORMATS = [(5, 2), (4, 3), (8, 23), (1, 0), (8, 0), (2, 7), (6, 9)]


@pytest.fixture(autouse=True, scope="module")
def both_libraries():
    if not (native.available() and jnative.available()):
        pytest.fail("a C++ compiler is part of this machine: both native "
                    "libraries must build")


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _values(rng, fmt, n=2000):
    """Random magnitudes over the whole fp32 range plus each format's
    edges: specials, fp32 subnormals, the max and past it, ties."""
    e, m = fmt
    bias = (1 << (e - 1)) - 1
    edge = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -3e-39, 1.0,
            1 + 2.0 ** (-m - 1), -(1 + 3 * 2.0 ** (-m - 1)),
            2.0 ** (1 - bias - m), 2.0 ** (-bias - m - 1),
            max_finite(*fmt), -2 * max_finite(*fmt), 3.4e38]
    x = rng.standard_normal(n) * 10.0 ** rng.integers(-45, 38, n)
    edge += [2.0 ** -126] * 6                  # 2021 values: (-1, 43)
    return np.concatenate([x, edge]).astype(np.float32)


def test_library_builds_under_build_cpu_keyed_by_sources():
    path = native.build()
    assert os.path.exists(path)
    parts = path.split(os.sep)
    assert parts[-4:-2] == ["build", "cpu"] and len(parts[-2]) == 16
    assert "-ffp-contract=off" in native.CXX_FLAGS
    assert native.build() == path          # built once, then reused


@pytest.mark.parametrize("fmt", FORMATS)
def test_cast_bitwise_vs_jax_native_and_cast_body(fmt):
    x = _values(np.random.default_rng(sum(fmt)), fmt).reshape(-1, 43)
    got = native.float_quantize_np(x, *fmt)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jnative.float_quantize_np(x, *fmt)))
    np.testing.assert_array_equal(
        _bits(got), _bits(cast_body(torch.from_numpy(x), *fmt).numpy()))
    assert got.shape == x.shape


@pytest.mark.parametrize("fmt", [(4, 3), (5, 2), (8, 23), (2, 1)])
def test_quant_gemm_bitwise_vs_jax_native_and_plain_scan(fmt):
    rng = np.random.default_rng(7)
    a = rng.standard_normal((13, 37)).astype(np.float32) * 4
    b = rng.standard_normal((37, 9)).astype(np.float32)
    a[0] *= 1e3 * max_finite(*fmt)        # saturates
    a[1] *= 2.0 ** -20                     # underflows
    got = native.quant_gemm_np(a, b, *fmt)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jnative.quant_gemm_np(a, b, *fmt)))
    want = qgemm_faithful_ref(torch.from_numpy(a), torch.from_numpy(b),
                              *fmt).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    with pytest.raises(ValueError, match="expected"):
        native.quant_gemm_np(a, a, *fmt)


@pytest.mark.parametrize("kahan", [False, True])
def test_ordered_sum_bitwise_vs_jax_native_and_torch(kahan):
    rng = np.random.default_rng(9)
    stacked = (rng.standard_normal((6, 5, 33)) * 3).astype(np.float32)
    stacked[2, 0, :3] = [np.inf, 1e6, 1e-40]
    for fmt in [(5, 2), (4, 3), (6, 9)]:
        got = native.ordered_sum_np(stacked, *fmt, kahan=kahan)
        np.testing.assert_array_equal(
            _bits(got), _bits(jnative.ordered_sum_np(stacked, *fmt,
                                                     kahan=kahan)))
        fn = kahan_quantized_sum if kahan else ordered_quantized_sum
        want = fn(torch.from_numpy(stacked), *fmt).numpy()
        # Inf - Inf in the Kahan term: a NaN whose sign the hardware picks
        # (x86's default NaN has it set, torch's vector ops not): both NaN
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])


def test_functions_are_pure_and_raise_when_unavailable(monkeypatch):
    x = np.linspace(-3, 3, 11, dtype=np.float32)
    keep = x.copy()
    native.float_quantize_np(x, 4, 3)
    np.testing.assert_array_equal(x, keep)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    assert not native.available()
    with pytest.raises(NotImplementedError):
        native.float_quantize_np(x, 5, 2)


def _numpy_chain(pipe, x, idx):
    out = x[idx]
    for t, ch in zip(pipe.transforms, pipe.choices):
        out = t(out, {k: v[idx] for k, v in ch.items()})
    return out


@pytest.mark.parametrize("cutout", [False, True])
def test_fused_augment_bitwise_vs_numpy_chain(cutout):
    rng = np.random.default_rng(3)
    data = pad_reflect(rng.standard_normal((40, 32, 32, 3)).astype(
        np.float32))
    chain = [Crop(32, 32), FlipLR()] + ([Cutout(8, 8)] if cutout else [])
    pipe = TransformPipeline(chain, data.shape)
    pipe.resample(5)
    for n_threads in (0, 1, 3):
        idx = rng.integers(0, 40, 23)
        crop, flip = pipe.choices[0], pipe.choices[1]
        cut = (dict(cut_y=pipe.choices[2]["y0"], cut_x=pipe.choices[2]["x0"],
                    cut_h=8, cut_w=8) if cutout else {})
        got = native.fused_augment_np(
            data, idx, crop["y0"], crop["x0"], 32, 32,
            flip["choice"].astype(np.uint8), n_threads=n_threads, **cut)
        np.testing.assert_array_equal(_bits(got),
                                      _bits(_numpy_chain(pipe, data, idx)))
    before = pipe.fused_calls
    got = pipe.apply(data, idx)
    assert pipe.fused_calls == before + 1
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_numpy_chain(pipe, data, idx)))


def test_other_chains_and_dtypes_take_the_numpy_path():
    rng = np.random.default_rng(4)
    data = rng.standard_normal((8, 36, 36, 3)).astype(np.float32)
    idx = np.arange(5)
    for chain, x in (([FlipLR(), Crop(32, 32)], data),
                     ([Crop(32, 32)], data),
                     ([Crop(32, 32), FlipLR()], data.astype(np.float64))):
        pipe = TransformPipeline(chain, x.shape)
        pipe.resample(1)
        got = pipe.apply(x, idx)
        assert pipe.fused_calls == 0
        np.testing.assert_array_equal(got, _numpy_chain(pipe, x, idx))


def test_cifar_pipeline_batches_bitwise_the_jax_pipeline():
    """The port's CIFAR10Pipeline (pad, crop, flip, cutout through the
    port's native pass) gives the JAX package's batches bitwise, over
    two epochs' choices."""
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (64, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 64)
    tp = tcifar.CIFAR10Pipeline(images, labels, 16)
    jp = jcifar.CIFAR10Pipeline(images, labels, 16)
    for seed in (0, 1):
        idx = rng.permutation(64)[:16]
        (tx, ty), (jx, jy) = tp.batch(idx, seed), jp.batch(idx, seed)
        np.testing.assert_array_equal(_bits(tx), _bits(jx))
        np.testing.assert_array_equal(ty, jy)
    assert tp.pipeline.fused_calls == 2
