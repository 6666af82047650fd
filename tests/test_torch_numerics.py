"""The port's eXmY numerics and digests vs the JAX package, bitwise.

The same inputs (numpy, seeded) go through `cpd_tpu.quant.numerics` and
`cpd_tpu_torch.quant.numerics`; every output must match bit for bit —
the RTNE and the stochastically rounded cast, the packed code words,
their decode, and the block-scaled codec — over the probe families of
tests/test_numerics.py and tests/test_stochastic.py: random bit patterns
(NaN payloads, subnormals, both infinities), ties at every e5m2/e4m3
point, subnormal targets, values that carry past the format max, and
random round bits with garbage above the bits the cast reads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.parallel import integrity as jint
from cpd_tpu.quant import numerics as jnum
from cpd_tpu_torch.parallel import integrity as tint
from cpd_tpu_torch.quant import numerics as tnum
from cpd_tpu_torch.quant import prng

FORMATS = [(8, 23), (5, 2), (4, 3), (5, 7)]
# tests/test_stochastic.py's formats, a 3-byte one and the identity
SR_FORMATS = [(5, 2), (4, 3), (3, 4), (8, 7), (2, 1), (6, 17), (8, 23)]
SUB_FP32 = [f for f in FORMATS if f != (8, 23)]


def _probes(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, size=6000, dtype=np.uint64)
    vals = [0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan,
            2.0**-126, -(2.0**-126), 1e-45, -1e-45, 2.0**-127,
            3.4e38, -3.4e38, 65504.0, 57344.0, 61439.0, 61440.0, 61441.0,
            448.0, 464.0, 465.0, 480.0, 496.0, 240.0, 0.0625,
            2.0**-9, 2.0**-10, 3 * 2.0**-11, 2.0**-16, 2.0**-17]
    for e in range(-20, 20):                 # ties around format points
        for m in (1.0, 1.0625, 1.125, 1.1875, 1.25, 1.375, 1.5, 1.625,
                  1.75, 1.875, 1.9375):
            vals += [m * 2.0**e, -m * 2.0**e]
    normals = rng.standard_normal(2000) * 10.0 ** rng.integers(-6, 6, 2000)
    return np.concatenate([bits.astype(np.uint32).view(np.float32),
                           np.asarray(vals, np.float32),
                           normals.astype(np.float32)])


def _bitwise(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("fmt", FORMATS)
def test_cast_body_bitwise(fmt):
    x = _probes(seed=fmt[0] * 31 + fmt[1])
    _bitwise(jnum.cast_body(jnp.asarray(x), *fmt),
             tnum.cast_body(torch.from_numpy(x), *fmt))


@pytest.mark.parametrize("fmt", SR_FORMATS)
def test_cast_body_sr_bitwise(fmt):
    """cast_body_sr with explicit bits, given as uint32 values (int64)
    and as their int32 patterns: all-zero and all-one bits (truncation
    and full round-up) at the front, random bits after."""
    x = _probes(seed=fmt[0] * 7 + fmt[1])
    r = np.random.default_rng(fmt[1]).integers(
        0, 2**32, x.size, dtype=np.uint64).astype(np.uint32)
    r[:64] = np.tile(np.uint32([0, 0xFFFFFFFF]), 32)
    want = jnum.cast_body_sr(jnp.asarray(x), *fmt, jnp.asarray(r))
    tr = torch.from_numpy(r.astype(np.int64))
    _bitwise(want, tnum.cast_body_sr(torch.from_numpy(x), *fmt, tr))
    _bitwise(want, tnum.cast_body_sr(torch.from_numpy(x), *fmt,
                                     prng.to_int32_bits(tr)))


@pytest.mark.parametrize("fmt", [(5, 2), (4, 3), (2, 1)])
def test_public_sr_casts_bitwise(fmt):
    """cast_to_format_sr (shape-indexed bits) and cast_to_format_sr_at
    (offset-indexed bits, offsets past 2^31) on CPU tensors."""
    x = _probes(seed=fmt[1] + 40)[:3000].reshape(30, 100)
    key = jax.random.PRNGKey(fmt[0])
    tkey = prng.PRNGKey(fmt[0])
    _bitwise(jnum.cast_to_format_sr(jnp.asarray(x), *fmt, key),
             tnum.cast_to_format_sr(torch.from_numpy(x), *fmt, tkey))
    offs = (np.arange(x.size, dtype=np.uint64) + 2**31 - 1500).astype(
        np.uint32).reshape(x.shape)
    _bitwise(jnum.cast_to_format_sr_at(jnp.asarray(x), *fmt, key,
                                       jnp.asarray(offs)),
             tnum.cast_to_format_sr_at(torch.from_numpy(x), *fmt, tkey,
                                       torch.from_numpy(
                                           offs.astype(np.int64))))


@pytest.mark.parametrize("fmt", FORMATS)
def test_pack_unpack_bitwise(fmt):
    x = _probes(seed=fmt[1] + 5)
    q = np.asarray(jnum.cast_body(jnp.asarray(x), *fmt))
    packed = jnum.pack_exmy(jnp.asarray(q), *fmt)
    _bitwise(packed, tnum.pack_exmy(torch.from_numpy(q), *fmt))
    p = np.asarray(packed)
    _bitwise(jnum.unpack_exmy(packed, *fmt),
             tnum.unpack_exmy(torch.from_numpy(p), *fmt))
    # every code word, not just the cast's outputs: one byte-plane sweep
    codes = np.arange(2 ** min(8 * p.shape[-1], 16), dtype=np.uint32)
    codes = np.stack([(codes >> (8 * k)) & 0xFF
                      for k in range(p.shape[-1])], -1).astype(np.uint8)
    _bitwise(jnum.unpack_exmy(jnp.asarray(codes), *fmt),
             tnum.unpack_exmy(torch.from_numpy(codes), *fmt))


@pytest.mark.parametrize("fmt", SUB_FP32)
@pytest.mark.parametrize("block", [32, 7])
def test_blocked_codec_bitwise(fmt, block):
    x = _probes(seed=block)[:5952].reshape(-1, 96)
    # rows whose blocks span very different magnitudes
    x = x * np.float32(2.0) ** np.arange(-3, 3)[np.arange(len(x)) % 6,
                                                  None].astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _bitwise(np.asarray(jnum.block_shifts(jx, *fmt, block)).astype(np.int64),
             tnum.block_shifts(tx, *fmt, block))
    _bitwise(jnum.cast_body_blocked(jx, *fmt, block),
             tnum.cast_body_blocked(tx, *fmt, block))
    packed = jnum.pack_exmy_blocked(jx, *fmt, block)
    _bitwise(packed, tnum.pack_exmy_blocked(tx, *fmt, block))
    p = np.asarray(packed)
    _bitwise(jnum.unpack_exmy_blocked(packed, *fmt, 96, block),
             tnum.unpack_exmy_blocked(torch.from_numpy(p), *fmt, 96, block))


@pytest.mark.parametrize("fmt", FORMATS)
def test_page_bytes_and_limits_agree(fmt):
    assert tnum.wire_bytes(*fmt) == jnum.wire_bytes(*fmt)
    assert tnum.max_finite(*fmt) == jnum.max_finite(*fmt)
    assert tnum.kv_page_bytes(*fmt, 16, 2, 64) == \
        jnum.kv_page_bytes(*fmt, 16, 2, 64)
    if fmt != (8, 23):
        assert tnum.kv_page_bytes(*fmt, 16, 2, 64, block_size=32) == \
            jnum.kv_page_bytes(*fmt, 16, 2, 64, block_size=32)
        assert tnum.format_max_exponent(fmt[0]) == \
            jnum.format_max_exponent(fmt[0])


@pytest.mark.parametrize("fmt", [(5, 1), (3, 0), (9, 2), (4, 24)])
def test_unpackable_formats_raise_in_both(fmt):
    with pytest.raises(ValueError):
        jnum.pack_exmy(jnp.zeros(2, jnp.float32), *fmt)
    with pytest.raises(ValueError):
        tnum.pack_exmy(torch.zeros(2), *fmt)


@pytest.mark.parametrize("dtype,n", [
    (np.uint8, 10000), (np.uint8, 37), (np.float32, 5000),
    (np.int32, 4099), (np.float16, 300), (np.int8, 513)])
def test_wire_digest_bitwise(dtype, n):
    rng = np.random.default_rng(n)
    if dtype == np.float32:
        x = rng.integers(0, 2**32, n, dtype=np.uint64).astype(
            np.uint32).view(np.float32)
    elif dtype == np.float16:
        x = rng.integers(0, 2**16, n).astype(np.uint16).view(np.float16)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, int(info.max) + 1, n).astype(dtype)
    want = int(jint.wire_digest(jnp.asarray(x)))
    assert int(tint.wire_digest(torch.from_numpy(x))) == want
    rows = np.stack([x, x[::-1]])
    got = tint.row_digests(torch.from_numpy(rows.copy()))
    assert [int(v) for v in got] == [want, int(jint.wire_digest(
        jnp.asarray(x[::-1].copy())))]
