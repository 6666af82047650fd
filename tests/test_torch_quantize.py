"""The port's quantize kernels (K1-K6, RTNE and SR arms) and the SR bit
helper vs the JAX Pallas kernels and `sr_bits_at`.

The plain versions in `cpd_tpu_torch.ops.quantize` (what each CUDA kernel
is held against on the card) and the JAX kernels of `cpd_tpu/ops/
quantize.py`, run in Pallas interpret mode as the JAX package's own CPU
tests run them, get the same inputs: random gradients at an APS-like
scale, plus a block of special values (±0, ±Inf, NaN, fp32 subnormals,
values at and just past the format max that round up and carry), over
odd lengths.  The SR kernels get the JAX kernels' own bits: K2 the
shape-indexed `jax.random.bits` of its key (`prng.random_bits`), K4/K5/K6
offset-indexed `sr_bits_at` bits.  Every output is compared BITWISE: the
fp32 partials, the wire bytes and the digests.  The public
`cast_to_format` and the APS helpers are held to the JAX package bitwise
as well.

The CUDA kernels cannot run here; `test_kernels_match_plain_on_card`
holds them against their plain versions where a card exists.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.ops import quantize as jq
from cpd_tpu.parallel import aps as japs
from cpd_tpu.quant import numerics as jnum
from cpd_tpu_torch.ops import quantize as tq
from cpd_tpu_torch.parallel import aps as taps
from cpd_tpu_torch.quant import numerics as tnum
from cpd_tpu_torch.quant import prng

WIRE_FORMATS = [(5, 2), (4, 3), (5, 7), (6, 17)]     # 1-, 2- and 3-byte words
CAST_FORMATS = WIRE_FORMATS + [(8, 23), (5, 1)]      # (5, 1) cannot pack
SR_CAST_FORMATS = CAST_FORMATS + [(2, 1)]            # and a man < 2 one


def _specials(fmt) -> np.ndarray:
    mf = float(jnum.max_finite(*fmt))
    ulp = 2.0 ** (np.floor(np.log2(mf)) - fmt[1])
    vals = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 2.0**-127,
            -(2.0**-130), 2.0**-126, mf, -mf, mf + ulp / 4, mf + ulp / 2,
            -(mf + ulp / 2), mf + ulp, 2 * mf, 3.4e38, 1.0, -1.5]
    with np.errstate(over="ignore"):
        return np.asarray(vals, np.float64).astype(np.float32)


def _grads(n: int, fmt, seed: int) -> np.ndarray:
    """APS-like: magnitudes scaled toward the top of the format, with the
    special block at the front."""
    rng = np.random.default_rng(seed)
    top = np.float32(jnum.max_finite(*fmt)) / 8
    g = (rng.standard_normal(n) * top
         * 2.0 ** rng.integers(-12, 1, n)).astype(np.float32)
    sp = _specials(fmt)
    g[:len(sp)] = sp
    return g


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.atleast_1d(a).view(np.uint8)


def _eq(want, got):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    np.testing.assert_array_equal(_bits(want), _bits(got.astype(want.dtype)))


@pytest.mark.parametrize("fmt", CAST_FORMATS)
@pytest.mark.parametrize("n", [1003, 131])
def test_cast_and_add_match_jax_kernels(fmt, n):
    """Bitwise: K1's and K3's plain versions (and the public
    `cast_to_format` on CPU tensors) vs quantize_pallas /
    quantize_add_pallas in interpret mode."""
    x = _grads(n, fmt, seed=n)
    y = _grads(n, fmt, seed=n + 1)[::-1].copy()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    want = jq.quantize_pallas(jnp.asarray(x), *fmt, True)
    _eq(want, tq.quantize_cast_ref(tx, *fmt))
    _eq(want, tq.quantize_cast(tx, *fmt))
    _eq(want, tnum.cast_to_format(tx, *fmt))
    want = jq.quantize_add_pallas(jnp.asarray(x), jnp.asarray(y), *fmt, True)
    _eq(want, tq.quantize_add_ref(tx, ty, *fmt))
    _eq(want, tq.quantize_add(tx, ty, *fmt))


@pytest.mark.parametrize("fmt", WIRE_FORMATS)
def test_wire_kernels_match_jax_kernels(fmt):
    """Bitwise: K6's and K5's plain versions vs quantize_pack_pallas and
    hop_pack_pallas in interpret mode — partials, wire bytes and both
    digests — over an odd length."""
    n = 1003
    g0, g1 = _grads(n, fmt, 1), _grads(n, fmt, 2)
    res, wire, dig = jq.quantize_pack_pallas(jnp.asarray(g0), *fmt,
                                             want_digest=True, interpret=True)
    t_res, t_wire, t_dig = tq.quantize_pack(torch.from_numpy(g0), *fmt,
                                            want_digest=True)
    _eq(res, t_res)
    _eq(wire, t_wire)
    assert int(t_dig) == int(dig)
    res2, wire2, d_in, d_out = jq.hop_pack_pallas(
        wire, jnp.asarray(g1), *fmt, want_digest=True, interpret=True)
    t_res2, t_wire2, t_in, t_out = tq.hop_pack(
        t_wire, torch.from_numpy(g1), *fmt, want_digest=True)
    _eq(res2, t_res2)
    _eq(wire2, t_wire2)
    assert (int(t_in), int(t_out)) == (int(d_in), int(d_out))
    # no-digest form: the same partial and wire
    r, w = tq.hop_pack(t_wire, torch.from_numpy(g1), *fmt)
    _eq(res2, r)
    _eq(wire2, w)


def _sr_key(fmt):
    return jax.random.fold_in(jax.random.PRNGKey(fmt[0]), fmt[1])


def _tkey(k) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def _offset_bits(key, n: int, start: int) -> tuple:
    """``sr_bits_at`` bits of offsets start + i: (JAX array, port int32)."""
    offs = (np.arange(n, dtype=np.uint64) + start).astype(np.uint32)
    want = jnum.sr_bits_at(key, jnp.asarray(offs))
    got = tq.sr_bits(_tkey(key), torch.zeros(n), offset_start=start)
    return want, got


@pytest.mark.parametrize("fmt", SR_CAST_FORMATS)
@pytest.mark.parametrize("n", [1003, 131])
def test_sr_cast_and_add_match_jax_kernels(fmt, n):
    """Bitwise: K2's plain version (bits = `jax.random.bits` of the key)
    vs quantize_pallas_sr, and K4's (offset-indexed bits from `sr_bits`)
    vs quantize_add_pallas_bits, both in interpret mode."""
    x = _grads(n, fmt, seed=n + 7)
    y = _grads(n, fmt, seed=n + 8)[::-1].copy()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    key = _sr_key(fmt)
    want = jq.quantize_pallas_sr(jnp.asarray(x), *fmt, key, True)
    rb = prng.random_bits(_tkey(key), (n,))
    _eq(want, tq.quantize_cast_sr_ref(tx, *fmt, rb))
    _eq(want, tq.quantize_cast_sr(tx, *fmt, prng.to_int32_bits(rb)))
    jbits, tbits = _offset_bits(key, n, start=2**31 - 100)
    want = jq.quantize_add_pallas_bits(jnp.asarray(x), jnp.asarray(y), *fmt,
                                       jbits, True)
    _eq(want, tq.quantize_add_sr_ref(tx, ty, *fmt, tbits))
    _eq(want, tq.quantize_add_sr(tx, ty, *fmt, tbits))


@pytest.mark.parametrize("fmt", WIRE_FORMATS)
def test_sr_wire_kernels_match_jax_kernels(fmt):
    """Bitwise: the SR arms of K6 and K5 vs quantize_pack_pallas(rbits=)
    and hop_pack_pallas(rbits=) in interpret mode — partials, wire
    bytes and both digests, with and without the digests."""
    n = 1003
    g0, g1 = _grads(n, fmt, 3), _grads(n, fmt, 4)
    key = _sr_key(fmt)
    j0, t0 = _offset_bits(jax.random.fold_in(key, 0), n, start=5000)
    j1, t1 = _offset_bits(jax.random.fold_in(key, 1), n, start=5000)
    res, wire, dig = jq.quantize_pack_pallas(
        jnp.asarray(g0), *fmt, rbits=j0, want_digest=True, interpret=True)
    t_res, t_wire, t_dig = tq.quantize_pack(torch.from_numpy(g0), *fmt,
                                            rbits=t0, want_digest=True)
    _eq(res, t_res)
    _eq(wire, t_wire)
    assert int(t_dig) == int(dig)
    r, w = tq.quantize_pack_ref(torch.from_numpy(g0), *fmt, rbits=t0)
    _eq(res, r)
    _eq(wire, w)
    r, w = tq.quantize_pack_sr(torch.from_numpy(g0), *fmt, t0)
    _eq(res, r)
    _eq(wire, w)
    res2, wire2, d_in, d_out = jq.hop_pack_pallas(
        wire, jnp.asarray(g1), *fmt, rbits=j1, want_digest=True,
        interpret=True)
    t_res2, t_wire2, t_in, t_out = tq.hop_pack(
        t_wire, torch.from_numpy(g1), *fmt, rbits=t1, want_digest=True)
    _eq(res2, t_res2)
    _eq(wire2, t_wire2)
    assert (int(t_in), int(t_out)) == (int(d_in), int(d_out))
    r, w = tq.hop_pack(t_wire, torch.from_numpy(g1), *fmt, rbits=t1)
    _eq(res2, r)
    _eq(wire2, w)
    r, w = tq.hop_pack_sr(t_wire, torch.from_numpy(g1), *fmt, t1)
    _eq(res2, r)
    _eq(wire2, w)


def test_sr_bits_helper_matches_jax():
    """Bitwise: `sr_bits` by offset_start (wrapping past 2^32, and a
    start past 2^32 taken mod 2^32) vs `sr_bits_at`; a 2-d ``like``
    gives its elements' bits flat."""
    key = jax.random.PRNGKey(12)
    for n, start in [(1, 0), (777, 2**32 - 300), (4096, 11_173_000),
                     (5, 2**33 + 7)]:
        want, got = _offset_bits(key, n, start)
        assert got.dtype == torch.int32 and tuple(got.shape) == (n,)
        _eq(np.asarray(want).view(np.int32), got)
    got = tq.sr_bits(_tkey(key), torch.zeros(6, 7), offset_start=3)
    want = jnum.sr_bits_at(key, jnp.arange(3, 45, dtype=jnp.uint32))
    _eq(np.asarray(want).view(np.int32), got)


def test_flat_sr_bits_match_jax_random_bits():
    """Bitwise: ``sr_bits(flat=True)`` is ``jax.random.bits(key,
    shape)`` flattened (one threefry an element from index 0), for a 1-d
    and a 2-d ``like``; an ``offset_start`` with ``flat`` raises, since
    the flat stream has no offset."""
    key = jax.random.PRNGKey(31)
    for shape in [(1,), (777,), (6, 7)]:
        want = jax.random.bits(key, shape, jnp.uint32)
        got = tq.sr_bits(_tkey(key), torch.zeros(shape), flat=True)
        assert got.dtype == torch.int32 and tuple(got.shape) == (
            int(np.prod(shape)),)
        _eq(np.asarray(want).reshape(-1).view(np.int32), got)
    with pytest.raises(ValueError, match="index 0"):
        tq.sr_bits(_tkey(key), torch.zeros(5), offset_start=3, flat=True)


def test_unported_wire_arms_raise():
    """What the wire wrappers still refuse: a block size the blocked
    kernel does not take (the JAX kernel's rule; the ring casts such
    blocks with torch ops), a block-scaled (8, 23) wire, a wire of the
    wrong size, an unpackable format, operands on several devices."""
    g = torch.zeros(8)
    with pytest.raises(ValueError, match="multiple of 128"):
        tq.quantize_pack(g, 5, 2, block_size=96)
    with pytest.raises(ValueError, match="multiple of 128"):
        tq.hop_pack(torch.zeros((9,), dtype=torch.uint8), g, 5, 2,
                    block_size=33)
    with pytest.raises(ValueError, match="nothing to scale"):
        tq.quantize_pack(g, 8, 23, block_size=128)
    with pytest.raises(ValueError, match="sidecar"):
        tq.hop_pack(torch.zeros((8, 1), dtype=torch.uint8), g, 5, 2,
                    block_size=128)
    with pytest.raises(ValueError, match="man_bits >= 2"):
        tq.quantize_pack(g, 5, 1)
    with pytest.raises(ValueError, match="several devices"):
        tq.quantize_add(g, g.to("meta"), 5, 2)
    with pytest.raises(ValueError, match="W, n_bytes"):
        tq.digest_rows(torch.zeros(8, dtype=torch.uint8))


def test_aps_helpers_match_jax():
    """Bitwise: exp2_exact, the exact ceil-log2, the max exponents, the
    shifts (all-zero and non-finite leaves included), scale and unscale."""
    s = np.arange(-160, 140, dtype=np.float32)
    _eq(japs.exp2_exact(jnp.asarray(s)), taps.exp2_exact(torch.from_numpy(s)))
    # normal maxima only: XLA:CPU treats subnormal inputs as zero (its
    # ceil-log2 of 2^-130 is -inf), where the port, like the card, takes
    # the function's exact subnormal branch
    rng = np.random.default_rng(3)
    m = np.concatenate([np.abs(rng.standard_normal(200)).astype(np.float32)
                        * np.float32(2.0) ** rng.integers(-120, 120, 200),
                        np.float32([0, 1, 2, 0.5, 3, 2.0**-126, 2.0**127,
                                    np.inf, np.nan])]).astype(np.float32)
    _eq(japs._ceil_log2_exact(jnp.asarray(m)),
        taps._ceil_log2_exact(torch.from_numpy(m)))
    leaves = [rng.standard_normal((3, 5)).astype(np.float32) * 1e-3,
              np.zeros(7, np.float32),
              np.float32([1.0, np.inf, 2.0]),
              rng.standard_normal(11).astype(np.float32) * 1e4]
    t_leaves = [torch.from_numpy(a) for a in leaves]
    j_leaves = [jnp.asarray(a) for a in leaves]
    me = japs.aps_max_exponents(j_leaves, 4)
    _eq(me, taps.aps_max_exponents(t_leaves, 4))
    shifts, bad = japs.aps_shift_factors_checked(me, 5)
    t_shifts, t_bad = taps.aps_shift_factors_checked(
        torch.from_numpy(np.asarray(me)), 5)
    _eq(shifts, t_shifts)
    assert int(bad) == int(t_bad) == 1
    for j, t in zip(japs.aps_scale(j_leaves, shifts),
                    taps.aps_scale(t_leaves, t_shifts)):
        _eq(j, t)
    for j, t in zip(japs.aps_unscale(j_leaves, shifts),
                    taps.aps_unscale(t_leaves, t_shifts)):
        _eq(j, t)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", CAST_FORMATS)
def test_kernels_match_plain_on_card(fmt):
    """Bitwise, on the card: each kernel vs its plain version, with the
    launch counted once per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    n = 100_003
    x = torch.from_numpy(_grads(n, fmt, 5)).cuda()
    y = torch.from_numpy(_grads(n, fmt, 6)).cuda()
    before = tq.quantize_cast.launches
    _eq(tq.quantize_cast_ref(x, *fmt).cpu(), tq.quantize_cast(x, *fmt).cpu())
    assert tq.quantize_cast.launches == before + 1
    _eq(tq.quantize_add_ref(x, y, *fmt).cpu(),
        tq.quantize_add(x, y, *fmt).cpu())
    if fmt not in WIRE_FORMATS:
        return
    want = tq.quantize_pack_ref(x, *fmt, want_digest=True)
    got = tq.quantize_pack(x, *fmt, want_digest=True)
    for a, b in zip(want, got):
        _eq(a.cpu(), b.cpu())
    want = tq.hop_pack_ref(got[1], y, *fmt, want_digest=True)
    got = tq.hop_pack(got[1], y, *fmt, want_digest=True)
    for a, b in zip(want, got):
        _eq(a.cpu(), b.cpu())
    with pytest.raises(TypeError, match="float32"):
        tq.quantize_cast(x.double(), *fmt)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", SR_CAST_FORMATS)
def test_sr_kernels_match_plain_on_card(fmt):
    """Bitwise, on the card: `sr_bits`, K2, K4 and the SR arms of K6/K5
    vs their plain versions, each launch counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    n = 100_003
    x = torch.from_numpy(_grads(n, fmt, 7)).cuda()
    y = torch.from_numpy(_grads(n, fmt, 8)).cuda()
    key = (123, fmt[0] * 100 + fmt[1])
    before = tq.sr_bits.launches
    rb = tq.sr_bits(key, x, offset_start=2**32 - 50)
    assert tq.sr_bits.launches == before + 1
    _eq(tq.sr_bits_ref(key, x.cpu(), offset_start=2**32 - 50), rb.cpu())
    before = tq.quantize_cast_sr.launches
    _eq(tq.quantize_cast_sr_ref(x, *fmt, rb).cpu(),
        tq.quantize_cast_sr(x, *fmt, rb).cpu())
    assert tq.quantize_cast_sr.launches == before + 1
    _eq(tq.quantize_add_sr_ref(x, y, *fmt, rb).cpu(),
        tq.quantize_add_sr(x, y, *fmt, rb).cpu())
    if fmt not in WIRE_FORMATS:
        return
    counts = (tq.quantize_pack.launches, tq.hop_pack.launches,
              tq.quantize_pack_sr.launches, tq.hop_pack_sr.launches)
    want = tq.quantize_pack_ref(x, *fmt, rbits=rb, want_digest=True)
    got = tq.quantize_pack(x, *fmt, rbits=rb, want_digest=True)
    for a, b in zip(want, got):
        _eq(a.cpu(), b.cpu())
    want = tq.hop_pack_ref(got[1], y, *fmt, rbits=rb, want_digest=True)
    got = tq.hop_pack_sr(got[1], y, *fmt, rb, want_digest=True)
    for a, b in zip(want, got):
        _eq(a.cpu(), b.cpu())
    # the SR arms count under their own names only
    assert (tq.quantize_pack.launches, tq.hop_pack.launches,
            tq.quantize_pack_sr.launches, tq.hop_pack_sr.launches) == (
        counts[0], counts[1], counts[2] + 1, counts[3] + 1)
    with pytest.raises(TypeError, match="int32"):
        tq.quantize_cast_sr(x, *fmt, rb.to(torch.int64))


def test_kept_wire_kernels_take_cuda_tensors_only():
    """`core_wire_launcher`, K6/K5's kept kernels, is a yardstick on the
    card: CPU tensors raise rather than run a plain version."""
    x = torch.from_numpy(_grads(64, (5, 2), 3))
    with pytest.raises(ValueError, match="CUDA"):
        tq.core_wire_launcher()(None, x, 5, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("fmt", WIRE_FORMATS + [(8, 23)])
def test_streaming_wire_kernels_ragged_and_misaligned_on_card(fmt, sr):
    """Bitwise, on the card: K6/K5's streaming kernels against their plain
    versions and the kept kernels (`core_wire_launcher`) at n = 1, 15, 17
    and 100_003, on g at a 16-byte boundary and 4 bytes past one, with and
    without digests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    core = tq.core_wire_launcher()
    big = torch.from_numpy(_grads(100_008, fmt, 11)).cuda()
    other = torch.from_numpy(_grads(100_008, fmt, 12)).cuda()
    for n in (1, 15, 17, 100_003):
        for off in (0, 1):          # off 1: 4 bytes past a 16-byte boundary
            x, y = big[off:off + n], other[off:off + n]
            rb = (tq.sr_bits((fmt[0], n), x, offset_start=2**32 - 9)
                  if sr else None)
            for dig in (True, False):
                got = tq.quantize_pack(x, *fmt, rbits=rb, want_digest=dig)
                for want in (tq.quantize_pack_ref(x, *fmt, rbits=rb,
                                                  want_digest=dig),
                             core(None, x, *fmt, rbits=rb, want_digest=dig)):
                    for a, b in zip(want, got):
                        _eq(a.cpu(), b.cpu())
                hop = tq.hop_pack(got[1], y, *fmt, rbits=rb, want_digest=dig)
                for want in (tq.hop_pack_ref(got[1], y, *fmt, rbits=rb,
                                             want_digest=dig),
                             core(got[1], y, *fmt, rbits=rb,
                                  want_digest=dig)):
                    for a, b in zip(want, hop):
                        _eq(a.cpu(), b.cpu())
