"""The port's threefry2x32 keys and bits (`cpd_tpu_torch.quant.prng`) vs
`jax.random` and the JAX package's `sr_bits_at` / `grad_sr_key`, BITWISE:
PRNGKey, fold_in, split, the shape-indexed `random_bits` and the
offset-indexed `sr_bits_at`, at offsets past 2^31 and at 2^32 - 1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.parallel import dist as jdist
from cpd_tpu.quant import numerics as jnum
from cpd_tpu_torch.parallel import dist as tdist
from cpd_tpu_torch.quant import prng

SEEDS = [0, 1, 7, 24, 2**31 + 5, 2**32 - 1]


def _key(k) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    assert tk == _key(jk)
    for data in (0, 1, 3, 2**31 - 1, 2**31, 2**32 - 1):
        assert prng.fold_in(tk, data) == _key(jax.random.fold_in(
            jk, np.uint32(data)))
    assert prng.split(tk, 3) == [_key(k) for k in jax.random.split(jk, 3)]
    assert prng.split(tk) == [_key(k) for k in jax.random.split(jk)]


@pytest.mark.parametrize("shape", [(), (5,), (3, 7), (2, 3, 65)])
def test_random_bits_match_jax(shape):
    for seed in (0, 11):
        want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                          jnp.uint32))
        got = prng.random_bits(prng.PRNGKey(seed), shape)
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_sr_bits_at_matches_jax_and_the_pin():
    pin = prng.sr_bits_at(prng.PRNGKey(0), torch.arange(4))
    assert pin.tolist() == [3617712097, 31327077, 3875991361, 1146711402]
    offs = np.concatenate([
        np.arange(1000, dtype=np.uint64),
        np.uint64([2**31 - 1, 2**31, 3_000_000_000, 2**32 - 2, 2**32 - 1,
                   11_173_961]),
        np.random.default_rng(0).integers(0, 2**32, 500, dtype=np.uint64),
    ]).astype(np.uint32)
    for key in (jax.random.PRNGKey(3), jax.random.fold_in(
            jax.random.PRNGKey(9), 4)):
        want = np.asarray(jnum.sr_bits_at(key, jnp.asarray(offs)))
        got = prng.sr_bits_at(_key(key), torch.from_numpy(
            offs.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # a 2-d offsets array keeps its shape
    o2 = offs[:12].reshape(3, 4)
    got = prng.sr_bits_at(_key(key), torch.from_numpy(o2.astype(np.int64)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnum.sr_bits_at(key, jnp.asarray(o2))))


@pytest.mark.parametrize("seed,step,site", [(5, 3, 1), (0, 0, 0),
                                             (24, 1000, 1), (7, 2**20, 0)])
def test_grad_sr_key_and_site_key_match_jax(seed, step, site):
    want = _key(jdist.grad_sr_key(seed, step, site))
    assert tdist.grad_sr_key(seed, step, site) == want
    assert prng.site_key(prng.PRNGKey(seed), step, site) == want


def test_int32_bit_patterns_round_trip():
    u = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    i = prng.to_int32_bits(u)
    assert i.dtype == torch.int32
    assert i.tolist() == [0, 1, 2**31 - 1, -2**31, -1]
    assert ((i.to(torch.int64) & 0xFFFFFFFF) == u).all()
    assert prng.to_int32_bits(i) is i
