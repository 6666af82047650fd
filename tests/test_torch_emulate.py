"""The port's emulate-node reduce (`cpd_tpu_torch.parallel.emulate`) vs
the JAX package's (`cpd_tpu.parallel.emulate`).

Every comparison here is BITWISE, given the same leaf list in the same
order: `emulate_node_reduce` at N in {1, 2, 4} over the formats (5, 2),
(4, 3) and (3, 4), APS on and off, RTNE and SR with a key; the N == 1
identity, the all-zero leaf's shift 0, the bucketed RTNE form equal to
the per-leaf `reduce_stacked_leaf`, the launch design (chip_smoke.py's
`emulate_design`, counted on the plain versions the CPU runs) and the rounding/key
contract errors (tests/test_parallel.py:253-281,
tests/test_sr_pipeline.py:102).  Inputs are normal fp32 values: XLA:CPU
flushes subnormals, the port does not (ROADMAP Queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpd_tpu.parallel import emulate as jemu
from cpd_tpu_torch.parallel import emulate as temu
from cpd_tpu_torch.parallel import reduction as tred
from cpd_tpu_torch.parallel.overlap import bucket_layout

SHAPES = [(4, 3, 3, 3), (7,), (5, 6), (11,)]


def _bitwise(want, got, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  got.view(np.uint32), err_msg=msg)


def _stacks(n, seed, zero_leaf=None):
    rng = np.random.RandomState(seed)
    out = [(rng.randn(n, *s) * 10.0 ** (-(i % 3))).astype(np.float32)
           for i, s in enumerate(SHAPES)]
    if zero_leaf is not None:
        out[zero_leaf][:] = 0.0
    return out


def _tkey(k) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def _both(stacks, n, sr=False, **kw):
    key = jax.random.PRNGKey(11) if sr else None
    rounding = "stochastic" if sr else "nearest"
    want = jemu.emulate_node_reduce([jnp.asarray(g) for g in stacks], n,
                                    key=key, rounding=rounding, **kw)
    got = temu.emulate_node_reduce([torch.from_numpy(g) for g in stacks], n,
                                   key=_tkey(key) if sr else None,
                                   rounding=rounding, **kw)
    return want, got


@pytest.mark.parametrize("use_aps", [False, True])
@pytest.mark.parametrize("fmt", [(5, 2), (4, 3), (3, 4)])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_emulate_node_reduce_matches_jax(n, fmt, use_aps):
    """Bitwise, RTNE: the local APS shift (scaled by N), the cast, the
    ordered N-step sum and the true-divide unscale, leaf by leaf."""
    stacks = _stacks(n, seed=n * 10 + fmt[1], zero_leaf=3)
    want, got = _both(stacks, n, use_aps=use_aps, grad_exp=fmt[0],
                      grad_man=fmt[1])
    for i, (w, g) in enumerate(zip(want, got)):
        assert tuple(g.shape) == SHAPES[i]
        _bitwise(w, g, f"leaf {i}")


@pytest.mark.parametrize("use_aps", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_emulate_node_reduce_sr_matches_jax(n, use_aps):
    """Bitwise, SR: leaf i keyed ``fold_in(key, i)``, split into the
    cast's key (``jax.random.bits`` by flat index over the (N, ...)
    stack) and the ordered sum's (leaf-local offsets)."""
    stacks = _stacks(n, seed=40 + n)
    want, got = _both(stacks, n, sr=True, use_aps=use_aps, grad_exp=4,
                      grad_man=3)
    for i, (w, g) in enumerate(zip(want, got)):
        _bitwise(w, g, f"leaf {i}")
    again = temu.emulate_node_reduce(
        [torch.from_numpy(g) for g in stacks], n, use_aps=use_aps,
        grad_exp=4, grad_man=3, key=_tkey(jax.random.PRNGKey(11)),
        rounding="stochastic")
    for a, b in zip(got, again):
        _bitwise(a.numpy(), b)


def test_n1_is_the_identity_and_zero_leaf_shifts_zero():
    """N == 1 returns each gradient as it is, unquantized, key or not;
    an all-zero leaf comes back as zeros (shift 0, no NaN from the
    -inf max exponent)."""
    stacks = [torch.from_numpy(g) for g in _stacks(1, seed=3)]
    for kw in ({}, dict(key=(0, 5), rounding="stochastic")):
        out = temu.emulate_node_reduce(stacks, 1, use_aps=True, grad_exp=5,
                                       grad_man=2, **kw)
        for g, o in zip(stacks, out):
            _bitwise(g[0].numpy(), o)
    zero = temu.reduce_stacked_leaf(torch.zeros(3, 8), 3, use_aps=True,
                                    grad_exp=3, grad_man=4)
    _bitwise(np.zeros(8, np.float32), zero)


@pytest.mark.parametrize("use_aps", [False, True])
@pytest.mark.parametrize("cap", [1, 50, 200, None])
def test_buckets_equal_the_per_leaf_reduce(monkeypatch, use_aps, cap):
    """RTNE runs on buckets of whole leaves: one cast of the bucket's
    (N, elems) stack and N summing steps are bitwise the per-leaf
    `reduce_stacked_leaf`, whatever the bucket cap (the module's
    ``DEFAULT_BUCKET_ELEMS`` set to ``cap``)."""
    if cap is not None:
        monkeypatch.setattr(temu, "DEFAULT_BUCKET_ELEMS", cap)
    stacks = [torch.from_numpy(g) for g in _stacks(4, seed=8, zero_leaf=1)]
    per_leaf = [temu.reduce_stacked_leaf(g, 4, use_aps, 5, 2)
                for g in stacks]
    got = temu.emulate_node_reduce(stacks, 4, use_aps, 5, 2)
    for a, b in zip(per_leaf, got):
        _bitwise(a.numpy(), b)


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("cap", [50, None])
def test_launches_follow_emulate_design(monkeypatch, sr, cap):
    """The casts one rank's reduce makes, counted on the plain versions
    the CPU runs (the names `cast_site` dispatches to), equal the design
    that chip_smoke.py's `emulate_design` states: RTNE one cast and N add-casts a bucket; SR one
    flat bits draw and one cast a leaf, N bits draws and N add-casts a
    leaf for the sum; none at N = 1."""
    counts, n = {}, 4

    def counting(name, fn):
        def wrapped(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped

    if cap is not None:
        monkeypatch.setattr(temu, "DEFAULT_BUCKET_ELEMS", cap)
    for name, ref in (("quantize_cast", "quantize_cast_ref"),
                      ("quantize_add", "quantize_add_ref"),
                      ("quantize_cast_sr", "quantize_cast_sr_ref"),
                      ("quantize_add_sr", "quantize_add_sr_ref"),
                      ("sr_bits", "sr_bits_ref")):
        monkeypatch.setattr(tred, ref, counting(name, getattr(tred, ref)))
    stacks = [torch.from_numpy(g) for g in _stacks(n, seed=2)]
    temu.emulate_node_reduce(
        stacks, n, True, 5, 2, key=(0, 9) if sr else None,
        rounding="stochastic" if sr else "nearest")
    leaves = len(stacks)
    buckets = len(bucket_layout([g[0].numel() for g in stacks],
                                temu.DEFAULT_BUCKET_ELEMS))
    assert buckets == (1 if cap is None else 2)
    assert counts == (
        {"sr_bits": (n + 1) * leaves, "quantize_cast_sr": leaves,
         "quantize_add_sr": n * leaves} if sr else
        {"quantize_cast": buckets, "quantize_add": n * buckets})
    counts.clear()
    temu.emulate_node_reduce([g[:1] for g in stacks], 1, True, 5, 2)
    assert counts == {}


def test_rounding_and_key_contract():
    """A key with 'nearest' would be ignored and raises; 'stochastic'
    without a key raises; an unknown rounding raises."""
    stacks = [torch.zeros(2, 3)]
    with pytest.raises(ValueError, match="nearest"):
        temu.emulate_node_reduce(stacks, 2, key=(0, 1))
    with pytest.raises(ValueError, match="requires"):
        temu.emulate_node_reduce(stacks, 2, rounding="stochastic")
    with pytest.raises(ValueError, match="unknown rounding"):
        temu.emulate_node_reduce(stacks, 2, rounding="up")
    with pytest.raises(ValueError, match="CUDA"):
        temu.emulate_node_reduce(stacks, 2, fused=True)
