"""The reduce's numeric-health telemetry on the port vs the JAX package
(tests/test_precision.py:67-120, 220-270).

All comparisons are BITWISE or exact counts: `quant_health` and
`cast_to_format_stats` on the probe values, the DAZ-proof cases (an
fp32-subnormal input that flushes is underflow, a subnormal output of
an e8 format is not) and random values over five formats;
`tree_quant_health` in both its forms (one count over the leaves
concatenated, and leaf by leaf past 2^24 elements);
`sum_gradients(stats=True)` at W in {2, 4}, modes
faithful, ring and fast, APS on and off — the same counts as the JAX
package's under shard_map, ``aps_bad`` included, and reduced values
bitwise those of ``stats=False`` — and ``aps_bad`` on an Inf gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cpd_tpu.compat import shard_map
from cpd_tpu.parallel import dist as jdist
from cpd_tpu.parallel.mesh import make_mesh
from cpd_tpu.quant import numerics as jnum
from cpd_tpu.quant.quant_function import tree_quant_health as j_tree_health
from cpd_tpu_torch.parallel import dist as tdist
from cpd_tpu_torch.parallel.mesh import LocalMesh
from cpd_tpu_torch.quant import numerics as tnum

# (4,3): max_finite = 240, min subnormal = 2^-9
PROBE = np.array([0.1, 500.0, -600.0, np.inf, -np.inf, np.nan, 1e-9, 0.0,
                  -2.5e-7, 240.0], np.float32)
SHAPES = [(8, 3, 3, 3), (8,), (10, 8)]


def _ints(h):
    return {k: int(v) for k, v in h.items()}


def _bitwise(want, got, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  got.view(np.uint32), err_msg=msg)


def test_quant_health_probe_and_daz_cases_match_jax():
    """The probe's counts (saturation of 500/-600 and the Infs, two
    underflows, one NaN), and the DAZ-proof cases: two fp32-subnormal
    inputs flushed to +0 count as underflow; an fp32-subnormal OUTPUT
    (kept by an e8 format) does not."""
    q = tnum.cast_to_format(torch.from_numpy(PROBE), 4, 3)
    h = tnum.quant_health(torch.from_numpy(PROBE), q)
    assert _ints(h) == {"sat": 4, "underflow": 2, "nan": 1, "total": 10}
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in h.values())
    assert h == pytest.approx({k: float(v) for k, v in jnum.quant_health(
        jnp.asarray(PROBE), jnum.cast_to_format(jnp.asarray(PROBE), 4,
                                                3)).items()})
    x = np.array([-1e-45, 1e-42, -0.0, 0.0], np.float32)
    tx = torch.from_numpy(x)
    assert _ints(tnum.quant_health(tx, tnum.cast_to_format(tx, 5, 2))) == \
        {"sat": 0, "underflow": 2, "nan": 0, "total": 4}
    jx = jnp.asarray(x)
    assert _ints(jnum.quant_health(jx, jnum.cast_to_format(jx, 5, 2))) == \
        {"sat": 0, "underflow": 2, "nan": 0, "total": 4}
    y = torch.from_numpy(np.array([2.0e-39], np.float32))
    assert int(tnum.quant_health(y, y.clone())["underflow"]) == 0


@pytest.mark.parametrize("fmt", [(4, 3), (5, 2), (5, 7), (3, 4), (8, 23)])
def test_cast_to_format_stats_matches_jax(fmt):
    """``q`` bitwise the plain cast and JAX's; the counters JAX's, on
    values over 16 decades plus the probe."""
    rng = np.random.RandomState(sum(fmt))
    x = np.concatenate([
        rng.randn(200).astype(np.float32) * 10.0 ** rng.randint(-8, 8, 200),
        PROBE]).astype(np.float32)
    q, h = tnum.cast_to_format_stats(torch.from_numpy(x), *fmt)
    jq, jh = jnum.cast_to_format_stats(jnp.asarray(x), *fmt)
    _bitwise(jq, q)
    _bitwise(tnum.cast_to_format(torch.from_numpy(x), *fmt).numpy(), q)
    assert _ints(h) == _ints(jh)


def test_tree_quant_health_sums_leaves_and_empty():
    x = [torch.from_numpy(PROBE), torch.from_numpy(PROBE)]
    q = [tnum.cast_to_format(t, 4, 3) for t in x]
    assert _ints(tdist.tree_quant_health(x, q)) == {
        "sat": 8, "underflow": 4, "nan": 2, "total": 20}
    jx = [jnp.asarray(PROBE)] * 2
    assert _ints(j_tree_health(jx, [jnum.cast_to_format(t, 4, 3)
                                    for t in jx])) == {
        "sat": 8, "underflow": 4, "nan": 2, "total": 20}
    assert _ints(tdist.tree_quant_health([], [])) == {
        "sat": 0, "underflow": 0, "nan": 0, "total": 0}


def _bits(h):
    return {k: np.asarray(v, np.float32).view(np.uint32).item()
            for k, v in h.items()}


def test_tree_quant_health_paths_match_jax(monkeypatch):
    """Both forms of `tree_quant_health` bitwise JAX's float32 leaf-by-
    leaf sums.  Past EXACT_COUNTS (2^24 saturating elements, then three
    leaves of one) JAX's sum stays at 2^24 and the leaf-by-leaf form
    with it, while one count over the concatenation would give 2^24 + 4;
    below it the leaf-by-leaf form (the switch forced) equals JAX's on
    the probe too."""
    big = 1 << 24
    before = [torch.ones(big)] + [torch.ones(1)] * 3
    after = [torch.full((big,), np.inf)] + [torch.full((1,), np.inf)] * 3
    want = _bits(j_tree_health([jnp.ones(big)] + [jnp.ones(1)] * 3,
                               [jnp.full(big, np.inf)]
                               + [jnp.full(1, np.inf)] * 3))
    assert want["sat"] == want["total"] == np.float32(big).view(np.uint32)
    assert _bits(tdist.tree_quant_health(before, after)) == want
    monkeypatch.setattr(tdist, "EXACT_COUNTS", 2 * big)
    assert int(tdist.tree_quant_health(before, after)["sat"]) == big + 4
    del before, after
    monkeypatch.setattr(tdist, "EXACT_COUNTS", 0)
    x = [torch.from_numpy(PROBE), torch.from_numpy(PROBE[::-1].copy())]
    q = [tnum.cast_to_format(t, 4, 3) for t in x]
    assert _bits(tdist.tree_quant_health(x, q)) == _bits(j_tree_health(
        [jnp.asarray(t.numpy()) for t in x],
        [jnum.cast_to_format(jnp.asarray(t.numpy()), 4, 3) for t in x]))


def _leaves(world, seed):
    rng = np.random.RandomState(seed)
    out = [(rng.randn(world, *s) * 0.1).astype(np.float32) for s in SHAPES]
    out[0][1, 3, 0, 0, 2] = 5000.0      # saturates the W-scaled (4, 3) probe
    out[2][0, 3, 1] = 3e-6              # underflows (4, 3)
    # the fast sum's -0.0 quirk (ROADMAP Queue C): rank 0 non-negative,
    # so no element casts to -0.0 on every rank
    for g in out:
        g[0] = np.abs(g[0])
    return out


def _jax_stats(world, leaves, **kw):
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])

    def body(*st):
        return jdist.sum_gradients([s[0] for s in st], "dp", stats=True,
                                   **kw)

    fn = jax.jit(shard_map(body, mesh=mesh,
                           in_specs=tuple(P("dp") for _ in leaves),
                           out_specs=(P(), P()), check_vma=False))
    return fn(*[jax.device_put(jnp.asarray(g), NamedSharding(mesh, P("dp")))
                for g in leaves])


@pytest.mark.parametrize("use_aps", [False, True])
@pytest.mark.parametrize("mode", ["faithful", "ring", "fast"])
@pytest.mark.parametrize("world", [2, 4])
def test_sum_gradients_stats_match_jax(world, mode, use_aps):
    """The counts JAX's shard_map reports (with APS: the pre-quantize's
    pair; without: the W-scaled probe), ``wire_total`` W x elements, and
    the reduced leaves bitwise JAX's and those of ``stats=False``."""
    leaves = _leaves(world, seed=world * 3 + use_aps)
    kw = dict(use_aps=use_aps, grad_exp=4, grad_man=3, mode=mode)
    jred, jrep = _jax_stats(world, leaves, **kw)
    mesh = LocalMesh(world, "cpu")
    per_rank = [[torch.from_numpy(g[r]) for g in leaves]
                for r in range(world)]
    plain = tdist.sum_gradients(per_rank, mesh, **kw)
    got, rep = tdist.sum_gradients(per_rank, mesh, stats=True, **kw)
    for r in range(world):
        for a, b in zip(plain[r], got[r]):
            _bitwise(a.numpy(), b)
    for i, (a, b) in enumerate(zip(jred, got[0])):
        _bitwise(a, b, f"leaf {i}")
    assert set(rep) == {"wire_sat", "wire_underflow", "wire_nan",
                        "wire_total", "aps_bad"}
    assert _ints(rep) == _ints(jrep)
    assert int(rep["wire_total"]) == world * sum(
        int(np.prod(s)) for s in SHAPES)
    if not use_aps:
        assert int(rep["wire_sat"]) >= 1 and int(rep["wire_underflow"]) >= 1


def test_sum_gradients_stats_merge_with_verify():
    """``verify`` and ``stats`` together: one report with both sets."""
    leaves = _leaves(2, seed=1)
    per_rank = [[torch.from_numpy(g[r]) for g in leaves] for r in range(2)]
    _, rep = tdist.sum_gradients(per_rank, LocalMesh(2, "cpu"),
                                 use_aps=True, grad_exp=4, grad_man=3,
                                 mode="ring", verify=True, stats=True)
    assert _ints(rep)["ok"] == 1 and "wire_total" in rep


def test_sum_gradients_stats_aps_bad_on_inf_grad():
    """An Inf gradient: ``aps_bad`` counts its leaf (from the rank-MAX'd
    exponents), and the Inf rides the wire as saturation — as JAX's."""
    world = 2
    leaves = _leaves(world, seed=5)
    leaves[1][0, 0] = np.inf
    kw = dict(use_aps=True, grad_exp=4, grad_man=3)
    _, jrep = _jax_stats(world, leaves, **kw)
    per_rank = [[torch.from_numpy(g[r]) for g in leaves]
                for r in range(world)]
    _, rep = tdist.sum_gradients(per_rank, LocalMesh(world, "cpu"),
                                 stats=True, **kw)
    assert int(rep["aps_bad"]) == 1 and int(rep["wire_sat"]) >= 1
    assert _ints(rep) == _ints(jrep)
