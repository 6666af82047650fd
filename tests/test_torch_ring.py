"""The port's gradient reduce vs the JAX package, BITWISE.

Seeded numpy inputs go through both packages: the bucket layout, the
ordered requantizing sum, the ring on a `LocalMesh` of W ranks against
the JAX ring under `shard_map` on W of the 8 virtual CPU devices (and
against both oracles), and `sum_gradients` in ring and faithful mode
with APS on a ResNet-shaped leaf list — each with round-to-nearest-even
and with stochastic rounding (the port's `prng` keys against the same
`jax.random` keys), plain and Kahan-compensated.  The JAX ring runs its plain arm,
as it does on the CPU; the port's fused arms need the card, where
`test_fused_ring_matches_oracle_on_card` holds them to the oracle.
No input is an fp32 subnormal: XLA:CPU flushes those to zero in its
adds, which the port, like the card, does not.  No column is -0.0 on
every rank: XLA folds ``0 + x`` to ``x`` in some of the reference's
programs and not in others, so the reference itself returns either sign
there (the port's hop 0 casts the chunk itself, as the JAX ring runs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cpd_tpu.compat import shard_map
from cpd_tpu.parallel import dist as jdist
from cpd_tpu.parallel import overlap as jover
from cpd_tpu.parallel import reduction as jred
from cpd_tpu.parallel import ring as jring
from cpd_tpu.parallel.mesh import make_mesh
from cpd_tpu_torch.ops import quantize as tq
from cpd_tpu_torch.parallel import dist as tdist
from cpd_tpu_torch.parallel import overlap as tover
from cpd_tpu_torch.parallel import reduction as tred
from cpd_tpu_torch.parallel import ring as tring
from cpd_tpu_torch.parallel.mesh import LocalMesh
from cpd_tpu_torch.quant import prng

# a ResNet-shaped leaf list (tiny widths): conv kernels, BN scale/bias
# pairs, the head; odd sizes so buckets and ring chunks have ragged ends
LEAF_SHAPES = [(8, 3, 3, 3), (8,), (8,), (16, 8, 3, 3), (16,), (16,),
               (16, 16, 3, 3), (16,), (16,), (16, 8, 1, 1), (16,), (16,),
               (10, 16), (10,)]


def _bitwise(want, got, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  got.view(np.uint32), err_msg=msg)


def _stack(world, n, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(world, n) * 0.3).astype(np.float32)
    x[:, 0] = 0.0
    return x


def _tkey(k) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def _jax_ring(world, stacked, exp, man, **kw):
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    fn = jax.jit(shard_map(
        lambda st: jring.ring_quantized_sum(st[0], "dp", exp, man, **kw),
        mesh=mesh, in_specs=(P("dp"),), out_specs=P(), check_vma=False))
    return np.asarray(fn(jax.device_put(jnp.asarray(stacked),
                                        NamedSharding(mesh, P("dp")))))


def test_bucket_layout_matches_jax():
    rng = np.random.default_rng(0)
    sizes = [int(s) for s in rng.integers(1, 5000, 40)]
    groups = [int(g) for g in rng.integers(0, 2, 40)]
    for cap in (1, 100, 4096, 10**6, tover.DEFAULT_BUCKET_ELEMS):
        assert tover.bucket_layout(sizes, cap) == \
            jover.bucket_layout(sizes, cap)
        assert tover.bucket_layout(sizes, cap, groups) == \
            jover.bucket_layout(sizes, cap, groups)
    assert tover.DEFAULT_BUCKET_ELEMS == jover.DEFAULT_BUCKET_ELEMS


@pytest.mark.parametrize("fmt", [(5, 2), (4, 3), (5, 1), (8, 23)])
def test_ordered_sum_matches_jax(fmt):
    """Bitwise for the requantizing scan.  At (8, 23) both take the
    plain fp32 sum, whose order is XLA's own: to 1e-6 relative there."""
    st = _stack(5, 777, seed=sum(fmt))
    want = jred.quantized_sum(jnp.asarray(st), *fmt)
    got = tred.quantized_sum(torch.from_numpy(st), *fmt)
    if fmt == (8, 23):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    else:
        _bitwise(want, got)


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("fmt", [(5, 2), (5, 1), (6, 17)])
def test_ring_matches_jax_ring_and_oracles(world, fmt):
    """Bitwise: the port's ring (packed wire; unpacked at (5, 1)) on a
    LocalMesh == the JAX ring under shard_map == both oracles."""
    st = _stack(world, 1001, seed=world + fmt[1])
    want = _jax_ring(world, st, *fmt)
    _bitwise(want, jring.ring_oracle_sum(jnp.asarray(st), *fmt))
    mesh = LocalMesh(world, "cpu")
    got = tring.ring_quantized_sum(list(torch.from_numpy(st)), mesh, *fmt)
    assert len(got) == world
    for g in got:
        _bitwise(want, g, f"W={world} {fmt}")
    _bitwise(want, tring.ring_oracle_sum(torch.from_numpy(st), *fmt))
    unpacked = tring.ring_quantized_sum(list(torch.from_numpy(st)), mesh,
                                        *fmt, packed=False)
    _bitwise(want, unpacked[0])


@pytest.mark.parametrize("kahan,sr", [(True, False), (False, True),
                                      (True, True)])
@pytest.mark.parametrize("fmt", [(5, 2), (4, 3), (8, 23)])
def test_ordered_and_kahan_sums_sr_match_jax(fmt, kahan, sr):
    """Bitwise: the ordered scan with SR and the Kahan scan with RTNE and
    SR, with default (leaf-local) offsets, an offset start past 2^31 and
    one whose offsets wrap past 2^32.  (8, 23) with Kahan has no fp32
    shortcut."""
    st = _stack(5, 777, seed=sum(fmt) + 3)
    key = jax.random.PRNGKey(sum(fmt)) if sr else None
    tkey = _tkey(key) if sr else None
    for start in (None, 2**31 + 9, 2**32 - 300):
        joffs = None if start is None else jnp.asarray(
            (np.arange(777, dtype=np.uint64) + start).astype(np.uint32))
        tkw = {} if start is None else dict(offset_start=start)
        want = jred.quantized_sum(jnp.asarray(st), *fmt, kahan, key=key,
                                  offsets=joffs if sr else None)
        got = tred.quantized_sum(torch.from_numpy(st), *fmt, kahan,
                                 key=tkey, **(tkw if sr else {}))
        if fmt == (8, 23) and not kahan:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
        else:
            _bitwise(want, got, f"{fmt} kahan={kahan} sr={sr} {tkw}")
        if not sr:
            break


def test_kahan_subtraction_as_negated_addition_is_exact():
    """x - y == x + (-y) bitwise in fp32 round-to-nearest, signed zeros
    included: what lets each Kahan site run as one K3/K4 launch."""
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2**32, (2, 20000), dtype=np.uint64)
    x, y = bits.astype(np.uint32).view(np.float32)
    keep = ~(np.isnan(x) | np.isnan(y))
    x, y = torch.from_numpy(x[keep]), torch.from_numpy(y[keep])
    z = torch.tensor([0.0, -0.0, 0.0, -0.0, 1.5, -1.5])
    w = torch.tensor([0.0, 0.0, -0.0, -0.0, 1.5, -1.5])
    for a, b in [(x, y), (z, w), (w, z)]:
        _bitwise((a - b).numpy(), a + (-b))
    for fmt in [(5, 2), (8, 23)]:
        _bitwise(tq.quantize_add_ref(x, -y, *fmt).numpy(),
                 tq.quantize_add_ref(x - y, torch.zeros_like(x), *fmt))


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("kahan,sr", [(True, False), (False, True),
                                      (True, True)])
def test_ring_kahan_sr_matches_jax_ring_and_oracles(world, kahan, sr):
    """Bitwise at W in {2, 4, 8}, odd lengths (ragged last chunk): the
    port's ring on a LocalMesh (packed wire at (5, 2), unpacked at
    (5, 1)) == the JAX ring under shard_map == both oracles, with Kahan,
    SR and both; the SR bits indexed from an offset start past 2^31."""
    n = 1001 + world
    for fmt in [(5, 2), (5, 1)]:
        st = _stack(world, n, seed=world * 3 + fmt[1] + 2 * kahan)
        key = jax.random.PRNGKey(world + fmt[1]) if sr else None
        kw = dict(use_kahan=kahan, key=key, offset_start=2**31 + 17)
        want = _jax_ring(world, st, *fmt, **kw)
        _bitwise(want, jring.ring_oracle_sum(jnp.asarray(st), *fmt, **kw))
        kw["key"] = _tkey(key) if sr else None
        mesh = LocalMesh(world, "cpu")
        got = tring.ring_quantized_sum(list(torch.from_numpy(st)), mesh,
                                       *fmt, **kw)
        assert len(got) == world
        for g in got:
            _bitwise(want, g, f"W={world} {fmt} kahan={kahan} sr={sr}")
        _bitwise(want, tring.ring_oracle_sum(torch.from_numpy(st), *fmt,
                                             **kw))


def test_ring_sr_offsets_wrap_past_2_32_match_jax():
    """Bitwise: the SR ring whose chunk offsets wrap past 2^32 (the
    offset start of a bucket near the top of the uint32 index space),
    plain and Kahan, against the JAX ring and both oracles."""
    world, n = 4, 203
    st = _stack(world, n, seed=11)
    key = jax.random.PRNGKey(8)
    for kahan in (False, True):
        kw = dict(key=key, use_kahan=kahan, offset_start=2**32 - 100)
        want = _jax_ring(world, st, 5, 2, **kw)
        _bitwise(want, jring.ring_oracle_sum(jnp.asarray(st), 5, 2, **kw))
        kw["key"] = _tkey(key)
        got = tring.ring_quantized_sum(list(torch.from_numpy(st)),
                                       LocalMesh(world, "cpu"), 5, 2, **kw)
        for g in got:
            _bitwise(want, g, f"kahan={kahan}")
        _bitwise(want, tring.ring_oracle_sum(torch.from_numpy(st), 5, 2,
                                             **kw))


def test_ring_layout_helpers_match_jax():
    for n, w in [(0, 4), (1, 4), (1001, 8), (4096, 4)]:
        assert tring.ring_chunk_size(n, w) == jring.ring_chunk_size(n, w)
        x = np.arange(n, dtype=np.float32)
        _bitwise(jring.pad_to_world(jnp.asarray(x), w),
                 tring.pad_to_world(torch.from_numpy(x), w))


def _leaves(world, seed):
    rng = np.random.RandomState(seed)
    out = []
    for i, shape in enumerate(LEAF_SHAPES):
        g = rng.randn(world, *shape).astype(np.float32)
        out.append(g * np.float32(10.0 ** (i % 5 - 4)))
    out[5][:] = 0.0                          # an all-zero leaf: shift 0
    return out


@pytest.mark.parametrize("mode,bucket_elems",
                         [("ring", None), ("ring", 600), ("faithful", None)])
def test_sum_gradients_matches_jax(mode, bucket_elems):
    """Bitwise: APS + (5, 2) RTNE sum_gradients over W=4 ranks, one bucket
    and several (ragged) buckets."""
    world = 4
    leaves = _leaves(world, seed=7)
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    jfn = jdist.make_sum_gradients_fn(mesh, axis_name="dp", use_aps=True,
                                      grad_exp=5, grad_man=2, mode=mode,
                                      bucket_elems=bucket_elems)
    want = jfn([jax.device_put(jnp.asarray(g), NamedSharding(mesh, P("dp")))
                for g in leaves])
    tfn = tdist.make_sum_gradients_fn(LocalMesh(world, "cpu"), use_aps=True,
                                      grad_exp=5, grad_man=2, mode=mode,
                                      bucket_elems=bucket_elems)
    got = tfn([torch.from_numpy(g) for g in leaves])
    for i, (w, g) in enumerate(zip(want, got)):
        assert tuple(g.shape) == LEAF_SHAPES[i]
        _bitwise(w, g, f"leaf {i}")


@pytest.mark.parametrize("mode,kahan,sr", [
    ("ring", False, True), ("ring", True, False), ("ring", True, True),
    ("faithful", False, True), ("faithful", True, False),
    ("faithful", True, True)])
def test_sum_gradients_sr_kahan_matches_jax(mode, kahan, sr):
    """Bitwise: APS + (5, 2) sum_gradients over W=4 ranks with SR (the
    three-way key split, the rank folded into the pre-quantize key,
    global leaf offsets), Kahan, and both, over several ragged buckets
    (the JAX faithful path reduces per leaf: the offsets make the bits
    the same)."""
    world = 4
    leaves = _leaves(world, seed=13)
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    key = jdist.grad_sr_key(3, 7, 1) if sr else None
    kw = dict(use_aps=True, grad_exp=5, grad_man=2, mode=mode,
              use_kahan=kahan, rounding="stochastic" if sr else "nearest")
    jfn = jdist.make_sum_gradients_fn(
        mesh, axis_name="dp", key=key,
        bucket_elems=600 if mode == "ring" else None, **kw)
    want = jfn([jax.device_put(jnp.asarray(g), NamedSharding(mesh, P("dp")))
                for g in leaves])
    tfn = tdist.make_sum_gradients_fn(
        LocalMesh(world, "cpu"), key=_tkey(key) if sr else None,
        bucket_elems=600, **kw)
    got = tfn([torch.from_numpy(g) for g in leaves])
    for i, (w, g) in enumerate(zip(want, got)):
        assert tuple(g.shape) == LEAF_SHAPES[i]
        _bitwise(w, g, f"leaf {i}")


def _fast_leaves(world, seed):
    """`_leaves` where no element casts to -0.0 on every rank: the JAX
    psum returns +0.0 there (Queue C: XLA's sum starts from or folds in
    +0.0), the port's rank-order sum -0.0.  Rank 0's values below 1e-3 in
    magnitude are made positive."""
    out = _leaves(world, seed)
    for g in out:
        g[0] = np.where(np.abs(g[0]) < 1e-3, np.abs(g[0]), g[0])
    return out


# (world, use_aps, stochastic rounding, format): every combination at W = 2;
# APS (5, 2) RTNE at W = 4 and SR at W = 8
FAST_CASES = ([(2, aps, sr, fmt) for aps in (False, True)
               for sr in (False, True) for fmt in ((5, 2), (8, 23))]
              + [(4, True, False, (5, 2)), (8, True, True, (5, 2))])


@pytest.mark.parametrize("world,aps,sr,fmt", FAST_CASES)
def test_sum_gradients_fast_matches_jax(world, aps, sr, fmt):
    """Bitwise: ``mode="fast"`` (each rank's cast where APS has not cast,
    none at (8, 23); the fp32 sum over the ranks; one cast of the sum with
    ``k_post``; the APS unscale) against the JAX package's under
    shard_map.  At W = 2 the sum of two values has one order; at W = 4
    and 8 the port's rank-order sum equals the JAX psum bitwise too on
    these inputs.  With ``verify`` the report is the agreement alone."""
    leaves = _fast_leaves(world, seed=13 + world)
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    key = jdist.grad_sr_key(3, 7, 1) if sr else None
    kw = dict(use_aps=aps, grad_exp=fmt[0], grad_man=fmt[1], mode="fast",
              rounding="stochastic" if sr else "nearest")
    want = jdist.make_sum_gradients_fn(mesh, axis_name="dp", key=key, **kw)(
        [jax.device_put(jnp.asarray(g), NamedSharding(mesh, P("dp")))
         for g in leaves])
    tfn = tdist.make_sum_gradients_fn(
        LocalMesh(world, "cpu"), key=_tkey(key) if sr else None,
        verify=True, **kw)
    got, report = tfn([torch.from_numpy(g) for g in leaves])
    for i, (w, g) in enumerate(zip(want, got)):
        assert tuple(g.shape) == LEAF_SHAPES[i]
        _bitwise(w, g, f"leaf {i}")
    assert {k: int(v) for k, v in report.items()} == {
        "hop_bad": 0, "gather_bad": 0, "agree": 1, "ok": 1}


def test_unported_and_misplaced_options_raise():
    """What the reduce refuses: fused kernels on CPU tensors, a key
    without stochastic rounding and the reverse.  Reduce-wire telemetry
    (stats=) is ported: it returns the report instead of raising."""
    mesh = LocalMesh(2, "cpu")
    flats = [torch.zeros(10), torch.zeros(10)]
    with pytest.raises(ValueError, match="CUDA"):
        tring.ring_quantized_sum(flats, mesh, 5, 2, fused=True)
    _, report = tdist.sum_gradients([[f] for f in flats], mesh, mode="ring",
                                    stats=True)
    assert int(report["wire_total"]) == 20 and int(report["aps_bad"]) == 0
    with pytest.raises(ValueError, match="requires a PRNG key"):
        tdist.sum_gradients([[f] for f in flats], mesh,
                            rounding="stochastic")
    with pytest.raises(ValueError, match="rounding='nearest'"):
        tdist.sum_gradients([[f] for f in flats], mesh, key=(0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [(5, 2), (5, 1), (5, 7)])
def test_fused_ring_matches_oracle_on_card(fmt):
    """Bitwise, on the card: the fused ring (K6 + K5, or K3 at (5, 1))
    == ring_oracle_sum, with the launches the design predicts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    world = 4
    st = torch.from_numpy(_stack(world, 100_003, seed=3)).cuda()
    mesh = LocalMesh(world, "cuda")
    before = (tq.quantize_pack.launches, tq.hop_pack.launches,
              tq.quantize_add.launches)
    got = tring.ring_quantized_sum(list(st), mesh, *fmt)
    want = tring.ring_oracle_sum(st, *fmt)
    for g in got:
        _bitwise(want.cpu(), g.cpu())
    after = (tq.quantize_pack.launches, tq.hop_pack.launches,
             tq.quantize_add.launches)
    packed = fmt[1] >= 2
    assert [a - b for a, b in zip(after, before)] == (
        [world, world * (world - 1), 0] if packed
        else [0, 0, world * (world - 1)])
