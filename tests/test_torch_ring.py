"""The port's gradient reduce vs the JAX package, BITWISE.

Seeded numpy inputs go through both packages: the bucket layout, the
ordered requantizing sum, the ring on a `LocalMesh` of W ranks against
the JAX ring under `shard_map` on W of the 8 virtual CPU devices (and
against both oracles), and `sum_gradients` in ring and faithful mode
with APS on a ResNet-shaped leaf list.  The JAX ring runs its plain arm,
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


def _jax_ring(world, stacked, exp, man):
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    fn = jax.jit(shard_map(
        lambda st: jring.ring_quantized_sum(st[0], "dp", exp, man),
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


def test_unported_and_misplaced_options_raise():
    mesh = LocalMesh(2, "cpu")
    flats = [torch.zeros(10), torch.zeros(10)]
    for kw, match in [(dict(use_kahan=True), "Kahan"),
                      (dict(key=0), "stochastic"),
                      (dict(block_scale=True), "block-scaled"),
                      (dict(verify=True), "verified"),
                      (dict(fault=(1, 0)), "fault")]:
        with pytest.raises(NotImplementedError, match=match):
            tring.ring_quantized_sum(flats, mesh, 5, 2, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tring.ring_quantized_sum(flats, mesh, 5, 2, fused=True)
    with pytest.raises(NotImplementedError, match="fast"):
        tdist.sum_gradients([[f] for f in flats], mesh, mode="fast")
    with pytest.raises(NotImplementedError, match="stochastic"):
        tdist.sum_gradients([[f] for f in flats], mesh,
                            rounding="stochastic")


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
