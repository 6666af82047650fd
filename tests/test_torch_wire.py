"""The port's block-scaled, self-verifying ring vs the JAX package.

Every comparison is BITWISE unless its docstring says otherwise: the
blocked codec's analytics and SR cast, the tag algebra and digests, the
blocked arms of K6/K5 and K7's plain versions against the Pallas kernels
in interpret mode, the blocked ring on a `LocalMesh` against the JAX ring
under `shard_map` and both oracles, the verified ring's reports (clean
and under each wire fault, per rank), the bytes the ring moves,
`sum_gradients` with block scale and verify, and two train steps (to the
tolerance `tests/test_torch_train.py` states).  Inputs come from seeded
numpy with block-structured magnitudes; none is an fp32 subnormal and no
column is -0.0 on every rank (XLA:CPU flushes the one and folds
``0 + x`` for the other, ROADMAP Queue C).  The kernels themselves need
the card: the ``cuda``-marked tests hold them to their plain versions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cpd_tpu.compat import shard_map
from cpd_tpu.data import cifar as jcifar
from cpd_tpu.ops.quantize import (digest_rows_pallas, hop_pack_pallas,
                                  quantize_pack_pallas)
from cpd_tpu.parallel import dist as jdist
from cpd_tpu.parallel import integrity as jint
from cpd_tpu.parallel import ring as jring
from cpd_tpu.parallel.mesh import make_mesh
from cpd_tpu.quant import numerics as jnum
from cpd_tpu_torch.examples.resnet18_cifar import train as tcli
from cpd_tpu_torch.ops import quantize as tq
from cpd_tpu_torch.parallel import dist as tdist
from cpd_tpu_torch.parallel import integrity as tint
from cpd_tpu_torch.parallel import ring as tring
from cpd_tpu_torch.parallel.mesh import LocalMesh
from cpd_tpu_torch.quant import numerics as tnum

# the ResNet-shaped leaf list of tests/test_torch_ring.py
LEAF_SHAPES = [(8, 3, 3, 3), (8,), (8,), (16, 8, 3, 3), (16,), (16,),
               (16, 16, 3, 3), (16,), (16,), (16, 8, 1, 1), (16,), (16,),
               (10, 16), (10,)]
CLEAN = {"hop_bad": 0, "gather_bad": 0, "agree": 1, "ok": 1}
FAULTED = {"hop_bad": 1, "gather_bad": 1, "agree": 0, "ok": 0}


def _bitwise(want, got, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert want.shape == got.shape, (want.shape, got.shape, msg)
    np.testing.assert_array_equal(want.view(np.uint8), got.view(np.uint8),
                                  err_msg=msg)


def _spread(world, n, seed=0, region=16, spread=30):
    """tests/test_ring.py's `_spread_stack`: magnitudes shared by the
    ranks in regions of 16 elements, 2^-30..2^30 apart."""
    rng = np.random.RandomState(seed)
    nr = -(-n // region)
    scale = np.exp2(rng.uniform(-spread, spread, (1, nr))
                    ).repeat(region, axis=1)[:, :n]
    return (rng.randn(world, n) * scale).astype(np.float32)


def _tkey(k) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def _bits_t(bits) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bits).view(np.int32).copy())


def _rep(report) -> dict:
    return {k: int(v) for k, v in report.items()}


def _jax_ring(world, stacked, exp, man, out_specs=P(), **kw):
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    fn = jax.jit(shard_map(
        lambda st: jring.ring_quantized_sum(st[0], "dp", exp, man, **kw),
        mesh=mesh, in_specs=(P("dp"),), out_specs=out_specs,
        check_vma=False))
    return fn(jax.device_put(jnp.asarray(stacked),
                             NamedSharding(mesh, P("dp"))))


@functools.lru_cache(maxsize=None)
def _jax_faulted_ring(world, exp, man, blocked):
    """The JAX verified ring with the fault ``(code, rank)`` an operand,
    so that one compile serves every fault code; per-rank vectors."""
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    kw = dict(block_scale=True, block_size=32) if blocked else {}
    fn = jax.jit(shard_map(
        lambda st, code, rank: jring.ring_quantized_sum(
            st[0], "dp", exp, man, verify=True, fault=(code, rank), **kw),
        mesh=mesh, in_specs=(P("dp"), P(), P()), out_specs=(P("dp"), P()),
        check_vma=False))
    return lambda st, code, rank: fn(
        jax.device_put(jnp.asarray(st), NamedSharding(mesh, P("dp"))),
        jnp.int32(code), jnp.int32(rank))


# -- the codec and the digest helpers ------------------------------------

def test_wire_bytes_blocked_and_transport_table_match_jax():
    for n in (0, 1, 127, 128, 1001, 988_944):
        for fmt in ((4, 3), (5, 2), (5, 7), (8, 2)):
            for b in (1, 33, 128, 65536):
                assert tnum.wire_bytes_blocked(*fmt, n, b) == \
                    jnum.wire_bytes_blocked(*fmt, n, b)
    for n, w in ((0, 4), (1001, 2), (3_955_776, 4), (103, 8)):
        for fmt in ((4, 3), (5, 2), (5, 1), (8, 23)):
            for kahan in (False, True):
                for b in (None, 33, 128):
                    assert tring.transport_table(
                        n, w, *fmt, use_kahan=kahan, block_size=b) == \
                        jring.transport_table(n, w, *fmt, use_kahan=kahan,
                                              block_size=b)
                    b_g = b if fmt[1] >= 2 else None
                    assert tring.gather_transport_bytes(
                        n, w, *fmt, compressed=kahan, block_size=b_g) == \
                        jring.gather_transport_bytes(
                            n, w, *fmt, compressed=kahan, block_size=b_g)
    with pytest.raises(ValueError, match="man_bits >= 2"):
        tnum.wire_bytes_blocked(5, 1, 10, 4)


@pytest.mark.parametrize("fmt", [(4, 3), (5, 2), (5, 7)])
def test_cast_body_blocked_sr_matches_jax(fmt):
    """The blocked cast, RTNE and with round bits, at blocks 1, 33 and
    128 over odd lengths (a short tail block), 2-d rows included."""
    rng = np.random.RandomState(sum(fmt))
    for n in (1, 301, 1001):
        x = _spread(3, n, seed=n + fmt[1])
        bits = rng.randint(0, 2**32, (3, n), dtype=np.uint64).astype(
            np.uint32)
        for b in (1, 33, 128):
            _bitwise(jnum.cast_body_blocked(jnp.asarray(x), *fmt, b),
                     tnum.cast_body_blocked(torch.from_numpy(x), *fmt, b),
                     f"{fmt} n={n} b={b}")
            _bitwise(jnum.cast_body_blocked(jnp.asarray(x), *fmt, b,
                                            rbits=jnp.asarray(bits)),
                     tnum.cast_body_blocked(torch.from_numpy(x), *fmt, b,
                                            rbits=_bits_t(bits)),
                     f"SR {fmt} n={n} b={b}")


def test_tag_algebra_and_tree_digest_match_jax():
    rng = np.random.RandomState(1)
    digests = rng.randint(0, 2**32, 50, dtype=np.uint64).astype(np.uint32)
    hops = np.array([0, 1, 7, 2**31 + 5], np.uint32)
    srcs = np.array([0, 2, 7, 65535], np.uint32)
    want = jint.tag_from_digest(jnp.asarray(digests)[:, None, None],
                                jnp.asarray(hops)[None, :, None],
                                jnp.asarray(srcs)[None, None, :])
    for i, hop in enumerate(hops):
        for j, src in enumerate(srcs):
            got = tint.tag_from_digest(
                torch.from_numpy(digests.astype(np.int64)), int(hop),
                int(src))
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(want)[:, i, j].astype(np.int64))
    # rank-vectorised, as the gather check runs it
    got = tint.tag_from_digest(torch.from_numpy(digests.astype(np.int64)),
                               0, torch.arange(50))
    want = jax.vmap(lambda d, i: jint.tag_from_digest(d, 0, i))(
        jnp.asarray(digests), jnp.arange(50, dtype=jnp.int32))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))
    payload = rng.randint(0, 256, 5000).astype(np.uint8)
    assert int(tint.hop_tag(torch.from_numpy(payload), 3, 2)) == \
        int(jint.hop_tag(jnp.asarray(payload), 3, 2))
    leaves = [rng.randn(*s).astype(np.float32) for s in LEAF_SHAPES]
    assert int(tint.tree_digest([torch.from_numpy(v) for v in leaves])) \
        == int(jax.jit(jint.tree_digest)(list(map(jnp.asarray, leaves))))
    assert int(tint.tree_digest([])) == int(jint.tree_digest([]))


def test_digest_concat_is_the_digest_of_the_concatenation():
    """At random split points of random buffers (and at the ends), and
    against the JAX function on three of them."""
    rng = np.random.RandomState(3)
    for it in range(20):
        total = int(rng.randint(1, 200_000))
        cut = (0, total)[it] if it < 2 else int(rng.randint(0, total + 1))
        buf = torch.from_numpy(rng.randint(0, 256, total).astype(np.uint8))
        a, b = buf[:cut], buf[cut:]
        got = tint.digest_concat(tint.wire_digest(a), cut,
                                 tint.wire_digest(b))
        assert int(got) == int(tint.wire_digest(buf)), (total, cut)
        if it % 7 == 0:
            assert int(got) == int(jint.digest_concat(
                jint.wire_digest(jnp.asarray(a.numpy())), cut,
                jint.wire_digest(jnp.asarray(b.numpy()))))
    lo = [torch.tensor(5), torch.tensor(5), torch.tensor(9)]
    assert [int(v) for v in tint.digest_agree(lo, LocalMesh(3, "cpu"))] \
        == [0, 0, 0]
    assert [int(v) for v in tint.digest_agree(lo[:2], LocalMesh(2, "cpu"))] \
        == [1, 1]


# -- the blocked arms of K6/K5 and K7: plain versions vs Pallas ----------

@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("fmt", [(4, 3), (5, 2), (5, 7)])
def test_blocked_wire_plain_versions_match_pallas(fmt, sr):
    """hop 0 and a later hop at block 128 (n = 301: a short tail block):
    partials, every wire byte (sidecar included) and the digests, with
    and without digests, against quantize_pack_pallas/hop_pack_pallas
    in interpret mode, as tests/test_ops_pallas.py runs them."""
    n = 301
    g0, g1 = _spread(2, n, seed=fmt[0] * 10 + fmt[1] + 7 * sr)
    key = jax.random.PRNGKey(5)
    offs = jnp.arange(n, dtype=jnp.uint32)
    rb0 = jnum.sr_bits_at(jax.random.fold_in(key, 0), offs) if sr else None
    rb1 = jnum.sr_bits_at(jax.random.fold_in(key, 1), offs) if sr else None
    t0 = None if rb0 is None else _bits_t(rb0)
    t1 = None if rb1 is None else _bits_t(rb1)
    jr0, jw0, jd0 = quantize_pack_pallas(
        jnp.asarray(g0), *fmt, rbits=rb0, block_size=128, want_digest=True,
        interpret=True)
    r0, w0, d0 = tq.quantize_pack(torch.from_numpy(g0), *fmt, rbits=t0,
                                  block_size=128, want_digest=True)
    _bitwise(jr0, r0, "hop 0 partial")
    _bitwise(jw0, w0, "hop 0 wire")
    assert int(d0) == int(jd0)
    assert w0.numel() == tnum.wire_bytes_blocked(*fmt, n, 128)
    _bitwise(jw0, tq.quantize_pack_ref(torch.from_numpy(g0), *fmt, rbits=t0,
                                       block_size=128)[1])
    jr1, jw1, jdi, jdo = hop_pack_pallas(
        jw0, jnp.asarray(g1), *fmt, rbits=rb1, block_size=128,
        want_digest=True, interpret=True)
    r1, w1, di, do = tq.hop_pack(w0, torch.from_numpy(g1), *fmt, rbits=t1,
                                 block_size=128, want_digest=True)
    _bitwise(jr1, r1, "hop partial")
    _bitwise(jw1, w1, "hop wire")
    assert (int(di), int(do)) == (int(jdi), int(jdo))
    r1b, w1b = tq.hop_pack_ref(w0, torch.from_numpy(g1), *fmt, rbits=t1,
                               block_size=128)
    _bitwise(jr1, r1b)
    _bitwise(jw1, w1b)


def test_digest_rows_plain_version_matches_pallas():
    rng = np.random.RandomState(0)
    for w, nb in [(8, 37), (4, 4096), (3, 65536 + 17), (1, 1)]:
        rows = rng.randint(0, 256, size=(w, nb)).astype(np.uint8)
        want = np.asarray(digest_rows_pallas(jnp.asarray(rows), True))
        got = tq.digest_rows(torch.from_numpy(rows))
        np.testing.assert_array_equal(want.astype(np.int64), got.numpy(),
                                      err_msg=f"({w}, {nb})")
        np.testing.assert_array_equal(tq.digest_rows_ref(
            torch.from_numpy(rows)).numpy(), got.numpy())


# -- the blocked ring ------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("fmt", [(5, 2), (4, 3)])
@pytest.mark.parametrize("variant", ["nearest", "stochastic", "kahan"])
def test_blocked_ring_matches_jax_ring_and_oracles(world, fmt, variant):
    """Block 33 (every chunk carries a short tail block): the port's ring
    on a LocalMesh == the JAX oracle == the port's oracle, RTNE, SR
    (offsets from past 2^31) and Kahan; at W = 4 the JAX ring under
    shard_map too (tests/test_ring.py holds it to its oracle at every
    W)."""
    st = _spread(world, 103, seed=world * 10 + fmt[0])
    key = jax.random.PRNGKey(world + fmt[1]) if variant == "stochastic" \
        else None
    kw = dict(use_kahan=variant == "kahan", key=key, block_scale=True,
              block_size=33, offset_start=2**31 + 5)
    want = np.asarray(jax.jit(lambda s: jring.ring_oracle_sum(s, *fmt, **kw))(
        jnp.asarray(st)))
    if world == 4:
        _bitwise(want, _jax_ring(world, st, *fmt, **kw))
    kw["key"] = None if key is None else _tkey(key)
    got = tring.ring_quantized_sum(list(torch.from_numpy(st)),
                                   LocalMesh(world, "cpu"), *fmt, **kw)
    assert len(got) == world
    for g in got:
        _bitwise(want, g, f"W={world} {fmt} {variant}")
    _bitwise(want, tring.ring_oracle_sum(torch.from_numpy(st), *fmt, **kw))


@pytest.mark.parametrize("sr", [False, True])
def test_blocked_ring_block_128_matches_jax(sr):
    """Block 128 at W = 4 (the slice's block; two whole blocks and a
    short one per chunk), the JAX ring on its fused wire (interpret mode)
    and on its plain arm, and both oracles."""
    world = 4
    st = _spread(world, 4 * 300 - 5, seed=17)
    key = jax.random.PRNGKey(9) if sr else None
    kw = dict(key=key, block_scale=True, block_size=128)
    want = np.asarray(_jax_ring(world, st, 4, 3, **kw))
    _bitwise(want, _jax_ring(world, st, 4, 3, fused=True, interpret=True,
                             **kw))
    _bitwise(want, jring.ring_oracle_sum(jnp.asarray(st), 4, 3, **kw))
    kw["key"] = None if key is None else _tkey(key)
    for g in tring.ring_quantized_sum(list(torch.from_numpy(st)),
                                      LocalMesh(world, "cpu"), 4, 3, **kw):
        _bitwise(want, g)
    _bitwise(want, tring.ring_oracle_sum(torch.from_numpy(st), 4, 3, **kw))


def test_blocked_ring_argument_errors_match_jax():
    z = [torch.zeros(4), torch.zeros(4)]
    mesh = LocalMesh(2, "cpu")
    for kw, match in [((8, 23), "nothing to scale"), ((6, 1), "packable")]:
        with pytest.raises(ValueError, match=match):
            tring.ring_quantized_sum(z, mesh, *kw, block_scale=True)
        with pytest.raises(ValueError, match=match):
            jring.ring_quantized_sum(jnp.zeros(4), "dp", *kw,
                                     block_scale=True, world=2)
    with pytest.raises(ValueError, match="block_size must be >= 1"):
        tring.ring_quantized_sum(z, mesh, 5, 2, block_scale=True,
                                 block_size=0)
    with pytest.raises(ValueError, match="packed=False"):
        tring.ring_quantized_sum(z, mesh, 5, 2, block_scale=True,
                                 packed=False)


# -- the verified ring and the faults ------------------------------------

@pytest.mark.parametrize("fmt,kw", [
    ((5, 2), {}), ((4, 3), dict(use_kahan=True)), ((8, 23), {}),
    ((4, 3), dict(block_scale=True, block_size=32)),
    ((5, 2), dict(block_scale=True, block_size=16, use_kahan=True))])
def test_verified_ring_clean_is_bitwise_transparent(fmt, kw):
    """verify=True observes the wire: the vectors equal the unverified
    ring's and the JAX verified ring's, the report is all green.  The
    per-tensor wires get magnitudes their format holds (a Kahan site fed
    Inf - Inf makes a NaN whose sign bit the two packages need not
    share)."""
    world = 4
    st = _spread(world, 193, seed=fmt[0] * 7 + fmt[1],
                 spread=30 if kw.get("block_scale") else 3)
    mesh = LocalMesh(world, "cpu")
    plain = tring.ring_quantized_sum(list(torch.from_numpy(st)), mesh, *fmt,
                                     **kw)
    vecs, rep = tring.ring_quantized_sum(list(torch.from_numpy(st)), mesh,
                                         *fmt, verify=True, **kw)
    assert _rep(rep) == CLEAN
    jvec, jrep = _jax_ring(world, st, *fmt, out_specs=(P(), P()),
                           verify=True, **kw)
    assert _rep(jrep) == CLEAN
    for v, p in zip(vecs, plain):
        _bitwise(p.numpy(), v)
        _bitwise(jvec, v)


@pytest.mark.parametrize("code", [1, 2, 3])
@pytest.mark.parametrize("blocked", [False, True])
def test_wire_faults_give_exact_counters_per_rank_as_jax(code, blocked):
    """Each fault on rank 2 (flip, stale, drop): exactly one hop mismatch
    and one gather-row mismatch, agreement broken — the JAX report — and
    each rank's vector equals the JAX ring's vector on that rank (read
    with out_specs P("dp"): the gather-site fault makes rank 2's copy
    differ)."""
    world = 4
    st = _spread(world, 257, seed=7, spread=30 if blocked else 3)
    kw = dict(block_scale=True, block_size=32) if blocked else {}
    jvec, jrep = _jax_faulted_ring(world, 5, 2, blocked)(st, code, 2)
    assert _rep(jrep) == FAULTED
    jvec = np.asarray(jvec).reshape(world, -1)
    vecs, rep = tring.ring_quantized_sum(
        list(torch.from_numpy(st)), LocalMesh(world, "cpu"), 5, 2,
        verify=True, fault=(code, 2), **kw)
    assert _rep(rep) == FAULTED
    for r in range(world):
        _bitwise(jvec[r], vecs[r], f"rank {r}")
    assert not torch.equal(vecs[2], vecs[0])


def test_fault_code_0_is_no_fault_and_unverified_faults_diverge():
    world = 4
    st = _spread(world, 101, seed=11)
    mesh = LocalMesh(world, "cpu")
    clean = tring.ring_quantized_sum(list(torch.from_numpy(st)), mesh, 5, 2,
                                     block_scale=True, block_size=8)
    vecs, rep = tring.ring_quantized_sum(
        list(torch.from_numpy(st)), mesh, 5, 2, verify=True, fault=(0, 2),
        block_scale=True, block_size=8)
    assert _rep(rep) == CLEAN
    for a, b in zip(clean, vecs):
        _bitwise(a.numpy(), b)
    for code in (1, 2, 3):
        bad = tring.ring_quantized_sum(list(torch.from_numpy(st)), mesh, 5,
                                       2, fault=(code, 1))
        # the gather-site fault diverges rank 1's copy, silently
        assert not torch.equal(bad[1], bad[0]), code
        assert torch.equal(bad[0], bad[2])


class _CountingMesh(LocalMesh):
    """A LocalMesh that counts the bytes each rank receives from another
    rank: payload (uint8 or fp32 wires) and tag/report words apart."""

    def __init__(self, world):
        super().__init__(world, "cpu")
        self.wire = self.tags = 0

    def _count(self, x, copies):
        nbytes = x.numel() * x.element_size() * copies
        if x.dtype == torch.int64:
            self.tags += nbytes
        else:
            self.wire += nbytes

    def ring_shift(self, xs):
        for x in xs:
            self._count(x, 1)
        return super().ring_shift(xs)

    def all_gather(self, xs):
        for x in xs:
            self._count(x, self.world - 1)
        return super().all_gather(xs)


@pytest.mark.parametrize("fmt,kw", [
    ((5, 2), {}), ((5, 2), dict(use_kahan=True)),
    ((4, 3), dict(block_scale=True, block_size=128)),
    ((4, 3), dict(block_scale=True, block_size=33, use_kahan=True))])
def test_ring_moves_the_analytic_transport_bytes(fmt, kw):
    """The bytes the ring passes through ring_shift and all_gather, per
    rank, equal `ring_transport_bytes`; verify adds only its tag vector
    ((W-1) int64 per rank) and its report rows (3 int64 per rank to each
    of W-1 ranks), counted apart."""
    world, n = 4, 1001
    st = _spread(world, n, seed=3)
    block = kw.get("block_size") if kw.get("block_scale") else None
    want = tring.ring_transport_bytes(n, world, *fmt,
                                      use_kahan=kw.get("use_kahan", False),
                                      block_size=block)
    assert want == jring.ring_transport_bytes(
        n, world, *fmt, use_kahan=kw.get("use_kahan", False),
        block_size=block)
    for verify in (False, True):
        mesh = _CountingMesh(world)
        tring.ring_quantized_sum(list(torch.from_numpy(st)), mesh, *fmt,
                                 verify=verify, **kw)
        assert mesh.wire == world * want
        assert mesh.tags == (world * 8 * ((world - 1) + 3 * (world - 1))
                             if verify else 0)


# -- sum_gradients and the train step ------------------------------------

def _leaves(world, seed):
    rng = np.random.RandomState(seed)
    out = []
    for i, shape in enumerate(LEAF_SHAPES):
        g = _spread(world, int(np.prod(shape)), seed=seed + i)
        out.append(g.reshape((world,) + shape)
                   * np.float32(10.0 ** (i % 5 - 4)))
    out[5][:] = 0.0
    return out


def _jax_sum_gradients(world, leaves, out_specs, **kw):
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    fn = jax.jit(shard_map(
        lambda st: jdist.sum_gradients([g[0] for g in st], "dp", **kw),
        mesh=mesh, in_specs=([P("dp")] * len(leaves),),
        out_specs=out_specs, check_vma=False))
    return fn([jax.device_put(jnp.asarray(g), NamedSharding(mesh, P("dp")))
               for g in leaves])


SG_BLOCKED = dict(use_aps=True, grad_exp=4, grad_man=3, mode="ring",
                  block_scale=True, block_size=16, verify=True,
                  bucket_elems=600)


@functools.lru_cache(maxsize=None)
def _jax_sum_gradients_faulted(world):
    """JAX `sum_gradients` with `SG_BLOCKED` and the wire fault an
    operand (one compile for every fault code); per-rank leaves."""
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    n = len(LEAF_SHAPES)
    fn = jax.jit(shard_map(
        lambda st, code, rank: jdist.sum_gradients(
            [g[0] for g in st], "dp", wire_fault=(code, rank), **SG_BLOCKED),
        mesh=mesh, in_specs=([P("dp")] * n, P(), P()),
        out_specs=([P("dp")] * n, P()), check_vma=False))
    return lambda leaves, code, rank: fn(
        [jax.device_put(jnp.asarray(g), NamedSharding(mesh, P("dp")))
         for g in leaves], jnp.int32(code), jnp.int32(rank))


@pytest.mark.parametrize("code", [0, 2])
def test_sum_gradients_block_scale_verify_matches_jax(code):
    """APS + (4, 3) ring sum_gradients with block 16 over several ragged
    buckets, verified, fault (code on rank 2) in bucket 0: the reduced
    leaves on every rank and the merged report equal JAX's."""
    world = 4
    leaves = _leaves(world, seed=5)
    want, jrep = _jax_sum_gradients_faulted(world)(leaves, code, 2)
    got, rep = tdist.sum_gradients(
        [[torch.from_numpy(g[r]) for g in leaves] for r in range(world)],
        LocalMesh(world, "cpu"), wire_fault=(code, 2), **SG_BLOCKED)
    assert _rep(rep) == _rep(jrep) == (FAULTED if code else CLEAN)
    for i, w in enumerate(want):
        w = np.asarray(w).reshape((world,) + LEAF_SHAPES[i])
        for r in range(world):
            _bitwise(w[r], got[r][i], f"leaf {i} rank {r}")


def test_sum_gradients_faithful_verify_is_the_agreement_digest():
    world = 4
    leaves = _leaves(world, seed=9)
    kw = dict(use_aps=True, grad_exp=5, grad_man=2, mode="faithful",
              verify=True)
    want, jrep = _jax_sum_gradients(world, leaves,
                                    ([P()] * len(leaves), P()), **kw)
    per_rank = [[torch.from_numpy(g[r]) for g in leaves]
                for r in range(world)]
    got, rep = tdist.sum_gradients(per_rank, LocalMesh(world, "cpu"), **kw)
    assert _rep(rep) == _rep(jrep) == CLEAN
    for w, g in zip(want, got[0]):
        _bitwise(w, g)
    fn = tdist.make_sum_gradients_fn(LocalMesh(world, "cpu"), **kw)
    out, rep2 = fn([torch.from_numpy(g) for g in leaves])
    assert _rep(rep2) == CLEAN and len(out) == len(leaves)


def test_sum_gradients_argument_errors_match_jax():
    mesh = LocalMesh(2, "cpu")
    grads = [[torch.ones(4)], [torch.ones(4)]]
    with pytest.raises(ValueError, match="mode='ring'"):
        tdist.sum_gradients(grads, mesh, mode="faithful", block_scale=True)
    with pytest.raises(ValueError, match="mode='ring'"):
        jdist.sum_gradients({"g": jnp.zeros(4)}, "dp", mode="faithful",
                            block_scale=True)
    for fmt, match in [((5, 1), "packable"), ((8, 23), "nothing to scale")]:
        with pytest.raises(ValueError, match=match):
            tdist.sum_gradients(grads, mesh, mode="ring", grad_exp=fmt[0],
                                grad_man=fmt[1], block_scale=True)
    with pytest.raises(ValueError, match="block_size must be >= 1"):
        tdist.sum_gradients(grads, mesh, mode="ring", block_scale=True,
                            block_size=0)


def test_two_steps_blocked_verified_match_jax():
    """Two APS (4, 3) blocked (block 32) verified ring steps over W=2
    ranks from carried-over weights, a stale fault on rank 1 at step 1:
    the losses to LOSS_RTOL of tests/test_torch_train.py (the fault
    changes the update after the second loss), the accuracies, and the
    four reduce_* metrics equal, float32, on both steps."""
    from cpd_tpu.train.state import TrainState
    from tests.test_torch_train import (LOSS_RTOL, _carried_model,
                                        j_make_step, joptim, jsched)
    from cpd_tpu_torch.train import (create_train_state, make_train_step,
                                     sgd, warmup_step_decay)

    world, per_rank = 2, 4
    jmodel, variables, tmodel = _carried_model(seed=3)
    tx = joptim.sgd(jsched.warmup_step_decay(0.4, 5, [100], warmup_from=0.1),
                    momentum=0.9, weight_decay=1e-4)
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    plan = ((0, 2), (1, 1))
    kw = dict(use_aps=True, grad_exp=4, grad_man=3, mode="ring",
              block_scale=True, block_size=32, verify_reduce=True,
              wire_fault_plan=plan)
    # create_train_state's state from the carried variables, replicated
    # as the step returns it, so that step 1 reuses step 0's compile
    params = variables["params"]
    jstate = jax.device_put(
        TrainState(step=jnp.zeros([], jnp.int32), params=params,
                   batch_stats=variables["batch_stats"],
                   opt_state=tx.init(params)),
        NamedSharding(mesh, P()))
    jstep = j_make_step(jmodel, tx, mesh, donate=False, **kw)
    opt = sgd(warmup_step_decay(0.4, 5, [100], warmup_from=0.1),
              momentum=0.9, weight_decay=1e-4)
    tstate = create_train_state(tmodel, opt)
    tstep = make_train_step(tmodel, opt, LocalMesh(world, "cpu"), **kw)
    x, y, _, _ = jcifar.synthetic_cifar10(2 * world * per_rank, 8, seed=2)
    pipe = jcifar.CIFAR10Pipeline(x, y, world * per_rank)
    sharding = NamedSharding(mesh, P("dp"))
    for it, want_rep in enumerate((CLEAN, FAULTED)):
        idx = np.arange(it * world * per_rank, (it + 1) * world * per_rank)
        bx, by = pipe.batch(idx)
        jstate, jm = jstep(jstate, jax.device_put(bx, sharding),
                           jax.device_put(by, sharding))
        tstate, tm = tstep(tstate, bx, by)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        assert float(tm["accuracy"]) == pytest.approx(float(jm["accuracy"]))
        for k in ("ok", "hop_bad", "gather_bad", "agree"):
            assert tm[f"reduce_{k}"].dtype == torch.float32
            assert float(tm[f"reduce_{k}"]) == float(jm[f"reduce_{k}"]) \
                == want_rep[k], (it, k)


def test_cli_block_scale_trains_on_cpu_and_refusals(tiny_cifar_factory,
                                                    tmp_path, capsys,
                                                    monkeypatch):
    """The JAX CLI's --block-scale/--block-size defaults and help, two
    blocked iterations on the CPU (tiny width), its two refusals (a mode
    other than ring, a format with man < 2), and --verify-reduce still
    refused with the reason."""
    import cpd_tpu_torch.models.resnet_cifar as tres
    from cpd_tpu_torch.models.resnet_cifar import ResNetCIFAR
    from tests.test_torch_train import TINY

    monkeypatch.setattr(tres, "resnet18_cifar",
                        lambda device: ResNetCIFAR(device=device, **TINY))
    args = tcli.parse_args(["--max-iter", "1"])
    assert (args.block_scale, args.block_size) == (False, 128)
    root = tiny_cifar_factory(tmp_path, n_train=40, n_test=8)
    argv = ["--mode", "ring", "--use_APS", "--grad_exp", "4", "--grad_man",
            "3", "--block-scale", "--block-size", "128", "--max-iter", "2",
            "--batch_size", "4", "--data-root", root, "--print_freq", "1",
            "--val_freq", "2"]
    assert tcli.main(argv, device="cpu") == 0
    assert "done: 2 iters" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="needs --mode ring"):
        tcli.main(argv + ["--mode", "faithful"], device="cpu")
    with pytest.raises(SystemExit, match="packable"):
        tcli.main(argv + ["--grad_man", "1"], device="cpu")
    with pytest.raises(SystemExit, match="TransportSupervisor"):
        tcli.main(argv + ["--verify-reduce"], device="cpu")


# -- the kernels, on the card --------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 1024, 65536])
@pytest.mark.parametrize("sr", [False, True])
def test_blocked_wire_kernels_match_plain_on_card(block, sr):
    """Bitwise on the card: the blocked arms of K6/K5 against their plain
    versions (partials, wire bytes with the sidecar, digests)."""
    _card()
    n = 100_003
    st = torch.from_numpy(_spread(2, n, seed=block)).cuda()
    rb = tq.sr_bits((3, 4), st[0]) if sr else None
    for fmt in ((4, 3), (5, 2), (5, 7)):
        first = tq.quantize_pack(st[0], *fmt, rbits=rb, block_size=block,
                                 want_digest=True)
        for a, b in zip(first, tq.quantize_pack_ref(
                st[0], *fmt, rbits=rb, block_size=block, want_digest=True)):
            _bitwise(b.cpu().numpy(), a.cpu())
        for a, b in zip(
                tq.hop_pack(first[1], st[1], *fmt, rbits=rb,
                            block_size=block, want_digest=True),
                tq.hop_pack_ref(first[1], st[1], *fmt, rbits=rb,
                                block_size=block, want_digest=True)):
            _bitwise(b.cpu().numpy(), a.cpu())


@pytest.mark.cuda
def test_digest_rows_kernel_and_fused_verified_ring_on_card():
    """K7 == its plain version; the fused blocked verified ring == the
    oracle with a clean report, with the launches the design predicts."""
    _card()
    rows = torch.randint(0, 256, (4, 996_671), dtype=torch.uint8,
                         device="cuda")
    _bitwise(tq.digest_rows_ref(rows).cpu().numpy(),
             tq.digest_rows(rows).cpu())
    world = 4
    st = torch.from_numpy(_spread(world, 100_003, seed=3)).cuda()
    before = (tq.quantize_pack_blocked.launches,
              tq.hop_pack_blocked.launches, tq.digest_rows.launches)
    vecs, rep = tring.ring_quantized_sum(list(st), LocalMesh(world, "cuda"),
                                         4, 3, block_scale=True, verify=True)
    after = (tq.quantize_pack_blocked.launches,
             tq.hop_pack_blocked.launches, tq.digest_rows.launches)
    assert [a - b for a, b in zip(after, before)] == [
        world, world * (world - 1), 1]
    assert _rep(rep) == CLEAN
    want = tring.ring_oracle_sum(st, 4, 3, block_scale=True)
    for v in vecs:
        _bitwise(want.cpu().numpy(), v.cpu())
