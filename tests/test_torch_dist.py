"""The port's process mesh (`parallel.mesh.ProcessMesh`, one rank per
process over `torch.distributed` gloo) vs the JAX package and the
`LocalMesh`, BITWISE.

W processes are spawned once per W in {2, 4} (`parallel.launch.spawn`,
torchrun's variables, a free localhost port); while they run, this
process compiles and runs every arm of the JAX reduce in one program.  Each rank draws the same
per-rank gradients from a seeded numpy generator, takes its own and runs
every arm of `sum_gradients` on its one rank: faithful, ring and fast
mode x RTNE, SR and Kahan, the blocked (4, 3) verified ring clean and
with a wire fault, and `tests/test_multiprocess.py`'s case (per-rank
grads from ``np.random.RandomState(7)``, APS e5m2 with Kahan).  Each
rank's result must be bitwise the JAX `sum_gradients` under `shard_map`
on W of the 8 virtual CPU devices (read per rank) and the port's
`LocalMesh` result, reports included.  The ranks also check the mesh's
collectives (a rank-order SUM, a NaN carried by MAX and MIN, the ring
shift's direction, the gather's order), the bytes each rank hands to
them against `ring_transport_bytes`/`gather_transport_bytes`, and
`replicate`/`broadcast_from` (rank 0's bytes on every rank).  The
workers import no JAX: this module imports it inside the parent's
functions only.  Inputs hold no fp32 subnormal and no element that is
-0.0 on every rank (ROADMAP Queue C: XLA:CPU flushes the one and folds
``0 + x`` for the other).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cpd_tpu_torch.parallel import dist as tdist
from cpd_tpu_torch.parallel.launch import spawn
from cpd_tpu_torch.parallel.mesh import LocalMesh, ProcessMesh

# a ResNet-shaped leaf list (tiny widths: conv kernels, BN vectors, the
# head), odd sizes so buckets and ring chunks have ragged ends; few
# leaves, as the JAX references compile per leaf
LEAF_SHAPES = [(8, 3, 3, 3), (8,), (16, 8, 3, 3), (16,), (16,), (10, 16),
               (10,)]
ZERO_LEAF = 4
SR_KEY = (3, 7, 1)          # grad_sr_key(seed, step, site)
BASE = dict(use_aps=True, grad_exp=5, grad_man=2)
BLOCKED = dict(use_aps=True, grad_exp=4, grad_man=3, mode="ring",
               block_scale=True, block_size=16, verify=True,
               bucket_elems=600)
# name -> (sum_gradients keywords, stochastic rounding, fault code)
ARMS = {f"{mode}-{arm}": (dict(BASE, mode=mode, use_kahan=arm == "kahan",
                               bucket_elems=None if mode == "fast"
                               else 600), arm == "sr", None)
        for mode in ("faithful", "ring", "fast")
        for arm in ("rtne", "sr", "kahan") if (mode, arm) != ("fast",
                                                              "kahan")}
ARMS.update({f"blocked-fault{c}": (BLOCKED, False, c) for c in (0, 2)})
CLEAN = {"hop_bad": 0, "gather_bad": 0, "agree": 1, "ok": 1}
FAULTED = {"hop_bad": 1, "gather_bad": 1, "agree": 0, "ok": 0}
WORLDS = (2, 4)


def _leaves(world: int, seed: int = 13) -> list:
    """(world, *shape) per leaf: scales 1e-4..1, one all-zero leaf (APS
    shift 0), rank 0's values below 1e-3 in magnitude made positive (no
    column -0.0 on every rank)."""
    rng = np.random.RandomState(seed)
    out = []
    for i, shape in enumerate(LEAF_SHAPES):
        g = rng.randn(world, *shape).astype(np.float32)
        g *= np.float32(10.0 ** (i % 5 - 4))
        g[0] = np.where(np.abs(g[0]) < 1e-3, np.abs(g[0]), g[0])
        out.append(g)
    out[ZERO_LEAF][:] = 0.0
    return out


def _mp_tree() -> list:
    """tests/test_multiprocess.py's per-rank gradients, in JAX's leaf
    order (sorted keys: ``b``, then ``w``)."""
    rng = np.random.RandomState(7)
    w = rng.randn(2, 9, 4).astype(np.float32)
    b = rng.randn(2, 7).astype(np.float32)
    return [b, w]


MP_KW = dict(use_aps=True, grad_exp=5, grad_man=2, use_kahan=True)


def _port_kw(kw: dict, sr: bool, fault, world: int) -> dict:
    kw = dict(kw)
    if sr:
        kw.update(rounding="stochastic", key=tdist.grad_sr_key(*SR_KEY))
    if fault is not None:
        kw["wire_fault"] = (fault, world - 1)
    return kw


def _as_numpy(res, verify: bool):
    leaves, report = res if verify else (res, None)
    return ([t.numpy().copy() for t in leaves],
            None if report is None else {k: int(v)
                                         for k, v in report.items()})


# -- the ranks (spawned; torch and numpy only) ---------------------------

def _rank_checks(world: int) -> dict:
    torch.set_num_threads(1)
    rank, w = tdist.dist_init("gloo")
    assert (rank, w) == (int(torch.distributed.get_rank()), world)
    mesh = ProcessMesh("cpu")
    assert mesh.ranks == (rank,) and mesh.world == world
    out = {"rank": rank, "arms": {}}
    leaves = _leaves(world)
    own = [torch.from_numpy(g[rank]) for g in leaves]
    for name, (kw, sr, fault) in ARMS.items():
        res = tdist.sum_gradients([own], mesh,
                                  **_port_kw(kw, sr, fault, world))
        out["arms"][name] = _as_numpy(
            (res[0][0], res[1]) if kw.get("verify") else res[0],
            kw.get("verify", False))
    if world == 2:
        tree = _mp_tree()
        out["mp"] = _as_numpy(tdist.sum_gradients(
            [[torch.from_numpy(g[rank]) for g in tree]], mesh, **MP_KW)[0],
            False)

    # the collectives' semantics
    v = torch.tensor([1e8, 1.0, -1e8, 0.0][rank % 4], dtype=torch.float32)
    out["sum"] = float(mesh.sum([v])[0])
    out["mean"] = float(tdist.all_reduce_mean([v], mesh)[0])
    nan = torch.tensor([float(rank), 1.0])
    if rank == 1:
        nan[0] = float("nan")
    out["max"] = mesh.max([nan])[0].tolist()
    out["min"] = mesh.min([nan])[0].tolist()
    r = torch.tensor([rank], dtype=torch.int64)
    out["shift"] = int(mesh.ring_shift([r])[0])
    out["gather"] = mesh.all_gather([r])[0].reshape(-1).tolist()
    out["gather0d"] = mesh.all_gather([r.reshape(())])[0].tolist()
    out["shift_u8"] = mesh.ring_shift(
        [torch.full((3,), rank, dtype=torch.uint8)])[0].tolist()

    # the bytes each rank hands to the collectives
    from cpd_tpu_torch.parallel.ring import (gather_transport_bytes,
                                             ring_quantized_sum,
                                             ring_transport_bytes)
    flat = torch.cat([g.reshape(-1) for g in own])
    n = flat.numel()

    def handed(fn):
        mesh.log = []
        fn()
        log, mesh.log = mesh.log, None
        shift = sum(b for op, _, b in log if op == "ring_shift")
        gather = sum(b for op, _, b in log if op == "all_gather")
        return shift + (world - 1) * gather

    out["bytes"] = {
        "ring": (handed(lambda: ring_quantized_sum([flat], mesh, 5, 2)),
                 ring_transport_bytes(n, world, 5, 2)),
        "ring_kahan": (handed(lambda: ring_quantized_sum(
            [flat], mesh, 5, 2, use_kahan=True)),
            ring_transport_bytes(n, world, 5, 2, use_kahan=True)),
        "ring_blocked": (handed(lambda: ring_quantized_sum(
            [flat], mesh, 4, 3, block_scale=True, block_size=16)),
            ring_transport_bytes(n, world, 4, 3, block_size=16)),
        "faithful": (handed(lambda: tdist.sum_gradients(
            [own], mesh, grad_exp=5, grad_man=2)),
            gather_transport_bytes(n, world, 5, 2))}

    # rank 0's bytes on every rank
    gen = torch.Generator().manual_seed(100 + rank)
    model = torch.nn.Sequential(torch.nn.Linear(5, 3),
                                torch.nn.BatchNorm1d(3))
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen))
    tdist.replicate(model, mesh)
    out["replicated"] = {k: t.numpy().copy()
                         for k, t in model.state_dict().items()}
    x = torch.randn(4, 2, generator=gen)
    out["broadcast"] = tdist.broadcast_from(x, mesh, src=world - 1).numpy()
    out["rank_input"] = x.numpy()
    return out


# -- the references (in this process) ------------------------------------

def _bitwise(want, got, msg=""):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (want.shape, got.shape, msg)
    assert want.dtype == got.dtype, (want.dtype, got.dtype, msg)
    np.testing.assert_array_equal(want.reshape(-1).view(np.uint8),
                                  got.reshape(-1).view(np.uint8),
                                  err_msg=msg)


def _jax_arms(world: int) -> dict:
    """Every arm of JAX `sum_gradients` under shard_map on W of the
    virtual CPU devices, in ONE jitted program (one compile a world): arm
    name -> per-rank leaves ``(world, *shape)`` and the report (or None).
    The wire fault's code and rank are operands, so the blocked arm runs
    once a fault code."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cpd_tpu.compat import shard_map
    from cpd_tpu.parallel import dist as jdist
    from cpd_tpu.parallel.mesh import make_mesh

    leaves = _leaves(world)
    codes = {n: f for n, (_, _, f) in ARMS.items() if f is not None}
    plain = [n for n in ARMS if n not in codes]
    specs = [P("dp")] * len(leaves)
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])

    def arm(st, name, fault):
        kw, sr, _ = ARMS[name]
        kw = dict(kw, **({"wire_fault": fault} if fault else {}))
        if sr:
            kw.update(rounding="stochastic", key=jdist.grad_sr_key(*SR_KEY))
        return jdist.sum_gradients([g[0] for g in st], "dp", **kw)

    def body(st, code, rank):
        return ([arm(st, n, None) for n in plain],
                arm(st, next(iter(codes)), (code, rank)))

    program = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(specs, P(), P()),
        out_specs=([specs] * len(plain), (specs, P())), check_vma=False))
    args = [jax.device_put(jnp.asarray(g), NamedSharding(mesh, P("dp")))
            for g in leaves]

    def per_rank(out, rep=None):
        return ([np.asarray(o).reshape(g.shape) for o, g in
                 zip(out, leaves)],
                None if rep is None else {k: int(v) for k, v in
                                          rep.items()})

    res = {}
    for name, code in codes.items():
        outs, blocked = program(args, jnp.int32(code), jnp.int32(world - 1))
        res[name] = per_rank(*blocked)
    res.update({n: per_rank(o) for n, o in zip(plain, outs)})
    return res


@functools.lru_cache(maxsize=None)
def _run(world: int) -> tuple:
    """The W rank processes' results, and `_jax_arms`, computed here
    while the ranks run."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, _rank_checks, world, args=(world,),
                            timeout=300)
        try:
            want = _jax_arms(world)
        finally:
            ranks = ranks.result()
    return ranks, want


def _ranks(world: int) -> list:
    return _run(world)[0]


def _local(world: int, leaves: list, kw: dict, sr: bool, fault) -> tuple:
    per = [[torch.from_numpy(g[r]) for g in leaves] for r in range(world)]
    res = tdist.sum_gradients(per, LocalMesh(world, "cpu"),
                              **_port_kw(kw, sr, fault, world))
    verify = kw.get("verify", False)
    out, rep = res if verify else (res, None)
    return ([[t.numpy() for t in rank] for rank in out],
            None if rep is None else {k: int(v) for k, v in rep.items()})


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arm", list(ARMS))
def test_process_mesh_reduce_matches_jax_and_local_mesh(world, arm):
    """Each rank's reduced leaves (and report) bitwise the JAX reduce
    under shard_map (read per rank) and the `LocalMesh` W reduce."""
    kw, sr, fault = ARMS[arm]
    ranks, jax_arms = _run(world)
    want, jrep = jax_arms[arm]
    local, lrep = _local(world, _leaves(world), kw, sr, fault)
    if kw.get("verify"):
        assert jrep == lrep == (FAULTED if fault else CLEAN)
    for r, res in enumerate(ranks):
        got, rep = res["arms"][arm]
        assert rep == lrep, f"rank {r}"
        for i, g in enumerate(got):
            _bitwise(want[i][r], g, f"{arm} rank {r} leaf {i} vs JAX")
            _bitwise(local[r][i], g, f"{arm} rank {r} leaf {i} vs local")


def test_two_process_case_of_test_multiprocess_matches_jax():
    """tests/test_multiprocess.py's tree and reduce (APS e5m2 Kahan,
    faithful) at W = 2: bitwise JAX's `make_sum_gradients_fn` and the
    `LocalMesh`."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cpd_tpu.parallel import make_mesh, make_sum_gradients_fn

    tree = _mp_tree()
    mesh = make_mesh(dp=2, devices=jax.devices()[:2])
    want = make_sum_gradients_fn(mesh, axis_name="dp", **MP_KW)(
        {"b": jax.device_put(jnp.asarray(tree[0]),
                             NamedSharding(mesh, P("dp"))),
         "w": jax.device_put(jnp.asarray(tree[1]),
                             NamedSharding(mesh, P("dp")))})
    local = tdist.make_sum_gradients_fn(LocalMesh(2, "cpu"), **MP_KW)(
        {"b": torch.from_numpy(tree[0]), "w": torch.from_numpy(tree[1])})
    for r, res in enumerate(_ranks(2)):
        got, _ = res["mp"]
        for i, k in enumerate(("b", "w")):
            _bitwise(want[k], got[i], f"rank {r} {k} vs JAX")
            _bitwise(local[k].numpy(), got[i], f"rank {r} {k} vs local")


@pytest.mark.parametrize("world", WORLDS)
def test_process_mesh_collectives(world):
    """SUM adds in rank order (at W = 4: (1e8 + 1) - 1e8 + 0 = 0 in
    fp32, where another order gives 1), MAX and MIN carry rank 1's NaN,
    the ring shift receives rank - 1's value (uint8 too), the gather
    stacks in rank order, 0-d values included."""
    vals = np.array([1e8, 1.0, -1e8, 0.0][:world], dtype=np.float32)
    s = vals[0]
    for v in vals[1:]:
        s = np.float32(s + v)
    for r, res in enumerate(_ranks(world)):
        assert res["sum"] == float(s)
        assert res["mean"] == float(np.float32(s) / np.float32(world))
        assert np.isnan(res["max"][0]) and np.isnan(res["min"][0])
        assert res["max"][1] == res["min"][1] == 1.0
        assert res["shift"] == (r - 1) % world
        assert res["shift_u8"] == [(r - 1) % world] * 3
        assert res["gather"] == res["gather0d"] == list(range(world))
    if world == 4:
        assert s == 0.0


@pytest.mark.parametrize("world", WORLDS)
def test_process_mesh_bytes_match_transport_tables(world):
    """The bytes each rank hands to the ring's shifts and gather, and to
    the faithful gather, are `ring_transport_bytes` and
    `gather_transport_bytes` (plain, Kahan, block-scaled)."""
    for res in _ranks(world):
        for name, (got, want) in res["bytes"].items():
            assert got == want > 0, name


@pytest.mark.parametrize("world", WORLDS)
def test_replicate_and_broadcast_give_one_ranks_bytes(world):
    ranks = _ranks(world)
    for r, res in enumerate(ranks):
        for k, v in ranks[0]["replicated"].items():
            _bitwise(v, res["replicated"][k], f"rank {r} {k}")
        _bitwise(ranks[-1]["rank_input"], res["broadcast"], f"rank {r}")
    assert not np.array_equal(ranks[0]["rank_input"],
                              ranks[-1]["rank_input"])


def test_dist_init_outside_a_cluster_is_a_no_op(monkeypatch):
    for group in tdist._LAUNCHERS:
        for var in group:
            monkeypatch.delenv(var, raising=False)
    assert tdist.dist_init() == (0, 1)
    assert tdist.dist_init("nccl") == (0, 1)
    assert not torch.distributed.is_initialized()
    mesh = LocalMesh(2, "cpu")
    x = torch.arange(3.0)
    assert tdist.broadcast_from(x, mesh) is not x
    assert torch.equal(tdist.broadcast_from(x, mesh), x)
    assert tdist.local_rows(np.arange(6), mesh).tolist() == list(range(6))
    with pytest.raises(RuntimeError, match="dist_init"):
        ProcessMesh("cpu")


def test_dist_init_refuses_a_guessed_backend_and_a_shared_card(monkeypatch):
    """The backend is never guessed; nccl without a card, or with two
    local ranks on one card, raises before any rendezvous."""
    with pytest.raises(ValueError, match="backend"):
        tdist.dist_init(rank=0, world_size=2)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(ValueError, match="backend"):
        tdist.dist_init()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NVIDIA card"):
            tdist.dist_init("nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="two ranks on one device"):
        tdist.dist_init("nccl")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="two ranks on one device"):
        tdist.dist_init("nccl")
    assert not torch.distributed.is_initialized()


def test_launcher_env_is_read_in_order(monkeypatch):
    for group in tdist._LAUNCHERS:
        for var in group:
            monkeypatch.delenv(var, raising=False)
    assert tdist._launcher_env() is None
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "3")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "8")
    assert tdist._launcher_env() == (3, 8, 3)
    monkeypatch.setenv("SLURM_PROCID", "5")
    monkeypatch.setenv("SLURM_NTASKS", "6")
    monkeypatch.setenv("SLURM_LOCALID", "1")
    assert tdist._launcher_env() == (5, 6, 1)
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert tdist._launcher_env() == (2, 4, 0)


def test_local_rows_is_the_process_slice():
    class _Rank:
        world, ranks = 4, (2,)

    x = np.arange(8)
    assert tdist.local_rows(x, _Rank()).tolist() == [4, 5]
    with pytest.raises(ValueError, match="multiple"):
        tdist.local_rows(np.arange(6), _Rank())


def _fails(rank_to_fail: int) -> int:
    import os

    if int(os.environ["RANK"]) == rank_to_fail:
        raise ValueError("deliberate")
    return int(os.environ["RANK"])


def test_spawn_returns_in_rank_order_and_raises_for_a_failed_rank():
    for world in WORLDS:
        assert [res["rank"] for res in _ranks(world)] == list(range(world))
    with pytest.raises(RuntimeError, match="(?s)rank 1: .*deliberate"):
        spawn(_fails, 2, args=(1,), timeout=120)
