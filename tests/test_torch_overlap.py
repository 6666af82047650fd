"""The port's overlapped backward-reduce and the ``offsets=`` vector vs
the JAX package and the port's own post-backward monolith, BITWISE.

* `BucketPlan` and `bucket_layout` give JAX's layout on the same sizes;
* the ``offsets=`` paths (`quantized_sum`, the ring on a `LocalMesh`
  against the JAX ring under `shard_map`, `ring_oracle_sum`) draw JAX's
  bits at an offset array of non-adjacent runs past 2^32 with pad
  elements at the sentinel, RTNE, SR and Kahan;
* `overlapped_grads` on a list of leaves whose gradients are known
  (the gradient of ``sum(p_i * c_i)`` is ``c_i`` exactly) is bitwise
  JAX's MONOLITHIC `sum_gradients` at the same bucket cap, one case per
  mode (the reference's own interleaved overlap test is red on this
  jax; ROADMAP Queue C);
* the overlapped train step is bitwise the port's monolithic step
  (weights, BN stats, momentum, metrics) on the tiny CNN at W = 2 for
  faithful, ring, the blocked verified ring, SR, Kahan and
  ``emulate_node`` 2 with the health counters, and the LM step's too;
* a bucket no gradient reaches reports as the monolith (agreement, its
  elements x W in ``wire_total``); a bucket-0 wire fault gives the
  monolith's exact counters; the log shows the last bucket's reduce
  fired before the first layer's gradient existed; the refusals.
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
from cpd_tpu_torch.models.tiny import TinyCNN
from cpd_tpu_torch.parallel import dist as tdist
from cpd_tpu_torch.parallel import overlap as tover
from cpd_tpu_torch.parallel import reduction as tred
from cpd_tpu_torch.parallel import ring as tring
from cpd_tpu_torch.parallel.mesh import LocalMesh
from cpd_tpu_torch.train import (create_train_state, make_optimizer,
                                 make_train_step, warmup_step_decay)

from test_torch_threads import one_torch_thread  # noqa: F401

# a ResNet-shaped leaf list (tiny widths), ragged against every cap
LEAF_SHAPES = [(8, 3, 3, 3), (8,), (16, 8, 3, 3), (16,), (16, 16, 3, 3),
               (10, 16), (10,)]


def _bitwise(want, got, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  got.view(np.uint32), err_msg=msg)


def _tkey(k) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def _leaves(world, seed):
    rng = np.random.RandomState(seed)
    out = []
    for i, shape in enumerate(LEAF_SHAPES):
        g = rng.randn(world, *shape).astype(np.float32)
        out.append(g * np.float32(10.0 ** (i % 4 - 3)))
    return out


def test_bucket_plan_matches_jax():
    rng = np.random.default_rng(1)
    sizes = [int(s) for s in rng.integers(1, 3000, 30)]
    leaves = [np.zeros(n, np.float32) for n in sizes]
    for cap in (1, 700, 4000, None):
        want = jover.BucketPlan.for_tree(leaves, cap)
        got = tover.BucketPlan.for_tree([torch.zeros(n) for n in sizes], cap)
        assert (got.sizes, got.starts, got.buckets, got.bucket_elems) == (
            want.sizes, want.starts, want.buckets, want.bucket_elems)
        assert got.key() == want.key() and got.n_buckets == want.n_buckets
        assert tover.bucket_layout(sizes, got.bucket_elems) == \
            jover.bucket_layout(sizes, want.bucket_elems)
    assert tover.REPORT_FIELDS == jover.REPORT_FIELDS
    for bad in (0, -3):
        with pytest.raises(ValueError, match="bucket_elems must be >= 1"):
            tover.BucketPlan.for_tree(leaves, bad)


def _offsets(n: int, pad: int) -> np.ndarray:
    """Two non-adjacent runs of global offsets, the second wrapping past
    2^32, and ``pad`` trailing elements at the sentinel (one past the
    last real offset)."""
    real = n - pad
    a = np.arange(real // 2, dtype=np.uint64) + 1000
    b = np.arange(real - real // 2, dtype=np.uint64) + 2 ** 32 - 40
    total = np.uint64(2 ** 32 + 7000)
    offs = np.concatenate([a, b, np.full(pad, total, np.uint64)])
    return (offs % 2 ** 32).astype(np.uint32)


def _jax_ring(world, stacked, exp, man, **kw):
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    fn = jax.jit(shard_map(
        lambda st: jring.ring_quantized_sum(st[0], "dp", exp, man, **kw),
        mesh=mesh, in_specs=(P("dp"),), out_specs=P(), check_vma=False))
    return np.asarray(fn(jax.device_put(jnp.asarray(stacked),
                                        NamedSharding(mesh, P("dp")))))


@pytest.mark.parametrize("variant", ["nearest", "sr", "kahan-sr"])
def test_offsets_paths_match_jax(variant):
    """Bitwise: the ordered (or Kahan) sum, the ring at W = 4 and the ring
    oracle with an explicit offset array (non-adjacent runs, a wrap past
    2^32, pad elements at the sentinel holding zeros)."""
    world, n, pad, fmt = 4, 1001, 3, (5, 2)
    rng = np.random.RandomState(5)
    stacked = (rng.randn(world, n) * 0.3).astype(np.float32)
    stacked[:, -pad:] = 0.0
    offs = _offsets(n, pad)
    sr, kahan = variant != "nearest", variant.startswith("kahan")
    key = jax.random.PRNGKey(11) if sr else None
    tkey = _tkey(key) if sr else None
    toffs = torch.from_numpy(offs.astype(np.int64))
    tst = torch.from_numpy(stacked)
    want = jred.quantized_sum(jnp.asarray(stacked), *fmt, kahan, key=key,
                              offsets=jnp.asarray(offs))
    _bitwise(want, tred.quantized_sum(tst, *fmt, kahan, key=tkey,
                                      offsets=toffs), "quantized_sum")
    want = _jax_ring(world, stacked, *fmt, use_kahan=kahan, key=key,
                     offsets=jnp.asarray(offs))
    got = tring.ring_quantized_sum(list(tst), LocalMesh(world, "cpu"), *fmt,
                                   use_kahan=kahan, key=tkey, offsets=toffs)
    for r in range(world):
        _bitwise(want, got[r], f"ring rank {r}")
    want = jring.ring_oracle_sum(jnp.asarray(stacked), *fmt,
                                 use_kahan=kahan, key=key,
                                 offsets=jnp.asarray(offs))
    _bitwise(want, tring.ring_oracle_sum(tst, *fmt, use_kahan=kahan,
                                         key=tkey, offsets=toffs), "oracle")


def test_sum_gradients_offset_starts_off_a_run_draws_the_array():
    """``offset_starts`` whose leaves do not run on draw each element's
    bits at its own offset (`dist._leaf_offsets`): bitwise the leaves
    reduced one by one at their starts."""
    world = 2
    mesh = LocalMesh(world, "cpu")
    leaves = [torch.from_numpy(g) for g in _leaves(world, 9)[:4]]
    per_rank = [[g[r] for g in leaves] for r in range(world)]
    starts = [5000, 17, 900000, 2 ** 32 - 3]
    kw = dict(use_aps=True, grad_exp=5, grad_man=2, mode="faithful",
              rounding="stochastic", key=(4, 9))
    got = tdist.sum_gradients(per_rank, mesh, offset_starts=starts, **kw)
    for i, st in enumerate(starts):
        one = tdist.sum_gradients([[p[i]] for p in per_rank], mesh,
                                  offset_starts=[st], **kw)
        _bitwise(one[0][0].numpy(), got[0][i], f"leaf {i}")
    with pytest.raises(ValueError, match="offset_starts"):
        tdist.sum_gradients(per_rank, mesh, offset_starts=[0], **kw)


def _known_grads(mesh, leaves, plan, **kw):
    """`overlapped_grads` on parameters whose gradients are the last
    rank's ``leaves`` exactly (the objective ``sum(p_i * c_i)``), the
    earlier ranks' given as ``prior``."""
    world = len(mesh.ranks)
    params = [torch.zeros(g.shape[1:], requires_grad=True) for g in leaves]
    c = [torch.from_numpy(g[world - 1]) for g in leaves]
    objective = sum((p * ci).sum() for p, ci in zip(params, c))
    prior = [[torch.from_numpy(g[r]) for g in leaves]
             for r in range(world - 1)]
    return tover.overlapped_grads(objective, params, mesh, plan=plan,
                                  prior=prior, **kw)


MONOLITH_ARMS = {
    "faithful": dict(mode="faithful"),
    "ring": dict(mode="ring"),
    "ring-blocked": dict(mode="ring", block_scale=True, block_size=128),
    "ring-sr": dict(mode="ring", rounding="stochastic"),
    "faithful-kahan-sr": dict(mode="faithful", use_kahan=True,
                              rounding="stochastic"),
}


@pytest.mark.parametrize("arm", list(MONOLITH_ARMS))
def test_overlapped_grads_match_jax_monolith(arm):
    """Bitwise: the port's per-bucket reduces fired from the backward at
    a 600-element cap == the JAX MONOLITHIC APS (5, 2) `sum_gradients`
    at the same cap over W = 4 ranks."""
    world, cap = 4, 600
    kw = dict(use_aps=True, grad_exp=5, grad_man=2, **MONOLITH_ARMS[arm])
    sr = kw.get("rounding") == "stochastic"
    key = jdist.grad_sr_key(3, 7, 1) if sr else None
    leaves = _leaves(world, seed=21)
    jmesh = make_mesh(dp=world, devices=jax.devices()[:world])
    jfn = jdist.make_sum_gradients_fn(jmesh, axis_name="dp", key=key,
                                      bucket_elems=cap, **kw)
    want = jfn([jax.device_put(jnp.asarray(g), NamedSharding(jmesh,
                                                             P("dp")))
                for g in leaves])
    plan = tover.BucketPlan.for_tree(
        [torch.zeros(g.shape[1:]) for g in leaves], cap)
    assert plan.n_buckets > 2
    _, reduced, _ = _known_grads(
        LocalMesh(world, "cpu"), leaves, plan,
        reduce_kw=dict(kw, bucket_elems=cap),
        key=_tkey(key) if sr else None)
    for r in range(world):
        for i, (w, g) in enumerate(zip(want, reduced[r])):
            _bitwise(w, g, f"rank {r} leaf {i}")


def test_late_bucket_fires_before_the_first_gradient_exists(monkeypatch):
    """The log of an overlapped backward (a hook on every parameter logs
    its gradient's arrival, a wrapper of `sum_gradients` each bucket's
    reduce, known by its first global offset): the last bucket (the late
    layers, whose gradients come first) starts its reduce before leaf
    0's gradient exists, and every bucket fires once, when its own last
    gradient is in."""
    world = 2
    model = TinyCNN(device="cpu").init_weights(
        torch.Generator().manual_seed(1))
    params = list(model.parameters())
    plan = tover.BucketPlan.for_tree(params, 300)
    assert plan.n_buckets >= 3
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    y = torch.arange(4) % 10
    log = []
    first = {plan.starts[idxs[0]]: b for b, idxs in enumerate(plan.buckets)}
    reduce = tdist.sum_gradients

    def logged(*a, offset_starts, **kw):
        log.append(("reduce", first[offset_starts[0]]))
        return reduce(*a, offset_starts=offset_starts, **kw)

    monkeypatch.setattr(tdist, "sum_gradients", logged)
    for i, p in enumerate(params):
        p.register_hook(lambda g, i=i: log.append(("grad", i)))
    mesh = LocalMesh(world, "cpu")
    prior = [[torch.randn(p.shape) * 1e-3 for p in params]]
    objective = torch.nn.functional.cross_entropy(model(x), y)
    tover.overlapped_grads(objective, params, mesh, plan=plan, prior=prior,
                           reduce_kw=dict(mode="ring", use_aps=True,
                                          grad_exp=5, grad_man=2,
                                          bucket_elems=300))
    fired = [b for kind, b in log if kind == "reduce"]
    assert sorted(fired) == list(range(plan.n_buckets))
    last = plan.n_buckets - 1
    assert log.index(("reduce", last)) < log.index(("grad", 0))
    for b, idxs in enumerate(plan.buckets):
        closing = max(log.index(("grad", i)) for i in idxs)
        assert log.index(("reduce", b)) == closing + 1


def test_unused_bucket_reports_as_the_monolith():
    """A bucket no gradient reaches never fires: its reduced gradients
    are zeros, its verdict agrees, and ``wire_total`` counts its
    elements x W as the monolith's probe does; every other field equals
    the monolith's report bitwise."""
    world, cap = 2, 600
    leaves = _leaves(world, seed=3)
    leaves[4][:] = 0.0             # (16, 16, 3, 3): a bucket of its own
    plan = tover.BucketPlan.for_tree(
        [torch.zeros(g.shape[1:]) for g in leaves], cap)
    assert (4,) in plan.buckets
    mesh = LocalMesh(world, "cpu")
    kw = dict(use_aps=True, grad_exp=5, grad_man=2, mode="ring")
    params = [torch.zeros(g.shape[1:], requires_grad=True) for g in leaves]
    c = [torch.from_numpy(g[world - 1]) for g in leaves]
    objective = sum((p * ci).sum() for i, (p, ci) in
                    enumerate(zip(params, c)) if i != 4)
    prior = [[torch.from_numpy(g[0]) for g in leaves]]
    grads, reduced, report = tover.overlapped_grads(
        objective, params, mesh, plan=plan, prior=prior,
        reduce_kw=dict(kw, bucket_elems=cap), verify=True, stats=True)
    assert float(grads[4].abs().sum()) == 0.0
    per_rank = [[torch.from_numpy(g[r]) for g in leaves]
                for r in range(world)]
    want, wrep = tdist.sum_gradients(per_rank, mesh, bucket_elems=cap,
                                     verify=True, stats=True, **kw)
    for i in range(len(leaves)):
        _bitwise(want[0][i].numpy(), reduced[1][i], f"leaf {i}")
    assert set(report) == set(wrep)
    for k in wrep:
        assert float(report[k]) == float(wrep[k]), k
    assert int(report["agree"]) == 1 and int(report["ok"]) == 1
    assert float(report["wire_total"]) == world * sum(
        int(np.prod(s)) for s in LEAF_SHAPES)


def test_overlapped_grads_refusals():
    mesh = LocalMesh(2, "cpu")
    p = [torch.zeros(3, requires_grad=True)]
    plan = tover.BucketPlan.for_tree(p * 2, 10)
    obj = (p[0] * 2).sum()
    with pytest.raises(ValueError, match="BucketPlan built for 2 leaves"):
        tover.overlapped_grads(obj, p, mesh, plan=plan, reduce_kw={},
                               prior=[[torch.zeros(3)]])
    plan = tover.BucketPlan.for_tree(p, 10)
    with pytest.raises(ValueError, match="threads no verify/stats"):
        tover.overlapped_grads(obj, p, mesh, plan=plan, reduce_kw={},
                               prior=[[torch.zeros(3)]], verify=True,
                               collective=lambda *a: None)
    with pytest.raises(ValueError, match="via extras="):
        tover.overlapped_grads(obj, p, mesh, plan=plan, reduce_kw={},
                               prior=[[torch.zeros(3)]],
                               emulate_reduce=lambda *a: None)


# -- the train steps -------------------------------------------------------

WORLD, PER_RANK = 2, 4
STEP_ARMS = {
    "faithful": dict(mode="faithful"),
    "ring": dict(mode="ring"),
    "ring-blocked-verify": dict(mode="ring", block_scale=True,
                                verify_reduce=True),
    "ring-sr": dict(mode="ring", grad_rounding="stochastic", grad_seed=3),
    "faithful-kahan": dict(mode="faithful", use_kahan=True),
    "emulate-2-sr-stats": dict(mode="faithful", emulate_node=2,
                               grad_rounding="stochastic", grad_seed=1,
                               quant_stats=True),
}


def _steps(arm: dict, overlap: bool, steps: int = 2, fault=None) -> dict:
    """Two steps of the tiny CNN at W = 2 from seeded weights: metrics,
    the state dict and the momentum after."""
    arm = dict(arm)
    model = TinyCNN(device="cpu").init_weights(
        torch.Generator().manual_seed(3))
    opt = make_optimizer("sgd", warmup_step_decay(0.4, 5, [100],
                                                  warmup_from=0.1),
                         momentum=0.9, weight_decay=1e-4)
    step = make_train_step(model, opt, LocalMesh(WORLD, "cpu"), use_aps=True,
                           grad_exp=5, grad_man=2, bucket_elems=700,
                           overlap_reduce=overlap, wire_fault_plan=fault,
                           **arm)
    state = create_train_state(model, opt)
    rng = np.random.RandomState(0)
    rows = WORLD * PER_RANK * arm.get("emulate_node", 1)
    metrics = []
    for _ in range(steps):
        x = rng.randn(rows, 32, 32, 3).astype(np.float32)
        y = rng.randint(0, 10, rows)
        state, m = step(state, x, y)
        metrics.append({k: v.numpy().copy() for k, v in m.items()})
    return dict(metrics=metrics,
                state={k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()},
                momentum=[b.numpy().copy()
                          for b in state.opt_state.momentum_buf])


def _same_run(want: dict, got: dict) -> None:
    for s, (wm, gm) in enumerate(zip(want["metrics"], got["metrics"])):
        assert set(wm) == set(gm)
        for k in wm:
            _bitwise(wm[k], gm[k], f"step {s} {k}")
    for k, v in want["state"].items():
        np.testing.assert_array_equal(v.view(np.uint8).reshape(-1),
                                      got["state"][k].view(np.uint8)
                                      .reshape(-1), err_msg=k)
    for i, (a, b) in enumerate(zip(want["momentum"], got["momentum"])):
        _bitwise(a, b, f"momentum {i}")


@pytest.mark.parametrize("arm", list(STEP_ARMS))
def test_overlapped_step_is_bitwise_the_monolith(arm):
    """Bitwise, two steps: overlap on == overlap off at the same bucket
    cap (weights, BN stats, momentum, every metric)."""
    _same_run(_steps(STEP_ARMS[arm], False), _steps(STEP_ARMS[arm], True))


def test_bucket0_wire_fault_keeps_exact_counters():
    """A flip on rank 1's wire at update 0: the overlapped verified ring
    reports the monolith's exact counters (hop_bad 1, gather_bad 1,
    agree 0, ok 0) over several buckets, and discards the step as it
    does (the weights, BN stats and momentum stay bitwise the
    monolith's)."""
    arm = dict(mode="ring", verify_reduce=True)
    fault = (np.array([1, 0]), np.array([1, 0]))
    want, got = _steps(arm, False, fault=fault), _steps(arm, True,
                                                        fault=fault)
    _same_run(want, got)
    for m in got["metrics"]:     # the retry runs update 0 again
        assert {k: float(m[f"reduce_{k}"]) for k in
                ("hop_bad", "gather_bad", "agree", "ok")} == {
            "hop_bad": 1.0, "gather_bad": 1.0, "agree": 0.0, "ok": 0.0}


def test_lm_overlapped_step_is_bitwise_the_monolith():
    """The tiny LM at W = 2 x ``emulate_node`` 2, SR ring, the health
    counters: two steps with overlap == without, bitwise."""
    from cpd_tpu_torch.models import transformer_lm
    from cpd_tpu_torch.train.lm import make_lm_train_step

    def run(overlap):
        model = transformer_lm(
            vocab_size=64, d_model=32, n_layers=1, n_heads=4, n_kv_heads=2,
            d_ff=64, attn_impl="flash", flash_bwd="pallas",
            device="cpu").init_weights(torch.Generator().manual_seed(7))
        opt = make_optimizer("sgd", warmup_step_decay(0.05, 2, [8],
                                                      warmup_from=0.02),
                             momentum=0.9)
        step = make_lm_train_step(
            model, opt, LocalMesh(WORLD, "cpu"), use_aps=True, grad_exp=5,
            grad_man=2, emulate_node=2, mode="ring",
            grad_rounding="stochastic", grad_seed=5, quant_stats=True,
            bucket_elems=2000, overlap_reduce=overlap)
        state = create_train_state(model, opt)
        rng = np.random.RandomState(5)
        metrics = []
        for _ in range(2):
            x = rng.randint(0, 64, (WORLD * 2 * 2, 17))
            state, m = step(state, x[:, :-1], x[:, 1:])
            metrics.append({k: v.numpy().copy() for k, v in m.items()})
        return dict(metrics=metrics,
                    state={k: v.detach().numpy().copy()
                           for k, v in model.state_dict().items()},
                    momentum=[b.numpy().copy()
                              for b in state.opt_state.momentum_buf])

    _same_run(run(False), run(True))


def test_a_parameter_the_loss_does_not_reach():
    """A parameter the loss never reaches gets a zero gradient, as JAX's
    does (it raised in `local_gradients` before): the monolithic and the
    overlapped step run, its bucket never fires, and the two steps are
    bitwise the same; SGD leaves the parameter at zero."""
    def run(overlap):
        model = TinyCNN(device="cpu").init_weights(
            torch.Generator().manual_seed(3))
        model.register_parameter("unused",
                                 torch.nn.Parameter(torch.zeros(300)))
        opt = make_optimizer("sgd", warmup_step_decay(0.4, 5, [100]),
                             momentum=0.9, weight_decay=1e-4)
        step = make_train_step(model, opt, LocalMesh(WORLD, "cpu"),
                               use_aps=True, grad_exp=5, grad_man=2,
                               mode="ring", verify_reduce=True,
                               quant_stats=True, bucket_elems=300,
                               overlap_reduce=overlap)
        state = create_train_state(model, opt)
        rng = np.random.RandomState(1)
        rows = WORLD * PER_RANK
        state, m = step(state, rng.randn(rows, 32, 32, 3).astype(
            np.float32), rng.randint(0, 10, rows))
        return model, {k: v.numpy().copy() for k, v in m.items()}

    (a, ma), (b, mb) = run(False), run(True)
    assert float(b.unused.detach().abs().sum()) == 0.0
    for k in ma:
        _bitwise(ma[k], mb[k], k)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        np.testing.assert_array_equal(x.numpy().view(np.uint8),
                                      y.numpy().view(np.uint8), err_msg=k)
