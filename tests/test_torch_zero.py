"""The port's ZeRO-1/2 (`cpd_tpu_torch/parallel/zero.py`) vs the JAX
package and the port's replicated step.

* the layout (`shard_offsets`, the per-bucket chunks) and
  `zero2_transport_bytes` are JAX's;
* the ZeRO-2 reduce-scatter on a `LocalMesh` (and the port's own
  `zero2_oracle_flat`) is BITWISE `cpd_tpu.parallel.zero.zero2_oracle_flat`
  across e5m2 / e4m3 / (8, 23) x Kahan x SR x the blocked wire x
  ``bucket_elems`` (one parametrised test);
* two ZeRO-1/2 SGD steps of the tiny CNN at W = 2 are BITWISE the
  replicated step (weights, BN stats, momentum), ZeRO-2 with and
  without overlap; ZeRO x LARS within the reference's 1e-6 / 1e-7;
* two ZeRO-2 steps of the tiny CNN match JAX's `zero2_sgd` step on the
  virtual mesh to the tolerance of `tests/test_torch_emulate_step.py`;
* `export_state` / `import_state` round-trip, and `restore(world=2)` of
  a W = 4 padded ZeRO-2 save is bitwise an `import_state` at W = 2 of
  the portable save of the same state;
* every ported refusal (the step's, the updaters', the CLI's) gives the
  JAX message; `LocalMesh.all_to_all` is the transposition;
* the ResNet CLI's ``--zero2 --overlap-reduce --bucket-elems`` run
  gives the JAX CLI's updates and loss on one argv from the same
  weights (8 ranks, tiny CNN), and bitwise the port CLI's replicated
  run.
"""

import contextlib
import io
import re
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cpd_tpu.data import cifar as jcifar
from cpd_tpu.parallel import zero as jzero
from cpd_tpu.parallel.mesh import make_mesh
from cpd_tpu.train import schedules as jsched
from cpd_tpu.train.state import TrainState as JState
from cpd_tpu.train.step import make_train_step as j_make_step
from cpd_tpu_torch.examples.resnet18_cifar import train as tcli
from cpd_tpu_torch.models.tiny import TinyCNN
from cpd_tpu_torch.parallel import zero as tzero
from cpd_tpu_torch.parallel.mesh import LocalMesh
from cpd_tpu_torch.train import (TrainState, create_train_state, lars, sgd,
                                 make_train_step, warmup_step_decay)
from cpd_tpu_torch.train.checkpoint import CheckpointManager
from test_torch_emulate_step import _carried, _port_state
from test_torch_threads import one_torch_thread  # noqa: F401

LEAF_SHAPES = [(8, 3, 3, 3), (8,), (16, 8, 3, 3), (16,), (10, 16), (10,)]
# the oracle's leaves: every bucket at a 430 cap holds 430 elements, 2
# past a multiple of W = 4, so the eager JAX oracle compiles one shape
ORACLE_SHAPES = [(5, 43), (43, 5), (5, 43), (43, 5), (215,), (5, 43)]
WORLD, PER_RANK = 2, 4
# the reference's ZeRO x LARS tolerance (tests/test_zero.py)
LARS_TOL = dict(rtol=1e-6, atol=1e-7)


def _bitwise(want, got, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  got.view(np.uint32), err_msg=msg)


def _tkey(k) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def _stacked(world, seed, shapes=LEAF_SHAPES):
    rng = np.random.RandomState(seed)
    out = []
    for i, shape in enumerate(shapes):
        g = rng.randn(world, *shape).astype(np.float32)
        out.append(g * np.float32(10.0 ** (i % 4 - 3)))
    return out


def test_layout_and_transport_bytes_match_jax():
    template = [np.zeros(s, np.float32) for s in LEAF_SHAPES]
    for world, cap in ((4, None), (4, 300), (3, 1)):
        jl = jzero._Zero2(lambda s: 0.0, world, 0.9, 0.0, False, None, "dp",
                          cap)._layout(template)
        tl = tzero._Zero2(lambda s: 0.0, world, 0.9, 0.0, False, None,
                          cap)._layout([torch.zeros(s) for s in LEAF_SHAPES])
        assert (tl.total, tl.sizes, tl.starts, tl.buckets, tl.meta) == (
            jl.total, jl.sizes, jl.starts, jl.buckets, jl.meta)
        assert tl.shard_size == jl.shard_size
        for r in range(world):
            np.testing.assert_array_equal(
                np.asarray(jl.shard_offsets(r)),
                tl.shard_offsets(r).numpy().astype(np.uint32))
    for args, kw in (((1001, 4, 5, 2), {}), ((1001, 4, 4, 3),
                                              dict(block_size=32)),
                     ((7, 3, 5, 2), dict(use_aps=False)),
                     ((0, 4, 5, 2), {})):
        assert tzero.zero2_transport_bytes(*args, **kw) == \
            jzero.zero2_transport_bytes(*args, **kw)


# (format, Kahan, SR, block size or None, bucket_elems, W): SR at W = 2,
# where the eager JAX oracle dispatches a quarter of W = 4's ops
ORACLE_CASES = [((5, 2), False, False, None, None, 4),
                ((5, 2), True, True, None, 430, 2),
                ((4, 3), False, True, 32, 430, 2),
                ((4, 3), True, False, 32, None, 4),
                ((4, 3), False, True, None, None, 2),
                ((8, 23), True, True, None, 430, 2)]


@pytest.mark.parametrize("fmt,kahan,sr,block,cap,world", ORACLE_CASES)
def test_zero2_reduce_scatter_matches_jax_oracle(fmt, kahan, sr, block, cap,
                                                 world):
    """Bitwise: every rank's reduce-scattered shard on a
    `LocalMesh` (the all-to-all a reindexing) and the port's oracle ==
    the JAX `zero2_oracle_flat`; APS on below fp32 (at (8, 23) APS
    lifts the leaves to 2^127, where the Kahan sites make NaNs whose
    sign the packages need not share: ROADMAP Queue C)."""
    stacked = _stacked(world, fmt[0] + 10 * kahan + 3 * sr, ORACLE_SHAPES)
    key = jax.random.PRNGKey(5) if sr else None
    kw = dict(use_aps=fmt != (8, 23), grad_exp=fmt[0], grad_man=fmt[1],
              use_kahan=kahan, block_scale=block is not None,
              block_size=block or 128)
    want = np.asarray(jzero.zero2_oracle_flat(
        [jnp.asarray(g) for g in stacked], world, key=key,
        bucket_elems=cap, **kw))
    tk = _tkey(key) if sr else None
    _bitwise(want, tzero.zero2_oracle_flat(
        [torch.from_numpy(g) for g in stacked], world, key=tk,
        bucket_elems=cap, **kw), "port oracle")
    z = tzero.zero2_sgd(lambda s: 0.0, world, bucket_elems=cap)
    mesh = LocalMesh(world, "cpu")
    per_rank = [[torch.from_numpy(g[r]) for g in stacked]
                for r in range(world)]
    lay = z._layout(per_rank[0])
    shards = z._grad_shard(per_rank, per_rank[0], mesh, lay, mode="faithful",
                           rounding="stochastic" if sr else "nearest",
                           key=tk, **kw)
    _bitwise(want, torch.cat(shards), "LocalMesh reduce-scatter")


def test_local_mesh_all_to_all_is_the_transposition():
    mesh = LocalMesh(3, "cpu")
    xs = [torch.arange(12, dtype=torch.float32).reshape(3, 4) + 100 * r
          for r in range(3)]
    out = mesh.all_to_all(xs)
    for r in range(3):
        for j in range(3):
            assert torch.equal(out[r][j], xs[j][r])


def _schedule():
    return warmup_step_decay(0.4, 5, [100], warmup_from=0.1)


def _run(make, overlap=False, steps=2, world=WORLD, bucket_elems=None,
         **step_kw):
    """``steps`` steps of the tiny CNN from seeded weights with the
    updater ``make(schedule, world)`` (a ZeRO factory) or, given the
    replicated optimizer, its plain step: the model, the state, the
    metrics."""
    model = TinyCNN(device="cpu").init_weights(
        torch.Generator().manual_seed(3))
    mesh = LocalMesh(world, "cpu")
    opt = make(_schedule(), world)
    if isinstance(opt, tzero._Zero1):
        state = TrainState(0, model, opt.init(list(model.parameters()),
                                              mesh))
        kw = opt.step_kwargs()
        opt_arg = None
    else:
        state, kw, opt_arg = create_train_state(model, opt), {}, opt
    step = make_train_step(model, opt_arg, mesh, use_aps=True, grad_exp=5,
                           grad_man=2, overlap_reduce=overlap,
                           bucket_elems=bucket_elems, **kw, **step_kw)
    rng = np.random.RandomState(0)
    metrics = []
    rows = world * PER_RANK * step_kw.get("emulate_node", 1)
    for _ in range(steps):
        x = rng.randn(rows, 32, 32, 3).astype(np.float32)
        state, m = step(state, x, rng.randint(0, 10, rows))
        metrics.append({k: v.numpy().copy() for k, v in m.items()})
    return model, state, metrics


def _flat_momentum(state, world):
    """The replicated momentum flat, or a ZeRO state's made portable."""
    opt = state.opt_state
    if isinstance(opt, tzero.Zero1State):
        return tzero.portable_momentum(opt).numpy()
    return torch.cat([b.reshape(-1) for b in opt.momentum_buf]).numpy()


def _wd_mask(params):
    return [p.dim() > 1 for p in params]


# name -> (ZeRO factory, replicated factory, step keywords)
SGD_ARMS = {
    "zero1": (lambda s, w: tzero.zero1_sgd(s, w, weight_decay=1e-4),
              lambda s, w: sgd(s, weight_decay=1e-4), {}),
    "zero1-nesterov-mask": (
        lambda s, w: tzero.zero1_sgd(s, w, weight_decay=1e-4, nesterov=True,
                                     wd_mask=_wd_mask),
        lambda s, w: sgd(s, weight_decay=1e-4, nesterov=True,
                         wd_mask=_wd_mask), {}),
    "zero1-overlap-ring": (
        lambda s, w: tzero.zero1_sgd(s, w, weight_decay=1e-4),
        lambda s, w: sgd(s, weight_decay=1e-4),
        dict(overlap=True, mode="ring", bucket_elems=700)),
    "zero2": (lambda s, w: tzero.zero2_sgd(s, w, weight_decay=1e-4),
              lambda s, w: sgd(s, weight_decay=1e-4), {}),
    "zero2-buckets-sr": (
        lambda s, w: tzero.zero2_sgd(s, w, weight_decay=1e-4,
                                     bucket_elems=700),
        lambda s, w: sgd(s, weight_decay=1e-4),
        dict(bucket_elems=700, grad_rounding="stochastic", grad_seed=2)),
    "zero2-overlap-kahan-emulate": (
        lambda s, w: tzero.zero2_sgd(s, w, weight_decay=1e-4,
                                     bucket_elems=700),
        lambda s, w: sgd(s, weight_decay=1e-4),
        dict(overlap=True, bucket_elems=700, use_kahan=True,
             emulate_node=2)),
}


@pytest.mark.parametrize("arm", list(SGD_ARMS))
def test_zero_sgd_steps_are_bitwise_the_replicated_step(arm):
    """Bitwise, two steps at W = 2: weights, BN stats, metrics and the
    momentum (the ZeRO shards made portable) == the replicated SGD step
    at the faithful reduce (ring where named)."""
    zmake, rmake, kw = SGD_ARMS[arm]
    kw = dict(kw)
    overlap = kw.pop("overlap", False)
    rep_model, rep_state, rep_m = _run(rmake, **kw)
    z_model, z_state, z_m = _run(zmake, overlap=overlap, **kw)
    for k, v in rep_model.state_dict().items():
        np.testing.assert_array_equal(
            v.numpy().view(np.uint8), z_model.state_dict()[k].numpy()
            .view(np.uint8), err_msg=k)
    _bitwise(_flat_momentum(rep_state, WORLD),
             _flat_momentum(z_state, WORLD), "momentum")
    for a, b in zip(rep_m, z_m):
        assert set(a) == set(b)
        for k in a:
            _bitwise(a[k], b[k], k)
    assert z_state.opt_state.step == 2 and z_state.step == 2
    s = z_state.opt_state.momentum[0].numel()
    assert all(m.numel() == s for m in z_state.opt_state.momentum)


@pytest.mark.parametrize("stage", ["zero1", "zero2-overlap"])
def test_zero_lars_within_the_reference_tolerance(stage):
    """ZeRO x LARS (the trust ratios from the shards' partial norms) ==
    the replicated LARS to 1e-6 / 1e-7 over two steps."""
    if stage == "zero1":
        zmake, kw = (lambda s, w: tzero.zero1_lars(s, w, weight_decay=1e-4),
                     {})
    else:
        zmake, kw = (lambda s, w: tzero.zero2_lars(s, w, weight_decay=1e-4,
                                                   bucket_elems=700),
                     dict(overlap=True, bucket_elems=700))
    overlap = kw.pop("overlap", False)
    rep_model, rep_state, _ = _run(
        lambda s, w: lars(s, weight_decay=1e-4), **kw)
    z_model, z_state, _ = _run(zmake, overlap=overlap, **kw)
    for k, v in rep_model.state_dict().items():
        np.testing.assert_allclose(z_model.state_dict()[k].numpy(),
                                   v.numpy(), err_msg=k, **LARS_TOL)
    np.testing.assert_allclose(_flat_momentum(z_state, WORLD),
                               _flat_momentum(rep_state, WORLD), **LARS_TOL)


def test_two_zero2_steps_match_jax_zero2_sgd():
    """Two ZeRO-2 steps (APS e5m2) of the tiny CNN at W = 2 x 4 from
    carried weights, the port with overlap and 2000-element buckets,
    JAX's `zero2_sgd` monolith on the virtual mesh: losses within 1e-5
    relative and every leaf within 1e-4 of its update (the packages'
    fp32 convolutions differ in round-off, as in
    `tests/test_torch_emulate_step.py`)."""
    jmodel, variables, tmodel = _carried(seed=3)
    start = {k: v.numpy().copy() for k, v in tmodel.state_dict().items()}
    mesh = make_mesh(dp=WORLD, devices=jax.devices()[:WORLD])
    jz = jzero.zero2_sgd(jsched.warmup_step_decay(0.4, 5, [100],
                                                  warmup_from=0.1),
                         WORLD, weight_decay=1e-4, bucket_elems=2000)
    jstate = JState(step=jnp.zeros([], jnp.int32),
                    params=variables["params"],
                    batch_stats=variables["batch_stats"],
                    opt_state=jz.init(variables["params"]))
    jstate, extra = jz.mesh_layout(jstate, mesh)
    kw = dict(use_aps=True, grad_exp=5, grad_man=2, mode="faithful")
    jstep = j_make_step(jmodel, None, mesh, donate=False, **kw, **extra)
    tz = tzero.zero2_sgd(_schedule(), WORLD, weight_decay=1e-4,
                         bucket_elems=2000)
    tmesh = LocalMesh(WORLD, "cpu")
    tstate = TrainState(0, tmodel, tz.init(list(tmodel.parameters()),
                                           tmesh))
    tstep = make_train_step(tmodel, None, tmesh, overlap_reduce=True,
                            bucket_elems=2000, **kw, **tz.step_kwargs())
    rows = WORLD * PER_RANK
    x, y, _, _ = jcifar.synthetic_cifar10(2 * rows, 8, seed=4)
    pipe = jcifar.CIFAR10Pipeline(x, y, rows)
    sharding = NamedSharding(mesh, P("dp"))
    for it in range(2):
        bx, by = pipe.batch(np.arange(it * rows, (it + 1) * rows))
        jstate, jm = jstep(jstate, jax.device_put(bx, sharding),
                           jax.device_put(by, sharding))
        tstate, tm = tstep(tstate, bx, by)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert tstate.step == int(jstate.step) == 2
    want = _port_state(jax.device_get(jstate.params),
                       jax.device_get(jstate.batch_stats))
    for name, g in tmodel.state_dict().items():
        g = g.numpy()
        if "running" in name:
            np.testing.assert_allclose(g, want[name], rtol=1e-5, atol=1e-6,
                                       err_msg=name)
            continue
        moved = np.linalg.norm(want[name] - start[name])
        assert np.linalg.norm(g - want[name]) <= 1e-4 * moved, name


def test_export_import_and_restore_at_another_world(tmp_path):
    """`export_state` -> `import_state` gives every shard back bitwise;
    a W = 4 ZeRO-2 (bucketed) state saved padded restores with
    ``restore(world=2)`` bitwise as an `import_state` at W = 2 of its
    portable save, and a portable save restores with ``world=`` the
    same; a template for another world than ``world=`` is refused, and
    so is a save of one process's shard alone."""
    make = (lambda s, w: tzero.zero2_sgd(s, w, weight_decay=1e-4,
                                         bucket_elems=700))
    model, state, _ = _run(make, world=4, bucket_elems=700)
    z4 = make(_schedule(), 4)
    mesh4 = LocalMesh(4, "cpu")
    portable = z4.export_state(state)
    back = z4.import_state(portable, mesh4)
    for a, b in zip(state.opt_state.momentum, back.opt_state.momentum):
        _bitwise(a.numpy(), b)
    assert float(state.opt_state.momentum[0].abs().sum()) > 0
    CheckpointManager(str(tmp_path / "padded")).save(1, state)
    CheckpointManager(str(tmp_path / "portable")).save(1, portable)

    z2, mesh2 = make(_schedule(), 2), LocalMesh(2, "cpu")
    tmpl = TrainState(0, model, z2.init(list(model.parameters()), mesh2))
    want = z2.import_state(CheckpointManager(str(tmp_path / "portable"))
                           .restore(z2.portable_template(tmpl)), mesh2)
    for src in ("padded", "portable"):
        got = CheckpointManager(str(tmp_path / src)).restore(tmpl, world=2)
        assert got.opt_state.world == 2 and got.step == 2
        assert got.opt_state.step == want.opt_state.step == 2
        assert len(got.opt_state.momentum) == 2
        for a, b in zip(want.opt_state.momentum, got.opt_state.momentum):
            _bitwise(a.numpy(), b, src)
    res = CheckpointManager(str(tmp_path / "padded")).restore_latest_valid(
        tmpl, world=2)
    _bitwise(want.opt_state.momentum[1].numpy(),
             res.state.opt_state.momentum[1])
    with pytest.raises(ValueError, match="template world and `world=` "
                                         "disagree"):
        CheckpointManager(str(tmp_path / "padded")).restore(tmpl, world=4)
    with pytest.raises(ValueError, match="shape|saved"):
        CheckpointManager(str(tmp_path / "padded")).restore(tmpl)
    one = TrainState(0, model, tzero.Zero1State(
        0, state.opt_state.momentum[:1], 4, state.opt_state.spans))
    with pytest.raises(ValueError, match="export_state"):
        CheckpointManager(str(tmp_path / "shard")).save(1, one)


def _message(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no refusal")


STEP_REFUSALS = [
    dict(loss_scale="dynamic", update_fn=lambda *a, **k: None),
    dict(reduce_in_update=True),
    dict(update_fn=lambda *a, **k: None, reduce_in_update=True,
         verify_reduce=True),
    dict(update_fn=lambda *a, **k: None, reduce_in_update=True,
         quant_stats=True),
    dict(tap_reduce=lambda *a: None),
    dict(update_fn=lambda *a, **k: None, reduce_in_update=True,
         overlap_reduce=True),
    dict(block_scale=True, mode="faithful"),
]


def test_refusals_give_the_jax_messages():
    """The step's, the updaters' and the precision check's refusals
    word for word as the JAX package's."""
    for kw in STEP_REFUSALS:
        want = _message(lambda: j_make_step(None, None, None, **kw))
        assert _message(lambda: make_train_step(None, None, None, **kw)) \
            == want, kw
    for args in (("ring", "nearest", None, False, 128, 5, 2),
                 ("faithful", "stochastic", None, False, 128, 5, 2),
                 ("faithful", "nearest", (0, 1), False, 128, 5, 2),
                 ("faithful", "nearest", None, True, 128, 8, 23),
                 ("faithful", "nearest", None, True, 128, 5, 1),
                 ("faithful", "nearest", None, True, 0, 5, 2)):
        want = _message(lambda: jzero._Zero2._validate_precision(*args))
        assert _message(lambda: tzero._Zero2._validate_precision(*args)) \
            == want, args
    mesh = LocalMesh(2, "cpu")
    want = _message(lambda: jzero.zero1_sgd(lambda s: 0.1, 2)._grad_shard(
        None, None, "dp", use_aps=True))
    assert _message(lambda: tzero.zero1_sgd(lambda s: 0.1, 2)._grad_shard(
        [], [], mesh, None, use_aps=True)) == want
    want = _message(lambda: jzero.zero2_sgd(lambda s: 0.1, 2).update_fn(
        None, None, "dp"))
    assert _message(lambda: tzero.zero2_sgd(lambda s: 0.1, 2).update_fn(
        [], None, mesh)) == want
    # the step's bucket cap must be the updater's
    z = tzero.zero2_sgd(lambda s: 0.1, 2, bucket_elems=500)
    model = TinyCNN(device="cpu")
    with pytest.raises(ValueError, match="does not match the ZeRO "
                                         "updater's bucket layout"):
        make_train_step(model, None, mesh, mode="faithful",
                        overlap_reduce=True, bucket_elems=600,
                        **z.step_kwargs())


CLI_REFUSALS = [["--zero1", "--zero2"], ["--zero2", "--mode", "ring"],
                ["--zero1", "--clip-grad", "1"],
                ["--zero2", "--opt_exp", "4", "--opt_man", "3"],
                ["--zero1", "--verify-reduce"], ["--block-scale"]]


def test_cli_refusals_give_the_jax_cli_messages():
    """Each refused ZeRO combination exits with a message the JAX CLI
    raises word for word (its source's string literals joined)."""
    src = open(os.path.join(os.path.dirname(__file__), "..", "examples",
                            "resnet18_cifar", "train.py")).read()
    joined = re.sub(r'"\s*\n\s*f?"', "", src)
    for argv in CLI_REFUSALS:
        with pytest.raises(SystemExit) as e:
            tcli.parse_args(["--arch", "tiny"] + argv)
        assert str(e.value) in joined, argv
    for flag in ("--zero1", "--zero2", "--overlap-reduce", "--bucket-elems"):
        assert flag not in tcli._NOT_PORTED
    args = tcli.parse_args(["--zero2", "--use_lars", "--overlap-reduce",
                            "--bucket-elems", "4096", "--block-scale"])
    assert (args.zero2, args.opt_name, args.overlap_reduce,
            args.bucket_elems) == (True, "lars", True, 4096)


def test_cli_zero2_overlap_gives_the_jax_cli_updates(tiny_cifar_factory,
                                                     tmp_path, monkeypatch):
    """One argv, 8 ranks, the tiny CNN, both CLIs from JAX's seeded
    weights (the port's `TinyCNN.init_weights` loads the ones the JAX
    CLI's `create_train_state` drew): the port CLI with ``--zero2
    --overlap-reduce --bucket-elems 2000`` makes the JAX CLI's updates,
    each leaf's final weights within 1e-5 of its move over the three
    steps and the BN stats within `test_torch_emulate_step`'s
    tolerance, and its last loss within 1e-5 relative of JAX's.  Its
    final weights, loss and accuracy are bitwise the port CLI's without
    the three flags; its checkpoint is the portable layout."""
    import cpd_tpu.train as jtrain
    from resnet18_cifar.train import main as jmain

    seen = {}
    make_state = jtrain.create_train_state

    def jax_start(*a, **kw):
        st = make_state(*a, **kw)
        seen["start"] = _port_state(jax.device_get(st.params),
                                    jax.device_get(st.batch_stats))
        return st

    jsave = jtrain.CheckpointManager.save

    def jax_saved(self, step, state, *a, **kw):
        seen["jax"] = _port_state(jax.device_get(state.params),
                                  jax.device_get(state.batch_stats))
        return jsave(self, step, state, *a, **kw)

    tsave = CheckpointManager.save

    def port_saved(self, step, state, *a, **kw):
        seen[self.directory] = {k: v.detach().numpy().copy() for k, v in
                                state.model.state_dict().items()}
        return tsave(self, step, state, *a, **kw)

    init = TinyCNN.init_weights

    def jax_weights(self, gen):
        init(self, gen)
        self.load_state_dict({k: torch.from_numpy(v)
                              for k, v in seen["start"].items()})
        return self

    monkeypatch.setattr(jtrain, "create_train_state", jax_start)
    monkeypatch.setattr(jtrain.CheckpointManager, "save", jax_saved)
    monkeypatch.setattr(CheckpointManager, "save", port_saved)
    monkeypatch.setattr(TinyCNN, "init_weights", jax_weights)
    root = tiny_cifar_factory(tmp_path / "data", n_train=64, n_test=16)
    argv = ["--arch", "tiny", "--mode", "faithful", "--use_APS",
            "--grad_exp", "5", "--grad_man", "2", "--batch_size", "2",
            "--max-iter", "3", "--val_freq", "3", "--print_freq", "1",
            "--data-root", root]
    zero = ["--zero2", "--overlap-reduce", "--bucket-elems", "2000"]
    paths = {k: str(tmp_path / k) for k in ("jax", "torch", "plain")}
    with contextlib.redirect_stdout(io.StringIO()):
        want = jmain(argv + zero + ["--save_path", paths["jax"]])
        got = tcli.run(tcli.parse_args(argv + zero + [
            "--save_path", paths["torch"]]), device="cpu", world=8)
        plain = tcli.run(tcli.parse_args(argv + [
            "--save_path", paths["plain"]]), device="cpu", world=8)
    assert got["step"] == want["step"] == plain["step"] == 3
    assert not got["diverged"] and not want["diverged"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    start, jend = seen["start"], seen["jax"]
    tend, pend = (seen[os.path.abspath(paths[k])] for k in ("torch",
                                                            "plain"))
    assert tend.keys() == jend.keys() == start.keys()
    for name, g in tend.items():
        _bitwise(pend[name], g, name)
        if "running" in name:
            np.testing.assert_allclose(g, jend[name], rtol=1e-5, atol=1e-6,
                                       err_msg=name)
            continue
        moved = np.linalg.norm(jend[name] - start[name])
        assert moved > 0, name
        assert np.linalg.norm(g - jend[name]) <= 1e-5 * moved, name
    for k in ("loss", "accuracy"):
        assert got[k] == plain[k], k
    with open(tmp_path / "torch" / "3" / "layout.json") as f:
        assert '"opt": {"fields": [3, [{"t"' in f.read()
