"""The port's training slice vs the JAX package: data, schedule, SGD,
model and the train step.

Each test says how it compares:

* BITWISE — `synthetic_cifar10`, the pickle-folder loader, the sampler's
  indices, the augmentation pipeline (numpy in both packages), the
  schedule's fp32 values, and given identical gradients the reduce +
  SGD update of the fp32 masters;
* to a TOLERANCE — the ResNet forward with the JAX weights carried over
  (XLA:CPU and ATen run the convolutions and BN reductions in other
  orders: logits within 1e-4 absolute/relative at these widths, measured
  4e-6), and two train steps at a tiny width: the losses (the same
  order differences, plus the eXmY casts of the reduce, which can round
  a gradient that sits near a tie the other way: 1e-4 relative,
  measured 2e-7), the rank-averaged BN running stats and, where the
  format's rounding step is below that tolerance, the weights and
  momentum buffers (``STATE_TOL``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cpd_tpu.data import cifar as jcifar
from cpd_tpu.data import samplers as jsamp
from cpd_tpu.models.resnet_cifar import ResNetCIFAR as JResNet
from cpd_tpu.parallel import dist as jdist
from cpd_tpu.parallel.mesh import make_mesh
from cpd_tpu.train import optim as joptim
from cpd_tpu.train import schedules as jsched
from cpd_tpu.train.state import TrainState as JTrainState
from cpd_tpu.train.step import make_train_step as j_make_step
import cpd_tpu_torch.data as tdata
from cpd_tpu_torch.data import cifar as tcifar
from cpd_tpu_torch.data import samplers as tsamp
from cpd_tpu_torch.examples.resnet18_cifar import train as tcli
from cpd_tpu_torch.interop import load_jax_resnet_cifar
from cpd_tpu_torch.models.resnet_cifar import ResNetCIFAR, resnet18_cifar
from cpd_tpu_torch.parallel import dist as tdist
from cpd_tpu_torch.parallel.mesh import LocalMesh
from cpd_tpu_torch.train import (create_train_state, make_eval_step,
                                 make_train_step, sgd, warmup_step_decay)
from cpd_tpu_torch.train import step as tstep_mod
from test_torch_threads import one_torch_thread  # noqa: F401

TINY = dict(stage_sizes=(1, 1, 1, 1), stage_channels=(8, 16, 32, 64))
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-4
# The state two train steps leave: fp32 order differences of the
# gradients carried through two updates (measured 3.6e-6 absolute on
# the BN running variance, 1.7e-6 on a weight).  A gradient that the two
# packages compute one fp32 ulp apart can round to either side of an
# eXmY midpoint: at (6, 17) that moves it by 2^-17 relative, inside
# this tolerance; at (5, 2) by 2^-2, so there the weights and momentum
# buffers (measured 1.3e-3 and 7.8e-3 apart) are not compared.
STATE_TOL = dict(rtol=1e-4, atol=1e-5)


def _bitwise(want, got):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert want.shape == got.shape and want.dtype == got.dtype
    np.testing.assert_array_equal(want.view(np.uint8), got.view(np.uint8))


def test_synthetic_and_pickle_data_match_jax(tiny_cifar_factory, tmp_path):
    """Bitwise: the synthetic stand-in and the pickle-folder loader."""
    for a, b in zip(jcifar.synthetic_cifar10(96, 32, seed=5),
                    tcifar.synthetic_cifar10(96, 32, seed=5)):
        _bitwise(a, b)
    root = tiny_cifar_factory(tmp_path, n_train=40, n_test=8)
    for a, b in zip(jcifar.load_cifar10(root), tcifar.load_cifar10(root)):
        _bitwise(a, b)
    with pytest.raises(FileNotFoundError):
        tcifar.load_cifar10(str(tmp_path / "nowhere"))


@pytest.mark.parametrize("dataset_len,total_iter,bs,world,rank,last",
                         [(50000, 7, 128, 4, 2, -1), (100, 30, 16, 1, 0, 4),
                          (1000, 9, 64, 8, 7, 2)])
def test_sampler_indices_match_jax(dataset_len, total_iter, bs, world, rank,
                                   last):
    """Bitwise: the reference's cap-tile-shuffle-slice recipe."""
    kw = dict(world_size=world, rank=rank, seed=0, last_iter=last)
    j = jsamp.DistributedGivenIterationSampler(dataset_len, total_iter, bs,
                                               **kw)
    t = tsamp.DistributedGivenIterationSampler(dataset_len, total_iter, bs,
                                               **kw)
    _bitwise(j.indices, t.indices)
    jb, tb = list(j.batches()), list(t.batches())
    assert len(jb) == len(tb) == total_iter - last - 1
    for a, b in zip(jb, tb):
        _bitwise(a, b)


@pytest.mark.parametrize("world", [1, 3, 4])
@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_sampler_indices_match_jax(world, shuffle):
    """Bitwise: the epoch-seeded permutation (or the identity), padded
    with its head to a multiple of the world, every rank's strided slice,
    over several epochs, at a length the world does not divide (1001)."""
    for rank in range(world):
        j = jsamp.DistributedEpochSampler(1001, world, rank, shuffle)
        t = tsamp.DistributedEpochSampler(1001, world, rank, shuffle)
        assert len(t) == len(j) == -(-1001 // world)
        for epoch in (0, 1, 7):
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            _bitwise(np.fromiter(j, np.int64), np.fromiter(t, np.int64))
    assert tdata.DistributedEpochSampler is tsamp.DistributedEpochSampler


@pytest.mark.parametrize("augment,cutout", [(True, 0), (True, 8),
                                            (False, 0)])
def test_augmentation_pipeline_matches_jax(augment, cutout):
    """Bitwise: normalise, reflect pad, crop, flip (and cutout), with the
    choices re-drawn per epoch seed."""
    x, y, _, _ = jcifar.synthetic_cifar10(64, 8, seed=1)
    j = jcifar.CIFAR10Pipeline(x, y, 16, augment=augment, cutout=cutout)
    t = tcifar.CIFAR10Pipeline(x, y, 16, augment=augment, cutout=cutout)
    idx = np.random.RandomState(0).permutation(64)[:16]
    for seed in (0, 3):
        for a, b in zip(j.batch(idx, seed=seed), t.batch(idx, seed=seed)):
            _bitwise(a, b)
    assert len(j) == len(t) == 4
    for (ja, jb), (ta, tb) in zip(j.epoch(idx[::-1], seed=1),
                                  t.epoch(idx[::-1], seed=1)):
        _bitwise(ja, ta)
        _bitwise(jb, tb)


def test_schedule_matches_jax():
    """Bitwise for warmup and the first decay (fp32 ops in the JAX order);
    after two decays within 1 ulp (fp32 pow vs XLA's)."""
    kw = dict(warmup_from=0.1, decay_factor=0.1)
    j = jsched.warmup_step_decay(1.6, 50, [100, 200], **kw)
    t = warmup_step_decay(1.6, 50, [100, 200], **kw)
    for s in list(range(0, 60, 7)) + [99, 100, 101, 150]:
        assert np.float32(j(s)) == np.float32(t(s)), s
    np.testing.assert_allclose(t(201), float(j(201)), rtol=1.2e-7)


def test_reduce_and_sgd_update_match_jax():
    """Bitwise: given identical per-rank gradients, the APS ring reduce
    and three SGD (momentum 0.9, wd 1e-4) updates of the fp32 masters."""
    world = 2
    rng = np.random.RandomState(0)
    shapes = [(16, 8, 3, 3), (16,), (10, 16)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    sched_j = jsched.warmup_step_decay(1.6, 5, [100], warmup_from=0.1)
    sched_t = warmup_step_decay(1.6, 5, [100], warmup_from=0.1)
    tx = joptim.sgd(sched_j, momentum=0.9, weight_decay=1e-4)
    opt = sgd(sched_t, momentum=0.9, weight_decay=1e-4)
    j_params = [jnp.asarray(p) for p in params]
    j_state = tx.init(j_params)
    t_params = [torch.from_numpy(p.copy()) for p in params]
    t_state = opt.init(t_params)
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    jfn = jdist.make_sum_gradients_fn(mesh, axis_name="dp", use_aps=True,
                                      grad_exp=5, grad_man=2, mode="ring")
    tfn = tdist.make_sum_gradients_fn(LocalMesh(world, "cpu"), use_aps=True,
                                      grad_exp=5, grad_man=2, mode="ring")
    for _ in range(3):
        grads = [(rng.randn(world, *s) * 1e-2).astype(np.float32)
                 for s in shapes]
        j_red = jfn([jax.device_put(jnp.asarray(g),
                                    NamedSharding(mesh, P("dp")))
                     for g in grads])
        t_red = tfn([torch.from_numpy(g) for g in grads])
        for a, b in zip(j_red, t_red):
            _bitwise(a, b)
        upd, j_state = tx.update(list(j_red), j_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        t_state = opt.apply(t_red, t_state, t_params)
    for a, b in zip(j_params, t_params):
        _bitwise(a, b)
    for a, b in zip(j_state.momentum_buf, t_state.momentum_buf):
        _bitwise(a, b)
    assert t_state.step == int(j_state.step) == 3


def _carried_model(seed=0):
    jmodel = JResNet(**TINY)
    # jitted: the same weights as eager init, a fraction of its dispatch
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((2, 32, 32, 3)), train=False))(jax.random.PRNGKey(seed))
    host = jax.device_get(variables)
    tmodel = load_jax_resnet_cifar(ResNetCIFAR(device="cpu", **TINY), host)
    return jmodel, variables, tmodel


def _as_port_state(params, batch_stats) -> dict:
    """A flax ResNetCIFAR's leaves as the port's ``state_dict()`` arrays."""
    model = load_jax_resnet_cifar(ResNetCIFAR(device="cpu", **TINY),
                                  {"params": params,
                                   "batch_stats": batch_stats})
    return {k: v.numpy() for k, v in model.state_dict().items()}


def test_resnet_forward_matches_jax_with_carried_weights():
    """To FWD_TOL: logits in eval and train mode, and the BN running
    stats one train-mode forward leaves (flax momentum 0.9, biased
    variance)."""
    jmodel, variables, tmodel = _carried_model()
    x = np.random.RandomState(1).randn(4, 32, 32, 3).astype(np.float32)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    tmodel.eval()
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        np.testing.assert_allclose(tmodel(tx).numpy(), np.asarray(want),
                                   **FWD_TOL)
    want, mut = jmodel.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    tmodel.train()
    with torch.no_grad():
        got = tmodel(tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    stats = jax.device_get(mut["batch_stats"])
    np.testing.assert_allclose(
        tmodel.layer4_block0.bn2.running_var.numpy(),
        stats["layer4_block0"]["bn2"]["var"], **FWD_TOL)
    np.testing.assert_allclose(tmodel.stem_bn.running_mean.numpy(),
                               stats["stem_bn"]["mean"], **FWD_TOL)


def test_full_width_model_matches_jax_parameter_count():
    shapes = jax.eval_shape(
        lambda: JResNet().init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)), train=False))
    n_jax = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(shapes["params"]))
    model = resnet18_cifar(device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == n_jax == 11_173_962
    assert [n for n, _ in model.named_children()][:3] == [
        "stem_conv", "stem_bn", "layer1_block0"]
    gen = torch.Generator().manual_seed(24)
    model.init_weights(gen)
    w = model.layer2_block0.conv1.weight
    assert abs(float(w.detach().std()) - math.sqrt(2 / w[0].numel())) < 0.01
    assert float(model.fc.bias.abs().max()) == 0.0


def _two_steps_match_jax(fmt, mode="ring", **reduce_kw):
    """Two APS train steps over W=2 ranks, batch 4 per rank, from
    carried-over weights, in both packages with the same reduce options;
    the losses, accuracies and the state the steps left, as stated in
    the callers."""
    world, per_rank = 2, 4
    jmodel, variables, tmodel = _carried_model(seed=3)
    sched_j = jsched.warmup_step_decay(0.4, 5, [100], warmup_from=0.1)
    sched_t = warmup_step_decay(0.4, 5, [100], warmup_from=0.1)
    tx = joptim.sgd(sched_j, momentum=0.9, weight_decay=1e-4)
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    # `create_train_state` of the carried variables (its init, jitted,
    # without its eager second init), placed as the step returns it: the
    # second step reuses the first step's compile
    jstate = jax.device_put(
        JTrainState(step=jnp.zeros([], jnp.int32),
                    params=variables["params"],
                    batch_stats=variables["batch_stats"],
                    opt_state=tx.init(variables["params"])),
        NamedSharding(mesh, P()))
    jstep = j_make_step(jmodel, tx, mesh, use_aps=True, grad_exp=fmt[0],
                        grad_man=fmt[1], mode=mode, donate=False,
                        **reduce_kw)
    opt = sgd(sched_t, momentum=0.9, weight_decay=1e-4)
    tstate = create_train_state(tmodel, opt)
    tmesh = LocalMesh(world, "cpu")
    tstep = make_train_step(tmodel, opt, tmesh, mode=mode, use_aps=True,
                            grad_exp=fmt[0], grad_man=fmt[1], **reduce_kw)
    x, y, _, _ = jcifar.synthetic_cifar10(2 * world * per_rank, 8, seed=2)
    pipe = jcifar.CIFAR10Pipeline(x, y, world * per_rank)
    sharding = NamedSharding(mesh, P("dp"))
    for it in range(2):
        idx = np.arange(it * world * per_rank, (it + 1) * world * per_rank)
        bx, by = pipe.batch(idx)
        jstate, jm = jstep(jstate, jax.device_put(bx, sharding),
                           jax.device_put(by, sharding))
        tstate, tm = tstep(tstate, bx, by)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        assert float(tm["accuracy"]) == pytest.approx(float(jm["accuracy"]))
    assert tstate.step == int(jstate.step) == 2
    # the weights, momentum buffers and rank-averaged BN stats the steps
    # left, mapped HWIO -> OIHW as the JAX weights were carried in
    want = _as_port_state(jax.device_get(jstate.params),
                          jax.device_get(jstate.batch_stats))
    got = dict(tmodel.named_buffers())
    if fmt == (6, 17):
        got.update(tmodel.named_parameters())
        want_buf = _as_port_state(
            jax.device_get(jstate.opt_state.momentum_buf),
            jax.device_get(jstate.batch_stats))
        for (name, _), buf in zip(tmodel.named_parameters(),
                                  tstate.opt_state.momentum_buf):
            np.testing.assert_allclose(buf.numpy(), want_buf[name],
                                       err_msg=f"momentum of {name}",
                                       **STATE_TOL)
    assert len(got) > 0
    for name, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), want[name],
                                   err_msg=name, **STATE_TOL)
    ev = make_eval_step(tmodel, tmesh)(tstate, bx, by)
    assert math.isfinite(float(ev["loss"])) and 0 <= float(ev["top1"]) <= 1


@pytest.mark.parametrize("fmt", [(5, 2), (6, 17)])
def test_two_step_losses_match_jax(fmt):
    """Two APS ring train steps over W=2 ranks, batch 4 per rank, from
    carried-over weights; the JAX step runs under shard_map on 2 CPU
    devices (its ring in the plain arm).  The losses to LOSS_RTOL; the
    BN running stats (the mean over ranks) to STATE_TOL; at (6, 17) the
    weights and momentum buffers to STATE_TOL too.  The faithful reduce
    is held bitwise in tests/test_torch_ring.py."""
    _two_steps_match_jax(fmt)


@pytest.mark.parametrize("mode,rounding", [("ring", "stochastic"),
                                           ("faithful", "nearest")])
def test_two_step_sr_and_kahan_losses_match_jax(mode, rounding,
                                                monkeypatch):
    """As `test_two_step_losses_match_jax` at (6, 17), with the reduce
    Kahan-compensated, and in the ring case stochastically rounded
    (seed 5), to the same tolerances: the SR bits are the same in both
    packages, so only the fp32 order differences of the gradients
    remain.  A wrong key would move a gradient by 2^-17 relative, inside
    that tolerance, so the key each step hands `sum_gradients` is held
    to the JAX step's ``grad_sr_key(5, step, 1)`` exactly.  (At (5, 2) a
    one-ulp gradient difference that flips a rounding moves the step-2
    BN statistics past the tolerance, with SR as with RTNE.)"""
    keys = []

    def spy(*args, **kw):
        keys.append(kw["key"])
        return tdist.sum_gradients(*args, **kw)

    monkeypatch.setattr(tstep_mod, "sum_gradients", spy)
    _two_steps_match_jax((6, 17), mode=mode, grad_rounding=rounding,
                         grad_seed=5, use_kahan=True)
    sr = rounding == "stochastic"
    assert keys == [tuple(int(v) for v in np.asarray(jax.random.key_data(
        jdist.grad_sr_key(5, s, 1)))) if sr else None for s in (0, 1)]


def test_cli_trains_on_cpu_and_rejects_unported_flags(tiny_cifar_factory,
                                                      tmp_path, capsys):
    root = tiny_cifar_factory(tmp_path, n_train=40, n_test=8)
    argv = ["--mode", "ring", "--use_APS", "--grad_exp", "5", "--grad_man",
            "2", "--max-iter", "2", "--batch_size", "4", "--data-root", root,
            "--print_freq", "1", "--val_freq", "2", "--save_path",
            str(tmp_path / "ckpt")]
    assert tcli.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert "Iter: [2/2]" in out and "Prec@1" in out and "done: 2 iters" in out
    cfg = tcli.read_config(tcli.build_parser().get_default("config"))
    assert cfg["weight_decay"] == 0.0001 and cfg["lr_steps"] == [3000, 6000,
                                                                  9000]
    for bad in (["--elastic"], ["--guard-grads"],
                ["--optimizer", "shampoo-lite"],
                ["--arch", "davidnet"]):
        with pytest.raises(SystemExit, match="not yet ported"):
            tcli.main(argv + bad, device="cpu")


def test_cli_trains_in_fast_mode_and_with_resnet50_on_cpu(
        tiny_cifar_factory, tmp_path, capsys, monkeypatch):
    """``--mode fast`` trains one iteration of the tiny CIFAR ResNet and,
    with ``--arch resnet50``, of the full-depth fp32 ResNet-50 (1000
    classes, as the JAX trainer builds it) at batch 2 on the CPU; every
    ported JAX registry name parses."""
    from cpd_tpu_torch import models

    root = tiny_cifar_factory(tmp_path, n_train=40, n_test=8)
    argv = ["--mode", "fast", "--use_APS", "--grad_exp", "5", "--grad_man",
            "2", "--max-iter", "1", "--batch_size", "2", "--data-root", root,
            "--print_freq", "1", "--val_freq", "1"]
    res = tcli.run(tcli.parse_args(argv + [
        "--arch", "resnet50", "--save_path", str(tmp_path / "r50")]),
        device="cpu")
    assert res["step"] == 1 and math.isfinite(res["loss"])
    assert "done: 1 iters" in capsys.readouterr().out
    monkeypatch.setitem(models._REGISTRY, "res_cifar",
                        lambda device: ResNetCIFAR(device=device, **TINY))
    res = tcli.run(tcli.parse_args(argv + [
        "--save_path", str(tmp_path / "tiny")]), device="cpu")
    assert res["step"] == 1 and math.isfinite(res["loss"])
    for arch in ("res_cifar", "resnet18_cifar", "resnet18", "resnet34",
                 "resnet50", "resnet101"):
        assert tcli.parse_args(["--arch", arch]).arch == arch
    assert tcli.parse_args([]).arch == "res_cifar"


def test_cli_trains_with_sr_and_kahan_on_cpu(tiny_cifar_factory, tmp_path,
                                             capsys, monkeypatch):
    """The ported reduce flags parse with the JAX trainer's choices and
    defaults, and one epoch (``--max_epoch 1``: 8 images at batch 4, two
    iterations) trains with them on the CPU (at the tiny width: the
    plain threefry over full-width leaves is slow on a CPU), its SGD
    behind ``--clip-grad``'s global-norm clip; ``--max_epoch`` overrides
    the config's and ``--clip-grad`` keeps the JAX trainer's refusal with
    shampoo-lite."""
    from cpd_tpu_torch import models, train

    monkeypatch.setitem(models._REGISTRY, "res_cifar",
                        lambda device: ResNetCIFAR(device=device, **TINY))
    args = tcli.parse_args(["--max-iter", "1"])
    assert (args.grad_rounding, args.grad_seed, args.use_kahan) == \
        ("nearest", 0, False)
    assert (args.clip_grad, args.max_epoch) == (None, int(tcli.read_config(
        args.config)["max_epoch"]))
    assert tcli.parse_args(["--max_epoch", "3"]).max_epoch == 3
    assert not {"--clip-grad", "--max_epoch"} & set(tcli._NOT_PORTED)
    with pytest.raises(SystemExit):
        tcli.parse_args(["--grad-rounding", "up"])
    with pytest.raises(SystemExit, match="ShampooLite updater bypasses"):
        tcli.parse_args(["--optimizer", "shampoo-lite", "--clip-grad", "1"])
    built = []
    real = train.make_optimizer
    monkeypatch.setattr(train, "make_optimizer", lambda *a, **kw: built.append(
        real(*a, **kw)) or built[-1])
    root = tiny_cifar_factory(tmp_path, n_train=8, n_test=8)
    argv = ["--mode", "faithful", "--use_APS", "--use_kahan",
            "--grad-rounding", "stochastic", "--grad-seed", "3",
            "--max_epoch", "1", "--clip-grad", "0.5", "--batch_size", "4",
            "--data-root", root, "--print_freq", "1", "--val_freq", "2",
            "--save_path", str(tmp_path / "ckpt")]
    assert tcli.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert "Iter: [2/2]" in out and "done: 2 iters" in out
    (opt,) = built
    assert isinstance(opt, train.ClipByGlobalNorm) and opt.max_norm == 0.5


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device here")
    with pytest.raises(RuntimeError, match="cuda"):
        resnet18_cifar()
    with pytest.raises(RuntimeError, match="cuda"):
        LocalMesh(4, "cuda")
