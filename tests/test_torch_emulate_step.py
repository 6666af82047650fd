"""The flagship step's other arms on the port vs the JAX package: the
tiny CNN, `make_train_step(emulate_node=, loss_scale=, quant_stats=)`
with SGD, LARS and `quant_sgd`, and the ResNet CLI's new flags.

Each test says how it compares:

* to a TOLERANCE — the tiny CNN's forward with flax's weights carried
  over (SAME padding at stride 2 pads (0, 1) on an even size, (1, 1) on
  an odd one): logits within FWD_TOL (XLA:CPU and ATen sum the
  convolutions and the BN statistics in other orders); two train steps
  at W = 2 x ``emulate_node`` 2 against the JAX ``make_train_step``
  under shard_map: losses within LOSS_RTOL, every leaf's change over
  the two steps within a share of JAX's change (L2) and the BN stats
  within STATS_TOL, the shares stated beside each case;
* EXACT — the ``quant_stats`` metrics' ``wire_total``, ``wire_nan`` and
  ``aps_bad``, a power-of-two ``loss_scale``'s gradients (2x the
  unscaled ones, bitwise) and a ``"dynamic"`` step's scale, besides the
  two steps with a static ``loss_scale`` (1024 with APS, 3 without)
  held to JAX's as above (the dynamic steps against JAX's:
  tests/test_torch_scaling.py);
* the CLI: 2 iterations with ``--emulate_node 2 --use_lars`` and with
  ``--opt_exp 4 --opt_man 3 --opt_kahan`` at ``--arch tiny``; the JAX
  CLI's contradiction errors; the flags gone from ``_NOT_PORTED``.

The step's leaves are the port's ``parameters()`` (OIHW); the JAX step's
are flax's sorted tree.  RTNE reduces elementwise and updates per leaf,
so the two orders give the same arithmetic; SR steps are held on the
card (kernels vs plain), not against JAX (ROADMAP Queue C).
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cpd_tpu.data import cifar as jcifar
from cpd_tpu.models import tiny as jtiny
from cpd_tpu.parallel.mesh import make_mesh
from cpd_tpu.train import optim as joptim
from cpd_tpu.train import schedules as jsched
from cpd_tpu.train.state import TrainState as JState
from cpd_tpu.train.step import make_train_step as j_make_step
from cpd_tpu_torch.examples.resnet18_cifar import train as tcli
from cpd_tpu_torch.interop import load_jax_tiny
from cpd_tpu_torch.models import get_model
from cpd_tpu_torch.models import tiny as ttiny
from cpd_tpu_torch.parallel.mesh import LocalMesh
from cpd_tpu_torch.train import (as_batch, create_train_state,
                                 local_gradients, make_optimizer,
                                 make_train_step, warmup_step_decay,
                                 with_dynamic_loss_scale)
from test_torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
WORLD, PER_RANK, N = 2, 4, 2


def _carried(seed=0):
    jmodel = jtiny.TinyCNN()
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((2, 32, 32, 3)), train=False))(jax.random.PRNGKey(seed))
    host = jax.device_get(variables)
    return jmodel, variables, load_jax_tiny(ttiny.TinyCNN(device="cpu"),
                                            host)


def _port_state(params, batch_stats) -> dict:
    model = load_jax_tiny(ttiny.TinyCNN(device="cpu"),
                          {"params": params, "batch_stats": batch_stats})
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("size", [32, 15])
def test_tiny_cnn_forward_matches_flax(size):
    """Logits in eval and train mode, and the BN running stats a train
    forward leaves, within FWD_TOL of flax's from carried weights, at an
    even size (SAME pads (0, 1)) and an odd one ((1, 1))."""
    jmodel, variables, tmodel = _carried(seed=1)
    x = np.random.RandomState(0).randn(3, size, size, 3).astype(np.float32)
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    tmodel.eval()
    np.testing.assert_allclose(tmodel(tx).detach().numpy(), want, **FWD_TOL)
    want, mut = jmodel.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    tmodel.train()
    np.testing.assert_allclose(tmodel(tx).detach().numpy(), want, **FWD_TOL)
    stats = _port_state(jax.device_get(variables["params"]),
                        jax.device_get(mut["batch_stats"]))
    for name, t in tmodel.named_buffers():
        np.testing.assert_allclose(t.numpy(), stats[name], err_msg=name,
                                   **FWD_TOL)
    assert ttiny.same_pads(32, 3, 2) == (0, 1)
    assert ttiny.same_pads(15, 3, 2) == (1, 1)
    assert sum(p.numel() for p in tmodel.parameters()) == sum(
        v.size for v in jax.tree_util.tree_leaves(variables["params"]))
    assert isinstance(get_model("tiny", device="cpu"), ttiny.TinyCNN)


def _optimizers(name, loss_scale=1.0):
    """Both packages' optimizer ``name``; the rates divided by a static
    ``loss_scale``, which no step divides out of the gradients."""
    peak, start = 0.4 / loss_scale, 0.1 / loss_scale
    sj = jsched.warmup_step_decay(peak, 5, [100], warmup_from=start)
    st = warmup_step_decay(peak, 5, [100], warmup_from=start)
    kw = dict(momentum=0.9, weight_decay=1e-4)
    if name == "quant_sgd":
        kw.update(opt_exp=4, opt_man=3, opt_kahan=True)
    return (joptim.make_optimizer(name, sj, **kw),
            make_optimizer(name, st, **kw))


def _two_steps(opt_name, fmt, use_aps, quant_stats=False, loss_scale=1.0):
    """Two steps of W = 2 ranks x ``emulate_node`` 2 x 4 images from
    carried weights in both packages (faithful reduce), both given the
    same static ``loss_scale``; returns the
    state dicts at the start, after JAX's steps and after the port's,
    both packages' losses, both optimizers' momentum buffers by port
    leaf name and the last metrics of each."""
    jmodel, variables, tmodel = _carried(seed=3)
    start = {k: v.numpy().copy() for k, v in tmodel.state_dict().items()}
    tx, opt = _optimizers(opt_name, loss_scale)
    mesh = make_mesh(dp=WORLD, devices=jax.devices()[:WORLD])
    jstate = JState(step=jnp.zeros([], jnp.int32),
                    params=variables["params"],
                    batch_stats=variables["batch_stats"],
                    opt_state=tx.init(variables["params"]))
    # placed as the step returns it: the second step reuses the compile
    jstate = jax.device_put(jstate, NamedSharding(mesh, P()))
    kw = dict(emulate_node=N, use_aps=use_aps, grad_exp=fmt[0],
              grad_man=fmt[1], mode="faithful", quant_stats=quant_stats,
              loss_scale=loss_scale)
    jstep = j_make_step(jmodel, tx, mesh, donate=False, **kw)
    tstate = create_train_state(tmodel, opt)
    tstep = make_train_step(tmodel, opt, LocalMesh(WORLD, "cpu"), **kw)
    rows = WORLD * PER_RANK * N
    x, y, _, _ = jcifar.synthetic_cifar10(2 * rows, 8, seed=4)
    pipe = jcifar.CIFAR10Pipeline(x, y, rows)
    sharding = NamedSharding(mesh, P("dp"))
    losses = []
    for it in range(2):
        bx, by = pipe.batch(np.arange(it * rows, (it + 1) * rows))
        jstate, jm = jstep(jstate, jax.device_put(bx, sharding),
                           jax.device_put(by, sharding))
        tstate, tm = tstep(tstate, bx, by)
        losses.append((float(jm["loss"]), float(tm["loss"])))
        assert float(tm["accuracy"]) == pytest.approx(
            float(jm["accuracy"]))
    assert tstate.step == int(jstate.step) == 2
    want = _port_state(jax.device_get(jstate.params),
                       jax.device_get(jstate.batch_stats))
    got = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    jbuf = _port_state(jax.device_get(jstate.opt_state.momentum_buf),
                       jax.device_get(jstate.batch_stats))
    tbuf = {name: b.numpy() for (name, _), b in zip(
        tmodel.named_parameters(), tstate.opt_state.momentum_buf)}
    return (start, want, got, np.array(losses), jbuf, tbuf,
            ({k: float(v) for k, v in jm.items()},
             {k: float(v) for k, v in tm.items()}))


def _check(start, want, got, losses, share):
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=LOSS_RTOL)
    for name, g in got.items():
        if "running" in name:
            np.testing.assert_allclose(g, want[name], err_msg=name,
                                       **STATS_TOL)
            continue
        moved = np.linalg.norm(want[name] - start[name])
        if moved == 0:      # LARS leaves a zero-norm leaf where it is
            np.testing.assert_array_equal(g, want[name], err_msg=name)
            continue
        assert np.linalg.norm(g - want[name]) <= share * moved, name


# (optimizer, gradient format, APS, static loss_scale).  The packages
# differ by fp32 round-off in the convolutions and BN sums; the worst
# leaf's change measured 1.4e-5 of JAX's with SGD at (8, 23) (a BN
# scale), 1.9e-6 at APS (5, 2) (no gradient sat at an e5m2 tie), 1.7e-5
# with LARS (a conv) and 1.5e-7 with the e4m3 Kahan buffer, 8.8e-7 at
# loss_scale 1024 with APS (5, 2) and 4.7e-7 at loss_scale 3 without
# APS; the momentum buffers 2.2e-6.
STEP_SHARE = 1e-4
STEP_CASES = [("sgd", (8, 23), False, 1.0), ("sgd", (5, 2), True, 1.0),
              ("lars", (8, 23), False, 1.0),
              ("quant_sgd", (8, 23), False, 1.0),
              ("sgd", (5, 2), True, 1024.0), ("sgd", (5, 2), False, 3.0)]


@pytest.mark.parametrize("opt_name,fmt,use_aps,loss_scale", STEP_CASES)
def test_two_emulated_steps_match_jax(opt_name, fmt, use_aps, loss_scale):
    """Two steps at W = 2 x ``emulate_node`` 2 on the tiny CNN: the
    micro-batch split, the BN stats carried from micro-batch to
    micro-batch, the loss / (W*N) times a static ``loss_scale`` (no
    unscale after: the scale reaches the emulate cast, the APS shift and
    the update), the local emulate reduce, the faithful reduce and the
    update (SGD, LARS or the e4m3 Kahan `quant_sgd`) against the JAX
    step, every leaf within STEP_SHARE; the momentum buffers within
    STEP_SHARE of their magnitude.  The APS (5, 2) cases run with
    ``quant_stats``: their five ``prec_*`` metrics equal JAX's,
    ``wire_total`` W x the parameter count."""
    stats = use_aps
    start, want, got, losses, jbuf, tbuf, (jm, tm) = _two_steps(
        opt_name, fmt, use_aps, quant_stats=stats, loss_scale=loss_scale)
    _check(start, want, got, losses, STEP_SHARE)
    for name, b in tbuf.items():
        assert np.linalg.norm(b - jbuf[name]) <= STEP_SHARE * \
            np.linalg.norm(jbuf[name]), f"momentum of {name}"
    if stats:
        n = sum(v.size for k, v in start.items() if "running" not in k)
        assert tm["prec_wire_total"] == WORLD * n
        assert {k: v for k, v in tm.items() if k.startswith("prec_")} == \
            {k: v for k, v in jm.items() if k.startswith("prec_")}
    else:
        assert not any(k.startswith("prec_") for k in tm)


def test_loss_scale_and_micro_batch_contract():
    """A static power-of-two ``loss_scale`` gives exactly 2x the
    gradients (no unscale follows); ``"dynamic"`` runs at W = 2 x N, the
    scale of the wrapped optimizer reaching the loss (one finite step at
    ``growth_interval`` 1 doubles it); a per-rank batch that N does not
    divide raises."""
    _, _, tmodel = _carried(seed=2)
    x, y, _, _ = jcifar.synthetic_cifar10(16, 8, seed=1)
    bx, by = as_batch(x, y, "cpu")
    mesh = LocalMesh(WORLD, "cpu")
    g1 = local_gradients(tmodel, bx, by, mesh, N)[0]
    g2 = local_gradients(tmodel, bx, by, mesh, N, loss_scale=2.0)[0]
    for a, b in zip(g1, g2):
        for u, v in zip(a, b):
            assert u.shape[0] == N
            np.testing.assert_array_equal((2 * u).numpy(), v.numpy())
    _, opt = _optimizers("sgd")
    opt = with_dynamic_loss_scale(opt, init_scale=4.0, growth_interval=1)
    state = create_train_state(tmodel, opt)
    state, m = make_train_step(tmodel, opt, mesh, emulate_node=N,
                               loss_scale="dynamic")(state, x, y)
    assert math.isfinite(float(m["loss"]))
    assert (state.opt_state.scale, state.opt_state.good_steps) == (8.0, 0)
    with pytest.raises(ValueError, match="emulate_node=3"):
        local_gradients(tmodel, bx, by, mesh, 3)


def _argv(root, *extra):
    return ["--arch", "tiny", "--use_APS", "--grad_exp", "5", "--grad_man",
            "2", "--batch_size", "4", "--max-iter", "2", "--val_freq", "2",
            "--print_freq", "1", "--data-root", root, "--save_path",
            os.path.join(root, "ckpt"), *extra]


@pytest.mark.parametrize("extra,opt_name", [
    (["--emulate_node", "2", "--use_lars"], "lars"),
    (["--emulate_node", "2", "--opt_exp", "4", "--opt_man", "3",
      "--opt_kahan"], "quant_sgd")])
def test_cli_trains_emulated_with_lars_and_quant_sgd(
        tiny_cifar_factory, tmp_path, capsys, extra, opt_name):
    """2 iterations of the ResNet CLI on the CPU at ``--arch tiny``, W = 2
    ranks x ``--emulate_node 2``: finite losses, the validation line,
    the optimizer the flags select."""
    root = tiny_cifar_factory(tmp_path, n_train=40, n_test=8)
    args = tcli.parse_args(_argv(root, *extra))
    assert args.opt_name == opt_name and args.emulate_node == 2
    res = tcli.run(args, device="cpu", world=2)
    out = capsys.readouterr().out
    assert res["step"] == 2 and not res["diverged"]
    assert math.isfinite(res["loss"])
    assert "Iter: [2/2]" in out and "Prec@1" in out


@pytest.mark.parametrize("extra,match", [
    (["--use_lars", "--opt_exp", "4"], "exclusive"),
    (["--opt-rounding", "stochastic"], "quantized buffer"),
    (["--opt_kahan", "--opt-rounding", "stochastic"], "quantized buffer"),
    (["--optimizer", "sgd", "--use_lars"], "contradicts"),
    (["--optimizer", "lars", "--opt_man", "2"], "quantized momentum"),
    (["--optimizer", "shampoo-lite"], "not yet ported"),
    (["--emulate_node", "0"], "emulate_node")])
def test_cli_contradictions_exit(extra, match):
    """The JAX trainer's contradiction checks, as SystemExits."""
    with pytest.raises(SystemExit, match=match):
        tcli.parse_args(["--arch", "tiny"] + extra)


def test_cli_new_flags_are_ported():
    """The flags this slice ports are gone from ``_NOT_PORTED`` and
    parse; ``--optimizer`` names the optimizer; the rest still raise
    naming their ROADMAP item."""
    flags = ("--emulate_node", "--use_lars", "--opt_exp", "--opt_man",
             "--opt_kahan", "--opt-rounding", "--opt-seed", "--optimizer")
    assert not set(flags) & set(tcli._NOT_PORTED)
    args = tcli.parse_args(["--emulate_node", "8", "--opt_exp", "4",
                            "--opt_man", "3", "--opt-rounding",
                            "stochastic", "--opt-seed", "3"])
    assert (args.opt_name, args.opt_seed, args.emulate_node) == (
        "quant_sgd", 3, 8)
    for name in ("sgd", "nesterov", "lars", "quant_sgd"):
        assert tcli.parse_args(["--optimizer", name]).opt_name == name
    with pytest.raises(SystemExit, match=r"ROADMAP Queue A, A6"):
        tcli.parse_args(["--zero1"])
