"""Dynamic loss scaling on the port (`cpd_tpu_torch.train.scaling`) vs
the JAX package's (`cpd_tpu.train.scaling`).

Each test says how it compares:

* BITWISE — `with_dynamic_loss_scale` around SGD over a scripted
  sequence of finite and non-finite gradient lists (NaN, +Inf and -Inf
  in one leaf; a finite run long enough to grow; the ``max_scale`` and
  ``min_scale`` clamps): after every step the scale and ``good_steps``,
  the weights and the inner SGD momentum equal JAX's (the JAX update
  run op by op, its updates applied with ``optax.apply_updates``);
* EXACT — `all_finite`, `find_dynamic_scale` through a nested state,
  the two ``ValueError`` refusals, `current_scale`'s ``TypeError``, and
  a verified step that a wire fault discards leaving the scale state,
  the weights and the momentum untouched;
* to a TOLERANCE — two steps of the tiny CNN through
  ``make_train_step(loss_scale="dynamic")`` at W = 2 against the JAX
  step, the second batch poisoned with a NaN pixel: the first step's
  loss within LOSS_RTOL, every leaf within STEP_SHARE of JAX's change
  (tests/test_torch_emulate_step.py's tolerances: the two packages sum
  the convolutions and BN statistics in other orders), the skip, the
  scales and ``good_steps`` exact, the second step's weights bitwise
  the first's.
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
from cpd_tpu.models import tiny as jtiny
from cpd_tpu.parallel.mesh import make_mesh
from cpd_tpu.train import optim as joptim
from cpd_tpu.train import scaling as jscaling
from cpd_tpu.train.state import TrainState as JState
from cpd_tpu.train.step import make_train_step as j_make_step
from cpd_tpu_torch.interop import load_jax_tiny
from cpd_tpu_torch.models import tiny as ttiny
from cpd_tpu_torch.parallel.mesh import LocalMesh
from cpd_tpu_torch.train import create_train_state, make_train_step
from cpd_tpu_torch.train import optim as toptim
from cpd_tpu_torch.train import scaling as tscaling

SHAPES = [(5, 3), (4,), (2, 2, 3)]
LOSS_RTOL = 1e-5
STEP_SHARE = 1e-4
WORLD, PER_RANK = 2, 4


def _bitwise(want, got, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert want.dtype == got.dtype and want.shape == got.shape, msg
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32),
                                  err_msg=msg)


def _script():
    """(kind, leaf) per step: 'ok' scales the step's gradients by the live
    scale; 'nan', 'inf' and '-inf' poison one element of leaf ``leaf``."""
    return ([("ok", 0)] * 5 + [("nan", 1), ("inf", 0), ("ok", 0),
                               ("-inf", 2)] + [("nan", 0)] * 4
            + [("ok", 0)] * 4)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_scripted_sequence_is_bitwise_the_reference(momentum):
    """init 2^3, growth every 2 finite steps up to max 2^5, backoff to
    min 2^1: the script grows, hits the max, skips on each non-finite
    kind (the inner state kept), hits the min and grows again."""
    kw = dict(init_scale=2.0 ** 3, growth_interval=2, max_scale=2.0 ** 5,
              min_scale=2.0)
    lr = lambda s: 0.05  # noqa: E731
    jtx = jscaling.with_dynamic_loss_scale(joptim.sgd(lr, momentum), **kw)
    topt = tscaling.with_dynamic_loss_scale(toptim.sgd(lr, momentum), **kw)
    rng = np.random.RandomState(0)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jp = [jnp.asarray(p) for p in params]
    js = jtx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = topt.init(tp)
    seen = set()
    for i, (kind, leaf) in enumerate(_script()):
        assert ts.scale == float(js.scale)
        grads = [(rng.randn(*s) * 1e-2).astype(np.float32) * ts.scale
                 for s in SHAPES]
        if kind != "ok":
            grads[leaf].reshape(-1)[1] = {"nan": np.nan, "inf": np.inf,
                                          "-inf": -np.inf}[kind]
        upd, js = jtx.update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = topt.apply([torch.from_numpy(g) for g in grads], ts, tp)
        assert (ts.scale, ts.good_steps) == (float(js.scale),
                                             int(js.good_steps)), i
        seen.add((kind, ts.scale))
        for j, (a, b) in enumerate(zip(jp, tp)):
            _bitwise(a, b, f"step {i} param {j}")
        for j, (a, b) in enumerate(zip(js.inner.momentum_buf,
                                       ts.inner.momentum_buf)):
            _bitwise(a, b, f"step {i} momentum {j}")
    # every path ran: growth to the max clamp, skips of every kind, the
    # min clamp
    assert ("ok", 2.0 ** 5) in seen and ("nan", 2.0) in seen
    assert {k for k, _ in seen} == {"ok", "nan", "inf", "-inf"}


def test_all_finite_and_find_through_a_nested_state():
    assert bool(tscaling.all_finite([torch.ones(3), torch.zeros(2)]))
    assert bool(tscaling.all_finite([]))
    big = torch.full((4,), 3e38)     # a sum of squares would overflow
    assert bool(tscaling.all_finite([big]))
    for bad in (math.nan, math.inf, -math.inf):
        leaves = [torch.ones(3), torch.tensor([1.0, bad])]
        assert not bool(tscaling.all_finite(leaves)), bad
        assert not bool(tscaling.all_finite({"a": [leaves]})), bad
    opt = tscaling.with_dynamic_loss_scale(toptim.sgd(lambda s: 0.1),
                                           init_scale=64.0)
    params = [torch.ones(2)]
    node = opt.init(params)
    # a chain-like state that holds the wrapper's one level down, and
    # the clip wrapper, whose state is the inner optimizer's
    nested = (toptim.TorchSGDState(0, []), {"x": [node]})
    assert tscaling.find_dynamic_scale(nested) is node
    assert tscaling.current_scale(nested) == 64.0
    clipped = toptim.ClipByGlobalNorm(opt, 1.0)
    assert tscaling.current_scale(clipped.init(params)) == 64.0
    jnested = optax.chain(optax.clip_by_global_norm(1.0),
                          jscaling.with_dynamic_loss_scale(
                              joptim.sgd(lambda s: 0.1), init_scale=64.0)
                          ).init([jnp.ones(2)])
    assert float(jscaling.current_scale(jnested)) == 64.0
    assert tscaling.find_dynamic_scale(toptim.TorchSGDState(0, [])) is None
    with pytest.raises(TypeError, match="with_dynamic_loss_scale"):
        tscaling.current_scale(toptim.TorchSGDState(0, []))


def test_refusals():
    """The wrapper's factor checks and the static-scale step's refusal
    of a wrapped optimizer, as the JAX package's ValueErrors."""
    sgd = toptim.sgd(lambda s: 0.1)
    for kw in ({"growth_factor": 1.0}, {"backoff_factor": 1.5}):
        with pytest.raises(ValueError, match="growth_factor"):
            tscaling.with_dynamic_loss_scale(sgd, **kw)
        with pytest.raises(ValueError, match="growth_factor"):
            jscaling.with_dynamic_loss_scale(joptim.sgd(lambda s: 0.1), **kw)
    model = ttiny.TinyCNN(device="cpu")
    mesh = LocalMesh(1, "cpu")
    x = np.zeros((2, 8, 8, 3), np.float32)
    y = np.zeros((2,), np.int64)
    wrapped = tscaling.with_dynamic_loss_scale(sgd)
    step = make_train_step(model, wrapped, mesh, loss_scale=2.0)
    with pytest.raises(ValueError, match="loss_scale is static"):
        step(create_train_state(model, wrapped), x, y)
    step = make_train_step(model, sgd, mesh, loss_scale="dynamic")
    with pytest.raises(TypeError, match="with_dynamic_loss_scale"):
        step(create_train_state(model, sgd), x, y)


def test_a_discarded_verified_step_keeps_the_scale_state():
    """A verified ring step whose reduce a wire fault broke applies
    nothing: the weights, the scale, ``good_steps`` and the inner
    momentum stay as they were; a clean retry applies and counts one
    finite step."""
    model = ttiny.TinyCNN(device="cpu")
    opt = tscaling.with_dynamic_loss_scale(toptim.sgd(lambda s: 0.1, 0.9),
                                           init_scale=64.0)
    state = create_train_state(model, opt)
    kw = dict(mode="ring", use_aps=True, grad_exp=5, grad_man=2,
              verify_reduce=True, loss_scale="dynamic")
    step = make_train_step(model, opt, LocalMesh(WORLD, "cpu"),
                           wire_fault_plan=([1], [1]), **kw)
    x, y, _, _ = jcifar.synthetic_cifar10(2 * WORLD * PER_RANK, 8, seed=2)
    rows = WORLD * PER_RANK
    before = [p.detach().clone() for p in model.parameters()]
    state, m = step(state, x[:rows], y[:rows])
    assert float(m["reduce_ok"]) == 0.0
    assert (state.opt_state.scale, state.opt_state.good_steps) == (64.0, 0)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 model.parameters()))
    assert all(not b.any() for b in state.opt_state.inner.momentum_buf)
    # the plan is keyed by the update index, which a discarded step does
    # not advance: the retry runs without it
    step = make_train_step(model, opt, LocalMesh(WORLD, "cpu"), **kw)
    state, m = step(state, x[rows:], y[rows:])
    assert float(m["reduce_ok"]) == 1.0
    assert (state.opt_state.scale, state.opt_state.good_steps) == (64.0, 1)
    assert not all(torch.equal(a, b) for a, b in zip(before,
                                                     model.parameters()))


def test_two_dynamic_steps_match_jax():
    """W = 2 x 4 images a rank, faithful fp32 reduce, SGD momentum 0.9
    wrapped at init 2^10 growing every finite step: step 0 applies and
    doubles the scale; step 1's batch holds a NaN pixel, so both
    packages skip it, halve the scale and reset ``good_steps``."""
    jmodel = jtiny.TinyCNN()
    variables = jax.device_get(jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((2, 32, 32, 3)), train=False))(jax.random.PRNGKey(5)))
    tmodel = load_jax_tiny(ttiny.TinyCNN(device="cpu"), variables)
    start = {k: v.numpy().copy() for k, v in tmodel.state_dict().items()}
    kw = dict(init_scale=2.0 ** 10, growth_interval=1)
    lr = lambda s: 0.1  # noqa: E731
    tx = jscaling.with_dynamic_loss_scale(joptim.sgd(lr, 0.9), **kw)
    opt = tscaling.with_dynamic_loss_scale(toptim.sgd(lr, 0.9), **kw)
    mesh = make_mesh(dp=WORLD, devices=jax.devices()[:WORLD])
    jstate = JState(step=jnp.zeros([], jnp.int32),
                    params=variables["params"],
                    batch_stats=variables["batch_stats"],
                    opt_state=tx.init(variables["params"]))
    # placed as the step returns it: the second step reuses the compile
    jstate = jax.device_put(jstate, NamedSharding(mesh, P()))
    jstep = j_make_step(jmodel, tx, mesh, donate=False, mode="faithful",
                        loss_scale="dynamic")
    tstate = create_train_state(tmodel, opt)
    tstep = make_train_step(tmodel, opt, LocalMesh(WORLD, "cpu"),
                            mode="faithful", loss_scale="dynamic")
    rows = WORLD * PER_RANK
    x, y, _, _ = jcifar.synthetic_cifar10(2 * rows, 8, seed=6)
    pipe = jcifar.CIFAR10Pipeline(x, y, rows, augment=False)
    sharding = NamedSharding(mesh, P("dp"))
    after = []
    for it in range(2):
        bx, by = pipe.batch(np.arange(it * rows, (it + 1) * rows))
        if it == 1:
            bx[rows - 1, 3, 4, 0] = np.nan      # rank 1's last image
        jstate, jm = jstep(jstate, jax.device_put(bx, sharding),
                           jax.device_put(by, sharding))
        tstate, tm = tstep(tstate, bx, by)
        js, ts = jstate.opt_state, tstate.opt_state
        assert (ts.scale, ts.good_steps) == (float(js.scale),
                                             int(js.good_steps)), it
        if it == 0:
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=LOSS_RTOL)
        else:
            assert math.isnan(float(tm["loss"]))
        after.append({k: v.detach().numpy().copy()
                      for k, v in tmodel.named_parameters()})
    assert (ts.scale, ts.good_steps) == (2.0 ** 10, 0)
    assert tstate.step == int(jstate.step) == 2
    for name, p in after[1].items():
        _bitwise(after[0][name], p, name)
    jmoved = load_jax_tiny(ttiny.TinyCNN(device="cpu"), jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    want = {k: v.detach().numpy() for k, v in jmoved.named_parameters()}
    for name, p in after[1].items():
        moved = np.linalg.norm(want[name] - start[name])
        assert moved > 0, name
        assert np.linalg.norm(p - want[name]) <= STEP_SHARE * moved, name

