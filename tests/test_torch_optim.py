"""The port's optimizers (`cpd_tpu_torch.train.optim`) vs the JAX
package's (`cpd_tpu.train.optim`), tests/test_train.py:78-200's cases.

Each test says how it compares:

* BITWISE — three updates of `quant_sgd` in every arm (naive and Kahan,
  RTNE and SR, Nesterov, ``wd_mask``) at (4, 3), `quant_sgd` at (8, 23)
  against `sgd`, `sgd` with Nesterov and ``wd_mask``, and LARS given the
  same norms in both packages;
* to a TOLERANCE — LARS with each package's own norms: XLA and ATen sum
  ||w|| and ||g|| in other orders, so each leaf's weights and buffer are
  held within LARS_RTOL of their magnitude (measured 1.9e-8 on the
  head's buffer; the other leaves came out bitwise);
* AdamW against ``optax.adamw`` over five updates, with and without the
  weight-decay mask, to ADAMW_RTOL (measured: bitwise on this host —
  the port's fp32 ``1 - b**count`` equals optax's jitted one at every
  count below 200 — but XLA's ``pow`` is not numpy's, so a count may
  differ in the last bit); BITWISE given the same bias corrections;
* global-norm clipping against ``optax.clip_by_global_norm`` on both
  sides of ``max_norm``: BITWISE given the same ``g_norm``, and the
  norm itself to NORM_RTOL (XLA and ATen sum the squares in other
  orders; the port squares each leaf's ``_foreach_norm``; measured
  9.9e-8, one fp32 ulp).

The weights, gradients and buffers are the same leaf lists in both
packages, normal fp32 values (XLA:CPU flushes subnormals).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpd_tpu.train import optim as joptim
from cpd_tpu.train import schedules as jsched
from cpd_tpu_torch.train import optim as toptim
from cpd_tpu_torch.train import schedules as tsched

SHAPES = [(6, 3, 3, 3), (6,), (10, 6)]
# LARS with each package's own norms: each leaf within this share of its
# L2 magnitude (measured 1.9e-8, the head's buffer after three updates)
LARS_RTOL = 1e-6
# AdamW after five updates, each leaf's weights and moments relative to
# their magnitude (measured 0: bitwise at counts 1-5)
ADAMW_RTOL = 1e-6
# the global norm of the clip (measured 9.9e-8 relative: one fp32 ulp)
NORM_RTOL = 1e-6


def _bitwise(want, got, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  got.view(np.uint32), err_msg=msg)


def _schedules():
    return (jsched.warmup_step_decay(0.4, 2, [100], warmup_from=0.1),
            tsched.warmup_step_decay(0.4, 2, [100], warmup_from=0.1))


def _run(jtx, topt, steps=3, seed=0, grad_scale=1e-2):
    """``steps`` updates of both optimizers from the same weights with
    the same gradients; returns both packages' params and states."""
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jp = [jnp.asarray(p) for p in params]
    js = jtx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = topt.init(tp)
    for _ in range(steps):
        grads = [(rng.randn(*s) * grad_scale).astype(np.float32)
                 for s in SHAPES]
        upd, js = jtx.update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = topt.apply([torch.from_numpy(g) for g in grads], ts, tp)
    return jp, js, tp, ts


def _wd_mask(params):
    """Weight decay on the conv and head kernels, not on the bias-like
    leaf (the BN-params-without-wd grouping)."""
    return [p.ndim > 1 for p in params]


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("kahan", [False, True])
def test_quant_sgd_matches_jax(kahan, rounding, mask, nesterov):
    """Bitwise over three updates at (4, 3): the eXmY buffer (and Kahan
    residual), every cast site, the SR keys (``fold_in(PRNGKey(seed),
    step)``, split by leaf, ``fold_in`` by site), Nesterov and the
    weight-decay mask."""
    js, ts = _schedules()
    kw = dict(momentum=0.9, weight_decay=1e-3, exp=4, man=3,
              use_kahan=kahan, nesterov=nesterov,
              wd_mask=_wd_mask if mask else None, rounding=rounding,
              seed=5)
    jp, jst, tp, tst = _run(joptim.quant_sgd(js, **kw),
                            toptim.quant_sgd(ts, **kw))
    for i, (a, b) in enumerate(zip(jp, tp)):
        _bitwise(a, b, f"param {i}")
    for i, (a, b) in enumerate(zip(jst.momentum_buf, tst.momentum_buf)):
        _bitwise(a, b, f"buffer {i}")
    if kahan:
        for i, (a, b) in enumerate(zip(jst.comp, tst.comp)):
            _bitwise(a, b, f"residual {i}")
    assert tst.step == int(jst.step) == 3


@pytest.mark.parametrize("nesterov", [False, True])
def test_quant_sgd_at_fp32_is_sgd(nesterov):
    """At (8, 23) the cast is the identity and RTNE quant_sgd walks
    `sgd`'s trajectory bitwise (SR asked for at (8, 23) is off, as in
    the JAX package)."""
    _, ts = _schedules()
    out = []
    for opt in (toptim.sgd(ts, 0.9, 1e-4, nesterov=nesterov),
                toptim.quant_sgd(ts, 0.9, 1e-4, nesterov=nesterov,
                                 rounding="stochastic")):
        rng = np.random.RandomState(1)
        tp = [torch.from_numpy(rng.randn(*s).astype(np.float32))
              for s in SHAPES]
        st = opt.init(tp)
        for _ in range(3):
            st = opt.apply([torch.from_numpy(
                (rng.randn(*s) * 1e-2).astype(np.float32)) for s in SHAPES],
                st, tp)
        out.append((tp, st.momentum_buf))
    for a, b in zip(out[0][0] + out[0][1], out[1][0] + out[1][1]):
        _bitwise(a.numpy(), b)
    assert toptim.quant_sgd(ts, rounding="stochastic").init([]).key is None


@pytest.mark.parametrize("nesterov,mask", [(True, False), (True, True),
                                           (False, True)])
def test_sgd_nesterov_and_wd_mask_match_jax(nesterov, mask):
    """Bitwise over three updates: ``d + momentum * buf`` for Nesterov,
    weight decay only on the masked leaves."""
    js, ts = _schedules()
    kw = dict(momentum=0.9, weight_decay=1e-3, nesterov=nesterov,
              wd_mask=_wd_mask if mask else None)
    jp, jst, tp, tst = _run(joptim.sgd(js, **kw), toptim.sgd(ts, **kw))
    for a, b in zip(jp + list(jst.momentum_buf), tp + tst.momentum_buf):
        _bitwise(a, b)


def test_lars_matches_jax_within_tolerance():
    """LARS with each package's own norms: every leaf's weights and
    buffer after three updates within LARS_RTOL of their magnitude."""
    js, ts = _schedules()
    jp, jst, tp, tst = _run(joptim.lars(js, 0.9, 1e-4),
                            toptim.lars(ts, 0.9, 1e-4))
    for i, (a, b) in enumerate(zip(jp + list(jst.momentum_buf),
                                   tp + tst.momentum_buf)):
        a, b = np.asarray(a), b.numpy()
        assert np.linalg.norm(b - a) <= LARS_RTOL * np.linalg.norm(a), i
    assert tst.step == int(jst.step) == 3


def test_lars_is_bitwise_given_the_same_norms(monkeypatch):
    """Bitwise when both packages read the same ||w|| and ||g|| (an fp32
    norm computed once in numpy, fed to each): the trust ratio, the
    rate folded into the buffer and the update are the same fp32
    operations in the same order."""
    def np_norm(v):
        v = np.asarray(v, np.float64).reshape(-1)
        return np.float32(np.sqrt(np.sum(v * v)))

    monkeypatch.setattr(joptim.jnp.linalg, "norm",
                        lambda v: jnp.asarray(np_norm(v)))
    monkeypatch.setattr(toptim, "_norms", lambda vs: torch.tensor(
        [np_norm(v.numpy()) for v in vs]))
    js, ts = _schedules()
    jp, jst, tp, tst = _run(joptim.lars(js, 0.9, 1e-4),
                            toptim.lars(ts, 0.9, 1e-4))
    for a, b in zip(jp + list(jst.momentum_buf), tp + tst.momentum_buf):
        _bitwise(a, b)


def _adamw_pair(mask: bool):
    js, ts = _schedules()
    kw = dict(momentum=0.9, weight_decay=1e-2,
              wd_mask=_wd_mask if mask else None)
    return (joptim.make_optimizer("adamw", js, **kw),
            toptim.make_optimizer("adamw", ts, **kw))


def _adam_leaves(jst, tst) -> list:
    """(JAX leaf, port leaf) pairs of the moments of both states."""
    adam = jst[0]
    assert tst.count == int(adam.count)
    return list(zip(list(adam.mu) + list(adam.nu), tst.mu + tst.nu))


@pytest.mark.parametrize("mask", [False, True])
def test_adamw_matches_optax(mask):
    """Five updates of AdamW (b1 = momentum 0.9, b2 0.999, eps 1e-8, wd
    1e-2 on every leaf or on the masked ones) against optax's: weights
    and both moments within ADAMW_RTOL of their magnitude."""
    jp, jst, tp, tst = _run(*_adamw_pair(mask), steps=5)
    for i, (a, b) in enumerate(list(zip(jp, tp)) + _adam_leaves(jst, tst)):
        a, b = np.asarray(a), b.numpy()
        assert np.linalg.norm(b - a) <= ADAMW_RTOL * np.linalg.norm(a), i
    assert tst.count == 5


def test_adamw_is_bitwise_given_the_same_bias_corrections(monkeypatch):
    """Both packages divide the moments by one fp32 ``1 - b**count``
    computed in numpy: the moments, the bias-corrected direction, the
    masked decay and the rate are then the same fp32 operations in the
    same order (optax's, op by op)."""
    def correction(decay, count):
        f32 = np.float32
        return f32(1) - f32(decay) ** f32(int(count))

    monkeypatch.setattr(optax.tree, "bias_correction", lambda m, d, c: [
        t / jnp.asarray(correction(d, c)) for t in m])
    monkeypatch.setattr(toptim, "bias_correction",
                        lambda d, c: float(correction(d, c)))
    for mask in (False, True):
        jp, jst, tp, tst = _run(*_adamw_pair(mask), steps=5)
        for a, b in list(zip(jp, tp)) + _adam_leaves(jst, tst):
            _bitwise(a, b)


def _clip_grads(seed: int) -> list:
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * 0.3).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm, monkeypatch):
    """The clip on both sides of ``max_norm`` (the gradients' norm is ~4.8):
    the global norm within NORM_RTOL of optax's; with both packages fed
    one norm (summed in float64 by numpy, rounded to fp32) the clipped
    gradients bitwise optax's (unchanged below ``max_norm``); and SGD
    behind ``make_optimizer(clip_norm=)`` bitwise the JAX chain over
    three updates given that norm."""
    from optax._src import linear_algebra

    grads = _clip_grads(2)
    got = float(toptim.global_norm([torch.from_numpy(g) for g in grads]))
    want = float(optax.global_norm([jnp.asarray(g) for g in grads]))
    assert abs(got - want) <= NORM_RTOL * want

    def np_norm(gs):
        return np.float32(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                                      for g in gs)))

    monkeypatch.setattr(linear_algebra, "global_norm",
                        lambda gs: jnp.asarray(np_norm(
                            jax.tree_util.tree_leaves(gs))))
    monkeypatch.setattr(toptim, "global_norm", lambda gs: torch.tensor(
        np_norm([g.numpy() for g in gs])))
    clip = optax.clip_by_global_norm(max_norm)
    want, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(None))
    got = toptim.clip_by_global_norm([torch.from_numpy(g) for g in grads],
                                     max_norm)
    for a, b, g in zip(want, got, grads):
        _bitwise(a, b)
        if max_norm > 5:
            _bitwise(g, b)
    js, ts = _schedules()
    kw = dict(momentum=0.9, weight_decay=1e-3, clip_norm=max_norm)
    jp, jst, tp, tst = _run(joptim.make_optimizer("sgd", js, **kw),
                            toptim.make_optimizer("sgd", ts, **kw),
                            grad_scale=0.3)
    for a, b in zip(jp + list(jst[1].momentum_buf), tp + tst.momentum_buf):
        _bitwise(a, b)


def test_make_optimizer_names_and_errors():
    """The registry builds the five names with their settings and the
    clip in front of any of them; ``clip_norm <= 0`` and an unknown name
    raise, as the JAX registry's."""
    _, ts = _schedules()
    assert isinstance(toptim.make_optimizer("sgd", ts), toptim.SGD)
    assert toptim.make_optimizer("nesterov", ts).nesterov
    assert isinstance(toptim.make_optimizer("lars", ts, 0.8, 1e-4),
                      toptim.LARS)
    q = toptim.make_optimizer("quant_sgd", ts, opt_exp=4, opt_man=3,
                              opt_kahan=True, opt_rounding="stochastic",
                              opt_seed=3)
    assert (q.fmt, q.use_kahan, q.stochastic, q.seed) == ((4, 3), True,
                                                          True, 3)
    a = toptim.make_optimizer("adamw", ts, 0.8, 1e-4, wd_mask=_wd_mask)
    assert isinstance(a, toptim.AdamW)
    assert (a.b1, a.weight_decay, a.wd_mask) == (0.8, 1e-4, _wd_mask)
    # b2 and eps are optax.adamw's defaults, which the reference keeps
    # (it passes neither), and eps_root, which the port leaves out, is 0
    adam_defaults = inspect.signature(optax.adamw).parameters
    assert (toptim.ADAM_B2, toptim.ADAM_EPS, 0.0) == tuple(
        adam_defaults[k].default for k in ("b2", "eps", "eps_root"))
    for name in ("sgd", "lars", "quant_sgd", "adamw"):
        c = toptim.make_optimizer(name, ts, clip_norm=1.5)
        assert isinstance(c, toptim.ClipByGlobalNorm) and c.max_norm == 1.5
        assert type(c.inner) is type(toptim.make_optimizer(name, ts))
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="clip_norm must be > 0"):
            toptim.make_optimizer("sgd", ts, clip_norm=bad)
        with pytest.raises(ValueError, match="clip_norm must be > 0"):
            joptim.make_optimizer("sgd", ts, clip_norm=bad)
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.make_optimizer("adam", ts)
    with pytest.raises(ValueError, match="unknown rounding"):
        toptim.quant_sgd(ts, rounding="up")
    with pytest.raises(ValueError, match="CUDA"):
        q.apply([torch.zeros(2)], q.init([torch.zeros(2)]),
                [torch.zeros(2)], fused=True)
