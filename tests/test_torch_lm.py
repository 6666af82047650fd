"""The port's LM training slice vs the JAX package: data, schedule, the
GQA-flash LM with the eXmY-accumulator FFN, the train and eval steps and
the trainer CLI.

`SyntheticText` is bitwise; `warmup_cosine` within two fp32 ulps of
``base_lr`` (XLA contracts its warmup into an FMA and has its own cos).
The tiny LM (vocab 64, d_model 32, 2 layers, 4 heads, 2 kv heads, d_ff
64, ``attn_impl="flash"``, e4m3 faithful FFN) loaded from flax params:
logits to LOGIT_ATOL (measured ~1e-6: the attention and LayerNorm sums
run in another order than XLA's).  Two train steps at W = 2 against the
JAX step on 2 CPU devices, at a nonzero rate from step 0: losses to
LOSS_RTOL and every updated leaf after each step, to WEIGHT_ATOL with an
fp32 FFN and within 1/8 of its update with the e4m3 one.  There an FFN
input or gradient that lands within fp32 round-off of an e4m3 rounding
boundary casts to the neighbouring code in one package and not the
other: the FFN is bitwise given equal inputs (tests/test_torch_qgemm.py),
but such a flip moves the step's loss by up to ~2e-3 relative (measured
1.4e-3 at this seed; 0 with an fp32 FFN).

bench.py's LM model — MHA, bf16 compute over fp32 parameters, flash
attention, remat — at a tiny width (MHA: vocab 64, d_model 32, 2 layers,
4 heads, d_ff 64, seq 128 for K11's 128-wide blocks): the stock flash
kernel does not run off a TPU, so the port's MHA flash model (the plain
K11) is held against JAX's ``attn_impl="xla"`` model.  In fp32 every
parameter's gradient and the loss to MHA_TOL, the logits to LOGIT_ATOL
(measured 2.8e-6 at logits of ~1, and 3.6e-6 through the port's xla
path: the sums of two layers in another order than XLA's).  In bf16 (xla, flash and chunked) the
logits to BF16_LOGIT_ATOL and the loss to BF16_LOSS_RTOL: the logits are
a bf16 product of magnitude ~4, whose ulp is 2^-6, and a sum taken in
another order flips a rounding somewhere upstream (measured 2 ulps,
0.031); two bf16 APS e5m2 steps to BF16_LOSS_RTOL.  ``remat`` changes no
bit of the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cpd_tpu.data.lm_data import SyntheticText as JText
from cpd_tpu.models import transformer_lm as jax_lm
from cpd_tpu.parallel.mesh import make_mesh
from cpd_tpu.train import optim as joptim
from cpd_tpu.train import schedules as jsched
from cpd_tpu.train.lm import make_lm_eval_step as j_eval_step
from cpd_tpu.train.lm import make_lm_train_step as j_train_step
from cpd_tpu.train.state import TrainState as JState
from cpd_tpu_torch.data.lm_data import SyntheticText as TText
from cpd_tpu_torch.examples.lm import train as tcli
from cpd_tpu_torch.interop import _flatten, _state_key, load_jax_params
from cpd_tpu_torch.models import transformer_lm as torch_lm
from cpd_tpu_torch.parallel.mesh import LocalMesh
from cpd_tpu_torch.train import (create_train_state, sgd, warmup_cosine,
                                 warmup_step_decay)
from cpd_tpu_torch.parallel import emulate as temulate
from cpd_tpu_torch.train import lm as tlm
from cpd_tpu_torch.train.lm import make_lm_eval_step, make_lm_train_step
from test_torch_threads import one_torch_thread  # noqa: F401

TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, attn_impl="flash", ffn_exp=4, ffn_man=3)
LOGIT_ATOL = 2e-5
LOSS_RTOL = 5e-3
WEIGHT_ATOL = 1e-7
# test_two_emulated_steps_match_jax: the elements a leaf that may move
# past WEIGHT_ATOL (the measured count), each only where an emulate cast
# input lay within MIDPOINT_ULPS fp32 ulps of an e5m2 rounding boundary
EMU_FLIPS = 1
MIDPOINT_ULPS = 16
# bench.py's LM model at a tiny width: MHA (no kv heads), the fp32 FFN
MHA = dict(TINY, n_kv_heads=None, ffn_exp=8, ffn_man=23)
MHA_SEQ = 128
MHA_TOL = dict(rtol=2e-5, atol=1e-6)
BF16_LOGIT_ATOL = 5e-2
BF16_LOSS_RTOL = 1e-2


def _jax_params(seed=0, base=TINY, **kw):
    model = jax_lm(**dict(base, **kw))
    params = jax.jit(lambda k: model.init(k, jnp.zeros((1, 8), jnp.int32))
                     )(jax.random.PRNGKey(seed))["params"]
    return model, jax.device_get(params)


def _torch_model(params, base=TINY, **kw):
    model = torch_lm(**dict(base, **kw), device="cpu")
    return load_jax_params(model, params)


def test_synthetic_text_bitwise():
    for n, seq, vocab, seed in ((64, 33, 97, 3), (16, 8, 5, 0)):
        jt, tt = JText(n, seq, vocab, seed), TText(n, seq, vocab, seed)
        np.testing.assert_array_equal(jt._cum.view(np.uint64),
                                      tt._cum.view(np.uint64))
        idx = [0, 5, n - 1, 7]
        for batch_seed in (0, 4, -1):
            for a, b in zip(jt.batch(idx, batch_seed),
                            tt.batch(idx, batch_seed)):
                np.testing.assert_array_equal(a, b)
        assert len(tt) == n and tt.labels.shape == (n,)


@pytest.mark.parametrize("args", [(0.1, 20, 200), (0.05, 0, 50),
                                  (1.0, 3, 10, 0.1, 0.5)])
def test_warmup_cosine_vs_jax(args):
    want = jax.jit(jsched.warmup_cosine(*args))
    got = warmup_cosine(*args)
    ulp = 2.0 ** (np.floor(np.log2(args[0])) - 23)
    for s in range(args[2] + 20):
        assert abs(got(s) - float(want(jnp.int32(s)))) <= 2 * ulp, s
    with pytest.raises(ValueError, match="exceed"):
        warmup_cosine(0.1, 10, 10)


def test_tiny_flash_lm_logits_match_flax():
    """The tree of a flax model with attn_impl="flash" and a quantized
    FFN loads unchanged (no key or shape missing or extra), and the
    logits agree to LOGIT_ATOL (plain xla attention too)."""
    toks = np.random.default_rng(1).integers(0, 64, (2, 19)).astype(np.int32)
    for kw in ({}, {"attn_impl": "xla", "ffn_exp": 8, "ffn_man": 23}):
        jm, params = _jax_params(**kw)
        tm = _torch_model(params, **kw)
        want = np.asarray(jax.jit(lambda p, t: jm.apply(
            {"params": p}, t, train=False))(params, jnp.asarray(toks)))
        with torch.no_grad():
            got = tm(torch.from_numpy(toks).long()).numpy()
        assert got.shape == want.shape == (2, 19, 64)
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=str(kw))
    assert type(tm.blocks[0].wi).__name__ == "Dense"
    tq = _torch_model(_jax_params()[1])
    assert type(tq.blocks[0].wi).__name__ == "QuantDense"
    assert tq.blocks[1].wo_mlp.kernel.shape == (64, 32)


def _leaves(params) -> dict:
    """A flax param tree as {port parameter name: numpy array}."""
    return {_state_key(k): np.asarray(v)
            for k, v in _flatten(jax.device_get(params)).items()}


def _replicated(state, mesh):
    """The JAX state placed as the step returns it (replicated over the
    mesh), so the second step reuses the first step's compile."""
    return jax.device_put(state, NamedSharding(mesh, P()))


def _two_steps_match_jax(ffn, weight_tol):
    """Two steps of the faithful APS (5,2) reduce at W = 2, batch 2 per
    rank, seq 16, one layer of the tiny LM at FFN format ``ffn``, from
    the same flax weights, SGD momentum 0.9 with a nonzero rate from step
    0: after each step the losses to LOSS_RTOL, accuracies to one token
    in 64, and every updated leaf within ``weight_tol(update)`` of JAX's,
    ``update`` being the leaf's largest move since the start; the eval
    step's loss too."""
    world, seq = 2, 16
    jm, params = _jax_params(seed=2, n_layers=1, ffn_exp=ffn[0],
                             ffn_man=ffn[1])
    start = _leaves(params)
    schedule = jsched.warmup_step_decay(0.05, 2, [8], warmup_from=0.02)
    tx = joptim.make_optimizer("sgd", schedule, momentum=0.9)
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    jstate = JState(step=jnp.zeros([], jnp.int32), params=params,
                    batch_stats={}, opt_state=tx.init(params))
    jstate = _replicated(jstate, mesh)
    jstep = j_train_step(jm, tx, mesh, use_aps=True, grad_exp=5, grad_man=2,
                         donate=False)
    tm = _torch_model(params, n_layers=1, ffn_exp=ffn[0], ffn_man=ffn[1])
    opt = sgd(warmup_step_decay(0.05, 2, [8], warmup_from=0.02),
              momentum=0.9)
    tstate = create_train_state(tm, opt)
    tmesh = LocalMesh(world, "cpu")
    tstep = make_lm_train_step(tm, opt, tmesh, use_aps=True, grad_exp=5,
                               grad_man=2)
    ds = JText(64, seq, 64, 0)
    for i in range(2):
        toks, tgts = ds.batch(np.arange(4 * i, 4 * i + 4), seed=i)
        jstate, jm_ = jstep(jstate, jnp.asarray(toks), jnp.asarray(tgts))
        tstate, tm_ = tstep(tstate, toks, tgts)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm_["accuracy"]),
                                   float(jm_["accuracy"]), atol=1 / 64)
        want = _leaves(jstate.params)
        for name, p in tstate.model.named_parameters():
            update = np.abs(want[name] - start[name]).max()
            assert update > 0, (i, name)
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       rtol=0, atol=weight_tol(update),
                                       err_msg=f"step {i} {name}")
    assert tstate.step == 2
    toks, tgts = ds.batch(np.arange(60, 64), seed=-1)
    want = j_eval_step(jm, mesh)(jstate, jnp.asarray(toks), jnp.asarray(tgts))
    got = make_lm_eval_step(tm, tmesh)(tstate, toks, tgts)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=LOSS_RTOL)


def test_two_train_steps_match_jax():
    """The e4m3 faithful FFN: a flipped e4m3 gradient code moves its leaf
    by one step of 2^-3 relative, so each leaf is held within 1/8 of its
    update (measured <= 1/15)."""
    _two_steps_match_jax((4, 3), lambda update: update / 8)


def test_two_train_steps_match_jax_fp32_ffn():
    """The FFN at (8, 23), where no cast flips: every leaf within
    WEIGHT_ATOL of JAX's (measured 3.0e-8 after updates of ~1e-2: the
    attention and LayerNorm sums run in another order than XLA's)."""
    _two_steps_match_jax((8, 23), lambda update: WEIGHT_ATOL)


class _FlaxOrder(torch.nn.Module):
    """The port LM with its ``parameters()`` in the flax tree's leaf
    order (the JAX step's): the SR streams fold the leaf index in, so
    the two steps draw the same bits only over the same leaf order."""

    def __init__(self, inner, order):
        super().__init__()
        self.inner = inner
        self.order = list(order)

    def forward(self, toks):
        return self.inner(toks)

    def parameters(self, recurse=True):
        named = dict(self.inner.named_parameters())
        return iter([named[n] for n in self.order])


def _midpoint_ulps(x: np.ndarray, exp: int, man: int) -> np.ndarray:
    """Each element's distance to the nearest eXmY round-to-nearest
    boundary (the midpoint of two neighbouring codes), in fp32 ulps of
    the element; inf at 0."""
    a = np.abs(x.astype(np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    step = np.exp2(np.maximum(e, 2 - 2 ** (exp - 1)) - man)
    r = a / step
    dist = np.abs(r - np.floor(r) - 0.5) * step
    return np.where(a > 0, dist / np.exp2(e - 23), np.inf)


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_two_emulated_steps_match_jax(rounding, monkeypatch):
    """Two steps at W = 2 x ``emulate_node`` 2 x 2 rows, seq 16, of the
    one-layer tiny LM at an fp32 FFN against JAX's
    ``make_lm_train_step(emulate_node=2)``: the micro-batch split, each
    micro loss / (one micro-batch's global token count) / N, the local
    emulate reduce (RTNE, or SR keyed ``fold_in(grad_sr_key(seed, step,
    0), rank)``), the faithful APS (5, 2) reduce with ``quant_stats``,
    SGD.  Losses to LOSS_RTOL, accuracies to one token in 64, the five
    ``prec_*`` metrics equal JAX's and ``prec_wire_total`` W x the
    parameter count.  Each step starts from JAX's weights and momentum
    (the second is loaded into the port's state), so the two packages'
    gradients differ only by their fp32 sums' order (XLA's and ATen's),
    in the last bits.  After each step every element of every leaf
    within WEIGHT_ATOL (as the fp32-FFN steps without emulation), but
    for at most EMU_FLIPS elements a leaf, each within 1/8 of the leaf's
    update, and each one whose emulate cast input (the gradient times
    its APS scale, on some rank and micro-batch) lay within
    MIDPOINT_ULPS fp32 ulps of an e5m2 rounding boundary: an input that
    close casts to the neighbouring code in one package and not the
    other (ROADMAP Queue C).  That cast is the only one of values that
    are not already e5m2 codes times a power of 2, so a flip starts
    nowhere else.  Measured: RTNE one such element at step 0
    (blocks.0.wkv.kernel, 6 ulps from the boundary, 0.042 of its
    update; the next nearest input of any leaf 91 ulps), none at step
    1; SR none; every other element within 7.5e-9."""
    world, seq, n = 2, 16, 2
    ffn = dict(n_layers=1, ffn_exp=8, ffn_man=23)
    jm, params = _jax_params(seed=4, **ffn)
    start = _leaves(params)
    schedule = jsched.warmup_step_decay(0.05, 2, [8], warmup_from=0.02)
    tx = joptim.make_optimizer("sgd", schedule, momentum=0.9)
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    kw = dict(emulate_node=n, use_aps=True, grad_exp=5, grad_man=2,
              grad_rounding=rounding, grad_seed=3, quant_stats=True)
    jstate = JState(step=jnp.zeros([], jnp.int32), params=params,
                    batch_stats={}, opt_state=tx.init(params))
    jstate = _replicated(jstate, mesh)
    jstep = j_train_step(jm, tx, mesh, donate=False, **kw)
    inner = _torch_model(params, **ffn)
    tm = _FlaxOrder(inner, start)
    opt = sgd(warmup_step_decay(0.05, 2, [8], warmup_from=0.02),
              momentum=0.9)
    tstate = create_train_state(tm, opt)
    tstep = make_lm_train_step(tm, opt, LocalMesh(world, "cpu"), **kw)
    # each element's nearest approach to an e5m2 rounding boundary over
    # the emulate casts' fp32 inputs (the gradients times their APS
    # scale, every rank and micro-batch, every step so far): the only
    # casts of values that are not already e5m2 codes times a power of 2
    order = list(start)
    near = {k: np.full(v.shape, np.inf) for k, v in start.items()}
    reduce = tlm.emulate_node_reduce

    def recording(g, n, use_aps, grad_exp, grad_man, **kw):
        scales = temulate._scales(g, n, use_aps, grad_exp)
        for name, x, scale in zip(order, g, scales):
            ulps = _midpoint_ulps((x * scale).numpy(), grad_exp, grad_man)
            near[name] = np.minimum(near[name], ulps.min(axis=0))
        return reduce(g, n, use_aps, grad_exp, grad_man, **kw)

    monkeypatch.setattr(tlm, "emulate_node_reduce", recording)
    ds = JText(64, seq, 64, 1)
    rows = world * 2 * n
    for i in range(2):
        toks, tgts = ds.batch(np.arange(rows * i, rows * (i + 1)), seed=i)
        jstate, jm_ = jstep(jstate, jnp.asarray(toks), jnp.asarray(tgts))
        tstate, tm_ = tstep(tstate, toks, tgts)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm_["accuracy"]),
                                   float(jm_["accuracy"]), atol=1 / 64)
        prec = {k: float(v) for k, v in tm_.items() if k.startswith("prec_")}
        assert len(prec) == 5
        assert prec == {k: float(jm_[k]) for k in prec}, i
        assert prec["prec_wire_total"] == world * sum(
            v.size for v in start.values())
        want = _leaves(jstate.params)
        for name, p in inner.named_parameters():
            update = np.abs(want[name] - start[name]).max()
            assert update > 0, (i, name)
            diff = np.abs(p.detach().numpy() - want[name])
            flips = diff > WEIGHT_ATOL
            assert flips.sum() <= EMU_FLIPS, (i, name)
            assert (near[name][flips] <= MIDPOINT_ULPS).all(), (i, name)
            assert diff.max() <= update / 8, (i, name)
        # the next step starts from JAX's weights and momentum
        bufs = _leaves(jstate.opt_state.momentum_buf)
        with torch.no_grad():
            for name, p in inner.named_parameters():
                p.copy_(torch.tensor(want[name]))
            for name, b in zip(order, tstate.opt_state.momentum_buf):
                b.copy_(torch.tensor(bufs[name]))
        near = {k: np.full(v.shape, np.inf) for k, v in start.items()}
    assert tstate.step == 2


def test_lm_gradient_leaves_are_contiguous():
    """Every gradient leaf of the flash + quantized-FFN LM is contiguous:
    the reduce's casts on the card (K1, K3) take contiguous tensors."""
    from cpd_tpu_torch.train.lm import lm_local_gradients

    tm = torch_lm(**dict(TINY, n_layers=1), device="cpu").init_weights(
        torch.Generator().manual_seed(1))
    toks = torch.randint(0, 64, (2, 8), generator=torch.Generator())
    grads = lm_local_gradients(tm, toks, toks, LocalMesh(2, "cpu"))[0]
    assert all(g.is_contiguous() for leaves in grads for g in leaves)


def test_label_smoothing_is_the_dense_target_loss():
    """The closed form (1-a)·CE + a·(logsumexp − mean logit) == the CE
    against one_hot·(1-a) + a/V targets, through one step's metrics."""
    torch.manual_seed(0)
    kw = dict(attn_impl="xla", ffn_exp=8, ffn_man=23)
    tm = torch_lm(**dict(TINY, **kw), device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    toks = torch.randint(0, 64, (2, 12))
    tgts = torch.randint(0, 64, (2, 12))
    a = 0.1
    with torch.no_grad():
        logits = tm(toks)
    dense = torch.full(logits.shape, a / 64)
    dense += (1 - a) * torch.nn.functional.one_hot(tgts, 64)
    want = -(dense * torch.log_softmax(logits, -1)).sum(-1).mean()
    opt = sgd(lambda s: 0.0, momentum=0.9)
    step = make_lm_train_step(tm, opt, LocalMesh(1, "cpu"),
                              label_smoothing=a)
    _, m = step(create_train_state(tm, opt), toks, tgts)
    np.testing.assert_allclose(float(m["loss"]), float(want), rtol=1e-6)
    with pytest.raises(ValueError, match="label_smoothing"):
        make_lm_train_step(tm, opt, LocalMesh(1, "cpu"),
                           label_smoothing=1.0)
    with pytest.raises(ValueError, match="emulate_node"):
        make_lm_train_step(tm, opt, LocalMesh(1, "cpu"), emulate_node=0)
    step = make_lm_train_step(tm, opt, LocalMesh(1, "cpu"), emulate_node=3)
    with pytest.raises(ValueError, match="emulate_node=3"):
        step(create_train_state(tm, opt), toks, tgts)


def _mha_batch(seed=0, rows=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 64, (rows, MHA_SEQ)).astype(np.int32)
                 for _ in range(2))


def _jax_ce(jm, params, toks, tgts):
    """JAX's mean next-token CE, its fp32 logits and its gradients."""
    def loss(p):
        logits = jm.apply({"params": p}, toks, train=False)
        logp = jax.nn.log_softmax(logits, axis=-1)
        ce = -jnp.take_along_axis(logp, tgts[..., None], axis=-1).mean()
        return ce, logits
    (ce, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return float(ce), np.asarray(logits), _leaves(grads)


def _torch_ce(tm, toks, tgts):
    logits = tm(torch.from_numpy(toks).long())
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]),
        torch.from_numpy(tgts).long().reshape(-1))
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad(ce, list(params.values()))
    return ce.detach(), logits.detach(), dict(zip(params, grads))


def test_mha_flash_lm_logits_and_gradients_match_jax_xla():
    """bench.py's attention path in fp32: the MHA model through the plain
    K11 (forward and its own backward) against JAX's xla model from the
    same flax weights: every parameter's gradient of the mean CE and the
    CE to MHA_TOL, the logits to LOGIT_ATOL."""
    jm, params = _jax_params(base=MHA, attn_impl="xla")
    toks, tgts = _mha_batch()
    want_ce, want_logits, want = _jax_ce(jm, params, jnp.asarray(toks),
                                         jnp.asarray(tgts))
    tm = _torch_model(params, base=MHA)
    assert tm.blocks[0].attn_impl == "flash" and hasattr(tm.blocks[0],
                                                         "wqkv")
    ce, logits, got = _torch_ce(tm, toks, tgts)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(float(ce), want_ce, **MHA_TOL)
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name,
                                   **MHA_TOL)


# bench.py's GQA flash arm at the tiny width: 2 kv heads, the GQA flash
# kernels K9/K10 with their own backward
GQA_FLASH = dict(MHA, n_kv_heads=2, attn_impl="flash", flash_bwd="pallas")


@pytest.mark.parametrize("impl", ["xla", "flash", "chunked", "gqa-flash"])
def test_bf16_lm_logits_and_loss_match_jax_bf16(impl):
    """The bf16 model (fp32 parameters loaded unchanged from the flax
    tree) against JAX's bf16 xla model: logits within BF16_LOGIT_ATOL,
    the mean CE within BF16_LOSS_RTOL; the parameters stay fp32 and the
    logits come back fp32.  ``gqa-flash``: bench.py's GQA flash arm
    (GQA_FLASH: the plain K9/K10 here) against JAX's bf16 GQA flash model
    (its Pallas kernels in interpret mode)."""
    gqa = impl == "gqa-flash"
    base = GQA_FLASH if gqa else MHA
    jm, params = _jax_params(base=base, dtype=jnp.bfloat16,
                             attn_impl=base["attn_impl"] if gqa else "xla")
    toks, tgts = _mha_batch(seed=1)
    want_ce, want_logits, _ = _jax_ce(jm, params, jnp.asarray(toks),
                                      jnp.asarray(tgts))
    tm = _torch_model(params, base=base, dtype=torch.bfloat16,
                      attn_impl=base["attn_impl"] if gqa else impl)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    ce, logits, grads = _torch_ce(tm, toks, tgts)
    assert logits.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in grads.values())
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               rtol=0, atol=BF16_LOGIT_ATOL)
    np.testing.assert_allclose(float(ce), want_ce, rtol=BF16_LOSS_RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_gradients_bitwise_equal(dtype):
    """``remat=True`` recomputes each block in the backward: on the CPU
    every gradient is bitwise the one without it, and the bf16 remat
    model loads the same flax tree unchanged."""
    _, params = _jax_params(base=MHA, attn_impl="xla")
    toks, tgts = _mha_batch(seed=2)
    runs = [_torch_ce(_torch_model(params, base=MHA, dtype=dtype,
                                   remat=remat), toks, tgts)
            for remat in (False, True)]
    (ce_a, _, ga), (ce_b, _, gb) = runs
    assert torch.equal(ce_a, ce_b)
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name
    tm = _torch_model(params, base=MHA, dtype=dtype, remat=True)
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.detach().numpy(),
                                      _leaves(params)[name])


def test_two_bf16_aps_steps_match_jax():
    """bench.py's LM step at a tiny width: two steps of the bf16 MHA
    model (the port's flash + remat, JAX's xla) under the faithful APS
    e5m2 reduce at W = 2, SGD momentum 0.9 at a nonzero rate from step 0:
    losses within BF16_LOSS_RTOL, accuracies within one token in 32 of
    the 256 per rank."""
    world = 2
    jm, params = _jax_params(seed=3, base=MHA, attn_impl="xla", n_layers=1,
                             dtype=jnp.bfloat16)
    schedule = jsched.warmup_step_decay(0.05, 2, [8], warmup_from=0.02)
    tx = joptim.make_optimizer("sgd", schedule, momentum=0.9)
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    jstate = JState(step=jnp.zeros([], jnp.int32), params=params,
                    batch_stats={}, opt_state=tx.init(params))
    jstate = _replicated(jstate, mesh)
    jstep = j_train_step(jm, tx, mesh, use_aps=True, grad_exp=5, grad_man=2,
                         donate=False)
    tm = _torch_model(params, base=MHA, n_layers=1, dtype=torch.bfloat16,
                      remat=True)
    opt = sgd(warmup_step_decay(0.05, 2, [8], warmup_from=0.02),
              momentum=0.9)
    tstate = create_train_state(tm, opt)
    tstep = make_lm_train_step(tm, opt, LocalMesh(world, "cpu"),
                               use_aps=True, grad_exp=5, grad_man=2)
    for i in range(2):
        toks, tgts = _mha_batch(seed=10 + i, rows=2 * world)
        jstate, jm_ = jstep(jstate, jnp.asarray(toks), jnp.asarray(tgts))
        tstate, tm_ = tstep(tstate, toks, tgts)
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=BF16_LOSS_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(tm_["accuracy"]),
                                   float(jm_["accuracy"]), atol=1 / 32)
    assert tstate.step == 2


TINY_ARGV = ["--vocab-size", "64", "--d-model", "32", "--n-layers", "1",
             "--n-heads", "4", "--n-kv-heads", "2", "--seq-len", "16",
             "--batch-size", "2", "--dp", "2", "--attn-impl", "flash",
             "--flash-bwd", "pallas", "--ffn-exp", "4", "--ffn-man", "3",
             "--ffn-mode", "faithful", "--use_APS", "--grad_exp", "5",
             "--grad_man", "2", "--max-iter", "2", "--print-freq", "1"]


def test_cli_trains_two_tiny_iterations(capsys):
    assert tcli.main(TINY_ARGV, device="cpu") == 0
    out = capsys.readouterr().out
    assert "Iter: [2/2]" in out and "Val [2]" in out and "done: 2" in out
    res = tcli.run(tcli.parse_args(TINY_ARGV[:-4] + [
        "--max-iter", "1", "--lr-schedule", "cosine", "--warmup-iters", "0",
        "--mode", "ring", "--label-smoothing", "0.1"]), device="cpu")
    assert res["step"] == 1 and np.isfinite(res["loss"])


def test_cli_trains_bf16_mha_flash_remat(capsys):
    """bench.py's LM flags on the CLI at a tiny width: ``--bf16
    --attn-impl flash --remat`` without ``--n-kv-heads`` (K11), seq 128,
    two iterations; ``--flash-bwd pallas`` stays refused there, as the
    JAX CLI refuses it."""
    argv = ["--vocab-size", "64", "--d-model", "32", "--n-layers", "1",
            "--n-heads", "4", "--seq-len", str(MHA_SEQ), "--batch-size",
            "2", "--dp", "2", "--bf16", "--attn-impl", "flash", "--remat",
            "--use_APS", "--grad_exp", "5", "--grad_man", "2",
            "--max-iter", "2", "--print-freq", "1"]
    assert tcli.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert "Iter: [2/2]" in out and "Val [2]" in out and "done: 2" in out
    with pytest.raises(SystemExit, match="MHA flash path"):
        tcli.parse_args(argv + ["--flash-bwd", "pallas"])


@pytest.mark.parametrize("extra", [
    ["--sp", "2"], ["--tp", "2"], ["--pp", "2"], ["--moe"],
    ["--scan-layers"], ["--dropout", "0.1"], ["--sample", "4"],
    ["--save-path", "x"],
    ["--export-torch", "x.pth"], ["--verify-reduce"], ["--obs-dir", "d"],
    ["--overlap-reduce"]])
def test_cli_unported_flags_raise(extra):
    with pytest.raises(SystemExit, match="not yet ported"):
        tcli.parse_args(TINY_ARGV + extra)


@pytest.mark.parametrize("extra,opt_type", [
    (["--optimizer", "adamw"], "AdamW"),
    (["--emulate_node", "2", "--optimizer", "nesterov"], "SGD")])
def test_cli_trains_with_adamw_and_emulated_nodes(extra, opt_type,
                                                  monkeypatch):
    """The flags this slice ports, two tiny iterations each at an fp32
    FFN: ``--optimizer adamw`` (b1 = the CLI's momentum 0.9) and
    ``--emulate_node 2`` with Nesterov (the global batch ranks x
    batch-size x 2, validated on ranks x batch-size rows)."""
    from cpd_tpu_torch import train

    built = []
    real = train.make_optimizer
    monkeypatch.setattr(train, "make_optimizer", lambda *a, **kw: built.append(
        real(*a, **kw)) or built[-1])
    args = tcli.parse_args(TINY_ARGV + ["--ffn-exp", "8", "--ffn-man", "23"]
                           + extra)
    res = tcli.run(args, device="cpu")
    assert res["step"] == 2 and np.isfinite(res["loss"])
    assert np.isfinite(res["val"]["loss"])
    (opt,) = built
    assert type(opt).__name__ == opt_type
    assert opt_type != "AdamW" or opt.b1 == 0.9
    assert opt_type != "SGD" or opt.nesterov


def test_cli_trains_in_fast_mode(capsys):
    """``--mode fast`` (the fp32 rank sum between the APS casts) trains
    one tiny iteration at W = 2 on the CPU."""
    res = tcli.run(tcli.parse_args(TINY_ARGV[:-4] + [
        "--max-iter", "1", "--mode", "fast"]), device="cpu")
    assert res["step"] == 1 and np.isfinite(res["loss"])


def test_cli_refuses_what_the_jax_cli_refuses():
    for extra, match in ((["--attn-impl", "xla"], "flash-backward"),
                         (["--n-kv-heads", "3"], "divisible"),
                         (["--block-scale"], "--mode ring")):
        with pytest.raises(SystemExit, match=match):
            tcli.parse_args(TINY_ARGV + extra)
