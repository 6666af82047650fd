"""Sequence parallelism in the port vs the JAX package: the dp x sp mesh,
ring and Ulysses attention, the LM's sp axis and dropout, the LM step
and CLI over dp x sp, on the `LocalMesh` and the gloo `ProcessMesh`.

* `ring_attention` / `ulysses_attention` on a `LocalMesh` sp view against
  JAX's under `shard_map` on the virtual CPU devices: the outputs and the
  (q, k, v) gradients of a random cotangent within ATTN_TOL (JAX's own
  tolerance for its sharded-vs-local attention), causal and not, MHA and
  GQA at H_kv in {1, 2, 4} over 4 query heads, sp in {2, 4}: Ulysses
  expands K/V at H_kv % sp != 0;
* Ulysses with ``impl="flash"`` (the plain K9/K10 and K11 here) against
  its xla middle step at T = 256, within FLASH_TOL;
* the tiny LM's forward at dp 2 x sp 2 in both modes against JAX's
  sharded forward on the same flax weights (`interop.load_jax_params`),
  within LOGIT_ATOL;
* flax's dropout masks bitwise (`dropout_key` + `dropout`), the model
  with dropout against flax's, eval the identity, rate 1.0 refused;
* two train steps at dp 2 x sp 2 against JAX's `make_lm_train_step` on
  ``make_mesh(dp=2, sp=2)``: the ring mode with dropout and the (8, 23)
  reduce, and Ulysses with dropout at ``emulate_node`` 2 (losses to
  LOSS_RTOL, every leaf to WEIGHT_ATOL), and the APS e5m2 ring reduce
  held as `tests/test_torch_lm.py` holds its quantized case (each leaf
  within 1/8 of its update): Ulysses RTNE, the ring with dropout at
  ``emulate_node`` 2 under SR (the emulate key folds the dp index) and
  Ulysses under SR (the pre-quantize keys fold the dp view's ranks);
  the eval step;
* the CLI's ``--sp 2`` in both modes, ``--dropout``, its refusals;
* ``remat`` bitwise in both modes; the refusals of what is not ported;
* one spawn of 4 gloo processes (dp 2 x sp 2): ring and Ulysses
  attention outputs and gradients, two train steps in each mode and at
  ``emulate_node`` 2 with the SR verified ring, and the CLI under
  ``--dist`` in each mode, every one BITWISE the `LocalMesh`'s;
  `make_consensus_fns(mesh, "dp")` checks and resyncs over the dp view.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from cpd_tpu_torch.parallel.launch import spawn
from test_torch_threads import one_torch_thread  # noqa: F401

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
FLASH_TOL = dict(fwd=1e-5, grad=1e-4)
LOGIT_ATOL = 1e-4
LOSS_RTOL = 1e-6
WEIGHT_ATOL = 1e-6
SP_TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
               n_kv_heads=2, d_ff=64)
SEQ, ROWS = 16, 2          # tokens a sequence, rows a dp rank
DROPOUT = 0.1
SP_ARGV = ["--vocab-size", "64", "--d-model", "32", "--n-layers", "1",
           "--n-heads", "4", "--n-kv-heads", "2", "--seq-len", "16",
           "--batch-size", "2", "--sp", "2", "--use_APS", "--grad_exp",
           "5", "--grad_man", "2", "--mode", "ring", "--max-iter", "2",
           "--print-freq", "1", "--dropout", "0.1"]


def _qkv(seed: int, t: int, hkv: int, h: int = 4, d: int = 8, b: int = 2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    c = rng.standard_normal((b, t, h, d)).astype(np.float32)
    return q, k, v, c


def _torch_sp_blocks(mode: str, sp_view, q, k, v, c, causal: bool,
                     impl: str = "xla") -> list:
    """The port's sp attention on ``sp_view`` from full-sequence numpy
    inputs, each local rank of the view taking its T block: for each
    local rank its output and the (q, k, v) gradients of the sum over
    the ranks of sum(out * c)."""
    from cpd_tpu_torch.ops.attention import ring_attention, ulysses_attention

    w = sp_view.world
    split = [[torch.tensor(a).chunk(w, 1)[r].clone().requires_grad_(g)
              for r in sp_view.ranks] for a, g in ((q, True), (k, True),
                                                  (v, True), (c, False))]
    qs, ks, vs, cs = split
    if mode == "ring":
        outs = ring_attention(qs, ks, vs, sp_view, causal=causal)
    else:
        outs = ulysses_attention(qs, ks, vs, sp_view, causal=causal,
                                 impl=impl)
    loss = None
    for o, ci in zip(outs, cs):
        term = (o * ci).sum()
        loss = term if loss is None else loss + term
    n = len(qs)
    grads = torch.autograd.grad(loss, qs + ks + vs)
    return [[outs[i].detach().numpy()] + [grads[t * n + i].numpy()
                                          for t in range(3)]
            for i in range(n)]


def _torch_sp_attention(mode: str, sp_view, q, k, v, c, causal: bool,
                        impl: str = "xla"):
    """`_torch_sp_blocks` over every rank of a `LocalMesh` view, the
    output and the gradients concatenated back along T."""
    blocks = _torch_sp_blocks(mode, sp_view, q, k, v, c, causal, impl)
    cat = [np.concatenate([b[t] for b in blocks], 1) for t in range(4)]
    return cat[0], cat[1:]


def _jax_sp_attention(mode: str, sp: int, q, k, v, c, causal: bool):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cpd_tpu.compat import shard_map
    from cpd_tpu.ops.attention import ring_attention, ulysses_attention
    from cpd_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(sp=sp, dp=1, devices=jax.devices()[:sp])
    spec = P(None, "sp")
    attn = ring_attention if mode == "ring" else ulysses_attention

    def fwd(q, k, v):
        return shard_map(lambda a, b, d: attn(a, b, d, "sp", causal=causal),
                         mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                         check_vma=False)(q, k, v)

    def both(q, k, v, c):
        out, vjp = jax.vjp(fwd, q, k, v)
        return out, vjp(c)

    out, grads = jax.jit(both)(*map(jnp.asarray, (q, k, v, c)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_sp_attention_matches_jax(mode, sp, hkv):
    """Forward and (q, k, v) gradients, causal and not, within ATTN_TOL
    of JAX's under shard_map (hkv 4 is MHA; Ulysses expands K/V by the
    minimal factor where sp does not divide hkv)."""
    from cpd_tpu_torch.parallel.mesh import make_mesh

    view = make_mesh(1, sp, "cpu").axis("sp")
    for causal in (True, False):
        q, k, v, c = _qkv(10 * sp + hkv, 32, hkv)
        got, got_g = _torch_sp_attention(mode, view, q, k, v, c, causal)
        want, want_g = _jax_sp_attention(mode, sp, q, k, v, c, causal)
        np.testing.assert_allclose(got, want, **ATTN_TOL,
                                   err_msg=f"{mode} causal={causal}")
        for name, a, b in zip("qkv", got_g, want_g):
            np.testing.assert_allclose(a, b, **ATTN_TOL,
                                       err_msg=f"d{name} causal={causal}")


@pytest.mark.parametrize("hkv", [2, 1, 4])
def test_ulysses_flash_middle_step_matches_xla(hkv):
    """Ulysses with ``impl="flash"`` runs the gathered sequence through
    the flash path (K9/K10 at rep > 1, K11 at rep 1 after the split; their
    plain versions on the CPU) on contiguous (B, T, H/W, D) inputs:
    within FLASH_TOL of the xla middle step, forward and gradients."""
    from cpd_tpu_torch.ops import flash_gqa
    from cpd_tpu_torch.parallel.mesh import make_mesh

    view = make_mesh(1, 2, "cpu").axis("sp")
    q, k, v, c = _qkv(hkv, 256, hkv, b=1)
    calls = []
    real = flash_gqa.flash_gqa_fwd

    def spy(q_, *a, **kw):
        calls.append(q_.is_contiguous())
        return real(q_, *a, **kw)

    flash_gqa.flash_gqa_fwd = spy
    try:
        got, got_g = _torch_sp_attention("ulysses", view, q, k, v, c, True,
                                         impl="flash")
    finally:
        flash_gqa.flash_gqa_fwd = real
    want, want_g = _torch_sp_attention("ulysses", view, q, k, v, c, True)
    np.testing.assert_allclose(got, want, rtol=0, atol=FLASH_TOL["fwd"])
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=0, atol=FLASH_TOL["grad"])
    # 2 q heads a rank: rep 2 after the split (hkv 1 expanded to 2, or
    # 2) takes K9/K10 on contiguous inputs, rep 1 (hkv 4) K11
    assert calls == [] if hkv == 4 else (calls and all(calls))


def test_ring_chunked_and_degenerate_split():
    """``impl="chunked"`` folds sub-blocks (the largest divisor of
    T_local <= block) to the xla ring's output within ATTN_TOL, and a
    degenerate split raises, as the JAX ring does."""
    from cpd_tpu_torch.ops.attention import ring_attention
    from cpd_tpu_torch.parallel.mesh import make_mesh

    view = make_mesh(1, 2, "cpu").axis("sp")
    q, k, v, _ = _qkv(3, 48, 2)
    qs, ks, vs = ([torch.tensor(a).chunk(2, 1)[i] for i in range(2)]
                  for a in (q, k, v))
    want = ring_attention(qs, ks, vs, view)
    got = ring_attention(qs, ks, vs, view, impl="chunked", block=16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **ATTN_TOL)
    q, k, v, _ = _qkv(3, 2 * 521, 2, b=1)
    qs, ks, vs = ([torch.tensor(a).chunk(2, 1)[i] for i in range(2)]
                  for a in (q, k, v))
    with pytest.raises(ValueError, match="degenerate"):
        ring_attention(qs, ks, vs, view, impl="chunked")


def test_mesh_layout_and_axis_views():
    """Flat rank dp * sp + j (tp 1); the views' ranks are axis indices,
    their collectives stay within the groups, and the rotation/reindexing
    carry gradients to the sender."""
    from cpd_tpu_torch.parallel.mesh import LocalMesh, make_mesh

    mesh = make_mesh(2, 2, "cpu")
    assert mesh.world == 4 and mesh.axes == {"dp": 2, "sp": 2, "tp": 1}
    assert [tuple(mesh.coords(r).values()) for r in mesh.ranks] == [
        (0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    dp, sp = mesh.axis("dp"), mesh.axis("sp")
    assert dp.ranks == (0, 0, 1, 1) and dp.world == 2
    assert sp.ranks == (0, 1, 0, 1) and sp.world == 2
    xs = [torch.tensor([float(r)], requires_grad=True) for r in mesh.ranks]
    assert [float(x.detach()) for x in dp.sum(xs)] == [2.0, 4.0, 2.0, 4.0]
    assert [float(x.detach()) for x in sp.ring_shift(xs)] == [1.0, 0.0, 3.0, 2.0]
    shifted = sp.ring_shift(xs)
    shifted[0].sum().backward()
    assert [float(x.grad) if x.grad is not None else 0.0 for x in xs] == [
        0.0, 1.0, 0.0, 0.0]
    assert make_mesh(3, 1, "cpu").axis("dp").world == 3
    with pytest.raises(ValueError, match="whole groups"):
        mesh.axis("sp", [0, 2])
    with pytest.raises(ValueError, match="divide"):
        LocalMesh(4, "cpu", sp=3)


def _jax_params(seed=0, **kw):
    import jax
    import jax.numpy as jnp

    from cpd_tpu.models import transformer_lm as jax_lm

    model = jax_lm(**dict(SP_TINY, **kw))
    params = jax.jit(lambda k: model.init(k, jnp.zeros((1, 8), jnp.int32))
                     )(jax.random.PRNGKey(seed))["params"]
    return jax.device_get(params)


def _torch_model(params, **kw):
    from cpd_tpu_torch.interop import load_jax_params
    from cpd_tpu_torch.models import transformer_lm as torch_lm

    return load_jax_params(torch_lm(**dict(SP_TINY, **kw), device="cpu"),
                           params)


def _jax_mesh():
    import jax

    from cpd_tpu.parallel.mesh import make_mesh

    return make_mesh(dp=2, sp=2, devices=jax.devices()[:4])


def _tokens(seed: int, rows: int = 2 * ROWS, seq: int = SEQ):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, SP_TINY["vocab_size"], (rows, seq + 1))
    return x[:, :-1].astype(np.int32), x[:, 1:].astype(np.int32)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_lm_forward_dp2_sp2_matches_jax(mode):
    """The LM forward at dp 2 x sp 2 (each rank its (rows, T/2) block,
    RoPE offset by sp_index * T_local) against JAX's under shard_map on
    ``make_mesh(dp=2, sp=2)``, within LOGIT_ATOL."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cpd_tpu.compat import shard_map
    from cpd_tpu.models import transformer_lm as jax_lm
    from cpd_tpu_torch.parallel.mesh import make_mesh

    params = _jax_params(1)
    toks, _ = _tokens(5)
    jm = jax_lm(**SP_TINY, sp_axis="sp", sp_mode=mode)
    want = np.asarray(jax.jit(shard_map(
        lambda p, t: jm.apply({"params": p}, t, train=False),
        mesh=_jax_mesh(), in_specs=(P(), P("dp", "sp")),
        out_specs=P("dp", "sp"), check_vma=False))(params, jnp.asarray(toks)))
    tm = _torch_model(params, sp_axis="sp", sp_mode=mode).eval()
    mesh = make_mesh(2, 2, "cpu")
    t = torch.from_numpy(toks).long()
    got = np.zeros_like(want)
    with torch.no_grad():
        for d in range(2):
            group = [2 * d, 2 * d + 1]
            blocks = [t[d * ROWS:(d + 1) * ROWS, j * 8:(j + 1) * 8]
                      for j in range(2)]
            for j, lg in enumerate(tm.forward_sp(blocks,
                                                 mesh.axis("sp", group))):
                got[d * ROWS:(d + 1) * ROWS, j * 8:(j + 1) * 8] = lg.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


def test_dropout_masks_are_flax_bitwise():
    """`dropout_key` + `dropout` give flax's ``nn.Dropout`` output bit for
    bit (both dropout modules of a ``block{i}`` scope, on a ones input
    and on random values), the LM with dropout in training matches
    flax's forward with the same ``rngs`` within LOGIT_ATOL, eval is the
    identity and rate 1.0 is refused."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from cpd_tpu_torch.models.transformer import dropout, dropout_key

    class Blk(nn.Module):
        @nn.compact
        def __call__(self, x):
            return (nn.Dropout(DROPOUT, deterministic=False)(x),
                    nn.Dropout(DROPOUT, deterministic=False)(x))

    class Top(nn.Module):
        @nn.compact
        def __call__(self, x):
            return Blk(name="block3")(x)

    key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    tkey = tuple(int(w) for w in np.asarray(key))
    x = np.random.default_rng(0).standard_normal((3, 37, 32)).astype(
        np.float32)
    for inp in (np.ones_like(x), x):
        want = jax.jit(lambda a: Top().apply({}, a, rngs={"dropout": key}))(
            jnp.asarray(inp))
        for site, w in enumerate(want):
            got = dropout(torch.from_numpy(inp), DROPOUT,
                          dropout_key(tkey, 3, site))
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          np.asarray(w).view(np.uint32))
    from cpd_tpu.models import transformer_lm as jax_lm

    params = _jax_params(2)
    toks, _ = _tokens(3, rows=2)
    want = jax.jit(lambda p, t: jax_lm(**SP_TINY, dropout_rate=DROPOUT).apply(
        {"params": p}, t, train=True, rngs={"dropout": key}))(
        params, jnp.asarray(toks))
    tm = _torch_model(params, dropout_rate=DROPOUT).train()
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        got = tm(t, tkey)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_ATOL)
        assert not torch.equal(got, tm.eval()(t))
        assert torch.equal(tm.eval()(t, tkey), tm(t))
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        _torch_model(params, dropout_rate=1.0)


def _jax_step_run(mode, dropout_rate, fmt, reduce_mode, rows, steps,
                  emulate_node=1, **step_kw):
    """JAX's LM step on make_mesh(dp=2, sp=2) for ``steps`` steps from
    seed-4 flax weights: (params, start leaves, losses, leaves after each
    step, the last state, the model, the mesh).  ``step_kw``: more of the
    step's options (the SR rounding and seed)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cpd_tpu.models import transformer_lm as jax_lm
    from cpd_tpu.train import optim as joptim
    from cpd_tpu.train import schedules as jsched
    from cpd_tpu.train.lm import make_lm_train_step as j_train_step
    from cpd_tpu.train.state import TrainState as JState
    from cpd_tpu_torch.interop import _flatten, _state_key

    def leaves(p):
        return {_state_key(k): np.asarray(v)
                for k, v in _flatten(jax.device_get(p)).items()}

    params = _jax_params(4)
    mesh = _jax_mesh()
    jm = jax_lm(**SP_TINY, sp_axis="sp", sp_mode=mode,
                dropout_rate=dropout_rate)
    tx = joptim.make_optimizer("sgd", jsched.warmup_step_decay(
        0.05, 2, [8], warmup_from=0.02), momentum=0.9)
    state = jax.device_put(JState(step=jnp.zeros([], jnp.int32),
                                  params=params, batch_stats={},
                                  opt_state=tx.init(params)),
                           NamedSharding(mesh, P()))
    step = j_train_step(jm, tx, mesh, use_aps=fmt != (8, 23),
                        grad_exp=fmt[0], grad_man=fmt[1], mode=reduce_mode,
                        emulate_node=emulate_node, donate=False, **step_kw)
    losses, after = [], []
    for i in range(steps):
        toks, tgts = rows[i]
        state, m = step(state, jnp.asarray(toks), jnp.asarray(tgts))
        losses.append(float(m["loss"]))
        after.append(leaves(state.params))
    return params, leaves(params), losses, after, state, jm, mesh


def _torch_steps(tm, fmt, reduce_mode, batches, mesh, **step_kw):
    """Steps of the port's LM step on ``mesh`` for model ``tm``: the
    losses, the weights after each step, the state."""
    from cpd_tpu_torch.train import create_train_state, sgd
    from cpd_tpu_torch.train import warmup_step_decay
    from cpd_tpu_torch.train.lm import make_lm_train_step

    opt = sgd(warmup_step_decay(0.05, 2, [8], warmup_from=0.02),
              momentum=0.9)
    state = create_train_state(tm, opt)
    step = make_lm_train_step(tm, opt, mesh, use_aps=fmt != (8, 23),
                              grad_exp=fmt[0], grad_man=fmt[1],
                              mode=reduce_mode, **step_kw)
    losses, after = [], []
    for toks, tgts in batches:
        state, m = step(state, toks, tgts)
        losses.append(float(m["loss"]))
        after.append({k: p.detach().numpy().copy()
                      for k, p in tm.named_parameters()})
    return losses, after, state


class _FlaxOrder(torch.nn.Module):
    """The port's sp LM with its ``parameters()`` and
    ``named_parameters()`` in the flax tree's leaf order (the JAX
    step's): the SR streams fold the leaf index in, so the two steps draw
    the same bits only over the same leaf order."""

    def __init__(self, inner, order):
        super().__init__()
        self.inner = inner
        self.order = list(order)
        self.sp_axis, self.dropout_rate = inner.sp_axis, inner.dropout_rate

    def forward_sp(self, *args):
        return self.inner.forward_sp(*args)

    def named_parameters(self, *args, **kw):
        named = dict(self.inner.named_parameters())
        return iter([(n, named[n]) for n in self.order])

    def parameters(self, recurse=True):
        return iter([p for _, p in self.named_parameters()])


# arm -> sp mode, dropout rate, reduce format, reduce mode, emulate_node,
# gradient rounding
STEP_ARMS = {"ring-dropout-fp32": ("ring", DROPOUT, (8, 23), "faithful", 1,
                                   "nearest"),
             "ulysses-aps-e5m2": ("ulysses", 0.0, (5, 2), "ring", 1,
                                  "nearest"),
             "ulysses-emulate2-fp32": ("ulysses", DROPOUT, (8, 23),
                                       "faithful", 2, "nearest"),
             "ring-dropout-emulate2-sr-e5m2": ("ring", DROPOUT, (5, 2),
                                               "ring", 2, "stochastic"),
             "ulysses-sr-e5m2": ("ulysses", 0.0, (5, 2), "ring", 1,
                                 "stochastic")}


@pytest.mark.parametrize("arm", list(STEP_ARMS))
def test_lm_train_step_dp2_sp2_matches_jax(arm):
    """Two steps at dp 2 x sp 2 against JAX's step on the same mesh.  The
    fp32 arms (the faithful (8, 23) reduce; dropout 0.1; at
    ``emulate_node`` 2 the micro-batches' sp-summed gradients stacked and
    reduced on each rank, their dropout keys folding the micro index):
    losses within LOSS_RTOL relative, every leaf within WEIGHT_ATOL.  The
    arms with the APS e5m2 ring reduce (Ulysses; the ring with dropout
    at ``emulate_node`` 2 and SR, whose emulate key folds the dp index;
    Ulysses with SR, whose pre-quantize keys fold the dp view's ranks,
    a cast that is exact at ``emulate_node`` 2, where the emulate reduce
    already gives e5m2 codes; the SR arms' leaves in flax's order so the
    streams line up): step 0's loss within LOSS_RTOL, step
    1's within 5e-3, every leaf within 1/8 of its update (an e5m2 cast
    input within fp32 round-off of a rounding boundary flips in one
    package and not the other, tests/test_torch_lm.py)."""
    from cpd_tpu_torch.parallel.mesh import make_mesh

    mode, drop, fmt, red, n, rounding = STEP_ARMS[arm]
    sr = dict(grad_rounding=rounding, grad_seed=3) \
        if rounding == "stochastic" else {}
    batches = [_tokens(20 + i, rows=2 * ROWS * n) for i in range(2)]
    params, start, jl, jafter, jstate, jm, jmesh = _jax_step_run(
        mode, drop, fmt, red, batches, 2, n, **sr)
    tm = _torch_model(params, sp_axis="sp", sp_mode=mode, dropout_rate=drop)
    if sr:
        tm = _FlaxOrder(tm, start)
    tl, tafter, tstate = _torch_steps(tm, fmt, red, batches,
                                      make_mesh(2, 2, "cpu"),
                                      emulate_node=n, **sr)
    for i in range(2):
        rtol = LOSS_RTOL if (fmt == (8, 23) or i == 0) else 5e-3
        np.testing.assert_allclose(tl[i], jl[i], rtol=rtol, err_msg=str(i))
        for name, p in tafter[i].items():
            update = np.abs(jafter[i][name] - start[name]).max()
            assert update > 0, (i, name)
            tol = WEIGHT_ATOL if fmt == (8, 23) else update / 8
            np.testing.assert_allclose(p, jafter[i][name], rtol=0, atol=tol,
                                       err_msg=f"step {i} {name}")
    if arm == "ring-dropout-fp32":
        # the eval step over dp x sp (dropout off) after the two steps
        import jax.numpy as jnp

        from cpd_tpu.train.lm import make_lm_eval_step as j_eval_step
        from cpd_tpu_torch.train.lm import make_lm_eval_step

        toks, tgts = _tokens(40)
        want = j_eval_step(jm, jmesh)(jstate, jnp.asarray(toks),
                                      jnp.asarray(tgts))
        got = make_lm_eval_step(tm, make_mesh(2, 2, "cpu"))(tstate, toks,
                                                           tgts)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-5)


def test_remat_sp_gradients_bitwise():
    """``remat=True`` recomputes each layer of the ranks' joint forward
    in the backward pass: the sp-summed gradients are bitwise those
    without it, in both modes."""
    from cpd_tpu_torch.parallel.mesh import make_mesh
    from cpd_tpu_torch.train.lm import as_tokens, lm_sp_gradients

    params = _jax_params(6)
    toks, tgts = as_tokens(*_tokens(8), "cpu")
    for mode in ("ring", "ulysses"):
        got = [lm_sp_gradients(_torch_model(params, sp_axis="sp",
                                            sp_mode=mode, remat=remat),
                               toks, tgts, make_mesh(2, 2, "cpu"))[0]
               for remat in (False, True)]
        for a, b in zip(got[0][0], got[1][0]):
            assert torch.equal(a, b), mode


def test_step_refuses_what_is_not_ported():
    """``overlap_reduce`` at sp > 1 and at tp > 1 raises "not yet ported"
    with its ROADMAP row; an sp mesh needs an sp model; the model refuses
    ring + flash and an unknown sp_mode, as JAX's."""
    from cpd_tpu_torch.models import transformer_lm as torch_lm
    from cpd_tpu_torch.parallel.mesh import make_mesh
    from cpd_tpu_torch.train import sgd
    from cpd_tpu_torch.train.lm import make_lm_train_step

    mesh = make_mesh(1, 2, "cpu")
    m = torch_lm(**SP_TINY, device="cpu", sp_axis="sp")
    opt = sgd(lambda s: 0.1)
    with pytest.raises(NotImplementedError, match="Queue A, row 2"):
        make_lm_train_step(m, opt, mesh, overlap_reduce=True)
    with pytest.raises(ValueError, match="sp_axis"):
        make_lm_train_step(torch_lm(**SP_TINY, device="cpu"), opt, mesh)
    with pytest.raises(NotImplementedError, match="row 2"):
        make_lm_train_step(torch_lm(**SP_TINY, device="cpu", tp_axis="tp"),
                           opt, make_mesh(1, 1, "cpu", tp=2),
                           overlap_reduce=True)
    with pytest.raises(ValueError, match="ulysses"):
        torch_lm(**SP_TINY, device="cpu", sp_axis="sp", attn_impl="flash")
    with pytest.raises(ValueError, match="sp_mode"):
        torch_lm(**SP_TINY, device="cpu", sp_mode="tree")


def _cli(argv, device="cpu"):
    from cpd_tpu_torch.examples.lm import train as cli

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        res = cli.run(cli.parse_args(argv), device=device)
    # the loss lines without their host-clock tokens/s
    return res, [ln.split(" TokPerSec")[0] for ln in
                 text.getvalue().splitlines()
                 if ln.startswith(("Iter", "Val"))]


def test_cli_sp_flags_and_refusals():
    """``--sp`` and ``--sp-mode`` parse with JAX's checks (seq-len % sp,
    Ulysses' heads rule, ring + flash), and ``--pp`` still raises "not
    yet ported" naming its row."""
    from cpd_tpu_torch.examples.lm import train as cli

    args = cli.parse_args(SP_ARGV + ["--sp-mode", "ulysses"])
    assert (args.sp, args.sp_mode, args.dropout) == (2, "ulysses", DROPOUT)
    for extra, match in ((["--seq-len", "15"], "divisible by sp"),
                         (["--sp", "3", "--seq-len", "18", "--sp-mode",
                           "ulysses"], "divisible by --sp"),
                         (["--attn-impl", "flash"], "does not compose"),
                         (["--pp", "2"], "Queue A row 4"),
                         (["--dropout", "1.0"], r"\[0, 1\)")):
        with pytest.raises(SystemExit, match=match):
            cli.parse_args(SP_ARGV + extra)


def _rank_work(local_refs: bool = False) -> dict:
    """One process of the spawn (or, with ``local_refs``, the parent's
    `LocalMesh` reference of the same work): dp 2 x sp 2."""
    import os

    from cpd_tpu_torch.parallel.dist import dist_init
    from cpd_tpu_torch.parallel.integrity import make_consensus_fns
    from cpd_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    out = {}
    if local_refs:
        mesh = make_mesh(2, 2, "cpu")
        rank = None
    else:
        dist_init("gloo")
        rank = int(os.environ["RANK"])
        mesh = make_mesh(None, 2, "cpu")
    # attention: each dp group its own inputs, its sp view
    for mode in ("ring", "ulysses"):
        for d in range(2):
            if rank is not None and mesh.coords(rank)["dp"] != d:
                continue
            view = (mesh.axis("sp", [2 * d, 2 * d + 1]) if local_refs
                    else mesh.axis("sp"))
            q, k, v, c = _qkv(100 + d, 32, 2)
            out[f"attn-{mode}-{d}"] = _torch_sp_blocks(mode, view, q, k, v,
                                                       c, True)
    batches = [_tokens(20 + i) for i in range(2)]
    from cpd_tpu_torch.models import transformer_lm as torch_lm
    from cpd_tpu_torch.parallel.dist import local_rows

    for mode in ("ring", "ulysses"):
        fed = [(local_rows(t, mesh), local_rows(g, mesh))
               for t, g in batches]
        tm = torch_lm(**SP_TINY, device="cpu", sp_axis="sp", sp_mode=mode,
                      dropout_rate=DROPOUT if mode == "ring" else 0.0)
        tm.init_weights(torch.Generator().manual_seed(4))
        losses, after, _ = _torch_steps(tm, (5, 2), "ring", fed, mesh)
        out[f"step-{mode}"] = (losses, after[-1])
    # emulate_node 2, the SR verified ring with the health counters
    fed = [(local_rows(t, mesh), local_rows(g, mesh))
           for t, g in (_tokens(30 + i, rows=2 * ROWS * 2) for i in range(2))]
    tm = torch_lm(**SP_TINY, device="cpu", sp_axis="sp", sp_mode="ulysses",
                  dropout_rate=DROPOUT)
    tm.init_weights(torch.Generator().manual_seed(5))
    from cpd_tpu_torch.train import create_train_state, sgd
    from cpd_tpu_torch.train.lm import make_lm_train_step

    opt = sgd(lambda s: 0.05, momentum=0.9)
    state = create_train_state(tm, opt)
    step = make_lm_train_step(tm, opt, mesh, emulate_node=2, use_aps=True,
                              grad_exp=5, grad_man=2, mode="ring",
                              grad_rounding="stochastic", grad_seed=3,
                              verify_reduce=True, quant_stats=True)
    metrics = []
    for toks, tgts in fed:
        state, m = step(state, toks, tgts)
        metrics.append({k: float(v) for k, v in m.items()})
    out["step-emulate-sr-verify"] = (metrics, {
        k: p.detach().numpy().copy() for k, p in tm.named_parameters()})
    for mode in ("ring", "ulysses"):
        argv = SP_ARGV + ["--sp-mode", mode]
        argv += ["--dist", "--dist-backend", "gloo"] if not local_refs \
            else ["--dp", "2"]
        res, lines = _cli(argv)
        out[f"cli-{mode}"] = (res["loss"], res["val"], lines)
    if not local_refs:
        from cpd_tpu_torch.models import transformer_lm as torch_lm

        m = torch_lm(**SP_TINY, device="cpu").init_weights(
            torch.Generator().manual_seed(0))
        check, resync = make_consensus_fns(mesh, "dp")
        agree = [int(check(m))]
        if rank == 2:
            with torch.no_grad():
                m.blocks[0].wo.kernel.add_(1.0)
        agree.append(int(check(m)))
        resync(m)
        agree.append(int(check(m)))
        out["consensus"] = (agree, m.blocks[0].wo.kernel.detach().numpy()
                            .copy())
    return out


@pytest.fixture(scope="module")
def spawned():
    ranks = spawn(_rank_work, 4, timeout=300.0)
    return ranks, _rank_work(local_refs=True)


def _bitwise(a, b, what):
    np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                  np.asarray(b).view(np.uint32),
                                  err_msg=what)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_process_mesh_attention_bitwise_local(spawned, mode):
    """On the 4-process gloo mesh each dp group's sp ranks give the
    `LocalMesh` sp view's outputs and (q, k, v) gradients bit for bit
    (their T blocks)."""
    ranks, local = spawned
    for r, got in enumerate(ranks):
        d, j = divmod(r, 2)
        (mine,) = got[f"attn-{mode}-{d}"]
        for a, b in zip(mine, local[f"attn-{mode}-{d}"][j]):
            _bitwise(a, b, f"rank {r} {mode}")


@pytest.mark.parametrize("arm", ["ring", "ulysses", "emulate-sr-verify"])
def test_process_mesh_steps_bitwise_local(spawned, arm):
    """Two APS e5m2 ring-reduce steps at dp 2 x sp 2 (dropout in the ring
    arm; the third arm Ulysses with dropout at ``emulate_node`` 2, the SR
    ring verified, the health counters): every process's losses (metrics)
    and weights bitwise the `LocalMesh` step's on the global batches, the
    verified ring clean."""
    ranks, local = spawned
    losses, after = local[f"step-{arm}"]
    for r, got in enumerate(ranks):
        assert got[f"step-{arm}"][0] == losses, r
        for name, w in after.items():
            _bitwise(got[f"step-{arm}"][1][name], w, f"rank {r} {name}")
    if arm == "emulate-sr-verify":
        assert all(m["reduce_ok"] == 1.0 and m["prec_wire_total"] > 0
                   for m in losses)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_cli_dist_sp_bitwise_local(spawned, mode):
    """Two CLI iterations with ``--sp 2 --dropout 0.1`` in each mode:
    under ``--dist`` on the 4 gloo processes (dp 2 x sp 2) rank 0's loss
    lines, the last loss and the validation equal ``--dp 2 --sp 2`` on one
    process, and the other ranks print nothing."""
    ranks, local = spawned
    loss, val, lines = local[f"cli-{mode}"]
    assert np.isfinite(loss) and len(lines) == 3
    assert ranks[0][f"cli-{mode}"] == (loss, val, lines)
    for got in ranks[1:]:
        assert got[f"cli-{mode}"][:2] == (loss, val)
        assert got[f"cli-{mode}"][2] == []


def test_consensus_over_the_dp_view(spawned):
    """`make_consensus_fns(mesh, "dp")` at dp 2 x sp 2: all agree, a
    perturbed copy on rank 2 (dp 1, sp 0) shows in the dp group of sp
    index 0 only, and the resync restores rank 0's bytes there."""
    ranks, _ = spawned
    agree = [rk["consensus"][0] for rk in ranks]
    assert agree == [[1, 0, 1], [1, 1, 1], [1, 0, 1], [1, 1, 1]]
    for rk in ranks[1:]:
        _bitwise(rk["consensus"][1], ranks[0]["consensus"][1], "resync")
