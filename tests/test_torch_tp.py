"""Tensor parallelism and scanned layers in the port vs the JAX package:
the dp x sp x tp mesh, the Megatron shard rules, the sharded blocks and
their tp sum, the LM step's sp/tp reduce, the scanned layout and the
LM CLI's ``--tp``/``--scan-layers``, on the `LocalMesh` and the gloo
`ProcessMesh`.

* the mesh's flat order equals JAX's ``make_mesh(dp=2, sp=2, tp=2)``
  device order; the tp view's ``psum`` sums forward and sums the
  cotangents backward (JAX's transpose of ``psum``);
* the port's shard kinds equal JAX's ``lm_param_specs`` on the unrolled
  and the scanned layout, MHA and GQA, and `interop.tp_shard_params`
  gives each tp rank the local block shard_map hands it;
* the tiny LM's forward at dp 2 x sp 2 x tp 2 (ring and Ulysses) within
  LOGIT_ATOL of JAX's sharded forward;
* the sharded gradients (the sp sum, the tp sum of replicated leaves,
  the fp32 dp sum, the shards put back) within GRAD_TOL of the
  single-device port's and of JAX's (`tests/test_attention_lm.py`'s
  contract);
* two-step arms of the LM step at dp 2 x sp 2 x tp 2 against JAX's on
  the same mesh: fp32 (losses LOSS_RTOL, leaves WEIGHT_ATOL), APS e5m2
  SR ring with dropout 0.5 at ``emulate_node`` 2 and the e4m3 faithful
  FFN (each leaf within 1/8 of its update, as `tests/test_torch_sp.py`
  and `tests/test_torch_lm.py` hold their quantized arms), scanned
  layers with remat and dropout (fp32);
* the scanned model bitwise the unrolled one on the same weights, its
  dropout masks bitwise flax's ``nn.scan`` masks;
* tp 2 against tp 1 in the port; the refusals;
* one spawn of 4 gloo processes (dp 1 x sp 2 x tp 2): the forward,
  three step arms and the CLI under ``--dist --tp 2 --scan-layers``
  bitwise the `LocalMesh`'s, the tp bytes a step the shapes', and the
  forward and the fp32 arm within tolerance of tp = 1;
* on the card: K8 at tp-local shapes against its plain version.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from cpd_tpu_torch.parallel.launch import spawn
from test_torch_threads import one_torch_thread  # noqa: F401

LOGIT_ATOL = 1e-4
GRAD_TOL = dict(rtol=2e-5, atol=1e-6)
LOSS_RTOL = 1e-6
WEIGHT_ATOL = 1e-6
TP_TINY = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
               n_kv_heads=2, d_ff=64)
SEQ, ROWS = 16, 2          # tokens a sequence, rows a dp rank
DROPOUT = 0.5
TP_ARGV = ["--vocab-size", "64", "--d-model", "32", "--n-layers", "2",
           "--n-heads", "4", "--n-kv-heads", "2", "--seq-len", "16",
           "--batch-size", "2", "--sp", "2", "--tp", "2", "--use_APS",
           "--grad_exp", "5", "--grad_man", "2", "--mode", "ring",
           "--max-iter", "2", "--print-freq", "1", "--dropout", "0.1",
           "--scan-layers", "--remat"]


def _jax_params(seed=0, scan=False, **kw):
    import jax
    import jax.numpy as jnp

    from cpd_tpu.models import transformer_lm as jax_lm

    model = jax_lm(**dict(TP_TINY, **kw), scan_layers=scan)
    params = jax.jit(lambda k: model.init(k, jnp.zeros((1, 8), jnp.int32))
                     )(jax.random.PRNGKey(seed))["params"]
    return jax.device_get(params)


def _torch_model(params, **kw):
    from cpd_tpu_torch.interop import load_jax_params
    from cpd_tpu_torch.models import transformer_lm as torch_lm

    return load_jax_params(torch_lm(**dict(TP_TINY, **kw), device="cpu"),
                           params)


def _jax_mesh():
    import jax

    from cpd_tpu.parallel.mesh import make_mesh

    return make_mesh(dp=2, sp=2, tp=2, devices=jax.devices()[:8])


def _tokens(seed: int, rows: int = 2 * ROWS, seq: int = SEQ):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, TP_TINY["vocab_size"], (rows, seq + 1))
    return x[:, :-1].astype(np.int32), x[:, 1:].astype(np.int32)


def _port_names(tree) -> dict:
    """A flax tree (params, specs or gradients) by the port's names."""
    from cpd_tpu_torch.interop import _flatten, _state_key

    return {_state_key(k): v for k, v in _flatten(tree).items()}


def _bitwise(a, b, what):
    np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                  np.asarray(b).view(np.uint32),
                                  err_msg=what)


def test_mesh_layout_matches_jax_and_psum_transposes():
    """Flat rank (i * sp + j) * tp + k is device (i, j, k) of JAX's
    ``make_mesh(dp=2, sp=2, tp=2)``; the views' ranks are axis indices;
    the tp view's ``psum`` gives each rank its group's sum and each
    rank's input the sum of the group's cotangents."""
    import jax

    from cpd_tpu_torch.parallel.mesh import LocalMesh, make_mesh

    ids = np.vectorize(lambda d: d.id)(_jax_mesh().devices)
    mesh = make_mesh(2, 2, "cpu", tp=2)
    assert mesh.world == 8 and mesh.axes == {"dp": 2, "sp": 2, "tp": 2}
    for f in mesh.ranks:
        c = mesh.coords(f)
        assert ids[c["dp"], 0, c["sp"], 0, c["tp"]] == jax.devices()[f].id
    assert mesh.axis("tp").ranks == (0, 1) * 4
    assert mesh.axis("sp").ranks == (0, 0, 1, 1) * 2
    assert mesh.axis("dp").ranks == (0,) * 4 + (1,) * 4
    xs = [torch.tensor([float(r + 1)], requires_grad=True)
          for r in mesh.ranks]
    out = mesh.axis("tp").psum(xs)
    assert [float(o.detach()) for o in out] == [3, 3, 7, 7, 11, 11, 15, 15]
    sum((o * (i + 1)).sum() for i, o in enumerate(out)).backward()
    assert [float(x.grad) for x in xs] == [3, 3, 7, 7, 11, 11, 15, 15]
    with pytest.raises(ValueError, match="divide"):
        LocalMesh(4, "cpu", sp=2, tp=3)


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("kv", [2, None])
def test_shard_kinds_match_jax_lm_param_specs(scan, kv):
    """`lm_param_specs` of the port's parameters: the dim JAX's
    ``lm_param_specs`` puts on tp (the last for col, the second-to-last
    for row, rank-aware on the stacked layout), None where it
    replicates."""
    from cpd_tpu.models.transformer import lm_param_specs as jax_specs
    from cpd_tpu_torch.models.transformer import lm_param_specs

    params = _jax_params(0, scan, n_kv_heads=kv)
    want = _port_names(jax_specs(params))
    tm = _torch_model(params, n_kv_heads=kv, scan_layers=scan)
    got = lm_param_specs(tm.named_parameters())
    assert set(got) == set(want)
    for name, p in tm.named_parameters():
        dim = next((i for i, a in enumerate(want[name]) if a == "tp"), None)
        kind, gdim = got[name]
        assert gdim == dim, name
        assert kind == {None: None, p.dim() - 1: "col",
                        p.dim() - 2: "row"}[dim], name
    # wq, wkv (or wqkv), wo, wi and wo_mlp a layer
    assert sum(k is not None for k, _ in got.values()) == (
        5 if kv else 4) * (1 if scan else TP_TINY["n_layers"])


def test_tp_shards_equal_shard_map_blocks():
    """`interop.tp_shard_params` of a flax tree at tp index k is, leaf
    by leaf, the local block JAX's ``lm_param_specs`` placement hands
    every device at tp index k (unrolled and scanned), and loaded into a
    ``tp_size=2`` model it equals `TransformerLM.load_shard` of the full
    model."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cpd_tpu.models.transformer import lm_param_specs as jax_specs
    from cpd_tpu_torch.interop import load_jax_params, tp_shard_params
    from cpd_tpu_torch.models import transformer_lm as torch_lm

    mesh = _jax_mesh()
    for scan in (False, True):
        params = _jax_params(1, scan)
        placed = jax.device_put(params, jax.tree.map(
            lambda s: NamedSharding(mesh, s), jax_specs(params),
            is_leaf=lambda x: isinstance(x, P)))
        full = _torch_model(params, scan_layers=scan)
        for k in range(2):
            mine = tp_shard_params(params, k, 2)
            flat = _port_names(mine)
            for name, leaf in _port_names(placed).items():
                for shard in leaf.addressable_shards:
                    if shard.device.id % 2 == k:
                        _bitwise(shard.data, flat[name], f"{name} tp{k}")
            a = load_jax_params(torch_lm(**TP_TINY, device="cpu",
                                         scan_layers=scan, tp_axis="tp",
                                         tp_size=2), mine)
            b = torch_lm(**TP_TINY, device="cpu", scan_layers=scan,
                         tp_axis="tp", tp_size=2).load_shard(full, k)
            for (n, x), (_, y) in zip(a.named_parameters(),
                                      b.named_parameters()):
                assert torch.equal(x, y), n


def _local_forward(tm, toks, mesh):
    """Each dp index's group forward on the `LocalMesh`: the logits of
    tp index 0 put back at their (rows, columns), and whether every tp
    rank's logits equal tp index 0's bitwise."""
    dp, sp, tp = (mesh.axes[a] for a in ("dp", "sp", "tp"))
    rows, t_local = toks.shape[0] // dp, toks.shape[1] // sp
    t = torch.as_tensor(toks).long()
    got = np.zeros(toks.shape + (TP_TINY["vocab_size"],), np.float32)
    same = True
    for d in range(dp):
        group = list(range(d * sp * tp, (d + 1) * sp * tp))
        blocks = [t[d * rows:(d + 1) * rows,
                    mesh.coords(p)["sp"] * t_local:
                    (mesh.coords(p)["sp"] + 1) * t_local] for p in group]
        outs = tm.forward_sp(blocks, mesh.axis("sp", group), None, None,
                             mesh.axis("tp", group))
        for p, lg in zip(group, outs):
            c = mesh.coords(p)
            if c["tp"] == 0:
                got[d * rows:(d + 1) * rows,
                    c["sp"] * t_local:(c["sp"] + 1) * t_local] = lg.numpy()
            same = same and torch.equal(lg, outs[group.index(
                p - c["tp"])])
    return got, same


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_lm_forward_dp2_sp2_tp2_matches_jax(mode):
    """The LM forward at dp 2 x sp 2 x tp 2 (each rank its block and its
    shards; the attention and MLP projections summed over tp) against
    JAX's under shard_map with ``lm_param_specs``, within LOGIT_ATOL;
    the tp ranks of a block give the same logits bit for bit."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cpd_tpu.compat import shard_map
    from cpd_tpu.models import transformer_lm as jax_lm
    from cpd_tpu.models.transformer import lm_param_specs as jax_specs
    from cpd_tpu_torch.parallel.mesh import make_mesh

    params = _jax_params(1)
    toks, _ = _tokens(5)
    jm = jax_lm(**TP_TINY, sp_axis="sp", sp_mode=mode, tp_axis="tp",
                tp_size=2)
    want = np.asarray(jax.jit(shard_map(
        lambda p, t: jm.apply({"params": p}, t, train=False),
        mesh=_jax_mesh(), in_specs=(jax_specs(params), P("dp", "sp")),
        out_specs=P("dp", "sp"), check_vma=False))(params, jnp.asarray(toks)))
    tm = _torch_model(params, sp_axis="sp", sp_mode=mode,
                      tp_axis="tp").eval()
    with torch.no_grad():
        got, same = _local_forward(tm, toks, make_mesh(2, 2, "cpu", tp=2))
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    assert same


def _shards_whole(grads, mesh, names, specs) -> list:
    """The dp-summed (rank order) whole gradient of every leaf from the
    per-rank local trees of `lm_sp_gradients`."""
    dp, sp, tp = (mesh.axes[a] for a in ("dp", "sp", "tp"))
    out = []
    for i, n in enumerate(names):
        total = None
        for d in range(dp):
            parts = [grads[(d * sp) * tp + k][i] for k in range(tp)]
            dim = specs[n][1]
            whole = parts[0] if dim is None else torch.cat(parts, dim)
            total = whole if total is None else total + whole
        out.append(total)
    return out


def test_sharded_grads_match_single_device_and_jax():
    """The dp 2 x sp 2 x tp 2 gradients of the global-mean CE (the sp
    sum, the replicated leaves' tp sum, an fp32 dp sum, the shards put
    back) within GRAD_TOL of the single-device port's and of JAX's
    sharded gradients (`test_lm_sharded_grads_match_single_device`),
    every leaf, sharded and replicated alike."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from cpd_tpu.compat import shard_map
    from cpd_tpu.models import transformer_lm as jax_lm
    from cpd_tpu.models.transformer import lm_param_specs as jax_specs
    from cpd_tpu_torch.models.transformer import lm_param_specs
    from cpd_tpu_torch.parallel.mesh import make_mesh
    from cpd_tpu_torch.train.lm import (as_tokens, lm_local_gradients,
                                        lm_sp_gradients)

    params = _jax_params(5)
    toks, tgts = _tokens(7)
    sh = jax_lm(**TP_TINY, tp_axis="tp", sp_axis="sp", tp_size=2)
    specs = jax_specs(params)

    def sharded_grads(p, tk, tg):
        def loss_of(p):
            logits = sh.apply({"params": p}, tk)
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, tg)
            n = lax.psum(jnp.float32(ce.size), ("dp", "sp", "tp"))
            return ce.sum() / n

        def reduce(g, spec):
            g = lax.psum(g, "sp")
            if spec == P():
                g = lax.psum(g, "tp")
            return lax.psum(g, "dp")

        return jax.tree.map(reduce, jax.grad(loss_of)(p), specs)

    g_sh = _port_names(jax.device_get(jax.jit(shard_map(
        sharded_grads, mesh=_jax_mesh(),
        in_specs=(specs, P("dp", "sp"), P("dp", "sp")), out_specs=specs,
        check_vma=False))(params, jnp.asarray(toks), jnp.asarray(tgts))))
    tm = _torch_model(params, sp_axis="sp", tp_axis="tp")
    names = [n for n, _ in tm.named_parameters()]
    mesh = make_mesh(2, 2, "cpu", tp=2)
    tk, tg = as_tokens(toks, tgts, "cpu")
    grads, _, _ = lm_sp_gradients(tm, tk, tg, mesh)
    got = _shards_whole(grads, mesh, names,
                        lm_param_specs(tm.named_parameters()))
    one = lm_local_gradients(tm, tk, tg, make_mesh(1, 1, "cpu"))[0][0]
    for n, g, ref in zip(names, got, one):
        np.testing.assert_allclose(g.numpy(), ref.numpy(), **GRAD_TOL,
                                   err_msg=f"single device {n}")
        np.testing.assert_allclose(g.numpy(), g_sh[n], **GRAD_TOL,
                                   err_msg=f"JAX {n}")


class _FlaxOrder(torch.nn.Module):
    """The port's LM with its ``parameters()`` and ``named_parameters()``
    in the flax tree's leaf order (the JAX step's): the SR streams fold
    the leaf index in, so the two steps draw the same bits only over the
    same leaf order."""

    def __init__(self, inner, order):
        super().__init__()
        self.inner = inner
        self.order = list(order)
        for a in ("sp_axis", "tp_axis", "tp_size", "dropout_rate"):
            setattr(self, a, getattr(inner, a))

    def forward_sp(self, *args):
        return self.inner.forward_sp(*args)

    def named_parameters(self, *args, **kw):
        named = dict(self.inner.named_parameters())
        return iter([(n, named[n]) for n in self.order])

    def parameters(self, recurse=True):
        return iter([p for _, p in self.named_parameters()])


# arm -> the model's options, the reduce format, the reduce mode,
# emulate_node, the gradient rounding
STEP_ARMS = {
    "ring-fp32": (dict(sp_mode="ring"), (8, 23), "faithful", 1, "nearest"),
    "ring-aps-e5m2-sr-dropout-emulate2": (
        dict(sp_mode="ring", dropout_rate=DROPOUT), (5, 2), "ring", 2,
        "stochastic"),
    "ulysses-e4m3-ffn": (
        dict(sp_mode="ulysses", ffn_exp=4, ffn_man=3), (8, 23), "faithful",
        1, "nearest"),
    "scan-remat-dropout-fp32": (
        dict(sp_mode="ring", scan_layers=True, remat=True,
             dropout_rate=DROPOUT), (8, 23), "faithful", 1, "nearest"),
}


def _jax_steps(model_kw, fmt, reduce_mode, batches, emulate_node,
               **step_kw):
    """JAX's LM step on make_mesh(dp=2, sp=2, tp=2) for two steps from
    seed-4 flax weights, the state placed by ``lm_state_specs`` (both
    steps one compile): (params, start leaves, losses, leaves after each
    step)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cpd_tpu.models import transformer_lm as jax_lm
    from cpd_tpu.train import optim as joptim
    from cpd_tpu.train import schedules as jsched
    from cpd_tpu.train.lm import lm_state_specs
    from cpd_tpu.train.lm import make_lm_train_step as j_train_step
    from cpd_tpu.train.state import TrainState as JState

    def leaves(p):
        return {k: np.asarray(v) for k, v in
                _port_names(jax.device_get(p)).items()}

    params = _jax_params(4, model_kw.get("scan_layers", False))
    mesh = _jax_mesh()
    jm = jax_lm(**TP_TINY, sp_axis="sp", tp_axis="tp", tp_size=2,
                **model_kw)
    tx = joptim.make_optimizer("sgd", jsched.warmup_step_decay(
        0.05, 2, [8], warmup_from=0.02), momentum=0.9)
    state = JState(step=jnp.zeros([], jnp.int32), params=params,
                   batch_stats={}, opt_state=tx.init(params))
    state = jax.device_put(state, jax.tree.map(
        lambda s: NamedSharding(mesh, s), lm_state_specs(state),
        is_leaf=lambda x: isinstance(x, P)))
    step = j_train_step(jm, tx, mesh, use_aps=fmt != (8, 23),
                        grad_exp=fmt[0], grad_man=fmt[1], mode=reduce_mode,
                        emulate_node=emulate_node, donate=False, **step_kw)
    losses, after = [], []
    for toks, tgts in batches:
        state, m = step(state, jnp.asarray(toks), jnp.asarray(tgts))
        losses.append(float(m["loss"]))
        after.append(leaves(state.params))
    return params, leaves(params), losses, after


def _torch_steps(tm, fmt, reduce_mode, batches, mesh, **step_kw):
    """Steps of the port's LM step on ``mesh`` for model ``tm``: the
    losses, the weights after each step, the metrics."""
    from cpd_tpu_torch.train import create_train_state, sgd
    from cpd_tpu_torch.train import warmup_step_decay
    from cpd_tpu_torch.train.lm import make_lm_train_step

    opt = sgd(warmup_step_decay(0.05, 2, [8], warmup_from=0.02),
              momentum=0.9)
    state = create_train_state(tm, opt)
    step = make_lm_train_step(tm, opt, mesh, use_aps=fmt != (8, 23),
                              grad_exp=fmt[0], grad_man=fmt[1],
                              mode=reduce_mode, **step_kw)
    losses, after, metrics = [], [], []
    for toks, tgts in batches:
        state, m = step(state, toks, tgts)
        losses.append(float(m["loss"]))
        metrics.append({k: float(v) for k, v in m.items()})
        after.append({k: p.detach().numpy().copy()
                      for k, p in tm.named_parameters()})
    return losses, after, metrics


@pytest.mark.parametrize("arm", list(STEP_ARMS))
def test_lm_train_step_dp2_sp2_tp2_matches_jax(arm):
    """Two steps at dp 2 x sp 2 x tp 2 against JAX's step on the same
    mesh: the dp reduce of each tp index over its local tree (its
    shards and the replicated leaves), the optimizer on the whole
    leaves.  fp32 arms (ring; scanned layers with remat and dropout
    0.5, whose keys are flax's scan keys): losses within LOSS_RTOL,
    every leaf within WEIGHT_ATOL.  The APS e5m2 SR ring with dropout
    at ``emulate_node`` 2 and the e4m3 faithful FFN (K8's plain version
    on the row-sharded ``wo_mlp``'s local K, its fp32 output summed over
    tp): step 0's loss within LOSS_RTOL (5e-3 at e4m3, whose casts flip
    on fp32 round-off), step 1's within 5e-3, every leaf within 1/8 of
    its update."""
    from cpd_tpu_torch.parallel.mesh import make_mesh

    model_kw, fmt, red, n, rounding = STEP_ARMS[arm]
    sr = dict(grad_rounding=rounding, grad_seed=3) \
        if rounding == "stochastic" else {}
    batches = [_tokens(20 + i, rows=2 * ROWS * n) for i in range(2)]
    params, start, jl, jafter = _jax_steps(model_kw, fmt, red, batches, n,
                                           **sr)
    tm = _torch_model(params, sp_axis="sp", tp_axis="tp", **model_kw)
    if sr:
        tm = _FlaxOrder(tm, start)
    tl, tafter, _ = _torch_steps(tm, fmt, red, batches,
                                 make_mesh(2, 2, "cpu", tp=2),
                                 emulate_node=n, **sr)
    exact = fmt == (8, 23) and "ffn_exp" not in model_kw
    for i in range(2):
        rtol = LOSS_RTOL if exact or (i == 0 and "ffn_exp" not in
                                      model_kw) else 5e-3
        np.testing.assert_allclose(tl[i], jl[i], rtol=rtol, err_msg=str(i))
        for name, p in tafter[i].items():
            update = np.abs(jafter[i][name] - start[name]).max()
            assert update > 0, (i, name)
            tol = WEIGHT_ATOL if exact else update / 8
            np.testing.assert_allclose(p, jafter[i][name], rtol=0, atol=tol,
                                       err_msg=f"step {i} {name}")


def test_scan_bitwise_unrolled_and_masks_flax():
    """The scanned model on the unrolled model's weights stacked over
    the layers gives its logits and its gradients (restacked) bit for
    bit; `scan_dropout_key` + `dropout` give flax's ``nn.scan``
    dropout masks bit for bit (both sites, three layers), and the
    scanned LM with dropout in training matches flax's scanned forward
    within LOGIT_ATOL."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from cpd_tpu.models import transformer_lm as jax_lm
    from cpd_tpu_torch.models.transformer import dropout, scan_dropout_key

    params = _jax_params(2)
    stacked = dict(params)
    blocks = [stacked.pop(f"block{i}") for i in range(TP_TINY["n_layers"])]
    stacked["blocks"] = jax.tree.map(lambda *ls: np.stack(ls), *blocks)
    unrolled = _torch_model(params)
    scanned = _torch_model(stacked, scan_layers=True)
    toks, tgts = _tokens(3, rows=2)
    t = torch.from_numpy(toks).long()
    outs = []
    for m in (unrolled, scanned):
        logits = m(t)
        logits.square().sum().backward()
        outs.append(logits.detach())
    assert torch.equal(outs[0], outs[1])
    for name, p in scanned.named_parameters():
        if name.startswith("blocks."):
            want = torch.stack([unrolled.get_parameter(
                f"blocks.{i}.{name[7:]}").grad
                for i in range(TP_TINY["n_layers"])])
        else:
            want = unrolled.get_parameter(name).grad
        assert torch.equal(p.grad, want), name

    class Blk(nn.Module):
        @nn.compact
        def __call__(self, x, _):
            return x, (nn.Dropout(DROPOUT, deterministic=False)(x),
                       nn.Dropout(DROPOUT, deterministic=False)(x))

    class Top(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.scan(Blk, variable_axes={"params": 0},
                           split_rngs={"params": True, "dropout": True},
                           in_axes=nn.broadcast, length=3)(
                name="blocks")(x, None)[1]

    key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    tkey = tuple(int(w) for w in np.asarray(key))
    x = np.random.default_rng(0).standard_normal((3, 37, 32)).astype(
        np.float32)
    want = jax.jit(lambda a: Top().apply({}, a, rngs={"dropout": key}))(
        jnp.asarray(x))
    for site, w in enumerate(want):
        for layer in range(3):
            got = dropout(torch.from_numpy(x), DROPOUT,
                          scan_dropout_key(tkey, layer, 3, site))
            _bitwise(got.numpy(), np.asarray(w[layer]), f"{layer} {site}")
    jm = jax_lm(**TP_TINY, scan_layers=True, dropout_rate=DROPOUT)
    want = jax.jit(lambda p, t: jm.apply({"params": p}, t, train=True,
                                         rngs={"dropout": key}))(
        stacked, jnp.asarray(toks))
    drop = _torch_model(stacked, scan_layers=True,
                        dropout_rate=DROPOUT).train()
    with torch.no_grad():
        got = drop(t, tkey)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)
    assert not torch.equal(got, drop.eval()(t))


def test_tp2_step_matches_tp1():
    """Two fp32 steps (RTNE faithful reduce) at dp 2 x tp 2 against the
    same at dp 2 x tp 1 in the port: losses within LOSS_RTOL, every leaf
    within WEIGHT_ATOL (the tp sums change the rounding, not the
    value); the eval step counts the dp tokens once."""
    from cpd_tpu_torch.parallel.mesh import make_mesh
    from cpd_tpu_torch.train.lm import make_lm_eval_step

    params = _jax_params(9)
    batches = [_tokens(50 + i) for i in range(2)]
    runs = []
    for tp in (2, 1):
        tm = _torch_model(params, tp_axis="tp")
        mesh = make_mesh(2, 1, "cpu", tp=tp)
        runs.append(_torch_steps(tm, (8, 23), "faithful", batches, mesh)
                    + (make_lm_eval_step(tm, mesh)(None, *_tokens(60)),))
    (l2, a2, _, e2), (l1, a1, _, e1) = runs
    np.testing.assert_allclose(l2, l1, rtol=LOSS_RTOL)
    for name in a1[-1]:
        np.testing.assert_allclose(a2[-1][name], a1[-1][name], rtol=0,
                                   atol=WEIGHT_ATOL, err_msg=name)
    np.testing.assert_allclose(float(e2["loss"]), float(e1["loss"]),
                               rtol=LOSS_RTOL)
    assert float(e2["accuracy"]) == float(e1["accuracy"])


def test_tp_refusals():
    """At tp > 1: LARS and global-norm clipping refused (norm-based), as
    JAX's step refuses them; ``overlap_reduce`` raises "not yet ported"
    naming row 2; heads or kv-heads that do not split over tp refused by
    the model and the CLI; a LocalMesh step needs the full-width model;
    ``--scan-layers`` with ``--sample`` refused."""
    from cpd_tpu_torch.examples.lm import train as cli
    from cpd_tpu_torch.models import transformer_lm as torch_lm
    from cpd_tpu_torch.parallel.mesh import make_mesh
    from cpd_tpu_torch.train import make_optimizer, sgd
    from cpd_tpu_torch.train.lm import make_lm_train_step

    mesh = make_mesh(1, 1, "cpu", tp=2)
    m = torch_lm(**TP_TINY, device="cpu", tp_axis="tp")
    for opt in (make_optimizer("lars", lambda s: 0.1),
                make_optimizer("sgd", lambda s: 0.1, clip_norm=1.0)):
        with pytest.raises(ValueError, match="norm-based"):
            make_lm_train_step(m, opt, mesh)
    opt = sgd(lambda s: 0.1)
    with pytest.raises(NotImplementedError, match="Queue A, row 2"):
        make_lm_train_step(m, opt, mesh, overlap_reduce=True)
    with pytest.raises(ValueError, match="tp_size=1"):
        make_lm_train_step(torch_lm(**TP_TINY, device="cpu", tp_axis="tp",
                                    tp_size=2), opt, mesh)
    with pytest.raises(ValueError, match="tp_axis"):
        make_lm_train_step(torch_lm(**TP_TINY, device="cpu"), opt, mesh)
    for kw in (dict(n_kv_heads=1), dict(n_heads=3, d_model=24,
                                        n_kv_heads=None)):
        with pytest.raises(ValueError, match="not divisible by tp_size"):
            torch_lm(**dict(TP_TINY, **kw), device="cpu", tp_axis="tp",
                     tp_size=2)
    for extra, match in ((["--tp", "3"], "n-heads 4 not divisible by tp"),
                         (["--n-kv-heads", "1", "--sp", "1"],
                          "n-kv-heads 1 not divisible by tp"),
                         (["--sample", "4"], "does not compose"),
                         (["--tp", "0"], ">= 1")):
        with pytest.raises(SystemExit, match=match):
            cli.parse_args(TP_ARGV + extra)
    with pytest.raises(ValueError, match="tp view"):
        torch_lm(**TP_TINY, device="cpu", tp_axis="tp", tp_size=2)(
            torch.zeros((1, 4), dtype=torch.long))


def _cli(argv, device="cpu"):
    from cpd_tpu_torch.examples.lm import train as cli

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        res = cli.run(cli.parse_args(argv), device=device)
    # the loss lines without their host-clock tokens/s
    return res, [ln.split(" TokPerSec")[0] for ln in
                 text.getvalue().splitlines()
                 if ln.startswith(("Iter", "Val"))]


# the spawn's step arms: the model's options and the step's
SPAWN_ARMS = {
    "ring-fp32": (dict(sp_mode="ring"), dict()),
    "ring-aps-dropout": (dict(sp_mode="ring", dropout_rate=DROPOUT),
                         dict(use_aps=True, grad_exp=5, grad_man=2,
                              mode="ring")),
    "ulysses-scan-sr-emulate2-verify": (
        dict(sp_mode="ulysses", scan_layers=True, remat=True),
        dict(use_aps=True, grad_exp=5, grad_man=2, mode="ring",
             emulate_node=2, grad_rounding="stochastic", grad_seed=3,
             verify_reduce=True, quant_stats=True)),
}


def _tp_bytes(model_kw, rows, t_local) -> int:
    """The bytes a process hands to the tp all-gathers in one micro-batch
    of ``rows`` rows: an fp32 (rows, T_local, d_model) sum twice a layer
    forward and twice backward, and under remat the recomputed
    forward's up to the last tensor the backward saved (the attention
    projection's sum; the MLP's too with dropout, whose mask follows
    it); the replicated leaves' gradients once."""
    d, n = TP_TINY["d_model"], TP_TINY["n_layers"]
    act = rows * t_local * d * 4
    per_layer = 4 * act
    if model_kw.get("remat"):
        per_layer += (2 if model_kw.get("dropout_rate") else 1) * act
    replicated = TP_TINY["vocab_size"] * d + 4 * d * n + 2 * d
    return n * per_layer + replicated * 4


def _rank_work(local_refs: bool = False) -> dict:
    """One process of the spawn (or, with ``local_refs``, the parent's
    `LocalMesh` reference of the same work): dp 1 x sp 2 x tp 2.
    Returns numpy arrays (tensors do not outlive the child)."""
    import os

    from cpd_tpu_torch.models import transformer_lm as torch_lm
    from cpd_tpu_torch.models.transformer import rank_params
    from cpd_tpu_torch.parallel.dist import dist_init, local_rows
    from cpd_tpu_torch.parallel.mesh import make_mesh
    from cpd_tpu_torch.train import create_train_state, sgd
    from cpd_tpu_torch.train.lm import make_lm_train_step

    torch.set_num_threads(1)
    out = {}
    if local_refs:
        mesh, k = make_mesh(1, 2, "cpu", tp=2), None
    else:
        dist_init("gloo")
        mesh = make_mesh(None, 2, "cpu", tp=2)
        k = mesh.coords(int(os.environ["RANK"]))["tp"]

    def model(seed, **kw):
        full = torch_lm(**TP_TINY, device="cpu", sp_axis="sp", tp_axis="tp",
                        **kw).init_weights(torch.Generator().manual_seed(seed))
        if local_refs:
            return full
        return torch_lm(**TP_TINY, device="cpu", sp_axis="sp", tp_axis="tp",
                        tp_size=2, **kw).load_shard(full, k)

    def shards(m):
        """Every tp rank's weights (the process's own)."""
        if local_refs:
            return [{n: p.numpy().copy() for n, p in
                     rank_params(m, j, 2).items()} for j in range(2)]
        return {n: p.detach().numpy().copy() for n, p in
                m.named_parameters()}

    toks, _ = _tokens(11, rows=ROWS)
    tm = model(4).eval()
    with torch.no_grad():
        t = torch.from_numpy(local_rows(toks, mesh)).long()
        blocks = ([t[:, j * 8:(j + 1) * 8] for j in (0, 0, 1, 1)]
                  if local_refs else [t])
        out["forward"] = [lg.numpy() for lg in tm.forward_sp(
            blocks, mesh.axis("sp"), None, None, mesh.axis("tp"))]
    for arm, (model_kw, step_kw) in SPAWN_ARMS.items():
        n = step_kw.get("emulate_node", 1)
        fed = [(local_rows(a, mesh), local_rows(b, mesh)) for a, b in
               (_tokens(30 + i, rows=ROWS * n) for i in range(2))]
        tm = model(5, **model_kw)
        opt = sgd(lambda s: 0.05, momentum=0.9)
        state = create_train_state(tm, opt)
        step = make_lm_train_step(tm, opt, mesh, **step_kw)
        metrics, logs = [], []
        for a, b in fed:
            mesh.log = [] if not local_refs else None
            state, m = step(state, a, b)
            metrics.append({key: float(v) for key, v in m.items()})
            if not local_refs:
                logs.append(sum(nb for op, _, nb in mesh.log
                                if op == "tp.all_gather"))
                mesh.log = None
        out[f"step-{arm}"] = (metrics, shards(tm), logs)
    argv = TP_ARGV + (["--dp", "1"] if local_refs
                      else ["--dist", "--dist-backend", "gloo"])
    res, lines = _cli(argv)
    out["cli"] = (res["loss"], res["val"], lines)
    if local_refs:
        # tp = 1 on the same weights: the forward and the fp32 arm
        mesh = make_mesh(1, 2, "cpu")
        tm = model(4).eval()
        with torch.no_grad():
            out["tp1-forward"] = [lg.numpy() for lg in tm.forward_sp(
                [t[:, :8], t[:, 8:]], mesh.axis("sp"))]
        tm = model(5, sp_mode="ring")
        opt = sgd(lambda s: 0.05, momentum=0.9)
        state = create_train_state(tm, opt)
        step = make_lm_train_step(tm, opt, mesh)
        losses = [float(step(state, a, b)[1]["loss"]) for a, b in
                  (_tokens(30 + i, rows=ROWS) for i in range(2))]
        out["tp1-ring-fp32"] = (losses, {n: p.detach().numpy().copy() for
                                         n, p in tm.named_parameters()})
    return out


@pytest.fixture(scope="module")
def spawned():
    ranks = spawn(_rank_work, 4, timeout=300.0)
    return ranks, _rank_work(local_refs=True)


def test_process_mesh_forward_bitwise_local(spawned):
    """On the 4-process gloo mesh (dp 1 x sp 2 x tp 2), each process's
    shard model gives its `LocalMesh` rank's logits bit for bit."""
    ranks, local = spawned
    for r, got in enumerate(ranks):
        _bitwise(got["forward"][0], local["forward"][r], f"rank {r}")


@pytest.mark.parametrize("arm", list(SPAWN_ARMS))
def test_process_mesh_steps_bitwise_local(spawned, arm):
    """Two steps of each arm (fp32; the APS e5m2 ring with dropout; Ulysses on
    scanned layers with remat, the SR verified ring at ``emulate_node``
    2 with the health counters): every process's loss and accuracy and
    shard weights bitwise its `LocalMesh` rank's (the tp-index-0
    processes' every metric: the `LocalMesh` reports tp index 0's
    reduce, as JAX's step returns device 0's), the verified ring clean,
    and the bytes a process hands to the tp all-gathers a step the
    shapes'."""
    ranks, local = spawned
    model_kw, step_kw = SPAWN_ARMS[arm]
    metrics, weights, _ = local[f"step-{arm}"]
    n = step_kw.get("emulate_node", 1)
    want = n * _tp_bytes(model_kw, ROWS, SEQ // 2)
    for r, got in enumerate(ranks):
        m, w, logs = got[f"step-{arm}"]
        if r % 2 == 0:
            assert m == metrics, r
        assert [(x["loss"], x["accuracy"]) for x in m] == [
            (x["loss"], x["accuracy"]) for x in metrics], r
        for name, x in weights[r % 2].items():
            _bitwise(w[name], x, f"rank {r} {name}")
        assert logs == [want] * 2, (r, logs, want)
    if "verify" in arm:
        assert all(x["reduce_ok"] == 1.0 and x["prec_wire_total"] > 0
                   for x in metrics)


def test_process_mesh_tp2_matches_tp1(spawned):
    """tp 2 on the gloo `ProcessMesh` against tp 1 in the port (dp 1 x
    sp 2 on a `LocalMesh`, the same weights): each process's logits
    within LOGIT_ATOL of its sp block's tp = 1 logits; after two fp32
    steps its losses within LOSS_RTOL and its shards within WEIGHT_ATOL
    of the tp = 1 weights' shards."""
    from cpd_tpu_torch.models.transformer import lm_param_specs, shard_param

    ranks, local = spawned
    losses, weights = local["tp1-ring-fp32"]
    specs = lm_param_specs(weights)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["forward"][0],
                                   local["tp1-forward"][r // 2], rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"rank {r}")
        metrics, shard, _ = got["step-ring-fp32"]
        np.testing.assert_allclose([m["loss"] for m in metrics], losses,
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
        for name, w in weights.items():
            np.testing.assert_allclose(
                shard[name], shard_param(w, specs[name][0], r % 2, 2),
                rtol=0, atol=WEIGHT_ATOL, err_msg=f"rank {r} {name}")


def test_cli_dist_tp_scan_bitwise_local(spawned):
    """Two CLI iterations of ``--sp 2 --tp 2 --scan-layers --remat
    --dropout 0.1``: under ``--dist`` on the 4 gloo processes rank 0's
    loss lines, the last loss and the validation equal ``--dp 1`` on one
    process (a finite loss, three lines), and the other ranks print
    nothing."""
    ranks, local = spawned
    loss, val, lines = local["cli"]
    assert np.isfinite(loss) and len(lines) == 3
    assert ranks[0]["cli"] == (loss, val, lines)
    for got in ranks[1:]:
        assert got["cli"][:2] == (loss, val) and got["cli"][2] == []


@pytest.mark.cuda
def test_k8_at_tp_local_shapes_matches_plain_on_card():
    """K8 (the e4m3 faithful QuantDense GEMM) at tp-local shapes of the
    serving width at tp 2 — wi's (M, 512) x (512, 1024) and the
    row-sharded wo_mlp's (M, 1024) x (1024, 512) — bitwise its plain
    version, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode")
    from cpd_tpu_torch.ops import qgemm as tqg

    gen = torch.Generator(device="cuda").manual_seed(21)
    for m, k, n in [(256, 512, 1024), (256, 1024, 512)]:
        a = torch.randn((m, k), generator=gen, device="cuda")
        b = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        before = tqg.qgemm_faithful.launches
        got = tqg.qgemm_faithful(a, b, 4, 3)
        torch.cuda.synchronize()
        assert tqg.qgemm_faithful.launches == before + 1
        want = tqg.qgemm_faithful_ref(a, b, 4, 3)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
