"""The port's ImageNet ResNets, bench.py's headline step and fast mode vs
the JAX package.

Each test says how it compares:

* BITWISE — `load_jax_resnet`'s mapping of every leaf of flax's
  ``resnet50()``, the parameter count (25,557,032);
* to a TOLERANCE — the full-depth fp32 ResNet-50 forward with the JAX
  weights carried over (XLA:CPU and ATen sum the convolutions and the BN
  statistics in other orders): in eval mode at (2, 32, 32, 3) the logits
  within FWD_RTOL of their largest magnitude (measured 1.7e-6; without
  batch statistics the residual stream grows to logits of ~800), in
  train mode at (2, 64, 64, 3) within FWD_TRAIN_ATOL (measured 1e-3 at
  logits of ~4: stage 4 normalises 8 values a channel, which magnifies
  the order differences; at 32 x 32 it normalises 2, and the
  near-degenerate statistics move logits by units, so that shape is
  held in eval mode only);
* the narrow bf16 models (flax's casts: bf16 convs, fp32 BN statistics
  and normalisation rounded once to bf16, an fp32 head) within
  BF16_ATOL of JAX's bf16 logits in train mode (a bf16 rounding flipped
  upstream by a sum in another order moves a logit by ulps of bf16), in
  eval mode within BF16_ATOL relative and absolute (the running stats at
  their init let the activations grow through the blocks), and their BN
  running stats within BF16_STATS_ATOL;
* two train steps of the narrow bf16 model at W = 2, APS e5m2, faithful
  and fast, against the JAX ``make_train_step``: losses within
  STEP_LOSS_RTOL, every leaf's change within LEAF_SHARE of JAX's and
  the BN stats within BF16_STATS_ATOL (the notes at STEP_LOSS_RTOL);
* two train steps of the narrow fp32 models at W = 2, (8, 23), the
  Bottleneck one faithful and the BasicBlock one fast, against the same
  JAX step: losses and BN stats within
  FP32_STEP_RTOL, every leaf's change within FP32_LEAF_SHARE of JAX's
  (the backward, the reduce and the update held past bf16's noise).

bench.py's headline entry (`cpd_tpu_torch.bench`) prints ``value: null``
with a reason on a host without a card.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cpd_tpu.data import cifar as jcifar
from cpd_tpu.models import resnet as jres
from cpd_tpu.parallel.mesh import make_mesh
from cpd_tpu.train import optim as joptim
from cpd_tpu.train import schedules as jsched
from cpd_tpu.train.state import TrainState as JState
from cpd_tpu.train.step import make_train_step as j_make_step
from cpd_tpu_torch import bench as tbench
from cpd_tpu_torch.interop import load_jax_resnet
from cpd_tpu_torch.models import get_model
from cpd_tpu_torch.models import resnet as tres
from cpd_tpu_torch.parallel.mesh import LocalMesh
from cpd_tpu_torch.train import (as_batch, create_train_state,
                                 make_train_step, sgd, warmup_step_decay)
from test_torch_threads import one_torch_thread  # noqa: F401

FWD_RTOL = 1e-5
FWD_TRAIN_ATOL = 5e-3
BF16_ATOL = 5e-2
BF16_STATS_ATOL = 2e-2
# Two bf16 APS e5m2 steps.  The bf16 backward is noisy in both packages:
# each package's bf16 gradients lie far from the fp32 gradients of the
# same weights (BatchNorm's backward through bf16 activations), which
# the packages agree on to fp32 round-off, and as far from each other's;
# an e5m2 cast (2 mantissa bits) then rounds such a difference a whole
# e5m2 step further.  So the losses are held to STEP_LOSS_RTOL and each
# weight's change over the two steps to LEAF_SHARE of JAX's change in L2
# norm (the worst leaf, an 8-element BN scale, reads about 0.56; a sign
# flip of the update reads 2).
STEP_LOSS_RTOL = 5e-3
LEAF_SHARE = 0.75
# Two fp32 steps at (8, 23): the packages differ by fp32 round-off only.
# Losses and BN stats within FP32_STEP_RTOL (measured 2e-7 on the
# losses); each weight's change within FP32_LEAF_SHARE of JAX's (worst
# leaf measured 9.1e-6, a BN scale; with weight decay dropped from the
# update the stem conv reads 1.1e-3, and a gradient of half the batch
# moves the second loss by 1.3e-3 to 2.2e-2)
FP32_STEP_RTOL = 1e-5
FP32_LEAF_SHARE = 5e-5
# two stages of one block: few leaves, so the JAX steps compile quickly
NARROW = dict(stage_sizes=(1, 1), widths=(8, 16), num_classes=10)
BLOCKS = {"bottleneck": (jres.Bottleneck, tres.Bottleneck),
          "basic": (jres.BasicBlockV1, tres.BasicBlockV1)}


def _bitwise(want, got):
    got = np.ascontiguousarray(got.detach().numpy()
                               if isinstance(got, torch.Tensor) else got)
    want = np.ascontiguousarray(want)
    assert want.shape == got.shape and want.dtype == got.dtype
    np.testing.assert_array_equal(want.view(np.uint8), got.view(np.uint8))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@pytest.fixture(scope="module")
def jax_resnet50():
    """flax ``resnet50()`` and its variables from PRNGKey(0) (jitted:
    the same weights as eager init)."""
    model = jres.resnet50()
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((2, 32, 32, 3)), train=False))(jax.random.PRNGKey(0))
    return model, variables, jax.device_get(variables)


def test_load_jax_resnet_covers_every_leaf_of_resnet50(jax_resnet50):
    """Bitwise: every flax leaf lands in the port's state dict (HWIO ->
    OIHW, (I, O) -> (O, I)); a tree with a leaf missing or one extra
    raises."""
    _, _, host = jax_resnet50
    model = load_jax_resnet(tres.resnet50(device="cpu"), host)
    params, stats = host["params"], host["batch_stats"]
    sd = model.state_dict()
    _bitwise(np.transpose(params["stem_conv"]["kernel"], (3, 2, 0, 1)),
             sd["stem_conv.weight"])
    blk = params["layer3_block0"]
    _bitwise(np.transpose(blk["downsample_conv"]["kernel"], (3, 2, 0, 1)),
             sd["layer3_block0.downsample_conv.weight"])
    _bitwise(params["layer4_block2"]["bn3"]["scale"],
             sd["layer4_block2.bn3.weight"])
    _bitwise(stats["layer2_block1"]["bn2"]["var"],
             sd["layer2_block1.bn2.running_var"])
    _bitwise(params["fc"]["kernel"].T, sd["fc.weight"])
    _bitwise(params["fc"]["bias"], sd["fc.bias"])
    n_leaves = sum(1 for _ in jax.tree_util.tree_leaves(host))
    assert n_leaves == len(sd)
    short = {"params": dict(params), "batch_stats": stats}
    del short["params"]["fc"]
    with pytest.raises(KeyError, match="fc.weight"):
        load_jax_resnet(tres.resnet50(device="cpu"), short)
    extra = {"params": dict(params, head={"bias": np.zeros(3)}),
             "batch_stats": stats}
    with pytest.raises(KeyError, match="head.bias"):
        load_jax_resnet(tres.resnet50(device="cpu"), extra)


def test_resnet50_has_the_jax_parameter_count_and_names(jax_resnet50):
    _, _, host = jax_resnet50
    n_jax = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(host["params"]))
    model = get_model("resnet50", device="cpu")
    assert sum(p.numel() for p in model.parameters()) == n_jax == 25_557_032
    assert [n for n, _ in model.named_children()][:4] == [
        "stem_conv", "stem_bn", "layer1_block0", "layer1_block1"]
    assert len(list(model.parameters())) == 161
    gen = torch.Generator().manual_seed(24)
    model.init_weights(gen)
    w = model.layer3_block1.conv2.weight
    assert abs(float(w.detach().std()) - math.sqrt(2 / w[0].numel())) < 0.01
    assert float(model.fc.bias.detach().abs().max()) == 0.0
    for depth, n in (("resnet18", 11_689_512), ("resnet34", 21_797_672),
                     ("resnet101", 44_549_160)):
        m = get_model(depth, device="cpu")
        assert sum(p.numel() for p in m.parameters()) == n


@pytest.mark.parametrize("kw", [dict(output_stride=8),
                                dict(features_only=True),
                                dict(feature_stages=(3, 4)),
                                dict(bn_axis="dp")])
def test_fcn_options_are_not_ported_yet(kw):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tres.resnet50(device="cpu", **kw)


def test_resnet50_fp32_forward_matches_jax(jax_resnet50):
    """Full depth, fp32, the JAX weights carried over: eval mode at (2,
    32, 32, 3) to FWD_RTOL of the largest logit; train mode at (2, 64,
    64, 3) to FWD_TRAIN_ATOL, and a BN running variance it leaves."""
    jmodel, variables, host = jax_resnet50
    model = load_jax_resnet(tres.resnet50(device="cpu"), host)
    x = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    model.eval()
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FWD_RTOL * np.abs(want).max())
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    want, mut = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    model.train()
    with torch.no_grad():
        got = model(_nchw(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=FWD_TRAIN_ATOL)
    np.testing.assert_allclose(
        model.layer4_block2.bn3.running_var.numpy(),
        jax.device_get(mut["batch_stats"])["layer4_block2"]["bn3"]["var"],
        rtol=1e-4, atol=1e-5)


def _narrow(name, seed=0, dtype="bfloat16"):
    jblock, tblock = BLOCKS[name]
    jmodel = jres.ResNet(block=jblock, dtype=getattr(jnp, dtype), **NARROW)
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((2, 32, 32, 3)), train=False))(jax.random.PRNGKey(seed))
    tmodel = tres.ResNet(block=tblock, dtype=getattr(torch, dtype),
                         device="cpu", **NARROW)
    return jmodel, variables, load_jax_resnet(tmodel,
                                              jax.device_get(variables))


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_narrow_bf16_resnet_matches_jax_bf16(block):
    """bf16 compute over fp32 weights, train and eval mode: fp32 logits
    within BF16_ATOL of JAX's bf16 model, the BN running stats one
    train-mode forward leaves within BF16_STATS_ATOL."""
    jmodel, variables, tmodel = _narrow(block)
    x = np.random.RandomState(3).randn(4, 32, 32, 3).astype(np.float32)
    want, mut = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    tmodel.train()
    with torch.no_grad():
        got = tmodel(_nchw(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BF16_ATOL)
    stats = jax.device_get(mut["batch_stats"])
    np.testing.assert_allclose(tmodel.layer2_block0.bn2.running_var.numpy(),
                               stats["layer2_block0"]["bn2"]["var"],
                               rtol=0, atol=BF16_STATS_ATOL)
    np.testing.assert_allclose(tmodel.stem_bn.running_mean.numpy(),
                               stats["stem_bn"]["mean"], rtol=0,
                               atol=BF16_STATS_ATOL)
    load_jax_resnet(tmodel, jax.device_get(variables))
    tmodel.eval()
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(_nchw(x).to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BF16_ATOL,
                               atol=BF16_ATOL)


def _flat_state(block, params, batch_stats) -> dict:
    model = load_jax_resnet(
        tres.ResNet(block=BLOCKS[block][1], device="cpu", **NARROW),
        {"params": params, "batch_stats": batch_stats})
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _two_steps(block, dtype, mode, **reduce_kw):
    """Two train steps of the narrow ``block`` ResNet at ``dtype`` from
    carried-over weights in both packages: W = 2 ranks, batch 4 per rank,
    SGD momentum 0.9 wd 1e-4, the gradient reduce of ``mode`` and
    ``reduce_kw``; the JAX step runs under shard_map on 2 CPU devices.
    Returns the state dicts (numpy) at the start, after JAX's steps and
    after the port's, and each package's losses."""
    world, per_rank = 2, 4
    jmodel, variables, tmodel = _narrow(block, seed=5, dtype=dtype)
    start = _flat_state(block, jax.device_get(variables["params"]),
                        jax.device_get(variables["batch_stats"]))
    tx = joptim.sgd(jsched.warmup_step_decay(0.4, 5, [100],
                                             warmup_from=0.1),
                    momentum=0.9, weight_decay=1e-4)
    mesh = make_mesh(dp=world, devices=jax.devices()[:world])
    # `create_train_state` of the carried variables, without its eager
    # second init
    jstate = JState(step=jnp.zeros([], jnp.int32),
                    params=variables["params"],
                    batch_stats=variables["batch_stats"],
                    opt_state=tx.init(variables["params"]))
    # placed as the step returns it: the second step reuses the compile
    jstate = jax.device_put(jstate, NamedSharding(mesh, P()))
    # one bucket: the faithful scan is elementwise, so its buckets change
    # no bit, and one scan compiles faster than one a leaf
    jstep = j_make_step(jmodel, tx, mesh, mode=mode, donate=False,
                        bucket_elems=1 << 22 if mode == "faithful" else None,
                        **reduce_kw)
    opt = sgd(warmup_step_decay(0.4, 5, [100], warmup_from=0.1),
              momentum=0.9, weight_decay=1e-4)
    tstate = create_train_state(tmodel, opt)
    tstep = make_train_step(tmodel, opt, LocalMesh(world, "cpu"), mode=mode,
                            **reduce_kw)
    x, y, _, _ = jcifar.synthetic_cifar10(2 * world * per_rank, 8, seed=4)
    pipe = jcifar.CIFAR10Pipeline(x, y, world * per_rank)
    sharding = NamedSharding(mesh, P("dp"))
    losses = []
    for it in range(2):
        idx = np.arange(it * world * per_rank, (it + 1) * world * per_rank)
        bx, by = pipe.batch(idx)
        jstate, jm = jstep(jstate, jax.device_put(bx, sharding),
                           jax.device_put(by, sharding))
        tstate, tm = tstep(tstate, bx, by)
        losses.append((float(jm["loss"]), float(tm["loss"])))
    want = _flat_state(block, jax.device_get(jstate.params),
                       jax.device_get(jstate.batch_stats))
    got = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    return start, want, got, np.array(losses)


@pytest.mark.parametrize("mode", ["faithful", "fast"])
def test_two_bf16_aps_e5m2_steps_match_jax(mode):
    """bench.py's headline step at a narrow width: the bf16 Bottleneck
    ResNet, APS e5m2 in ``mode`` (`_two_steps`).  Losses within
    STEP_LOSS_RTOL; each weight's change over the two steps within
    LEAF_SHARE of JAX's (L2); the rank-mean BN stats within
    BF16_STATS_ATOL.  `test_two_fp32_steps_match_jax` holds the same
    backward and update tightly."""
    start, want, got, losses = _two_steps("bottleneck", "bfloat16", mode,
                                          use_aps=True, grad_exp=5,
                                          grad_man=2)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0],
                               rtol=STEP_LOSS_RTOL)
    for name, g in got.items():
        if "running" in name:
            np.testing.assert_allclose(g, want[name], rtol=0,
                                       atol=BF16_STATS_ATOL, err_msg=name)
            continue
        moved = np.linalg.norm(want[name] - start[name])
        assert moved > 0, name
        assert np.linalg.norm(g - want[name]) <= LEAF_SHARE * moved, name


@pytest.mark.parametrize("block,mode", [("bottleneck", "faithful"),
                                        ("basic", "fast")])
def test_two_fp32_steps_match_jax(block, mode):
    """The backward, the reduce and the SGD update without bf16 noise:
    the narrow fp32 ``block`` ResNet, gradients reduced at (8, 23)
    without APS in ``mode`` (`_two_steps`; APS at (8, 23) overflows its
    scale in both packages).  Losses within
    FP32_STEP_RTOL; each weight's change over the two steps within
    FP32_LEAF_SHARE of JAX's change (L2), so half a batch, a wrong
    BN-backward scale or a missing weight-decay term fails; the BN
    running stats within FP32_STEP_RTOL."""
    start, want, got, losses = _two_steps(block, "float32", mode,
                                          grad_exp=8, grad_man=23)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0],
                               rtol=FP32_STEP_RTOL)
    for name, g in got.items():
        if "running" in name:
            np.testing.assert_allclose(g, want[name], rtol=FP32_STEP_RTOL,
                                       atol=FP32_STEP_RTOL, err_msg=name)
            continue
        moved = np.linalg.norm(want[name] - start[name])
        assert moved > 0, name
        assert np.linalg.norm(g - want[name]) <= FP32_LEAF_SHARE * moved, \
            name


def test_as_batch_keeps_a_bf16_batch_in_bf16():
    img = torch.randn(2, 8, 8, 3)
    x, y = as_batch(img.to(torch.bfloat16), np.array([1, 2]), "cpu")
    assert x.dtype == torch.bfloat16 and tuple(x.shape) == (2, 3, 8, 8)
    assert y.dtype == torch.int64
    x, _ = as_batch(img.numpy(), np.array([1, 2]), "cpu")
    assert x.dtype == torch.float32


def test_bench_prints_null_with_a_reason_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench measures it")
    assert tbench.main() == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["metric"] == "resnet50_train_img_per_sec_per_chip"
    assert line["value"] is None and "cuda" in line["error"]
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.run(device="cpu")


def test_bench_draws_bench_pys_inputs():
    """Bitwise: the images and labels bench.py draws from RandomState(0)
    (its fuse-16 draw at a small size), the images rounded to bf16."""
    x, y = tbench.headline_batches(1, 2, 8, "cpu")
    rng = np.random.RandomState(0)
    want_x = rng.randn(16, 2, 8, 8, 3).astype(np.float32)
    want_y = rng.randint(0, 1000, (16, 2)).astype(np.int32)
    assert x.dtype == torch.bfloat16 and tuple(x.shape) == (16, 2, 8, 8, 3)
    _bitwise(np.asarray(jnp.asarray(want_x, jnp.bfloat16)).view(np.uint16),
             x.view(torch.int16).numpy().view(np.uint16))
    _bitwise(want_y, y)


def test_resnet_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid device here")
    for name in ("resnet50", "resnet18", "res_cifar"):
        with pytest.raises(RuntimeError, match="cuda"):
            get_model(name)
