"""Checkpoints and reference-layout weights of the port
(`cpd_tpu_torch/train/checkpoint.py`, `cpd_tpu_torch/interop.py`, the
ResNet CLI's checkpoint flags) vs the JAX package.

* the digest: `cpd_tpu.train.checkpoint.checkpoint_digest` of a port
  step directory equals the port's, and the sidecar records it;
* save -> restore -> step is BITWISE one unbroken step, for sgd,
  nesterov, LARS and `quant_sgd` with its Kahan buffer under RTNE and
  under SR (a `LocalMesh` W = 2, the faithful APS reduce, the tiny CNN);
* corruption (`tests/test_resilience.py:494`): a truncated or bit-flipped
  newest step is skipped for the newest valid one, all corrupt gives
  None, a torn sidecar counts as invalid, ``integrity=False`` restores
  with ``verified`` None, ``max_to_keep`` holds newest-N and, with
  ``track_best``, best-N;
* reference weights: the JAX package's `export_reference_resnet18_cifar`
  of seeded flax ResNet-18 variables, written by its
  `save_torch_checkpoint`, imports into the port's ResNet-18 BITWISE as
  `load_jax_resnet_cifar` loads the variables; the port's export, read
  by the JAX `import_reference_resnet18_cifar`, is the flax variables
  BITWISE;
* the port CLI's ``-e --init-from-torch`` on the committed real-format
  fixture gives the JAX CLI's validation loss within 1e-5 relative and
  its Prec@1 within one image of the 200 (both run the fp32 ResNet-18 on
  the CPU, XLA and ATen convolving in other orders);
* the CLI: a run saved at iteration 2 and resumed (auto-resume from
  ``--save_path``, and ``--load-path --resume-opt``) to 4 equals an
  unbroken 4-iteration run bitwise: last loss and accuracy, and every
  array of the step-4 checkpoints.
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

from cpd_tpu_torch import interop
from cpd_tpu_torch.examples.resnet18_cifar import train as tcli
from cpd_tpu_torch.models.tiny import TinyCNN
from cpd_tpu_torch.parallel.mesh import LocalMesh
from cpd_tpu_torch.train import (create_train_state, make_optimizer,
                                 make_train_step, warmup_step_decay)
from cpd_tpu_torch.train.checkpoint import (CheckpointManager,
                                            checkpoint_digest,
                                            restore_latest,
                                            save_checkpoint)
from test_torch_threads import one_torch_thread  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "cifar10_real_format")
OPTS = {
    "sgd": dict(name="sgd"),
    "nesterov": dict(name="nesterov"),
    "lars": dict(name="lars"),
    "quant_sgd-kahan-rtne": dict(name="quant_sgd", opt_exp=4, opt_man=3,
                                 opt_kahan=True),
    "quant_sgd-kahan-sr": dict(name="quant_sgd", opt_exp=4, opt_man=3,
                               opt_kahan=True, opt_rounding="stochastic",
                               opt_seed=3),
}


def _state(opt_kw: dict, seed: int = 0):
    kw = dict(opt_kw)
    opt = make_optimizer(kw.pop("name"), warmup_step_decay(
        0.4, 5, [100], warmup_from=0.1), momentum=0.9, weight_decay=1e-4,
        **kw)
    gen = torch.Generator().manual_seed(seed)
    model = TinyCNN(device="cpu").init_weights(gen)
    return model, opt, create_train_state(model, opt)


def _batch(i: int):
    rng = np.random.RandomState(10 + i)
    return (rng.rand(8, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, 8))


def _arrays(state) -> list:
    from cpd_tpu_torch.parallel.integrity import tensor_leaves

    return [t.detach().numpy().copy() for t in tensor_leaves(state)]


def _bitwise(want, got, msg=""):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype, msg
    np.testing.assert_array_equal(want.reshape(-1).view(np.uint8),
                                  got.reshape(-1).view(np.uint8),
                                  err_msg=msg)


def _step(model, opt):
    return make_train_step(model, opt, LocalMesh(2, "cpu"), use_aps=True,
                           grad_exp=5, grad_man=2, mode="faithful")


@pytest.mark.parametrize("opt", list(OPTS))
def test_save_restore_step_is_one_unbroken_run(opt, tmp_path):
    model, o, state = _state(OPTS[opt])
    step = _step(model, o)
    state, _ = step(state, *_batch(0))
    CheckpointManager(str(tmp_path)).save(1, state)
    state, m = step(state, *_batch(1))
    want = _arrays(state)

    model2, o2, fresh = _state(OPTS[opt], seed=7)
    restored = restore_latest(str(tmp_path), fresh)
    assert restored.step == 1 and restored.model is model2
    assert restored.opt_state.step == 1
    if opt.endswith("sr"):
        assert restored.opt_state.key == state.opt_state.key
    got_state, got_m = _step(model2, o2)(restored, *_batch(1))
    assert got_state.step == state.step == 2
    for k in ("loss", "accuracy"):
        _bitwise(m[k].numpy(), got_m[k].numpy(), k)
    got = _arrays(got_state)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        _bitwise(a, b, f"{opt} tensor {i}")


def test_digest_is_the_reference_function_and_bf16_round_trips(tmp_path):
    from cpd_tpu.train.checkpoint import checkpoint_digest as jdigest

    model, o, state = _state(OPTS["sgd"])
    with torch.no_grad():
        model.fc.weight.data = model.fc.weight.data.to(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path), track_best=False)
    mgr.save(3, state, metadata={"epoch": 1})
    step_dir = os.path.join(str(tmp_path), "3")
    assert sorted(os.listdir(step_dir)) == ["layout.json", "state.npz"]
    assert checkpoint_digest(step_dir) == jdigest(step_dir)
    meta = mgr.metadata(3)
    assert meta["epoch"] == 1 and meta["integrity"] == jdigest(step_dir)
    assert mgr.verify_step(3) is True
    want = model.fc.weight.detach().clone()
    _, _, fresh = _state(OPTS["sgd"], seed=5)
    fresh.model.fc.weight.data = fresh.model.fc.weight.data.to(
        torch.bfloat16)
    got = mgr.restore(fresh)
    assert got.model.fc.weight.dtype == torch.bfloat16
    _bitwise(want.view(torch.int16).numpy(),
             got.model.fc.weight.detach().view(torch.int16).numpy())
    with pytest.raises(FileExistsError):
        mgr.save(3, state)
    mgr.save(3, state, force=True)
    assert mgr.all_steps() == [3] and mgr.verify_step(3) is True
    with pytest.raises(ValueError, match="fc.weight saved"):
        mgr.restore(_state(OPTS["sgd"])[2])
    fresh = _state(OPTS["quant_sgd-kahan-rtne"])[2]
    fresh.model.fc.weight.data = fresh.model.fc.weight.data.to(
        torch.bfloat16)
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore(fresh)


def _corrupt(path: str, how: str) -> None:
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        if how == "truncate":
            f.truncate(max(size // 2, 1))
        else:
            f.seek(size // 2)
            byte = f.read(1)
            f.seek(size // 2)
            f.write(bytes([byte[0] ^ 0xFF]))


@pytest.mark.parametrize("how", ["truncate", "bitflip"])
def test_corrupt_newest_step_is_skipped_for_newest_valid(how, tmp_path,
                                                          capsys):
    model, o, state = _state(OPTS["sgd"])
    step = _step(model, o)
    mgr = CheckpointManager(str(tmp_path), track_best=False)
    state, _ = step(state, *_batch(0))
    mgr.save(1, state)
    want = _arrays(state)
    state, _ = step(state, *_batch(1))
    mgr.save(2, state)
    _corrupt(os.path.join(str(tmp_path), "2", "state.npz"), how)
    assert mgr.verify_step(2) is False and mgr.verify_step(1) is True
    res = mgr.restore_latest_valid(_state(OPTS["sgd"], seed=9)[2])
    assert (res.step, res.skipped, res.verified) == (1, (2,), True)
    assert "integrity digest mismatch" in capsys.readouterr().err
    for a, b in zip(want, _arrays(res.state)):
        _bitwise(a, b)
    _corrupt(os.path.join(str(tmp_path), "1", "layout.json"), "truncate")
    assert mgr.restore_latest_valid(_state(OPTS["sgd"])[2]) is None


def test_torn_sidecar_unverified_restore_and_retention(tmp_path, capsys):
    _, _, state = _state(OPTS["sgd"])
    mgr = CheckpointManager(str(tmp_path / "a"), track_best=False)
    mgr.save(1, state)
    mgr.save(2, state)
    with open(tmp_path / "a" / "meta-2.json", "w") as f:
        f.write('{"integrity": {"dig')
    assert mgr.verify_step(2) is False and mgr.metadata(2) is None
    assert mgr.restore_latest_valid(state).step == 1

    plain = CheckpointManager(str(tmp_path / "b"), integrity=False)
    plain.save(5, state)
    assert plain.verify_step(5) is None and plain.metadata(5) is None
    res = plain.restore_latest_valid(state)
    assert res.step == 5 and res.verified is None
    assert "WITHOUT an integrity digest" in capsys.readouterr().err

    newest = CheckpointManager(str(tmp_path / "c"), max_to_keep=2,
                               track_best=False)
    for s in range(1, 6):
        newest.save(s, state, best_metric=float(10 - s))
    assert newest.all_steps() == [4, 5]
    assert sorted(os.listdir(tmp_path / "c")) == ["4", "5", "meta-4.json",
                                                 "meta-5.json"]
    best = CheckpointManager(str(tmp_path / "d"), max_to_keep=2)
    for s, metric in ((1, 50.0), (2, 70.0), (3, None), (4, 60.0),
                      (5, 10.0)):
        best.save(s, state, best_metric=metric)
    # orbax's BestN: the two best metrics, and every step without one
    assert best.all_steps() == [2, 3, 4]
    save_checkpoint(str(tmp_path / "e"), 7, state)
    assert CheckpointManager(str(tmp_path / "e")).all_steps() == [7]
    # the state's own step, as the reference's pytree carries it
    assert restore_latest(str(tmp_path / "e"), state).step == state.step
    assert restore_latest(str(tmp_path / "missing"), state) is None


@pytest.fixture(scope="module")
def flax_resnet18():
    """Seeded flax ResNet-18/CIFAR variables (numpy leaves): the init's
    shapes, drawn from numpy (no compile), with moved BN stats."""
    import jax
    import jax.numpy as jnp

    from cpd_tpu.models import resnet18_cifar

    shapes = jax.eval_shape(lambda k: resnet18_cifar().init(
        k, jnp.zeros((2, 32, 32, 3)), train=False), jax.random.PRNGKey(5))
    rng = np.random.RandomState(0)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['var']"):
            return (1 + rng.rand(*s.shape)).astype(np.float32)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) * np.sqrt(2 / fan_in)).astype(
                np.float32)
        if name.endswith("['scale']"):
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_reference_weights_import_and_export_bitwise(flax_resnet18,
                                                      tmp_path):
    from cpd_tpu.interop import (export_reference_resnet18_cifar,
                                 import_reference_resnet18_cifar,
                                 save_torch_checkpoint)
    from cpd_tpu_torch.models.resnet_cifar import resnet18_cifar

    path = str(tmp_path / "ref.pth")
    save_torch_checkpoint(export_reference_resnet18_cifar(flax_resnet18),
                          path)
    want = interop.load_jax_resnet_cifar(resnet18_cifar(device="cpu"),
                                         flax_resnet18)
    got = interop.import_reference_resnet18_cifar(
        resnet18_cifar(device="cpu"),
        interop.load_reference_checkpoint(path))
    for (k, a), b in zip(want.state_dict().items(),
                         got.state_dict().values()):
        _bitwise(a.numpy(), b.numpy(), k)

    out = str(tmp_path / "port.pth")
    interop.save_torch_checkpoint(
        interop.export_reference_resnet18_cifar(got), out)
    sd = torch.load(out, weights_only=True)["state_dict"]
    back = import_reference_resnet18_cifar(sd)
    for coll in ("params", "batch_stats"):
        import jax

        w = jax.tree_util.tree_flatten_with_path(flax_resnet18[coll])[0]
        g = dict((jax.tree_util.keystr(p), v) for p, v in
                 jax.tree_util.tree_flatten_with_path(back[coll])[0])
        assert len(w) == len(g)
        for p, v in w:
            _bitwise(v, g[jax.tree_util.keystr(p)], jax.tree_util.keystr(p))
    assert int(sd["conv1.1.num_batches_tracked"]) == 0
    # DDP's prefix and the bare and "model" wrappers load alike
    torch.save({"model": {"module." + k: v for k, v in sd.items()}},
               str(tmp_path / "ddp.pth"))
    again = interop.load_reference_checkpoint(str(tmp_path / "ddp.pth"))
    assert set(again) == set(sd)
    with pytest.raises(KeyError, match="does not match"):
        interop.import_reference_resnet18_cifar(
            resnet18_cifar(device="cpu"), {"fc.weight": sd["fc.weight"]})


def test_cli_evaluate_init_from_torch_matches_jax_cli(flax_resnet18,
                                                      tmp_path):
    from cpd_tpu.interop import (export_reference_resnet18_cifar,
                                 save_torch_checkpoint)
    from resnet18_cifar.train import main as jmain

    path = str(tmp_path / "ref.pth")
    save_torch_checkpoint(export_reference_resnet18_cifar(flax_resnet18),
                          path)
    argv = ["-e", "--init-from-torch", path, "--data-root", FIXTURE]
    with contextlib.redirect_stdout(io.StringIO()):
        want = jmain(argv + ["--save_path", str(tmp_path / "j")])
    text = io.StringIO()
    exported = str(tmp_path / "out.pth")
    with contextlib.redirect_stdout(text):
        got = tcli.run(tcli.parse_args(argv + [
            "--save_path", str(tmp_path / "t"), "--export-torch",
            exported]), device="cpu", world=8)
    assert "=> imported torch checkpoint" in text.getvalue()
    assert "Prec@1" in text.getvalue()
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert abs(got["top1"] - want["top1"]) <= 1 / 200
    assert abs(got["top5"] - want["top5"]) <= 1 / 200
    # -e with --export-torch writes the weights it evaluated
    ref = interop.load_reference_checkpoint(path)
    out = interop.load_reference_checkpoint(exported)
    assert set(out) == set(ref)
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            # the reference writes a (1,) zero, torch's BatchNorm a 0-d one
            assert int(v) == int(out[k]) == 0
        else:
            _bitwise(v.numpy(), out[k].numpy(), k)
    with pytest.raises(SystemExit, match="exclusive"):
        tcli.parse_args(argv + ["--load-path", "x"])
    with pytest.raises(SystemExit, match="res_cifar only"):
        tcli.parse_args(["--arch", "tiny", "--export-torch", "x.pth"])


def _cli(root, save, iters, *extra) -> dict:
    argv = ["--arch", "tiny", "--mode", "faithful", "--use_APS",
            "--grad_exp", "5", "--grad_man", "2", "--batch_size", "4",
            "--max-iter", str(iters), "--val_freq", "2", "--print_freq",
            "1", "--data-root", root, "--save_path", save, *extra]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = tcli.run(tcli.parse_args(argv), device="cpu", world=2)
    res["printed"] = out.getvalue()
    return res


def _ckpt_arrays(path: str) -> list:
    with np.load(os.path.join(path, "state.npz")) as z:
        return [z[k] for k in sorted(z.files)]


def test_cli_resume_is_the_unbroken_run(tiny_cifar_factory, tmp_path):
    """The unbroken 4-iteration run saves at 2 and 4; its step 2 alone,
    resumed to 4 (both ways), gives its step 4 again.  (The sampler's
    order depends on ``--max-iter``, in the reference too, so every run
    here has the same 4.)"""
    root = tiny_cifar_factory(tmp_path / "data", n_train=40, n_test=8)
    whole = _cli(root, str(tmp_path / "whole"), 4)
    assert whole["step"] == 4
    assert CheckpointManager(str(tmp_path / "whole")).all_steps() == [2, 4]
    for where in ("part", "copy"):
        shutil.copytree(tmp_path / "whole", tmp_path / where)
        shutil.rmtree(tmp_path / where / "4")
        os.remove(tmp_path / where / "meta-4.json")
    resumed = _cli(root, str(tmp_path / "part"), 4)
    assert "=> resumed from iter 2" in resumed["printed"]
    assert "done: 2 iters" in resumed["printed"]
    loaded = _cli(root, str(tmp_path / "fresh"), 4, "--load-path",
                  str(tmp_path / "copy"), "--resume-opt")
    assert "=> loaded" in loaded["printed"]
    want = _ckpt_arrays(str(tmp_path / "whole" / "4"))
    for res, where in ((resumed, "part"), (loaded, "fresh")):
        assert res["step"] == 4
        for k in ("loss", "accuracy"):
            assert res[k] == whole[k], (where, k)
        got = _ckpt_arrays(str(tmp_path / where / "4"))
        assert len(got) == len(want)
        for a, b in zip(want, got):
            _bitwise(a, b, where)
    # --load-path without --resume-opt: the weights, a fresh optimizer
    weights_only = _cli(root, str(tmp_path / "w"), 1, "--load-path",
                        str(tmp_path / "copy"))
    assert weights_only["step"] == 1


def test_eval_step_ranks_tied_logits_by_class_index():
    """Tied logits rank by class index, as the JAX eval step's
    ``argmax`` and ``top_k`` rank them: with a zeroed head every logit
    ties, top-1 is class 0 and top-5 classes 0-4 (``topk`` had left the
    order among ties unspecified, and the CLI's ``-e`` Prec@1 differed
    from the JAX CLI's on such weights)."""
    from cpd_tpu_torch.train import make_eval_step

    model = TinyCNN(device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.fc.weight.zero_()
        model.fc.bias.zero_()
    x = np.random.RandomState(0).rand(40, 32, 32, 3).astype(np.float32)
    y = np.arange(40) % 3
    m = make_eval_step(model, LocalMesh(1, "cpu"))(None, x, y)
    assert float(m["top1"]) == np.float32(np.mean(y == 0))
    assert float(m["top5"]) == 1.0
