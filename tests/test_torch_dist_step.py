"""The train step and the ResNet CLI on the port's process mesh (two
gloo processes, one rank each) vs the `LocalMesh` W = 2, BITWISE.

* two iterations of the ResNet-18 CLI under ``--dist --dist-backend
  gloo`` (full width, batch 4 a rank, the synthetic-format CIFAR tree of
  `tests/test_torch_train.py`'s CLI test): the last loss, accuracy and
  rank 0's validation equal ``run(world=2)`` fed the same global
  batches — the two processes' samplers' slices in rank order, the JAX
  trainer's per-host schedule — and rank 1 prints nothing;
* two `make_train_step` steps of the tiny CNN (`models/tiny.py`, loaded
  with flax's initial weights by `interop.load_jax_tiny`): plain, at
  ``emulate_node`` 2 with LARS and the SR ring, and at ``emulate_node`` 2
  with SGD and the wire's health counters.  Each process is handed its
  own rows of the global batch (`parallel.dist.local_rows`); its losses,
  metrics, weights, BN stats and momentum buffers equal those of the
  `LocalMesh` W = 2 step on the global batch;
* two `make_lm_train_step` steps of the tiny LM (fp32 FFN, the plain
  GQA flash kernels, seeded weights): plain with SGD, and at
  ``emulate_node`` 2 on the SR ring with AdamW and the health counters;
  each process handed its own rows; losses, metrics, weights and
  optimizer state equal the `LocalMesh` W = 2 step's;
* two iterations of the LM CLI under ``--dist --dist-backend gloo``
  (``--emulate_node 2 --optimizer adamw --mode ring``): the last loss,
  accuracy and validation equal ``--dp 2`` on one process, and rank 1
  prints nothing;
* an ``nccl`` mesh asked for where there is no card raises.

One spawn runs all of it: the two ranks, and beside them a third
process outside their group that computes the `LocalMesh` W = 2
references at the same time, in a fresh interpreter as the ranks are
(one thread in all three, so the CPU kernels split their work alike).
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from cpd_tpu_torch.parallel.launch import spawn

WORLD, PER_RANK = 2, 4
# name -> make_train_step keywords and the optimizer
ARMS = {
    "plain": dict(emulate_node=1, mode="faithful", opt="sgd"),
    "emulate-lars-sr-ring": dict(emulate_node=2, mode="ring", opt="lars",
                                 grad_rounding="stochastic", grad_seed=5),
    "emulate-sgd-stats": dict(emulate_node=2, mode="faithful", opt="sgd",
                              quant_stats=True),
}
# the LM arms: make_lm_train_step keywords and the optimizer
LM_ARMS = {
    "lm-plain": dict(emulate_node=1, mode="faithful", opt="sgd"),
    "lm-emulate-adamw-sr-ring": dict(emulate_node=2, mode="ring",
                                     opt="adamw",
                                     grad_rounding="stochastic",
                                     grad_seed=5, quant_stats=True),
}
LM_TINY = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=4,
               n_kv_heads=2, d_ff=64, attn_impl="flash", flash_bwd="pallas")
LM_ARGV = ["--vocab-size", "64", "--d-model", "32", "--n-layers", "1",
           "--n-heads", "4", "--n-kv-heads", "2", "--seq-len", "16",
           "--batch-size", "2", "--attn-impl", "flash", "--flash-bwd",
           "pallas", "--use_APS", "--grad_exp", "5", "--grad_man", "2",
           "--max-iter", "2", "--print-freq", "1", "--emulate_node", "2",
           "--optimizer", "adamw", "--mode", "ring"]
CLI_ARGV = ["--mode", "ring", "--use_APS", "--grad_exp", "5", "--grad_man",
            "2", "--max-iter", "2", "--batch_size", "4", "--print_freq",
            "1", "--val_freq", "2"]


def _two_steps(variables, arm: dict, mesh) -> dict:
    """Two steps of ``arm`` on ``mesh`` from flax's weights: metrics per
    step, the state dict and the momentum buffers after."""
    from cpd_tpu_torch.data import CIFAR10Pipeline, synthetic_cifar10
    from cpd_tpu_torch.interop import load_jax_tiny
    from cpd_tpu_torch.models.tiny import TinyCNN
    from cpd_tpu_torch.parallel.dist import local_rows
    from cpd_tpu_torch.train import (create_train_state, make_optimizer,
                                     make_train_step, warmup_step_decay)

    arm = dict(arm)
    opt_name = arm.pop("opt")
    model = load_jax_tiny(TinyCNN(device="cpu"), variables)
    opt = make_optimizer(opt_name, warmup_step_decay(0.4, 5, [100],
                                                     warmup_from=0.1),
                         momentum=0.9, weight_decay=1e-4)
    step = make_train_step(model, opt, mesh, use_aps=True, grad_exp=5,
                           grad_man=2, **arm)
    state = create_train_state(model, opt)
    rows = WORLD * PER_RANK * arm["emulate_node"]
    x, y, _, _ = synthetic_cifar10(2 * rows, 8, seed=4)
    pipe = CIFAR10Pipeline(x, y, rows, augment=False)
    metrics = []
    for it in range(2):
        bx, by = pipe.batch(np.arange(it * rows, (it + 1) * rows))
        state, m = step(state, local_rows(bx, mesh), local_rows(by, mesh))
        metrics.append({k: v.numpy().copy() for k, v in m.items()})
    return dict(metrics=metrics,
                state={k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()},
                momentum=[b.numpy().copy()
                          for b in state.opt_state.momentum_buf])


def _lm_two_steps(arm: dict, mesh) -> dict:
    """Two steps of the LM ``arm`` on ``mesh`` from seeded weights, each
    process handed its rows of the global batch: metrics per step, the
    state dict and every optimizer-state tensor after."""
    from cpd_tpu_torch.models import transformer_lm
    from cpd_tpu_torch.parallel.dist import local_rows
    from cpd_tpu_torch.train import (create_train_state, make_optimizer,
                                     warmup_step_decay)
    from cpd_tpu_torch.train.lm import make_lm_train_step

    arm = dict(arm)
    opt_name = arm.pop("opt")
    model = transformer_lm(**LM_TINY, device="cpu").init_weights(
        torch.Generator().manual_seed(7))
    opt = make_optimizer(opt_name, warmup_step_decay(0.05, 2, [8],
                                                     warmup_from=0.02),
                         momentum=0.9)
    step = make_lm_train_step(model, opt, mesh, use_aps=True, grad_exp=5,
                              grad_man=2, **arm)
    state = create_train_state(model, opt)
    rng = np.random.RandomState(5)
    metrics = []
    for _ in range(2):
        x = rng.randint(0, 64, (WORLD * 2 * arm["emulate_node"], 17))
        state, m = step(state, local_rows(x[:, :-1], mesh),
                        local_rows(x[:, 1:], mesh))
        metrics.append({k: v.numpy().copy() for k, v in m.items()})
    return dict(metrics=metrics,
                state={k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()},
                momentum=[t.numpy().copy() for f in state.opt_state
                          if isinstance(f, list) for t in f])


class _Stitched:
    """The global batches of a ``--dist`` run over WORLD processes: each
    process's `DistributedGivenIterationSampler` slice, in rank order
    (what the JAX trainer's ``host_batch_to_global`` assembles), with the
    single-process sampler's signature."""

    def __init__(self, n, total_iter, batch, world_size=1, rank=0, seed=0,
                 last_iter=-1):
        from cpd_tpu_torch.data import samplers

        self.parts = [samplers.DistributedGivenIterationSampler(
            n, total_iter, batch // WORLD, world_size=WORLD, rank=r,
            seed=seed, last_iter=last_iter) for r in range(WORLD)]

    def batches(self):
        for parts in zip(*(p.batches() for p in self.parts)):
            yield np.concatenate(parts)


def _process(variables, root: str) -> dict:
    """Ranks 0 and 1: the ``--dist`` CLI, which joins the gloo group from
    torchrun's variables, then the train steps on the group's
    `ProcessMesh`.  Process WORLD, outside the group: the `LocalMesh`
    W = 2 references of both."""
    import cpd_tpu_torch.data as tdata
    from cpd_tpu_torch.examples.lm import train as lcli
    from cpd_tpu_torch.examples.resnet18_cifar import train as tcli
    from cpd_tpu_torch.parallel.mesh import LocalMesh, ProcessMesh

    torch.set_num_threads(1)
    local = int(os.environ["RANK"]) == WORLD
    argv = CLI_ARGV + ["--data-root", root, "--save_path", os.path.join(
        root, "ckpt_local" if local else "ckpt_dist")]
    if local:
        tdata.DistributedGivenIterationSampler = _Stitched
        with contextlib.redirect_stdout(io.StringIO()):
            cli = tcli.run(tcli.parse_args(argv), device="cpu", world=WORLD)
        with contextlib.redirect_stdout(io.StringIO()):
            lm_cli = lcli.run(lcli.parse_args(LM_ARGV + ["--dp",
                                                         str(WORLD)]),
                              device="cpu")
        mesh = LocalMesh(WORLD, "cpu")
        return {"cli": cli, "lm_cli": lm_cli,
                "steps": {n: _two_steps(variables, a, mesh)
                          for n, a in ARMS.items()},
                "lm_steps": {n: _lm_two_steps(a, mesh)
                             for n, a in LM_ARMS.items()}}
    text, lm_text = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(text):
        cli = tcli.run(tcli.parse_args(argv + ["--dist", "--dist-backend",
                                               "gloo"]), device="cpu")
    mesh = ProcessMesh("cpu")
    with contextlib.redirect_stdout(lm_text):
        lm_cli = lcli.run(lcli.parse_args(LM_ARGV + [
            "--dist", "--dist-backend", "gloo"]), device="cpu")
    return {"cli": cli, "printed": text.getvalue(), "lm_cli": lm_cli,
            "lm_printed": lm_text.getvalue(),
            "steps": {n: _two_steps(variables, a, mesh)
                      for n, a in ARMS.items()},
            "lm_steps": {n: _lm_two_steps(a, mesh)
                         for n, a in LM_ARMS.items()}}


@pytest.fixture(scope="module")
def processes(tiny_cifar_factory, tmp_path_factory) -> tuple:
    """(the two ranks' results, the references)."""
    import jax
    import jax.numpy as jnp

    from cpd_tpu.models import tiny as jtiny

    root = tiny_cifar_factory(tmp_path_factory.mktemp("cifar"), n_train=40,
                              n_test=8)
    variables = jax.device_get(jax.jit(lambda k: jtiny.TinyCNN().init(
        k, jnp.zeros((2, 32, 32, 3)), train=False))(jax.random.PRNGKey(3)))
    out = spawn(_process, WORLD + 1, args=(variables, str(root)),
                timeout=400, env={"WORLD_SIZE": str(WORLD),
                                  "LOCAL_WORLD_SIZE": str(WORLD)})
    return out[:WORLD], out[WORLD]


def _bitwise(want, got, msg=""):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype, msg
    np.testing.assert_array_equal(want.reshape(-1).view(np.uint8),
                                  got.reshape(-1).view(np.uint8),
                                  err_msg=msg)


@pytest.mark.parametrize("arm", list(ARMS))
def test_two_process_steps_are_bitwise_the_local_mesh(arm, processes):
    ranks, local = processes
    want = local["steps"][arm]
    for r, res in enumerate(ranks):
        got = res["steps"][arm]
        for s, (wm, gm) in enumerate(zip(want["metrics"], got["metrics"])):
            assert set(wm) == set(gm)
            for k in wm:
                _bitwise(wm[k], gm[k], f"rank {r} step {s} {k}")
        for k, v in want["state"].items():
            _bitwise(v, got["state"][k], f"rank {r} {k}")
        for i, (a, b) in enumerate(zip(want["momentum"], got["momentum"])):
            _bitwise(a, b, f"rank {r} momentum {i}")
    m = want["metrics"][-1]
    assert np.isfinite(m["loss"])
    if arm == "emulate-sgd-stats":
        n_params = sum(v.size for k, v in want["state"].items()
                       if "running" not in k and "num_batches" not in k)
        assert float(m["prec_wire_total"]) == WORLD * n_params


@pytest.mark.parametrize("arm", list(LM_ARMS))
def test_two_process_lm_steps_are_bitwise_the_local_mesh(arm, processes):
    ranks, local = processes
    want = local["lm_steps"][arm]
    for r, res in enumerate(ranks):
        got = res["lm_steps"][arm]
        for s, (wm, gm) in enumerate(zip(want["metrics"], got["metrics"])):
            assert set(wm) == set(gm)
            for k in wm:
                _bitwise(wm[k], gm[k], f"rank {r} step {s} {k}")
        for k, v in want["state"].items():
            _bitwise(v, got["state"][k], f"rank {r} {k}")
        assert len(want["momentum"]) == len(got["momentum"]) > 0
        for i, (a, b) in enumerate(zip(want["momentum"], got["momentum"])):
            _bitwise(a, b, f"rank {r} optimizer tensor {i}")
    m = want["metrics"][-1]
    assert np.isfinite(m["loss"])
    if "quant_stats" in LM_ARMS[arm]:
        assert float(m["prec_wire_total"]) == WORLD * sum(
            v.size for v in want["state"].values())


def test_lm_cli_under_dist_matches_run_dp_2(processes):
    ranks, local = processes
    want = local["lm_cli"]
    assert want["step"] == 2 and not want["diverged"]
    for r, res in enumerate(ranks):
        got = res["lm_cli"]
        for k in ("step", "loss", "accuracy", "diverged", "val"):
            assert got[k] == want[k], (r, k)
    assert "Iter: [2/2]" in ranks[0]["lm_printed"]
    assert "Val [2]" in ranks[0]["lm_printed"]
    assert ranks[1]["lm_printed"] == ""


def test_cli_under_dist_matches_run_world_2(processes):
    ranks, local = processes
    want = local["cli"]
    assert want["step"] == 2 and not want["diverged"]
    for r, res in enumerate(ranks):
        got = res["cli"]
        for k in ("step", "loss", "accuracy", "diverged"):
            assert got[k] == want[k], (r, k)
    assert ranks[0]["cli"]["best_prec1"] == want["best_prec1"]
    assert "Iter: [2/2]" in ranks[0]["printed"]
    assert "Prec@1" in ranks[0]["printed"]
    assert ranks[1]["printed"] == ""


def test_cli_dist_flag_and_nccl_without_cards(monkeypatch, tmp_path):
    """``--dist`` parses and is no longer refused; asking for nccl where
    the machine has no card (here: no CUDA at all, or one card for two
    local ranks) raises before any rendezvous."""
    from cpd_tpu_torch.examples.resnet18_cifar import train as tcli
    from cpd_tpu_torch.parallel.dist import dist_init

    args = tcli.parse_args(["--dist", "--max-iter", "1"])
    assert args.dist and args.dist_backend == "nccl"
    assert tcli.parse_args(["--dist", "--dist-backend", "gloo"]
                           ).dist_backend == "gloo"
    assert "--dist" not in tcli._NOT_PORTED
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NVIDIA card"):
            tcli.run(args, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one rank per card"):
        dist_init("nccl", init_method=f"file://{tmp_path}/store")
    assert not torch.distributed.is_initialized()


def test_mean_stats_is_each_buffers_own_mean():
    """The BN means taken in one collective per dtype are bitwise each
    buffer's own `mesh.mean`, int64 counters included."""
    from cpd_tpu_torch.parallel.mesh import LocalMesh
    from cpd_tpu_torch.train.step import mean_stats

    mesh = LocalMesh(3, "cpu")
    gen = torch.Generator().manual_seed(0)
    new_stats = [[torch.randn(5, generator=gen),
                  torch.randn(2, 3, generator=gen) * 1e3,
                  torch.tensor(7 + r), torch.randn(1, generator=gen)]
                 for r in range(3)]
    got = mean_stats(new_stats, mesh)
    for j in range(4):
        want = mesh.mean([ns[j] for ns in new_stats])[0]
        _bitwise(want.numpy(), got[j].numpy(), f"buffer {j}")
