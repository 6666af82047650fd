"""The transport ladder and discard-and-retry of the port
(`cpd_tpu_torch/train/step.py`, the ResNet CLI's ``--verify-reduce``)
vs the JAX package's CLI.

* a verified ring step whose wire was corrupted (flip, stale, drop)
  leaves the weights, BN stats, optimizer state and ``state.step``
  BITWISE as they were, and fires again on the retry (the step did not
  advance); ``keep_failed`` applies it all the same;
* the JAX CLI and the port CLI (8 ranks, ``--arch tiny``) run one ring
  argv with ``--verify-reduce --fault-plan wire_flip@2:1``: the same
  updates (``step``), resilience counters and ``=>`` ladder lines, and
  the port's transitions ``[(2, ring, faithful), (3, faithful, ring)]``;
* a reduce that always fails walks the ladder to fp32 and gives up:
  ``main`` returns 3;
* a fast-mode home verifies by agreement only: no ladder, and a wire
  fault planned for it never fires;
* a plan with a kind the port does not execute is refused, naming its
  ROADMAP item;
* one spawn: two gloo processes run the ladder (``wire_flip`` on rank 1)
  and a save under ``--dist``, then resume with ``--load-path
  --resume-opt``; beside them a third process runs the same argv on a
  `LocalMesh` W = 2.  Both runs of both ranks are BITWISE the local
  ones (losses, counters, transitions), the ranks' resynced states
  agree, and every rank restores the same bytes.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from cpd_tpu_torch.examples.resnet18_cifar import train as tcli
from cpd_tpu_torch.parallel.launch import spawn
from test_torch_threads import one_torch_thread  # noqa: F401

LADDER = ["--arch", "tiny", "--mode", "ring", "--use_APS", "--grad_exp",
          "5", "--grad_man", "2", "--batch_size", "2", "--max-iter", "6",
          "--val_freq", "100", "--print_freq", "1", "--verify-reduce",
          "--reduce-retries", "1", "--transport-probation", "2",
          "--fault-plan", "wire_flip@2:1"]


def _bitwise(want, got, msg=""):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype, msg
    np.testing.assert_array_equal(want.reshape(-1).view(np.uint8),
                                  got.reshape(-1).view(np.uint8),
                                  err_msg=msg)


def _arrays(state) -> list:
    from cpd_tpu_torch.parallel.integrity import tensor_leaves

    return [t.detach().numpy().copy() for t in tensor_leaves(state)]


@pytest.mark.parametrize("kind", ["wire_flip", "wire_stale", "wire_drop"])
def test_failed_verified_step_leaves_state_bitwise(kind):
    from cpd_tpu_torch.models.tiny import TinyCNN
    from cpd_tpu_torch.parallel.mesh import LocalMesh
    from cpd_tpu_torch.resilience import FaultPlan
    from cpd_tpu_torch.train import (create_train_state, make_optimizer,
                                     make_train_step, warmup_step_decay)

    plan = FaultPlan.parse(f"{kind}@1:2").wire_schedule(4)
    model = TinyCNN(device="cpu").init_weights(
        torch.Generator().manual_seed(1))
    opt = make_optimizer("lars", warmup_step_decay(0.4, 5, [100]),
                         momentum=0.9, weight_decay=1e-4)
    kw = dict(use_aps=True, grad_exp=5, grad_man=2, mode="ring",
              verify_reduce=True, wire_fault_plan=plan)
    step = make_train_step(model, opt, LocalMesh(4, "cpu"), **kw)
    state = create_train_state(model, opt)
    rng = np.random.RandomState(0)
    batch = lambda: (rng.rand(8, 32, 32, 3).astype(np.float32),  # noqa
                     rng.randint(0, 10, 8))
    state, m = step(state, *batch())
    assert float(m["reduce_ok"]) == 1.0 and state.step == 1
    before = _arrays(state)
    for _ in range(2):      # the fault fires again: the step is still 1
        state, m = step(state, *batch())
        assert float(m["reduce_ok"]) == 0.0 and state.step == 1
        assert state.opt_state.step == 1
        after = _arrays(state)
        assert len(after) == len(before)
        for i, (a, b) in enumerate(zip(before, after)):
            _bitwise(a, b, f"{kind} tensor {i}")
    kept = make_train_step(model, opt, LocalMesh(4, "cpu"),
                           keep_failed=True, **kw)
    state, m = kept(state, *batch())
    assert float(m["reduce_ok"]) == 0.0 and state.step == 2


def _ladder_lines(text: str) -> list:
    return [line for line in text.splitlines() if line.startswith("=>")]


@pytest.fixture(scope="module")
def ladder_runs(tiny_cifar_factory, tmp_path_factory):
    """The JAX CLI and the port CLI on one ladder argv: (result, the
    ``=>`` lines) of each."""
    from resnet18_cifar.train import main as jmain

    base = tmp_path_factory.mktemp("ladder")
    root = tiny_cifar_factory(base / "data", n_train=80, n_test=16)
    out = {}
    for name in ("jax", "torch"):
        err = io.StringIO()
        argv = LADDER + ["--data-root", root, "--save_path",
                         str(base / name)]
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()):
            res = (jmain(argv) if name == "jax" else
                   tcli.run(tcli.parse_args(argv), device="cpu", world=8))
        out[name] = (res, _ladder_lines(err.getvalue()))
    return out


@pytest.mark.parametrize("what", ["step", "resilience", "lines"])
def test_cli_ladder_matches_jax_cli(ladder_runs, what):
    (want, want_lines), (got, got_lines) = (ladder_runs["jax"],
                                            ladder_runs["torch"])
    if what == "step":
        # six batches, two discarded: four updates
        assert got["step"] == want["step"] == 4
        assert not got["diverged"] and not want["diverged"]
    elif what == "resilience":
        assert got["resilience"] == want["resilience"]
        assert {k: v for k, v in got["resilience"].items() if v} == {
            "wire_faults_detected": 2, "reduce_retries": 1,
            "transport_downgrades": 1, "resyncs": 1,
            "transport_upgrades": 1}
        assert got["transport"] == {
            "mode": "ring", "home": "ring",
            "transitions": [(2, "ring", "faithful"),
                            (3, "faithful", "ring")]}
    else:
        assert got_lines == want_lines and len(got_lines) == 3


def _always_failing(monkeypatch):
    """Every verified reduce reports a failure."""
    from cpd_tpu_torch.train import step as tstep

    real = tstep.sum_gradients

    def failing(*args, **kw):
        out = real(*args, **kw)
        if kw.get("verify"):
            red, rep = out
            rep = dict(rep, ok=torch.zeros_like(rep["ok"]))
            return red, rep
        return out

    monkeypatch.setattr(tstep, "sum_gradients", failing)


def test_ladder_gives_up_at_the_fp32_floor(tiny_cifar_factory, tmp_path,
                                           monkeypatch, capsys):
    root = tiny_cifar_factory(tmp_path / "data", n_train=40, n_test=8)
    _always_failing(monkeypatch)
    argv = LADDER[:-2] + ["--max-iter", "8", "--data-root", root,
                          "--save_path", str(tmp_path / "s")]
    assert tcli.main(argv, device="cpu") == 3
    err = capsys.readouterr().err
    assert "fp32 transport floor (iter 1)" in err
    res = tcli.run(tcli.parse_args(argv), device="cpu", world=2)
    assert res["diverged"] and res["step"] == 0
    assert res["transport"]["transitions"] == [(0, "ring", "faithful"),
                                               (0, "faithful", "fp32")]
    assert {k: v for k, v in res["resilience"].items() if v} == {
        "wire_faults_detected": 6, "reduce_retries": 3,
        "transport_downgrades": 2, "resyncs": 2}


def test_fast_home_verifies_by_agreement_only(tiny_cifar_factory, tmp_path,
                                              capsys):
    root = tiny_cifar_factory(tmp_path / "data", n_train=40, n_test=8)
    argv = LADDER + ["--mode", "fast", "--max-iter", "2", "--data-root",
                     root, "--save_path", str(tmp_path / "s")]
    res = tcli.run(tcli.parse_args(argv), device="cpu", world=2)
    assert res["step"] == 2 and "transport" not in res
    assert {k: v for k, v in res["resilience"].items() if v} == {
        "faults_unfired": 1}
    assert float(res["reduce_ok"]) == 1.0
    assert "never fired" in capsys.readouterr().err


@pytest.mark.parametrize("plan,item", [("grad_nan@1", "A10"),
                                       ("wire_flip@1;stall@2", "A10"),
                                       ("kv_flip@1", "A9"),
                                       ("store_torn@1", "A11")])
def test_fault_plan_refuses_unported_kinds(plan, item):
    with pytest.raises(SystemExit, match=f"ROADMAP Queue A, {item}"):
        tcli.parse_args(["--fault-plan", plan])


# -- the process mesh ------------------------------------------------------

WORLD = 2
DIST_LADDER = LADDER[:-1] + ["wire_flip@2:1", "--batch_size", "4",
                             "--val_freq", "2"]


class _Stitched:
    """The global batches of a ``--dist`` run over WORLD processes: each
    process's sampler slice, in rank order."""

    def __init__(self, n, total_iter, batch, world_size=1, rank=0, seed=0,
                 last_iter=-1):
        from cpd_tpu_torch.data import samplers

        self.parts = [samplers.DistributedGivenIterationSampler(
            n, total_iter, batch // WORLD, world_size=WORLD, rank=r,
            seed=seed, last_iter=last_iter) for r in range(WORLD)]

    def batches(self):
        for parts in zip(*(p.batches() for p in self.parts)):
            yield np.concatenate(parts)


def _process(root: str, base: str) -> dict:
    """Ranks 0 and 1: the ladder, then the resume, under ``--dist``.
    Process WORLD: the same two runs on the `LocalMesh` W = 2."""
    import cpd_tpu_torch.data as tdata
    from cpd_tpu_torch.models.tiny import TinyCNN
    from cpd_tpu_torch.parallel.integrity import tensor_leaves
    from cpd_tpu_torch.train import create_train_state, make_optimizer
    from cpd_tpu_torch.train.checkpoint import restore_latest
    from cpd_tpu_torch.train.schedules import warmup_step_decay

    torch.set_num_threads(1)
    local = int(os.environ["RANK"]) == WORLD
    where = os.path.join(base, "local" if local else "dist")
    argv = DIST_LADDER + ["--data-root", root]
    runs = [argv + ["--save_path", os.path.join(where, "a")],
            argv + ["--max-iter", "8", "--load-path",
                    os.path.join(where, "a"), "--resume-opt",
                    "--save_path", os.path.join(where, "b")]]
    if local:
        tdata.DistributedGivenIterationSampler = _Stitched
    out = {"runs": []}
    for run_argv in runs:
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            args = tcli.parse_args(run_argv + ([] if local else [
                "--dist", "--dist-backend", "gloo"]))
            res = tcli.run(args, device="cpu",
                           world=WORLD if local else 1)
        res["lines"] = _ladder_lines(err.getvalue())
        out["runs"].append(res)
    model = TinyCNN(device="cpu")
    opt = make_optimizer("sgd", warmup_step_decay(1.6, 5, [40]),
                         momentum=0.9, weight_decay=1e-4)
    state = restore_latest(os.path.join(where, "b"),
                           create_train_state(model, opt))
    out["restored"] = [t.detach().numpy().copy()
                       for t in tensor_leaves(state)]
    out["restored_step"] = state.step
    return out


@pytest.fixture(scope="module")
def processes(tiny_cifar_factory, tmp_path_factory) -> tuple:
    base = tmp_path_factory.mktemp("dist_ladder")
    root = tiny_cifar_factory(base / "data", n_train=80, n_test=16)
    out = spawn(_process, WORLD + 1, args=(str(root), str(base)),
                timeout=400, env={"WORLD_SIZE": str(WORLD),
                                  "LOCAL_WORLD_SIZE": str(WORLD)})
    return out[:WORLD], out[WORLD]


def test_process_mesh_ladder_runs_are_bitwise_the_local_mesh(processes):
    ranks, local = processes
    first, resumed = local["runs"]
    assert first["step"] == 4 and resumed["step"] == 8
    assert first["transport"]["transitions"] == [(2, "ring", "faithful"),
                                                 (3, "faithful", "ring")]
    assert first["resilience"]["resyncs"] == 1
    for r, res in enumerate(ranks):
        for i, (want, got) in enumerate(zip(local["runs"], res["runs"])):
            for k in ("step", "loss", "accuracy", "diverged", "resilience",
                      "transport", "reduce_ok"):
                assert got[k] == want[k], (r, i, k)
    assert ranks[0]["runs"][0]["lines"] == first["lines"]
    assert len(first["lines"]) == 3 and ranks[1]["runs"][0]["lines"] == []


def test_process_mesh_ranks_restore_the_same_bytes(processes):
    ranks, local = processes
    assert local["restored_step"] == 8
    for r, res in enumerate(ranks):
        assert res["restored_step"] == 8
        assert len(res["restored"]) == len(local["restored"])
        for i, (a, b) in enumerate(zip(local["restored"],
                                       res["restored"])):
            _bitwise(a, b, f"rank {r} tensor {i}")
