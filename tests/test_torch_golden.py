"""The golden APS ordering on the port (`cpd_tpu_torch.examples.aps_golden`).

The default tier holds the port's three config tables to the reference's
(`examples/aps_golden.py`) and runs its three check functions, beside
the reference's, on canned results on both sides of every margin (a
diverged or NaN arm too): the same check lines, the same verdicts.

Marked ``slow`` as tests/test_golden.py is (training runs; not in the
default tier):

* the CIFAR arm at tests/test_golden.py's settings: e3m4 gradients, the
  tiny CNN, 8 `LocalMesh` ranks x ``--emulate_node 2`` x batch 8, 100
  iterations in fast mode, on the learnable synthetic CIFAR set with
  fixed seeds.  Without APS the 16-rank emulated sum underflows and
  accuracy stalls; APS recovers it (~45 s on the CPU);
* the optimizer arm at the same settings (the e4m3 momentum buffer
  naive, Kahan-compensated and SR against fp32) under
  `check_opt_ordering`, and the LM arm at tests/test_golden.py's LM
  settings (the 2-layer LM on ``--dp 8``, 120 iterations) with its fp32
  arm under `check_lm_ordering`.

On the card the CIFAR arm is `chip_smoke.py`'s phase 13c.
"""

import math

import pytest

from cpd_tpu_torch.examples import aps_golden as tgold


def _reference():
    import aps_golden  # examples/ is on the path (tests/conftest.py)

    return aps_golden


def _tuples(configs) -> list:
    """A config table with its flag lists as tuples."""
    return [tuple(tuple(v) if isinstance(v, list) else v for v in c)
            for c in configs]


def test_config_tables_are_the_reference_tables():
    ref = _reference()
    assert tgold.CONFIGS == ref.CONFIGS
    assert _tuples(tgold.OPT_CONFIGS) == _tuples(ref.OPT_CONFIGS)
    assert tgold.LM_CONFIGS == ref.LM_CONFIGS
    assert tgold.WORLD == 8


def _opt(fp32, naive, kahan, sr=None):
    out = {"opt_fp32": {"prec1": fp32}, "opt_e4m3_naive": {"prec1": naive},
           "opt_e4m3_kahan": {"prec1": kahan}}
    if sr is not None:
        out["opt_e4m3_sr"] = {"prec1": sr}
    return out


def _lm(fp32, noaps, aps, sr=None, diverged=()):
    losses = {"lm_fp32": fp32, "lm_e3m4_noaps": noaps, "lm_e3m4_aps": aps}
    if sr is not None:
        losses["lm_e3m4_sr_noaps"] = sr
    return {k: {"loss": v, "diverged": k in diverged}
            for k, v in losses.items()}


@pytest.mark.parametrize("results", [
    _opt(95.0, 92.0, 94.5), _opt(95.0, 92.0, 94.5, sr=93.5),
    _opt(95.0, 94.0, 94.5, sr=94.0), _opt(97.0, 92.0, 93.0, sr=80.0)])
def test_check_opt_ordering_is_the_reference_check(results):
    assert tgold.check_opt_ordering(results) == \
        _reference().check_opt_ordering(results)
    assert tgold.check_opt_ordering(results, margin=0.1, recover=5.0) == \
        _reference().check_opt_ordering(results, margin=0.1, recover=5.0)


@pytest.mark.parametrize("results", [
    _lm(2.6, 4.1, 2.7), _lm(2.6, 4.1, 2.7, sr=2.72),
    _lm(2.6, 3.0, 2.8, sr=3.5), _lm(2.6, math.nan, 2.7),
    _lm(2.6, 4.1, 2.7, diverged=("lm_e3m4_noaps",)),
    _lm(2.6, 4.1, 2.7, sr=2.9, diverged=("lm_e3m4_aps",))])
def test_check_lm_ordering_is_the_reference_check(results):
    assert tgold.check_lm_ordering(results) == \
        _reference().check_lm_ordering(results)


@pytest.mark.parametrize("results", [
    {"fp32": {"prec1": 90.0}, "e3m4_noaps": {"prec1": 30.0},
     "e3m4_aps": {"prec1": 88.0}, "e3m4_sr_noaps": {"prec1": 70.0}},
    {"fp32": {"prec1": 90.0}, "e4m3_noaps": {"prec1": 89.0},
     "e4m3_aps": {"prec1": 90.0}, "e3m4_noaps": {"prec1": 30.0},
     "e3m4_aps": {"prec1": 80.0}}])
def test_check_ordering_is_the_reference_check(results):
    assert tgold.check_ordering(results) == \
        _reference().check_ordering(results)


@pytest.mark.slow
def test_aps_recovers_low_precision_accuracy_on_the_port():
    configs = [("e3m4_noaps", 3, 4, False), ("e3m4_aps", 3, 4, True)]
    results = tgold.run_experiment(iters=100, batch_size=8,
                                   configs=configs, device="cpu")
    noaps = results["e3m4_noaps"]["prec1"]
    aps = results["e3m4_aps"]["prec1"]
    assert aps >= noaps + 10.0, (noaps, aps)
    assert aps >= 60.0, aps
    assert not any(r["diverged"] for r in results.values())
    # check_ordering wants an fp32 arm; the APS arm stands in for it,
    # so its gain check (aps >= noaps + 2) is the one that bites
    checks = tgold.check_ordering(dict(results, fp32={"prec1": aps}))
    assert checks and not any("VIOLATED" in c for c in checks), checks


@pytest.mark.slow
def test_optimizer_and_lm_arms_on_the_port():
    opt = tgold.run_opt_experiment(iters=100, batch_size=8, device="cpu")
    checks = tgold.check_opt_ordering(opt)
    lm = tgold.run_lm_experiment(iters=120, configs=tgold.LM_CONFIGS[:3],
                                 device="cpu")
    checks += tgold.check_lm_ordering(lm)
    assert lm["lm_e3m4_aps"]["loss"] <= 3.5, lm
    assert checks and not any("VIOLATED" in c for c in checks), checks
