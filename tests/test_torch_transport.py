"""The transport ladder's host state and the fault-plan grammar of the
port (`cpd_tpu_torch/resilience/`, `cpd_tpu_torch/train/metrics.py`) vs
the JAX package's (`cpd_tpu/resilience/transport.py`, `inject.py`,
`cpd_tpu/train/metrics.py`): EXACT.

* `TransportSupervisor`: for each home rung and several (retries,
  probation), seeded numpy sequences of failures and successes give the
  reference's actions, ``mode``, ``degraded``, ``home`` and
  ``transitions``, the transition cap included; the constructor's
  errors; the state machine of `tests/test_resilience.py`.
* `level_reduce_kwargs` is the reference's on every rung; `StepTable`
  builds each rung once.
* `FaultPlan`: the plan strings of `tests/test_resilience.py` parse to
  the reference's specs; `to_json` text, `random(seed, n)`,
  `wire_schedule` and `counts` equal the reference's; the grammar's errors; `report_unfired`'s wire accounting.
* `ResilienceMeter`: the reference's fields and ``suffix``.
"""

import numpy as np
import pytest

from cpd_tpu.resilience import inject as jinject
from cpd_tpu.resilience import transport as jtransport
from cpd_tpu.train import metrics as jmetrics
from cpd_tpu_torch.resilience import inject as tinject
from cpd_tpu_torch.resilience import transport as ttransport
from cpd_tpu_torch.train import metrics as tmetrics


def _view(sup) -> tuple:
    return (sup.mode, sup.home, sup.degraded, sup.retries, sup.clean,
            list(sup.transitions))


@pytest.mark.parametrize("home", ["ring", "faithful", "fp32"])
@pytest.mark.parametrize("retries,probation", [(0, 1), (1, 2), (2, 3),
                                               (3, 8)])
def test_supervisor_sequences_match_reference(home, retries, probation):
    """400 seeded outcomes, failure rate 0.3: every action and the whole
    state after it equal the reference's (a give-up is an outcome like
    any other: the reference supervisor stays usable after it)."""
    rng = np.random.RandomState(
        100 * ttransport.TransportSupervisor.LEVELS.index(home)
        + 10 * retries + probation)
    ref = jtransport.TransportSupervisor(home, retries, probation)
    got = ttransport.TransportSupervisor(home, retries, probation)
    for step, fail in enumerate(rng.random_sample(400) < 0.3):
        if fail:
            want_action = ref.on_failure(step)
            assert got.on_failure(step) == want_action, step
        else:
            want_action = ref.on_success(step)
            assert got.on_success(step) == want_action, step
        assert _view(got) == _view(ref), step
    assert got.LEVELS == ref.LEVELS


def test_supervisor_transition_cap_and_errors(monkeypatch):
    for mod in (jtransport, ttransport):
        monkeypatch.setattr(mod.TransportSupervisor, "TRANSITION_CAP", 5)
    ref = jtransport.TransportSupervisor("ring", 0, 1)
    got = ttransport.TransportSupervisor("ring", 0, 1)
    for step in range(40):
        fn = "on_failure" if step % 2 == 0 else "on_success"
        assert getattr(got, fn)(step) == getattr(ref, fn)(step)
        assert got.transitions == ref.transitions
    assert len(got.transitions) == 5
    for kw, match in ((dict(start="torus"), "unknown transport level"),
                      (dict(max_retries=-1), "max_retries"),
                      (dict(probation=0), "probation")):
        with pytest.raises(ValueError, match=match):
            jtransport.TransportSupervisor(**kw)
        with pytest.raises(ValueError, match=match):
            ttransport.TransportSupervisor(**kw)


def test_supervisor_state_machine():
    """`tests/test_resilience.py::test_transport_supervisor_state_machine`
    on the port."""
    sup = ttransport.TransportSupervisor(start="ring", max_retries=2,
                                         probation=3)
    assert sup.mode == "ring" and not sup.degraded
    assert [sup.on_failure(4) for _ in range(3)] == ["retry", "retry",
                                                     "downgrade"]
    assert sup.mode == "faithful" and sup.degraded
    assert [sup.on_success(s) for s in (5, 6, 7)] == [None, None,
                                                      "upgrade"]
    assert sup.mode == "ring"
    sup2 = ttransport.TransportSupervisor(start="ring", max_retries=0,
                                          probation=2)
    assert sup2.on_failure(1) == "downgrade"
    assert sup2.on_success(2) is None
    assert sup2.on_failure(3) == "downgrade"
    assert sup2.mode == "fp32" and sup2.on_failure(4) == "give_up"
    assert sup2.transitions == [(1, "ring", "faithful"),
                                (3, "faithful", "fp32")]
    sup3 = ttransport.TransportSupervisor(start="faithful", max_retries=0,
                                          probation=1)
    assert sup3.on_success(1) is None and sup3.mode == "faithful"


@pytest.mark.parametrize("level", ["ring", "faithful", "fp32", "torus"])
def test_level_reduce_kwargs_match_reference(level):
    for fmt in ((5, 2), (4, 3), (8, 23)):
        if level == "torus":
            with pytest.raises(ValueError, match="unknown transport level"):
                ttransport.level_reduce_kwargs(level, *fmt)
            continue
        assert ttransport.level_reduce_kwargs(level, *fmt) == \
            jtransport.level_reduce_kwargs(level, *fmt)


def test_step_table_builds_each_rung_once():
    built = []
    table = ttransport.StepTable(lambda lv: built.append(lv) or
                                 (lambda: lv))
    for lv in ("ring", "faithful", "ring", "fp32", "faithful", "ring"):
        assert table[lv]() == lv
    assert built == ["ring", "faithful", "fp32"]
    assert "anything" in table


PLANS = ["grad_nan@3;stall@5:1.5, ckpt_truncate@8",
         "grad_inf@2:1;loss_spike@7:1e6",
         "grad_nan@1;grad_blowup@3:2;stall@2",
         "wire_flip@4:2;wire_stale@7;wire_drop@9:5",
         "stall@50;grad_nan@60;wire_flip@70:1;loss_spike@2:10",
         "wire_flip@2:1;wire_drop@99", "wire_flip@2:1",
         "host_kill@3:1:4;straggler@5:0:3.5;link_flaky@6:2",
         "sat_pressure@1;sat_pressure@2:12;kv_flip@3:1;engine_kill@4",
         "store_torn@1:10;store_eio@2:3;req_burst@5:4", ""]


def _specs(plan) -> list:
    return [(f.step, f.kind, f.arg, f.arg2) for f in plan.faults]


@pytest.mark.parametrize("text", PLANS)
def test_plan_matches_reference(text, tmp_path):
    ref = jinject.FaultPlan.parse(text, seed=9)
    got = tinject.FaultPlan.parse(text, seed=9)
    assert _specs(got) == _specs(ref) and got.seed == ref.seed
    assert got.to_json() == ref.to_json()
    assert got.counts() == ref.counts()
    for name in ("grad_faults", "wire_faults", "sat_faults", "kv_faults",
                 "serve_faults", "fleet_faults", "elastic_faults",
                 "store_faults"):
        assert [(f.step, f.kind, f.arg) for f in getattr(got, name)()] == \
            [(f.step, f.kind, f.arg) for f in getattr(ref, name)()], name
    assert {s: _specs(tinject.FaultPlan(tuple(v)))
            for s, v in got.host_faults().items()} == \
        {s: _specs(jinject.FaultPlan(tuple(v)))
         for s, v in ref.host_faults().items()}
    for n in (1, 5, 10, 100):
        for a, b in zip(got.wire_schedule(n), ref.wire_schedule(n)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    assert tinject.FaultPlan.from_json(ref.to_json()) == got
    path = tmp_path / "plan.json"
    path.write_text(got.to_json())
    assert tinject.FaultPlan.parse(str(path)) == got


def test_plan_random_and_errors_match_reference():
    for seed, n in ((123, 200), (124, 200), (7, 50)):
        assert _specs(tinject.FaultPlan.random(seed, n)) == \
            _specs(jinject.FaultPlan.random(seed, n))
    rates = {"wire_flip": 0.1, "stall": 0.05}
    assert _specs(tinject.FaultPlan.random(3, 80, rates)) == \
        _specs(jinject.FaultPlan.random(3, 80, rates))
    for bad, match in (("gremlins@3", "unknown fault kind"),
                       ("grad_nan3", "bad fault spec"),
                       ("wire_flip@2:1:3", "arg2 only exists")):
        with pytest.raises(ValueError, match=match):
            jinject.FaultPlan.parse(bad)
        with pytest.raises(ValueError, match=match):
            tinject.FaultPlan.parse(bad)
    with pytest.raises(ValueError, match="step must be"):
        tinject.FaultSpec(-1, "wire_flip")
    assert tinject.FaultPlan.parse("") == tinject.FaultPlan()


def test_report_unfired_wire_accounting(capsys):
    """The wire part of `report_unfired`: specs past the run, every wire
    spec on a run whose home is not the ring, and every kind the port
    does not execute; the meter's ``faults_unfired``."""
    plan = tinject.FaultPlan.parse("wire_flip@2:1;wire_drop@99")
    ref = jinject.FaultPlan.parse("wire_flip@2:1;wire_drop@99")
    for armed in (True, False):
        want = jinject.report_unfired(jinject.Injector(ref), n_steps=10,
                                      rank=0, wire_armed=armed)
        got = tinject.report_unfired(plan, n_steps=10, rank=0,
                                     wire_armed=armed)
        assert _specs(tinject.FaultPlan(tuple(got))) == \
            _specs(jinject.FaultPlan(tuple(want)))
    meter = tmetrics.ResilienceMeter()
    left = tinject.report_unfired(
        tinject.FaultPlan.parse("stall@1;wire_flip@70:1;wire_stale@3"),
        n_steps=10, meter=meter, rank=0)
    assert [f.kind for f in left] == ["stall", "wire_flip"]
    assert meter["faults_unfired"] == 2 and "unfired 2" in meter.suffix()
    assert "never fired" in capsys.readouterr().err
    assert tinject.report_unfired(None) == []
    assert tinject.not_ported_kinds(tinject.FaultPlan.parse(
        "wire_flip@1;grad_nan@2;kv_flip@3;store_eio@4")) == {
        "grad_nan": "A10", "kv_flip": "A9", "store_eio": "A11"}


def test_resilience_meter_matches_reference():
    ref, got = jmetrics.ResilienceMeter(), tmetrics.ResilienceMeter()
    assert got.FIELDS == ref.FIELDS and got.as_dict() == ref.as_dict()
    assert got.suffix() == ref.suffix() == ""
    for field in ("wire_faults_detected", "reduce_retries",
                  "transport_downgrades", "resyncs", "transport_upgrades",
                  "wire_faults_detected", "faults_unfired"):
        ref.bump(field)
        got.bump(field)
        assert got.suffix() == ref.suffix()
    for m in (ref, got):
        m.observe_metrics({"guard_skipped": 3.0, "loss": 1.0})
    assert got.as_dict() == ref.as_dict() and got.suffix() == ref.suffix()
    with pytest.raises(KeyError, match="unknown resilience counter"):
        got.bump("gremlins")
    assert tmetrics.loss_diverged(1.0, "iter 1", 0) is False
    assert tmetrics.loss_diverged(float("nan"), "iter 1", 1) is True
    out = np.random.RandomState(0).randn(16, 10)
    tgt = np.random.RandomState(1).randint(0, 10, 16)
    assert tmetrics.accuracy(out, tgt, (1, 5)) == \
        jmetrics.accuracy(out, tgt, (1, 5))
    a, b = tmetrics.AverageMeter(3), jmetrics.AverageMeter(3)
    for v in (1.0, 4.0, 2.0, 8.0):
        a.update(v)
        b.update(v)
        assert (a.val, a.avg) == (b.val, b.avg)
