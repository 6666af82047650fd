"""The golden APS ordering on the port, at tests/test_golden.py's
settings: e3m4 gradients, the tiny CNN, 8 `LocalMesh` ranks x
``--emulate_node 2`` x batch 8, 100 iterations in fast mode, on the
learnable synthetic CIFAR set with fixed seeds.  Without APS the
16-rank emulated sum underflows and accuracy stalls; APS recovers it.

Marked ``slow`` as tests/test_golden.py is (two 100-step training runs,
~45 s on the CPU): not in the default tier.  On the card the same run
is `chip_smoke.py`'s phase 13c.
"""

import pytest

pytestmark = pytest.mark.slow


def test_aps_recovers_low_precision_accuracy_on_the_port():
    from cpd_tpu_torch.examples import aps_golden

    configs = [("e3m4_noaps", 3, 4, False), ("e3m4_aps", 3, 4, True)]
    results = aps_golden.run_experiment(iters=100, batch_size=8,
                                        configs=configs, device="cpu")
    noaps = results["e3m4_noaps"]["prec1"]
    aps = results["e3m4_aps"]["prec1"]
    assert aps >= noaps + 10.0, (noaps, aps)
    assert aps >= 60.0, aps
    assert not any(r["diverged"] for r in results.values())
    # check_ordering wants an fp32 arm; the APS arm stands in for it,
    # so its gain check (aps >= noaps + 2) is the one that bites
    checks = aps_golden.check_ordering(
        dict(results, fp32={"prec1": aps}))
    assert checks and not any("VIOLATED" in c for c in checks), checks
