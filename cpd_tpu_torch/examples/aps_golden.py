"""The golden APS accuracy experiment on the port (port of the CIFAR arm
of `examples/aps_golden.py`: `CONFIGS`, `run_experiment`,
`check_ordering`).

    python -m cpd_tpu_torch.examples.aps_golden --iters 100

The reference's artifact claim: training with a low-precision gradient
all-reduce loses accuracy, and APS recovers it.  Each config trains the
tiny CNN through the port's ResNet CLI (`resnet18_cifar.train.run`) on
``world`` = 8 `LocalMesh` ranks x ``--emulate_node 2`` (a 16-rank
emulated cluster) in ``--mode fast``, on the learnable synthetic CIFAR
set (or CIFAR-10 under ``--data-root``), with fixed seeds.  The JAX
experiment runs the same flags on its 8 virtual CPU devices.  The
optimizer arm (`OPT_CONFIGS`) and the LM arm are not ported yet
(ROADMAP Queue A).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile

CONFIGS = [
    # tag, grad_exp, grad_man, use_aps
    ("fp32", 8, 23, False),
    ("e4m3_noaps", 4, 3, False),
    ("e4m3_aps", 4, 3, True),
    ("e3m4_noaps", 3, 4, False),
    ("e3m4_aps", 3, 4, True),
    # SR gradient pipeline: unbiased rounding instead of exponent shifting
    ("e3m4_sr_noaps", 3, 4, False, ("--grad-rounding", "stochastic")),
]

WORLD = 8


def run_experiment(iters: int, save_root=None, batch_size: int = 16,
                   emulate_node: int = 2, peak_lr: float = 0.4,
                   configs=CONFIGS, data_root=None, arch: str = "tiny",
                   mode: str = "fast", quiet: bool = True, world: int = WORLD,
                   device="cuda") -> dict:
    """Train every gradient-precision config, each from scratch with its
    checkpoints under ``save_root/<tag>`` (a temporary directory, removed
    after, when None); ``{tag: {"prec1", "loss", "diverged"}}`` (``loss``
    the last step's)."""
    if save_root is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run_experiment(iters, tmp, batch_size, emulate_node,
                                  peak_lr, configs, data_root, arch, mode,
                                  quiet, world, device)
    from .resnet18_cifar.train import parse_args, run

    out = {}
    for tag, ge, gm, aps, *extra in configs:
        save = os.path.join(save_root, tag)
        # from scratch: a stale checkpoint would resume at max_iter
        shutil.rmtree(save, ignore_errors=True)
        argv = ["--arch", arch, "--batch_size", str(batch_size),
                "--max-iter", str(iters), "--val_freq", str(iters),
                "--print_freq", "100000" if quiet else "50",
                "--peak-lr", str(peak_lr), "--save_path", save,
                "--emulate_node", str(emulate_node), "--mode", mode,
                "--grad_exp", str(ge), "--grad_man", str(gm)]
        argv += ["--use_APS"] if aps else []
        argv += [f for flags in extra for f in flags]
        if data_root:
            argv += ["--data-root", data_root]
        res = run(parse_args(argv), device=device, world=world)
        out[tag] = {"prec1": res["best_prec1"],
                    "loss": res.get("loss", math.nan),
                    "diverged": bool(res.get("diverged"))}
        note = "  [DIVERGED]" if res.get("diverged") else ""
        print(f"== {tag}: Prec@1 {res['best_prec1']:.2f}{note}", flush=True)
    return out


def check_ordering(results: dict, margin: float = 2.0) -> list:
    """The artifact claim: APS recovers the accuracy low precision loses
    (needs the ``fp32`` config)."""
    checks = []
    fp32 = results["fp32"]["prec1"]
    for fmt in ("e4m3", "e3m4"):
        noaps = results.get(f"{fmt}_noaps")
        aps = results.get(f"{fmt}_aps")
        if noaps is None or aps is None:
            continue
        ok_gain = aps["prec1"] >= noaps["prec1"] + margin
        ok_recover = aps["prec1"] >= fp32 - 5.0
        checks.append(f"{fmt}: aps {aps['prec1']:.2f} >= noaps "
                      f"{noaps['prec1']:.2f} + {margin} -> "
                      f"{'OK' if ok_gain else 'VIOLATED'}")
        checks.append(f"{fmt}: aps {aps['prec1']:.2f} >= fp32 {fp32:.2f} - 5 "
                      f"-> {'OK' if ok_recover else 'VIOLATED'}")
    if "e3m4_sr_noaps" in results and "e3m4_noaps" in results:
        sr = results["e3m4_sr_noaps"]["prec1"]
        noaps = results["e3m4_noaps"]["prec1"]
        ok_sr = sr >= noaps + 15.0
        checks.append(f"e3m4: sr_noaps {sr:.2f} >= noaps {noaps:.2f} + 15 "
                      f"-> {'OK' if ok_sr else 'VIOLATED'}")
    return checks


def main(argv=None, device="cuda") -> int:
    """Run every config and check the ordering; 1 on a violation."""
    p = argparse.ArgumentParser(description="golden APS experiment")
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--data-root", default=None)
    p.add_argument("--margin", type=float, default=2.0)
    args = p.parse_args(argv)
    results = run_experiment(args.iters, data_root=args.data_root,
                             device=device)
    checks = check_ordering(results, args.margin)
    print(json.dumps({"results": results, "checks": checks}), flush=True)
    return 1 if any("VIOLATED" in c for c in checks) else 0


if __name__ == "__main__":
    sys.exit(main())
