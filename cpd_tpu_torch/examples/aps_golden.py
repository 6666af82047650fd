"""The golden APS accuracy experiment on the port (port of
`examples/aps_golden.py`: the CIFAR arm `CONFIGS`, `run_experiment`,
`check_ordering`; the optimizer arm `OPT_CONFIGS`,
`run_opt_experiment`, `check_opt_ordering`; the LM arm `LM_CONFIGS`,
`run_lm_experiment`, `check_lm_ordering`).

    python -m cpd_tpu_torch.examples.aps_golden --iters 100

The reference's artifact claim: training with a low-precision gradient
all-reduce loses accuracy, and APS recovers it.  Each CIFAR and
optimizer config trains the tiny CNN through the port's ResNet CLI
(`resnet18_cifar.train.run`) on ``world`` = 8 `LocalMesh` ranks x
``--emulate_node 2`` (a 16-rank emulated cluster) in ``--mode fast``, on
the learnable synthetic CIFAR set (or CIFAR-10 under ``--data-root``),
with fixed seeds; the optimizer arm holds the momentum buffer in e4m3
(naive, Kahan-compensated, stochastically rounded) with fp32 gradients.
The LM arm trains the 2-layer transformer through the port's LM CLI
(`lm.train.run`) on ``--dp 8`` ranks in fast mode, its metric the last
step's loss.  The JAX experiment runs the same flags on its 8 virtual
CPU devices.  The LM CLI's ``--save-path`` is not ported (ROADMAP Queue
A, A8): the LM arm writes nothing.
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

# Second arm (beyond the reference): the momentum buffer held in eXmY
# (train/optim.py quant_sgd), fp32 gradients.  Naive low-precision state
# loses accuracy, the quantized Kahan residual (and SR) recovers it.
OPT_CONFIGS = [
    # tag, extra CLI flags
    ("opt_fp32", []),
    ("opt_e4m3_naive", ["--opt_exp", "4", "--opt_man", "3"]),
    ("opt_e4m3_kahan", ["--opt_exp", "4", "--opt_man", "3",
                        "--opt_kahan"]),
    ("opt_e4m3_sr", ["--opt_exp", "4", "--opt_man", "3",
                     "--opt-rounding", "stochastic"]),
]

# Third arm (beyond the reference): the transformer LM under the same
# APS claim, loss (lower is better) in place of Prec@1.
LM_CONFIGS = [
    ("lm_fp32", 8, 23, False),
    ("lm_e3m4_noaps", 3, 4, False),
    ("lm_e3m4_aps", 3, 4, True),
    ("lm_e3m4_sr_noaps", 3, 4, False, ("--grad-rounding", "stochastic")),
]

WORLD = 8


def _run_tagged(tagged_flags, iters: int, save_root, batch_size: int,
                emulate_node: int, peak_lr: float, data_root, arch: str,
                mode: str, quiet: bool, world: int, device) -> dict:
    """Train each ``(tag, extra CLI flags)`` config through the ResNet
    CLI from scratch, its checkpoints under ``save_root/<tag>`` (a
    temporary directory, removed after, when None); ``{tag: {"prec1",
    "loss", "diverged"}}`` (``loss`` the last step's)."""
    if save_root is None:
        with tempfile.TemporaryDirectory() as tmp:
            return _run_tagged(tagged_flags, iters, tmp, batch_size,
                               emulate_node, peak_lr, data_root, arch, mode,
                               quiet, world, device)
    from .resnet18_cifar.train import parse_args, run

    out = {}
    for tag, extra in tagged_flags:
        save = os.path.join(save_root, tag)
        # from scratch: a stale checkpoint would resume at max_iter
        shutil.rmtree(save, ignore_errors=True)
        argv = ["--arch", arch, "--batch_size", str(batch_size),
                "--max-iter", str(iters), "--val_freq", str(iters),
                "--print_freq", "100000" if quiet else "50",
                "--peak-lr", str(peak_lr), "--save_path", save,
                "--emulate_node", str(emulate_node), "--mode", mode] + extra
        if data_root:
            argv += ["--data-root", data_root]
        res = run(parse_args(argv), device=device, world=world)
        out[tag] = {"prec1": res["best_prec1"],
                    "loss": res.get("loss", math.nan),
                    "diverged": bool(res.get("diverged"))}
        note = "  [DIVERGED]" if res.get("diverged") else ""
        print(f"== {tag}: Prec@1 {res['best_prec1']:.2f}{note}", flush=True)
    return out


def run_experiment(iters: int, save_root=None, batch_size: int = 16,
                   emulate_node: int = 2, peak_lr: float = 0.4,
                   configs=CONFIGS, data_root=None, arch: str = "tiny",
                   mode: str = "fast", quiet: bool = True, world: int = WORLD,
                   device="cuda") -> dict:
    """Train every gradient-precision config (`_run_tagged`)."""
    tagged = [(tag, ["--grad_exp", str(ge), "--grad_man", str(gm)]
               + (["--use_APS"] if aps else [])
               + [f for flags in extra for f in flags])
              for tag, ge, gm, aps, *extra in configs]
    return _run_tagged(tagged, iters, save_root, batch_size, emulate_node,
                       peak_lr, data_root, arch, mode, quiet, world, device)


def run_opt_experiment(iters: int, save_root=None, batch_size: int = 16,
                       emulate_node: int = 2, peak_lr: float = 0.4,
                       configs=OPT_CONFIGS, data_root=None,
                       arch: str = "tiny", mode: str = "fast",
                       quiet: bool = True, world: int = WORLD,
                       device="cuda") -> dict:
    """Train every optimizer-precision config (`_run_tagged`)."""
    return _run_tagged(list(configs), iters, save_root, batch_size,
                       emulate_node, peak_lr, data_root, arch, mode, quiet,
                       world, device)


def run_lm_experiment(iters: int, configs=LM_CONFIGS, quiet: bool = True,
                      world: int = WORLD, device="cuda") -> dict:
    """Train each gradient-precision config through the LM CLI on
    ``world`` `LocalMesh` ranks (the reference's 8-device mesh);
    ``{tag: {"loss", "accuracy", "diverged"}}``, the last step's."""
    from .lm.train import parse_args, run

    out = {}
    for tag, ge, gm, aps, *extra in configs:
        argv = ["--seq-len", "32", "--d-model", "32", "--n-layers", "2",
                "--n-heads", "4", "--vocab-size", "64", "--batch-size",
                "2", "--dp", str(world), "--max-iter", str(iters),
                "--base-lr", "0.05",
                "--print-freq", "100000" if quiet else "50",
                "--val-freq", str(iters), "--mode", "fast",
                "--grad_exp", str(ge), "--grad_man", str(gm)]
        if aps:
            argv.append("--use_APS")
        for flags in extra:
            argv.extend(flags)
        res = run(parse_args(argv), device=device)
        out[tag] = {"loss": res.get("loss", math.nan),
                    "accuracy": res.get("accuracy", math.nan),
                    "diverged": bool(res.get("diverged"))}
        print(f"== {tag}: loss {out[tag]['loss']:.4f} "
              f"acc {100 * out[tag]['accuracy']:.1f}", flush=True)
    return out


def check_lm_ordering(results: dict, margin: float = 0.5,
                      recover: float = 0.3) -> list:
    """APS recovers the LM loss the naive low-precision reduce loses.  A
    diverged (or NaN) no-APS arm counts as infinitely bad (divergence at
    the aggressive format is the claim's premise at its strongest); a
    diverged APS or fp32 arm is a failure."""
    def loss_of(tag, bad_is_inf):
        rec = results[tag]
        v = rec["loss"]
        if rec.get("diverged") or not math.isfinite(v):
            return float("inf") if bad_is_inf else float("nan")
        return v

    fp32 = loss_of("lm_fp32", bad_is_inf=False)
    noaps = loss_of("lm_e3m4_noaps", bad_is_inf=True)
    aps = loss_of("lm_e3m4_aps", bad_is_inf=False)
    ok_gain = aps <= noaps - margin
    ok_recover = aps <= fp32 + recover
    checks = [
        f"lm e3m4: aps loss {aps:.3f} <= noaps {noaps:.3f} - {margin} -> "
        f"{'OK' if ok_gain else 'VIOLATED'}",
        f"lm e3m4: aps loss {aps:.3f} <= fp32 {fp32:.3f} + {recover} -> "
        f"{'OK' if ok_recover else 'VIOLATED'}",
    ]
    if "lm_e3m4_sr_noaps" in results:
        sr = loss_of("lm_e3m4_sr_noaps", bad_is_inf=False)
        ok_sr = (sr <= noaps - margin) and (sr <= fp32 + 0.5)
        checks.append(
            f"lm e3m4: sr_noaps loss {sr:.3f} <= noaps {noaps:.3f} - "
            f"{margin} and <= fp32 {fp32:.3f} + 0.5 -> "
            f"{'OK' if ok_sr else 'VIOLATED'}")
    return checks


def check_opt_ordering(results: dict, margin: float = 1.0,
                       recover: float = 2.0) -> list:
    """The Kahan-compensated eXmY momentum recovers what the naive one
    loses; so does stochastic rounding (by a smaller, noisier margin)."""
    fp32 = results["opt_fp32"]["prec1"]
    naive = results["opt_e4m3_naive"]["prec1"]
    kahan = results["opt_e4m3_kahan"]["prec1"]
    ok_gain = kahan >= naive + margin
    ok_recover = kahan >= fp32 - recover
    checks = [
        f"opt e4m3: kahan {kahan:.2f} >= naive {naive:.2f} + {margin} -> "
        f"{'OK' if ok_gain else 'VIOLATED'}",
        f"opt e4m3: kahan {kahan:.2f} >= fp32 {fp32:.2f} - {recover} -> "
        f"{'OK' if ok_recover else 'VIOLATED'}",
    ]
    if "opt_e4m3_sr" in results:
        sr = results["opt_e4m3_sr"]["prec1"]
        ok_sr = sr >= naive + margin
        checks.append(
            f"opt e4m3: sr {sr:.2f} >= naive {naive:.2f} + {margin} -> "
            f"{'OK' if ok_sr else 'VIOLATED'}")
    return checks


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
    """Run every config of the three arms and check their orderings; 1
    on a violation."""
    p = argparse.ArgumentParser(description="golden APS experiment")
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--data-root", default=None)
    p.add_argument("--margin", type=float, default=2.0,
                   help="APS-arm min accuracy gain (aps vs noaps)")
    p.add_argument("--opt-margin", type=float, default=1.0,
                   help="optimizer-arm min gain (kahan vs naive)")
    p.add_argument("--lm-iters", type=int, default=150,
                   help="LM-arm iterations")
    p.add_argument("--lm-margin", type=float, default=0.5,
                   help="LM-arm min loss gain (aps vs noaps)")
    p.add_argument("--lm-recover", type=float, default=0.3,
                   help="LM-arm max loss gap to fp32")
    args = p.parse_args(argv)
    results = run_experiment(args.iters, data_root=args.data_root,
                             device=device)
    checks = check_ordering(results, args.margin)
    opt_results = run_opt_experiment(args.iters, data_root=args.data_root,
                                     device=device)
    checks += check_opt_ordering(opt_results, margin=args.opt_margin)
    lm_results = run_lm_experiment(args.lm_iters, device=device)
    checks += check_lm_ordering(lm_results, margin=args.lm_margin,
                                recover=args.lm_recover)
    print(json.dumps({"results": results, "opt_results": opt_results,
                      "lm_results": lm_results, "checks": checks}),
          flush=True)
    return 1 if any("VIOLATED" in c for c in checks) else 0


if __name__ == "__main__":
    sys.exit(main())
