"""ResNet-18/CIFAR-10 trainer of the port (port of the main path of
`examples/resnet18_cifar/train.py`).

    python -m cpd_tpu_torch.examples.resnet18_cifar.train --mode ring \\
        --use_APS --grad_exp 5 --grad_man 2 --max-iter 20

    python -m cpd_tpu_torch.examples.resnet18_cifar.train --use_APS \\
        --grad_exp 5 --grad_man 2 --emulate_node 8 --use_lars

Data-parallel ranks on the card (`run`'s ``world``, one by default, the
JAX trainer's device count): ``--arch`` (the config's ``res_cifar`` by
default; the ImageNet ResNets of `models.resnet` and the ``tiny`` CNN
too), seed-24 weights, the seed-0 iteration sampler, pad-4 reflect /
random crop / flip augmentation re-drawn each epoch, ``--emulate_node
N`` micro-batches of ``--batch_size`` a rank reduced locally before the
cross-rank reduce (an epoch counts the emulated cluster), SGD (momentum
and weight decay from ``configs/res18_cifar.yaml``), LARS (``--use_lars``)
or the eXmY momentum buffer (``--opt_exp/--opt_man/--opt_kahan``,
``--opt-rounding stochastic --opt-seed N``; ``--optimizer`` names one)
under the warmup -> peak -> x0.1 at epochs 40 and 80 schedule, the APS
low-precision gradient reduce in ``--mode`` faithful, ring or fast
(``--grad-rounding stochastic --grad-seed N`` rounds it stochastically,
``--use_kahan`` compensates it, ``--block-scale --block-size B`` ships
the ring block-scaled), validation every ``--val_freq`` iterations and
at the end.  Without CIFAR-10 under ``--data-root`` (or ``./data``) it
trains on the deterministic synthetic stand-in.  Checkpoints and the
other flags of the JAX trainer are not ported yet: passing one raises.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np

from ...obs.timing import now

_HERE = os.path.dirname(os.path.abspath(__file__))

# flags of the JAX trainer that the port does not have yet, by the
# ROADMAP Queue A item they wait for
_NOT_PORTED = {
    "--dist": "A3", "--load-path": "A4", "--init-from-torch": "A4",
    "--export-torch": "A4", "--resume-opt": "A4",
    "--shampoo-stat-exp": "A12", "--shampoo-stat-man": "A12",
    "--shampoo-stat-mode": "A12", "-e": "A4", "--evaluate": "A4",
    "--max_epoch": "A4", "--save_path": "A4", "--clip-grad": "A4",
    "--profile-dir": "A11", "--tensorboard": "A11", "--zero1": "A6",
    "--zero2": "A6", "--overlap-reduce": "A6", "--bucket-elems": "A6",
    "--obs-dir": "A11", "--obs-flight": "A11", "--fault-plan": "A10",
    "--guard-grads": "A10", "--spike-factor": "A10",
    "--watchdog-timeout": "A10", "--divergence-window": "A10",
    "--divergence-factor": "A10", "--divergence-mode": "A10",
    "--max-rollbacks": "A10", "--rollback-backoff": "A10",
    "--no-ckpt-integrity": "A4", "--verify-reduce": "A10",
    "--reduce-retries": "A10", "--transport-probation": "A10",
    "--precision-ladder": "A10", "--sat-threshold": "A10",
    "--sat-patience": "A10", "--precision-probation": "A10",
    "--quant-telemetry": "A10", "--elastic": "A10",
    "--heartbeat-patience": "A10", "--straggler-factor": "A10"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="cpd_tpu_torch ResNet18/CIFAR10 (one rank on the card)")
    p.add_argument("--config",
                   default=os.path.join(_HERE, "configs", "res18_cifar.yaml"))
    p.add_argument("--grad_exp", default=5, type=int)
    p.add_argument("--grad_man", default=2, type=int)
    p.add_argument("--grad-rounding", default="nearest",
                   choices=["nearest", "stochastic"],
                   help="rounding of every cast of the gradient reduce: "
                        "stochastic = unbiased SR")
    p.add_argument("--grad-seed", default=0, type=int,
                   help="PRNG seed for --grad-rounding stochastic")
    p.add_argument("--use_lars", action="store_true")
    p.add_argument("--use_APS", action="store_true")
    p.add_argument("--use_kahan", action="store_true")
    # optimizer-state precision: the SGD momentum buffer held in eXmY
    p.add_argument("--opt_exp", default=8, type=int)
    p.add_argument("--opt_man", default=23, type=int)
    p.add_argument("--opt_kahan", action="store_true",
                   help="Kahan-compensate the quantized momentum buffer")
    p.add_argument("--opt-rounding", default="nearest",
                   choices=["nearest", "stochastic"],
                   help="rounding of the eXmY momentum-buffer casts: "
                        "stochastic = unbiased SR (train/optim.py "
                        "quant_sgd)")
    p.add_argument("--opt-seed", default=0, type=int,
                   help="PRNG seed for --opt-rounding stochastic")
    p.add_argument("--optimizer", default="auto",
                   choices=["auto", "sgd", "nesterov", "lars", "quant_sgd",
                            "shampoo-lite"],
                   help="optimizer family.  'auto' (default) keeps the "
                        "flag-driven choice (--use_lars / --opt_exp&co -> "
                        "quant_sgd, else sgd).  'shampoo-lite' is not "
                        "ported yet")
    p.add_argument("--emulate_node", default=1, type=int,
                   help="micro-batches a rank runs and reduces locally "
                        "before the cross-rank reduce (an emulated "
                        "cluster of ranks x N)")
    p.add_argument("--mode", default="faithful",
                   choices=["faithful", "fast", "ring"])
    p.add_argument("--arch", default=None, type=str,
                   help="model by the JAX registry's name (default: the "
                        "config's), built as the JAX trainer builds it: "
                        "fp32, 10 classes for the CIFAR ResNet, 1000 for "
                        "the ImageNet ones")
    p.add_argument("--block-scale", action="store_true",
                   help="block-scaled ring wire (EQuARX-style): every hop "
                        "cast shares one power-of-2 scale per --block-size "
                        "consecutive elements; the 1-byte-per-block shift "
                        "sidecar rides the packed wire.  Requires --mode "
                        "ring and a packable gradient format (man >= 2)")
    p.add_argument("--block-size", default=128, type=int,
                   help="elements per shared-scale block for --block-scale "
                        "(default 128; multiples of 128 dividing 65536 "
                        "keep the fused CUDA wire kernel eligible — other "
                        "sizes take the plain torch hop)")
    p.add_argument("--batch_size", default=None, type=int)
    p.add_argument("--val_freq", default=None, type=int)
    p.add_argument("--print_freq", default=None, type=int)
    p.add_argument("--data-root", default=None)
    p.add_argument("--peak-lr", default=None, type=float)
    p.add_argument("--max-iter", default=None, type=int)
    return p


def _scalar(text: str):
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        return [_scalar(t) for t in text[1:-1].split(",") if t.strip()]
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


def read_config(path: str, section: str = "common") -> dict:
    """The ``section`` mapping of the trainer's flat YAML config
    (``key: scalar`` and ``key: [a, b]`` lines, ``#`` comments)."""
    cfg: dict = {}
    current = None
    with open(path) as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            key, _, value = line.strip().partition(":")
            if not raw[0].isspace():
                current = key
            elif current == section:
                cfg[key] = _scalar(value)
    return cfg


def parse_args(argv=None) -> argparse.Namespace:
    args, rest = build_parser().parse_known_args(argv)
    if rest:
        flag = rest[0].split("=", 1)[0]
        if flag == "--verify-reduce":
            raise SystemExit(
                "--verify-reduce: not yet ported to cpd_tpu_torch: in the "
                "JAX trainer it arms the ring -> faithful -> fp32 "
                "TransportSupervisor ladder, whose last rung is --mode "
                "fast; both come in a later slice (ROADMAP Queue A, A3 "
                "and A10).  The verified ring itself is ported: "
                "make_train_step(verify_reduce=True)")
        if flag in _NOT_PORTED:
            raise SystemExit(f"{flag}: not yet ported to cpd_tpu_torch "
                             f"(ROADMAP Queue A, {_NOT_PORTED[flag]})")
        build_parser().error(f"unrecognized arguments: {' '.join(rest)}")
    if args.emulate_node < 1:
        raise SystemExit(f"--emulate_node must be >= 1, got "
                         f"{args.emulate_node}")
    args.opt_name = _optimizer_name(args)
    if args.block_scale and args.mode != "ring":
        raise SystemExit("--block-scale needs --mode ring: the per-block "
                         "scale sidecar rides a packed wire")
    if args.block_scale and args.grad_man < 2:
        raise SystemExit(f"--block-scale needs a packable gradient format "
                         f"(man_bits >= 2 for the codec's special codes), "
                         f"got e{args.grad_exp}m{args.grad_man}")
    cfg = read_config(args.config)
    if args.arch is None:
        args.arch = cfg.get("arch", "res_cifar")
    from ... import models

    if args.arch not in models.ARCHS:
        raise SystemExit(f"arch {args.arch!r}: not yet ported to "
                         f"cpd_tpu_torch (ported: "
                         f"{', '.join(models.ARCHS)})")
    for key in ("batch_size", "val_freq", "print_freq"):
        if getattr(args, key) is None:
            setattr(args, key, int(cfg[key]))
    args.max_epoch = int(cfg["max_epoch"])
    args.momentum = float(cfg["momentum"])
    args.weight_decay = float(cfg["weight_decay"])
    return args


def _optimizer_name(args: argparse.Namespace) -> str:
    """The optimizer the flags select, with the JAX trainer's
    contradiction checks (`examples/resnet18_cifar/train.py:198-257`)."""
    quant_opt = (args.opt_exp, args.opt_man) != (8, 23) or args.opt_kahan
    if quant_opt and args.use_lars:
        raise SystemExit("--use_lars and --opt_exp/--opt_man/--opt_kahan "
                         "are exclusive")
    if (args.opt_rounding != "nearest"
            and (args.opt_exp, args.opt_man) == (8, 23)):
        # --opt_kahan with an fp32 buffer would silently drop SR
        raise SystemExit("--opt-rounding stochastic needs a quantized "
                         "buffer (--opt_exp/--opt_man below fp32)")
    if args.optimizer == "shampoo-lite":
        raise SystemExit("--optimizer shampoo-lite: not yet ported to "
                         "cpd_tpu_torch (ROADMAP Queue A, A12)")
    if args.optimizer != "auto":
        if args.use_lars and args.optimizer != "lars":
            raise SystemExit("--use_lars contradicts --optimizer "
                             f"{args.optimizer}")
        if quant_opt and args.optimizer != "quant_sgd":
            raise SystemExit(f"--opt_exp/--opt_man/--opt_kahan need "
                             f"the quantized momentum buffer; "
                             f"--optimizer {args.optimizer} would "
                             f"ignore them (use quant_sgd or auto)")
        return args.optimizer
    return "lars" if args.use_lars else "quant_sgd" if quant_opt else "sgd"


def run(args: argparse.Namespace, device="cuda", world: int = 1) -> dict:
    """Train as the flags say on ``world`` `LocalMesh` ranks on
    ``device`` (the JAX trainer's device count); returns the last
    metrics with ``step``, ``best_prec1`` and ``diverged``."""
    import torch

    from ...data import (CIFAR10Pipeline, DistributedGivenIterationSampler,
                         load_cifar10)
    from ...device import resolve_device
    from ... import models
    from ...parallel.mesh import data_parallel_mesh
    from ...train import (create_train_state, make_eval_step,
                          make_optimizer, make_train_step,
                          warmup_step_decay)

    dev = resolve_device(device)
    mesh = data_parallel_mesh(world, dev)
    seed = 24
    train_x, train_y, test_x, test_y = load_cifar10(args.data_root)
    # iterations per epoch count the emulated cluster
    iter_per_epoch = math.ceil(len(train_y) / (
        mesh.world * args.batch_size * args.emulate_node))
    total_iter = (args.max_iter if args.max_iter is not None
                  else args.max_epoch * iter_per_epoch)
    peak_lr = args.peak_lr if args.peak_lr is not None else 1.6
    schedule = warmup_step_decay(
        peak_lr, 5 * iter_per_epoch,
        [40 * iter_per_epoch, 80 * iter_per_epoch],
        warmup_from=peak_lr / 16.0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = models.get_model(args.arch, device=dev).init_weights(gen)
    opt = make_optimizer(args.opt_name, schedule, momentum=args.momentum,
                         weight_decay=args.weight_decay,
                         opt_exp=args.opt_exp, opt_man=args.opt_man,
                         opt_kahan=args.opt_kahan,
                         opt_rounding=args.opt_rounding,
                         opt_seed=args.opt_seed)
    state = create_train_state(model, opt)
    train_step = make_train_step(model, opt, mesh,
                                 emulate_node=args.emulate_node,
                                 mode=args.mode,
                                 use_aps=args.use_APS,
                                 grad_exp=args.grad_exp,
                                 grad_man=args.grad_man,
                                 use_kahan=args.use_kahan,
                                 grad_rounding=args.grad_rounding,
                                 grad_seed=args.grad_seed,
                                 block_scale=args.block_scale,
                                 block_size=args.block_size)
    eval_step = make_eval_step(model, mesh)

    global_batch = args.batch_size * mesh.world * args.emulate_node
    pipeline = CIFAR10Pipeline(train_x, train_y, global_batch, augment=True,
                               cutout=0)
    eval_bs = max(mesh.world,
                  (min(1000, len(test_y)) // mesh.world) * mesh.world)
    eval_pipe = CIFAR10Pipeline(test_x, test_y, eval_bs, augment=False)

    def validate() -> dict:
        tot = {"loss": 0.0, "top1": 0.0, "top5": 0.0}
        lows = range(0, (len(test_y) // eval_bs) * eval_bs, eval_bs)
        for lo in lows:
            x, y = eval_pipe.batch(np.arange(lo, lo + eval_bs))
            m = eval_step(state, x, y)
            for k in tot:
                tot[k] += float(m[k])
        avg = {k: v / max(len(lows), 1) for k, v in tot.items()}
        print(f" * Prec@1 {100 * avg['top1']:.3f} Prec@5 "
              f"{100 * avg['top5']:.3f} Loss {avg['loss']:.4f}", flush=True)
        return avg

    sampler = DistributedGivenIterationSampler(
        len(train_y), total_iter, global_batch, world_size=1, rank=0,
        seed=0)
    best, last, diverged, step_no = 0.0, {}, False, 0
    t0 = now()
    for idx in sampler.batches():
        x, y = pipeline.batch(idx, seed=step_no // iter_per_epoch)
        lr = schedule(step_no)
        state, metrics = train_step(state, x, y)
        last = {k: float(v) for k, v in metrics.items()}
        step_no += 1
        if not math.isfinite(last["loss"]):
            print(f"=> non-finite loss {last['loss']} at iter {step_no}: "
                  "diverged", file=sys.stderr)
            diverged = True
            break
        if step_no % args.print_freq == 0 or step_no == total_iter:
            print(f"Iter: [{step_no}/{total_iter}] Loss {last['loss']:.4f} "
                  f"Prec@1 {100 * last['accuracy']:.3f} LR {lr:.4f}",
                  flush=True)
        if step_no % args.val_freq == 0 or step_no == total_iter:
            best = max(best, 100 * validate()["top1"])
    if not diverged:
        print(f"done: {step_no} iters in {now() - t0:.1f}s best Prec@1 "
              f"{best:.2f}", flush=True)
    return {"step": step_no, "best_prec1": best, "diverged": diverged,
            **last}


def main(argv=None, device="cuda") -> int:
    """Run the trainer; 0 when it finished, 3 when the loss diverged."""
    res = run(parse_args(argv), device=device)
    return 3 if res["diverged"] else 0


if __name__ == "__main__":
    sys.exit(main())
