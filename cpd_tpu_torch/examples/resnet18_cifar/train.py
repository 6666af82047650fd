"""ResNet-18/CIFAR-10 trainer of the port (port of the main path of
`examples/resnet18_cifar/train.py`).

    python -m cpd_tpu_torch.examples.resnet18_cifar.train --mode ring \\
        --use_APS --grad_exp 5 --grad_man 2 --max-iter 20

One data-parallel rank on the card: seed-24 weights, the seed-0
iteration sampler, pad-4 reflect / random crop / flip augmentation
re-drawn each epoch, SGD (momentum and weight decay from
``configs/res18_cifar.yaml``) under the warmup -> peak -> x0.1 at epochs
40 and 80 schedule, the APS low-precision gradient reduce in ``--mode``
faithful or ring (``--grad-rounding stochastic --grad-seed N`` rounds it
stochastically, ``--use_kahan`` compensates it, ``--block-scale
--block-size B`` ships the ring block-scaled), validation every
``--val_freq`` iterations and at the end.  Without CIFAR-10 under ``--data-root`` (or ``./data``) it trains
on the deterministic synthetic stand-in.  Checkpoints and the other
flags of the JAX trainer are not ported yet: passing one raises.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np

from ...obs.timing import now

_HERE = os.path.dirname(os.path.abspath(__file__))

# flags of the JAX trainer that the port does not have yet
_NOT_PORTED = (
    "--dist", "--load-path", "--init-from-torch", "--export-torch",
    "--resume-opt", "--use_lars", "--opt_exp", "--opt_man", "--opt_kahan",
    "--opt-rounding", "--opt-seed", "--optimizer", "--shampoo-stat-exp",
    "--shampoo-stat-man", "--shampoo-stat-mode", "-e", "--evaluate",
    "--emulate_node", "--arch", "--max_epoch", "--save_path", "--clip-grad",
    "--profile-dir", "--tensorboard", "--zero1", "--zero2",
    "--overlap-reduce", "--bucket-elems", "--obs-dir", "--obs-flight", "--fault-plan", "--guard-grads",
    "--spike-factor", "--watchdog-timeout", "--divergence-window",
    "--divergence-factor", "--divergence-mode", "--max-rollbacks",
    "--rollback-backoff", "--no-ckpt-integrity", "--verify-reduce",
    "--reduce-retries", "--transport-probation", "--precision-ladder",
    "--sat-threshold", "--sat-patience", "--precision-probation",
    "--quant-telemetry", "--elastic", "--heartbeat-patience",
    "--straggler-factor")


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
    p.add_argument("--use_APS", action="store_true")
    p.add_argument("--use_kahan", action="store_true")
    p.add_argument("--mode", default="faithful",
                   choices=["faithful", "fast", "ring"])
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
                             f"(ROADMAP Queue A)")
        build_parser().error(f"unrecognized arguments: {' '.join(rest)}")
    if args.mode == "fast":
        raise SystemExit("--mode fast: not yet ported to cpd_tpu_torch "
                         "(ROADMAP Queue A, A3)")
    if args.block_scale and args.mode != "ring":
        raise SystemExit("--block-scale needs --mode ring: the per-block "
                         "scale sidecar rides a packed wire")
    if args.block_scale and args.grad_man < 2:
        raise SystemExit(f"--block-scale needs a packable gradient format "
                         f"(man_bits >= 2 for the codec's special codes), "
                         f"got e{args.grad_exp}m{args.grad_man}")
    cfg = read_config(args.config)
    if cfg.get("arch", "res_cifar") != "res_cifar":
        raise SystemExit(f"arch {cfg['arch']!r}: not yet ported to "
                         "cpd_tpu_torch (only res_cifar)")
    for key in ("batch_size", "val_freq", "print_freq"):
        if getattr(args, key) is None:
            setattr(args, key, int(cfg[key]))
    args.max_epoch = int(cfg["max_epoch"])
    args.momentum = float(cfg["momentum"])
    args.weight_decay = float(cfg["weight_decay"])
    return args


def run(args: argparse.Namespace, device="cuda") -> dict:
    import torch

    from ...data import (CIFAR10Pipeline, DistributedGivenIterationSampler,
                         load_cifar10)
    from ...device import resolve_device
    from ...models.resnet_cifar import resnet18_cifar
    from ...parallel.mesh import data_parallel_mesh
    from ...train import (create_train_state, make_eval_step,
                          make_train_step, sgd, warmup_step_decay)

    dev = resolve_device(device)
    mesh = data_parallel_mesh(1, dev)
    seed = 24
    train_x, train_y, test_x, test_y = load_cifar10(args.data_root)
    iter_per_epoch = math.ceil(len(train_y) / (mesh.world * args.batch_size))
    total_iter = (args.max_iter if args.max_iter is not None
                  else args.max_epoch * iter_per_epoch)
    peak_lr = args.peak_lr if args.peak_lr is not None else 1.6
    schedule = warmup_step_decay(
        peak_lr, 5 * iter_per_epoch,
        [40 * iter_per_epoch, 80 * iter_per_epoch],
        warmup_from=peak_lr / 16.0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = resnet18_cifar(device=dev).init_weights(gen)
    opt = sgd(schedule, momentum=args.momentum,
              weight_decay=args.weight_decay)
    state = create_train_state(model, opt)
    train_step = make_train_step(model, opt, mesh, mode=args.mode,
                                 use_aps=args.use_APS,
                                 grad_exp=args.grad_exp,
                                 grad_man=args.grad_man,
                                 use_kahan=args.use_kahan,
                                 grad_rounding=args.grad_rounding,
                                 grad_seed=args.grad_seed,
                                 block_scale=args.block_scale,
                                 block_size=args.block_size)
    eval_step = make_eval_step(model, mesh)

    global_batch = args.batch_size * mesh.world
    pipeline = CIFAR10Pipeline(train_x, train_y, global_batch, augment=True,
                               cutout=0)
    eval_bs = max(1, min(1000, len(test_y)))
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
