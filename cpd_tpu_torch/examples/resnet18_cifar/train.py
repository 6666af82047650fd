"""ResNet-18/CIFAR-10 trainer of the port (port of the main path of
`examples/resnet18_cifar/train.py`).

    python -m cpd_tpu_torch.examples.resnet18_cifar.train --mode ring \\
        --use_APS --grad_exp 5 --grad_man 2 --max-iter 20

    python -m cpd_tpu_torch.examples.resnet18_cifar.train --use_APS \\
        --grad_exp 5 --grad_man 2 --emulate_node 8 --use_lars

    python -m torch.distributed.run --nproc_per_node 4 \\
        -m cpd_tpu_torch.examples.resnet18_cifar.train --dist \\
        --mode ring --use_APS --grad_exp 5 --grad_man 2

Data-parallel ranks on the card (`run`'s ``world``, one by default, the
JAX trainer's device count), or with ``--dist`` one rank per process
(`parallel.dist.dist_init` reads the launcher's variables; the
``--dist-backend``, ``nccl`` by default, one process per card, or
``gloo`` for processes that share a card or run on the CPU): each
process loads its contiguous slice of every global batch through its
own `DistributedGivenIterationSampler` (the JAX trainer's per-host
schedule, `examples/resnet18_cifar/train.py:540-548`), starts from rank
0's weights (`parallel.dist.replicate`), and rank 0 alone prints and
validates.  Outside a cluster ``--dist`` runs one process, as the JAX
trainer does.  ``--arch`` (the config's ``res_cifar`` by
default; the ImageNet ResNets of `models.resnet` and the ``tiny`` CNN
too), seed-24 weights, the seed-0 iteration sampler, pad-4 reflect /
random crop / flip augmentation re-drawn each epoch, ``--emulate_node
N`` micro-batches of ``--batch_size`` a rank reduced locally before the
cross-rank reduce (an epoch counts the emulated cluster), SGD (momentum
and weight decay from ``configs/res18_cifar.yaml``), LARS (``--use_lars``)
or the eXmY momentum buffer (``--opt_exp/--opt_man/--opt_kahan``,
``--opt-rounding stochastic --opt-seed N``; ``--optimizer`` names one),
fed the reduced gradients clipped to a global norm with ``--clip-grad``,
under the warmup -> peak -> x0.1 at epochs 40 and 80 schedule over
``--max_epoch`` epochs (the config's by default), the APS
low-precision gradient reduce in ``--mode`` faithful, ring or fast
(``--grad-rounding stochastic --grad-seed N`` rounds it stochastically,
``--use_kahan`` compensates it, ``--block-scale --block-size B`` ships
the ring block-scaled), validation every ``--val_freq`` iterations and
at the end.  Without CIFAR-10 under ``--data-root`` (or ``./data``) it
trains on the deterministic synthetic stand-in.

``--verify-reduce`` checks every reduce (the ring's hop and gather tags,
the cross-rank agreement) and, in ring or faithful mode, arms the
ring -> faithful -> fp32 transport ladder (`resilience.transport`): a
failed step's update is discarded, the next batch retries on the same
rung (``--reduce-retries`` times), then the ladder steps down a rung and
rank 0's state is broadcast to every rank; ``--transport-probation``
clean steps climb a rung back; a failure on the fp32 rung stops the run
(exit 3).  In fast mode it only detects.  ``--fault-plan`` schedules the
ring's wire faults (``wire_flip@2:1``: rank 1's wire at update 2).

Checkpoints (`train.checkpoint`) go to ``--save_path`` (the config's
``cifar/res18`` by default, relative to the working directory) at every
``--val_freq`` iterations with Prec@1 as their metric, and a run resumes
from its newest step there; ``--load-path DIR`` starts from the newest
step of another directory (``--resume-opt``: its optimizer state and
iteration too), ``--init-from-torch`` from a reference ResNet-18
``.pth``, ``-e`` only validates, and ``--export-torch`` writes the
weights as a reference ``.pth`` at the end.

``--overlap-reduce`` reduces each gradient bucket (``--bucket-elems``
elements at most) from inside the backward, bitwise the post-backward
reduce at the same layout.  ``--zero1`` shards the SGD (or, with
``--use_lars``, LARS) momentum over the ranks, ``--zero2`` the faithful
reduce too (an all-to-all reduce-scatter, in ``--bucket-elems``
buckets, inside the backward with ``--overlap-reduce``;
`parallel.zero`); their checkpoints are saved in the portable layout
and restore at any rank count.  The JAX trainer's other flags are not
ported yet: passing one raises.
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
    "--shampoo-stat-exp": "A12", "--shampoo-stat-man": "A12",
    "--shampoo-stat-mode": "A12",
    "--profile-dir": "A11", "--tensorboard": "A11", "--obs-dir": "A11", "--obs-flight": "A11",
    "--guard-grads": "A10", "--spike-factor": "A10",
    "--watchdog-timeout": "A10", "--divergence-window": "A10",
    "--divergence-factor": "A10", "--divergence-mode": "A10",
    "--max-rollbacks": "A10", "--rollback-backoff": "A10",
    "--precision-ladder": "A10", "--sat-threshold": "A10",
    "--sat-patience": "A10", "--precision-probation": "A10",
    "--quant-telemetry": "A10", "--elastic": "A10",
    "--heartbeat-patience": "A10", "--straggler-factor": "A10"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="cpd_tpu_torch ResNet18/CIFAR10 (ranks on the card, or "
                    "one rank per process with --dist)")
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
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: shard the optimizer state 1/W over the "
                        "ranks (composes with --use_lars)")
    p.add_argument("--zero2", action="store_true",
                   help="ZeRO-2: momentum AND the faithful reduction "
                        "sharded (all-to-all reduce-scatter; composes "
                        "with --use_lars)")
    p.add_argument("--overlap-reduce", action="store_true",
                   help="reduce each gradient bucket from inside the "
                        "backward, the moment its last gradient is ready "
                        "(bitwise the post-backward reduce); composes "
                        "with --emulate_node and --zero1/--zero2")
    p.add_argument("--bucket-elems", default=None, type=int,
                   help="per-bucket element cap of the reduce, the "
                        "overlapped schedule and the --zero2 layout "
                        "(default 4M)")
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
    p.add_argument("--dist", action="store_true",
                   help="one rank per process in a torch.distributed group "
                        "(launch with torchrun); a no-op outside a cluster")
    p.add_argument("--dist-backend", default="nccl",
                   choices=["nccl", "gloo"],
                   help="the group's backend under --dist: nccl, one "
                        "process per card; gloo, processes that share a "
                        "card or run on the CPU")
    p.add_argument("--load-path", default="", type=str,
                   help="start from the newest checkpoint in this "
                        "directory: its weights and BN stats, and with "
                        "--resume-opt its optimizer state and iteration")
    p.add_argument("--resume-opt", action="store_true")
    p.add_argument("--init-from-torch", default="", type=str,
                   help="start from a reference CPDtorch ResNet-18 .pth "
                        "(res_cifar): weights and BN stats, a fresh "
                        "optimizer")
    p.add_argument("--export-torch", default="", type=str,
                   help="after the run (training or -e), write the "
                        "weights and BN stats as a reference-format .pth "
                        "(res_cifar only)")
    p.add_argument("-e", "--evaluate", action="store_true",
                   help="validate the starting weights and stop")
    p.add_argument("--save_path", default=None, type=str,
                   help="checkpoint directory (default: the config's); "
                        "a run resumes from its newest step")
    p.add_argument("--no-ckpt-integrity", dest="ckpt_integrity",
                   action="store_false", default=True,
                   help="skip the per-save content digest")
    p.add_argument("--fault-plan", default=None, metavar="SPEC|FILE",
                   help="inject the ring's wire faults: "
                        "'wire_flip@2:1;wire_drop@5' (kind@update:rank), "
                        "or a JSON plan file; other kinds are not "
                        "ported yet")
    p.add_argument("--verify-reduce", action="store_true",
                   help="verified reduce: the ring's hop and gather tags "
                        "and the cross-rank agreement, and the ring -> "
                        "faithful -> fp32 transport ladder on a failure "
                        "(fast mode: detection only)")
    p.add_argument("--reduce-retries", default=1, type=int,
                   help="verified reduce: retries on the same rung "
                        "before the ladder steps down")
    p.add_argument("--transport-probation", default=8, type=int,
                   help="clean verified steps on a degraded rung before "
                        "the ladder climbs one back")
    p.add_argument("--batch_size", default=None, type=int)
    p.add_argument("--val_freq", default=None, type=int)
    p.add_argument("--print_freq", default=None, type=int)
    p.add_argument("--data-root", default=None)
    p.add_argument("--peak-lr", default=None, type=float)
    p.add_argument("--max-iter", default=None, type=int)
    p.add_argument("--max_epoch", default=None, type=int,
                   help="epochs to train (default: the config's); "
                        "--max-iter overrides it")
    p.add_argument("--clip-grad", default=None, type=float,
                   help="global-norm gradient clipping of the fully "
                        "reduced gradients")
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
        if flag in _NOT_PORTED:
            raise SystemExit(f"{flag}: not yet ported to cpd_tpu_torch "
                             f"(ROADMAP Queue A, {_NOT_PORTED[flag]})")
        build_parser().error(f"unrecognized arguments: {' '.join(rest)}")
    if args.emulate_node < 1:
        raise SystemExit(f"--emulate_node must be >= 1, got "
                         f"{args.emulate_node}")
    args.opt_name = _optimizer_name(args)
    zero = args.zero1 or args.zero2
    if args.verify_reduce and zero:
        raise SystemExit("--verify-reduce needs the step's own reduction "
                         "and a donate-free state for discard-and-retry; "
                         "the ZeRO/ShampooLite updaters own the "
                         "collective (reduce_in_update) — run without "
                         "--zero1/--zero2/--optimizer shampoo-lite")
    if args.block_scale and args.mode != "ring" and not args.zero2:
        raise SystemExit("--block-scale needs --mode ring (or --zero2, "
                         "whose all_to_all carries the blocked wire): "
                         "the per-block scale sidecar rides a packed "
                         "wire")
    if args.block_scale and args.grad_man < 2:
        raise SystemExit(f"--block-scale needs a packable gradient format "
                         f"(man_bits >= 2 for the codec's special codes), "
                         f"got e{args.grad_exp}m{args.grad_man}")
    if args.zero1 and args.zero2:
        raise SystemExit("--zero1/--zero2 are mutually exclusive")
    if zero:
        if (args.opt_exp, args.opt_man) != (8, 23) or args.opt_kahan:
            raise SystemExit("--zero1/--zero2 do not compose with the "
                             "quantized optimizer state (the ZeRO "
                             "updaters carry fp32 flat momentum)")
        if args.clip_grad is not None:
            raise SystemExit("--clip-grad runs inside the optax chain, "
                             "which the ZeRO updaters bypass")
        if args.zero2 and args.mode != "faithful":
            raise SystemExit("--zero2 shards the faithful reduction; "
                             "--mode fast is not supported with it")
    if args.init_from_torch and args.load_path:
        raise SystemExit("--init-from-torch and --load-path are exclusive")
    if args.fault_plan and not args.fault_plan.startswith("random:"):
        _wire_only(_fault_plan(args.fault_plan, 0))
    cfg = read_config(args.config)
    if args.arch is None:
        args.arch = cfg.get("arch", "res_cifar")
    if args.export_torch and args.arch != "res_cifar":
        raise SystemExit(f"--export-torch supports --arch res_cifar only "
                         f"(got --arch {args.arch})")
    from ... import models

    if args.arch not in models.ARCHS:
        raise SystemExit(f"arch {args.arch!r}: not yet ported to "
                         f"cpd_tpu_torch (ported: "
                         f"{', '.join(models.ARCHS)})")
    for key in ("batch_size", "val_freq", "print_freq", "save_path"):
        if getattr(args, key) is None:
            value = cfg[key]
            setattr(args, key, value if key == "save_path" else int(value))
    if args.max_epoch is None:
        args.max_epoch = int(cfg["max_epoch"])
    args.momentum = float(cfg["momentum"])
    args.weight_decay = float(cfg["weight_decay"])
    return args


def _fault_plan(spec: str, total_iter: int):
    """The ``--fault-plan`` (the JAX trainer's ``random:<seed>`` form
    draws over the run's ``total_iter`` updates)."""
    from ...resilience import FaultPlan

    if spec.startswith("random:"):
        return FaultPlan.random(int(spec.split(":", 1)[1]), total_iter)
    return FaultPlan.parse(spec)


def _wire_only(plan) -> None:
    """Refuse a plan with a kind the port does not execute."""
    from ...resilience import not_ported_kinds

    for kind, item in sorted(not_ported_kinds(plan).items()):
        raise SystemExit(f"--fault-plan kind {kind}: not yet ported to "
                         f"cpd_tpu_torch (ROADMAP Queue A, {item}); the "
                         f"port executes the wire_* kinds")


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
        if args.clip_grad is not None:
            raise SystemExit("--clip-grad runs inside the optax chain, "
                             "which the ShampooLite updater bypasses")
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
    ``device`` (the JAX trainer's device count), or with ``--dist`` in a
    process group on this process's one rank (``world`` must be 1; under
    nccl ``device`` is the rank's card); returns the last metrics with
    ``step`` (the updates applied, counting a resumed run's), ``best_prec1``
    (rank 0's validation; 0 on the others), ``diverged`` (also a ladder
    that gave up), and with ``--fault-plan`` or ``--verify-reduce`` the
    ``resilience`` counters and, when the ladder runs, ``transport``
    (its rung, home and transitions).  ``-e`` returns the validation's
    ``loss``/``top1``/``top5`` instead."""
    import torch
    import torch.distributed

    from ...data import (CIFAR10Pipeline, DistributedGivenIterationSampler,
                         load_cifar10)
    from ...device import resolve_device
    from ... import interop, models
    from ...parallel.dist import dist_init, replicate
    from ...parallel.integrity import make_consensus_fns
    from ...parallel.mesh import data_parallel_mesh
    from ...resilience import (StepTable, TransportSupervisor,
                               level_reduce_kwargs, report_unfired)
    from ...train import (create_train_state, make_eval_step,
                          make_optimizer, make_train_step,
                          warmup_step_decay)
    from ...train.checkpoint import CheckpointManager, restore_latest
    from ...train.metrics import ResilienceMeter, loss_diverged

    rank, n_proc = (dist_init(args.dist_backend) if args.dist else (0, 1))
    grouped = args.dist and torch.distributed.is_initialized()
    if grouped and world != 1:
        raise ValueError(f"--dist runs one rank per process; world="
                         f"{world} asks for {world} in this one")
    dev = resolve_device(device)
    mesh = data_parallel_mesh(None if grouped else world, dev)
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

    # the resilience surface (the JAX trainer's build_resilience)
    plan = (_fault_plan(args.fault_plan, total_iter) if args.fault_plan
            else None)
    if plan is not None:
        _wire_only(plan)
    verify = args.verify_reduce
    wire_plan = None
    if plan is not None and plan.wire_faults():
        wire_plan = plan.wire_schedule(total_iter)
        if not verify and rank == 0:
            print("=> WARNING: fault plan schedules wire_* faults but "
                  "--verify-reduce is off — the corrupted reduce will go "
                  "UNDETECTED (pass --verify-reduce to arm the checksums)",
                  file=sys.stderr)
    # a home outside the ladder (fast) verifies by agreement only
    supervisor = (TransportSupervisor(
        start=args.mode, max_retries=args.reduce_retries,
        probation=args.transport_probation)
        if verify and args.mode in TransportSupervisor.LEVELS else None)
    meter = ResilienceMeter()

    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    model = models.get_model(args.arch, device=mesh.device).init_weights(
        gen)
    replicate(model, mesh)
    opt = make_optimizer(args.opt_name, schedule, momentum=args.momentum,
                         weight_decay=args.weight_decay,
                         opt_exp=args.opt_exp, opt_man=args.opt_man,
                         opt_kahan=args.opt_kahan,
                         opt_rounding=args.opt_rounding,
                         opt_seed=args.opt_seed,
                         clip_norm=args.clip_grad)
    state = create_train_state(model, opt)
    zero = None
    if args.zero1 or args.zero2:
        from ...parallel import zero as zero_mod
        from ...train import TrainState

        maker = getattr(zero_mod, ("zero1" if args.zero1 else "zero2")
                        + ("_lars" if args.opt_name == "lars" else "_sgd"))
        zkw = dict(momentum=args.momentum, weight_decay=args.weight_decay)
        if args.zero2:
            # the overlap taps and the update consume the same buckets
            zkw["bucket_elems"] = args.bucket_elems
        zero = maker(schedule, world=mesh.world, **zkw)
        opt = None
        state = TrainState(0, model, zero.init(list(model.parameters()),
                                               mesh))

    def portable(st):
        """The restore template: a ZeRO state's portable layout."""
        return zero.portable_template(st) if zero else st

    def live(st):
        """A restored state on this mesh: a ZeRO state sharded."""
        return zero.import_state(st, mesh) if zero else st

    # where the run starts: a reference .pth, --load-path, or the newest
    # step under --save_path (every rank reads the same bytes)
    manager = CheckpointManager(args.save_path, track_best=True,
                                integrity=args.ckpt_integrity)
    start_iter = 0
    if args.init_from_torch:
        interop.import_reference_resnet18_cifar(
            model, interop.load_reference_checkpoint(args.init_from_torch))
        if rank == 0:
            print(f"=> imported torch checkpoint {args.init_from_torch}")
    elif args.load_path:
        loaded = restore_latest(os.path.abspath(args.load_path),
                                portable(state))
        if loaded is None:
            raise FileNotFoundError(
                f"--load-path {args.load_path}: no checkpoint found")
        if args.resume_opt:
            state = live(loaded)
            start_iter = int(loaded.step)
        if rank == 0:
            print(f"=> loaded {args.load_path} "
                  f"(opt {'restored' if args.resume_opt else 'fresh'})")
    elif manager.latest_step() is not None:
        restored = manager.restore(portable(state))
        if restored is not None:
            state = live(restored)
            start_iter = int(restored.step)
            if rank == 0:
                print(f"=> resumed from iter {start_iter}")

    step_kw = dict(emulate_node=args.emulate_node, use_aps=args.use_APS,
                   use_kahan=args.use_kahan,
                   grad_rounding=args.grad_rounding,
                   grad_seed=args.grad_seed, block_size=args.block_size,
                   overlap_reduce=args.overlap_reduce,
                   bucket_elems=args.bucket_elems,
                   **(zero.step_kwargs() if zero else {}))
    if supervisor is not None:
        _, resync_fn = make_consensus_fns(mesh)

        def build_step(level):
            rkw = level_reduce_kwargs(level, args.grad_exp, args.grad_man)
            # the blocked wire exists on the ring rung alone
            return make_train_step(
                model, opt, mesh, verify_reduce=True,
                wire_fault_plan=wire_plan if level == "ring" else None,
                block_scale=args.block_scale and rkw["mode"] == "ring",
                **rkw, **step_kw)

        step_table = StepTable(build_step)
        train_step = step_table[supervisor.mode]
    else:
        # fast mode detects only: a failed step's update is kept, as the
        # JAX trainer keeps it
        train_step = make_train_step(
            model, opt, mesh, mode=args.mode, grad_exp=args.grad_exp,
            grad_man=args.grad_man, verify_reduce=verify,
            keep_failed=verify, wire_fault_plan=wire_plan,
            block_scale=args.block_scale, **step_kw)
    eval_step = make_eval_step(model, mesh)

    global_batch = args.batch_size * mesh.world * args.emulate_node
    # this process's contiguous slice of each global batch
    host_batch = global_batch // n_proc
    pipeline = CIFAR10Pipeline(train_x, train_y, host_batch, augment=True,
                               cutout=0)
    eval_bs = max(mesh.world,
                  (min(1000, len(test_y)) // mesh.world) * mesh.world)
    eval_pipe = CIFAR10Pipeline(test_x, test_y, eval_bs, augment=False)

    def validate() -> dict:
        # rank 0 alone: every rank holds the same weights and BN stats
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

    def export_torch() -> None:
        if args.export_torch and rank == 0:
            interop.save_torch_checkpoint(
                interop.export_reference_resnet18_cifar(model),
                args.export_torch)
            print(f"=> exported torch checkpoint {args.export_torch}")

    if args.evaluate:
        res = validate() if rank == 0 else {}
        export_torch()
        return res

    sampler = DistributedGivenIterationSampler(
        len(train_y), total_iter, host_batch, world_size=n_proc, rank=rank,
        seed=0, last_iter=start_iter - 1)
    best, last, diverged, step_no = 0.0, {}, False, start_iter
    t0 = now()
    # the augmentation's epoch counts batches drawn, discarded ones too
    for drawn, idx in enumerate(sampler.batches(), start_iter):
        x, y = pipeline.batch(idx, seed=drawn // iter_per_epoch)
        lr = schedule(step_no)
        state, metrics = train_step(state, x, y)
        last = {k: float(v) for k, v in metrics.items()}
        failed = last.get("reduce_ok", 1.0) == 0.0
        if failed and supervisor is None:
            meter.bump("wire_faults_detected")
            if rank == 0:
                print(f"=> reduce verify FAILED at iter {step_no + 1} "
                      f"(mode {args.mode} has no transport ladder: "
                      f"detection only)", file=sys.stderr)
        if failed and supervisor is not None:
            # the step discarded its update; the ladder decides what next
            meter.bump("wire_faults_detected")
            action = supervisor.on_failure(step_no)
            if action == "give_up":
                if rank == 0:
                    print(f"=> verified reduce failed at the fp32 "
                          f"transport floor (iter {step_no + 1}) — not a "
                          f"wire problem; stopping", file=sys.stderr)
                diverged = True
                break
            if action == "downgrade":
                meter.bump("transport_downgrades")
                state = resync_fn(state)
                meter.bump("resyncs")
                train_step = step_table[supervisor.mode]
                if rank == 0:
                    print(f"=> wire fault detected at iter {step_no + 1} "
                          f"(hop_bad {int(last.get('reduce_hop_bad', 0))}, "
                          f"gather_bad "
                          f"{int(last.get('reduce_gather_bad', 0))}) — "
                          f"transport downgraded to {supervisor.mode}, "
                          f"replicas re-synced from rank 0",
                          file=sys.stderr)
            else:
                meter.bump("reduce_retries")
                if rank == 0:
                    print(f"=> wire fault detected at iter {step_no + 1} "
                          f"— update discarded, retrying on the "
                          f"{supervisor.mode} transport", file=sys.stderr)
            continue
        if supervisor is not None and \
                supervisor.on_success(step_no) == "upgrade":
            meter.bump("transport_upgrades")
            train_step = step_table[supervisor.mode]
            if rank == 0:
                print(f"=> transport probation passed at iter "
                      f"{step_no + 1}: back to {supervisor.mode}",
                      file=sys.stderr)
        step_no += 1
        # the loss is the global one: every rank stops here
        if loss_diverged(last["loss"], f"iter {step_no}", rank):
            diverged = True
            break
        if rank == 0 and (step_no % args.print_freq == 0
                          or step_no == total_iter):
            print(f"Iter: [{step_no}/{total_iter}] Loss {last['loss']:.4f} "
                  f"Prec@1 {100 * last['accuracy']:.3f} LR {lr:.4f}"
                  f"{meter.suffix()}", flush=True)
        if step_no % args.val_freq == 0 or step_no == total_iter:
            prec1 = 100 * validate()["top1"] if rank == 0 else None
            if rank == 0:
                best = max(best, prec1)
            # every rank gathers a ZeRO state's shards; rank 0 writes
            manager.save(step_no, zero.export_state(state, mesh) if zero
                         else state, best_metric=prec1)
    report_unfired(plan, n_steps=total_iter, meter=meter, rank=rank,
                   wire_armed=(supervisor.home == "ring"
                               if supervisor is not None
                               else args.mode == "ring"))
    if rank == 0 and not diverged:
        print(f"done: {step_no - start_iter} iters in {now() - t0:.1f}s "
              f"best Prec@1 {best:.2f}", flush=True)
    manager.close()
    if not diverged:
        export_torch()
    # the batches the native fused augment made (0 on the numpy path)
    out = {"step": step_no, "best_prec1": best, "diverged": diverged,
           "augment_fused_calls": pipeline.pipeline.fused_calls}
    if plan is not None or verify:
        out["resilience"] = meter.as_dict()
    if supervisor is not None:
        out["transport"] = {"mode": supervisor.mode,
                            "home": supervisor.home,
                            "transitions": list(supervisor.transitions)}
    return {**out, **last}


def main(argv=None, device="cuda") -> int:
    """Run the trainer; 0 when it finished, 3 when the loss diverged or
    the transport ladder gave up."""
    res = run(parse_args(argv), device=device)
    return 3 if res.get("diverged") else 0


if __name__ == "__main__":
    sys.exit(main())
