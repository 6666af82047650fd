"""Transformer-LM trainer of the port (port of the default data-parallel
path of `examples/lm/train.py`).

    python -m cpd_tpu_torch.examples.lm.train --vocab-size 32000 \\
        --d-model 512 --n-layers 4 --n-heads 8 --n-kv-heads 2 \\
        --seq-len 1024 --batch-size 4 --dp 2 --attn-impl flash \\
        --flash-bwd pallas --ffn-exp 4 --ffn-man 3 --ffn-mode faithful \\
        --use_APS --grad_exp 5 --grad_man 2 --max-iter 20

    python -m cpd_tpu_torch.examples.lm.train --vocab-size 32000 \\
        --d-model 512 --n-layers 8 --n-heads 8 --seq-len 1024 \\
        --batch-size 4 --dp 2 --bf16 --attn-impl flash --remat \\
        --use_APS --grad_exp 5 --grad_man 2 --max-iter 20

    python -m torch.distributed.run --nproc_per_node 4 \\
        -m cpd_tpu_torch.examples.lm.train --dist --optimizer adamw \\
        --emulate_node 2 --use_APS --grad_exp 5 --grad_man 2

``--dp N`` data-parallel ranks on a `LocalMesh` on the one card (default
1), or with ``--dist`` one rank per process (`parallel.dist.dist_init`
reads the launcher's variables; ``--dist-backend`` ``nccl``, one process
per card, or ``gloo`` for processes that share a card or run on the
CPU; the backend is never guessed): every process draws the same global
batch and takes its own rows of it (`parallel.dist.local_rows`), starts
from rank 0's weights (`parallel.dist.replicate`), and rank 0 alone
prints.  ``--batch-size`` sequences a rank and micro-batch, ``--emulate_node
N`` micro-batches a rank reduced locally before the cross-rank reduce
(the global batch is batch-size x ranks x N), from the synthetic
Markov-chain corpus (`data.lm_data.SyntheticText`, 4096 sequences, the
last batch-size x ranks held out for validation); random weights at
flax's default scales from a seeded generator (`TransformerLM.init_weights`,
seed 0: not the JAX trainer's flax init); ``--optimizer`` sgd, nesterov
(momentum 0.9) or adamw (b1 0.9) under the constant (warmup, then
``--base-lr``) or ``--lr-schedule cosine`` schedule; the APS
low-precision gradient reduce as the ResNet trainer has it; validation
every ``--val-freq`` iterations and at the end (on every rank's rows).
``--bf16`` computes in bf16 over fp32 master weights (the JAX trainer's
``dtype=bfloat16``), ``--remat`` recomputes each block in the backward
pass, and ``--attn-impl flash`` runs the GQA flash kernels with
``--n-kv-heads`` and the MHA flash kernel (K11) without.
``--overlap-reduce`` reduces each gradient bucket (``--bucket-elems``
elements at most) from inside the backward, bitwise the post-backward
reduce at the same layout (at ``--sp 1``).

``--sp N`` adds the sequence-parallel axis: ``--dp`` x ``--sp`` ranks on
the card's `LocalMesh`, or under ``--dist`` the group's processes as
world / N dp ranks x N (start dp x sp processes); each rank takes the
rows of its dp index and the columns of its sp index (``--seq-len`` a
multiple of N) and every attention layer runs ``--sp-mode ring`` (K/V
rotate around the sp ranks) or ``ulysses`` (all-to-all between sequence
and heads; ``--n-heads`` a multiple of N, and with ``--attn-impl flash``
the flash kernels on the gathered sequence).  ``--dropout`` drops the
residual branches in training with flax's masks (seed 0, as the JAX
trainer).

``--tp N`` adds Megatron tensor parallelism (``--n-heads`` and
``--n-kv-heads`` multiples of N): ``--dp`` x ``--sp`` x ``--tp`` ranks
on the card's `LocalMesh` (one full-width model, each tp rank on its
slices), or under ``--dist`` the group's processes as world / (sp x tp)
dp ranks x sp x tp, each process holding its shard of rank 0's
full-width weights (`TransformerLM.load_shard`); the tp ranks of a block
take the same tokens.  ``--scan-layers`` keeps the blocks in the scanned
layout (leaves stacked over the layers, flax's ``nn.scan`` with its
dropout keys); not with ``--sample``.  Flags of the JAX trainer whose
subsystem is not ported yet raise "not yet ported" with their ROADMAP
row: ``--overlap-reduce`` at ``--sp`` or ``--tp`` > 1 (Queue A row 2),
``--sample*`` (row 3: `generate`), ``--pp``, ``--vocab-pp`` and
``--n-microbatches`` (row 4: pipeline), ``--moe``/``--n-experts``/
``--ep`` (row 5: MoE), checkpoints and ``--save-path``/
``--export-torch`` (A8), the resilience flags (A10) and the
observability flags (A11).
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

from ...obs.timing import now

# flags of the JAX trainer that the port does not have yet (presence
# alone selects their subsystem)
_NOT_PORTED = (
    "--vocab-pp", "--moe", "--n-experts", "--n-microbatches",
    "--save-path", "--ckpt-freq",
    "--tensorboard", "--sample-temperature", "--sample-top-k",
    "--sample-top-p", "--sample-seed", "--profile-dir", "--export-torch",
    "--obs-dir", "--obs-flight",
    "--fault-plan", "--guard-grads", "--spike-factor", "--watchdog-timeout",
    "--divergence-window", "--divergence-factor", "--divergence-mode",
    "--max-rollbacks", "--rollback-backoff", "--no-ckpt-integrity",
    "--verify-reduce", "--reduce-retries", "--transport-probation",
    "--precision-ladder", "--sat-threshold", "--sat-patience",
    "--precision-probation", "--quant-telemetry", "--elastic",
    "--heartbeat-patience", "--straggler-factor")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="cpd_tpu_torch transformer LM (dp ranks on the card, "
                    "or one rank per process with --dist)")
    p.add_argument("--dp", default=1, type=int,
                   help="data-parallel ranks on the card's LocalMesh "
                        "(1 under --dist)")
    p.add_argument("--sp", default=1, type=int,
                   help="sequence-parallel ranks: x --dp on the card's "
                        "LocalMesh, or under --dist the group's processes "
                        "as world/sp dp ranks x sp")
    p.add_argument("--sp-mode", default="ring", choices=["ring", "ulysses"],
                   help="sequence-parallel attention: ring (K/V rotate "
                        "around the sp ranks) or ulysses (all-to-all "
                        "heads<->sequence; needs --n-heads divisible by "
                        "--sp)")
    p.add_argument("--tp", default=1, type=int,
                   help="tensor-parallel (Megatron) ranks: x --dp x --sp "
                        "on the card's LocalMesh, or under --dist the "
                        "group's processes as world/(sp*tp) dp ranks x sp "
                        "x tp")
    p.add_argument("--pp", default=1, type=int,
                   help="not yet ported > 1 (ROADMAP Queue A row 4)")
    p.add_argument("--ep", default=1, type=int,
                   help="not yet ported > 1 (ROADMAP Queue A row 5)")
    p.add_argument("--vocab-size", default=256, type=int)
    p.add_argument("--d-model", default=256, type=int)
    p.add_argument("--n-layers", default=4, type=int)
    p.add_argument("--n-heads", default=8, type=int)
    p.add_argument("--n-kv-heads", default=None, type=int,
                   help="GQA: fewer K/V heads than query heads (must "
                        "divide --n-heads; default = MHA)")
    p.add_argument("--seq-len", default=256, type=int)
    p.add_argument("--batch-size", default=8, type=int,
                   help="sequences per dp rank per step")
    p.add_argument("--max-iter", default=200, type=int)
    p.add_argument("--base-lr", default=0.01, type=float)
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "cosine"])
    p.add_argument("--optimizer", default="sgd",
                   choices=["sgd", "nesterov", "adamw"],
                   help="momentum 0.9 (adamw: b1 0.9)")
    p.add_argument("--warmup-iters", default=20, type=int)
    p.add_argument("--print-freq", default=10, type=int)
    p.add_argument("--val-freq", default=100, type=int)
    p.add_argument("--grad_exp", default=8, type=int)
    p.add_argument("--grad_man", default=23, type=int)
    p.add_argument("--grad-rounding", default="nearest",
                   choices=["nearest", "stochastic"])
    p.add_argument("--grad-seed", default=0, type=int)
    p.add_argument("--use_APS", action="store_true")
    p.add_argument("--use_kahan", action="store_true")
    p.add_argument("--emulate_node", default=1, type=int,
                   help="micro-batches a rank runs and reduces locally "
                        "before the cross-rank reduce")
    p.add_argument("--dist", action="store_true",
                   help="one rank per process in a torch.distributed group "
                        "(launch with torchrun); a no-op outside a cluster")
    p.add_argument("--dist-backend", default="nccl",
                   choices=["nccl", "gloo"],
                   help="the group's backend under --dist: nccl, one "
                        "process per card; gloo, processes that share a "
                        "card or run on the CPU")
    p.add_argument("--mode", default="faithful",
                   choices=["faithful", "fast", "ring"])
    p.add_argument("--block-scale", action="store_true",
                   help="block-scaled ring wire (needs --mode ring and "
                        "man >= 2)")
    p.add_argument("--block-size", default=128, type=int)
    p.add_argument("--overlap-reduce", action="store_true",
                   help="reduce each gradient bucket from inside the "
                        "backward, the moment its last gradient is ready "
                        "(bitwise the post-backward reduce)")
    p.add_argument("--bucket-elems", default=None, type=int,
                   help="per-bucket element cap of the reduce (default "
                        "4M)")
    p.add_argument("--ffn-exp", default=8, type=int,
                   help="MLP GEMM accumulator exponent bits; (--ffn-exp, "
                        "--ffn-man) != (8, 23) makes wi/wo_mlp run the "
                        "quantized GEMM recipe")
    p.add_argument("--ffn-man", default=23, type=int)
    p.add_argument("--ffn-mode", default="faithful",
                   choices=["faithful", "fast"])
    p.add_argument("--flash-bwd", default="chunked",
                   choices=["chunked", "pallas"],
                   help="GQA flash backward: the chunked recompute or the "
                        "flash-backward kernels (with --attn-impl flash)")
    p.add_argument("--attn-impl", default="xla",
                   choices=["xla", "flash", "chunked"],
                   help="flash: the GQA flash kernels with --n-kv-heads, "
                        "the MHA flash kernel (K11) without")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute dtype (fp32 master params; the "
                        "gradients stay fp32)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block's forward in the backward "
                        "pass (activation memory for compute)")
    p.add_argument("--scan-layers", action="store_true",
                   help="the scanned block stack: leaves stacked over the "
                        "layers (flax's nn.scan layout and dropout keys)")
    p.add_argument("--label-smoothing", default=0.0, type=float)
    p.add_argument("--dropout", default=0.0, type=float,
                   help="residual-branch dropout rate in [0, 1) (training "
                        "only; flax's masks)")
    p.add_argument("--sample", default=0, type=int,
                   help="not yet ported > 0 (ROADMAP Queue A row 3: "
                        "generate)")
    return p


def _not_ported(what: str, row: str = "Queue A") -> SystemExit:
    return SystemExit(f"{what}: not yet ported to cpd_tpu_torch (ROADMAP "
                      f"{row})")


def parse_args(argv=None) -> argparse.Namespace:
    args, rest = build_parser().parse_known_args(argv)
    if rest:
        flag = rest[0].split("=", 1)[0]
        if flag in _NOT_PORTED:
            raise _not_ported(flag)
        build_parser().error(f"unrecognized arguments: {' '.join(rest)}")
    if args.scan_layers and args.sample > 0:
        raise SystemExit("--sample (KV-cache decode) does not compose with "
                         "--scan-layers")
    for flag, value, default, row in (("--sample", args.sample, 0, 3),
                                      ("--pp", args.pp, 1, 4),
                                      ("--ep", args.ep, 1, 5)):
        if value != default:
            raise _not_ported(f"{flag} {value}", f"Queue A row {row}")
    for flag, value in (("--dp", args.dp), ("--sp", args.sp),
                        ("--tp", args.tp)):
        if value < 1:
            raise SystemExit(f"{flag} must be >= 1, got {value}")
    if args.seq_len % args.sp:
        raise SystemExit(f"seq-len {args.seq_len} not divisible by "
                         f"sp={args.sp}")
    if args.n_heads % args.tp:
        raise SystemExit(f"n-heads {args.n_heads} not divisible by "
                         f"tp={args.tp}")
    if args.n_kv_heads is not None and args.n_kv_heads % args.tp:
        raise SystemExit(f"n-kv-heads {args.n_kv_heads} not divisible by "
                         f"tp={args.tp}")
    if args.sp > 1 and args.sp_mode == "ulysses" and (
            args.n_heads // args.tp) % args.sp:
        raise SystemExit(f"--sp-mode ulysses needs the local heads "
                         f"{args.n_heads // args.tp} (--n-heads / --tp) "
                         f"divisible by --sp {args.sp}")
    if args.sp > 1 and args.sp_mode == "ring" and args.attn_impl == "flash":
        raise SystemExit("--attn-impl flash does not compose with --sp-mode "
                         "ring (the ring's online softmax is its own "
                         "schedule); use --sp-mode ulysses")
    if (args.sp > 1 or args.tp > 1) and args.overlap_reduce:
        raise _not_ported("--overlap-reduce at --sp or --tp > 1",
                          "Queue A row 2")
    if not 0.0 <= args.dropout < 1.0:
        raise SystemExit(f"--dropout must be in [0, 1), got {args.dropout}")
    if args.dist and args.dp != 1:
        raise SystemExit(f"--dist runs one rank per process; --dp "
                         f"{args.dp} asks for {args.dp} in each")
    if args.emulate_node < 1:
        raise SystemExit(f"--emulate_node must be >= 1, got "
                         f"{args.emulate_node}")
    if args.n_kv_heads is not None:
        if args.n_kv_heads < 1:
            raise SystemExit(f"n-kv-heads must be >= 1, got "
                             f"{args.n_kv_heads}")
        if args.n_heads % args.n_kv_heads:
            raise SystemExit(f"n-heads {args.n_heads} not divisible by "
                             f"n-kv-heads {args.n_kv_heads}")
    if args.d_model % args.n_heads:
        raise SystemExit(f"d-model {args.d_model} not divisible by n-heads "
                         f"{args.n_heads}")
    if (args.d_model // args.n_heads) % 2:
        raise SystemExit(f"head dim {args.d_model // args.n_heads} must be "
                         "even (RoPE splits it in half)")
    if args.flash_bwd != "chunked" and not (
            args.attn_impl == "flash" and args.n_kv_heads is not None):
        raise SystemExit(
            "--flash-bwd pallas selects the GQA flash-backward kernels, "
            "which only run with --attn-impl flash AND --n-kv-heads (the "
            "MHA flash path uses the stock kernel's own backward)")
    if args.block_scale and args.mode != "ring":
        raise SystemExit("--block-scale needs --mode ring: the per-block "
                         "scale sidecar rides the ring's packed wire")
    if args.block_scale and args.grad_man < 2:
        raise SystemExit(f"--block-scale needs a packable gradient format "
                         f"(man_bits >= 2 for the codec's special codes), "
                         f"got e{args.grad_exp}m{args.grad_man}")
    return args


def run(args: argparse.Namespace, device="cuda") -> dict:
    """Train as the flags say on ``--dp`` x ``--sp`` x ``--tp``
    `LocalMesh` ranks on ``device``, or with ``--dist`` on this process's
    one rank of the group (under nccl ``device`` is the rank's card);
    returns the last
    metrics with ``step``, ``diverged``, ``seconds`` and ``val`` (the
    last validation's metrics)."""
    import torch
    import torch.distributed

    from ...data.lm_data import SyntheticText
    from ...device import resolve_device
    from ...models.transformer import transformer_lm
    from ...parallel.dist import dist_init, local_rows, replicate
    from ...parallel.mesh import make_mesh
    from ...train import (create_train_state, make_optimizer,
                          warmup_cosine, warmup_step_decay)
    from ...train.lm import make_lm_eval_step, make_lm_train_step

    rank, _ = dist_init(args.dist_backend) if args.dist else (0, 1)
    grouped = args.dist and torch.distributed.is_initialized()
    dev = resolve_device(device)
    mesh = make_mesh(None if grouped else args.dp, args.sp, dev, tp=args.tp)
    model_kw = dict(vocab_size=args.vocab_size, d_model=args.d_model,
                    n_layers=args.n_layers, n_heads=args.n_heads,
                    n_kv_heads=args.n_kv_heads, attn_impl=args.attn_impl,
                    flash_bwd=args.flash_bwd, remat=args.remat,
                    scan_layers=args.scan_layers,
                    dtype=torch.bfloat16 if args.bf16 else torch.float32,
                    sp_axis="sp" if args.sp > 1 else None,
                    sp_mode=args.sp_mode, dropout_rate=args.dropout,
                    tp_axis="tp" if args.tp > 1 else None)
    if (args.ffn_exp, args.ffn_man) != (8, 23):
        model_kw.update(ffn_exp=args.ffn_exp, ffn_man=args.ffn_man,
                        ffn_mode=args.ffn_mode)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    model = transformer_lm(**model_kw, device=mesh.device).init_weights(gen)
    replicate(model, mesh)
    if grouped and args.tp > 1:
        # this process holds its shard of rank 0's full-width weights
        model = transformer_lm(**model_kw, tp_size=args.tp,
                               device=mesh.device).load_shard(
            model, mesh.coords(mesh.rank)["tp"])
    if args.lr_schedule == "cosine":
        schedule = warmup_cosine(args.base_lr, args.warmup_iters,
                                 args.max_iter)
    else:
        schedule = warmup_step_decay(args.base_lr, args.warmup_iters,
                                     [args.max_iter * 2], warmup_from=0.0)
    opt = make_optimizer(args.optimizer, schedule, momentum=0.9)
    state = create_train_state(model, opt)
    step = make_lm_train_step(
        model, opt, mesh, emulate_node=args.emulate_node,
        use_aps=args.use_APS, grad_exp=args.grad_exp,
        grad_man=args.grad_man, use_kahan=args.use_kahan, mode=args.mode,
        label_smoothing=args.label_smoothing,
        grad_rounding=args.grad_rounding, grad_seed=args.grad_seed,
        block_scale=args.block_scale, block_size=args.block_size,
        overlap_reduce=args.overlap_reduce, bucket_elems=args.bucket_elems)
    eval_step = make_lm_eval_step(model, mesh)

    ds = SyntheticText(n=4096, seq_len=args.seq_len,
                       vocab_size=args.vocab_size)
    # the dp ranks' rows; the sp ranks split their columns, the tp ranks
    # share their block
    global_batch = (args.batch_size * (mesh.world // (args.sp * args.tp))
                    * args.emulate_node)
    val_bs = global_batch // args.emulate_node
    val_toks, val_tgts = ds.batch(np.arange(len(ds) - val_bs, len(ds)),
                                  seed=-1)
    val_toks, val_tgts = local_rows(val_toks, mesh), local_rows(val_tgts,
                                                                mesh)
    train_n = len(ds) - val_bs
    rng = np.random.RandomState(0)

    def validate(it: int) -> dict:
        # every rank evaluates its rows; the metrics are the global ones
        m = {k: float(v) for k, v in eval_step(state, val_toks,
                                               val_tgts).items()}
        if rank == 0:
            print(f"Val [{it}]: loss {m['loss']:.4f} acc "
                  f"{100 * m['accuracy']:.2f}", flush=True)
        return m

    last, val, diverged, step_no = {}, {}, False, 0
    t0 = now()
    for it in range(1, args.max_iter + 1):
        toks, tgts = ds.batch(rng.randint(0, train_n, size=global_batch),
                              seed=it)
        state, metrics = step(state, local_rows(toks, mesh),
                              local_rows(tgts, mesh))
        last = {k: float(v) for k, v in metrics.items()}
        step_no = it
        # the loss is the global one: every rank stops here
        if not math.isfinite(last["loss"]):
            if rank == 0:
                print(f"=> non-finite loss {last['loss']} at iter {it}: "
                      "diverged", file=sys.stderr)
            diverged = True
            break
        if rank == 0 and (it % args.print_freq == 0 or it == args.max_iter):
            print(f"Iter: [{it}/{args.max_iter}] Loss {last['loss']:.4f} "
                  f"Acc {100 * last['accuracy']:.2f} TokPerSec "
                  f"{global_batch * args.seq_len * it / (now() - t0):.0f}",
                  flush=True)
        if it % args.val_freq == 0 or it == args.max_iter:
            val = validate(it)
    dt = now() - t0
    if rank == 0 and not diverged and last:
        print(f"done: {step_no} iters in {dt:.1f}s "
              f"({step_no * global_batch * args.seq_len / dt:.0f} tok/s) "
              f"final loss {last['loss']:.4f}", flush=True)
    return {"step": step_no, "diverged": diverged, "seconds": dt,
            "val": val, **last}


def main(argv=None, device="cuda") -> int:
    """Run the trainer; 0 when it finished, 3 when the loss diverged."""
    res = run(parse_args(argv), device=device)
    return 3 if res["diverged"] else 0


if __name__ == "__main__":
    sys.exit(main())
