"""The LM train and eval steps (port of `make_lm_train_step` /
`make_lm_eval_step` from `cpd_tpu/train/lm.py`: the data-parallel arm,
sp = tp = 1, the monolithic reduce).

One train step over a mesh of W ranks, as the JAX step runs it under
`shard_map` on a ("dp",) mesh:

1. rank r takes rows ``[r*B*N, (r+1)*B*N)`` of the global (W*B*N, T)
   token batch (a `ProcessMesh` step is handed its process's rows alone,
   `parallel.dist.local_rows`, and takes them all) and splits them into
   N = ``emulate_node`` contiguous micro-batches of B rows; each
   micro-batch runs its forward and backward and takes the gradients of
   its next-token cross-entropy SUM over one micro-batch's global token
   count W*B*T, divided by N (so the reduced sum is the mean);
   ``label_smoothing`` mixes in the closed-form uniform term
   (1-a)·CE + a·(logsumexp − mean logit);
2. with N > 1 each rank reduces its N gradients locally
   (`parallel.emulate.emulate_node_reduce`: local APS shift, cast,
   ordered quantized sum; under SR rank r keys it with
   ``fold_in(grad_sr_key(grad_seed, step, 0), r)``);
3. the per-rank gradients are reduced by `parallel.dist.sum_gradients`
   with every option it takes (APS, format, Kahan, mode, rounding and
   ``grad_sr_key(grad_seed, step, 1)``, verify, wire fault, block scale,
   the health counters);
4. the optimizer updates the fp32 master weights with rank 0's reduced
   gradients.

Metrics: ``loss`` and ``accuracy`` (argmax hits) over the global token
count W*B*N*T, summed over every micro-batch and rank through the mesh
(in rank order, so a `ProcessMesh` gives the `LocalMesh`'s bits), plus
``reduce_*`` with ``verify_reduce`` and ``prec_*`` with
``quant_stats``.  The step runs with TF32 off and bf16 matmuls reducing
in fp32 (`fp32_numerics`).  A model with a bf16 compute dtype returns
fp32 logits and holds fp32 parameters, so the loss, the gradients and
the reduce stay fp32.  Each micro-batch's logits and their gradient are
freed before the next runs, so one (B, T, vocab) fp32 tensor pair is
live at a time.  ``overlap_reduce`` runs steps 2-3 from inside the
last local rank's last backward, each bucket of ``bucket_elems`` as
soon as its gradients are whole (`train.step.overlap_backward`),
bitwise the post-backward reduce at the same layout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.dist import grad_sr_key, sum_gradients
from ..parallel.emulate import emulate_node_reduce
from ..parallel.overlap import BucketPlan
from ..quant.prng import fold_in
from .state import TrainState
from .step import _wire_fault, fp32_numerics, overlap_backward

__all__ = ["make_lm_train_step", "make_lm_eval_step", "lm_local_gradients",
           "as_tokens"]


def as_tokens(tokens, targets, device) -> tuple:
    """(N, T) tokens and targets (numpy or tensors) as int64 on
    ``device``."""
    return (torch.as_tensor(tokens).to(device, torch.int64),
            torch.as_tensor(targets).to(device, torch.int64))


def _rank_rows(n: int, mesh) -> int:
    """Rows each local rank of ``mesh`` takes of ``n`` handed ones."""
    local = len(mesh.ranks)
    if n % local:
        raise ValueError(f"batch {n} is not a multiple of the {local} "
                         "local ranks")
    return n // local


def _ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token integer-label cross-entropy, (B, T)."""
    v = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, v), targets.reshape(-1),
                           reduction="none").reshape(targets.shape)


def lm_local_gradients(model, toks: torch.Tensor, tgts: torch.Tensor, mesh,
                       label_smoothing: float = 0.0,
                       emulate_node: int = 1, backward=None) -> tuple:
    """Step 1 for every local rank of ``mesh``: the i-th local rank's
    forward and backward on rows ``[i*B*N, (i+1)*B*N)`` of ``toks``/
    ``tgts`` (the global batch on a `LocalMesh`, this process's rows on a
    `ProcessMesh`) as N = ``emulate_node`` contiguous micro-batches of B
    rows in turn.  Returns ``(grads, sums, hits)``, one entry per local
    rank: the gradients of each micro-batch's CE sum / (W*B*T) / N in
    ``parameters()`` order (at N > 1 each leaf stacks the N micro-batch
    gradients, ``(N, *shape)``), the CE sum and the count of argmax hits
    over its micro-batches.  ``backward``: the last backward's hook, as
    `train.step.local_gradients` takes it."""
    per_rank, n = _rank_rows(toks.shape[0], mesh), emulate_node
    if per_rank < n or per_rank % n:
        raise ValueError(
            f"per-rank batch {per_rank} must be a positive multiple of "
            f"emulate_node={n} (global batch = ranks * per-rank batch; "
            f"each rank's rows are split into emulate_node sequential "
            f"micro-batches)")
    b = per_rank // n
    # one micro-batch's tokens over the dp ranks (the JAX step's psum)
    global_n = float(b * toks.shape[1] * mesh.world)
    params = list(model.parameters())
    model.train()
    grads, sums, hits = [], [], []
    for i in range(len(mesh.ranks)):
        micro, rank_sum, rank_hits = [], None, None
        for j in range(n):
            lo = i * per_rank + j * b
            tk, tg = toks[lo:lo + b], tgts[lo:lo + b]
            logits = model(tk)
            ce = _ce(logits, tg)
            if label_smoothing:
                uniform = (torch.logsumexp(logits, dim=-1)
                           - logits.mean(dim=-1))
                ce = (1.0 - label_smoothing) * ce + label_smoothing * uniform
            local_sum = ce.sum()
            objective = local_sum / global_n / n
            if backward is not None and i == len(mesh.ranks) - 1 \
                    and j == n - 1:
                micro.append(list(backward(objective, params, grads,
                                           micro)))
            else:
                micro.append(list(torch.autograd.grad(
                    objective, params, allow_unused=True,
                    materialize_grads=True)))
            hit = (logits.detach().argmax(-1) == tg).sum()
            local_sum = local_sum.detach()
            rank_sum = local_sum if rank_sum is None else rank_sum + local_sum
            rank_hits = hit if rank_hits is None else rank_hits + hit
            del logits, ce
        grads.append(micro[0] if n == 1 else
                     [torch.stack(gs) for gs in zip(*micro)])
        del micro
        sums.append(rank_sum)
        hits.append(rank_hits)
    return grads, sums, hits


def make_lm_train_step(model, opt, mesh, *, emulate_node: int = 1,
                       use_aps: bool = False, grad_exp: int = 8,
                       grad_man: int = 23, use_kahan: bool = False,
                       mode: str = "faithful", label_smoothing: float = 0.0,
                       grad_rounding: str = "nearest", grad_seed: int = 0,
                       verify_reduce: bool = False, wire_fault_plan=None,
                       quant_stats: bool = False,
                       block_scale: bool = False, block_size: int = 128,
                       overlap_reduce: bool = False,
                       bucket_elems: Optional[int] = None,
                       fused: Optional[bool] = None):
    """``step(state, tokens, targets) -> (state, metrics)`` over
    ``mesh``: tokens/targets (W * B * N, T) int with N =
    ``emulate_node``, on a `ProcessMesh` this process's (B * N) rows of
    them; each rank takes its contiguous B * N rows as N micro-batches
    (module docstring).  ``metrics`` are 0-d tensors on the device;
    ``quant_stats`` adds the reduce wire's health counters as float32
    ``prec_wire_sat``, ``prec_wire_underflow``, ``prec_wire_nan``,
    ``prec_wire_total`` and ``prec_aps_bad``.  ``bucket_elems`` caps the
    reduce's buckets; ``overlap_reduce`` reduces them from inside the
    backward (module docstring).  ``fused`` goes to the emulate-node
    reduce, `sum_gradients` and the optimizer (None: the kernels on
    CUDA)."""
    if emulate_node < 1:
        raise ValueError(f"emulate_node must be >= 1, got {emulate_node}")
    if not 0.0 <= label_smoothing < 1.0:
        raise ValueError(f"label_smoothing must be in [0, 1), got "
                         f"{label_smoothing}")
    if grad_rounding not in ("nearest", "stochastic"):
        raise ValueError(f"unknown grad_rounding {grad_rounding!r}")
    if block_scale and mode != "ring":
        raise ValueError(
            f"block_scale=True needs mode='ring' (got {mode!r}): the "
            f"per-block scale sidecar rides the ring's packed wire")
    sr = grad_rounding == "stochastic"
    prec_kw = dict(use_aps=use_aps, grad_exp=grad_exp, grad_man=grad_man,
                   use_kahan=use_kahan, mode=mode, rounding=grad_rounding,
                   block_scale=block_scale, block_size=block_size)
    plan = (BucketPlan.for_tree(list(model.parameters()), bucket_elems)
            if overlap_reduce else None)

    def step(state: TrainState, tokens, targets):
        toks, tgts = as_tokens(tokens, targets, mesh.device)
        total_n = float(toks.shape[0] // len(mesh.ranks) * toks.shape[1]
                        * mesh.world)
        sum_key = grad_sr_key(grad_seed, state.step, 1) if sr else None
        fault = (_wire_fault(wire_fault_plan, state.step)
                 if wire_fault_plan is not None and mode == "ring" else None)
        emu_key = grad_sr_key(grad_seed, state.step, 0) if sr else None
        with fp32_numerics():
            if overlap_reduce:
                backward, res = overlap_backward(
                    mesh, plan, dict(prec_kw, bucket_elems=bucket_elems,
                                     fused=fused),
                    emulate_node=emulate_node, use_aps=use_aps,
                    grad_exp=grad_exp, grad_man=grad_man, key=sum_key,
                    emu_key=emu_key, wire_fault=fault, verify=verify_reduce,
                    stats=quant_stats, fused=fused)
                _, sums, hits = lm_local_gradients(
                    model, toks, tgts, mesh, label_smoothing, emulate_node,
                    backward)
                reduced, report = res["reduced"], res["report"]
            else:
                grads, sums, hits = lm_local_gradients(
                    model, toks, tgts, mesh, label_smoothing, emulate_node)
                if emulate_node > 1:
                    grads = [emulate_node_reduce(
                        g, emulate_node, use_aps, grad_exp, grad_man,
                        key=fold_in(emu_key, r) if sr else None,
                        rounding=grad_rounding, fused=fused)
                        for g, r in zip(grads, mesh.ranks)]
                out = sum_gradients(grads, mesh, key=sum_key,
                                    verify=verify_reduce, wire_fault=fault,
                                    stats=quant_stats,
                                    bucket_elems=bucket_elems, fused=fused,
                                    **prec_kw)
                del grads
                reduced, report = (out if verify_reduce or quant_stats
                                   else (out, None))
            state.opt_state = opt.apply(reduced[0], state.opt_state,
                                        list(model.parameters()),
                                        fused=fused)
        state.step += 1
        metrics = {"loss": mesh.sum(sums)[0] / total_n,
                   "accuracy": mesh.sum(hits)[0].to(torch.float32)
                   / total_n}
        if verify_reduce:
            metrics.update({f"reduce_{k}": report[k].to(torch.float32)
                            for k in ("ok", "hop_bad", "gather_bad",
                                      "agree")})
        if quant_stats:
            metrics.update({f"prec_{k}": report[k].to(torch.float32)
                            for k in ("wire_sat", "wire_underflow",
                                      "wire_nan", "wire_total", "aps_bad")})
        return state, metrics

    return step


def make_lm_eval_step(model, mesh):
    """``eval_step(state, tokens, targets) -> {'loss', 'accuracy'}``:
    plain next-token CE and argmax accuracy over the global token count,
    each local rank on its contiguous rows (on a `ProcessMesh` this
    process's rows, and every rank calls it), no gradients."""

    @torch.no_grad()
    def eval_step(state: TrainState, tokens, targets):
        toks, tgts = as_tokens(tokens, targets, mesh.device)
        b = _rank_rows(toks.shape[0], mesh)
        model.eval()
        sums, hits = [], []
        with fp32_numerics():
            for i in range(len(mesh.ranks)):
                tg = tgts[i * b:(i + 1) * b]
                logits = model(toks[i * b:(i + 1) * b])
                sums.append(_ce(logits, tg).sum())
                hits.append((logits.argmax(-1) == tg).sum())
        n = float(b * toks.shape[1] * mesh.world)
        return {"loss": mesh.sum(sums)[0] / n,
                "accuracy": mesh.sum(hits)[0].to(torch.float32) / n}

    return eval_step
