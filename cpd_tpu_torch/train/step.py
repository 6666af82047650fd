"""The data-parallel train and eval steps (port of `make_train_step` /
`make_eval_step` from `cpd_tpu/train/step.py`).

One train step over a mesh of W ranks, as the JAX step runs it under
`shard_map`:

1. rank r takes rows ``[r*B*N, (r+1)*B*N)`` of the global batch and
   splits them into N = ``emulate_node`` contiguous micro-batches of B
   (a `ProcessMesh` step is handed its process's rows alone,
   `parallel.dist.local_rows`, and takes them all);
   each micro-batch runs its forward and backward from the BN stats the
   previous one left (the first from the step's stats), and takes the
   gradients of ``loss / (W*N) * loss_scale`` (so the reduced SUM is the
   mean; a static ``loss_scale`` is not divided out again, as in the
   reference; ``"dynamic"`` takes the scale from the optimizer's
   `train.scaling` wrapper, which divides it out);
2. with N > 1 each rank reduces its N gradients locally
   (`parallel.emulate.emulate_node_reduce`: local APS shift, cast,
   ordered quantized sum);
3. the per-rank gradients are reduced by `parallel.dist.sum_gradients`
   (APS, eXmY casts rounded to nearest or stochastically, the faithful
   scan, the ring or fast mode, optionally Kahan-compensated,
   block-scaled, verified and observed by the health counters);
4. the optimizer (`train.optim`: SGD, LARS, `quant_sgd`, AdamW, any
   of them behind global-norm clipping or dynamic loss scaling) updates
   the fp32 master weights with the reduced gradients;
5. the BN running stats become the mean of the ranks' stats, and the
   loss and the top-1 hits are summed over the ranks, each through the
   mesh (in rank order, so a `ProcessMesh` gives the `LocalMesh`'s bits).

``overlap_reduce`` runs steps 2-3 from inside the backward of the last
local rank's last micro-batch (`parallel.overlap.overlapped_grads`):
each bucket of ``bucket_elems`` reduces as soon as its last gradient
is ready, bitwise the post-backward reduce at the same layout.  A custom
updater (``update_fn``, `parallel.zero`'s ZeRO-1/2) takes the place of
step 4 and owns its collective: with ``reduce_in_update`` it is handed
the local gradients and reduce-scatters them itself (ZeRO-2), and with
overlap its ``tap_reduce`` hook runs that reduce-scatter in the
backward, the update consuming each rank's shards concatenated in
bucket order.

The step runs with TF32 off and cuDNN deterministic (restored after), as
the reference computes in fp32 and the reduce is bitwise; on a
`ProcessMesh` each process sets them for itself, as each runs its own
step.  The weights, BN stats and optimizer buffers are updated in place
(a verified step whose reduce failed leaves them as they were);
every rank applies the same reduced gradients and the same mean of the
BN stats, so ranks that start from `parallel.dist.replicate`'s bytes
stay equal.

The gradient leaves are the module's parameters in ``parameters()``
order, in torch layouts (OIHW convs).  The ring's chunks follow that
flat layout; the JAX step flattens its (sorted, HWIO) tree instead, so
the two rings fold the same gradients in the same documented rotation
over different chunk boundaries.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.dist import grad_sr_key, sum_gradients
from ..parallel.emulate import emulate_node_reduce, make_overlap_emulate_fn
from ..parallel.overlap import BucketPlan, overlapped_grads
from ..quant.prng import fold_in
from .scaling import current_scale, find_dynamic_scale
from .state import TrainState

__all__ = ["make_train_step", "make_eval_step", "fp32_numerics",
           "local_gradients", "as_batch", "mean_stats"]


@contextlib.contextmanager
def fp32_numerics():
    """TF32 off for matmuls and convolutions, bf16 matmuls reducing in
    fp32 (as XLA's bf16 dot accumulates), cuDNN deterministic and without
    autotuning; the previous settings are restored after."""
    mm = torch.backends.cuda.matmul
    saved = mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction
    mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled, benchmark=False,
                deterministic=True, allow_tf32=False):
            yield
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = saved


def as_batch(images, labels, device) -> tuple:
    """NHWC images and labels (numpy or tensors) -> NCHW images and int64
    labels on ``device``: a bf16 image batch stays bf16 (as bench.py
    feeds its bf16 model; the model casts), any other becomes fp32."""
    x = torch.as_tensor(images)
    x = x.to(device, torch.bfloat16 if x.dtype == torch.bfloat16
             else torch.float32)
    y = torch.as_tensor(labels).to(device, torch.int64)
    return x.permute(0, 3, 1, 2).contiguous(), y


def local_gradients(model, x: torch.Tensor, y: torch.Tensor, mesh,
                    emulate_node: int = 1, loss_scale: float = 1.0,
                    backward=None) -> tuple:
    """Step 1 for every local rank of ``mesh``: the i-th local rank's
    forward and backward on rows ``[i*B*N, (i+1)*B*N)`` of ``x``/``y``
    (NCHW on the mesh's device: the global batch on a `LocalMesh`, this
    process's rows on a `ProcessMesh`) as N = ``emulate_node``
    contiguous micro-batches of B in turn, the first from the step's
    starting BN stats.  Returns ``(grads, stats, losses, hits)``, one
    entry per local rank: the gradients of ``loss / (W*N) * loss_scale`` in
    ``parameters()`` order (at N > 1 each leaf stacks the N micro-batch
    gradients, ``(N, *shape)``), the BN running stats the rank's last
    micro-batch left, its summed micro losses / (W*N) (unscaled) and its
    count of top-1 hits.  The module's BN stats are left at the last
    rank's.  A parameter the loss does not reach gets a zero gradient.
    ``backward(objective, params, done, micro)``, when given, takes the
    last local rank's last backward (``done``: the earlier ranks'
    gradients, ``micro``: this rank's earlier micro-batches') and
    returns its gradients: the overlapped reduce's hook.
    """
    world, n, local = mesh.world, emulate_node, len(mesh.ranks)
    if x.shape[0] % local:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of the "
                         f"{local} local ranks")
    per_rank = x.shape[0] // local
    if per_rank < n or per_rank % n:
        raise ValueError(
            f"per-rank batch {per_rank} must be a positive multiple of "
            f"emulate_node={n} (global batch = ranks * per-rank batch; "
            f"each rank's rows are split into emulate_node sequential "
            f"micro-batches)")
    b = per_rank // n
    params = list(model.parameters())
    stats = list(model.buffers())
    start = [s.clone() for s in stats]
    model.train()
    grads, new_stats, losses, hits = [], [], [], []
    for i in range(local):
        for s, s0 in zip(stats, start):
            s.copy_(s0)
        micro, rank_loss, rank_hits = [], None, None
        for j in range(n):
            lo = i * per_rank + j * b
            xr, yr = x[lo:lo + b], y[lo:lo + b]
            logits = model(xr)
            loss = F.cross_entropy(logits, yr) / (world * n)
            objective = loss if loss_scale == 1.0 else loss * loss_scale
            if backward is not None and i == local - 1 and j == n - 1:
                micro.append(list(backward(objective, params, grads,
                                           micro)))
            else:
                micro.append(list(torch.autograd.grad(
                    objective, params, allow_unused=True,
                    materialize_grads=True)))
            hit = (logits.detach().argmax(-1) == yr).sum()
            loss = loss.detach()
            rank_loss = loss if rank_loss is None else rank_loss + loss
            rank_hits = hit if rank_hits is None else rank_hits + hit
        grads.append(micro[0] if n == 1 else
                     [torch.stack(gs) for gs in zip(*micro)])
        del micro
        new_stats.append([s.clone() for s in stats])
        losses.append(rank_loss)
        hits.append(rank_hits)
    return grads, new_stats, losses, hits


def mean_stats(new_stats: list, mesh) -> list:
    """Step 5: the mean over the ranks of every BN buffer
    (``new_stats[i]``: the i-th local rank's buffers), one `mesh.mean`
    per dtype over the buffers concatenated.  The mean is elementwise,
    so each buffer gets the bits of its own mean; on a `ProcessMesh` the
    buffers share one all-gather instead of one each."""
    first = new_stats[0]
    groups: dict = {}
    for j, b in enumerate(first):
        groups.setdefault(b.dtype, []).append(j)
    out = [None] * len(first)
    for idx in groups.values():
        mean = mesh.mean([torch.cat([ns[j].reshape(-1) for j in idx])
                          for ns in new_stats])[0]
        off = 0
        for j in idx:
            n = first[j].numel()
            out[j] = mean[off:off + n].reshape(first[j].shape)
            off += n
    return out


def _wire_fault(plan, step: int):
    """The ``(code, rank)`` of ``plan = (codes, ranks)`` at ``step``:
    code 0 past the plan's end, as the JAX step clips and masks."""
    codes, ranks = plan
    if not len(codes):
        return None
    i = min(max(step, 0), len(codes) - 1)
    return (int(codes[i]) if step < len(codes) else 0, int(ranks[i]))


def overlap_backward(mesh, plan: BucketPlan, reduce_kw: dict, *,
                     emulate_node: int, use_aps: bool, grad_exp: int,
                     grad_man: int, key=None, emu_key=None, wire_fault=None,
                     verify: bool = False, stats: bool = False,
                     collective=None, fused: Optional[bool] = None) -> tuple:
    """``(backward, out)``: the ``backward`` hook of `local_gradients`
    that runs the last local rank's last backward through
    `overlapped_grads` (the emulate-node reduce of each leaf inside its
    bucket at N > 1, rank r keyed ``fold_in(emu_key, r)``), and the dict
    it leaves ``reduced`` and ``report`` in.  The image and the LM steps
    share it."""
    n = emulate_node
    emulate_fn = emu_keys = None
    if n > 1:
        emulate_fn = make_overlap_emulate_fn(n, use_aps, grad_exp, grad_man,
                                             emu_key is not None,
                                             fused=fused)
        emu_keys = [None if emu_key is None else fold_in(emu_key, r)
                    for r in mesh.ranks]
    out: dict = {}

    def backward(objective, params, done, micro):
        extras = ([torch.stack([m[i] for m in micro])
                   for i in range(len(params))] if n > 1 else None)
        grads, out["reduced"], out["report"] = overlapped_grads(
            objective, params, mesh, plan=plan, reduce_kw=reduce_kw,
            prior=done, extras=extras, key=key, wire_fault=wire_fault,
            verify=verify, stats=stats, collective=collective,
            emulate_reduce=emulate_fn, emulate_keys=emu_keys)
        return grads

    return backward, out


def check_updater_args(*, loss_scale, update_fn, reduce_in_update: bool,
                       verify_reduce: bool, quant_stats: bool, tap_reduce,
                       overlap_reduce: bool, block_scale: bool,
                       mode: str) -> None:
    """The JAX step's refusals of the custom-updater switches, word for
    word (`cpd_tpu/train/step.py:214-256`)."""
    if loss_scale == "dynamic" and update_fn is not None:
        raise ValueError("loss_scale='dynamic' requires the default optax "
                         "update path (the wrapper owns unscale+skip); "
                         "custom update_fn steppers must manage scaling "
                         "themselves")
    if reduce_in_update and update_fn is None:
        raise ValueError("reduce_in_update=True requires update_fn")
    if verify_reduce and reduce_in_update:
        raise ValueError("verify_reduce=True needs the step's own "
                         "sum_gradients call; reduce_in_update hands the "
                         "collective to the updater (ZeRO-2/3), which "
                         "does not thread a verification report")
    if quant_stats and reduce_in_update:
        raise ValueError("quant_stats=True needs the step's own "
                         "sum_gradients call; reduce_in_update hands the "
                         "collective to the updater (ZeRO-2/3), which "
                         "does not thread a telemetry report")
    if tap_reduce is not None and not reduce_in_update:
        raise ValueError("tap_reduce is the ZeRO-2 overlap hook — it "
                         "only makes sense with reduce_in_update=True")
    if overlap_reduce and reduce_in_update and tap_reduce is None:
        raise ValueError(
            "overlap_reduce=True with reduce_in_update needs the "
            "updater's tap_reduce hook (zero2_sgd's mesh_layout wires "
            "it); ZeRO-3 and other custom updaters without one own the "
            "whole post-backward collective — run without "
            "overlap_reduce")
    if block_scale and mode != "ring" and not reduce_in_update:
        raise ValueError(
            f"block_scale=True needs mode='ring' (got {mode!r}): the "
            f"per-block scale sidecar rides the ring's packed wire "
            f"(with reduce_in_update the ZeRO-2 updater's all_to_all "
            f"carries it instead — parallel/zero.py)")


def make_train_step(model, opt, mesh, *, emulate_node: int = 1,
                    mode: str = "faithful",
                    use_aps: bool = False, grad_exp: int = 8,
                    grad_man: int = 23, use_kahan: bool = False,
                    loss_scale: float = 1.0,
                    grad_rounding: str = "nearest", grad_seed: int = 0,
                    verify_reduce: bool = False, keep_failed: bool = False,
                    wire_fault_plan=None,
                    quant_stats: bool = False,
                    block_scale: bool = False, block_size: int = 128,
                    bucket_elems: Optional[int] = None,
                    overlap_reduce: bool = False, update_fn=None,
                    reduce_in_update: bool = False, tap_reduce=None,
                    fused: Optional[bool] = None):
    """``step(state, images, labels) -> (state, metrics)`` over ``mesh``.

    ``images``: the global batch, (W * B * N, 32, 32, 3) NHWC fp32 with
    N = ``emulate_node``, on a `ProcessMesh` this process's (B * N)
    rows of it; each rank takes its contiguous B * N rows, as
    N micro-batches (module docstring).  ``metrics``: ``loss`` (the
    rank-summed micro losses / (W*N), i.e. the global mean) and
    ``accuracy`` (top-1 over the global batch), as 0-d tensors on the
    device.  ``loss_scale``: a static factor on the loss the gradients
    are taken of, or ``"dynamic"``: the scale of the optimizer's
    `train.scaling.with_dynamic_loss_scale` state, which unscales, skips
    a non-finite step and moves the scale (a static factor with a
    wrapped optimizer raises).  With
    ``grad_rounding="stochastic"`` step s reduces with the key
    ``grad_sr_key(grad_seed, s, 1)`` and rank r's emulate-node reduce
    with ``fold_in(grad_sr_key(grad_seed, s, 0), r)``.  ``quant_stats``
    adds the reduce wire's health counters as float32 metrics
    ``prec_wire_sat``, ``prec_wire_underflow``, ``prec_wire_nan``,
    ``prec_wire_total`` and ``prec_aps_bad``.  ``block_scale``/``block_size``
    ship the ring block-scaled.  ``verify_reduce`` adds the reduce's
    verdict as float32 metrics ``reduce_ok``, ``reduce_hop_bad``,
    ``reduce_gather_bad`` and ``reduce_agree``, and discards a failed
    step: when ``reduce_ok`` is 0 no update is applied and the BN stats
    are put back, so the weights, buffers, optimizer state and
    ``state.step`` stay bitwise as they were (the transport ladder's
    retry; the JAX trainer rewinds to the step's input state).  Reading
    the verdict syncs the host with the card once a step;
    ``keep_failed`` applies a failed step all the same (detection only,
    as the JAX trainer's fast mode keeps it).  ``wire_fault_plan =
    (codes, ranks)``: in ring mode, step s injects the wire fault
    ``(codes[s], ranks[s])`` (none past the plan's end).  The update
    applies rank 0's reduced gradients.  ``bucket_elems`` caps the
    reduce's buckets (`parallel.overlap.DEFAULT_BUCKET_ELEMS` by
    default), and ``overlap_reduce`` reduces each bucket from inside the
    backward (module docstring), bitwise the same step.  ``update_fn(
    grads, state, mesh, *, pre_sharded, fused, **quant_kw) -> opt_state``
    replaces ``opt.apply`` (a ZeRO updater's, `parallel.zero`: its
    ``step_kwargs()`` give it, ``reduce_in_update`` and ``tap_reduce``);
    it is handed one entry per local rank: the reduced gradients, or
    with ``reduce_in_update`` the local ones and the step's precision
    keywords (and ``key``), or with overlap and ``tap_reduce`` the
    rank's reduce-scattered shard (``pre_sharded=True``).  ``fused``
    goes to the emulate-node reduce, `sum_gradients` and the optimizer
    (None: the kernels on CUDA)."""
    if grad_rounding not in ("nearest", "stochastic"):
        raise ValueError(f"unknown grad_rounding {grad_rounding!r}")
    if emulate_node < 1:
        raise ValueError(f"emulate_node must be >= 1, got {emulate_node}")
    check_updater_args(
        loss_scale=loss_scale, update_fn=update_fn,
        reduce_in_update=reduce_in_update, verify_reduce=verify_reduce,
        quant_stats=quant_stats, tap_reduce=tap_reduce,
        overlap_reduce=overlap_reduce, block_scale=block_scale, mode=mode)
    dynamic_scale = loss_scale == "dynamic"
    if not dynamic_scale:
        loss_scale = float(loss_scale)

    sr = grad_rounding == "stochastic"
    prec_kw = dict(use_aps=use_aps, grad_exp=grad_exp, grad_man=grad_man,
                   use_kahan=use_kahan, mode=mode, rounding=grad_rounding,
                   block_scale=block_scale, block_size=block_size)
    plan = tap_collective = None
    if overlap_reduce:
        params = list(model.parameters())
        if tap_reduce is not None:
            plan, tap_collective = tap_reduce(
                params, mesh, dict(prec_kw, fused=fused))
            if bucket_elems is not None and plan.bucket_elems != bucket_elems:
                raise ValueError(
                    f"bucket_elems={bucket_elems} does not match "
                    f"the ZeRO updater's bucket layout (cap "
                    f"{plan.bucket_elems}): with reduce_in_update "
                    f"the tap plan comes from the updater — pass "
                    f"the same value to zero2_sgd(bucket_elems=)")
        else:
            plan = BucketPlan.for_tree(params, bucket_elems)

    def step(state: TrainState, images, labels):
        if dynamic_scale:
            scale = current_scale(state.opt_state)
        elif find_dynamic_scale(state.opt_state) is not None:
            # a static factor would never be divided out: every update
            # would be the wrapper's unscale of an unscaled gradient
            raise ValueError(
                "optimizer is wrapped with with_dynamic_loss_scale but "
                "loss_scale is static; pass loss_scale='dynamic' to "
                "make_train_step")
        else:
            scale = loss_scale
        x, y = as_batch(images, labels, mesh.device)
        sum_key = grad_sr_key(grad_seed, state.step, 1) if sr else None
        fault = (_wire_fault(wire_fault_plan, state.step)
                 if wire_fault_plan is not None and mode == "ring" else None)
        emu_key = grad_sr_key(grad_seed, state.step, 0) if sr else None
        pre_sharded = None
        with fp32_numerics():
            # the BN stats the forwards move, kept for a discarded step
            start = ([b.clone() for b in state.batch_stats]
                     if verify_reduce else None)
            if overlap_reduce:
                backward, res = overlap_backward(
                    mesh, plan, dict(prec_kw, bucket_elems=bucket_elems,
                                     fused=fused),
                    emulate_node=emulate_node, use_aps=use_aps,
                    grad_exp=grad_exp, grad_man=grad_man, key=sum_key,
                    emu_key=emu_key, wire_fault=fault, verify=verify_reduce,
                    stats=quant_stats, collective=tap_collective,
                    fused=fused)
                _, new_stats, losses, hits = local_gradients(
                    model, x, y, mesh, emulate_node, scale, backward)
                reduced, report = res["reduced"], res["report"]
                if tap_collective is not None:
                    pre_sharded = [torch.cat(r) for r in reduced]
            else:
                grads, new_stats, losses, hits = local_gradients(
                    model, x, y, mesh, emulate_node, scale)
                if emulate_node > 1:
                    grads = [emulate_node_reduce(
                        g, emulate_node, use_aps, grad_exp, grad_man,
                        key=fold_in(emu_key, r) if sr else None,
                        rounding=grad_rounding, fused=fused)
                        for g, r in zip(grads, mesh.ranks)]
                if reduce_in_update:
                    reduced, report = grads, None   # the updater reduces
                else:
                    out = sum_gradients(
                        grads, mesh, key=sum_key, verify=verify_reduce,
                        wire_fault=fault, stats=quant_stats,
                        bucket_elems=bucket_elems, fused=fused, **prec_kw)
                    reduced, report = (out if verify_reduce or quant_stats
                                       else (out, None))
                del grads
            # the merged report is the same on every rank (its counts
            # are all-gathered), so every rank takes the same branch
            ok = not verify_reduce or keep_failed or bool(report["ok"])
            if ok and update_fn is not None:
                if pre_sharded is not None:
                    state.opt_state = update_fn(pre_sharded, state, mesh,
                                                pre_sharded=True,
                                                fused=fused)
                else:
                    quant_kw = (dict(prec_kw, key=sum_key)
                                if reduce_in_update else {})
                    state.opt_state = update_fn(reduced, state, mesh,
                                                fused=fused, **quant_kw)
            elif ok:
                state.opt_state = opt.apply(reduced[0], state.opt_state,
                                            state.params, fused=fused)
            with torch.no_grad():
                for s, m in zip(state.batch_stats,
                                mean_stats(new_stats, mesh) if ok
                                else start):
                    s.copy_(m)
        if ok:
            state.step += 1
        global_batch = x.shape[0] // len(mesh.ranks) * mesh.world
        metrics = {"loss": mesh.sum(losses)[0],
                   "accuracy": mesh.sum(hits)[0].to(torch.float32)
                   / global_batch}
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


def make_eval_step(model, mesh):
    """``eval_step(state, images, labels) -> metrics``: ``loss`` (mean
    cross-entropy), ``top1`` and ``top5`` over the batch, with the BN
    running stats; equal logits rank by class index, as the JAX
    step's ``argmax`` and ``top_k`` rank them."""

    @torch.no_grad()
    def eval_step(state: TrainState, images, labels):
        x, y = as_batch(images, labels, mesh.device)
        model.eval()
        with fp32_numerics():
            logits = model(x)
        k = min(5, logits.shape[-1])
        # ties go to the lower class index, as jnp.argmax and lax.top_k
        # break them (topk's order among equal logits is unspecified)
        top = logits.sort(dim=-1, descending=True, stable=True).indices[:, :k]
        return {"loss": F.cross_entropy(logits, y),
                "top1": (top[:, 0] == y).to(torch.float32).mean(),
                "top5": (top == y[:, None]).any(-1).to(torch.float32).mean()}

    return eval_step
