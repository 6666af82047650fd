"""The data-parallel train and eval steps (port of `make_train_step` /
`make_eval_step` from `cpd_tpu/train/step.py`).

One train step over a mesh of W ranks, as the JAX step runs it under
`shard_map`:

1. rank r takes rows ``[r*B, (r+1)*B)`` of the global batch, runs the
   forward and backward from the step's starting BN stats, and takes the
   gradients of ``loss / W`` (so the reduced SUM is the mean);
2. the per-rank gradients are reduced by `parallel.dist.sum_gradients`
   (APS, eXmY casts rounded to nearest or stochastically, the faithful
   scan or the ring, optionally Kahan-compensated, block-scaled and
   verified);
3. the optimizer updates the fp32 master weights with the reduced
   gradients;
4. the BN running stats become the mean of the ranks' stats.

The step runs with TF32 off and cuDNN deterministic (restored after), as
the reference computes in fp32 and the reduce is bitwise.  The weights,
BN stats and optimizer buffers are updated in place.

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
from .state import TrainState

__all__ = ["make_train_step", "make_eval_step", "fp32_numerics",
           "local_gradients", "as_batch"]


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


def local_gradients(model, x: torch.Tensor, y: torch.Tensor, mesh) -> tuple:
    """Step 1 for every local rank of ``mesh``: rank r's forward and
    backward on rows ``[r*B, (r+1)*B)`` of the global batch ``x``/``y``
    (NCHW on the mesh's device), each from the same starting BN stats.
    Returns ``(grads, stats, losses, hits)``, one entry per local rank:
    the gradients of ``loss / W`` in ``parameters()`` order, the BN
    running stats the rank's forward left, its loss / W and its count of
    top-1 hits.  The module's BN stats are left at the last rank's."""
    world = mesh.world
    if x.shape[0] % world:
        raise ValueError(f"global batch {x.shape[0]} is not a multiple of "
                         f"the {world} ranks")
    b = x.shape[0] // world
    params = list(model.parameters())
    stats = list(model.buffers())
    start = [s.clone() for s in stats]
    model.train()
    grads, new_stats, losses, hits = [], [], [], []
    for r in mesh.ranks:
        for s, s0 in zip(stats, start):
            s.copy_(s0)
        xr, yr = x[r * b:(r + 1) * b], y[r * b:(r + 1) * b]
        logits = model(xr)
        loss = F.cross_entropy(logits, yr) / world
        grads.append(list(torch.autograd.grad(loss, params)))
        new_stats.append([s.clone() for s in stats])
        losses.append(loss.detach())
        hits.append((logits.detach().argmax(-1) == yr).sum())
    return grads, new_stats, losses, hits


def _wire_fault(plan, step: int):
    """The ``(code, rank)`` of ``plan = (codes, ranks)`` at ``step``:
    code 0 past the plan's end, as the JAX step clips and masks."""
    codes, ranks = plan
    if not len(codes):
        return None
    i = min(max(step, 0), len(codes) - 1)
    return (int(codes[i]) if step < len(codes) else 0, int(ranks[i]))


def make_train_step(model, opt, mesh, *, mode: str = "faithful",
                    use_aps: bool = False, grad_exp: int = 8,
                    grad_man: int = 23, use_kahan: bool = False,
                    grad_rounding: str = "nearest", grad_seed: int = 0,
                    verify_reduce: bool = False, wire_fault_plan=None,
                    block_scale: bool = False, block_size: int = 128,
                    fused: Optional[bool] = None):
    """``step(state, images, labels) -> (state, metrics)`` over ``mesh``.

    ``images``: the global batch, (W * B, 32, 32, 3) NHWC fp32; each rank
    takes its contiguous B rows.  ``metrics``: ``loss`` (the rank-summed
    loss / W, i.e. the global mean) and ``accuracy`` (top-1 over the
    global batch), as 0-d tensors on the device.  With
    ``grad_rounding="stochastic"`` step s reduces with the key
    ``grad_sr_key(grad_seed, s, 1)``.  ``block_scale``/``block_size``
    ship the ring block-scaled.  ``verify_reduce`` adds the reduce's
    verdict as float32 metrics ``reduce_ok``, ``reduce_hop_bad``,
    ``reduce_gather_bad`` and ``reduce_agree``.  ``wire_fault_plan =
    (codes, ranks)``: in ring mode, step s injects the wire fault
    ``(codes[s], ranks[s])`` (none past the plan's end).  The update
    applies rank 0's reduced gradients.  ``fused`` goes to
    `sum_gradients` (None: the kernels on CUDA)."""
    if grad_rounding not in ("nearest", "stochastic"):
        raise ValueError(f"unknown grad_rounding {grad_rounding!r}")
    if block_scale and mode != "ring":
        raise ValueError(
            f"block_scale=True needs mode='ring' (got {mode!r}): the "
            f"per-block scale sidecar rides the ring's packed wire")

    def step(state: TrainState, images, labels):
        x, y = as_batch(images, labels, mesh.device)
        sum_key = (grad_sr_key(grad_seed, state.step, 1)
                   if grad_rounding == "stochastic" else None)
        fault = (_wire_fault(wire_fault_plan, state.step)
                 if wire_fault_plan is not None and mode == "ring" else None)
        with fp32_numerics():
            grads, new_stats, losses, hits = local_gradients(model, x, y,
                                                             mesh)
            out = sum_gradients(grads, mesh, use_aps=use_aps,
                                grad_exp=grad_exp, grad_man=grad_man,
                                use_kahan=use_kahan, mode=mode,
                                rounding=grad_rounding, key=sum_key,
                                verify=verify_reduce, wire_fault=fault,
                                block_scale=block_scale,
                                block_size=block_size, fused=fused)
            reduced, report = out if verify_reduce else (out, None)
            reduced = reduced[0]
            state.opt_state = opt.apply(reduced, state.opt_state,
                                        state.params)
            with torch.no_grad():
                for j, s in enumerate(state.batch_stats):
                    s.copy_(mesh.mean([ns[j] for ns in new_stats])[0])
        state.step += 1
        metrics = {"loss": mesh.sum(losses)[0],
                   "accuracy": mesh.sum(hits)[0].to(torch.float32)
                   / x.shape[0]}
        if report is not None:
            metrics.update({f"reduce_{k}": report[k].to(torch.float32)
                            for k in ("ok", "hop_bad", "gather_bad",
                                      "agree")})
        return state, metrics

    return step


def make_eval_step(model, mesh):
    """``eval_step(state, images, labels) -> metrics``: ``loss`` (mean
    cross-entropy), ``top1`` and ``top5`` over the batch, with the BN
    running stats."""

    @torch.no_grad()
    def eval_step(state: TrainState, images, labels):
        x, y = as_batch(images, labels, mesh.device)
        model.eval()
        with fp32_numerics():
            logits = model(x)
        k = min(5, logits.shape[-1])
        top = logits.topk(k, dim=-1).indices
        return {"loss": F.cross_entropy(logits, y),
                "top1": (top[:, 0] == y).to(torch.float32).mean(),
                "top5": (top == y[:, None]).any(-1).to(torch.float32).mean()}

    return eval_step
