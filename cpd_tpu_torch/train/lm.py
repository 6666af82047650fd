"""The LM train and eval steps (port of `make_lm_train_step` /
`make_lm_eval_step` from `cpd_tpu/train/lm.py`, data parallel: sp = tp =
1, ``emulate_node=1``).

One train step over a mesh of W ranks, as the JAX step runs it under
`shard_map` on a ("dp",) mesh:

1. rank r takes rows ``[r*B, (r+1)*B)`` of the global (W*B, T) token
   batch, runs the forward and backward, and takes the gradients of its
   next-token cross-entropy SUM over the global token count W*B*T (so
   the reduced sum is the mean); ``label_smoothing`` mixes in the
   closed-form uniform term (1-a)·CE + a·(logsumexp − mean logit);
2. the per-rank gradients are reduced by `parallel.dist.sum_gradients`
   with every option it takes (APS, format, Kahan, mode, rounding and
   ``grad_sr_key(grad_seed, step, 1)``, verify, wire fault, block scale);
3. SGD updates the fp32 master weights with rank 0's reduced gradients.

Metrics: ``loss`` and ``accuracy`` (argmax hits) over the global token
count, plus ``reduce_*`` with ``verify_reduce``.  The step runs with TF32
off and bf16 matmuls reducing in fp32 (`fp32_numerics`).  A model with a
bf16 compute dtype returns fp32 logits and holds fp32 parameters, so the
loss, the gradients and the reduce stay fp32.  Each rank's logits and their gradient are freed
before the next rank runs, so one (B, T, vocab) fp32 tensor pair is live
at a time.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.dist import grad_sr_key, sum_gradients
from .state import TrainState
from .step import _wire_fault, fp32_numerics

__all__ = ["make_lm_train_step", "make_lm_eval_step", "lm_local_gradients",
           "as_tokens"]


def as_tokens(tokens, targets, device) -> tuple:
    """(N, T) tokens and targets (numpy or tensors) as int64 on
    ``device``."""
    return (torch.as_tensor(tokens).to(device, torch.int64),
            torch.as_tensor(targets).to(device, torch.int64))


def _rank_rows(n: int, world: int) -> int:
    if n % world:
        raise ValueError(f"global batch {n} is not a multiple of the "
                         f"{world} ranks")
    return n // world


def _ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token integer-label cross-entropy, (B, T)."""
    v = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, v), targets.reshape(-1),
                           reduction="none").reshape(targets.shape)


def lm_local_gradients(model, toks: torch.Tensor, tgts: torch.Tensor, mesh,
                       label_smoothing: float = 0.0) -> tuple:
    """Step 1 for every local rank of ``mesh``: rank r's forward and
    backward on rows ``[r*B, (r+1)*B)`` of the global token batch.
    Returns ``(grads, sums, hits)``, one entry per local rank: the
    gradients of its CE sum over the global token count in
    ``parameters()`` order, the CE sum and the count of argmax hits."""
    b = _rank_rows(toks.shape[0], mesh.world)
    global_n = float(toks.numel())
    params = list(model.parameters())
    model.train()
    grads, sums, hits = [], [], []
    for r in mesh.ranks:
        tk, tg = toks[r * b:(r + 1) * b], tgts[r * b:(r + 1) * b]
        logits = model(tk)
        ce = _ce(logits, tg)
        if label_smoothing:
            uniform = torch.logsumexp(logits, dim=-1) - logits.mean(dim=-1)
            ce = (1.0 - label_smoothing) * ce + label_smoothing * uniform
        local_sum = ce.sum()
        grads.append(list(torch.autograd.grad(local_sum / global_n, params)))
        sums.append(local_sum.detach())
        hits.append((logits.detach().argmax(-1) == tg).sum())
        del logits, ce
    return grads, sums, hits


def make_lm_train_step(model, opt, mesh, *, emulate_node: int = 1,
                       use_aps: bool = False, grad_exp: int = 8,
                       grad_man: int = 23, use_kahan: bool = False,
                       mode: str = "faithful", label_smoothing: float = 0.0,
                       grad_rounding: str = "nearest", grad_seed: int = 0,
                       verify_reduce: bool = False, wire_fault_plan=None,
                       block_scale: bool = False, block_size: int = 128,
                       fused: Optional[bool] = None):
    """``step(state, tokens, targets) -> (state, metrics)`` over
    ``mesh``: tokens/targets (W * B, T) int, rank r taking its contiguous
    B rows.  ``metrics`` are 0-d tensors on the device.  ``fused`` goes
    to `sum_gradients` (None: the kernels on CUDA)."""
    if emulate_node != 1:
        raise NotImplementedError(
            "emulate_node > 1 in the LM step: not yet ported to "
            "cpd_tpu_torch (ROADMAP Queue A, A8; the ResNet step has it "
            "through parallel.emulate.emulate_node_reduce)")
    if not 0.0 <= label_smoothing < 1.0:
        raise ValueError(f"label_smoothing must be in [0, 1), got "
                         f"{label_smoothing}")
    if grad_rounding not in ("nearest", "stochastic"):
        raise ValueError(f"unknown grad_rounding {grad_rounding!r}")
    if block_scale and mode != "ring":
        raise ValueError(
            f"block_scale=True needs mode='ring' (got {mode!r}): the "
            f"per-block scale sidecar rides the ring's packed wire")

    def step(state: TrainState, tokens, targets):
        toks, tgts = as_tokens(tokens, targets, mesh.device)
        global_n = float(toks.numel())
        sum_key = (grad_sr_key(grad_seed, state.step, 1)
                   if grad_rounding == "stochastic" else None)
        fault = (_wire_fault(wire_fault_plan, state.step)
                 if wire_fault_plan is not None and mode == "ring" else None)
        with fp32_numerics():
            grads, sums, hits = lm_local_gradients(model, toks, tgts, mesh,
                                                   label_smoothing)
            out = sum_gradients(grads, mesh, use_aps=use_aps,
                                grad_exp=grad_exp, grad_man=grad_man,
                                use_kahan=use_kahan, mode=mode,
                                rounding=grad_rounding, key=sum_key,
                                verify=verify_reduce, wire_fault=fault,
                                block_scale=block_scale,
                                block_size=block_size, fused=fused)
            reduced, report = out if verify_reduce else (out, None)
            state.opt_state = opt.apply(reduced[0], state.opt_state,
                                        list(model.parameters()))
        state.step += 1
        metrics = {"loss": mesh.sum(sums)[0] / global_n,
                   "accuracy": mesh.sum(hits)[0].to(torch.float32)
                   / global_n}
        if report is not None:
            metrics.update({f"reduce_{k}": report[k].to(torch.float32)
                            for k in ("ok", "hop_bad", "gather_bad",
                                      "agree")})
        return state, metrics

    return step


def make_lm_eval_step(model, mesh):
    """``eval_step(state, tokens, targets) -> {'loss', 'accuracy'}``:
    plain next-token CE and argmax accuracy over the global token count,
    each rank on its rows, no gradients."""

    @torch.no_grad()
    def eval_step(state: TrainState, tokens, targets):
        toks, tgts = as_tokens(tokens, targets, mesh.device)
        b = _rank_rows(toks.shape[0], mesh.world)
        model.eval()
        sums, hits = [], []
        with fp32_numerics():
            for r in mesh.ranks:
                tg = tgts[r * b:(r + 1) * b]
                logits = model(toks[r * b:(r + 1) * b])
                sums.append(_ce(logits, tg).sum())
                hits.append((logits.argmax(-1) == tg).sum())
        n = float(toks.numel())
        return {"loss": mesh.sum(sums)[0] / n,
                "accuracy": mesh.sum(hits)[0].to(torch.float32) / n}

    return eval_step
