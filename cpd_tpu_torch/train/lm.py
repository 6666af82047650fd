"""The LM train and eval steps (port of `make_lm_train_step` /
`make_lm_eval_step` from `cpd_tpu/train/lm.py`: the dp and sp axes,
tp = 1).

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

On a dp x sp mesh (`parallel.mesh.make_mesh(dp, sp)`) rank (i, j) takes
the rows of dp rank i and the columns ``[j*T_local, (j+1)*T_local)`` of
the global (dp*B*N, T) batch (a `ProcessMesh` process is handed its
block, `parallel.dist.local_rows`), and `lm_sp_gradients` runs step 1:
the sp ranks of one dp index run their forwards layer by layer together
(`TransformerLM.forward_sp`: each attention layer needs all their K/V)
and one backward, and each rank's gradients are SUMMED over the sp view
in rank order (JAX's ``psum`` over sp).  The gradients stay per rank
until that sum, not accumulated by autograd into one shared leaf: on a
`LocalMesh` each rank computes with its own aliases of the parameters
(``p.detach().requires_grad_()``, bound by `torch.func.functional_call`),
so the per-rank gradients and their ordered sum are the bits a
`ProcessMesh` rank computes and gathers.  The normaliser counts dp x sp
tokens, the dp reduce runs over the dp view (SR keys fold the dp index:
after the sp sum the sp ranks hold one gradient and must draw the same
bits), and the metrics sum over dp x sp.  On a `LocalMesh` the dp
reduce runs once, over the sp-index-0 ranks, and every sp rank takes its
result; on a `ProcessMesh` each sp slice runs its own, as JAX does.
``overlap_reduce`` at sp > 1 is not ported yet (ROADMAP Queue A row 1).

With a ``dropout_rate`` the model draws each micro-batch's masks from
``fold_in(fold_in(fold_in(PRNGKey(rng_seed), step*N + micro), dp),
sp)`` (JAX's key: no tp index), and the eval step runs with dropout
off.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.dist import grad_sr_key, sum_gradients
from ..parallel.emulate import emulate_node_reduce
from ..parallel.overlap import BucketPlan
from ..quant.prng import PRNGKey, fold_in
from .state import TrainState
from .step import _wire_fault, fp32_numerics, overlap_backward

__all__ = ["make_lm_train_step", "make_lm_eval_step", "lm_local_gradients",
           "lm_sp_gradients", "as_tokens", "step_dropout_key"]


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


def step_dropout_key(rng_seed: int, step: int, emulate_node: int,
                     micro: int, dp_index: int, sp_index: int) -> tuple:
    """The dropout key of one rank's micro-batch, as the JAX step folds
    it: ``fold_in(fold_in(fold_in(PRNGKey(rng_seed), step * N + micro),
    dp_index), sp_index)``."""
    k = fold_in(PRNGKey(rng_seed), step * emulate_node + micro)
    return fold_in(fold_in(k, dp_index), sp_index)


def _objective(logits, tg, label_smoothing: float, global_n: float,
               n: int) -> tuple:
    """(CE sum / global_n / n, the CE sum, the argmax hits) of one
    micro-batch; ``label_smoothing`` mixes in the closed-form uniform
    term."""
    ce = _ce(logits, tg)
    if label_smoothing:
        uniform = torch.logsumexp(logits, dim=-1) - logits.mean(dim=-1)
        ce = (1.0 - label_smoothing) * ce + label_smoothing * uniform
    local_sum = ce.sum()
    hit = (logits.detach().argmax(-1) == tg).sum()
    return local_sum / global_n / n, local_sum.detach(), hit


def _flat(leaves) -> torch.Tensor:
    return torch.cat([g.reshape(-1) for g in leaves])


def _unflat(flat: torch.Tensor, like) -> list:
    out, off = [], 0
    for g in like:
        out.append(flat[off:off + g.numel()].reshape(g.shape))
        off += g.numel()
    return out


def lm_local_gradients(model, toks: torch.Tensor, tgts: torch.Tensor, mesh,
                       label_smoothing: float = 0.0,
                       emulate_node: int = 1, backward=None,
                       key_fn=None) -> tuple:
    """Step 1 for every local rank of ``mesh``: the i-th local rank's
    forward and backward on rows ``[i*B*N, (i+1)*B*N)`` of ``toks``/
    ``tgts`` (the global batch on a `LocalMesh`, this process's rows on a
    `ProcessMesh`) as N = ``emulate_node`` contiguous micro-batches of B
    rows in turn.  Returns ``(grads, sums, hits)``, one entry per local
    rank: the gradients of each micro-batch's CE sum / (W*B*T) / N in
    ``parameters()`` order (at N > 1 each leaf stacks the N micro-batch
    gradients, ``(N, *shape)``), the CE sum and the count of argmax hits
    over its micro-batches.  ``backward``: the last backward's hook, as
    `train.step.local_gradients` takes it.  ``key_fn(dp_index,
    sp_index, micro)``: the dropout key of a rank's micro-batch."""
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
            logits = (model(tk) if key_fn is None
                      else model(tk, key_fn(mesh.ranks[i], 0, j)))
            objective, local_sum, hit = _objective(logits, tg,
                                                   label_smoothing,
                                                   global_n, n)
            del logits
            if backward is not None and i == len(mesh.ranks) - 1 \
                    and j == n - 1:
                micro.append(list(backward(objective, params, grads,
                                           micro)))
            else:
                micro.append(list(torch.autograd.grad(
                    objective, params, allow_unused=True,
                    materialize_grads=True)))
            rank_sum = local_sum if rank_sum is None else rank_sum + local_sum
            rank_hits = hit if rank_hits is None else rank_hits + hit
        grads.append(micro[0] if n == 1 else
                     [torch.stack(gs) for gs in zip(*micro)])
        del micro
        sums.append(rank_sum)
        hits.append(rank_hits)
    return grads, sums, hits


def _sp_layout(toks: torch.Tensor, mesh) -> tuple:
    """``(groups, block, rows, t_local)`` of a dp x sp mesh: the local
    positions of each dp index's sp ranks, ``block(x, p)`` local
    position p's (rows, T_local) block of a handed batch, and its size."""
    sp = mesh.axes["sp"]
    if not mesh.is_local:
        return [[0]], (lambda x, p: x), toks.shape[0], toks.shape[1]
    dp = mesh.world // sp
    if toks.shape[0] % dp or toks.shape[1] % sp:
        raise ValueError(f"batch {tuple(toks.shape)} does not split into "
                         f"dp={dp} x sp={sp} blocks")
    rows, t_local = toks.shape[0] // dp, toks.shape[1] // sp

    def block(x, p):
        c = mesh.coords(p)
        return x[c["dp"] * rows:(c["dp"] + 1) * rows,
                 c["sp"] * t_local:(c["sp"] + 1) * t_local]

    return ([[d * sp + j for j in range(sp)] for d in range(dp)], block,
            rows, t_local)


def _sp_view(mesh, group: list):
    """The sp view over one dp index's local ranks."""
    return mesh.axis("sp", group) if mesh.is_local else mesh.axis("sp")


def _coords(mesh, p: int) -> dict:
    return mesh.coords(p if mesh.is_local else mesh.rank)


def lm_sp_gradients(model, toks: torch.Tensor, tgts: torch.Tensor, mesh,
                    label_smoothing: float = 0.0, emulate_node: int = 1,
                    key_fn=None) -> tuple:
    """Step 1 on a dp x sp mesh (module docstring): for every local rank,
    its block's N = ``emulate_node`` micro-batches of B rows, each run
    with the other sp ranks of its dp index by `forward_sp` and one
    backward of their objectives' sum (each rank's CE sum / (dp*sp*B*
    T_local) / N), and the per-rank gradients summed over the sp view in
    rank order.  Returns ``(grads, sums, hits)``, one entry per local
    rank: the sp-summed gradients in ``parameters()`` order (at N > 1
    each leaf stacks the N micro-batch sums, ``(N, *shape)``; the sp
    ranks of one dp index share one list on a `LocalMesh`), the CE sum
    and the argmax hits of its micro-batches.  ``key_fn(dp_index,
    sp_index, micro)``: each rank's dropout key."""
    groups, block, rows, t_local = _sp_layout(toks, mesh)
    n = emulate_node
    if rows < n or rows % n:
        raise ValueError(
            f"per-rank batch {rows} must be a positive multiple of "
            f"emulate_node={n}")
    b = rows // n
    global_n = float(b * t_local * mesh.world)
    names = [k for k, _ in model.named_parameters()]
    model.train()
    local = len(mesh.ranks)
    grads, sums, hits = [None] * local, [None] * local, [None] * local
    for group in groups:
        view = _sp_view(mesh, group)
        coords = [_coords(mesh, p) for p in group]
        micro = [[] for _ in group]
        for j in range(n):
            tk = [block(toks, p)[j * b:(j + 1) * b] for p in group]
            tg = [block(tgts, p)[j * b:(j + 1) * b] for p in group]
            if mesh.is_local:
                # each rank's own aliases of the weights
                params = [{k: p.detach().requires_grad_(True) for k, p in
                           model.named_parameters()} for _ in group]
                leaves = [[d[k] for k in names] for d in params]
            else:
                params, leaves = None, [list(model.parameters())]
            keys = (None if key_fn is None else
                    [key_fn(c["dp"], c["sp"], j) for c in coords])
            logits = model.forward_sp(tk, view, params, keys)
            objective = None
            for i, (lg, t) in enumerate(zip(logits, tg)):
                obj, local_sum, hit = _objective(lg, t, label_smoothing,
                                                 global_n, n)
                objective = obj if objective is None else objective + obj
                p = group[i]
                sums[p] = local_sum if sums[p] is None else sums[p] + local_sum
                hits[p] = hit if hits[p] is None else hits[p] + hit
            del logits
            flat = [x for ls in leaves for x in ls]
            gs = torch.autograd.grad(objective, flat, allow_unused=True,
                                     materialize_grads=True)
            k = len(names)
            for i in range(len(group)):
                micro[i].append(list(gs[i * k:(i + 1) * k]))
            del gs, params, leaves, flat, objective
        per_rank = [m[0] if n == 1 else [torch.stack(g) for g in zip(*m)]
                    for m in micro]
        del micro
        # every rank of the group holds the same sum: one list for all
        shared = _unflat(view.sum([_flat(g) for g in per_rank])[0],
                         per_rank[0])
        for p in group:
            grads[p] = shared
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
                       rng_seed: int = 0,
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
    backward (module docstring).  ``rng_seed`` seeds the dropout keys
    (`step_dropout_key`).  ``fused`` goes to the emulate-node reduce,
    `sum_gradients` and the optimizer (None: the kernels on CUDA).  On a
    dp x sp mesh the tokens are (dp * B * N, T) and each rank takes its
    (B * N, T / sp) block (module docstring)."""
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
    sp = mesh.axes["sp"]
    if sp > 1 and overlap_reduce:
        raise NotImplementedError(
            "overlap_reduce at sp > 1 (the sp sum moved into each bucket's "
            "tap): not yet ported to cpd_tpu_torch (ROADMAP Queue A, row 1)")
    if sp > 1 and getattr(model, "sp_axis", None) is None:
        raise ValueError(f"a mesh with sp={sp} needs a model built with "
                         "sp_axis='sp'")
    prec_kw = dict(use_aps=use_aps, grad_exp=grad_exp, grad_man=grad_man,
                   use_kahan=use_kahan, mode=mode, rounding=grad_rounding,
                   block_scale=block_scale, block_size=block_size)
    plan = (BucketPlan.for_tree(list(model.parameters()), bucket_elems)
            if overlap_reduce else None)
    # the dp reduce's ranks: on a LocalMesh the sp-index-0 ones, whose
    # sp-summed gradients every sp rank of their dp index shares
    dp_pos = (list(range(0, mesh.world, sp)) if mesh.is_local
              else [0])
    dp_view = (mesh.axis("dp", dp_pos) if sp > 1 and mesh.is_local
               else mesh.axis("dp"))
    dropout = getattr(model, "dropout_rate", 0.0) > 0.0

    def step(state: TrainState, tokens, targets):
        toks, tgts = as_tokens(tokens, targets, mesh.device)
        total_n = float(toks.numel() // len(mesh.ranks) * mesh.world)
        sum_key = grad_sr_key(grad_seed, state.step, 1) if sr else None
        fault = (_wire_fault(wire_fault_plan, state.step)
                 if wire_fault_plan is not None and mode == "ring" else None)
        emu_key = grad_sr_key(grad_seed, state.step, 0) if sr else None
        key_fn = None
        if dropout:
            def key_fn(dp_index, sp_index, micro, step=state.step):
                return step_dropout_key(rng_seed, step, emulate_node, micro,
                                        dp_index, sp_index)
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
                    backward, key_fn)
                reduced, report = res["reduced"], res["report"]
            else:
                grads, sums, hits = (
                    lm_sp_gradients if sp > 1 else lm_local_gradients)(
                    model, toks, tgts, mesh, label_smoothing, emulate_node,
                    key_fn=key_fn)
                grads = [grads[p] for p in dp_pos]
                if emulate_node > 1:
                    grads = [emulate_node_reduce(
                        g, emulate_node, use_aps, grad_exp, grad_man,
                        key=fold_in(emu_key, r) if sr else None,
                        rounding=grad_rounding, fused=fused)
                        for g, r in zip(grads, dp_view.ranks)]
                out = sum_gradients(grads, dp_view, key=sum_key,
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
    each local rank on its contiguous rows (on a dp x sp mesh its block;
    on a `ProcessMesh` this process's, and every rank calls it), no
    gradients, no dropout."""

    @torch.no_grad()
    def eval_step(state: TrainState, tokens, targets):
        toks, tgts = as_tokens(tokens, targets, mesh.device)
        model.eval()
        sums, hits = [None] * len(mesh.ranks), [None] * len(mesh.ranks)
        with fp32_numerics():
            if mesh.axes["sp"] > 1:
                groups, block, _, _ = _sp_layout(toks, mesh)
                for group in groups:
                    logits = model.forward_sp(
                        [block(toks, p) for p in group],
                        _sp_view(mesh, group))
                    for p, lg in zip(group, logits):
                        tg = block(tgts, p)
                        sums[p] = _ce(lg, tg).sum()
                        hits[p] = (lg.argmax(-1) == tg).sum()
            else:
                b = _rank_rows(toks.shape[0], mesh)
                for i in range(len(mesh.ranks)):
                    tg = tgts[i * b:(i + 1) * b]
                    logits = model(toks[i * b:(i + 1) * b])
                    sums[i] = _ce(logits, tg).sum()
                    hits[i] = (logits.argmax(-1) == tg).sum()
        n = float(toks.numel() // len(mesh.ranks) * mesh.world)
        return {"loss": mesh.sum(sums)[0] / n,
                "accuracy": mesh.sum(hits)[0].to(torch.float32) / n}

    return eval_step
