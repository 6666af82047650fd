"""The LM train and eval steps (port of `make_lm_train_step` /
`make_lm_eval_step` from `cpd_tpu/train/lm.py`: the dp, sp and tp
axes).

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
``overlap_reduce`` at sp or tp > 1 is not ported yet (ROADMAP Queue A
row 2).

On a dp x sp x tp mesh (``make_mesh(dp, sp, tp=)``) the tp ranks of a
block take the same tokens and run Megatron-sharded blocks
(`models.transformer`): each rank's forward uses its shards of the
col/row-sharded kernels and the replicated rest, and the blocks' tp sums
carry gradients (their backward sums the tp ranks' cotangents, JAX's
transpose of ``psum``).  As in JAX, the normaliser counts dp x sp x tp
tokens (the loss is computed redundantly on every tp rank, and the
transpose of the forward tp sums adds the tp ranks' cotangents), every
leaf is summed over sp and then each replicated leaf over tp, both in
rank order, and a sharded leaf is already whole on its shard.  The dp
reduce runs per tp index over that index's LOCAL tree — its shards and
the replicated leaves, so the bucket layout, APS's exponents and the SR
offsets are the local leaves' (a tp = 2 step's quantized gradients
differ from tp = 1's by design).  On a `LocalMesh` one full-width model
holds every shard: each tp rank computes with its own contiguous slices
(`models.transformer.rank_params`), and the optimizer updates the full
weights from the reduced shards put back together along their sharded
dim (the replicated leaves from tp index 0's reduce), which for SGD,
Nesterov and AdamW is elementwise and so bitwise the shard-local
update; LARS and global-norm clipping need global norms and are
refused at tp > 1.  On a `ProcessMesh` each process holds its shard
model (``tp_size`` = tp).  The dropout keys fold dp and sp, not tp
(every tp rank draws the same mask on the summed value), the SR keys
fold the dp index, and the metrics and the eval step count dp x sp
tokens (tp index 0's sums).

With a ``dropout_rate`` the model draws each micro-batch's masks from
``fold_in(fold_in(fold_in(PRNGKey(rng_seed), step*N + micro), dp),
sp)`` (JAX's key: no tp index), and the eval step runs with dropout
off.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models.transformer import lm_param_specs, rank_params
from ..parallel.dist import grad_sr_key, sum_gradients
from ..parallel.emulate import emulate_node_reduce
from ..parallel.overlap import BucketPlan
from ..quant.prng import PRNGKey, fold_in
from .state import TrainState, reject_norm_based
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


def _group_layout(toks: torch.Tensor, mesh) -> tuple:
    """``(groups, block, rows, t_local)`` of a dp x sp x tp mesh: the
    local positions of each dp index's sp x tp ranks (flat order),
    ``block(x, p)`` local position p's (rows, T_local) block of a handed
    batch (a tp rank's is its block's), and its size."""
    if not mesh.is_local:
        return [[0]], (lambda x, p: x), toks.shape[0], toks.shape[1]
    dp, sp, tp = (mesh.axes[a] for a in ("dp", "sp", "tp"))
    if toks.shape[0] % dp or toks.shape[1] % sp:
        raise ValueError(f"batch {tuple(toks.shape)} does not split into "
                         f"dp={dp} x sp={sp} blocks")
    rows, t_local = toks.shape[0] // dp, toks.shape[1] // sp

    def block(x, p):
        c = mesh.coords(p)
        return x[c["dp"] * rows:(c["dp"] + 1) * rows,
                 c["sp"] * t_local:(c["sp"] + 1) * t_local]

    per = sp * tp
    return ([list(range(d * per, (d + 1) * per)) for d in range(dp)], block,
            rows, t_local)


def _group_views(mesh, group: list) -> tuple:
    """The sp and tp views over one dp index's local ranks."""
    if mesh.is_local:
        return mesh.axis("sp", group), mesh.axis("tp", group)
    return mesh.axis("sp"), mesh.axis("tp")


def _coords(mesh, p: int) -> dict:
    return mesh.coords(p if mesh.is_local else mesh.rank)


def _check_tp_model(model, mesh) -> None:
    """A tp mesh's model: built with ``tp_axis``, at ``tp_size`` 1 (all
    the shards) on a `LocalMesh` and at the mesh's tp (its own shard) on
    a `ProcessMesh`."""
    tp = mesh.axes["tp"]
    want = 1 if mesh.is_local else tp
    if getattr(model, "tp_axis", None) is None or model.tp_size != want:
        raise ValueError(
            f"a mesh with tp={tp} needs a model built with tp_axis='tp' "
            f"and tp_size={want} (a LocalMesh's model holds the full "
            f"weights, a ProcessMesh rank's its own shard); got "
            f"tp_size={getattr(model, 'tp_size', None)}")


def _tokens_counted(toks: torch.Tensor, mesh) -> float:
    """The global token count of a handed batch: each dp x sp block once
    (its tp ranks share it)."""
    tp = mesh.axes["tp"]
    blocks = mesh.world // tp
    handed = len(mesh.ranks) // tp if mesh.is_local else 1
    return float(toks.numel() // handed * blocks)


def _block_sum(mesh, xs: list) -> torch.Tensor:
    """The rank-order sum of the tp-index-0 ranks' values over the whole
    mesh (JAX's psum over (dp, sp)); at tp 1 ``mesh.sum``."""
    tp = mesh.axes["tp"]
    if tp == 1:
        return mesh.sum(xs)[0]
    stack = mesh.all_gather(xs)[0]
    s = stack[0]
    for f in range(tp, mesh.world, tp):
        s = s + stack[f]
    return s


def _whole(shards: list, dims: list) -> list:
    """Each leaf of the tp indices' reduced local trees put back whole:
    a sharded leaf the concatenation of its shards along its dim, a
    replicated leaf tp index 0's."""
    if len(shards) == 1:
        return shards[0]
    out = []
    for i, dim in enumerate(dims):
        if dim is None:
            out.append(shards[0][i])
        else:
            out.append(torch.cat([s[i] for s in shards], dim=dim))
    return out


def lm_sp_gradients(model, toks: torch.Tensor, tgts: torch.Tensor, mesh,
                    label_smoothing: float = 0.0, emulate_node: int = 1,
                    key_fn=None) -> tuple:
    """Step 1 on a dp x sp x tp mesh (module docstring): for every local
    rank, its block's N = ``emulate_node`` micro-batches of B rows, each
    run with the other sp and tp ranks of its dp index by `forward_sp`
    and one backward of their objectives' sum (each rank's CE sum /
    (dp*sp*tp*B*T_local) / N), and the per-rank gradients summed over
    the sp view, then the replicated leaves over the tp view, in rank
    order.  Returns ``(grads, sums, hits)``, one entry per local rank:
    the summed gradients of its local tree in ``parameters()`` order (a
    sharded leaf at its shard's shape; at N > 1 each leaf stacks the N
    micro-batch sums, ``(N, *shape)``; on a `LocalMesh` the ranks that
    hold the same sums hold views of one buffer), the CE sum and the
    argmax hits of its micro-batches.  ``key_fn(dp_index, sp_index,
    micro)``: each rank's dropout key."""
    groups, block, rows, t_local = _group_layout(toks, mesh)
    n = emulate_node
    if rows < n or rows % n:
        raise ValueError(
            f"per-rank batch {rows} must be a positive multiple of "
            f"emulate_node={n}")
    b = rows // n
    global_n = float(b * t_local * mesh.world)
    tp = mesh.axes["tp"]
    names = [k for k, _ in model.named_parameters()]
    specs = lm_param_specs(model.named_parameters())
    replicated = [specs[k][0] is None for k in names]
    model.train()
    local = len(mesh.ranks)
    grads, sums, hits = [None] * local, [None] * local, [None] * local
    for group in groups:
        sp_view, tp_view = _group_views(mesh, group)
        coords = [_coords(mesh, p) for p in group]
        micro = [[] for _ in group]
        for j in range(n):
            tk = [block(toks, p)[j * b:(j + 1) * b] for p in group]
            tg = [block(tgts, p)[j * b:(j + 1) * b] for p in group]
            if mesh.is_local:
                # each rank's own aliases of the weights (its shards)
                params = [rank_params(model, c["tp"], tp, grad=True)
                          for c in coords]
                leaves = [[d[k] for k in names] for d in params]
            else:
                params, leaves = None, [list(model.parameters())]
            keys = (None if key_fn is None else
                    [key_fn(c["dp"], c["sp"], j) for c in coords])
            logits = model.forward_sp(tk, sp_view, params, keys, tp_view)
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
        summed = [_unflat(f, per_rank[0])
                  for f in sp_view.sum([_flat(g) for g in per_rank])]
        del per_rank
        if tp > 1:
            # the replicated leaves' tp sum; a shard is whole already
            rep = tp_view.sum([_flat([g for g, r in zip(gs, replicated)
                                      if r]) for gs in summed])
            like = [g for g, r in zip(summed[0], replicated) if r]
            for i, f in enumerate(rep):
                whole = iter(_unflat(f, like))
                summed[i] = [next(whole) if r else g
                             for g, r in zip(summed[i], replicated)]
        for p, gs in zip(group, summed):
            grads[p] = gs
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
    sp, tp = mesh.axes["sp"], mesh.axes["tp"]
    if (sp > 1 or tp > 1) and overlap_reduce:
        raise NotImplementedError(
            "overlap_reduce at sp or tp > 1 (the sp and tp sums moved into "
            "each bucket's tap): not yet ported to cpd_tpu_torch (ROADMAP "
            "Queue A, row 2)")
    if sp > 1 and getattr(model, "sp_axis", None) is None:
        raise ValueError(f"a mesh with sp={sp} needs a model built with "
                         "sp_axis='sp'")
    if tp > 1:
        reject_norm_based(opt, "tp-sharded LM step")
        _check_tp_model(model, mesh)
    prec_kw = dict(use_aps=use_aps, grad_exp=grad_exp, grad_man=grad_man,
                   use_kahan=use_kahan, mode=mode, rounding=grad_rounding,
                   block_scale=block_scale, block_size=block_size)
    plan = (BucketPlan.for_tree(list(model.parameters()), bucket_elems)
            if overlap_reduce else None)
    # the dp reduce's ranks, one list a tp index: on a LocalMesh the
    # sp-index-0 ones, whose sp-summed gradients every sp rank of their dp
    # index shares
    if mesh.is_local:
        dp_pos = [list(range(k, mesh.world, sp * tp)) for k in range(tp)]
        dp_views = [mesh.axis("dp", pos) if sp * tp > 1 else mesh.axis("dp")
                    for pos in dp_pos]
    else:
        dp_pos, dp_views = [[0]], [mesh.axis("dp")]
    specs = lm_param_specs(model.named_parameters())
    dims = [specs[n][1] for n, _ in model.named_parameters()]
    dropout = getattr(model, "dropout_rate", 0.0) > 0.0

    def step(state: TrainState, tokens, targets):
        toks, tgts = as_tokens(tokens, targets, mesh.device)
        total_n = _tokens_counted(toks, mesh)
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
                    lm_sp_gradients if sp * tp > 1 else lm_local_gradients)(
                    model, toks, tgts, mesh, label_smoothing, emulate_node,
                    key_fn=key_fn)
                shards, report = [], None
                # the dp reduce of each tp index, over its local tree
                for pos, view in zip(dp_pos, dp_views):
                    local = [grads[p] for p in pos]
                    if emulate_node > 1:
                        local = [emulate_node_reduce(
                            g, emulate_node, use_aps, grad_exp, grad_man,
                            key=fold_in(emu_key, r) if sr else None,
                            rounding=grad_rounding, fused=fused)
                            for g, r in zip(local, view.ranks)]
                    out = sum_gradients(local, view, key=sum_key,
                                        verify=verify_reduce,
                                        wire_fault=fault, stats=quant_stats,
                                        bucket_elems=bucket_elems,
                                        fused=fused, **prec_kw)
                    del local
                    out, rep = (out if verify_reduce or quant_stats
                                else (out, None))
                    shards.append(out[0])
                    report = rep if report is None else report
                del grads
                reduced = [_whole(shards, dims)]
            state.opt_state = opt.apply(reduced[0], state.opt_state,
                                        list(model.parameters()),
                                        fused=fused)
        state.step += 1
        metrics = {"loss": _block_sum(mesh, sums) / total_n,
                   "accuracy": _block_sum(mesh, hits).to(torch.float32)
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
    each local rank on its contiguous rows (on a dp x sp x tp mesh its
    block, the dp x sp tokens counted; on a `ProcessMesh` this
    process's, and every rank calls it), no gradients, no dropout."""

    @torch.no_grad()
    def eval_step(state: TrainState, tokens, targets):
        toks, tgts = as_tokens(tokens, targets, mesh.device)
        model.eval()
        sums, hits = [None] * len(mesh.ranks), [None] * len(mesh.ranks)
        with fp32_numerics():
            if mesh.axes["sp"] * mesh.axes["tp"] > 1:
                groups, block, _, _ = _group_layout(toks, mesh)
                for group in groups:
                    sp_view, tp_view = _group_views(mesh, group)
                    logits = model.forward_sp(
                        [block(toks, p) for p in group], sp_view, None,
                        None, tp_view)
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
        n = _tokens_counted(toks, mesh)
        return {"loss": _block_sum(mesh, sums) / n,
                "accuracy": _block_sum(mesh, hits).to(torch.float32) / n}

    return eval_step
