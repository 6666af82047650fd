"""The overlapped backward-reduce (port of `cpd_tpu/parallel/overlap.py`:
`bucket_layout`, `BucketPlan`, `REPORT_FIELDS` and `overlapped_grads`).

`bucket_layout` is the one capping function every bucketed reduce uses,
so bucket boundaries cannot drift between the ring, the faithful
gather, the overlapped backward and the ZeRO layouts.

`overlapped_grads` runs a backward whose gradient buckets are reduced
while it runs: each bucket's reduce (`dist.sum_gradients` on the
bucket's leaves with their GLOBAL flat offsets, or a caller's
``collective``, ZeRO-2's reduce-scatter) starts the moment the bucket's
last gradient is ready, so the reduce of the late layers' buckets is
issued while the early layers' backward is still to run.  The result is
bitwise the post-backward `sum_gradients` at the same bucket layout:
the faithful and fast sums are elementwise, the SR bits are indexed by
global offset, and the ring runs the same per-bucket rings.

Mechanism.  The JAX module puts a `custom_vjp` identity tap on each
bucket's parameters, whose backward rule reduces the bucket.  The port
hooks the gradients instead: a tensor hook on every parameter the
objective reaches (`Tensor.register_hook`) records the parameter's
gradient, and the hook that completes a bucket fires its reduce.
Leaf tensor hooks run under `torch.autograd.grad` (which the step uses)
as soon as the leaf's gradient is whole: the engine runs a leaf's
gradient capture at the highest priority.  The alternatives do not
overlap or do not run there: ``register_multi_grad_hook`` refuses
`autograd.grad` over leaves, ``register_post_accumulate_grad_hook``
fires only in `backward()`, and a `torch.autograd.Function` tap on each
bucket (the literal port of the `custom_vjp`) has the lowest sequence
number in the graph, so the engine's ready queue runs every later
backward node before it: the taps would fire after the whole backward.
The parameters the objective reaches are found by a walk of its graph
before the backward (an `AccumulateGrad` node per reached leaf); a
bucket none of whose parameters is reached never fires, as a JAX tap
that autodiff never runs: its gradients are zeros, its verdict agrees,
and its elements x W are credited to ``wire_total`` (``REPORT_FIELDS``'s
"ran" rule).

A ZeRO-2 ``collective`` returns each local rank's reduce-scattered
(c_b,) shard of the bucket, and the caller gets those shards as they
are.  The JAX taps must return cotangents shaped like the leaves, so
they embed each shard in a zero-filled bucket that
`extract_bucket_shards` slices back out; a hook has no such constraint,
and the port has neither the embedding nor that function.

The reduce runs on the backward's own thread and stream, so its kernels
queue between the backward's: on a `LocalMesh` the bucket needs every
local rank's gradient, and the ranks' backwards run in turn, so the
buckets fire during the LAST local rank's backward (the earlier ranks'
gradients are complete by then).  On a `ProcessMesh` the reduce is
issued while the backward is still to run, but nothing here runs it
beside the backward: the collectives are issued on the backward's
stream, so every later backward kernel is queued behind the transfer.
Under nccl a ring hop (`batch_isend_irecv`) or an all-to-all returns to
the autograd thread without a host wait, but the ring's hops are driven
from the host one at a time; under gloo the wire is staged through host
memory and each transfer blocks that thread until it is done.  On four
H100 cards under nccl, overlap made each arm's step slower, not faster
(PERF.md, Findings).  The verdict (``verify``) is read once, by the
caller, after the backward.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

__all__ = ["DEFAULT_BUCKET_ELEMS", "REPORT_FIELDS", "bucket_layout",
           "BucketPlan", "overlapped_grads"]

# Default per-bucket element cap: 4 Mi elements (16 MiB of fp32 per rank).
DEFAULT_BUCKET_ELEMS = 4 * 1024 * 1024

# The fields of a bucket's report that the overlapped reduce merges: the
# verdict's counts and agreement, the wire's health counters.
REPORT_FIELDS = ("hop_bad", "gather_bad", "agree", "wire_sat",
                 "wire_underflow", "wire_nan", "wire_total", "aps_bad")


def bucket_layout(sizes: Sequence[int], bucket_elems: int,
                  group_ids: Optional[Sequence] = None) -> list:
    """Greedy bucket capping: split leaf indices into buckets of at most
    ``bucket_elems`` total elements (a single leaf larger than the cap
    forms its own bucket), preserving leaf order.  ``group_ids`` force a
    bucket break between unequal neighbours."""
    if bucket_elems < 1:
        raise ValueError(f"bucket_elems must be >= 1, got {bucket_elems}")
    buckets: list = []
    cur: list = []
    cur_n = 0
    cur_gid = None
    for i, n in enumerate(sizes):
        gid = None if group_ids is None else group_ids[i]
        if cur and (cur_n + n > bucket_elems or gid != cur_gid):
            buckets.append(cur)
            cur, cur_n = [], 0
        cur.append(i)
        cur_n += int(n)
        cur_gid = gid
    if cur:
        buckets.append(cur)
    return buckets


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """The static bucket layout over one list of gradient leaves:
    ``sizes`` (elements a leaf), ``starts`` (each leaf's GLOBAL flat
    offset, `dist._leaf_starts`'s index space, which the SR bits are
    drawn on), ``buckets`` (tuples of leaf indices) and the cap."""
    sizes: tuple
    starts: tuple
    buckets: tuple
    bucket_elems: int

    @classmethod
    def for_tree(cls, leaves: Sequence[torch.Tensor],
                 bucket_elems: Optional[int] = None) -> "BucketPlan":
        """The plan of ``leaves`` (in their order) at ``bucket_elems``
        (default `DEFAULT_BUCKET_ELEMS`)."""
        be = (DEFAULT_BUCKET_ELEMS if bucket_elems is None
              else int(bucket_elems))
        if be < 1:
            raise ValueError(f"bucket_elems must be >= 1, got {be}")
        leaves = list(leaves)
        sizes = tuple(int(l.numel()) for l in leaves)
        starts, off = [], 0
        for n in sizes:
            starts.append(off)
            off += n
        buckets = tuple(tuple(b) for b in bucket_layout(sizes, be))
        return cls(sizes=sizes, starts=tuple(starts), buckets=buckets,
                   bucket_elems=be)

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def key(self) -> tuple:
        """Hashable fingerprint of the layout, for a table of steps."""
        return (self.bucket_elems, self.buckets)


def _reached(objective: torch.Tensor, params: Sequence[torch.Tensor]) -> set:
    """Indices of the ``params`` the backward of ``objective`` reaches:
    those with an `AccumulateGrad` node in its graph."""
    want = {id(p): i for i, p in enumerate(params)}
    seen, out = set(), set()
    stack = [objective.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None and id(var) in want:
            out.add(want[id(var)])
        stack.extend(f for f, _ in fn.next_functions)
    return out


def _merge(reports: list, plan: BucketPlan, world: int, verify: bool,
           stats: bool, device) -> dict:
    """The buckets' reports merged as the JAX taps' report rows are:
    counts add, agreement ANDs over the buckets that ran, ``ok``
    recomputed; the health counters add, a bucket that never ran
    credited its elements x W in ``wire_total``."""
    ran = [r for r in reports if r is not None]
    i0 = torch.zeros((), dtype=torch.int32, device=device)
    out = {}
    if verify:
        hop = sum((r["hop_bad"].to(torch.int32) for r in ran), i0)
        gather = sum((r["gather_bad"].to(torch.int32) for r in ran), i0)
        agree = i0 + 1
        for r in ran:
            agree = torch.minimum(agree, r["agree"].to(torch.int32))
        out.update(hop_bad=hop, gather_bad=gather, agree=agree,
                   ok=((hop == 0) & (gather == 0)
                       & (agree == 1)).to(torch.int32))
    if stats:
        f0 = torch.zeros((), dtype=torch.float32, device=device)
        for f in ("wire_sat", "wire_underflow", "wire_nan", "wire_total"):
            out[f] = sum((r[f] for r in ran), f0)
        dead = sum(sum(plan.sizes[i] for i in idxs)
                   for idxs, r in zip(plan.buckets, reports) if r is None)
        out["wire_total"] = out["wire_total"] + float(world * dead)
        out["aps_bad"] = sum((r["aps_bad"].to(torch.int32) for r in ran),
                             i0)
    return out


def overlapped_grads(objective: torch.Tensor,
                     params: Sequence[torch.Tensor], mesh, *,
                     plan: BucketPlan, reduce_kw: dict,
                     prior: Sequence = (), extras: Optional[Sequence] = None,
                     key=None, wire_fault=None, verify: bool = False,
                     stats: bool = False,
                     collective: Optional[Callable] = None,
                     emulate_reduce: Optional[Callable] = None,
                     emulate_keys: Optional[Sequence] = None) -> tuple:
    """The gradients of ``objective`` w.r.t. ``params``, with every
    bucket of ``plan`` reduced over ``mesh`` from inside the backward
    (module docstring).

    ``objective`` is the LAST local rank's scalar of its last
    micro-batch; ``prior`` holds each earlier local rank's gradient
    leaves (a `LocalMesh`'s ranks 0 .. L-2, their backwards done; at
    ``emulate_node`` N > 1 each leaf a stack of the N micro-batch
    gradients, ``(N, *leaf)``); ``extras`` the last rank's ``(N-1,
    *leaf)`` stacks of its earlier micro-batches.  ``emulate_reduce(g,
    extra, i, key)`` (`emulate.make_overlap_emulate_fn`) reduces each
    leaf's N micro-batches locally before the bucket's collective, rank
    by rank with ``emulate_keys[rank]``.  A bucket's reduce is
    `dist.sum_gradients` over its leaves at their global offsets
    (``reduce_kw``: its precision and mode keywords; ``key``: the shared
    SR key; ``wire_fault`` arms bucket 0 only, so a drill's counters are
    those of one fault), or ``collective(b, idxs, per_rank_leaves,
    key)``, which returns one output per local rank and takes no
    ``verify`` or ``stats``; a bucket no gradient reaches runs it on
    zeros after the backward, as the monolith reduces them.

    Returns ``(grads, reduced, report)``: this backward's own gradients;
    each local rank's reduced leaves (bitwise the monolithic
    `sum_gradients` of the same layout), or with ``collective`` each
    local rank's list of the buckets' outputs in bucket order; and the
    merged report (None without ``verify`` and ``stats``)."""
    from .dist import sum_gradients

    params = list(params)
    n = len(params)
    if len(plan.sizes) != n:
        raise ValueError(f"BucketPlan built for {len(plan.sizes)} leaves, "
                         f"params have {n}")
    if collective is not None and (verify or stats):
        raise ValueError("a custom bucket collective threads no "
                         "verify/stats report — the ZeRO paths reject "
                         "them upstream (make_train_step)")
    local = len(mesh.ranks)
    if len(prior) != local - 1:
        raise ValueError(f"prior holds {len(prior)} ranks' gradients; the "
                         f"mesh has {local} local ranks")
    if emulate_reduce is not None and extras is None:
        raise ValueError("emulate_reduce needs the prior micro-batches' "
                         "stacked gradients via extras=")
    if extras is not None and len(extras) != n:
        raise ValueError(f"extras must align with the {n} param leaves, "
                         f"got {len(extras)}")
    if emulate_keys is None:
        emulate_keys = [None] * local
    reached = _reached(objective, params)
    bucket_of = {i: b for b, idxs in enumerate(plan.buckets) for i in idxs}
    pending = [sum(1 for i in idxs if i in reached)
               for idxs in plan.buckets]
    got: list = [None] * n
    out = [[None] * (n if collective is None else plan.n_buckets)
           for _ in range(local)]
    reports: list = [None] * plan.n_buckets

    def rank_leaf(li: int, i: int) -> torch.Tensor:
        """Local rank li's gradient of leaf i, locally reduced."""
        if li == local - 1:
            g = got[i] if got[i] is not None else torch.zeros_like(params[i])
            extra = None if extras is None else extras[i]
        else:
            g, extra = prior[li][i], None
            if emulate_reduce is not None:
                g, extra = g[-1], g[:-1]
        if emulate_reduce is not None:
            g = emulate_reduce(g, extra, i, emulate_keys[li])
        return g

    def fire(b: int) -> None:
        idxs = plan.buckets[b]
        per_rank = [[rank_leaf(li, i) for i in idxs] for li in range(local)]
        if collective is not None:
            for li, r in enumerate(collective(b, idxs, per_rank, key)):
                out[li][b] = r
            return
        rep = {}
        res = sum_gradients(
            per_rank, mesh, key=key, verify=verify, stats=stats,
            wire_fault=wire_fault if b == 0 else None,
            offset_starts=[plan.starts[i] for i in idxs], **reduce_kw)
        if verify or stats:
            res, rep = res
        reports[b] = rep        # ran (None: never ran)
        for li in range(local):
            for j, i in enumerate(idxs):
                out[li][i] = res[li][j]

    def hook(i: int):
        def on_grad(g):
            got[i] = g
            b = bucket_of[i]
            pending[b] -= 1
            if pending[b] == 0:
                fire(b)
        return on_grad

    handles = [params[i].register_hook(hook(i)) for i in sorted(reached)]
    try:
        grads = torch.autograd.grad(objective, params, allow_unused=True,
                                    materialize_grads=True)
    finally:
        for h in handles:
            h.remove()
    for b, idxs in enumerate(plan.buckets):
        if pending[b] > 0:
            raise RuntimeError(f"bucket {b}: {pending[b]} gradients never "
                               "arrived in the backward")
        if not any(i in reached for i in idxs):
            if collective is not None:
                fire(b)         # the monolith's collective of zeros
                continue
            # never ran: the zeros the monolith's reduce of zeros gives
            for li in range(local):
                for i in idxs:
                    out[li][i] = torch.zeros_like(params[i])
    report = None
    if verify or stats:
        report = _merge(reports, plan, mesh.world, verify, stats,
                        mesh.device)
    return list(grads), out, report
