"""Low-precision gradient all-reduce (port of `cpd_tpu/parallel/dist.py`:
modes ``faithful`` and ``ring``, APS, RTNE or stochastic rounding, plain
or Kahan-compensated accumulation, the block-scaled ring wire, the
verified transport and wire-fault injection).

`sum_gradients` takes each local rank's gradient leaves — a list per
rank of fp32 tensors, in one fixed leaf order — and returns each rank's
reduced leaves: the SUM over the mesh's ranks (trainers divide the loss
by the world size, so the sum is the mean).  The pipeline:

    [APS: rank-MAX'd per-leaf max exponent -> shift by 2^k -> cast]
    -> ordered requantizing reduction -> [APS: divide by 2^k]

* ``faithful`` — all-gather the fp32 gradients, then the rank-ordered
  requantizing scan (`reduction.quantized_sum`), one per bucket;
* ``ring`` — the bit-packed reduce-scatter + all-gather ring
  (`ring.ring_quantized_sum`), one per bucket; ``block_scale`` ships it
  block-scaled (ring mode only);
* ``fast`` — the cast of each rank's gradients (already done by APS;
  none at (8, 23)), an fp32 sum over the ranks in rank order (the JAX
  package's ``psum``), and one cast of the sum (none at (8, 23)).

Both modes bucket the leaves (concatenated in leaf order) at
`overlap.DEFAULT_BUCKET_ELEMS` with `overlap.bucket_layout`.  The ring's
chunk boundaries follow that flat layout, so the bucket cap is part of
the ring's documented accumulation order; the faithful scan is
elementwise, so its buckets change no bit (the JAX package buckets it on
the TPU only).  Its gather ships fp32: packing APS-cast values is
lossless, so the sum is the same.

Stochastic rounding (``rounding="stochastic"`` with a `prng` key) draws
every cast's bits by GLOBAL flat offset: leaf i's elements sit at
``_leaf_starts(leaves)[i] + j``, so bucketing changes no bit.  The key
splits three ways as in the JAX package: the APS pre-quantize takes
``k_pre`` with the rank folded in (each rank rounds its own gradients
with its own bits), the reduction takes the shared ``k_sum``, and fast
mode's cast of the sum the shared ``k_post``.

``verify=True`` returns ``(reduced, report)``: in ring mode each
bucket's ring reports {hop_bad, gather_bad, agree, ok} and the reports
merge (counts add, agreement ANDs, ``ok`` recomputed); in faithful and
fast mode the report is the cross-rank agreement of
`integrity.tree_digest` of the reduced leaves alone.
``wire_fault=(code, rank)`` hits the ring of bucket 0 only
(`ring.ring_quantized_sum`'s ``fault``), so one fault gives the same
counters whatever the bucket count.

``stats=True`` returns ``(reduced, report)`` too, the report holding the
reduce wire's numeric health (`numerics.quant_health`): ``wire_sat``,
``wire_underflow``, ``wire_nan`` and ``wire_total`` summed over the ranks,
and ``aps_bad``, the leaves whose rank-MAX'd APS exponent is +Inf or NaN
(`aps_shift_factors_checked`; 0 without APS).  With APS the counters
observe the pre-quantize's (scaled, cast) pair that already ran; without
APS each rank's gradients x W are cast to the wire format once (RTNE,
one K1 a leaf, whatever ``rounding``) as a probe whose output is
discarded.  The reduced values are bitwise those of ``stats=False``.
With ``verify`` the two reports merge into one dict.

The mesh is a `mesh.LocalMesh` (every rank in this process) or a
`mesh.ProcessMesh` (this process's rank of a `torch.distributed` group,
joined by `dist_init`); ``grads`` holds one leaf list per local rank of
either, and the result is bitwise the same on both.  `replicate`,
`broadcast_from`, `all_reduce_mean` and `local_rows` are the
multi-process helpers of the JAX module.

On CUDA tensors (``fused=None``) every cast is a hand-written kernel:
the APS pre-quantize is K1, or `sr_bits` + K2 (one launch each per leaf
per rank), a faithful scan step K3 or `sr_bits` + K4 (four of each per
step with Kahan), a ring hop K6/K5 with their SR arms (K3/K4 for a
format the codec cannot pack, and for every Kahan site), fast mode's
cast of the sum one K1 (or `sr_bits` + K2) over all leaves.
``fused=False`` runs the plain torch version of each, on any device —
the reference the kernels are held against.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Sequence

import torch

from ..quant.numerics import HEALTH_FIELDS, quant_health
from ..quant.prng import PRNGKey, fold_in, split
from .aps import (aps_max_exponents, aps_scale, aps_shift_factors_checked,
                  aps_unscale)
from .integrity import digest_agree, tree_digest
from .mesh import per_distinct
from .overlap import DEFAULT_BUCKET_ELEMS, bucket_layout
from .reduction import _use_kernel, cast_site, quantized_sum
from .ring import clean_report, hierarchical_ring_sum, report_ok

__all__ = ["sum_gradients", "make_sum_gradients_fn", "grad_sr_key",
           "quantize_tree_sr", "tree_quant_health", "dist_init",
           "replicate", "broadcast_from", "all_reduce_mean", "local_rows"]

# where a launcher says which process this is: torchrun, SLURM, Open MPI
# (rank, world size, local rank)
_LAUNCHERS = (("RANK", "WORLD_SIZE", "LOCAL_RANK"),
              ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
              ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
               "OMPI_COMM_WORLD_LOCAL_RANK"))


def _launcher_env() -> Optional[tuple]:
    """``(rank, world, local_rank)`` from the first launcher whose
    variables are set, else None."""
    for rank, world, local in _LAUNCHERS:
        if rank in os.environ and world in os.environ:
            r = int(os.environ[rank])
            return r, int(os.environ[world]), int(os.environ.get(local, r))
    return None


def _check_nccl_card(local_rank: int) -> None:
    """nccl runs one rank per card: this rank's card must exist, and no
    other local rank may share it."""
    if not torch.cuda.is_available():
        raise RuntimeError("backend 'nccl' needs an NVIDIA card, and "
                           "torch.cuda.is_available() is False; the CPU "
                           "and ranks that share a card take 'gloo'")
    cards = torch.cuda.device_count()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", local_rank + 1))
    if local_rank >= cards or local_world > cards:
        raise RuntimeError(
            f"backend 'nccl' runs one rank per card, but local rank "
            f"{local_rank} of {max(local_world, local_rank + 1)} has "
            f"{cards} card(s): NCCL refuses two ranks on one device; "
            f"run one process per card, or take backend 'gloo' to share "
            f"a card")


def dist_init(backend: Optional[str] = None, *, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              local_rank: Optional[int] = None,
              init_method: Optional[str] = None) -> tuple:
    """Join the `torch.distributed` process group and return ``(rank,
    world_size)`` (port of `cpd_tpu/parallel/dist.py:dist_init`).

    The process learns who it is from explicit arguments, else from its
    launcher's variables: torchrun's ``RANK``/``WORLD_SIZE``/
    ``LOCAL_RANK``, SLURM's ``SLURM_PROCID``/``SLURM_NTASKS``/
    ``SLURM_LOCALID`` or Open MPI's ``OMPI_COMM_WORLD_*``; the rendezvous
    is ``init_method``, else ``env://`` (``MASTER_ADDR``/
    ``MASTER_PORT``).  Outside a cluster (none of these) it is a no-op
    returning ``(0, 1)``; an initialized group returns its own numbers.
    ``backend`` is the caller's choice and is never guessed: ``nccl``,
    one rank per card (``torch.cuda.set_device(local_rank)`` comes
    first; two ranks on one card raise), or ``gloo`` (the CPU, or ranks
    sharing a card, `mesh.ProcessMesh` staging the wire through the
    host).  A failed rendezvous raises: nothing is swallowed, so an
    N-process job never degrades to N independent trainings."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = _launcher_env()
    explicit = (rank is not None or world_size is not None
                or init_method is not None)
    if not explicit and env is None:
        return 0, 1
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' (one rank per card) or "
                         f"'gloo' (the CPU, or ranks sharing a card), got "
                         f"{backend!r}")
    if rank is None or world_size is None:
        if env is None:
            raise ValueError("pass both rank= and world_size=, or launch "
                             "under torchrun, SLURM or Open MPI")
        rank = env[0] if rank is None else rank
        world_size = env[1] if world_size is None else world_size
        local_rank = env[2] if local_rank is None else local_rank
    local_rank = rank if local_rank is None else local_rank
    if backend == "nccl":
        _check_nccl_card(local_rank)
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return dist.get_rank(), dist.get_world_size()


def _broadcast_(t: torch.Tensor, mesh, src: int) -> None:
    """``t`` overwritten in place with rank ``src``'s bytes."""
    if mesh.world == 1 or len(mesh.ranks) == mesh.world:
        return
    import torch.distributed as dist

    if mesh.staged:
        host = t.detach().cpu()
        dist.broadcast(host, src)
        with torch.no_grad():
            t.copy_(host)
    else:
        dist.broadcast(t.detach(), src)


def replicate(module, mesh, src: int = 0):
    """Rank ``src``'s parameters and buffers, byte for byte, on every
    rank of ``mesh`` (port of `replicate`, the reference's
    ``broadcast_params``); in place, returning ``module``.  A `LocalMesh`
    shares its one module, so there is nothing to move."""
    for t in list(module.parameters()) + list(module.buffers()):
        _broadcast_(t, mesh, src)
    return module


def broadcast_from(x: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s value of ``x`` on every rank (a new tensor): one
    broadcast on a `ProcessMesh`, a copy of ``x`` on a `LocalMesh`.  The
    transport ladder's resync after a downgrade calls it on every tensor
    of the state (`integrity.make_consensus_fns`); `replicate` moves the
    weights at the start."""
    out = x.clone()
    _broadcast_(out, mesh, src)
    return out


def all_reduce_mean(xs: Sequence[torch.Tensor], mesh) -> list:
    """The mean over the ranks of one value per local rank: the
    rank-order sum / world (`mesh.sum`), the loss and metric averaging of
    the reference's examples.  API parity with the JAX module's
    ``all_reduce_mean``: nothing on the main path calls it (the step
    averages through ``mesh.mean`` itself)."""
    return mesh.mean(xs)


def local_rows(x, mesh):
    """This process's rows of a global batch ``x`` (numpy or a tensor):
    the contiguous ``1/P`` slice of process ``p`` out of ``P``, which
    holds the rows of its local ranks (the per-process contract of the
    JAX ``host_batch_to_global``: the global batch is the processes'
    slices in rank order).  A `LocalMesh` holds every rank: all rows."""
    if len(mesh.ranks) == mesh.world:
        return x
    n = x.shape[0]
    if n % mesh.world:
        raise ValueError(f"global batch {n} is not a multiple of the "
                         f"{mesh.world} processes")
    per = n // mesh.world * len(mesh.ranks)
    lo = mesh.ranks[0] * (n // mesh.world)
    return x[lo:lo + per]


def _leaf_starts(leaves: Sequence[torch.Tensor]) -> list:
    """Global flat offset of each leaf in leaf order: the index space the
    SR bitstream is defined on."""
    starts, off = [], 0
    for leaf in leaves:
        starts.append(off)
        off += leaf.numel()
    return starts


def quantize_tree_sr(leaves: Sequence[torch.Tensor], grad_exp: int,
                     grad_man: int, key, starts=None, *,
                     fused: Optional[bool] = None) -> list:
    """Per-leaf eXmY cast: RTNE when ``key`` is None, else stochastic
    rounding with global-offset bits (leaf i's elements at ``starts[i] +
    j``; default `_leaf_starts`).  One K1, or `sr_bits` + K2, per leaf
    on CUDA."""
    if not leaves:
        return []
    kernel = _use_kernel(leaves[0], fused)
    starts = _leaf_starts(leaves) if starts is None else list(starts)
    return [cast_site(g, None, grad_exp, grad_man, kernel=kernel, key=key,
                      offset_start=st) for st, g in zip(starts, leaves)]


# below this many elements every float32 count is an exact integer
EXACT_COUNTS = 1 << 24


def tree_quant_health(before: Sequence[torch.Tensor],
                      after: Sequence[torch.Tensor]) -> dict:
    """`quant_health` summed over two matching leaf lists (cast inputs
    and outputs, leaf for leaf), as the JAX package sums it: float32,
    leaf by leaf from zero.  Below EXACT_COUNTS elements every partial
    sum is an exact integer, so the counts are taken once over the leaves
    concatenated; past it, leaf by leaf, where the float32 sum rounds as
    JAX's does.  Empty lists report zeros."""
    if not before:
        return {f: torch.zeros((), dtype=torch.float32) for f in
                HEALTH_FIELDS}
    if sum(b.numel() for b in before) < EXACT_COUNTS:
        return quant_health(_concat(before), _concat(after))
    total = None
    for b, a in zip(before, after):
        h = quant_health(b, a)
        total = h if total is None else {f: total[f] + h[f]
                                         for f in HEALTH_FIELDS}
    return total


def grad_sr_key(grad_seed: int, step: int, site: int) -> tuple:
    """The gradient pipeline's SR key: ``fold_in(fold_in(PRNGKey(seed),
    step), site)``, no rank folded in.  Site 0 is the rank-local
    pre-reduce cast, site 1 the `sum_gradients` reduction."""
    return fold_in(fold_in(PRNGKey(grad_seed), step), site)


def _split(flat: torch.Tensor, leaves: Sequence[torch.Tensor]) -> list:
    out, off = [], 0
    for leaf in leaves:
        out.append(flat[off:off + leaf.numel()].reshape(leaf.shape))
        off += leaf.numel()
    return out


def _concat(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    if len(leaves) == 1:
        return leaves[0].reshape(-1).to(torch.float32)
    return torch.cat([g.reshape(-1).to(torch.float32) for g in leaves])


def sum_gradients(grads: Sequence[Sequence[torch.Tensor]], mesh,
                  use_aps: bool = False, grad_exp: int = 5,
                  grad_man: int = 2, use_kahan: bool = False,
                  mode: str = "faithful",
                  bucket_elems: Optional[int] = None,
                  rounding: str = "nearest", key=None, verify: bool = False,
                  wire_fault=None, stats: bool = False,
                  block_scale: bool = False, block_size: int = 128,
                  fused: Optional[bool] = None):
    """Low-precision gradient all-reduce (SUM) over ``mesh``'s ranks.

    ``grads[i]`` is local rank ``mesh.ranks[i]``'s list of gradient
    leaves; returns the reduced leaves for each local rank (equal on
    every rank).  use_aps shifts each leaf's exponent range to the top
    of the format around the reduction (aps.py); use_kahan compensates
    the ordered accumulation; ``rounding="stochastic"`` with ``key`` (a
    `prng` key, e.g. `grad_sr_key`) rounds every cast stochastically
    (module docstring).  ``block_scale`` ships the ring block-scaled
    (blocks of ``block_size``); ``verify`` returns ``(reduced, report)``
    and ``wire_fault`` corrupts bucket 0's ring; ``stats`` returns
    ``(reduced, report)`` with the wire's health counters (module
    docstring)."""
    if mode not in ("faithful", "ring", "fast"):
        raise ValueError(f"unknown mode {mode!r}")
    if rounding not in ("nearest", "stochastic"):
        raise ValueError(f"unknown rounding {rounding!r}")
    if rounding == "stochastic" and key is None:
        raise ValueError("rounding='stochastic' requires a PRNG key "
                         "(fold in the step counter for fresh per-step "
                         "bits)")
    if rounding == "nearest" and key is not None:
        raise ValueError("a PRNG key was passed but rounding='nearest' "
                         "would ignore it; pass rounding='stochastic'")
    if block_scale and mode != "ring":
        raise ValueError(
            f"block_scale=True needs mode='ring' (got {mode!r}): the "
            f"per-block shift sidecar rides the ring's packed wire — "
            f"faithful's gather and fast's psum have no lane to carry it")
    if len(grads) != len(mesh.ranks):
        raise ValueError(f"expected one leaf list per local rank "
                         f"({len(mesh.ranks)}), got {len(grads)}")
    template = list(grads[0])
    if not template:
        out = [list(g) for g in grads]
        prec = [tree_quant_health([], [])] * len(grads)
        return _with_report(out, clean_report() if verify else None,
                            prec if stats else None, torch.zeros(
                                (), dtype=torch.int32), mesh)
    kernel = _use_kernel(template[0], fused)
    grads = [[g.to(torch.float32) for g in leaves] for leaves in grads]
    starts = _leaf_starts(template)

    k_sum = k_post = None
    k_pre = [None] * len(grads)
    if key is not None:
        k_pre_all, k_sum, k_post = split(key, 3)
        # each rank rounds its own gradients with its own bits
        k_pre = [fold_in(k_pre_all, r) for r in mesh.ranks]

    shifts = [None] * len(grads)
    prec = None
    aps_bad = torch.zeros((), dtype=torch.int32, device=template[0].device)
    if use_aps:
        max_exp = mesh.max([aps_max_exponents(leaves, mesh.world)
                            for leaves in grads])
        checked = per_distinct(
            lambda m: aps_shift_factors_checked(m, grad_exp), max_exp)
        shifts = [c[0] for c in checked]
        aps_bad = checked[0][1]
        scaled = [aps_scale(leaves, s) for leaves, s in zip(grads, shifts)]
        grads = [quantize_tree_sr(sc, grad_exp, grad_man, k, starts,
                                  fused=kernel)
                 for sc, k in zip(scaled, k_pre)]
        if stats:
            # the pre-quantize's own (input, output) pair: no extra cast
            prec = [tree_quant_health(sc, g) for sc, g in zip(scaled, grads)]
    elif stats:
        # the probe: each rank's gradients x W (APS's bound on the scan's
        # partial sums) cast once to the wire format, output discarded
        w = float(mesh.world)
        scaled = [[g * w for g in leaves] for leaves in grads]
        prec = [tree_quant_health(sc, quantize_tree_sr(
            sc, grad_exp, grad_man, None, starts, fused=kernel))
            for sc in scaled]
        del scaled

    if mode == "fast":
        reduced = _fast_sum(grads, mesh, template, shifts, use_aps,
                            grad_exp, grad_man, k_pre, k_post, starts,
                            kernel)
        return _with_report(
            reduced, _agreement_report(reduced, mesh) if verify else None,
            prec, aps_bad, mesh)

    buckets = bucket_layout([g.numel() for g in template],
                            bucket_elems if bucket_elems is not None
                            else DEFAULT_BUCKET_ELEMS)
    reduced = [[None] * len(template) for _ in grads]
    reports = []
    for b, idxs in enumerate(buckets):
        lo, hi = idxs[0], idxs[-1] + 1       # a bucket is a leaf range
        flats = [_concat([leaves[i] for i in idxs]) for leaves in grads]
        kw = dict(use_kahan=use_kahan, key=k_sum, offset_start=starts[lo],
                  fused=kernel)
        if mode == "ring":
            red = hierarchical_ring_sum(
                flats, mesh, grad_exp, grad_man, block_scale=block_scale,
                block_size=block_size, verify=verify,
                fault=wire_fault if b == 0 else None, **kw)
            if verify:
                red, rep = red
                reports.append(rep)
        else:
            red = per_distinct(lambda st: quantized_sum(
                st, grad_exp, grad_man, **kw), mesh.all_gather(flats))

        def unscaled(flat, s, lo=lo, hi=hi):
            pieces = _split(flat, template[lo:hi])
            return pieces if s is None else aps_unscale(pieces, s[lo:hi])

        for out, pieces in zip(reduced, per_distinct(unscaled, red, shifts)):
            out[lo:hi] = pieces
    report = None
    if verify:
        report = (_merge_verify_reports(reports) if mode == "ring"
                  else _agreement_report(reduced, mesh))
    return _with_report(reduced, report, prec, aps_bad, mesh)


def _with_report(reduced: list, report: Optional[dict],
                 prec: Optional[list], aps_bad: torch.Tensor, mesh):
    """``reduced``, or ``(reduced, report)`` when a verify report or the
    per-rank health counters ``prec`` are on: the counters summed over
    the ranks as ``wire_*``, beside ``aps_bad``."""
    if report is None and prec is None:
        return reduced
    report = {} if report is None else dict(report)
    if prec is not None:
        for f in HEALTH_FIELDS:
            report["wire_" + f] = mesh.sum([p[f] for p in prec])[0]
        report["aps_bad"] = aps_bad
    return reduced, report


def _fast_sum(grads: list, mesh, template: list, shifts: list,
              use_aps: bool, grad_exp: int, grad_man: int, k_pre: list,
              k_post, starts: list, kernel: bool) -> list:
    """``mode="fast"``: each rank's cast (where APS has not cast already,
    and off (8, 23)), the fp32 SUM over the ranks in rank order, one cast
    of the sum with ``k_post`` (off (8, 23)), then the APS unscale.  The
    sum and its cast run on the leaves concatenated in leaf order: both
    are elementwise, and the SR bits are drawn by the same global
    offsets (`_leaf_starts`), so the bits are those of a cast per leaf in
    one launch."""
    fp32 = grad_exp == 8 and grad_man == 23
    if not use_aps and not fp32:
        grads = [quantize_tree_sr(leaves, grad_exp, grad_man, k, starts,
                                  fused=kernel)
                 for leaves, k in zip(grads, k_pre)]
    total = mesh.sum([_concat(leaves) for leaves in grads])
    if not fp32:
        total = per_distinct(lambda t: cast_site(
            t, None, grad_exp, grad_man, kernel=kernel, key=k_post,
            offset_start=0), total)

    def unscaled(flat, s):
        pieces = _split(flat, template)
        return pieces if s is None else aps_unscale(pieces, s)

    return [list(p) for p in per_distinct(unscaled, total, shifts)]


def _agreement_report(reduced: list, mesh) -> dict:
    """The verdict of a reduce with no wire of its own to checksum (the
    faithful gather, the fast sum): the cross-rank agreement of the
    reduced trees is the whole report."""
    agree = digest_agree(per_distinct(tree_digest, reduced), mesh)[0]
    report = clean_report(agree.device)
    report["agree"] = report["ok"] = agree
    return report


def _merge_verify_reports(reports: list) -> dict:
    """Per-bucket ring reports merged into one verdict: the mismatch
    counts add, the agreement ANDs, ``ok`` is recomputed."""
    if not reports:
        return clean_report()
    agree = reports[0]["agree"]
    for r in reports[1:]:
        agree = torch.minimum(agree, r["agree"])
    merged = {"hop_bad": sum(r["hop_bad"] for r in reports),
              "gather_bad": sum(r["gather_bad"] for r in reports),
              "agree": agree}
    merged["ok"] = report_ok(merged)
    return merged


def make_sum_gradients_fn(mesh, **kwargs):
    """``stacked_grads -> reduced`` over ``mesh``: the leaves hold every
    rank's gradient stacked, ``(W, *shape)``; the result holds rank 0's
    reduced ``(*shape)`` leaves (with ``verify`` or ``stats``,
    ``(reduced, report)``).  A dict keeps its keys (leaf order is its insertion
    order), a sequence becomes a list.  Every keyword goes to
    `sum_gradients`."""

    def reduced(stacked):
        if isinstance(stacked, Mapping):
            keys, leaves = list(stacked), list(stacked.values())
        else:
            keys, leaves = None, list(stacked)
        per_rank = [[leaf[r] for leaf in leaves] for r in mesh.ranks]
        res = sum_gradients(per_rank, mesh, **kwargs)
        out, report = (res if kwargs.get("verify") or kwargs.get("stats")
                       else (res, None))
        out = dict(zip(keys, out[0])) if keys is not None else out[0]
        return out if report is None else (out, report)

    return reduced
