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
  block-scaled (ring mode only).

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
with its own bits), the reduction takes the shared ``k_sum`` (``k_post``
belongs to ``mode="fast"``, not ported).

``verify=True`` returns ``(reduced, report)``: in ring mode each
bucket's ring reports {hop_bad, gather_bad, agree, ok} and the reports
merge (counts add, agreement ANDs, ``ok`` recomputed); in faithful mode
the report is the cross-rank agreement of `integrity.tree_digest` of the
reduced leaves alone.  ``wire_fault=(code, rank)`` hits the ring of
bucket 0 only (`ring.ring_quantized_sum`'s ``fault``), so one fault
gives the same counters whatever the bucket count.

On CUDA tensors (``fused=None``) every cast is a hand-written kernel:
the APS pre-quantize is K1, or `sr_bits` + K2 (one launch each per leaf
per rank), a faithful scan step K3 or `sr_bits` + K4 (four of each per
step with Kahan), a ring hop K6/K5 with their SR arms (K3/K4 for a
format the codec cannot pack, and for every Kahan site).
``fused=False`` runs the plain torch version of each, on any device —
the reference the kernels are held against.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch

from ..quant.prng import PRNGKey, fold_in, split
from .aps import (aps_max_exponents, aps_scale, aps_shift_factors_checked,
                  aps_unscale)
from .integrity import digest_agree, tree_digest
from .mesh import per_distinct
from .overlap import DEFAULT_BUCKET_ELEMS, bucket_layout
from .reduction import _use_kernel, cast_site, quantized_sum
from .ring import clean_report, hierarchical_ring_sum, report_ok

__all__ = ["sum_gradients", "make_sum_gradients_fn", "grad_sr_key",
           "quantize_tree_sr"]


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
    and ``wire_fault`` corrupts bucket 0's ring (module docstring).
    Stats and ``mode="fast"`` are not ported yet and raise."""
    if mode not in ("faithful", "ring", "fast"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "fast":
        raise NotImplementedError("mode='fast' is not ported yet (ROADMAP "
                                  "Queue A, A3)")
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
    if stats:
        raise NotImplementedError("stats=True (reduce-wire telemetry) is "
                                  "not ported yet (ROADMAP Queue A, A3)")
    if len(grads) != len(mesh.ranks):
        raise ValueError(f"expected one leaf list per local rank "
                         f"({len(mesh.ranks)}), got {len(grads)}")
    template = list(grads[0])
    if not template:
        out = [list(g) for g in grads]
        return (out, clean_report()) if verify else out
    kernel = _use_kernel(template[0], fused)
    grads = [[g.to(torch.float32) for g in leaves] for leaves in grads]
    starts = _leaf_starts(template)

    k_sum = None
    k_pre = [None] * len(grads)
    if key is not None:
        k_pre_all, k_sum, _ = split(key, 3)
        # each rank rounds its own gradients with its own bits
        k_pre = [fold_in(k_pre_all, r) for r in mesh.ranks]

    shifts = [None] * len(grads)
    if use_aps:
        max_exp = mesh.max([aps_max_exponents(leaves, mesh.world)
                            for leaves in grads])
        shifts = per_distinct(
            lambda m: aps_shift_factors_checked(m, grad_exp)[0], max_exp)
        grads = [quantize_tree_sr(aps_scale(leaves, s), grad_exp, grad_man,
                                  k, starts, fused=kernel)
                 for leaves, s, k in zip(grads, shifts, k_pre)]

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
    if not verify:
        return reduced
    if mode == "ring":
        return reduced, _merge_verify_reports(reports)
    # the gather has no wire of its own to checksum: the agreement of
    # the reduced trees is the whole verdict
    agree = digest_agree(per_distinct(tree_digest, reduced), mesh)[0]
    report = clean_report(agree.device)
    report["agree"] = report["ok"] = agree
    return reduced, report


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
    reduced ``(*shape)`` leaves (with ``verify=True``, ``(reduced,
    report)``).  A dict keeps its keys (leaf order is its insertion
    order), a sequence becomes a list.  Every keyword goes to
    `sum_gradients`."""

    def reduced(stacked):
        if isinstance(stacked, Mapping):
            keys, leaves = list(stacked), list(stacked.values())
        else:
            keys, leaves = None, list(stacked)
        per_rank = [[leaf[r] for leaf in leaves] for r in mesh.ranks]
        res = sum_gradients(per_rank, mesh, **kwargs)
        out, report = res if kwargs.get("verify") else (res, None)
        out = dict(zip(keys, out[0])) if keys is not None else out[0]
        return out if report is None else (out, report)

    return reduced
