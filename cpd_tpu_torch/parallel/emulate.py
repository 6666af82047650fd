"""Cluster-size emulation, ``--emulate_node N`` (port of
`cpd_tpu/parallel/emulate.py`: `_reduce_leaf`, `reduce_stacked_leaf`,
`make_overlap_emulate_fn`, `emulate_node_reduce`).

Each rank runs N micro-batches and reduces their gradients locally
before the cross-rank `sum_gradients`: per leaf, an APS shift from the
LOCAL max of the N micro-batch gradients (scaled by N, not by the world
size), a cast to eXmY, the ordered quantized sum over the N, and the
unscale.  The quirks of the reference recipe are kept:

* N == 1 returns the single gradient as it is, unquantized;
* the cast runs with APS off too (shift 0);
* an all-zero leaf takes shift 0 (the `aps_shift_factors` sentinel);
* the unscale is a true divide by ``exp2_exact(shift)``, never a
  multiply by the reciprocal;
* stochastic rounding keys leaf i with ``fold_in(key, i)`` (i its index
  in the caller's list) and splits that into ``k_pre`` (the cast, with
  ``jax.random.bits(k_pre, (N, *shape))``'s bits) and ``k_sum`` (the
  ordered sum, leaf-local offsets);
* a key with ``rounding="nearest"``, or ``"stochastic"`` without one,
  raises.

Launches on CUDA tensors.  Every leaf's shift comes from one pass of
vector ops over the leaves (elementwise, so each is the leaf's own).
With RTNE the leaves go in buckets of whole leaves
(`overlap.bucket_layout` at ``DEFAULT_BUCKET_ELEMS``): each leaf's N
gradients are scaled into the bucket's (N, elems) stack, one K1 casts
the stack and N K3 launches sum it.  The cast and the sum are
elementwise, so this is bitwise the per-leaf result.  With SR every leaf
has its own bit streams, so the leaf is the unit: one flat `sr_bits` and
one K2 for the cast, then N `sr_bits` + K4 for the sum.  ``fused=False``
runs the plain versions on any device.

`make_overlap_emulate_fn` is the emulate reduce inside the overlapped
backward (`overlap.overlapped_grads`): one leaf at a time, as its bucket
closes, with `reduce_stacked_leaf` (the leaf alone is the unit, RTNE as
SR; bitwise the bucketed RTNE, whose cast and sum are elementwise).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..quant.prng import fold_in, split
from .aps import aps_max_exponents, aps_shift_factors, exp2_exact
from .overlap import DEFAULT_BUCKET_ELEMS, bucket_layout
from .reduction import _use_kernel, cast_site, ordered_quantized_sum

__all__ = ["emulate_node_reduce", "reduce_stacked_leaf",
           "make_overlap_emulate_fn"]


def _check_rounding(rounding: str, key) -> None:
    if rounding not in ("nearest", "stochastic"):
        raise ValueError(f"unknown rounding {rounding!r}")
    if rounding == "stochastic" and key is None:
        raise ValueError("rounding='stochastic' requires a PRNG key")
    if rounding == "nearest" and key is not None:
        raise ValueError("a PRNG key was passed but rounding='nearest' "
                         "would ignore it; pass rounding='stochastic' "
                         "(matching sum_gradients' contract)")


def _scales(leaves: Sequence[torch.Tensor], n: int, use_aps: bool,
            grad_exp: int) -> torch.Tensor:
    """``2^shift`` of every leaf as one (n_leaves,) vector: the APS shift
    from each leaf's local max over its (N, ...) stack, or 0 without
    APS.  Elementwise over the leaves, so each entry is what the leaf
    alone would give (`_reduce_leaf`'s ``aps_max_exponents([g], n)``)."""
    if use_aps:
        shifts = aps_shift_factors(aps_max_exponents(leaves, n), grad_exp)
    else:
        shifts = torch.zeros((len(leaves),), dtype=torch.float32,
                             device=leaves[0].device)
    return exp2_exact(shifts)


def _reduce_leaf(g: torch.Tensor, scale: torch.Tensor, grad_exp: int,
                 grad_man: int, key, kernel: bool) -> torch.Tensor:
    """One stacked leaf at N > 1 with its ``scale`` = ``2^shift``: the
    cast, the ordered N-step sum, the true-divide unscale."""
    scaled = g * scale
    if key is None:
        cast = cast_site(scaled, None, grad_exp, grad_man, kernel=kernel)
        res = ordered_quantized_sum(cast, grad_exp, grad_man, fused=kernel)
    else:
        k_pre, k_sum = split(key)
        cast = cast_site(scaled, None, grad_exp, grad_man, kernel=kernel,
                         key=k_pre, flat=True)
        res = ordered_quantized_sum(cast, grad_exp, grad_man, key=k_sum,
                                    fused=kernel)
    return res / scale


def reduce_stacked_leaf(g: torch.Tensor, n: int, use_aps: bool = False,
                        grad_exp: int = 5, grad_man: int = 2, key=None, *,
                        fused: Optional[bool] = None) -> torch.Tensor:
    """One stacked (N, *shape) leaf -> its locally reduced (*shape)
    gradient (`_reduce_leaf`).  ``key`` (SR) must already carry the
    leaf's index, ``fold_in(key, i)``, to draw `emulate_node_reduce`'s
    bits."""
    if n == 1:
        return g[0]
    g = g.to(torch.float32)
    return _reduce_leaf(g, _scales([g], n, use_aps, grad_exp)[0], grad_exp,
                        grad_man, key, _use_kernel(g, fused))


def make_overlap_emulate_fn(n: int, use_aps: bool, grad_exp: int,
                            grad_man: int, sr: bool, *,
                            fused: Optional[bool] = None):
    """The `overlap.overlapped_grads` ``emulate_reduce`` hook, shared by
    the image and the LM steps so the SR key contract,
    ``fold_in(emu_key, GLOBAL leaf index)`` into `reduce_stacked_leaf`
    (`emulate_node_reduce`'s per-leaf streams), cannot drift between
    them.  Returns ``fn(g, extra, i, emu_key)``: the last micro-batch's
    gradient ``g`` of leaf i stacked under the earlier ones' ``extra``
    ``(N-1, *leaf)``, reduced locally."""

    def emulate_fn(g, extra, i, ekey):
        stacked = torch.cat([extra, g.unsqueeze(0)], 0)
        return reduce_stacked_leaf(
            stacked, n, use_aps, grad_exp, grad_man,
            key=fold_in(ekey, i) if sr else None, fused=fused)

    return emulate_fn


def _reduce_bucket(leaves: Sequence[torch.Tensor], n: int,
                   scales: Sequence[torch.Tensor], grad_exp: int,
                   grad_man: int, kernel: bool) -> list:
    """RTNE over a bucket of whole leaves: each leaf scaled into one
    (N, elems) stack, one cast of the stack, the N-step ordered sum,
    then each leaf's true-divide unscale."""
    if len(leaves) == 1:
        return [_reduce_leaf(leaves[0], scales[0], grad_exp, grad_man, None,
                             kernel)]
    sizes = [g[0].numel() for g in leaves]
    stack = torch.empty((n, sum(sizes)), dtype=torch.float32,
                        device=leaves[0].device)
    off = 0
    for g, size, scale in zip(leaves, sizes, scales):
        torch.mul(g.reshape(n, size), scale, out=stack[:, off:off + size])
        off += size
    cast = cast_site(stack, None, grad_exp, grad_man, kernel=kernel)
    res = ordered_quantized_sum(cast, grad_exp, grad_man, fused=kernel)
    out, off = [], 0
    for g, size, scale in zip(leaves, sizes, scales):
        out.append((res[off:off + size] / scale).reshape(g.shape[1:]))
        off += size
    return out


def emulate_node_reduce(stacked_grads: Sequence[torch.Tensor],
                        emulate_node: int, use_aps: bool = False,
                        grad_exp: int = 5, grad_man: int = 2, key=None,
                        rounding: str = "nearest", *,
                        fused: Optional[bool] = None) -> list:
    """Reduce each stacked (N, *shape) leaf of ``stacked_grads`` (one
    rank's N micro-batch gradients, in one fixed leaf order) to its local
    (*shape) gradient, ready for `sum_gradients`.  ``rounding=
    "stochastic"`` with a `prng` ``key`` rounds every cast
    stochastically, one bit stream per leaf (module docstring).  RTNE
    runs on buckets of whole leaves; the buckets change no bit."""
    _check_rounding(rounding, key)
    leaves = list(stacked_grads)
    if emulate_node == 1 or not leaves:
        return [g[0] for g in leaves]
    n = emulate_node
    leaves = [g.to(torch.float32) for g in leaves]
    kernel = _use_kernel(leaves[0], fused)
    scales = list(_scales(leaves, n, use_aps, grad_exp))
    if key is not None:
        return [_reduce_leaf(g, scale, grad_exp, grad_man, fold_in(key, i),
                             kernel)
                for i, (g, scale) in enumerate(zip(leaves, scales))]
    out = []
    for idxs in bucket_layout([g[0].numel() for g in leaves],
                              DEFAULT_BUCKET_ELEMS):
        out += _reduce_bucket([leaves[i] for i in idxs], n,
                              [scales[i] for i in idxs], grad_exp,
                              grad_man, kernel)
    return out

