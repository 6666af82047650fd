"""ZeRO-1/2: the optimizer state, and with ZeRO-2 the reduce, sharded
over the data-parallel ranks (port of `cpd_tpu/parallel/zero.py`:
`_ZeroLayout`, `Zero1State`, `zero1_sgd`, `zero1_lars`, `zero2_sgd`,
`zero2_lars`, `zero2_oracle_flat`, `zero2_transport_bytes`; ZeRO-3 is
ROADMAP Queue A, A7).

The flat layout.  The gradient and parameter leaves, in the module's
``parameters()`` order and torch layouts (the port's ring flattens them
so too, `train.step`), concatenate into one fp32 vector of ``total``
elements.  It splits into buckets (`overlap.bucket_layout` at
``bucket_elems``; one whole-tree bucket by default, and always for
ZeRO-1); bucket b, ``m_b`` elements from global offset ``a_b``, is
zero-padded to ``W * c_b`` with ``c_b = ceil(m_b / W)`` (the ring's
chunk) and rank r owns its r-th chunk.  Rank r's shard is its chunks of
every bucket concatenated, ``S = sum(c_b)`` elements; its elements' SR
offsets are `_ZeroLayout.shard_offsets`, the pad taking the sentinel
``total`` (pad elements hold exact zeros, whose cast no rounding moves).

The updaters.  ``update_fn(grads, state, mesh, ...)`` updates the
module's parameters in place and returns the new `Zero1State`; it is
`train.step.make_train_step`'s ``update_fn``.  Each local rank of the
mesh (every rank on a `LocalMesh`, this process's on a `ProcessMesh`)
holds its (S,) momentum shard:

* ZeRO-1 is handed the step's reduced gradients, slices its shard, runs
  the rule on it, and the new parameter shards are all-gathered back
  into the module;
* ZeRO-2 is handed the LOCAL gradients (``reduce_in_update``, with the
  step's precision keywords) and reduce-scatters them per bucket
  (`_Zero2._bucket_reduce_scatter`): the APS pre-quantize, the (W, c_b)
  payload over `mesh.all_to_all` (packed eXmY code words after APS, the
  blocked wire with ``block_scale``, fp32 otherwise), the rank-ordered
  requantizing scan over the received (W, c_b) stack with the shard's
  global SR offsets (an offset ARRAY: the `sr_bits` kernel's
  offset-array arm on the card), and the APS unscale.  The scan is
  elementwise over the ranks in rank order, so a shard is bitwise the
  same slice of the replicated faithful `dist.sum_gradients`;
  `make_tap_reduce` runs the same reduce-scatter from inside the
  backward (`overlap.overlapped_grads`), so overlap on or off is
  bitwise the same.

The rules.  SGD is `train.optim.sgd`'s, op for op on the shard, so
ZeRO x SGD is bitwise the replicated step.  LARS needs each leaf's norm,
which no shard holds whole: each rank sums the squares of its pieces of
every leaf in float64 (`torch._foreach_norm` of each piece, squared),
`mesh.sum` adds the ranks' partial sums in rank order, and the trust
ratio of `train.optim.lars` runs per leaf, 0 in the pad.  The replicated
rule sums each leaf's squares in float64 too (`train.optim._norms`), so
the two fp32 norms differ only where the float64 sums straddle an fp32
rounding boundary: ZeRO x LARS agrees within the reference's tolerance
(1e-6 / 1e-7) at any width, where fp32 partial sums miss it by ~1e-5 of
a norm at ResNet-18's.

Checkpoints.  ``export_state`` gathers the shards into the PORTABLE
layout, one (total,) vector with every pad trimmed, which restores at
any world size through ``portable_template`` and ``import_state``.
`Zero1State` records its layout (``world``, 0 when portable, and the
buckets' element counts), so `train.checkpoint`'s ``restore(world=)``
re-flattens a state saved padded at one world for another.  The pad
holds exact zeros forever (zero gradients keep zero momentum), so the
trim is lossless.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..quant.numerics import (cast_body_blocked, pack_exmy,
                              pack_exmy_blocked, unpack_exmy,
                              unpack_exmy_blocked, wire_bytes,
                              wire_bytes_blocked)
from ..quant.prng import fold_in, split
from .aps import aps_max_exponents, aps_scale, aps_shift_factors, exp2_exact
from .dist import _concat, quantize_tree_sr
from .mesh import per_distinct
from .reduction import _use_kernel, quantized_sum
from .ring import pad_to_world, ring_chunk_size

__all__ = ["Zero1State", "zero1_sgd", "zero1_lars", "zero2_sgd",
           "zero2_lars", "zero2_oracle_flat", "zero2_transport_bytes"]


def _runs(ends: Sequence[int], lo: int, count: int, real_end: int,
          pad: int) -> list:
    """``(value index, length)`` runs over the positions ``lo ..
    lo + count - 1`` of a space cut at ``ends`` (position p takes the
    first j with p < ends[j]); positions at or past ``real_end`` take
    ``pad``."""
    out, p, stop = [], lo, lo + count
    while p < stop:
        if p >= real_end:
            out.append((pad, stop - p))
            break
        j = bisect.bisect_right(ends, p)
        e = min(ends[j], real_end, stop)
        out.append((j, e - p))
        p = e
    return out


@dataclasses.dataclass(frozen=True)
class _ZeroLayout:
    """The static flat layout of one updater over one list of leaves:
    ``meta[b] = (a_b, m_b, c_b)``, bucket b's global flat start, its
    element count and its per-rank chunk (module docstring)."""
    world: int
    total: int
    sizes: tuple
    starts: tuple
    buckets: tuple
    meta: tuple
    # (bucket, rank, device, leaves_only) -> the runs as device tensors
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     hash=False, repr=False)

    @property
    def shard_size(self) -> int:
        return sum(c for _, _, c in self.meta)

    @property
    def spans(self) -> tuple:
        """The buckets' element counts, which with the world fix the
        padded layout."""
        return tuple(m for _, m, _ in self.meta)

    def bucket_offsets(self, b: int, rank: Optional[int] = None,
                       device="cpu") -> torch.Tensor:
        """GLOBAL flat offset of each element of rank ``rank``'s (c_b,)
        chunk of bucket b (``rank`` None: of the whole (W * c_b,) padded
        bucket), int64 holding uint32 values; the world-size pad takes
        the sentinel ``total``."""
        a, m, c = self.meta[b]
        lo, n = (0, self.world * c) if rank is None else (rank * c, c)
        local = lo + torch.arange(n, dtype=torch.int64, device=device)
        return torch.where(local < m, a + local,
                           torch.full_like(local, self.total)) & 0xFFFFFFFF

    def shard_offsets(self, rank: int, device="cpu") -> torch.Tensor:
        """(S,) GLOBAL flat offset of each element of rank ``rank``'s
        shard: its buckets' chunk offsets (`bucket_offsets`) in bucket
        order."""
        if not self.meta:
            return torch.zeros((0,), dtype=torch.int64, device=device)
        return torch.cat([self.bucket_offsets(b, rank, device)
                          for b in range(len(self.meta))])

    def shard_runs(self, rank: int) -> list:
        """``(leaf index, length)`` runs along rank ``rank``'s shard, the
        pad as leaf ``len(sizes)``: one run per leaf piece, since a leaf
        lies in one bucket and a chunk is contiguous."""
        ends = [s + n for s, n in zip(self.starts, self.sizes)]
        out = []
        for a, m, c in self.meta:
            out += _runs(ends, a + rank * c, c, a + m, len(self.sizes))
        return out

    def bucket_runs(self, b: int, rank: int) -> list:
        """``(index within bucket b, length)`` runs along rank ``rank``'s
        (c_b,) chunk of the bucket, the pad as ``len(buckets[b])``."""
        _, m, c = self.meta[b]
        idxs = self.buckets[b]
        ends, off = [], 0
        for i in idxs:
            off += self.sizes[i]
            ends.append(off)
        return _runs(ends, rank * c, c, m, len(idxs))

    def run_tensors(self, rank: int, device, b: Optional[int] = None,
                    leaves_only: bool = False) -> tuple:
        """`shard_runs` (or bucket b's `bucket_runs`; ``leaves_only``:
        the shard's runs without the pad's) as ``(index, length)`` int64
        tensors on ``device``, made once: no host copy on the step's
        path."""
        key = (b, rank, str(device), leaves_only)
        hit = self._cache.get(key)
        if hit is None:
            runs = (self.shard_runs(rank) if b is None
                    else self.bucket_runs(b, rank))
            if leaves_only:
                runs = [(j, n) for j, n in runs if j < len(self.sizes)]
            hit = tuple(torch.tensor(col, dtype=torch.int64, device=device)
                        for col in ([j for j, _ in runs],
                                    [n for _, n in runs]))
            self._cache[key] = hit
        return hit


def _expand(values: torch.Tensor, runs: tuple, size: int) -> torch.Tensor:
    """A per-leaf value vector (the pad's value last) as one value per
    element along ``runs`` (`_ZeroLayout.run_tensors`)."""
    idx, lens = runs
    return values[idx].repeat_interleave(lens, output_size=size)


class Zero1State(NamedTuple):
    """A ZeRO updater's state: ``step`` (the updates applied),
    ``momentum`` (one (S,) fp32 shard per local rank of the mesh; in the
    portable layout one (total,) vector), ``world`` (the layout's world
    size, 0 for the portable layout) and ``spans`` (the buckets' element
    counts).  The momentum's world-size pad holds exact zeros forever:
    `pad_to_world` zero-fills it and the rules keep it (pad gradients
    are exact zeros, so ``m * 0 + 0 == 0``), which makes the portable
    trim and the elastic re-flatten lossless."""
    step: int
    momentum: list
    world: int
    spans: tuple


def _unshard(stacked: torch.Tensor, spans: Sequence[int],
             world: int) -> torch.Tensor:
    """The (total,) flat vector of a (W, S) stack of every rank's shard,
    rank-major: bucket b is the flattened (W, c_b) column block trimmed
    to m_b."""
    out, off = [], 0
    for m in spans:
        c = ring_chunk_size(m, world)
        out.append(stacked[:, off:off + c].reshape(-1)[:m])
        off += c
    if not out:
        return stacked.new_zeros((0,))
    return torch.cat(out)


def _shard_of(flat: torch.Tensor, spans: Sequence[int], world: int,
              rank: int) -> torch.Tensor:
    """Rank ``rank``'s (S,) shard of the (total,) flat vector: its chunk
    of each bucket's span padded to ``world * c_b``."""
    segs, a = [], 0
    for m in spans:
        c = ring_chunk_size(m, world)
        lo, hi = min(rank * c, m), min(rank * c + c, m)
        piece = flat[a + lo:a + hi]
        if hi - lo < c:
            piece = torch.cat([piece, piece.new_zeros((c - (hi - lo),))])
        segs.append(piece)
        a += m
    if not segs:
        return flat.new_zeros((0,))
    return torch.cat(segs)


def portable_momentum(z: Zero1State, mesh=None) -> torch.Tensor:
    """The (total,) portable momentum of ``z``: a portable state's own
    vector; else every rank's shard (gathered over ``mesh`` when it
    holds one rank of several) un-interleaved, the pads trimmed."""
    if z.world == 0:
        return z.momentum[0]
    if len(z.momentum) == z.world:
        stacked = torch.stack(list(z.momentum))
    else:
        if mesh is None or len(z.momentum) != len(mesh.ranks):
            raise ValueError(f"a ZeRO state holding {len(z.momentum)} of "
                             f"{z.world} shards needs its mesh to gather "
                             f"the rest")
        stacked = mesh.all_gather(list(z.momentum))[0]
    return _unshard(stacked, z.spans, z.world)


def shards_at(flat: torch.Tensor, spans: Sequence[int], world: int,
              ranks: Sequence[int]) -> list:
    """The (S,) shards of ranks ``ranks`` of a (total,) portable vector
    at ``world``."""
    return [_shard_of(flat, spans, world, r) for r in ranks]


class _Zero1:
    """ZeRO-1 torch-SGD: momentum sharded 1/W (module docstring)."""

    # the per-bucket cap of the flat layout (ZeRO-2 only; None: one
    # whole-tree bucket)
    bucket_elems: Optional[int] = None
    # ZeRO-2 alone consumes the reduce-scatter of the overlap taps
    supports_tap_reduce = False
    requires_reduce_in_update = False

    def __init__(self, schedule: Callable, world: int, momentum: float,
                 weight_decay: float, nesterov: bool,
                 wd_mask: Optional[Callable]):
        self.schedule = schedule
        self.world = int(world)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.wd_mask = wd_mask
        self._layouts: dict = {}

    # -- the flat layout ---------------------------------------------------
    def _layout(self, leaves: Sequence[torch.Tensor]) -> _ZeroLayout:
        """The layout over ``leaves``: one whole-tree bucket, or the
        shared capping function's buckets at ``bucket_elems``, chunked
        by the ring's quantum."""
        from .overlap import bucket_layout

        sizes = tuple(int(l.numel()) for l in leaves)
        lay = self._layouts.get(sizes)
        if lay is not None:
            return lay
        starts, off = [], 0
        for n in sizes:
            starts.append(off)
            off += n
        if self.bucket_elems is None:
            buckets = (tuple(range(len(sizes))),) if sizes else ()
        else:
            buckets = tuple(tuple(b) for b in
                            bucket_layout(sizes, self.bucket_elems))
        meta = []
        for b in buckets:
            m = sum(sizes[i] for i in b)
            meta.append((starts[b[0]], m, ring_chunk_size(m, self.world)))
        lay = _ZeroLayout(world=self.world, total=off, sizes=sizes,
                          starts=tuple(starts), buckets=buckets,
                          meta=tuple(meta))
        self._layouts[sizes] = lay
        return lay

    def _check_mesh(self, mesh) -> None:
        if mesh.world != self.world:
            raise ValueError(f"updater built for world {self.world}, the "
                             f"mesh has {mesh.world}")

    # -- the optimizer surface ---------------------------------------------
    def init(self, params: Sequence[torch.Tensor], mesh) -> Zero1State:
        """Step 0, a zero (S,) momentum shard for each local rank."""
        self._check_mesh(mesh)
        params = list(params)
        lay = self._layout(params)
        dev = params[0].device if params else mesh.device
        return Zero1State(0, [torch.zeros((lay.shard_size,),
                                          dtype=torch.float32, device=dev)
                              for _ in mesh.ranks], self.world, lay.spans)

    def step_kwargs(self) -> dict:
        """The `make_train_step` hooks of this updater: ``update_fn``,
        and ``reduce_in_update`` and ``tap_reduce`` for ZeRO-2."""
        kw = {"update_fn": self.update_fn}
        if self.requires_reduce_in_update:
            kw["reduce_in_update"] = True
        if self.supports_tap_reduce:
            kw["tap_reduce"] = self.make_tap_reduce
        return kw

    def _grad_shard(self, grads: list, params: list, mesh, lay: _ZeroLayout,
                    fused=None, **quant_kw) -> list:
        """Each local rank's (S,) gradient shard: ZeRO-1 slices the
        reduced gradients; ZeRO-2 overrides with its reduce-scatter."""
        if quant_kw:
            raise ValueError(
                "ZeRO-1 expects pre-reduced gradients; "
                "reduce_in_update=True is a ZeRO-2 (zero2_sgd) contract")
        # once per distinct set of leaves (a LocalMesh's ranks share one)
        flats = per_distinct(lambda *ls: _concat(ls),
                             *[[g[i] for g in grads]
                               for i in range(len(params))])
        return [_shard_of(f, lay.spans, self.world, r)
                for f, r in zip(flats, mesh.ranks)]

    @torch.no_grad()
    def update_fn(self, grads: Sequence, state, mesh, *,
                  pre_sharded: bool = False, fused: Optional[bool] = None,
                  **quant_kw) -> Zero1State:
        """One update.  ``grads``: one entry per local rank of ``mesh``:
        its reduced gradient leaves (ZeRO-1), its LOCAL leaves with the
        step's precision keywords in ``quant_kw`` (ZeRO-2,
        ``reduce_in_update``), or with ``pre_sharded`` its (S,) shard
        already reduce-scattered by the overlap taps.  The module's
        parameters are updated in place; returns the new state."""
        if self.requires_reduce_in_update and not (quant_kw or pre_sharded):
            raise ValueError(
                "this ZeRO stage folds the collective into the update: "
                "build the step with make_train_step(..., "
                "reduce_in_update=True) — without it the step pre-reduces "
                "and the sharded reduce-scatter would double-count by W")
        self._check_mesh(mesh)
        params = state.params
        opt: Zero1State = state.opt_state
        lay = self._layout(params)
        if opt.world != self.world or len(opt.momentum) != len(mesh.ranks):
            raise ValueError(f"optimizer state holds {len(opt.momentum)} "
                             f"shards of world {opt.world}; this step runs "
                             f"{len(mesh.ranks)} local ranks of world "
                             f"{self.world} (import_state a portable "
                             f"state first)")
        lr = self.schedule(opt.step)
        if pre_sharded:
            g_sh = [torch.as_tensor(g, dtype=torch.float32) for g in grads]
            for g in g_sh:
                if tuple(g.shape) != (lay.shard_size,):
                    raise ValueError(
                        f"pre_sharded gradients have shape "
                        f"{tuple(g.shape)}, expected ({lay.shard_size},) — "
                        f"the tap plan's bucket layout must come from "
                        f"this updater (make_tap_reduce)")
        else:
            g_sh = self._grad_shard(list(grads), params, mesh, lay,
                                    fused=fused, **quant_kw)
        flat_p = _concat(params)
        p_sh = [_shard_of(flat_p, lay.spans, self.world, r)
                for r in mesh.ranks]
        new_p = self._shard_update(g_sh, p_sh, params, mesh, lay,
                                   opt.momentum, lr)
        full = mesh.all_gather(new_p)[0]
        flat = _unshard(full, lay.spans, self.world)
        off = 0
        for p in params:
            p.copy_(flat[off:off + p.numel()].reshape(p.shape))
            off += p.numel()
        return Zero1State(opt.step + 1, opt.momentum, self.world, lay.spans)

    def _shard_update(self, g_sh: list, p_sh: list, params: list, mesh,
                      lay: _ZeroLayout, bufs: list, lr) -> list:
        """The rule on each local rank's flat shard (its momentum shard
        updated in place); returns the new parameter shards.  The
        default is `train.optim.sgd`'s, op for op."""
        from ..train.optim import _mask

        mask = _mask(self.wd_mask, params) if self.weight_decay else []
        out = []
        for g, p, buf, r in zip(g_sh, p_sh, bufs, mesh.ranks):
            d = g
            if self.weight_decay:
                decayed = p * self.weight_decay + g
                if all(mask):
                    d = decayed
                else:
                    vals = torch.tensor([float(m) for m in mask] + [0.0],
                                        device=g.device)
                    keep = _expand(vals, lay.run_tensors(r, g.device),
                                   g.numel()) > 0
                    d = torch.where(keep, decayed, g)
            buf.mul_(self.momentum).add_(d)
            if self.nesterov:
                direction = buf * self.momentum + d
                out.append(p + direction * (-lr))
            else:
                out.append(p + buf * (-lr))
        return out

    # -- portable checkpoints ----------------------------------------------
    def export_state(self, state, mesh=None):
        """``state`` with its momentum in the PORTABLE layout: every
        rank's shard gathered (over ``mesh`` on a `ProcessMesh`), the
        pads trimmed, one (total,) vector on every rank; it restores at
        any world size."""
        opt: Zero1State = state.opt_state
        mom = portable_momentum(opt, mesh)
        return dataclasses.replace(state, opt_state=Zero1State(
            opt.step, [mom], 0, opt.spans))

    def portable_template(self, state):
        """The restore template in the portable layout (for
        `CheckpointManager.restore`, before `import_state`)."""
        params = state.params
        lay = self._layout(params)
        dev = params[0].device if params else "cpu"
        return dataclasses.replace(state, opt_state=Zero1State(
            0, [torch.zeros((lay.total,), dtype=torch.float32, device=dev)],
            0, lay.spans))

    def import_state(self, state, mesh):
        """The portable layout -> this updater's (S,) shard of each
        local rank of ``mesh`` (the bucketed inverse of
        `export_state`)."""
        self._check_mesh(mesh)
        opt: Zero1State = state.opt_state
        lay = self._layout(state.params)
        if opt.world != 0:
            raise ValueError("import_state takes the portable layout "
                             "(export_state / portable_template)")
        if tuple(opt.spans) != lay.spans:
            raise ValueError(f"portable state's buckets {tuple(opt.spans)} "
                             f"do not match this updater's {lay.spans}")
        mom = opt.momentum[0]
        return dataclasses.replace(state, opt_state=Zero1State(
            opt.step, shards_at(mom, lay.spans, self.world, mesh.ranks),
            self.world, lay.spans))


def zero1_sgd(schedule: Callable, world: int, momentum: float = 0.9,
              weight_decay: float = 0.0, nesterov: bool = False,
              wd_mask: Optional[Callable] = None) -> _Zero1:
    """ZeRO-1 torch-SGD: momentum sharded 1/``world``."""
    return _Zero1(schedule, world, momentum, weight_decay, nesterov,
                  wd_mask)


class _Zero2(_Zero1):
    """ZeRO-2: the faithful quantized reduce sharded as well (module
    docstring).  The step hands `update_fn` the rank-LOCAL gradients
    (``reduce_in_update``) with its own precision keywords, so the
    emulate-node cast and the reduce cannot drift apart.  With
    ``bucket_elems`` each bucket reduce-scatters on its own, which is
    what lets `make_tap_reduce` run it inside the backward."""

    requires_reduce_in_update = True
    supports_tap_reduce = True

    def __init__(self, schedule, world, momentum, weight_decay, nesterov,
                 wd_mask, bucket_elems: Optional[int] = None):
        super().__init__(schedule, world, momentum, weight_decay, nesterov,
                         wd_mask)
        if bucket_elems is not None and bucket_elems < 1:
            raise ValueError(f"bucket_elems must be >= 1, got "
                             f"{bucket_elems}")
        self.bucket_elems = bucket_elems

    @staticmethod
    def _validate_precision(mode, rounding, key, block_scale, block_size,
                            grad_exp, grad_man):
        """The one precision-contract check of the sharded reduce, for the
        post-backward `_grad_shard` and the overlap hook
        `make_tap_reduce` alike."""
        if mode != "faithful":
            raise ValueError(
                f"ZeRO-2 shards the faithful ordered reduction; mode="
                f"{mode!r} is not supported here (the fast psum path "
                f"keeps the full gradient resident anyway, and the ring "
                f"transport's per-chunk rotation order is a different "
                f"reduction semantics from the rank-order slices ZeRO-2 "
                f"reproduces)")
        if rounding == "stochastic" and key is None:
            raise ValueError("rounding='stochastic' requires a PRNG key")
        if rounding == "nearest" and key is not None:
            raise ValueError("a PRNG key was passed but rounding='nearest' "
                             "would ignore it (sum_gradients' contract)")
        if block_scale:
            if grad_exp == 8 and grad_man == 23:
                raise ValueError(
                    "block_scale=True at (8, 23): the fp32 wire has "
                    "nothing to scale — drop block_scale or pick a "
                    "sub-fp32 format")
            if grad_man < 2:
                raise ValueError(
                    f"block_scale=True needs a packable format (man_bits "
                    f">= 2 for the codec's special codes), got "
                    f"({grad_exp}, {grad_man})")
            if block_size < 1:
                raise ValueError(f"block_size must be >= 1, got "
                                 f"{block_size}")

    def _bucket_reduce_scatter(self, lay: _ZeroLayout, b: int,
                               leaves_b: list, mesh, *, use_aps: bool,
                               grad_exp: int, grad_man: int,
                               use_kahan: bool, key, block_scale=False,
                               block_size=128, fused=None) -> list:
        """Bucket b's (c_b,) reduce-scattered shard of each local rank
        (``leaves_b``: each local rank's leaves of the bucket): the one
        body the post-backward monolith and the overlap taps share
        (module docstring).  The key splits as `dist.sum_gradients`'s:
        the pre-quantize's ``k_pre`` with the rank folded in, the scan's
        shared ``k_sum``."""
        c = lay.meta[b][2]
        idxs = lay.buckets[b]
        w = self.world
        kernel = _use_kernel(leaves_b[0][0], fused)
        dev = leaves_b[0][0].device
        k_sum = None
        k_pre = [None] * len(leaves_b)
        if key is not None:
            k_pre_all, k_sum, _ = split(key, 3)
            k_pre = [fold_in(k_pre_all, r) for r in mesh.ranks]
        g = [[l.to(torch.float32) for l in ls] for ls in leaves_b]
        shifts = [None] * len(g)
        if use_aps:
            max_exp = mesh.max([aps_max_exponents(gs, w) for gs in g])
            shifts = per_distinct(lambda e: aps_shift_factors(e, grad_exp),
                                  max_exp)
            g = [aps_scale(gs, s) for gs, s in zip(g, shifts)]
            if not block_scale:
                starts = [lay.starts[i] for i in idxs]
                g = [quantize_tree_sr(gs, grad_exp, grad_man, k, starts,
                                      fused=kernel)
                     for gs, k in zip(g, k_pre)]
        payloads = [pad_to_world(_concat(gs), w).reshape(w, c) for gs in g]
        if block_scale:
            if key is not None:
                # the blocked SR pre-quantize, its bits at the payload's
                # global offsets (the pad at the sentinel)
                offs = lay.bucket_offsets(b, device=dev)
                payloads = [cast_body_blocked(
                    p, grad_exp, grad_man, block_size,
                    _sr_bits(kernel)(k, p, offsets=offs).reshape(w, c))
                    for p, k in zip(payloads, k_pre)]
            wires = [pack_exmy_blocked(p, grad_exp, grad_man, block_size)
                     for p in payloads]
            stacked = per_distinct(
                lambda s: unpack_exmy_blocked(s, grad_exp, grad_man, c,
                                              block_size),
                mesh.all_to_all(wires))
        else:
            # after APS the values are in the format's set: the packed
            # code words carry them losslessly, narrower than fp32
            packed = (use_aps and grad_man >= 2
                      and wire_bytes(grad_exp, grad_man) < 4)
            if packed:
                payloads = [pack_exmy(p, grad_exp, grad_man)
                            for p in payloads]
            stacked = mesh.all_to_all(payloads)
            if packed:
                stacked = per_distinct(
                    lambda s: unpack_exmy(s, grad_exp, grad_man), stacked)
        # row j of rank r's stack: rank j's slice of r's chunk, in rank
        # order: the gather side of a reduce-scatter
        out = []
        for st, r, s in zip(stacked, mesh.ranks, shifts):
            offs = (None if k_sum is None
                    else lay.bucket_offsets(b, r, dev))
            red = quantized_sum(st, grad_exp, grad_man, use_kahan,
                                key=k_sum, offsets=offs,
                                block_size=block_size if block_scale
                                else None, fused=kernel)
            if use_aps:
                # a true divide (aps_unscale), the pad at 2^0
                p2 = exp2_exact(torch.cat([s, s.new_zeros((1,))]))
                red = red / _expand(p2, lay.run_tensors(r, dev, b), c)
            out.append(red)
        return out

    def _grad_shard(self, grads: list, params: list, mesh, lay: _ZeroLayout,
                    fused=None, use_aps: bool = False, grad_exp: int = 8,
                    grad_man: int = 23, use_kahan: bool = False,
                    mode: str = "faithful", rounding: str = "nearest",
                    key=None, block_scale: bool = False,
                    block_size: int = 128) -> list:
        """Each local rank's (S,) slice of the faithful quantized
        gradient sum: the buckets' reduce-scatters concatenated in
        bucket order."""
        self._validate_precision(mode, rounding, key, block_scale,
                                 block_size, grad_exp, grad_man)
        per_bucket = [self._bucket_reduce_scatter(
            lay, b, [[ls[i] for i in idxs] for ls in grads], mesh,
            use_aps=use_aps, grad_exp=grad_exp, grad_man=grad_man,
            use_kahan=use_kahan, key=key, block_scale=block_scale,
            block_size=block_size, fused=fused)
            for b, idxs in enumerate(lay.buckets)]
        return [torch.cat([pb[li] for pb in per_bucket]) if per_bucket
                else torch.zeros((0,), dtype=torch.float32)
                for li in range(len(grads))]

    def make_tap_reduce(self, params: Sequence[torch.Tensor], mesh,
                        quant_kw: dict) -> tuple:
        """The ZeRO-2 overlap hook: ``(plan, collective)`` for
        `overlap.overlapped_grads`.  ``plan`` is the `BucketPlan` of this
        updater's layout, and ``collective(b, idxs, per_rank_leaves,
        key)`` bucket b's `_bucket_reduce_scatter`: each local rank's
        (c_b,) shard, which the step concatenates in bucket order for
        ``update_fn(..., pre_sharded=True)``."""
        from .overlap import BucketPlan

        params = list(params)
        lay = self._layout(params)
        sr = quant_kw.get("rounding", "nearest") == "stochastic"
        self._validate_precision(
            quant_kw.get("mode", "faithful"),
            quant_kw.get("rounding", "nearest"),
            # the key is drawn per step; the static contract only
            object() if sr else None,
            quant_kw.get("block_scale", False),
            quant_kw.get("block_size", 128),
            quant_kw.get("grad_exp", 8), quant_kw.get("grad_man", 23))
        prec = dict(use_aps=quant_kw.get("use_aps", False),
                    grad_exp=quant_kw.get("grad_exp", 8),
                    grad_man=quant_kw.get("grad_man", 23),
                    use_kahan=quant_kw.get("use_kahan", False),
                    block_scale=quant_kw.get("block_scale", False),
                    block_size=quant_kw.get("block_size", 128),
                    fused=quant_kw.get("fused"))
        plan = BucketPlan(sizes=lay.sizes, starts=lay.starts,
                          buckets=lay.buckets,
                          bucket_elems=(self.bucket_elems
                                        if self.bucket_elems is not None
                                        else max(lay.total, 1)))

        def collective(b, idxs, per_rank, key):
            return self._bucket_reduce_scatter(lay, b, per_rank, mesh,
                                               key=key, **prec)

        return plan, collective


def _sr_bits(kernel: bool):
    from ..ops.quantize import sr_bits, sr_bits_ref

    return sr_bits if kernel else sr_bits_ref


def zero2_sgd(schedule: Callable, world: int, momentum: float = 0.9,
              weight_decay: float = 0.0, nesterov: bool = False,
              wd_mask: Optional[Callable] = None,
              bucket_elems: Optional[int] = None) -> _Zero2:
    """ZeRO-2 torch-SGD: momentum AND the faithful quantized reduce
    sharded 1/``world``; pair with ``make_train_step(...,
    **z.step_kwargs())`` (``reduce_in_update``).  ``bucket_elems`` opts
    into the per-bucket layout (the overlap taps' boundaries)."""
    return _Zero2(schedule, world, momentum, weight_decay, nesterov,
                  wd_mask, bucket_elems)


class _LarsRule:
    """The reference's LARS on the flat shard (module docstring): the
    per-leaf norms from the ranks' partial sums of squares, the trust
    ratio on the UN-decayed gradient norm, the rate folded into the
    buffer, no Nesterov, no mask; the pad's rate forced to 0."""

    coefficient = 0.001

    def _shard_update(self, g_sh: list, p_sh: list, params: list, mesh,
                      lay: _ZeroLayout, bufs: list, lr) -> list:
        n = len(params)
        dev = g_sh[0].device

        def partial_sq(x: torch.Tensor, r: int) -> torch.Tensor:
            # one piece a leaf: its squares' sum in float64, as
            # `train.optim._norms` sums a whole leaf
            pieces, pos = [], 0
            for j, length in lay.shard_runs(r):
                if j < n:
                    pieces.append(x[pos:pos + length])
                pos += length
            sq = torch.zeros((n + 1,), dtype=torch.float64, device=dev)
            if pieces:
                norms = torch.stack(torch._foreach_norm(
                    pieces, 2, dtype=torch.float64))
                sq[lay.run_tensors(r, dev, leaves_only=True)[0]] = (
                    norms * norms)
            return sq

        w_sq = mesh.sum([partial_sq(p, r) for p, r in zip(p_sh, mesh.ranks)])
        g_sq = mesh.sum([partial_sq(g, r) for g, r in zip(g_sh, mesh.ranks)])
        wd = self.weight_decay
        out = []
        for g, p, buf, r, ws, gs in zip(g_sh, p_sh, bufs, mesh.ranks, w_sq,
                                         g_sq):
            # each norm rounded to fp32 once, as the replicated rule's
            w_norm = torch.sqrt(ws).to(torch.float32)
            g_norm = torch.sqrt(gs).to(torch.float32)
            local_lr = w_norm / (g_norm + wd * w_norm) * self.coefficient
            rate = lr * local_lr
            rate[n] = 0.0              # the pad (0 / 0 otherwise)
            d = p * wd + g
            buf.mul_(self.momentum).add_(
                d * _expand(rate, lay.run_tensors(r, dev), g.numel()))
            out.append(p - buf)
        return out


class _Zero1Lars(_LarsRule, _Zero1):
    pass


class _Zero2Lars(_LarsRule, _Zero2):
    pass


def zero1_lars(schedule: Callable, world: int, momentum: float = 0.9,
               weight_decay: float = 0.0,
               coefficient: float = 0.001) -> _Zero1Lars:
    """ZeRO-1 LARS: momentum sharded 1/``world``, per-leaf trust ratios
    from the shards' partial norms (`_LarsRule`)."""
    z = _Zero1Lars(schedule, world, momentum, weight_decay, False, None)
    z.coefficient = coefficient
    return z


def zero2_lars(schedule: Callable, world: int, momentum: float = 0.9,
               weight_decay: float = 0.0, coefficient: float = 0.001,
               bucket_elems: Optional[int] = None) -> _Zero2Lars:
    """ZeRO-2 LARS: momentum and the faithful reduce sharded; pair with
    ``make_train_step(..., **z.step_kwargs())``.  ``bucket_elems`` as
    on `zero2_sgd`."""
    z = _Zero2Lars(schedule, world, momentum, weight_decay, False, None,
                   bucket_elems)
    z.coefficient = coefficient
    return z


def zero2_oracle_flat(stacked: Sequence[torch.Tensor], world: int, *,
                      use_aps: bool = False, grad_exp: int = 8,
                      grad_man: int = 23, use_kahan: bool = False,
                      key=None, block_scale: bool = False,
                      block_size: int = 128,
                      bucket_elems: Optional[int] = None) -> torch.Tensor:
    """Single-device oracle of ZeRO-2's sharded reduce, in plain torch
    ops: from the STACKED per-rank local gradients (leaves ``(W,
    *leaf)``), every rank's `_Zero2._grad_shard` output concatenated in
    rank order, ``(W * S,)``.  Everything but the all-to-all is the
    updater's own arithmetic (the APS shifts, the per-tensor and blocked
    pre-quantizers with the codec's lossless round trip, the ordered
    scan with global-offset SR bits, the unscale)."""
    z = _Zero2(lambda s: 0.0, world, 0.9, 0.0, False, None, bucket_elems)
    z._validate_precision("faithful",
                          "stochastic" if key is not None else "nearest",
                          key, block_scale, block_size, grad_exp, grad_man)
    leaves = [l.to(torch.float32) for l in stacked]
    dev = leaves[0].device
    lay = z._layout([l[0] for l in leaves])
    k_pre = k_sum = None
    if key is not None:
        k_pre, k_sum, _ = split(key, 3)
    per_rank = []
    for r in range(world):
        segs = []
        for b, idxs in enumerate(lay.buckets):
            c = lay.meta[b][2]
            shifts = None
            if use_aps:
                shifts = aps_shift_factors(aps_max_exponents(
                    [leaves[i] for i in idxs], world), grad_exp)
            rows_r = []
            for j in range(world):
                g_j = [leaves[i][j] for i in idxs]
                k_j = None if k_pre is None else fold_in(k_pre, j)
                if use_aps:
                    g_j = aps_scale(g_j, shifts)
                    if not block_scale:
                        g_j = quantize_tree_sr(
                            g_j, grad_exp, grad_man, k_j,
                            [lay.starts[i] for i in idxs], fused=False)
                rows = pad_to_world(_concat(g_j), world).reshape(world, c)
                if block_scale:
                    rbits = None
                    if k_j is not None:
                        rbits = _sr_bits(False)(
                            k_j, rows, offsets=lay.bucket_offsets(
                                b, device=dev)).reshape(world, c)
                    rows = cast_body_blocked(rows, grad_exp, grad_man,
                                             block_size, rbits)
                rows_r.append(rows[r])
            offs = (None if k_sum is None
                    else lay.bucket_offsets(b, r, dev))
            red = quantized_sum(torch.stack(rows_r), grad_exp, grad_man,
                                use_kahan, key=k_sum, offsets=offs,
                                block_size=block_size if block_scale
                                else None, fused=False)
            if use_aps:
                p2 = exp2_exact(torch.cat([shifts, shifts.new_zeros((1,))]))
                red = red / _expand(p2, lay.run_tensors(r, red.device, b),
                                    c)
            segs.append(red)
        per_rank.append(torch.cat(segs) if segs
                        else torch.zeros((0,), dtype=torch.float32))
    return torch.cat(per_rank)


def zero2_transport_bytes(n: int, world: int, exp: int, man: int, *,
                          use_aps: bool = True,
                          block_size: Optional[int] = None) -> int:
    """Per-rank wire bytes of ZeRO-2's sharded reduce of ONE ``n``-element
    bucket: the all-to-all ships the (W, c) payload (c =
    ``ring_chunk_size(n, world)``) and keeps its own row, so (W - 1) rows
    leave each rank, each the packed code words after APS, the blocked
    wire (sidecar counted) with ``block_size``, fp32 otherwise.  A
    bucketed layout prices as the sum over its buckets' ``m_b``."""
    if n == 0 or world <= 0:
        return 0
    c = ring_chunk_size(n, world)
    if block_size is not None:
        per_shard = wire_bytes_blocked(exp, man, c, block_size)
    elif use_aps and man >= 2 and wire_bytes(exp, man) < 4:
        per_shard = c * wire_bytes(exp, man)
    else:
        per_shard = c * 4
    return (world - 1) * per_shard
