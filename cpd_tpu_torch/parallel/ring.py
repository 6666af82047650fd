"""Ring-transport quantized all-reduce (port of `cpd_tpu/parallel/ring.py`:
per-tensor casts, RTNE or stochastic rounding, plain or Kahan hops,
clean transport).

A reduce-scatter ring followed by an all-gather, moving eXmY partials
bit-packed (`pack_exmy`) instead of fp32.  The semantics are the JAX
module's documented per-chunk rank rotation: the flat vector is
zero-padded to ``W * chunk`` and split into W chunks; chunk c's partial
starts on rank (c + 1) mod W as ``q(g_{c+1}[c])`` and hops rightward,
each hop folding in the host rank's chunk:

    hop t (t = 1..W-1): rank (c + 1 + t) mod W applies
        res = q(res + g_{(c + 1 + t) mod W}[c])               (site 0)
        or the Kahan step: y = q(g - comp); tmp = q(res + y);
        comp = q(q(tmp - res) - y); res = tmp                  (sites 0-3)

so rank r's partial after hop t belongs to chunk ``(r - 1 - t) mod W``
and rank r ends owning chunk r.  With a key, every cast draws its SR
bits by (key, hop t, site, GLOBAL flat offset), the offset of element i
of chunk c being ``offset_start + c * chunk + i``, so the bits do not
depend on which rank casts.  A Kahan hop ships
``stack([res, comp])``; the all-gather ships the result only.
`ring_oracle_sum` reproduces every arm bit for bit on one device.

Arms of `ring_quantized_sum`, as in the JAX module:

* plain — the hop is torch ops: unpack, add, cast, pack (fp32 payloads
  when the format cannot pack);
* fused with the packed wire (no Kahan) — hop 0 is one launch of K6
  (`ops.quantize.quantize_pack`: cast + pack) and every later hop one
  launch of K5 (`hop_pack`: unpack + add + cast + pack); with SR each
  also takes the hop's bits from one `sr_bits` launch;
* fused with an unpacked wire (man < 2) — hop 0 is one launch of K1, or
  `sr_bits` + K2, and every later hop one launch of K3, or `sr_bits` +
  K4;
* Kahan on the card — each of a hop's four casts is K3, or `sr_bits` +
  K4 (`reduction.cast_site`); the wire is packed with torch ops.  The
  JAX ring turns its fused kernels off under Kahan too.

Hop 0 casts the chunk itself, not ``0 + chunk``: the JAX hop writes
``q(zeros + g)``, which XLA folds to ``q(g)``, and its K6 kernel casts
``g``; the two differ from an IEEE ``0 + g`` only where every rank holds
-0.0, which then survives as -0.0.  A Kahan hop 0 is the full four-site
step from zero partials.

``fused=None`` means fused exactly when the tensors are on CUDA (the JAX
default is "on the TPU"); ``fused=True`` on CPU tensors raises.  The
gather ships each rank's final wire as it is: a packed wire is
canonical, so re-packing its decode would give the same bytes.

The hop logic is rank-local (`_Ring.first_hop`, `_Ring.next_hop`); the mesh only
moves wires (`parallel/mesh.py`), so a multi-card mesh can reuse it.
The block-scaled wire, the verified transport and fault injection are
not ported yet and raise.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.quantize import hop_pack, quantize_pack, sr_bits
from ..quant.numerics import pack_exmy, unpack_exmy
from ..quant.prng import site_key
from .mesh import per_distinct
from .reduction import _make_q, _use_kernel, kahan_step

__all__ = ["ring_chunk_size", "pad_to_world", "ring_quantized_sum",
           "hierarchical_ring_sum", "ring_oracle_sum"]

_U32 = 0xFFFFFFFF


def ring_chunk_size(n: int, world: int) -> int:
    """Elements per ring chunk: ceil(n / world)."""
    return math.ceil(n / world) if n else 0


def pad_to_world(flat: torch.Tensor, world: int) -> torch.Tensor:
    """Zero-pad a flat (n,) vector to world * ring_chunk_size(n, world).
    Exact zeros are rounding-invariant, so the pad never perturbs the
    reduction (and is sliced off before returning)."""
    n = flat.shape[0]
    return F.pad(flat, (0, world * ring_chunk_size(n, world) - n))


def check_unported(*, block_scale=False, verify=False, fault=None) -> None:
    """Raise for every option of the JAX reduce that the port lacks."""
    if block_scale:
        raise NotImplementedError(
            "the block-scaled wire is not ported yet (ROADMAP Queue A, A5; "
            "Queue B, B3)")
    if verify:
        raise NotImplementedError(
            "the verified transport is not ported yet (ROADMAP Queue A, A5; "
            "Queue B, B4)")
    if fault is not None:
        raise NotImplementedError(
            "wire fault injection is not ported yet (ROADMAP Queue A, A5/A10)")


class _Ring:
    """One ring all-reduce's static layout, hop arm and cast sites."""

    def __init__(self, world: int, n: int, exp: int, man: int, packed: bool,
                 fused: bool, use_kahan: bool, key, offset_start: int):
        self.world, self.exp, self.man = world, exp, man
        self.chunk = ring_chunk_size(n, world)
        self.kahan, self.key = use_kahan, key
        self.shortcut = exp == 8 and man == 23 and not use_kahan
        # the codec needs man >= 2 for its special codes, and 4-byte
        # words at (8, 23) save nothing
        self.packed = (packed and man >= 2
                       and not (exp == 8 and man == 23))
        self.fused = fused and not self.shortcut
        self.fused_wire = self.fused and self.packed and not use_kahan
        self.offset_start = offset_start

    def chunk_at(self, rank: int, t: int) -> int:
        """Chunk the partial of ``rank`` holds after hop t."""
        return (rank - 1 - t) % self.world

    def local(self, padded: torch.Tensor, c: int) -> torch.Tensor:
        return padded[c * self.chunk:(c + 1) * self.chunk]

    def offset(self, c: int) -> int:
        """The SR offset of chunk c's first element."""
        return (self.offset_start + c * self.chunk) & _U32

    def q(self, c: int):
        """Chunk c's quantizer ``q(x, y, t, site)`` (`reduction._make_q`)."""
        return _make_q(self.exp, self.man, self.key, self.fused,
                       self.offset(c))

    def rbits(self, t: int, c: int, g: torch.Tensor):
        """Hop t's SR bits for chunk c (site 0), for the wire kernels."""
        if self.key is None:
            return None
        return sr_bits(site_key(self.key, t, 0), g,
                       offset_start=self.offset(c))

    def to_wire(self, res: torch.Tensor, comp=None) -> torch.Tensor:
        payload = res if comp is None else torch.stack([res, comp])
        return pack_exmy(payload, self.exp, self.man) if self.packed \
            else payload

    def from_wire(self, wire: torch.Tensor) -> torch.Tensor:
        return unpack_exmy(wire, self.exp, self.man) if self.packed else wire

    def first_hop(self, rank: int, padded: torch.Tensor) -> torch.Tensor:
        """Rank ``rank``'s hop 0: its wire for hop 1."""
        c = self.chunk_at(rank, 0)
        g = self.local(padded, c)
        if self.kahan:
            zero = torch.zeros_like(g)
            return self.to_wire(*kahan_step(self.q(c), zero, zero, g, 0))
        if self.fused_wire:
            return quantize_pack(g, self.exp, self.man,
                                 rbits=self.rbits(0, c, g))[1]
        if self.shortcut:
            return g
        return self.to_wire(self.q(c)(g, None, 0, 0))

    def next_hop(self, rank: int, t: int, recv: torch.Tensor,
                 padded: torch.Tensor) -> torch.Tensor:
        """Rank ``rank``'s hop t >= 1 on the wire received from rank - 1."""
        c = self.chunk_at(rank, t)
        g = self.local(padded, c)
        if self.kahan:
            res, comp = self.from_wire(recv)
            return self.to_wire(*kahan_step(self.q(c), res, comp, g, t))
        if self.fused_wire:
            return hop_pack(recv, g, self.exp, self.man,
                            rbits=self.rbits(t, c, g))[1]
        if self.shortcut:
            return recv + g
        return self.to_wire(self.q(c)(self.from_wire(recv), g, t, 0))

    def gather_wire(self, wire: torch.Tensor) -> torch.Tensor:
        """The wire a rank ships in the all-gather: its final partial
        (a Kahan wire drops the compensation)."""
        return self.to_wire(self.from_wire(wire)[0]) if self.kahan else wire


def ring_quantized_sum(flats: Sequence[torch.Tensor], mesh, exp: int,
                       man: int, *, packed: bool = True,
                       fused: Optional[bool] = None, use_kahan: bool = False,
                       key=None, offset_start: int = 0,
                       block_scale: bool = False, verify: bool = False,
                       fault=None) -> list:
    """Ordered quantized SUM over ``mesh``'s ranks via the ring.

    ``flats`` holds one (n,) fp32 contribution per local rank of
    ``mesh`` (``mesh.ranks``); returns the reduced (n,) vector for each,
    every partial re-quantized to (exp, man) in the documented per-chunk
    rank rotation (`ring_oracle_sum` reproduces it bit for bit).
    ``packed`` ships the wire as eXmY code words (off automatically for
    man < 2 and at (8, 23), where the hop without Kahan is a plain fp32
    add).  ``use_kahan`` compensates every hop; ``key`` (a `prng` key)
    rounds every cast stochastically, ``offset_start`` being the global
    offset of ``flats[i][0]`` in the SR bit-index space.  (The JAX
    ``offsets`` vector, for a bucket of non-adjacent leaves, is not
    ported: the port's buckets are runs of whole leaves.)"""
    check_unported(block_scale=block_scale, verify=verify, fault=fault)
    if len(flats) != len(mesh.ranks):
        raise ValueError(f"expected one vector per local rank "
                         f"({len(mesh.ranks)}), got {len(flats)}")
    flats = [f.to(torch.float32) for f in flats]
    n = flats[0].shape[0]
    ring = _Ring(mesh.world, n, exp, man, packed,
                 _use_kernel(flats[0], fused), use_kahan, key, offset_start)
    if n == 0:
        return flats
    padded = [pad_to_world(f, mesh.world) for f in flats]
    wires = [ring.first_hop(r, p) for r, p in zip(mesh.ranks, padded)]
    for t in range(1, mesh.world):
        recv = mesh.ring_shift(wires)
        wires = [ring.next_hop(r, t, w, p)
                 for r, w, p in zip(mesh.ranks, recv, padded)]
    # rank r's wire now holds the reduced chunk r; the all-gather
    # rebuilds the full vector on every rank
    gathered = mesh.all_gather([ring.gather_wire(w) for w in wires])
    return per_distinct(lambda g: ring.from_wire(g).reshape(-1)[:n],
                        gathered)


def hierarchical_ring_sum(flats: Sequence[torch.Tensor], mesh, exp: int,
                          man: int, **kw) -> list:
    """The ring over the mesh's axes.  A `LocalMesh` has one axis, where
    this is exactly `ring_quantized_sum`; the multi-axis composition
    (innermost axis first) waits for a multi-card mesh."""
    return ring_quantized_sum(flats, mesh, exp, man, **kw)


def ring_oracle_sum(stacked: torch.Tensor, exp: int, man: int, *,
                    use_kahan: bool = False, key=None,
                    offset_start: int = 0) -> torch.Tensor:
    """Single-device oracle of `ring_quantized_sum`: from the stacked
    per-rank contributions (W, *shape), the same per-chunk rank rotation
    and per-hop casts with their (hop, site, global offset) SR bits, in
    plain torch ops — everything except the wire.  The casts run on the
    (W, chunk) block of all chunks at once, whose element (c, i) draws
    offset ``offset_start + c * chunk + i``, as on the ring."""
    w = stacked.shape[0]
    shape = stacked.shape[1:]
    n = stacked[0].numel()
    if n == 0:
        return torch.zeros(shape, dtype=torch.float32, device=stacked.device)
    chunk = ring_chunk_size(n, w)
    flat = stacked.reshape(w, n).to(torch.float32)
    per_chunk = F.pad(flat, (0, w * chunk - n)).reshape(w, w, chunk)
    c_idx = torch.arange(w, device=stacked.device)
    q = _make_q(exp, man, key, False, offset_start)
    shortcut = exp == 8 and man == 23 and not use_kahan
    res = comp = None
    for t in range(w):
        # the contribution visiting chunk c at hop t is rank (c + 1 + t)'s
        g = per_chunk[(c_idx + 1 + t) % w, c_idx]
        if use_kahan:
            if res is None:
                res = comp = torch.zeros_like(g)
            res, comp = kahan_step(q, res, comp, g, t)
        elif shortcut:
            res = g if res is None else res + g
        else:
            res = q(g, None, 0, 0) if res is None else q(res, g, t, 0)
    return res.reshape(-1)[:n].reshape(shape)
