"""Ring-transport quantized all-reduce (port of `cpd_tpu/parallel/ring.py`:
per-tensor or block-scaled casts, RTNE or stochastic rounding, plain or
Kahan hops, clean, verified or fault-injected transport).

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
of chunk c being ``offset_start + c * chunk + i`` (or, with an explicit
``offsets`` array, its zero-padded entry ``c * chunk + i``, the JAX
``offsets`` vector: on the card the `sr_bits` kernel's offset-array
arm), so the bits do not depend on which rank casts.  A Kahan hop ships
``stack([res, comp])``; the all-gather ships the result only.
`ring_oracle_sum` reproduces every arm bit for bit on one device.

``block_scale`` makes every cast the block-scaled one
(`numerics.cast_body_blocked`: one power-of-two shift per block of
``block_size`` elements of a chunk, odd tail block included) and the
wire `pack_exmy_blocked`'s: the code bytes, then one shift byte per
block.

Arms of `ring_quantized_sum`, as in the JAX module:

* plain — the hop is torch ops: unpack, add, cast, pack (fp32 payloads
  when the format cannot pack);
* fused with the packed wire (no Kahan) — hop 0 is one launch of K6
  (`ops.quantize.quantize_pack`: cast + pack) and every later hop one
  launch of K5 (`hop_pack`: unpack + add + cast + pack); with SR each
  also takes the hop's bits from one `sr_bits` launch.  The block-scaled
  wire takes the blocked arm of K6/K5 when the block size is one the
  kernel takes (`ops.quantize.fused_block_ok`: a multiple of 128
  dividing 65536, the JAX rule);
* fused with an unpacked wire (man < 2) — hop 0 is one launch of K1, or
  `sr_bits` + K2, and every later hop one launch of K3, or `sr_bits` +
  K4;
* Kahan on the card — each of a hop's four casts is K3, or `sr_bits` +
  K4 (`reduction.cast_site`); the wire is packed with torch ops.  The
  JAX ring turns its fused kernels off under Kahan too.

Two arms have no kernel, in the JAX package as here, and run the plain
torch blocked cast on CUDA tensors (their SR bits still come from the
`sr_bits` kernel): the blocked Kahan hop (four blocked casts, a
``stack([res, comp])`` blocked wire) and a block size the kernel does
not take (e.g. 33).  Both cast through `reduction._make_q`'s blocked
arm, which is those plain ops.

``verify`` is the self-verifying transport.  Each hop's payload is
tagged on both ends (`integrity.tag_from_digest`: digest ^ hop ^
sender): the sender's tag of what it sent, the receiver's of what
arrived; one ring shift of the (W-1,) sent-tag vector after the hops
lines them up (``hop_bad`` counts mismatches).  The all-gather rows are
tagged with hop 0 and checked on every rank (``gather_bad``), and each
rank's whole gathered wire digest, composed from the row digests with
`integrity.digest_concat`, is compared across ranks (``agree``).  On the
fused arm every digest comes from a kernel: the hops' from K6/K5, the
gathered rows' from K7 (`ops.quantize.digest_rows`); the plain arm
digests with `integrity.wire_digest`.  The result is then ``(vectors,
report)``, the report one dict of int32 scalars {hop_bad, gather_bad,
agree, ok}; the clean vectors equal the unverified ones bitwise.

``fault=(code, rank)`` (Python ints) corrupts, on that rank, the wire
received at hop 1 and the all-gather row (rank + 1) mod W of its copy of
the gathered stack: code 1 flips the first word's lowest bit, 2 replays
the rank's own just-sent wire (the own row at the gather), 3 zeroes it;
0 is no fault.  It applies with or without ``verify``.

``fused=None`` means fused exactly when the tensors are on CUDA (the JAX
default is "on the TPU"); ``fused=True`` on CPU tensors raises.  The
gather ships each rank's final wire as it is: a packed wire is
canonical, so re-packing its decode would give the same bytes.

The hop logic is rank-local (`_Ring.first_hop`, `_Ring.next_hop`); the
mesh only moves wires (`parallel/mesh.py`), so the same code runs on a
`LocalMesh` (every rank in this process, a hop a device copy) and on a
`ProcessMesh` (this process's rank alone, a hop one `batch_isend_irecv`
to rank + 1 and from rank - 1, the gather one all-gather).  Every rank
takes part in every collective, verified or not, faulted or not: no
rank returns early.  On a `LocalMesh` all ranks share the one gathered
stack; a gather-site fault corrupts a copy for the faulted rank only.
On a `ProcessMesh` each rank holds its own stack, and only the faulted
rank's copy is corrupted, as there.  The verify tables (the sent tags,
each rank's gather tag, whole-wire digest and ``hop_bad``) travel by
the same collectives, so every rank ends with the same report.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.quantize import (digest_rows, fused_block_ok, hop_pack,
                            quantize_pack, sr_bits)
from ..quant.numerics import (pack_exmy,
                              pack_exmy_blocked, unpack_exmy,
                              unpack_exmy_blocked, wire_bytes,
                              wire_bytes_blocked)
from ..quant.prng import site_key
from .integrity import (digest_concat, row_digests, tag_from_digest,
                        wire_digest)
from .mesh import per_distinct
from .reduction import _make_q, _use_kernel, kahan_step

__all__ = ["ring_chunk_size", "pad_to_world", "reflatten_to_world",
           "ring_quantized_sum",
           "hierarchical_ring_sum", "ring_oracle_sum", "ring_transport_bytes",
           "gather_transport_bytes", "transport_table"]

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


def reflatten_to_world(flat: torch.Tensor, total: int,
                       world: int) -> torch.Tensor:
    """A flat vector padded for one world size re-padded for ``world``:
    its first ``total`` elements (the data; the pad holds exact zeros)
    through `pad_to_world` — the elastic restart's re-flatten of a ZeRO
    momentum (`train.checkpoint`)."""
    if total > flat.shape[0]:
        raise ValueError(
            f"reflatten_to_world: flat layout holds {flat.shape[0]} "
            f"elements but total={total} are claimed as data — the "
            f"caller's layout and parameter count disagree")
    return pad_to_world(flat[:total], world)


def _check_block_args(exp: int, man: int, block_size: int,
                      packed: bool) -> None:
    """The JAX ring's refusals of a block-scaled wire, word for word."""
    if exp == 8 and man == 23:
        raise ValueError("block_scale=True at (8, 23): the fp32 wire "
                         "has nothing to scale — drop block_scale or "
                         "pick a sub-fp32 format")
    if man < 2:
        raise ValueError(
            f"block_scale=True needs a packable format (man_bits >= 2 "
            f"for the codec's special codes), got ({exp}, {man})")
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    if not packed:
        raise ValueError("block_scale=True IS the packed sidecar wire; "
                         "packed=False contradicts it")


def _flip_first_bit(x: torch.Tensor) -> torch.Tensor:
    """The lowest bit of a payload's first word (a code byte, or an fp32
    bit pattern) flipped."""
    flat = x.reshape(-1).clone()
    words = flat if flat.dtype == torch.uint8 else flat.view(torch.int32)
    words[0] ^= 1
    return flat.reshape(x.shape)


def _corrupt(x: torch.Tensor, own: torch.Tensor, code: int) -> torch.Tensor:
    """``x`` after wire fault ``code``: 1 flip, 2 ``own`` replayed, 3
    dropped (zeros); any other code leaves it."""
    if code == 1:
        return _flip_first_bit(x)
    if code == 2:
        return own.clone()
    if code == 3:
        return torch.zeros_like(x)
    return x


class _Ring:
    """One ring all-reduce's static layout, hop arm and cast sites."""

    def __init__(self, world: int, n: int, exp: int, man: int, packed: bool,
                 fused: bool, use_kahan: bool, key, offset_start: int,
                 block=None, offsets=None):
        self.world, self.exp, self.man = world, exp, man
        self.chunk = ring_chunk_size(n, world)
        self.kahan, self.key, self.block = use_kahan, key, block
        self.shortcut = exp == 8 and man == 23 and not use_kahan
        # the codec needs man >= 2 for its special codes, and 4-byte
        # words at (8, 23) save nothing
        self.packed = (packed and man >= 2
                       and not (exp == 8 and man == 23))
        self.fused = fused and not self.shortcut
        self.fused_wire = (self.fused and self.packed and not use_kahan
                           and (block is None or fused_block_ok(block)))
        self.offset_start = offset_start
        # the explicit offsets, zero-padded as the flat vector is
        self.offsets = (None if offsets is None else
                        pad_to_world(offsets.reshape(-1).to(torch.int64),
                                     world))

    def chunk_at(self, rank: int, t: int) -> int:
        """Chunk the partial of ``rank`` holds after hop t."""
        return (rank - 1 - t) % self.world

    def local(self, padded: torch.Tensor, c: int) -> torch.Tensor:
        return padded[c * self.chunk:(c + 1) * self.chunk]

    def offset(self, c: int) -> int:
        """The SR offset of chunk c's first element."""
        return (self.offset_start + c * self.chunk) & _U32

    def offs(self, c: int):
        """Chunk c's explicit offsets, or None."""
        return (None if self.offsets is None
                else self.local(self.offsets, c))

    def start(self, c: int) -> int:
        """Chunk c's ``offset_start`` (0 beside explicit offsets)."""
        return 0 if self.offsets is not None else self.offset(c)

    def q(self, c: int):
        """Chunk c's quantizer ``q(x, y, t, site)`` (`reduction._make_q`,
        blocked on the block-scaled wire)."""
        return _make_q(self.exp, self.man, self.key, self.fused,
                       self.start(c), self.offs(c), self.block)

    def rbits(self, t: int, c: int, g: torch.Tensor):
        """Hop t's SR bits for chunk c (site 0), for the wire kernels."""
        if self.key is None:
            return None
        return sr_bits(site_key(self.key, t, 0), g,
                       offset_start=self.start(c), offsets=self.offs(c))

    def to_wire(self, res: torch.Tensor, comp=None) -> torch.Tensor:
        payload = res if comp is None else torch.stack([res, comp])
        if self.block is not None:
            return pack_exmy_blocked(payload, self.exp, self.man, self.block)
        return pack_exmy(payload, self.exp, self.man) if self.packed \
            else payload

    def from_wire(self, wire: torch.Tensor) -> torch.Tensor:
        if self.block is not None:
            return unpack_exmy_blocked(wire, self.exp, self.man, self.chunk,
                                       self.block)
        return unpack_exmy(wire, self.exp, self.man) if self.packed else wire

    def first_hop(self, rank: int, padded: torch.Tensor,
                  digest: bool = False) -> tuple:
        """Rank ``rank``'s hop 0: ``(wire for hop 1, its digest or
        None)``; the fused arm's digest comes from its kernel."""
        c = self.chunk_at(rank, 0)
        g = self.local(padded, c)
        if self.kahan:
            zero = torch.zeros_like(g)
            wire = self.to_wire(*kahan_step(self.q(c), zero, zero, g, 0))
        elif self.fused_wire:
            out = quantize_pack(g, self.exp, self.man,
                                rbits=self.rbits(0, c, g),
                                block_size=self.block, want_digest=digest)
            return out[1], (out[2] if digest else None)
        elif self.shortcut:
            wire = g
        else:
            wire = self.to_wire(self.q(c)(g, None, 0, 0))
        return wire, (wire_digest(wire) if digest else None)

    def next_hop(self, rank: int, t: int, recv: torch.Tensor,
                 padded: torch.Tensor, digest: bool = False) -> tuple:
        """Rank ``rank``'s hop t >= 1 on the wire received from rank - 1:
        ``(new wire, digest of recv, digest of the new wire)``, the
        digests None unless asked for."""
        c = self.chunk_at(rank, t)
        g = self.local(padded, c)
        if self.fused_wire:
            out = hop_pack(recv, g, self.exp, self.man,
                           rbits=self.rbits(t, c, g), block_size=self.block,
                           want_digest=digest)
            return (out[1], out[2], out[3]) if digest else \
                (out[1], None, None)
        if self.kahan:
            res, comp = self.from_wire(recv)
            wire = self.to_wire(*kahan_step(self.q(c), res, comp, g, t))
        elif self.shortcut:
            wire = recv + g
        else:
            wire = self.to_wire(self.q(c)(self.from_wire(recv), g, t, 0))
        if not digest:
            return wire, None, None
        return wire, wire_digest(recv), wire_digest(wire)

    def gather_wire(self, wire: torch.Tensor) -> torch.Tensor:
        """The wire a rank ships in the all-gather: its final partial
        (a Kahan wire drops the compensation)."""
        return self.to_wire(self.from_wire(wire)[0]) if self.kahan else wire


def clean_report(device=None) -> dict:
    """The verified transport's report of a reduce with nothing to
    check: no mismatch, agreement."""
    i0 = torch.zeros((), dtype=torch.int32, device=device)
    return {"hop_bad": i0, "gather_bad": i0.clone(),
            "agree": i0 + 1, "ok": i0 + 1}


def report_ok(report: dict) -> torch.Tensor:
    """``ok`` of a report: no hop or gather mismatch, and agreement."""
    return ((report["hop_bad"] == 0) & (report["gather_bad"] == 0)
            & (report["agree"] == 1)).to(torch.int32)


def ring_quantized_sum(flats: Sequence[torch.Tensor], mesh, exp: int,
                       man: int, *, packed: bool = True,
                       fused: Optional[bool] = None, use_kahan: bool = False,
                       key=None, offset_start: int = 0, offsets=None,
                       block_scale: bool = False, block_size: int = 128,
                       verify: bool = False, fault=None):
    """Ordered quantized SUM over ``mesh``'s ranks via the ring.

    ``flats`` holds one (n,) fp32 contribution per local rank of
    ``mesh`` (``mesh.ranks``); returns the reduced (n,) vector for each,
    every partial re-quantized to (exp, man) in the documented per-chunk
    rank rotation (`ring_oracle_sum` reproduces it bit for bit), and with
    ``verify`` the pair ``(vectors, report)``.  ``packed`` ships the wire
    as eXmY code words (off automatically for man < 2 and at (8, 23),
    where the hop without Kahan is a plain fp32 add).  ``use_kahan``
    compensates every hop; ``key`` (a `prng` key) rounds every cast
    stochastically, ``offset_start`` being the global offset of
    ``flats[i][0]`` in the SR bit-index space; ``offsets`` (an (n,)
    integer tensor of uint32 offsets) gives every element's own, for a
    bucket whose leaves are not adjacent.  ``block_scale`` /
    ``block_size``, ``verify`` and ``fault``: the module docstring."""
    if block_scale:
        _check_block_args(exp, man, block_size, packed)
    if len(flats) != len(mesh.ranks):
        raise ValueError(f"expected one vector per local rank "
                         f"({len(mesh.ranks)}), got {len(flats)}")
    flats = [f.to(torch.float32) for f in flats]
    n = flats[0].shape[0]
    w = mesh.world
    if offsets is not None and offsets.numel() != n:
        raise ValueError(f"offsets must be shape ({n},), got "
                         f"{tuple(offsets.shape)}")
    ring = _Ring(w, n, exp, man, packed, _use_kernel(flats[0], fused),
                 use_kahan, key, offset_start,
                 block=block_size if block_scale else None,
                 offsets=None if offsets is None else offsets.to(
                     flats[0].device))
    if n == 0:
        return (flats, clean_report(flats[0].device)) if verify else flats
    f_code, f_rank = (0, -1) if fault is None else (int(fault[0]),
                                                     int(fault[1]))
    padded = [pad_to_world(f, w) for f in flats]
    firsts = [ring.first_hop(r, p, verify) for r, p in zip(mesh.ranks, padded)]
    wires = [x for x, _ in firsts]
    # per rank: the tags of the wires it sent (hop 1 first) and received
    sent = [[tag_from_digest(d, 1, r)] for r, (_, d) in
            zip(mesh.ranks, firsts)] if verify else None
    recvd = [[] for _ in mesh.ranks]
    last_digest = [d for _, d in firsts]
    for t in range(1, w):
        recv = mesh.ring_shift(wires)
        if t == 1 and f_code:
            recv = [_corrupt(x, own, f_code) if r == f_rank else x
                    for r, x, own in zip(mesh.ranks, recv, wires)]
        hops = [ring.next_hop(r, t, x, p, verify)
                for r, x, p in zip(mesh.ranks, recv, padded)]
        wires = [h[0] for h in hops]
        if verify:
            for i, (r, (_, d_in, d_out)) in enumerate(zip(mesh.ranks, hops)):
                recvd[i].append(tag_from_digest(d_in, t, (r - 1) % w))
                if t < w - 1:        # the last hop's wire is never sent
                    sent[i].append(tag_from_digest(d_out, t + 1, r))
                last_digest[i] = d_out
    # rank r's wire now holds the reduced chunk r; the all-gather
    # rebuilds the full vector on every rank
    gwires = [ring.gather_wire(x) for x in wires]
    gathered = mesh.all_gather(gwires)
    if f_code:
        # rank f's copy of row (f + 1) mod W arrives corrupted
        j = (f_rank + 1) % w
        for i, r in enumerate(mesh.ranks):
            if r == f_rank:
                mine = gathered[i].clone()
                mine[j] = _corrupt(mine[j], gwires[i], f_code)
                gathered[i] = mine
    vecs = per_distinct(lambda g: ring.from_wire(g).reshape(-1)[:n],
                        gathered)
    if not verify:
        return vecs

    hop_bad = [torch.zeros((), dtype=torch.int64, device=v.device)
               for v in vecs]
    if w > 1:
        remote = mesh.ring_shift([torch.stack(s) for s in sent])
        hop_bad = [(rs != torch.stack(rt)).sum()
                   for rs, rt in zip(remote, recvd)]
    if ring.fused_wire:
        # the sent gather wire's digest came out of the last hop's kernel;
        # the received rows are digested by K7
        gtags = [tag_from_digest(d, 0, r)
                 for r, d in zip(mesh.ranks, last_digest)]
        rdig = per_distinct(lambda g: digest_rows(g.reshape(w, -1)),
                            gathered)
    else:
        gtags = [tag_from_digest(wire_digest(g), 0, r)
                 for r, g in zip(mesh.ranks, gwires)]
        rdig = per_distinct(row_digests, gathered)
    row_words = gathered[0][0].numel()

    def full_digest(d):
        out = d[0]
        for i in range(1, w):
            out = digest_concat(out, i * row_words, d[i])
        return out

    rep = mesh.all_gather([
        torch.stack([gt, full_digest(d), hb.to(torch.int64)])
        for gt, d, hb in zip(gtags, rdig, hop_bad)])
    ranks_t = torch.arange(w, dtype=torch.int64, device=rdig[0].device)
    gather_bad = mesh.sum([
        (tag_from_digest(d, 0, ranks_t) != rp[:, 0]).sum()
        for d, rp in zip(rdig, rep)])[0]
    rep0 = rep[0]
    report = {"hop_bad": rep0[:, 2].sum().to(torch.int32),
              "gather_bad": gather_bad.to(torch.int32),
              "agree": (rep0[:, 1] == rep0[0, 1]).all().to(torch.int32)}
    report["ok"] = report_ok(report)
    return vecs, report


def hierarchical_ring_sum(flats: Sequence[torch.Tensor], mesh, exp: int,
                          man: int, **kw):
    """The ring over the mesh's axes.  The reduce runs over one axis (a
    data-parallel mesh, or the dp view of a dp x sp x tp mesh), where
    this is exactly `ring_quantized_sum`; the multi-axis composition
    (innermost axis first) is not ported yet (ROADMAP Queue A row 2,
    A5)."""
    return ring_quantized_sum(flats, mesh, exp, man, **kw)


def ring_oracle_sum(stacked: torch.Tensor, exp: int, man: int, *,
                    use_kahan: bool = False, key=None,
                    offset_start: int = 0, offsets=None,
                    block_scale: bool = False,
                    block_size: int = 128) -> torch.Tensor:
    """Single-device oracle of `ring_quantized_sum`: from the stacked
    per-rank contributions (W, *shape), the same per-chunk rank rotation
    and per-hop casts with their (hop, site, global offset) SR bits, in
    plain torch ops — everything except the wire.  The casts run on the
    (W, chunk) block of all chunks at once, whose element (c, i) draws
    offset ``offset_start + c * chunk + i`` (or the zero-padded
    ``offsets[c * chunk + i]``), as on the ring; with ``block_scale``
    they are the blocked cast, blocks along each chunk."""
    w = stacked.shape[0]
    shape = stacked.shape[1:]
    n = stacked[0].numel()
    if n == 0:
        return torch.zeros(shape, dtype=torch.float32, device=stacked.device)
    chunk = ring_chunk_size(n, w)
    flat = stacked.reshape(w, n).to(torch.float32)
    per_chunk = F.pad(flat, (0, w * chunk - n)).reshape(w, w, chunk)
    c_idx = torch.arange(w, device=stacked.device)
    offs = None
    if offsets is not None:
        offs = F.pad(offsets.reshape(-1).to(stacked.device, torch.int64),
                     (0, w * chunk - n)).reshape(w, chunk)
    q = _make_q(exp, man, key, False, offset_start, offs,
                block_size if block_scale else None)
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


def ring_transport_bytes(n: int, world: int, exp: int, man: int, *,
                         use_kahan: bool = False, packed: bool = True,
                         block_size: Optional[int] = None) -> int:
    """Per-rank wire bytes of one ring all-reduce of n elements: (W-1)
    reduce-scatter hops of one chunk (x2 with Kahan, the compensation
    rides) plus (W-1) all-gather hops of one chunk.  ``block_size``
    prices the block-scaled wire, sidecar included."""
    if n == 0 or world <= 0:
        return 0
    chunk = ring_chunk_size(n, world)
    if block_size is not None:
        per_chunk = wire_bytes_blocked(exp, man, chunk, block_size)
    else:
        per_chunk = chunk * (wire_bytes(exp, man) if packed else 4)
    reduce_phase = (world - 1) * per_chunk * (2 if use_kahan else 1)
    gather_phase = (world - 1) * per_chunk
    return reduce_phase + gather_phase


def gather_transport_bytes(n: int, world: int, exp: int, man: int, *,
                           compressed: bool = False,
                           block_size: Optional[int] = None) -> int:
    """Per-rank wire bytes of the faithful all-gather: (W-1) * n
    elements, fp32 unless packed (``compressed``); ``block_size`` adds
    the sidecar a block-scaled row would carry (analytic only)."""
    if n == 0 or world <= 0:
        return 0
    if block_size is not None:
        return (world - 1) * wire_bytes_blocked(exp, man, n, block_size)
    per_elem = wire_bytes(exp, man) if compressed else 4
    return (world - 1) * n * per_elem


def transport_table(n: int, world: int, exp: int, man: int,
                    use_kahan: bool = False,
                    block_size: Optional[int] = None) -> dict:
    """Per-rank bytes on the wire of every transport of one all-reduce
    of n elements (the JAX function's table, key for key)."""
    compressible = man >= 2 and wire_bytes(exp, man) < 4
    gather = gather_transport_bytes(n, world, exp, man, compressed=False)
    table = {
        "faithful_gather_fp32": gather,
        "faithful_gather_packed": (
            gather_transport_bytes(n, world, exp, man, compressed=True)
            if compressible else None),
        "ring_packed": ring_transport_bytes(n, world, exp, man,
                                            use_kahan=use_kahan,
                                            packed=compressible),
        "ring_block_scaled": (
            ring_transport_bytes(n, world, exp, man, use_kahan=use_kahan,
                                 block_size=block_size)
            if block_size is not None and compressible else None),
        "fast_psum_fp32": ring_transport_bytes(n, world, 8, 23,
                                               packed=False),
    }
    table["ring_vs_gather_ratio"] = (
        round(gather / table["ring_packed"], 2) if table["ring_packed"]
        else None)
    return table
