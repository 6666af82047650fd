"""The data-parallel meshes of the port (port of the dp part of
`cpd_tpu/parallel/mesh.py`).

Two meshes, one interface:

* `LocalMesh` holds ``world`` data-parallel ranks in ONE process on ONE
  device.  It is the counterpart of the JAX package's single-controller
  mesh, where one program runs `shard_map` over the W devices of a host
  (every JAX ring test runs that way, on the 8-device CPU mesh).  Rank
  r's computation is exactly what shard_map's rank r computes; the mesh
  adds no semantics of its own.  On one device the ring's send/recv is a
  device copy of the wire, and the ranks run in turn.
* `ProcessMesh` holds ONE rank: this process's, in a `torch.distributed`
  process group of ``world`` processes (the JAX package's
  multi-controller mesh, `jax.distributed` with one device a process).
  Its ring hop is one `dist.batch_isend_irecv`, its gather one
  all-gather into a ``(world, ...)`` stack, its all-to-all (ZeRO-2's
  reduce-scatter) one `dist.all_to_all_single`.

The collectives take and return one value per local rank, as a list
indexed by position in ``mesh.ranks`` (global rank numbers): ``world``
entries on a `LocalMesh`, one on a `ProcessMesh`.  The reduce code in
`ring.py`/`dist.py` is written against that interface, so it runs on
either, and the two give the same bits: the MAX, MIN, SUM and mean of a
`ProcessMesh` are its all-gather followed by the `LocalMesh`'s own
reduction of the stack (`_max`, `_min`, `_sum`), in rank order.  A
backend's own all-reduce is never used: NCCL's SUM adds in an order of
its own, and no backend's MAX promises to carry a NaN, which the APS
exponent MAX must (``aps_bad`` counts it).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["LocalMesh", "ProcessMesh", "data_parallel_mesh", "per_distinct"]


def _max(stack: torch.Tensor) -> torch.Tensor:
    """Elementwise MAX over the leading (rank) axis; NaN propagates."""
    return stack.amax(dim=0)


def _min(stack: torch.Tensor) -> torch.Tensor:
    """Elementwise MIN over the leading (rank) axis; NaN propagates."""
    return stack.amin(dim=0)


def _sum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Elementwise SUM of the ranks' values, added in rank order."""
    s = xs[0]
    for x in xs[1:]:
        s = s + x
    return s


class LocalMesh:
    """``world`` data-parallel ranks in one process on ``device``."""

    def __init__(self, world: int, device):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.world = int(world)
        self.device = resolve_device(device)
        self.ranks = tuple(range(self.world))

    def __repr__(self) -> str:
        return f"LocalMesh(world={self.world}, device={self.device})"

    def _check(self, xs: Sequence) -> None:
        if len(xs) != len(self.ranks):
            raise ValueError(f"expected one value per local rank "
                             f"({len(self.ranks)}), got {len(xs)}")

    def ring_shift(self, xs: Sequence[torch.Tensor]) -> list:
        """Each rank sends its value to rank + 1 (mod world) and receives
        rank - 1's: the ring's one hop (the JAX ``ppermute`` with
        ``perm = [(i, (i + 1) % W)]``)."""
        self._check(xs)
        return [xs[(r - 1) % self.world].clone() for r in self.ranks]

    def all_gather(self, xs: Sequence[torch.Tensor]) -> list:
        """Every rank receives the (world, ...) stack of all ranks'
        values, in rank order."""
        self._check(xs)
        stacked = torch.stack(list(xs))
        return [stacked for _ in self.ranks]

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> list:
        """Each rank's value is a (world, ...) stack whose row j goes to
        rank j; rank r receives the (world, ...) stack of every rank's
        row r, in rank order (the JAX ``all_to_all`` with ``split_axis =
        concat_axis = 0``).  Here a reindexing."""
        self._check(xs)
        stacked = torch.stack(list(xs))
        return [stacked[:, r].contiguous() for r in self.ranks]

    def max(self, xs: Sequence[torch.Tensor]) -> list:
        """Elementwise MAX over the ranks (NaN propagates)."""
        self._check(xs)
        m = _max(torch.stack(list(xs)))
        return [m for _ in self.ranks]

    def min(self, xs: Sequence[torch.Tensor]) -> list:
        """Elementwise MIN over the ranks (NaN propagates)."""
        self._check(xs)
        m = _min(torch.stack(list(xs)))
        return [m for _ in self.ranks]

    def sum(self, xs: Sequence[torch.Tensor]) -> list:
        """Elementwise SUM over the ranks, in rank order."""
        self._check(xs)
        s = _sum(xs)
        return [s for _ in self.ranks]

    def mean(self, xs: Sequence[torch.Tensor]) -> list:
        """Elementwise mean over the ranks: the rank-order sum / world."""
        return [s / self.world for s in self.sum(xs)]


class ProcessMesh:
    """This process's one rank of a `torch.distributed` process group
    (`parallel.dist.dist_init` starts it).

    ``world`` is the group's size and ``ranks`` is ``(rank,)``, the
    GLOBAL rank: the SR keys and ``wire_fault=(code, rank)`` fold it in.
    ``device`` is the rank's own device.  The backend is the group's:

    * ``nccl`` — one rank per card.  The collectives run on the tensors
      where they lie, on the rank's card; `dist_init` refuses two ranks
      on one card (NCCL does too).
    * ``gloo`` — the CPU, and W processes sharing one card.  gloo's
      send, receive and all-gather take CPU tensors only, so on a card
      the mesh stages every wire through host memory: a copy to the host
      before the send, a copy to the card after the receive.

    ``log``, when set to a list, receives ``(op, dtype, nbytes)`` for
    every tensor this rank hands to a collective (``ring_shift``,
    ``all_gather``, ``all_to_all``): what the wire carries out of the
    rank is nbytes for a ring shift, ``(world - 1) * nbytes`` for an
    all-gather and ``(world - 1) / world * nbytes`` for an all-to-all
    (the rank keeps its own row)."""

    def __init__(self, device="cuda"):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs a torch.distributed "
                               "process group: call parallel.dist."
                               "dist_init first")
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.ranks = (self.rank,)
        self.backend = str(dist.get_backend())
        self.device = resolve_device(device)
        if self.backend == "nccl":
            if self.device.type != "cuda":
                raise ValueError("an nccl mesh runs on the card: got "
                                 f"device {self.device}")
            if self.device.index != torch.cuda.current_device():
                raise ValueError(
                    f"an nccl rank runs on its own card, cuda:"
                    f"{torch.cuda.current_device()} (set by dist_init); "
                    f"got {self.device}")
        # gloo moves CPU tensors only
        self.staged = self.backend != "nccl" and self.device.type == "cuda"
        self.log: Optional[list] = None

    def __repr__(self) -> str:
        return (f"ProcessMesh(rank={self.rank}, world={self.world}, "
                f"backend={self.backend}, device={self.device})")

    def _check(self, xs: Sequence) -> torch.Tensor:
        if len(xs) != 1:
            raise ValueError(f"expected one value per local rank (1), got "
                             f"{len(xs)}")
        x = xs[0]
        if x.device != self.device:
            raise ValueError(f"rank {self.rank} holds {x.device}, the mesh "
                             f"runs on {self.device}")
        return x.contiguous()

    def _record(self, op: str, x: torch.Tensor) -> None:
        if self.log is not None:
            self.log.append((op, x.dtype, x.numel() * x.element_size()))

    def ring_shift(self, xs: Sequence[torch.Tensor]) -> list:
        """Send this rank's value to rank + 1 (mod world) and receive
        rank - 1's, in one `batch_isend_irecv` (the JAX ``ppermute`` with
        ``perm = [(i, (i + 1) % W)]``).  The received buffer has the
        shape and dtype of the rank's own send; every rank of the ring
        sends the same shape.  The receive is complete when this
        returns: the requests are waited on, which on NCCL orders the
        current stream after the transfer."""
        x = self._check(xs)
        self._record("ring_shift", x)
        if self.world == 1:
            return [x.clone()]
        send = x.cpu() if self.staged else x
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, (self.rank + 1) % self.world),
               dist.P2POp(dist.irecv, recv, (self.rank - 1) % self.world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [recv.to(self.device) if self.staged else recv]

    def all_gather(self, xs: Sequence[torch.Tensor]) -> list:
        """The (world, ...) stack of every rank's value, in rank order:
        one all-gather into a single tensor (at world 1 too, so the
        backend's collective runs on a one-card machine)."""
        x = self._check(xs)
        self._record("all_gather", x)
        src = x.cpu() if self.staged else x
        out = torch.empty((self.world,) + tuple(src.shape), dtype=src.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(out.reshape(-1), src.reshape(-1))
        return [out.to(self.device) if self.staged else out]

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> list:
        """This rank's (world, ...) stack, row j sent to rank j; returns
        the (world, ...) stack of every rank's row for this one, in rank
        order: one `dist.all_to_all_single` (at world 1 too).  Under
        nccl the receive is ordered on the current stream, and the host
        does not wait; gloo stages through host memory and waits."""
        x = self._check(xs)
        if x.shape[0] != self.world:
            raise ValueError(f"all_to_all sends one row per rank: leading "
                             f"axis {x.shape[0]}, world {self.world}")
        self._record("all_to_all", x)
        src = x.cpu() if self.staged else x
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src)
        return [out.to(self.device) if self.staged else out]

    def max(self, xs: Sequence[torch.Tensor]) -> list:
        """Elementwise MAX over the ranks (NaN propagates): `_max` of the
        gathered stack, bitwise the `LocalMesh`'s."""
        return [_max(self.all_gather(xs)[0])]

    def min(self, xs: Sequence[torch.Tensor]) -> list:
        """Elementwise MIN over the ranks (NaN propagates)."""
        return [_min(self.all_gather(xs)[0])]

    def sum(self, xs: Sequence[torch.Tensor]) -> list:
        """Elementwise SUM over the ranks, in rank order: `_sum` of the
        gathered stack's rows, bitwise the `LocalMesh`'s."""
        return [_sum(list(self.all_gather(xs)[0]))]

    def mean(self, xs: Sequence[torch.Tensor]) -> list:
        """Elementwise mean over the ranks: the rank-order sum / world."""
        return [s / self.world for s in self.sum(xs)]


def per_distinct(fn, *columns: Sequence) -> list:
    """``[fn(*row) for row in zip(*columns)]``, with ``fn`` run once per
    distinct row of objects: the ranks of a `LocalMesh` receive one
    shared buffer from a collective, and what each rank would compute
    from the same inputs is the same.  On a `ProcessMesh` there is one
    row, so ``fn`` runs once, on this rank's own buffers."""
    done: dict = {}
    out = []
    for row in zip(*columns):
        key = tuple(map(id, row))
        if key not in done:
            done[key] = fn(*row)
        out.append(done[key])
    return out


def data_parallel_mesh(world: Optional[int] = None, device="cuda"):
    """A pure data-parallel mesh: ``world`` `LocalMesh` ranks in this
    process on ``device``, or, with ``world=None``, this process's rank
    of the `torch.distributed` group as a `ProcessMesh` (its ``device``:
    the rank's card under nccl, ``device`` itself under gloo)."""
    if world is None:
        return ProcessMesh(device)
    return LocalMesh(world, device)
