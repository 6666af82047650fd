"""The data-parallel mesh of the port (port of the dp part of
`cpd_tpu/parallel/mesh.py`).

A `LocalMesh` holds ``world`` data-parallel ranks in ONE process on ONE
device.  It is the counterpart of the JAX package's single-controller
mesh, where one program runs `shard_map` over the W devices of a host
(every JAX ring test runs that way, on the 8-device CPU mesh).  Rank
r's computation is exactly what shard_map's rank r computes; the mesh
adds no semantics of its own.

The collectives take and return one value per local rank, as a list
indexed by position in ``mesh.ranks``.  A `LocalMesh` holds every rank,
so its lists have ``world`` entries; a `torch.distributed` mesh (one
rank per card, a later slice) would hold one.  The reduce code in
`ring.py`/`dist.py` is written against that interface, so it runs on
either.

On one device the ring's send/recv is a device copy of the wire, not a
transfer over NVLink.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..device import resolve_device

__all__ = ["LocalMesh", "data_parallel_mesh", "per_distinct"]


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

    def max(self, xs: Sequence[torch.Tensor]) -> list:
        """Elementwise MAX over the ranks (NaN propagates)."""
        self._check(xs)
        m = torch.stack(list(xs)).amax(dim=0)
        return [m for _ in self.ranks]

    def min(self, xs: Sequence[torch.Tensor]) -> list:
        """Elementwise MIN over the ranks (NaN propagates)."""
        self._check(xs)
        m = torch.stack(list(xs)).amin(dim=0)
        return [m for _ in self.ranks]

    def sum(self, xs: Sequence[torch.Tensor]) -> list:
        """Elementwise SUM over the ranks, in rank order."""
        self._check(xs)
        s = xs[0]
        for x in xs[1:]:
            s = s + x
        return [s for _ in self.ranks]

    def mean(self, xs: Sequence[torch.Tensor]) -> list:
        """Elementwise mean over the ranks: the rank-order sum / world."""
        return [s / self.world for s in self.sum(xs)]


def per_distinct(fn, *columns: Sequence) -> list:
    """``[fn(*row) for row in zip(*columns)]``, with ``fn`` run once per
    distinct row of objects: the ranks of a `LocalMesh` receive one
    shared buffer from a collective, and what each rank would compute
    from the same inputs is the same."""
    done: dict = {}
    out = []
    for row in zip(*columns):
        key = tuple(map(id, row))
        if key not in done:
            done[key] = fn(*row)
        out.append(done[key])
    return out


def data_parallel_mesh(world: int, device="cuda") -> LocalMesh:
    """A pure data-parallel mesh of ``world`` ranks on one device."""
    return LocalMesh(world, device)
