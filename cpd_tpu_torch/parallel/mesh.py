"""The meshes of the port (port of `cpd_tpu/parallel/mesh.py` at its
dp, sp and tp axes).

Two meshes, one interface:

* `LocalMesh` holds ``world`` ranks in ONE process on ONE device.  It is
  the counterpart of the JAX package's single-controller mesh, where one
  program runs `shard_map` over the W devices of a host (every JAX ring
  test runs that way, on the 8-device CPU mesh).  Rank r's computation
  is exactly what shard_map's rank r computes; the mesh adds no
  semantics of its own.  On one device the ring's send/recv is a device
  copy of the wire, and the ranks run in turn.
* `ProcessMesh` holds ONE rank: this process's, in a `torch.distributed`
  process group of ``world`` processes (the JAX package's
  multi-controller mesh, `jax.distributed` with one device a process).
  Its ring hop is one `dist.batch_isend_irecv`, its gather one
  all-gather into a ``(world, ...)`` stack, its all-to-all (ZeRO-2's
  reduce-scatter, Ulysses' head exchange) one `dist.all_to_all_single`.

Both are meshes of named axes in the JAX package's canonical order
``(dp, pp, sp, ep, tp)``; the port has the dp, sp and tp axes (``sp=1,
tp=1`` keeps the pure data-parallel mesh of earlier slices).  tp is the
innermost: flat rank ``f = (i * sp + j) * tp + k`` sits at dp index i,
sp index j and tp index k (the order of JAX's ``make_mesh(dp, tp, sp)
.devices`` once pp = ep = 1), so data block (i, j) — the rows of dp rank
i and the columns of sp rank j, as JAX's ``P(dp, sp)`` shards a (batch,
sequence) array — is held by the tp ranks ``(i * sp + j) * tp + k``,
every one of them.  ``mesh.axis(name)`` is the 1-D view over one axis,
with the interface the reduce code is written against (``ring_shift``,
``all_gather``, ``all_to_all``, ``max``, ``min``, ``sum``, ``mean``,
``ranks``, ``world``): its ``world`` is the axis size and its ``ranks``
are the axis indices of the local ranks, so an SR key folded with
``r for r in view.ranks`` is JAX's ``fold_in(k, axis_index(axis))``.  On a
`LocalMesh` the view applies each collective within every group of local
ranks that share their other coordinates; on a `ProcessMesh` it runs
over a `torch.distributed` subgroup (every process creates every
subgroup of the mesh, in one order, when the mesh is built; its ops are
logged under the axis' name).  A data-parallel mesh (sp = tp = 1) is
its own dp view.

The collectives take and return one value per local rank, as a list
indexed by position in ``mesh.ranks``: ``world`` entries on a
`LocalMesh`, one on a `ProcessMesh`.  The reduce code in
`ring.py`/`dist.py` is written against that interface, so it runs on
either, and the two give the same bits: the MAX, MIN, SUM and mean of a
`ProcessMesh` are its all-gather followed by the `LocalMesh`'s own
reduction of the stack (`_max`, `_min`, `_sum`), in rank order.  A
backend's own all-reduce is never used: NCCL's SUM adds in an order of
its own, and no backend's MAX promises to carry a NaN, which the APS
exponent MAX must (``aps_bad`` counts it).

``ring_shift``, ``all_to_all`` and ``psum`` carry gradients, as JAX's
shard_map transposes ``ppermute``, ``all_to_all`` and ``psum``: on a
`LocalMesh` the first two are copies and reindexings that autograd sees
through; on a `ProcessMesh` each is a `torch.autograd.Function` whose
backward is the reverse shift or the inverse all-to-all of the incoming
gradient (sequence-parallel attention's backward, `ops.attention`).
``psum`` (the tensor-parallel sum of the Megatron blocks) is the
rank-order ``sum`` forward and the rank-order sum of the incoming
gradients backward on both meshes, as shard_map (with its replication
check off) transposes ``psum``.  Every rank reaches a backward
collective where its forward one stood in the graph, so the ranks meet
in the same order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["LocalMesh", "ProcessMesh", "data_parallel_mesh", "make_mesh",
           "per_distinct", "AXIS_DATA", "AXIS_SEQ", "AXIS_TENSOR"]

AXIS_DATA = "dp"
AXIS_SEQ = "sp"
AXIS_TENSOR = "tp"
# the JAX package's order; the port holds its dp, sp and tp axes
_CANONICAL_ORDER = (AXIS_DATA, "pp", AXIS_SEQ, "ep", AXIS_TENSOR)


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


def _axes(world: int, sp: int, tp: int = 1) -> dict:
    """The axis sizes of a dp x sp x tp mesh of ``world`` ranks."""
    if sp < 1 or tp < 1 or world % (sp * tp):
        raise ValueError(f"sp={sp} x tp={tp} must be >= 1 and divide the "
                         f"mesh's {world} ranks")
    return {AXIS_DATA: world // (sp * tp), AXIS_SEQ: sp, AXIS_TENSOR: tp}


def _coords(flat: int, axes: dict) -> dict:
    """A flat rank's index on each axis (dp outermost, tp innermost)."""
    sp, tp = axes[AXIS_SEQ], axes[AXIS_TENSOR]
    return {AXIS_DATA: flat // (sp * tp), AXIS_SEQ: flat // tp % sp,
            AXIS_TENSOR: flat % tp}


def _axis_groups(name: str, axes: dict) -> list:
    """The flat ranks of each group along axis ``name`` (ranks that share
    their other coordinates), each in axis-index order, groups in the
    order of their first rank."""
    world = axes[AXIS_DATA] * axes[AXIS_SEQ] * axes[AXIS_TENSOR]
    groups: dict = {}
    for f in range(world):
        c = _coords(f, axes)
        groups.setdefault(tuple(v for k, v in c.items() if k != name),
                          []).append(f)
    return list(groups.values())


class _LocalCollectives:
    """The `LocalMesh` collectives over ``self._groups`` (lists of
    positions into ``ranks``, each in axis-index order): every group
    runs the collective on its own members' values."""

    def __repr__(self) -> str:
        return f"{type(self).__name__}(world={self.world}, " \
               f"device={self.device})"

    def _check(self, xs: Sequence) -> None:
        if len(xs) != len(self.ranks):
            raise ValueError(f"expected one value per local rank "
                             f"({len(self.ranks)}), got {len(xs)}")

    def _each(self, xs: Sequence, fn) -> list:
        self._check(xs)
        out = [None] * len(xs)
        for g in self._groups:
            for p, y in zip(g, fn([xs[p] for p in g])):
                out[p] = y
        return out

    def ring_shift(self, xs: Sequence[torch.Tensor]) -> list:
        """Each rank sends its value to rank + 1 (mod world) and receives
        rank - 1's: the ring's one hop (the JAX ``ppermute`` with
        ``perm = [(i, (i + 1) % W)]``).  A copy, so gradients flow back
        to the sender."""
        return self._each(xs, lambda v: [v[(i - 1) % len(v)].clone()
                                         for i in range(len(v))])

    def all_gather(self, xs: Sequence[torch.Tensor]) -> list:
        """Every rank receives the (world, ...) stack of all ranks'
        values, in rank order."""
        def gather(v):
            stacked = torch.stack(list(v))
            return [stacked] * len(v)
        return self._each(xs, gather)

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> list:
        """Each rank's value is a (world, ...) stack whose row j goes to
        rank j; rank r receives the (world, ...) stack of every rank's
        row r, in rank order (the JAX ``all_to_all`` with ``split_axis =
        concat_axis = 0``).  Here a reindexing."""
        def exchange(v):
            stacked = torch.stack(list(v))
            return [stacked[:, i].contiguous() for i in range(len(v))]
        return self._each(xs, exchange)

    def _reduce(self, xs, fn) -> list:
        def red(v):
            m = fn(v)
            return [m] * len(v)
        return self._each(xs, red)

    def max(self, xs: Sequence[torch.Tensor]) -> list:
        """Elementwise MAX over the ranks (NaN propagates)."""
        return self._reduce(xs, lambda v: _max(torch.stack(list(v))))

    def min(self, xs: Sequence[torch.Tensor]) -> list:
        """Elementwise MIN over the ranks (NaN propagates)."""
        return self._reduce(xs, lambda v: _min(torch.stack(list(v))))

    def sum(self, xs: Sequence[torch.Tensor]) -> list:
        """Elementwise SUM over the ranks, in rank order."""
        return self._reduce(xs, _sum)

    def mean(self, xs: Sequence[torch.Tensor]) -> list:
        """Elementwise mean over the ranks: the rank-order sum / world."""
        return [s / self.world for s in self.sum(xs)]

    def psum(self, xs: Sequence[torch.Tensor]) -> list:
        """The SUM that carries gradients (module docstring): the
        rank-order sum forward, the rank-order sum of the incoming
        gradients backward; a one-rank group passes its value through."""
        return self._each(xs, lambda v: list(_RankSum.apply(*v))
                          if len(v) > 1 else list(v))


class _RankSum(torch.autograd.Function):
    """The rank-order sum of a `LocalMesh` group's values, one output a
    rank; the backward is the rank-order sum of the outputs' gradients,
    handed to every rank (JAX's transpose of ``psum``)."""

    @staticmethod
    def forward(ctx, *xs):
        s = _sum(xs)
        return (s,) + tuple(s.clone() for _ in xs[1:])

    @staticmethod
    def backward(ctx, *gs):
        s = _sum(gs)
        return (s,) + tuple(s.clone() for _ in gs[1:])


class LocalMesh(_LocalCollectives):
    """``world`` ranks in one process on ``device``: ``world // (sp *
    tp)`` dp ranks x ``sp`` sequence-parallel ranks x ``tp``
    tensor-parallel ranks (flat rank ``(i * sp + j) * tp + k``)."""

    is_local = True

    def __init__(self, world: int, device, *, sp: int = 1, tp: int = 1):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.world = int(world)
        self.axes = _axes(self.world, int(sp), int(tp))
        self.device = resolve_device(device)
        self.ranks = tuple(range(self.world))
        self._groups = [list(self.ranks)]

    def __repr__(self) -> str:
        return (f"LocalMesh(world={self.world}, sp={self.axes[AXIS_SEQ]}, "
                f"tp={self.axes[AXIS_TENSOR]}, device={self.device})")

    def coords(self, rank: int) -> dict:
        """Flat rank ``rank``'s index on each axis."""
        return _coords(rank, self.axes)

    def axis(self, name: str, members: Optional[Sequence[int]] = None):
        """The 1-D view over axis ``name`` (module docstring), over the
        flat ranks ``members`` (default: all; whole groups only)."""
        if name not in self.axes:
            raise ValueError(f"no axis {name!r}; the mesh has "
                             f"{tuple(self.axes)}")
        if members is None and self.axes[name] == self.world:
            return self
        return _LocalAxis(self, name, self.ranks if members is None
                          else tuple(members))


class _LocalAxis(_LocalCollectives):
    """A `LocalMesh`'s view over one axis, on some of its ranks (whole
    groups of the axis)."""

    is_local = True

    def __init__(self, mesh: LocalMesh, name: str, members: tuple):
        self.device = mesh.device
        self.world = mesh.axes[name]
        self.axes = {name: self.world}
        self.ranks = tuple(mesh.coords(m)[name] for m in members)
        pos = {m: p for p, m in enumerate(members)}
        groups = [g for g in _axis_groups(name, mesh.axes)
                  if any(f in pos for f in g)]
        if sum(map(len, groups)) != len(members):
            raise ValueError(f"members {members} do not hold whole "
                             f"groups of axis {name!r}")
        self._groups = [[pos[f] for f in g] for g in groups]


class _Shift(torch.autograd.Function):
    """A `ProcessMesh` ring hop whose backward is the reverse hop."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return mesh._shift(x, False)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh._shift(g.contiguous(), True)


class _AllToAll(torch.autograd.Function):
    """A `ProcessMesh` all-to-all; the exchange is its own inverse, so
    the backward is the same exchange of the incoming gradient."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return mesh._exchange(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh._exchange(g.contiguous())


class _Psum(torch.autograd.Function):
    """A `ProcessMesh` view's ``psum``: the all-gather and the rank-order
    sum of the stack, forward and backward."""

    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return _sum(list(mesh._gather(x)))

    @staticmethod
    def backward(ctx, g):
        return None, _sum(list(ctx.mesh._gather(g.contiguous())))


class ProcessMesh:
    """This process's one rank of a `torch.distributed` process group
    (`parallel.dist.dist_init` starts it), a dp x ``sp`` x ``tp`` mesh of
    the group's processes.

    ``world`` is the group's size and ``ranks`` is ``(rank,)``, the
    GLOBAL rank: the SR keys and ``wire_fault=(code, rank)`` fold it in
    (on an axis view, ``ranks`` is the axis index).  ``device`` is the
    rank's own device.  The backend is the group's:

    * ``nccl`` — one rank per card.  The collectives run on the tensors
      where they lie, on the rank's card; `dist_init` refuses two ranks
      on one card (NCCL does too).
    * ``gloo`` — the CPU, and W processes sharing one card.  gloo's
      send, receive and all-gather take CPU tensors only, so on a card
      the mesh stages every wire through host memory: a copy to the host
      before the send, a copy to the card after the receive.

    ``log``, when set to a list on the mesh, receives ``(op, dtype,
    nbytes)`` for every tensor this rank hands to a collective
    (``ring_shift``, ``all_gather``, ``all_to_all``; an axis view's ops
    as ``"<axis>.<op>"``, a backward's as well): what the wire carries
    out of the rank is nbytes for a ring shift, ``(world - 1) * nbytes``
    for an all-gather and ``(world - 1) / world * nbytes`` for an
    all-to-all (the rank keeps its own row)."""

    is_local = False

    def __init__(self, device="cuda", *, sp: int = 1, tp: int = 1):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs a torch.distributed "
                               "process group: call parallel.dist."
                               "dist_init first")
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.ranks = (self.rank,)
        self.axes = _axes(self.world, int(sp), int(tp))
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
        self.group = None
        self._peers = tuple(range(self.world))
        self._root, self._name = self, None
        self._views: dict = {}
        if self.axes[AXIS_DATA] < self.world:
            # every process creates every subgroup, in one order; an axis
            # over all the processes runs on the group itself
            for name in _CANONICAL_ORDER:
                size = self.axes.get(name, 1)
                if size == 1:
                    continue
                if size == self.world:
                    self._views[name] = self._view(name, None,
                                                   tuple(range(size)))
                    continue
                for members in _axis_groups(name, self.axes):
                    group = dist.new_group(members)
                    if self.rank in members:
                        self._views[name] = self._view(name, group, members)

    def __repr__(self) -> str:
        if self._name is not None:
            return (f"ProcessMesh.axis({self._name!r}, rank={self.rank}, "
                    f"world={self.world})")
        return (f"ProcessMesh(rank={self.rank}, world={self.world}, "
                f"sp={self.axes[AXIS_SEQ]}, tp={self.axes[AXIS_TENSOR]}, "
                f"backend={self.backend}, device={self.device})")

    def _view(self, name: str, group, members: Sequence[int]):
        v = object.__new__(ProcessMesh)
        v.__dict__.update(
            world=len(members), rank=list(members).index(self.rank),
            axes={name: len(members)}, backend=self.backend,
            device=self.device, staged=self.staged, group=group,
            _peers=tuple(members), _root=self, _name=name, _views={})
        v.ranks = (v.rank,)
        v._views[name] = v
        return v

    def coords(self, rank: int) -> dict:
        """Flat rank ``rank``'s index on each axis."""
        return _coords(rank, self.axes)

    def axis(self, name: str):
        """The 1-D view over axis ``name`` (module docstring): this
        process's subgroup along it, or a one-rank view where the axis
        has size 1.  A data-parallel mesh is its own dp view."""
        if name not in self.axes:
            raise ValueError(f"no axis {name!r}; the mesh has "
                             f"{tuple(self.axes)}")
        if name not in self._views:
            if name == AXIS_DATA and self.axes[AXIS_DATA] == self.world:
                return self
            self._views[name] = self._view(name, None, (self.rank,))
        return self._views[name]

    def global_rank(self, index: int) -> int:
        """The group-wide rank of this mesh's (or view's) rank ``index``."""
        return self._peers[index]

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
        log = self._root.log
        if log is not None:
            name = op if self._name is None else f"{self._name}.{op}"
            log.append((name, x.dtype, x.numel() * x.element_size()))

    @property
    def _solo(self) -> bool:
        # a view over an axis of size 1 moves nothing
        return self._name is not None and self.world == 1

    def _shift(self, x: torch.Tensor, reverse: bool) -> torch.Tensor:
        self._record("ring_shift", x)
        if self.world == 1:
            return x.clone()
        s = -1 if reverse else 1
        send = x.cpu() if self.staged else x
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send,
                          self._peers[(self.rank + s) % self.world],
                          self.group),
               dist.P2POp(dist.irecv, recv,
                          self._peers[(self.rank - s) % self.world],
                          self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(self.device) if self.staged else recv

    def _exchange(self, x: torch.Tensor) -> torch.Tensor:
        self._record("all_to_all", x)
        if self._solo:
            return x.clone()
        src = x.cpu() if self.staged else x
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return out.to(self.device) if self.staged else out

    def ring_shift(self, xs: Sequence[torch.Tensor]) -> list:
        """Send this rank's value to rank + 1 (mod world) and receive
        rank - 1's, in one `batch_isend_irecv` (the JAX ``ppermute`` with ``perm = [(i, (i +
        1) % W)]``); its backward is the reverse hop.  The received
        buffer has the shape and dtype of the rank's own send; every rank
        of the ring sends the same shape.  The receive is complete when
        this returns: the requests are waited on, which on NCCL orders
        the current stream after the transfer."""
        return [_Shift.apply(self, self._check(xs))]

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        self._record("all_gather", x)
        if self._solo:
            return x[None].clone()
        src = x.cpu() if self.staged else x
        # 2-byte floats travel as their bits (gloo has no bf16 type)
        bits = src.view(torch.int16) if src.element_size() == 2 else src
        out = torch.empty((self.world,) + tuple(src.shape), dtype=bits.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(out.reshape(-1), bits.reshape(-1),
                                    group=self.group)
        out = out.view(src.dtype)
        return out.to(self.device) if self.staged else out

    def all_gather(self, xs: Sequence[torch.Tensor]) -> list:
        """The (world, ...) stack of every rank's value, in rank order:
        one all-gather into a single tensor (at world 1 too, so the
        backend's collective runs on a one-card machine)."""
        return [self._gather(self._check(xs))]

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> list:
        """This rank's (world, ...) stack, row j sent to rank j; returns
        the (world, ...) stack of every rank's row for this one, in rank
        order: one `dist.all_to_all_single` (at world 1 too); its
        backward is the same exchange of the gradient.  Under nccl the
        receive is ordered on the current stream, and the host does not
        wait; gloo stages through host memory and waits."""
        x = self._check(xs)
        if x.shape[0] != self.world:
            raise ValueError(f"all_to_all sends one row per rank: leading "
                             f"axis {x.shape[0]}, world {self.world}")
        return [_AllToAll.apply(self, x)]

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

    def psum(self, xs: Sequence[torch.Tensor]) -> list:
        """The SUM that carries gradients (module docstring): `sum`
        forward, the same all-gather and rank-order sum of the incoming
        gradient backward, bitwise the `LocalMesh`'s ``psum``."""
        x = self._check(xs)
        if self._solo:
            return [x]
        return [_Psum.apply(self, x)]


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


def make_mesh(dp: Optional[int] = 1, sp: int = 1, device="cuda", *,
              tp: int = 1):
    """A dp x sp x tp mesh (the JAX ``make_mesh(dp=, tp=, sp=)``):
    ``dp * sp * tp`` `LocalMesh` ranks on ``device``, or, with
    ``dp=None``, this process's rank of the `torch.distributed` group as
    a `ProcessMesh` whose processes form ``world // (sp * tp)`` dp ranks
    x ``sp`` x ``tp``."""
    if dp is None:
        return ProcessMesh(device, sp=sp, tp=tp)
    return LocalMesh(dp * sp * tp, device, sp=sp, tp=tp)
