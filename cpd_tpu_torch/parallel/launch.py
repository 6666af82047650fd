"""Start W ranks as W processes on this host, as torchrun would, and
collect what each returns (the port's counterpart of the JAX package's
multi-process test launch).

    results = spawn(fn, world, args=(...), timeout=120)

The ranks are `torch.multiprocessing.start_processes`' (the ``spawn``
start method: fresh interpreters, so a card already in use in the parent
is never inherited).  Each rank's environment holds torchrun's
variables: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``
and the rendezvous ``MASTER_ADDR``/``MASTER_PORT`` (a free port on
localhost).  It runs ``fn(*args)``, which joins the group with
`parallel.dist.dist_init` and its own choice of backend; the group is
destroyed when ``fn`` returns.  ``fn`` must be importable by name (a
module-level function) and return something picklable.

A rank that raises or dies fails the whole launch: the process context
stops the other ranks and `spawn` raises with that rank's traceback.  At
the deadline every rank still running is killed and `spawn` raises.  No
rank's failure is swallowed.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
from typing import Callable, Optional, Sequence

from ..obs.timing import now

__all__ = ["spawn"]

# seconds between two reads of the ranks' answers while they run
_POLL = 0.5


def _free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, port: int,
               args: Sequence, env: Optional[dict], results) -> None:
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world),
                       "MASTER_ADDR": "localhost",
                       "MASTER_PORT": str(port)})
    os.environ.update(env or {})
    try:
        out = fn(*args)
    finally:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    results.put((rank, out))


def spawn(fn: Callable, world: int, *, args: Sequence = (),
          timeout: float = 600.0, env: Optional[dict] = None) -> list:
    """Run ``fn(*args)`` in ``world`` rank processes; return their
    results in rank order.  ``env`` adds variables to every rank's
    environment.  Raises `RuntimeError` when a rank fails or the
    deadline passes (module docstring)."""
    import torch.multiprocessing as tmp
    from torch.multiprocessing.spawn import ProcessException

    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    results = mp.get_context("spawn").SimpleQueue()
    procs = tmp.start_processes(
        _rank_main, args=(fn, world, _free_port(), tuple(args), env,
                          results),
        nprocs=world, join=False, start_method="spawn")
    done: dict = {}
    deadline = now() + timeout

    def drain():
        # a rank's put blocks until its answer is read: read while waiting
        while not results.empty():
            rank, out = results.get()
            done[rank] = out

    try:
        while True:
            try:
                finished = procs.join(timeout=_POLL)
            except ProcessException as e:
                trace = procs.error_files[e.error_index]
                if os.path.exists(trace):
                    os.unlink(trace)
                raise RuntimeError(f"1 of {world} ranks failed:\nrank "
                                   f"{e.error_index}: {e}") from None
            drain()
            if finished:
                break
            if now() > deadline:
                raise RuntimeError(
                    f"ranks {sorted(set(range(world)) - set(done))} of "
                    f"{world} gave no answer within {timeout:.0f} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
    missing = sorted(set(range(world)) - set(done))
    if missing:
        raise RuntimeError(f"ranks {missing} of {world} exited without an "
                           "answer")
    return [done[r] for r in range(world)]
