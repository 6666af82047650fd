"""Checkpoints and auto-resume (port of the core of
`cpd_tpu/train/checkpoint.py`).

The reference writes a TrainState pytree through orbax; the port writes
its own format with torch and numpy only.  One directory per step,
``<directory>/<step>/``, holds

* ``state.npz``: every tensor of the state as a host array, in a fixed
  order (the module's ``state_dict()``, then the optimizer state's
  tensors; `layout.json` names each), in its own dtype (a bf16 tensor is
  stored as its 16-bit pattern);
* ``layout.json``: the step, each array's name, dtype and shape, the
  optimizer state's structure with its ints and PRNG key, and the
  ``best_metric`` the save was given.

A step is written under ``.tmp-<step>`` and renamed into place, so a
listed step is whole.  With ``integrity`` on (the default) the
``meta-<step>.json`` sidecar beside it records the sha256 digest of the
step's files (`checkpoint_digest`, the reference's function), and
`CheckpointManager.restore_latest_valid` skips a step whose bytes no
longer match it.  The sidecar is written under a temporary name and
renamed, so it is never torn by a crash.

With a `torch.distributed` group of more than one process, rank 0 alone
writes, and a barrier follows every save, so every rank then reads the
same bytes.  A restore copies the module's tensors into the template's
module in place (the train step holds that module) and builds the
optimizer state on the template's devices.

A ZeRO state (`parallel.zero.Zero1State`) is saved as it is: the
portable layout (``export_state``, the CLI's way), or every rank's
shard on a `LocalMesh`.  A process of a multi-process mesh holds its own
shard only, and its save is refused: save ``export_state(state)``.
``restore(world=)`` re-flattens a ZeRO momentum saved for one world
size (or portable) for the template's (`restore`).

Not ported yet: ``store=`` (the durable store, ROADMAP Queue A, A11)
and `PreemptionGuard`/`preempt_save` (A10).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .state import TrainState

__all__ = ["CheckpointManager", "save_checkpoint", "restore_latest",
           "RestoreResult", "checkpoint_digest", "PreemptionGuard",
           "preempt_save"]

_FORMAT = "cpd_tpu_torch.checkpoint/1"


def checkpoint_digest(step_dir: str, exclude: tuple = ()) -> dict:
    """Content checksum of one step's directory: sha256 over (relative
    path, size, bytes) of every file in sorted order, ``exclude``
    skipping files by relative path (the reference's function)."""
    h = hashlib.sha256()
    n_files = 0
    n_bytes = 0
    for root, dirs, files in os.walk(step_dir):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(root, name)
            rel = os.path.relpath(path, step_dir)
            if rel in exclude:
                continue
            size = os.path.getsize(path)
            h.update(rel.encode())
            h.update(str(size).encode())
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            n_files += 1
            n_bytes += size
    return {"algo": "sha256", "digest": h.hexdigest(),
            "files": n_files, "bytes": n_bytes}


class RestoreResult(NamedTuple):
    state: TrainState
    step: int
    skipped: tuple      # steps rejected (bad digest or unrestorable)
    # True: the digest matched; None: no digest was recorded
    # (integrity=False saves), which the caller counts apart
    verified: Any = True
    metadata: Any = None


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what}: not yet ported to cpd_tpu_torch "
                              f"(ROADMAP Queue A, {item})")


class PreemptionGuard:
    """Not ported yet (ROADMAP Queue A, A10)."""

    def __init__(self, *args, **kwargs):
        _not_ported("PreemptionGuard", "A10")


def preempt_save(*args, **kwargs):
    """Not ported yet (ROADMAP Queue A, A10)."""
    _not_ported("preempt_save", "A10")


def _group() -> tuple:
    """(this process's rank, processes) of the default group, (0, 1)
    outside one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    if _group()[1] > 1:
        import torch.distributed as dist

        dist.barrier()


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a host array: bf16 as its int16 pattern."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _encode(x, arrays: list, name: str):
    """The JSON skeleton of an optimizer-state value: a tensor becomes
    ``{"t": i}`` (its array appended), a tuple or list a list, a
    NamedTuple ``{"fields": [...]}``, an int or None itself."""
    if isinstance(x, torch.Tensor):
        arrays.append((name, x))
        return {"t": len(arrays) - 1}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {"fields": [_encode(v, arrays, f"{name}.{f}")
                           for f, v in zip(x._fields, x)]}
    if isinstance(x, (list, tuple)):
        return [_encode(v, arrays, f"{name}.{i}") for i, v in enumerate(x)]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"{name}: cannot checkpoint a {type(x).__name__}")


def _decode(tmpl, skel, tensors: list, name: str):
    """The optimizer-state value shaped like ``tmpl`` from its skeleton,
    each tensor checked against the template's shape and dtype and put
    on the template's device."""
    if isinstance(tmpl, torch.Tensor):
        if not isinstance(skel, dict) or "t" not in skel:
            raise ValueError(f"{name}: saved {skel!r} where the template "
                             f"holds a tensor")
        t = tensors[skel["t"]]
        if tuple(t.shape) != tuple(tmpl.shape) or t.dtype != tmpl.dtype:
            raise ValueError(f"{name}: saved {tuple(t.shape)}/{t.dtype} vs "
                             f"template {tuple(tmpl.shape)}/{tmpl.dtype}")
        return t.to(tmpl.device)
    if isinstance(tmpl, tuple) and hasattr(tmpl, "_fields"):
        fields = skel.get("fields") if isinstance(skel, dict) else None
        if fields is None or len(fields) != len(tmpl):
            raise ValueError(f"{name}: saved {skel!r} does not match "
                             f"{type(tmpl).__name__}")
        return type(tmpl)(*(_decode(t, s, tensors, f"{name}.{f}")
                            for f, t, s in zip(tmpl._fields, tmpl, fields)))
    if isinstance(tmpl, (list, tuple)):
        if not isinstance(skel, list) or len(skel) != len(tmpl):
            raise ValueError(f"{name}: saved {skel!r} does not match a "
                             f"{len(tmpl)}-long {type(tmpl).__name__}")
        return type(tmpl)(_decode(t, s, tensors, f"{name}.{i}")
                          for i, (t, s) in enumerate(zip(tmpl, skel)))
    if tmpl is None:
        if skel is not None:
            raise ValueError(f"{name}: saved {skel!r} where the template "
                             f"holds None")
        return None
    if isinstance(skel, (dict, list)) or skel is None:
        raise ValueError(f"{name}: saved {skel!r} where the template "
                         f"holds {tmpl!r}")
    return type(tmpl)(skel)


def _zero_states(x) -> list:
    """Every `parallel.zero.Zero1State` in an optimizer state."""
    from ..parallel.zero import Zero1State

    if isinstance(x, Zero1State):
        return [x]
    if isinstance(x, (list, tuple)):
        return [z for v in x for z in _zero_states(v)]
    return []


def _saved_zero_shape(tmpl, skel, tensors: list):
    """``tmpl`` with each `Zero1State` shaped as the one saved under
    ``skel`` (its shards' sizes, world and buckets), so it decodes."""
    from ..parallel.zero import Zero1State

    if isinstance(tmpl, Zero1State):
        try:
            _, mom, world, spans = skel["fields"]
            momentum = [torch.empty(tuple(tensors[m["t"]].shape),
                                    dtype=torch.float32) for m in mom]
        except (KeyError, TypeError, ValueError, IndexError):
            return tmpl          # let _decode name the mismatch
        return Zero1State(tmpl.step, momentum, int(world), tuple(spans))
    if isinstance(tmpl, tuple) and hasattr(tmpl, "_fields") and \
            isinstance(skel, dict) and len(skel.get("fields", ())) == \
            len(tmpl):
        return type(tmpl)(*(_saved_zero_shape(t, k, tensors)
                            for t, k in zip(tmpl, skel["fields"])))
    if isinstance(tmpl, (list, tuple)) and isinstance(skel, list) and \
            len(skel) == len(tmpl):
        return type(tmpl)(_saved_zero_shape(t, k, tensors)
                          for t, k in zip(tmpl, skel))
    return tmpl


def _reflatten(saved, tmpl, world: int):
    """``saved`` with each `Zero1State` re-flattened for ``world`` and
    the template's local ranks (all ``world`` of them, or this process's
    one): the saved momentum made portable (its pads trimmed), then
    padded and sharded for the new world, bitwise an ``import_state`` of
    the portable save."""
    from ..parallel.zero import Zero1State, portable_momentum, shards_at

    if isinstance(saved, Zero1State):
        flat = portable_momentum(saved)
        if tuple(saved.spans) != tuple(tmpl.spans):
            raise ValueError(
                f"elastic restore at world={world}: the checkpoint's ZeRO "
                f"buckets {tuple(saved.spans)} do not match the "
                f"template's {tuple(tmpl.spans)} (another model or "
                f"bucket_elems)")
        if tmpl.world == 0:
            return Zero1State(saved.step, [flat.to(tmpl.momentum[0].device)],
                              0, tuple(saved.spans))
        ranks = (range(world) if len(tmpl.momentum) == world
                 else (_group()[0],))
        shards = shards_at(flat, saved.spans, world, ranks)
        for got, want in zip(shards, tmpl.momentum):
            if got.numel() != want.numel():
                raise ValueError(
                    f"elastic restore at world={world}: re-flattened "
                    f"momentum has {got.numel()} elements but the "
                    f"template expects {want.numel()} — template world "
                    f"and `world=` disagree (build the template with the "
                    f"updater for the NEW world size)")
        return Zero1State(saved.step, [s.to(t.device) for s, t in
                                       zip(shards, tmpl.momentum)],
                          world, tuple(saved.spans))
    if isinstance(saved, tuple) and hasattr(saved, "_fields"):
        return type(saved)(*(_reflatten(a, b, world)
                             for a, b in zip(saved, tmpl)))
    if isinstance(saved, (list, tuple)):
        return type(saved)(_reflatten(a, b, world)
                           for a, b in zip(saved, tmpl))
    return saved


def _write_step(path: str, state: TrainState,
                best_metric: Optional[float]) -> None:
    """The step's two files under ``path``."""
    for z in _zero_states(state.opt_state):
        if z.world and len(z.momentum) != z.world:
            raise ValueError(
                f"this process holds {len(z.momentum)} of the {z.world} "
                f"shards of a ZeRO state: save the updater's "
                f"export_state(state, mesh), the portable layout")
    arrays = [(f"model.{k}", v)
              for k, v in state.model.state_dict().items()]
    opt = _encode(state.opt_state, arrays, "opt")
    hosts = [_host(t) for _, t in arrays]
    layout = {"format": _FORMAT, "step": int(state.step),
              "best_metric": (None if best_metric is None
                              else float(best_metric)),
              "arrays": [{"name": n, "dtype": str(t.dtype).replace(
                  "torch.", ""), "shape": list(t.shape)}
                  for n, t in arrays],
              "opt": opt}
    os.makedirs(path)
    with open(os.path.join(path, "state.npz"), "wb") as f:
        np.savez(f, **{f"a{i:06d}": h for i, h in enumerate(hosts)})
    with open(os.path.join(path, "layout.json"), "w") as f:
        json.dump(layout, f, sort_keys=True)


def _read_step(path: str) -> tuple:
    """(layout, tensors on the host) of a step directory, every array
    checked against its recorded dtype and shape."""
    with open(os.path.join(path, "layout.json")) as f:
        layout = json.load(f)
    if layout.get("format") != _FORMAT:
        raise ValueError(f"{path}: not a {_FORMAT} checkpoint")
    tensors = []
    with np.load(os.path.join(path, "state.npz"),
                 allow_pickle=False) as z:
        for i, rec in enumerate(layout["arrays"]):
            t = torch.from_numpy(np.array(z[f"a{i:06d}"]))
            want = getattr(torch, rec["dtype"])
            if want == torch.bfloat16:
                t = t.view(torch.bfloat16)
            if t.dtype != want or list(t.shape) != rec["shape"]:
                raise ValueError(f"{path}: array {rec['name']} is "
                                 f"{tuple(t.shape)}/{t.dtype}, recorded "
                                 f"{rec['shape']}/{rec['dtype']}")
            tensors.append(t)
    return layout, tensors


class CheckpointManager:
    """Step-indexed checkpoints in ``directory`` (module docstring),
    with the reference's retention: at most ``max_to_keep`` steps, the
    newest ones, or with ``track_best`` the best ``max_to_keep`` by
    their ``best_metric`` (higher is better; steps saved without one are
    always kept), as orbax's `BestN` keeps them.  ``integrity`` records
    each step's digest in its sidecar."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 track_best: bool = True, integrity: bool = True,
                 store=None):
        if store is not None:
            _not_ported("CheckpointManager(store=)", "A11")
        self._dir = os.path.abspath(directory)
        self._keep = int(max_to_keep)
        self._best = track_best
        self._integrity = integrity
        self._rank = _group()[0]
        if self._rank == 0:
            os.makedirs(self._dir, exist_ok=True)
        _barrier()

    @property
    def directory(self) -> str:
        return self._dir

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(step))

    def all_steps(self) -> list:
        """The saved steps, ascending."""
        if not os.path.isdir(self._dir):
            return []
        return sorted(int(n) for n in os.listdir(self._dir)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self._dir, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             best_metric: Optional[float] = None, force: bool = False,
             metadata: Optional[dict] = None) -> None:
        """Save ``state`` as step ``step``; ``force`` replaces a step
        already saved (without it that raises).  ``metadata``: a small
        JSON-able dict for the sidecar, beside the digest.  Rank 0
        writes; every rank returns after the barrier."""
        try:
            if self._rank == 0:
                self._save(int(step), state, best_metric, force, metadata)
        finally:
            _barrier()

    def _save(self, step: int, state: TrainState, best_metric, force,
              metadata) -> None:
        final = self._step_dir(step)
        if os.path.exists(final):
            if not force:
                raise FileExistsError(f"checkpoint step {step} already "
                                      f"exists in {self._dir}")
            shutil.rmtree(final)
        tmp = os.path.join(self._dir, f".tmp-{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        _write_step(tmp, state, best_metric)
        os.replace(tmp, final)
        if self._integrity:
            metadata = dict(metadata or {})
            metadata["integrity"] = checkpoint_digest(final)
        meta_path = os.path.join(self._dir, f"meta-{step}.json")
        if metadata is not None:
            tmp_meta = os.path.join(self._dir, f".meta-{step}.json.tmp")
            with open(tmp_meta, "w") as f:
                json.dump(metadata, f)
            os.replace(tmp_meta, meta_path)
        elif os.path.exists(meta_path):
            os.remove(meta_path)
        self._retain()

    def _metric(self, step: int) -> Optional[float]:
        try:
            with open(os.path.join(self._step_dir(step),
                                   "layout.json")) as f:
                return json.load(f).get("best_metric")
        except (OSError, ValueError):
            return None

    def _retain(self) -> None:
        """Delete the steps retention does not keep, and sidecars whose
        step is gone."""
        steps = self.all_steps()
        if len(steps) > self._keep:
            if self._best:
                scored = [(m, s) for s in steps
                          if (m := self._metric(s)) is not None]
                ranked = [s for _, s in sorted(scored, key=lambda p: p[0])]
                keep = set(ranked[-self._keep:] if self._keep else [])
                keep |= {s for s in steps if self._metric(s) is None}
            else:
                keep = set(steps[-self._keep:] if self._keep else [])
            for s in steps:
                if s not in keep:
                    shutil.rmtree(self._step_dir(s), ignore_errors=True)
        live = set(self.all_steps())
        for name in os.listdir(self._dir):
            if name.startswith("meta-") and name.endswith(".json"):
                num = name[len("meta-"):-len(".json")]
                if num.isdigit() and int(num) not in live:
                    os.remove(os.path.join(self._dir, name))

    def _read_sidecar(self, step: int) -> tuple:
        """``("ok", dict)``, ``("absent", None)`` or ``("torn", None)``
        for a sidecar that exists and does not parse."""
        path = os.path.join(self._dir, f"meta-{step}.json")
        if not os.path.exists(path):
            return "absent", None
        try:
            with open(path) as f:
                return "ok", json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError, OSError):
            return "torn", None

    def verify_step(self, step: int) -> Optional[bool]:
        """True: the step's files match the recorded digest; False: they
        do not, or the sidecar is torn, or the files are unreadable;
        None: no digest was recorded."""
        status, meta = self._read_sidecar(step)
        if status == "torn":
            return False
        recorded = (meta or {}).get("integrity")
        if not recorded:
            return None
        try:
            actual = checkpoint_digest(self._step_dir(step))
        except OSError:
            return False
        return actual["digest"] == recorded["digest"]

    def metadata(self, step: Optional[int] = None) -> Optional[dict]:
        """The sidecar of ``step`` (default: the latest), None when it
        is absent or torn."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return self._read_sidecar(step)[1]

    def wait(self) -> None:
        """Saves are synchronous; kept for the reference's API."""

    def restore(self, state_template: TrainState,
                step: Optional[int] = None,
                world: Optional[int] = None) -> Optional[TrainState]:
        """Step ``step`` (default: the latest) shaped like
        ``state_template``, or None when there is none.  Every array is
        read and checked before anything is copied, so a step that
        fails to restore leaves the template as it was.  ``world``: the
        elastic ZeRO restart: a `parallel.zero.Zero1State` saved for
        another world size, or portable, is re-flattened for ``world``
        and the template's local ranks (the saved momentum's pads
        trimmed, then padded for ``world``: the pads hold exact zeros,
        so it is bitwise an ``import_state`` of the portable save); a
        template whose layout disagrees raises."""
        if step is None:
            step = self.latest_step()
        if step is None or not os.path.isdir(self._step_dir(step)):
            return None
        layout, tensors = _read_step(self._step_dir(step))
        own = state_template.model.state_dict()
        names = [r["name"] for r in layout["arrays"]]
        model_names = [n for n in names if n.startswith("model.")]
        if model_names != [f"model.{k}" for k in own]:
            raise ValueError(f"checkpoint step {step}: module tensors "
                             f"{model_names[:4]}... do not match the "
                             f"template's {list(own)[:4]}...")
        for (k, t), saved in zip(own.items(), tensors):
            if tuple(saved.shape) != tuple(t.shape) or saved.dtype != t.dtype:
                raise ValueError(f"checkpoint step {step}: {k} saved "
                                 f"{tuple(saved.shape)}/{saved.dtype} vs "
                                 f"{tuple(t.shape)}/{t.dtype}")
        tmpl_opt = state_template.opt_state
        if world is not None:
            tmpl_opt = _saved_zero_shape(tmpl_opt, layout["opt"], tensors)
        opt_state = _decode(tmpl_opt, layout["opt"], tensors, "opt")
        if world is not None:
            opt_state = _reflatten(opt_state, state_template.opt_state,
                                   int(world))
        with torch.no_grad():
            for t, saved in zip(own.values(), tensors):
                t.copy_(saved)
        return TrainState(step=int(layout["step"]),
                          model=state_template.model, opt_state=opt_state)

    def restore_latest_valid(self, state_template: TrainState,
                             rank: int = 0,
                             world: Optional[int] = None
                             ) -> Optional[RestoreResult]:
        """The newest step that passes its digest and restores; steps
        that fail either are skipped with a rank-0 line on stderr and
        listed in ``skipped``.  A step with no recorded digest restores
        with ``verified`` None.  None when no step survives.  ``world``:
        the elastic ZeRO re-flatten of `restore`."""
        skipped = []
        for step in sorted(self.all_steps(), reverse=True):
            verdict = self.verify_step(step)
            if verdict is False:
                if rank == 0:
                    print(f"=> checkpoint {step}: integrity digest "
                          f"mismatch — skipping", file=sys.stderr)
                skipped.append(step)
                continue
            try:
                state = self.restore(state_template, step=step,
                                     world=world)
            except Exception as e:
                if rank == 0:
                    print(f"=> checkpoint {step}: restore failed "
                          f"({type(e).__name__}: {e}) — skipping",
                          file=sys.stderr)
                skipped.append(step)
                continue
            if verdict is None and rank == 0:
                print(f"=> checkpoint {step}: restored WITHOUT an "
                      f"integrity digest — corruption would be "
                      f"undetectable here", file=sys.stderr)
            return RestoreResult(state, step, tuple(skipped),
                                 verified=verdict,
                                 metadata=self.metadata(step))
        return None

    def close(self) -> None:
        """Nothing stays open; kept for the reference's API."""


def save_checkpoint(directory: str, step: int, state: TrainState,
                    best_metric: Optional[float] = None) -> None:
    """One save, replacing a step already there."""
    mgr = CheckpointManager(directory, track_best=best_metric is not None)
    mgr.save(step, state, best_metric=best_metric, force=True)
    mgr.close()


def restore_latest(directory: str,
                   state_template: TrainState) -> Optional[TrainState]:
    """The newest checkpoint in ``directory`` shaped like the template,
    or None."""
    if not os.path.isdir(directory):
        return None
    mgr = CheckpointManager(directory, track_best=False)
    try:
        return mgr.restore(state_template)
    finally:
        mgr.close()
