"""The fault-plan grammar (port of the plan half of
`cpd_tpu/resilience/inject.py`).

A `FaultPlan` is an immutable, seed-reproducible schedule of `FaultSpec`
entries, written as

    kind@step[:arg[:arg2]][;kind@step[:arg[:arg2]]...]

(or a path to a JSON file written by `FaultPlan.to_json`), e.g.
``wire_flip@2:1;wire_drop@5``.  ``step`` is the 0-based optimizer-update
index.  ``arg`` is the target RANK for the ``wire_*`` kinds (-1: rank
0); ``arg2`` exists only for the two-argument elastic kinds.

The port executes the ``wire_*`` kinds: `wire_schedule` gives the dense
(codes, ranks) table that `train.step.make_train_step(wire_fault_plan=)`
reads, and the ring corrupts its hop payload and gather row on that rank
at that step.  The other kinds parse (the tables are the reference's)
but nothing in the port executes them yet: `not_ported_kinds` names the
ROADMAP item each waits for, and `report_unfired` counts them as never
fired.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import sys
from typing import Optional

import numpy as np

__all__ = ["FaultSpec", "FaultPlan", "report_unfired", "not_ported_kinds",
           "GRAD_KINDS", "HOST_KINDS", "WIRE_KINDS", "SAT_KINDS",
           "KV_KINDS", "SERVE_KINDS", "FLEET_KINDS", "ELASTIC_KINDS",
           "STORE_KINDS"]

# in-step gradient corruption -> opcode
GRAD_KINDS = {"grad_nan": 1, "grad_inf": 2, "grad_blowup": 3}
# ring wire corruption -> opcode (parallel/ring.py `_corrupt`)
WIRE_KINDS = {"wire_flip": 1, "wire_stale": 2, "wire_drop": 3}
# the precision ladder's saturation pressure: scale by 2^arg
SAT_KINDS = frozenset({"sat_pressure"})
# the serving engine's KV-page flip, on the engine's step clock
KV_KINDS = frozenset({"kv_flip"})
# serving chaos, on the engine's step clock
SERVE_KINDS = frozenset({"kv_storm", "slot_stall", "req_burst"})
# fleet chaos, on the fleet's step clock
FLEET_KINDS = frozenset({"engine_kill", "kill_wave"})
# whole-host faults of elastic training: host_kill@s:h[:r],
# straggler@s:h:f, link_flaky@s:h:p
ELASTIC_KINDS = frozenset({"host_kill", "straggler", "link_flaky"})
# storage chaos, on the durable store's publish clock
STORE_KINDS = frozenset({"store_torn", "store_flip", "store_eio",
                         "store_enospc"})
# host-level faults around the step call
HOST_KINDS = frozenset({
    "batch_nan", "batch_scale", "data_drop", "data_dup", "stall",
    "preempt", "ckpt_truncate", "ckpt_bitflip", "loss_spike"})
_ALL_KINDS = (frozenset(GRAD_KINDS) | HOST_KINDS | frozenset(WIRE_KINDS)
              | SAT_KINDS | KV_KINDS | SERVE_KINDS | FLEET_KINDS
              | ELASTIC_KINDS | STORE_KINDS)

# the ROADMAP Queue A item whose executor each unported family waits for
_NOT_PORTED = ((frozenset(GRAD_KINDS) | HOST_KINDS | SAT_KINDS
                | ELASTIC_KINDS, "A10"),
               (KV_KINDS | SERVE_KINDS | FLEET_KINDS, "A9"),
               (STORE_KINDS, "A11"))


@dataclasses.dataclass(frozen=True, order=True)
class FaultSpec:
    """One scheduled fault (module docstring); ``arg2`` stays -1.0 but
    for the elastic kinds."""
    step: int
    kind: str
    arg: float = -1.0
    arg2: float = -1.0

    def __post_init__(self):
        if self.kind not in _ALL_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; know "
                             f"{sorted(_ALL_KINDS)}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable schedule of faults, sorted; equality is structural,
    so the same seed and spec give equal plans."""
    faults: tuple = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(sorted(self.faults)))

    def __len__(self) -> int:
        return len(self.faults)

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """The ``kind@step[:arg[:arg2]]`` grammar, or the JSON file that
        ``text`` names."""
        text = text.strip()
        if not text:
            return cls((), seed)
        if os.path.exists(text):
            with open(text) as f:
                return cls.from_json(f.read())
        faults = []
        for part in text.replace(",", ";").split(";"):
            part = part.strip()
            if not part:
                continue
            try:
                kind, rest = part.split("@", 1)
                fields = rest.split(":", 2)
                if len(fields) > 2 and kind.strip() not in ELASTIC_KINDS:
                    raise ValueError(
                        f"arg2 only exists for the elastic kinds "
                        f"{sorted(ELASTIC_KINDS)}")
                arg = float(fields[1]) if len(fields) > 1 else -1.0
                arg2 = float(fields[2]) if len(fields) > 2 else -1.0
                faults.append(FaultSpec(int(fields[0]), kind.strip(), arg,
                                        arg2))
            except ValueError as e:
                raise ValueError(
                    f"bad fault spec {part!r} (want "
                    f"kind@step[:arg[:arg2]]): {e}") from e
        return cls(tuple(faults), seed)

    @classmethod
    def random(cls, seed: int, n_steps: int,
               rates: Optional[dict] = None) -> "FaultPlan":
        """Each kind fires at each step with probability ``rates[kind]``
        (default: a light mix of gradient faults and stalls), drawn from
        Python's `random.Random(seed)` as the reference draws them."""
        rates = rates or {"grad_nan": 0.02, "grad_blowup": 0.02,
                          "stall": 0.01}
        rng = random.Random(seed)
        faults = []
        for step in range(n_steps):
            for kind in sorted(rates):
                if rng.random() < rates[kind]:
                    arg = (rng.uniform(0.2, 1.0) if kind == "stall"
                           else -1.0)
                    faults.append(FaultSpec(step, kind, arg))
        return cls(tuple(faults), seed)

    @classmethod
    def from_json(cls, blob: str) -> "FaultPlan":
        doc = json.loads(blob)
        return cls(tuple(FaultSpec(f["step"], f["kind"],
                                   float(f.get("arg", -1.0)),
                                   float(f.get("arg2", -1.0)))
                         for f in doc["faults"]),
                   int(doc.get("seed", 0)))

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "faults": [dataclasses.asdict(f)
                                      for f in self.faults]}, indent=2)

    def counts(self) -> dict:
        out: dict = {}
        for f in self.faults:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out

    def _of(self, kinds) -> tuple:
        return tuple(f for f in self.faults if f.kind in kinds)

    def grad_faults(self) -> tuple:
        return self._of(GRAD_KINDS)

    def wire_faults(self) -> tuple:
        return self._of(WIRE_KINDS)

    def sat_faults(self) -> tuple:
        return self._of(SAT_KINDS)

    def kv_faults(self) -> tuple:
        return self._of(KV_KINDS)

    def serve_faults(self) -> tuple:
        return self._of(SERVE_KINDS)

    def fleet_faults(self) -> tuple:
        return self._of(FLEET_KINDS)

    def elastic_faults(self) -> tuple:
        return self._of(ELASTIC_KINDS)

    def store_faults(self) -> tuple:
        return self._of(STORE_KINDS)

    def host_faults(self) -> dict:
        """step -> [FaultSpec] of the host-level kinds."""
        out: dict = {}
        for f in self._of(HOST_KINDS):
            out.setdefault(f.step, []).append(f)
        return out

    def wire_schedule(self, n_steps: int):
        """Dense (codes, ranks) int32 tables for the ring's wire faults,
        entry i for update i: ``arg`` is the target rank (-1: rank 0),
        the last spec of a step wins, specs past ``n_steps`` drop out
        (`report_unfired` counts them)."""
        codes = np.zeros((max(n_steps, 1),), np.int32)
        ranks = np.zeros((max(n_steps, 1),), np.int32)
        for f in self.wire_faults():
            if f.step < n_steps:
                codes[f.step] = WIRE_KINDS[f.kind]
                ranks[f.step] = max(int(f.arg), 0)
        return codes, ranks


def not_ported_kinds(plan: FaultPlan) -> dict:
    """kind -> the ROADMAP Queue A item its executor waits for, for
    every kind of ``plan`` the port does not execute (all but
    ``wire_*``)."""
    out = {}
    for f in plan.faults:
        for kinds, item in _NOT_PORTED:
            if f.kind in kinds:
                out[f.kind] = item
    return out


def report_unfired(plan: Optional[FaultPlan], *,
                   n_steps: Optional[int] = None, meter=None,
                   rank: int = 0, wire_armed: bool = True) -> list:
    """The specs of ``plan`` that never fired: a wire spec scheduled
    past ``n_steps``, every wire spec when ``wire_armed`` is False (the
    run's home rung is not the ring, so no step read the table), and
    every spec of a kind the port has no executor for.  Bumps the
    meter's ``faults_unfired`` and warns on rank 0; returns the sorted
    leftovers (empty: every planned fault fired).  The reference takes
    its `Injector`, whose host one-shots the port does not run."""
    if plan is None:
        return []
    leftover = []
    for f in plan.faults:
        if f.kind in WIRE_KINDS:
            past = n_steps is not None and f.step >= n_steps
            if past or not wire_armed:
                leftover.append(f)
        else:
            leftover.append(f)
    leftover = sorted(set(leftover))
    if leftover:
        if meter is not None:
            meter.bump("faults_unfired", len(leftover))
        if rank == 0:
            print(f"=> fault plan: {len(leftover)} spec(s) never fired "
                  f"(scheduled past the end of the run, or on a hook "
                  f"this loop does not wire): {leftover}",
                  file=sys.stderr)
    return leftover
