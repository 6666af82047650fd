"""Host-side metric plumbing (port of `cpd_tpu/train/metrics.py`): the
run's resilience counters, the divergence check, the averaging meter and
top-k accuracy.  Pure Python and numpy."""

from __future__ import annotations

import math
import sys
from collections import deque
from typing import Sequence

import numpy as np

__all__ = ["AverageMeter", "accuracy", "loss_diverged", "ResilienceMeter"]


class ResilienceMeter:
    """Run-level resilience counters, one place, one spelling.

    *Mirrored* counters are copied from a step's metrics
    (`observe_metrics`; absent keys leave them alone); *host* counters
    are the loop's own decisions (`bump`): the wire faults the verified
    reduce detected, the ladder's retries, downgrades, upgrades and
    resyncs, the planned faults that never fired.  ``suffix()`` renders
    the non-zero ones for the log line; ``as_dict`` goes into the
    trainer's result."""

    MIRRORED = {"guard_skipped": "steps_skipped",
                "guard_overflows": "overflows",
                "guard_spikes": "spikes",
                "guard_disagreements": "disagreements",
                "faults_injected": "faults_injected"}
    HOST = ("rollbacks", "restores", "watchdog_trips", "preemptions",
            "batches_dropped", "batches_duplicated", "ckpts_invalid",
            "wire_faults_detected", "reduce_retries",
            "transport_downgrades", "transport_upgrades", "resyncs",
            "ckpts_unverified", "faults_unfired",
            "sat_hot_steps", "precision_escalations",
            "precision_deescalations",
            "elastic_shrinks", "elastic_regrows", "elastic_drains",
            "elastic_hot_steps", "elastic_heartbeat_misses",
            "elastic_link_retries", "elastic_link_escalations")
    FIELDS = tuple(MIRRORED.values()) + HOST
    SHORT = {"steps_skipped": "skip", "overflows": "ovf",
             "spikes": "spike", "disagreements": "disagree",
             "faults_injected": "inj", "rollbacks": "rollback",
             "restores": "restore", "watchdog_trips": "wdog",
             "preemptions": "preempt", "batches_dropped": "drop",
             "batches_duplicated": "dup", "ckpts_invalid": "badckpt",
             "wire_faults_detected": "wire", "reduce_retries": "retry",
             "transport_downgrades": "down", "transport_upgrades": "up",
             "resyncs": "resync", "ckpts_unverified": "unvckpt",
             "faults_unfired": "unfired", "sat_hot_steps": "hot",
             "precision_escalations": "esc",
             "precision_deescalations": "deesc",
             "elastic_shrinks": "shrink", "elastic_regrows": "regrow",
             "elastic_drains": "drain", "elastic_hot_steps": "ehot",
             "elastic_heartbeat_misses": "miss",
             "elastic_link_retries": "lretry",
             "elastic_link_escalations": "lesc"}

    def __init__(self):
        self.counts = {f: 0 for f in self.FIELDS}

    def observe_metrics(self, metrics: dict) -> None:
        for key, field in self.MIRRORED.items():
            if key in metrics:
                self.counts[field] = int(metrics[key])

    def bump(self, field: str, n: int = 1) -> None:
        if field not in self.counts:
            raise KeyError(f"unknown resilience counter {field!r}; know "
                           f"{sorted(self.counts)}")
        self.counts[field] += n

    def __getitem__(self, field: str) -> int:
        return self.counts[field]

    def as_dict(self) -> dict:
        return dict(self.counts)

    def suffix(self) -> str:
        """' wire 2 retry 1': the non-zero counters only, so a healthy
        run's log lines read as they did without the meter."""
        parts = [f"{self.SHORT[f]} {v}" for f, v in self.counts.items()
                 if v]
        return (" " + " ".join(parts)) if parts else ""


def loss_diverged(loss: float, where: str, rank: int,
                  hint: str = "try --use_APS / more mantissa bits") -> bool:
    """True, with a rank-0 line on stderr, when ``loss`` is not finite.
    The loss is the global one, so every rank takes the same branch."""
    if math.isfinite(loss):
        return False
    if rank == 0:
        print(f"=> non-finite loss {loss} at {where} — diverged "
              f"({hint})", file=sys.stderr)
    return True


class AverageMeter:
    """The current value, a windowed average (``length`` > 0: of the
    last ``length`` updates) or the running average (``length`` 0)."""

    def __init__(self, length: int = 0):
        self.length = length
        self.reset()

    def reset(self):
        self.history = deque(maxlen=self.length or None)
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        val = float(val)
        self.val = val
        if self.length > 0:
            self.history.append(val)
            self.avg = sum(self.history) / len(self.history)
        else:
            self.sum += val * n
            self.count += n
            self.avg = self.sum / max(self.count, 1)


def accuracy(output, target, topk: Sequence[int] = (1,)):
    """Top-k precision of (B, C) scores against (B,) labels, in
    percent, one float per k."""
    output = np.asarray(output)
    target = np.asarray(target)
    maxk = max(topk)
    pred = np.argsort(-output, axis=1)[:, :maxk]
    correct = pred == target[:, None]
    batch = target.shape[0]
    return [100.0 * correct[:, :k].any(axis=1).sum() / batch for k in topk]
