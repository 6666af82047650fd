"""The degraded-transport ladder of the verified reduce (port of
`cpd_tpu/resilience/transport.py`).

When ``sum_gradients(..., verify=True)`` reports a failed step (a hop
tag mismatch, a gather-row mismatch or cross-rank disagreement,
`parallel.ring`), something between the ranks is lying.  The response
is a host-side state machine:

    ring --(retries spent)--> faithful --(again)--> fp32
      ^                           |                   |
      +---- N clean steps --------+---- N clean ------+

* **retry**: the step's update is discarded and the next step runs at
  the same rung (a transient wire fault clears; a deterministic
  injected one does not, which forces the next rung).  At most
  ``max_retries`` in a row.
* **downgrade**: one rung down: the ring's packed wire gives way to the
  faithful gather, and the gather to the fp32 sum of fast mode.
* **probation**: after ``probation`` clean verified steps on a degraded
  rung, one rung back up, never above the configured home.
* **give_up**: a failure on the bottom rung is not a transport problem;
  the loop stops.

The supervisor is pure host state (no RNG, no clock), so a run under a
deterministic fault plan replays its exact transitions.
"""

from __future__ import annotations

from typing import Callable, Optional

__all__ = ["TransportSupervisor", "StepTable", "level_reduce_kwargs"]


class TransportSupervisor:
    """The ring -> faithful -> fp32 ladder (module docstring).

    ``on_failure(step)`` -> "retry" | "downgrade" | "give_up";
    ``on_success(step)`` -> "upgrade" | None.  ``mode`` names the rung
    whose step the loop runs next; ``transitions`` is the (step, from,
    to) log, the newest `TRANSITION_CAP` entries."""

    LEVELS = ("ring", "faithful", "fp32")

    TRANSITION_CAP = 4096

    def __init__(self, start: str = "ring", max_retries: int = 1,
                 probation: int = 8):
        if start not in self.LEVELS:
            raise ValueError(f"unknown transport level {start!r}; know "
                             f"{self.LEVELS}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if probation < 1:
            raise ValueError(f"probation must be >= 1, got {probation}")
        self._home = self.LEVELS.index(start)
        self._level = self._home
        self.max_retries = max_retries
        self.probation = probation
        self.retries = 0          # failures in a row at this step
        self.clean = 0            # clean steps in a row at this rung
        self.transitions: list = []

    @property
    def mode(self) -> str:
        return self.LEVELS[self._level]

    @property
    def home(self) -> str:
        """The configured rung: probation's ceiling."""
        return self.LEVELS[self._home]

    @property
    def degraded(self) -> bool:
        return self._level > self._home

    def on_failure(self, step: int) -> str:
        """A verified reduce failed at ``step``: retry, downgrade or
        give up.  Either way the clean streak restarts."""
        self.clean = 0
        if self.retries < self.max_retries:
            self.retries += 1
            return "retry"
        self.retries = 0
        if self._level + 1 < len(self.LEVELS):
            old = self.mode
            self._level += 1
            self._record(step, old)
            return "downgrade"
        return "give_up"

    def on_success(self, step: int) -> Optional[str]:
        """A verified reduce passed at ``step``: "upgrade" when the
        clean streak earns a rung back."""
        self.retries = 0
        self.clean += 1
        if self._level > self._home and self.clean >= self.probation:
            old = self.mode
            self._level -= 1
            self.clean = 0
            self._record(step, old)
            return "upgrade"
        return None

    def _record(self, step: int, old: str) -> None:
        self.transitions.append((step, old, self.mode))
        if len(self.transitions) > self.TRANSITION_CAP:
            del self.transitions[0]


def level_reduce_kwargs(level: str, grad_exp: int, grad_man: int) -> dict:
    """The `sum_gradients` mode and format of one rung: the fp32 rung
    is fast mode at (8, 23), an fp32 sum with no wire of its own."""
    if level == "ring":
        return dict(mode="ring", grad_exp=grad_exp, grad_man=grad_man)
    if level == "faithful":
        return dict(mode="faithful", grad_exp=grad_exp, grad_man=grad_man)
    if level == "fp32":
        return dict(mode="fast", grad_exp=8, grad_man=23)
    raise ValueError(f"unknown transport level {level!r}; know "
                     f"{TransportSupervisor.LEVELS}")


class StepTable:
    """``level -> step``, each rung's step built by ``build(level)`` at
    its first use and kept."""

    def __init__(self, build: Callable[[str], Callable]):
        self._build = build
        self._cache: dict = {}

    def __getitem__(self, level: str) -> Callable:
        if level not in self._cache:
            self._cache[level] = self._build(level)
        return self._cache[level]

    def __contains__(self, level: str) -> bool:
        return True
