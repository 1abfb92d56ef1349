"""Fault-tolerance primitives for the training loop (a copy of
``repro/train/fault_tolerance.py``, which imports no framework; the port
keeps its own copy rather than import the JAX package).

At 1000+ nodes, *something* is always failing: the loop must treat
preemption/node-loss as a normal control-flow path, not an exception. The
pieces:

* :class:`FailurePlan` — deterministic fault injection for tests ("die at
  step 7", "preempt at step 12"), so restart logic is exercised in CI.
* :class:`StragglerDetector` — rolling median step-time watchdog; flags
  hosts whose step time exceeds ``factor`` × median. The data-fabric
  counterpart is the swarm's endgame mode (duplicate the tail pieces); the
  trainer counterpart here is surfacing the slow host for the scheduler to
  replace (at dry-run scale we log + count).
* :func:`run_with_restarts` — supervisor that restarts a step-loop closure
  from the latest checkpoint after each simulated failure, up to a budget.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


class SimulatedFailure(RuntimeError):
    """Injected node failure (hard crash: lose all in-memory state)."""


class Preemption(RuntimeError):
    """Injected preemption (grace period: allowed to checkpoint first)."""


@dataclasses.dataclass
class FailurePlan:
    crash_at_steps: tuple[int, ...] = ()
    preempt_at_steps: tuple[int, ...] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.crash_at_steps and ("c", step) not in self._fired:
            self._fired.add(("c", step))
            raise SimulatedFailure(f"injected crash at step {step}")
        if step in self.preempt_at_steps and ("p", step) not in self._fired:
            self._fired.add(("p", step))
            raise Preemption(f"injected preemption at step {step}")


@dataclasses.dataclass
class StragglerDetector:
    factor: float = 3.0
    window: int = 32
    _times: list = dataclasses.field(default_factory=list)
    flagged: int = 0

    def observe(self, step_seconds: float) -> bool:
        """Record a step time; True if this step is a straggler."""
        self._times.append(step_seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 5:
            return False
        med = sorted(self._times)[len(self._times) // 2]
        if step_seconds > self.factor * max(med, 1e-9):
            self.flagged += 1
            return True
        return False


def run_with_restarts(
    run_fn: Callable[[], int],
    max_restarts: int = 3,
    on_restart: Optional[Callable[[int, Exception], None]] = None,
) -> tuple[int, int]:
    """Supervisor: run ``run_fn`` (which resumes from the latest checkpoint
    internally) until it returns its final step, restarting on injected
    failures. Returns (final_step, restarts_used)."""
    restarts = 0
    while True:
        try:
            return run_fn(), restarts
        except (SimulatedFailure, Preemption) as e:
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError("restart budget exhausted") from e
            if on_restart is not None:
                on_restart(restarts, e)
