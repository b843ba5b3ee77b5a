"""Fault tolerance at the fleet level: straggler detection + elastic re-mesh.

* ``StepWatchdog`` — records per-step wall times; flags stragglers with the
  robust median + k·MAD rule.  On a real fleet the flag feeds the scheduler
  (hot-spare swap / slice reconfiguration); here it also powers tests and the
  training log.
* ``ElasticPlan`` — given a surviving device count, pick the largest feasible
  (pods, dp, tp) factorization keeping TP fixed (model must still fit), and
  restore the latest checkpoint with the new mesh's shardings (the
  checkpoint format is sharding-agnostic — see checkpoint/ckpt.py).
* ``run_with_restarts`` — supervisor loop: run the train function; on a
  (simulated or real) failure, rebuild the mesh from survivors and resume
  from the last checkpoint.  This is the single-process skeleton of the
  coordinator logic a 1000-node deployment runs per-job.

Port of ``repro/distributed/elastic.py`` (the home of ``StepWatchdog``),
copied whole with the package renamed.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class StragglerReport:
    step: int
    duration: float
    median: float
    mad: float
    threshold: float


class StepWatchdog:
    def __init__(self, k: float = 5.0, window: int = 50, min_steps: int = 10):
        self.k = k
        self.window = window
        self.min_steps = min_steps
        self.durations: List[float] = []
        self.flags: List[StragglerReport] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> Optional[StragglerReport]:
        if self._t0 is None:
            raise ValueError("StepWatchdog.stop() before start()")
        dt = time.monotonic() - self._t0
        self._t0 = None
        self._step += 1
        report = self.observe(self._step, dt)
        return report

    def observe(self, step: int, duration: float) -> Optional[StragglerReport]:
        hist = self.durations[-self.window:]
        self.durations.append(duration)
        if len(hist) < self.min_steps:
            return None
        med = statistics.median(hist)
        mad = statistics.median(abs(x - med) for x in hist) or 1e-9
        thr = med + self.k * 1.4826 * mad
        if duration > thr:
            rep = StragglerReport(step, duration, med, mad, thr)
            self.flags.append(rep)
            return rep
        return None


@dataclasses.dataclass
class ElasticPlan:
    pods: int
    dp: int
    tp: int

    @property
    def devices(self) -> int:
        return self.pods * self.dp * self.tp

    @staticmethod
    def largest(surviving_devices: int, tp: int, pods: int = 1,
                dp_multiple: int = 1) -> "ElasticPlan":
        """Largest dp such that pods·dp·tp <= survivors (tp pinned: the model
        is sharded tp-ways and must still fit per chip)."""
        dp = max(1, surviving_devices // (tp * pods))
        dp -= dp % dp_multiple
        dp = max(dp, 1)
        return ElasticPlan(pods, dp, tp)


class SimulatedFailure(RuntimeError):
    """Raised by tests / chaos hooks to exercise the restart path."""


class RestartBudgetExhausted(RuntimeError):
    """Raised when a restart loop has spent its failure budget."""


def run_with_restarts(train_once: Callable[[int, int], Tuple[int, bool]],
                      max_restarts: int = 3) -> Dict[str, int]:
    """Supervisor: ``train_once(attempt, start_step) -> (end_step, done)``.

    train_once is expected to resume from its own checkpoints; we only count
    attempts and re-invoke after failures.
    """
    attempt = 0
    step = 0
    while True:
        try:
            step, done = train_once(attempt, step)
            if done:
                return {"attempts": attempt + 1, "final_step": step}
        except SimulatedFailure:
            pass
        attempt += 1
        if attempt > max_restarts:
            raise RestartBudgetExhausted("restart budget exhausted")
