"""Straggler / hang mitigation (a copy of the reference's `repro.training.watchdog`).

Synchronous SPMD means one slow worker stalls the fleet.  The watchdog
tracks per-step wall times, flags statistical outliers, and exposes a
hang deadline; the trainer's response at scale is checkpoint-and-evict
(here: flag + callback; the tests drive `observe` directly).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional


@dataclass
class StepStats:
    step: int
    duration_s: float
    flagged: bool


class StragglerWatchdog:
    def __init__(self, window: int = 50, sigma: float = 4.0,
                 hang_factor: float = 10.0,
                 on_flag: Optional[Callable[[StepStats], None]] = None):
        self.window: Deque[float] = deque(maxlen=window)
        self.sigma = sigma
        self.hang_factor = hang_factor
        self.on_flag = on_flag
        self.flagged: List[StepStats] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start_step(self, step: int) -> None:
        self._step = step
        self._t0 = time.perf_counter()

    def end_step(self) -> StepStats:
        assert self._t0 is not None
        dur = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(self._step, dur)

    def observe(self, step: int, duration_s: float) -> StepStats:
        flagged = False
        if len(self.window) >= 10:
            mean = sum(self.window) / len(self.window)
            var = sum((x - mean) ** 2 for x in self.window) / len(self.window)
            std = max(var ** 0.5, 1e-6 * mean, 1e-9)
            if duration_s > mean + self.sigma * std and duration_s > 1.5 * mean:
                flagged = True
        self.window.append(duration_s)
        st = StepStats(step, duration_s, flagged)
        if flagged:
            self.flagged.append(st)
            if self.on_flag:
                self.on_flag(st)
        return st

    def hang_deadline_s(self) -> float:
        """Abort threshold for a wedged collective (checkpoint-and-evict)."""
        if not self.window:
            return 3600.0
        return max(self.window) * self.hang_factor
