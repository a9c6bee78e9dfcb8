"""Fault-tolerance runtime pieces — port of `repro/ft/runtime.py`.

`StragglerMonitor` is a robust step-time tracker (median over a window):
a step slower than `threshold` x the running median is counted, and
sustained stragglers raise a signal. The serving engine times its ticks
with it. `PreemptionHandler` and `run_with_restarts` come with the
checkpointing slice.
"""
from __future__ import annotations

import statistics
import time
from typing import Optional

__all__ = ["StragglerMonitor"]


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, window: int = 50,
                 patience: int = 3):
        self.threshold = threshold
        self.window = window
        self.patience = patience
        self.times: list[float] = []
        self.strikes = 0
        self._t0: Optional[float] = None

    def start_step(self):
        self._t0 = time.monotonic()

    def end_step(self) -> float:
        dt = time.monotonic() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) >= 8 and dt > self.threshold * self.median():
            self.strikes += 1
        else:
            self.strikes = max(0, self.strikes - 1)
        return dt

    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0

    @property
    def straggling(self) -> bool:
        return self.strikes >= self.patience

    def stats(self) -> dict:
        if not self.times:
            return {}
        med = self.median()
        return {"median_s": med,
                "p90_s": sorted(self.times)[int(0.9 * (len(self.times) - 1))],
                "max_s": max(self.times),
                "straggling": self.straggling}
