"""Fault-tolerance runtime pieces — port of `repro/ft/runtime.py`.

  * `PreemptionHandler` — SIGTERM/SIGINT set a flag; the train loop saves
    a checkpoint and exits at the next step boundary (saves are atomic, so
    a kill during one is safe too). `restore()` puts the old handlers back.
  * `StragglerMonitor` — robust step-time tracker (median over a window):
    a step slower than `threshold` x the running median is counted, and
    sustained stragglers raise a signal. The train loop and the serving
    engine time their steps and ticks with it.
  * `run_with_restarts` — supervisor loop: run until completion; on a
    worker failure, rebuild the state from the last checkpoint and go on.
"""
from __future__ import annotations

import signal
import statistics
import time
from typing import Callable, Optional

__all__ = ["PreemptionHandler", "StragglerMonitor", "run_with_restarts"]


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._old = {}
        for s in signals:
            try:
                self._old[s] = signal.signal(s, self._on)
            except ValueError:          # not the main thread
                pass

    def _on(self, signum, frame):
        self.requested = True

    def restore(self):
        for s, h in self._old.items():
            signal.signal(s, h)
        self._old = {}


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


def run_with_restarts(make_state: Callable[[], tuple],
                      run: Callable[..., int],
                      *, max_restarts: int = 10,
                      on_restart: Optional[Callable[[int, Exception], None]]
                      = None) -> int:
    """Supervisor: (re)build the state (restoring the latest checkpoint) and
    run until `run` returns normally. A worker exception triggers a restore
    and a retry, at most `max_restarts` times."""
    attempt = 0
    while True:
        state = make_state()
        try:
            return run(*state)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — any worker failure
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
