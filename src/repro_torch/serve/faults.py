"""Deterministic fault injection for the serving engine (chaos tier) —
port of `repro/serve/faults.py`.

Production failure modes are rehearsed here on purpose, not discovered in
production: fastmax's unnormalized moment sums overflow low precision at
long context (a *paper-specific* hazard — NaN in one slot's moments must
never take down the pool), user callbacks raise, ticks stall, and traffic
bursts past capacity. Every fault is scheduled by ENGINE TICK, so chaos
runs are exactly reproducible: the same script injects the same fault at
the same point in the token stream on every run.

    inj = FaultInjector()
    inj.nan_into_slot(tick=12, slot=1)        # poison one slot's state
    inj.slow_tick(tick=5, seconds=0.05)       # blow the tick budget
    inj.cancel_at(tick=8, rid=3)              # mid-stream cancellation
    eng = ServeEngine(params, cfg, ..., faults=inj)

The engine calls ``inj.apply(engine, tick)`` at the top of every
``step()``; an engine built without ``faults=`` pays nothing. The module
also holds the host-side helpers the injector itself uses (``poison_slot``)
and test utilities (``exploding_callback``, ``burst``) so chaos tests and
the overload benchmark share one vocabulary.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.serve.errors import EngineOverloaded
from repro_torch.attention.state import state_leaves

__all__ = ["FaultInjector", "poison_slot", "exploding_callback", "burst"]


def poison_slot(slots, slot: int, value: float = float("nan")) -> int:
    """Overwrite every floating-point leaf of one slot's decode state with
    `value` (in place, that slot only). Returns the number of leaves
    poisoned. Integer lanes (cursors, positions) are left intact so the
    fault is purely numerical — exactly what a low-precision moment
    overflow looks like."""
    floats = [t for t in state_leaves(slots.view(slot))
              if t.is_floating_point()]
    for t in floats:
        t.fill_(value)
    return len(floats)


def exploding_callback(n: int, exc: Optional[Exception] = None):
    """A per-token callback that raises on its `n`-th invocation — the
    canonical misbehaving-user-code fault. The engine must fail only the
    owning request and keep serving."""
    count = {"i": 0}

    def cb(rid, tok):
        count["i"] += 1
        if count["i"] >= n:
            raise (exc if exc is not None
                   else RuntimeError(f"callback exploded on token #{n}"))

    return cb


def burst(engine, prompts, max_new_tokens: int, **submit_kw
          ) -> Tuple[List[int], int]:
    """Submit a burst of prompts at once, absorbing backpressure: returns
    (admitted rids, number rejected with `EngineOverloaded`). The overload
    benchmark and chaos tests both drive saturation through this."""
    rids, rejected = [], 0
    for p in prompts:
        try:
            rids.append(engine.submit(p, max_new_tokens, **submit_kw))
        except EngineOverloaded:
            rejected += 1
    return rids, rejected


class FaultInjector:
    """Tick-scheduled fault script. Actions registered for tick T run at
    the top of the engine's T-th `step()` (before deadline checks and
    admission), in registration order. `self.log` records what fired and
    when, for assertions."""

    def __init__(self):
        self._at: Dict[int, List[Tuple[str, Callable[[Any], None]]]] = \
            defaultdict(list)
        self.log: List[Tuple[int, str]] = []

    def _schedule(self, tick: int, name: str,
                  fn: Callable[[Any], None]) -> "FaultInjector":
        self._at[int(tick)].append((name, fn))
        return self

    # -- fault vocabulary ----------------------------------------------------

    def nan_into_slot(self, tick: int, slot: int,
                      value: float = float("nan")) -> "FaultInjector":
        """Poison every float leaf of `slot`'s state before tick `tick` —
        the moment-overflow failure the quarantine guard exists for."""
        return self._schedule(
            tick, f"nan_into_slot({slot})",
            lambda eng: poison_slot(eng.slots, slot, value))

    def slow_tick(self, tick: int, seconds: float) -> "FaultInjector":
        """Stall tick `tick` by sleeping on the host — a straggling device,
        a GC pause, a noisy neighbor. Drives the tick-budget watchdog."""
        return self._schedule(tick, f"slow_tick({seconds}s)",
                              lambda eng: time.sleep(seconds))

    def cancel_at(self, tick: int, rid: int) -> "FaultInjector":
        """Cancel request `rid` at tick `tick` (mid-prefill or mid-decode,
        wherever it happens to be)."""
        return self._schedule(tick, f"cancel_at(rid={rid})",
                              lambda eng: eng.cancel(rid))

    def call(self, tick: int, fn: Callable[[Any], None],
             name: str = "call") -> "FaultInjector":
        """Escape hatch: run `fn(engine)` at tick `tick` (wedge a host
        lane, drop a queue entry, whatever the scenario needs)."""
        return self._schedule(tick, name, fn)

    # -- engine hook ---------------------------------------------------------

    def apply(self, engine, tick: int) -> None:
        for name, fn in self._at.pop(int(tick), ()):
            self.log.append((int(tick), name))
            fn(engine)
