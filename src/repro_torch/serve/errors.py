"""Request lifecycle + structured error taxonomy for the serving engine —
port of `repro/serve/errors.py` (unchanged: pure host code).

A request moves through a small state machine; every terminal state is
reported as a `FinishedRequest` carrying the status and a diagnostic, so
callers never have to infer "what happened" from a missing rid:

    QUEUED ──admit──► PREFILL ──first token──► DECODE ──eos/budget──► FINISHED
      │                  │                        │
      │                  └───── callback raise / non-finite ────────► FAILED
      ├─ cancel() ───────┴──────────────────────────────────────────► CANCELLED
      ├─ deadline ──────────────────────────────────────────────────► TIMED_OUT
      └─ load shed ─────────────────────────────────────────────────► REJECTED

`submit()` raising `EngineOverloaded` is the one outcome with no
`FinishedRequest`: the request was never accepted, so no rid exists.

The exceptions partition the failure modes the engine distinguishes:

    EngineOverloaded   admission refused (queue depth / prompt-token budget)
    RequestTimeout     a per-request TTFT or total deadline expired (used as
                       the diagnostic on TIMED_OUT finishes; raised only if
                       a caller opts into exceptions via `strict` helpers)
    SlotQuarantined    non-finite values reached a slot's emissions; the
                       slot was re-initialized and only that request failed
    EngineStalled      the watchdog tripped: no tick progress / tick
                       wall-clock budget blown / `run()` exhausted
                       `max_ticks` with requests still pending — carries an
                       engine snapshot for postmortems
"""
from __future__ import annotations

import enum
from typing import Any, Optional

__all__ = ["RequestStatus", "TERMINAL_STATUSES", "ServeError",
           "EngineOverloaded", "RequestTimeout", "SlotQuarantined",
           "EngineStalled"]


class RequestStatus(str, enum.Enum):
    QUEUED = "queued"          # accepted, waiting for a slot
    PREFILL = "prefill"        # in a slot, prompt chunks still running
    DECODE = "decode"          # first token emitted, decoding
    FINISHED = "finished"      # eos or max_new_tokens reached
    FAILED = "failed"          # callback raised / non-finite quarantine
    CANCELLED = "cancelled"    # cancel(rid)
    TIMED_OUT = "timed_out"    # TTFT or total deadline expired
    REJECTED = "rejected"      # shed from the queue under sustained overload

    def __str__(self) -> str:  # stable in messages / JSON
        return self.value


TERMINAL_STATUSES = frozenset({
    RequestStatus.FINISHED, RequestStatus.FAILED, RequestStatus.CANCELLED,
    RequestStatus.TIMED_OUT, RequestStatus.REJECTED})


class ServeError(RuntimeError):
    """Base class for structured serving failures."""


class EngineOverloaded(ServeError):
    """`submit()` refused: the bounded queue (depth or prompt-token budget)
    is full. Callers should back off / retry elsewhere; the engine state is
    unchanged."""


class RequestTimeout(ServeError):
    """A per-request deadline (TTFT or total latency) expired. The request
    finished with status TIMED_OUT; this class names the diagnostic."""


class SlotQuarantined(ServeError):
    """Non-finite values (NaN/Inf) reached a slot's logits or — with
    REPRO_SERVE_CHECK_STATE=1 — its decode-state leaves. The slot was
    re-initialized in place and returned to the pool; only
    the poisoned request failed."""


class EngineStalled(ServeError):
    """The engine watchdog tripped. Carries `snapshot`, a host-side dict of
    engine state at the stall (tick, queue, per-slot lanes, counters, tick
    timing stats) for postmortems."""

    def __init__(self, message: str, snapshot: Optional[Any] = None):
        super().__init__(message)
        self.snapshot = snapshot

    def __str__(self) -> str:
        base = super().__str__()
        if not self.snapshot:
            return base
        snap = self.snapshot
        slots = snap.get("slots", [])
        busy = sum(1 for s in slots if s.get("rid") is not None)
        return (f"{base} [tick {snap.get('tick')}, queue "
                f"{snap.get('queue_depth')}, slots {busy}/{len(slots)} busy]")
