"""Admission scheduling for the continuous-batching engine — port of
`repro/serve/scheduler.py` (unchanged: pure host code).

Requests wait in a host-side queue until a slot frees up. Two policies:

  fcfs  -> strict arrival order.
  lpf   -> longest-prefill-first: admit the queued request with the most
           prompt tokens, so the big prefills start streaming chunks early
           and short requests fill the decode batch around them. Guarded by
           `max_wait`: once the oldest request has waited that many engine
           ticks it is admitted next regardless (no starvation).

The queue is BOUNDED: `max_depth` caps how many requests may wait and
`max_queued_tokens` caps the sum of their prompt lengths. `push` raises
`EngineOverloaded` past either bound — the engine's backpressure signal —
so memory is bounded by configuration, not by arrival rate. Under
sustained saturation the engine additionally calls `shed()` to drop the
newest/largest waiter (graceful degradation: predictable victims instead
of unbounded latency for everyone).

The scheduler is pure host bookkeeping — it never touches device state.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, List, Optional

import numpy as np

from repro_torch.serve.errors import EngineOverloaded, RequestStatus

__all__ = ["Request", "Scheduler", "POLICIES"]

POLICIES = ("fcfs", "lpf")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [P] int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    callback: Optional[Callable[[int, int], Any]] = None  # (rid, token)
    submit_tick: int = 0               # engine tick at submission
    submit_time: float = 0.0           # wall clock (load-gen latency stats)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # robustness lane (see serve/errors.py)
    status: RequestStatus = RequestStatus.QUEUED
    error: Optional[str] = None        # diagnostic on non-FINISHED terminals
    ttft_deadline: Optional[float] = None  # seconds from submit to token #1
    deadline: Optional[float] = None       # seconds from submit to finish


class Scheduler:
    def __init__(self, policy: str = "fcfs", *, max_wait: int = 64,
                 max_depth: int = 0, max_queued_tokens: int = 0):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        self.policy = policy
        self.max_wait = int(max_wait)
        self.max_depth = int(max_depth)              # 0 = unbounded
        self.max_queued_tokens = int(max_queued_tokens)  # 0 = unbounded
        self.queued_tokens = 0
        self._q: deque[Request] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, req: Request) -> None:
        """Enqueue, or raise `EngineOverloaded` past the depth/token bound
        (the queue is left unchanged — rejection has no side effects)."""
        if self.max_depth and len(self._q) >= self.max_depth:
            raise EngineOverloaded(
                f"queue full: {len(self._q)} requests waiting "
                f"(max_queue={self.max_depth})")
        if self.max_queued_tokens and \
                self.queued_tokens + len(req.prompt) > self.max_queued_tokens:
            raise EngineOverloaded(
                f"queued prompt-token budget exhausted: {self.queued_tokens} "
                f"+ {len(req.prompt)} > {self.max_queued_tokens}")
        self._q.append(req)
        self.queued_tokens += len(req.prompt)

    def _take(self, i: int) -> Request:
        req = self._q[i]
        del self._q[i]
        self.queued_tokens -= len(req.prompt)
        return req

    def pop(self, tick: int) -> Optional[Request]:
        """Next request to admit, or None if the queue is empty."""
        if not self._q:
            return None
        if self.policy == "fcfs":
            return self._take(0)
        # lpf: oldest-first once it has starved past max_wait
        if tick - self._q[0].submit_tick >= self.max_wait:
            return self._take(0)
        i = max(range(len(self._q)),
                key=lambda j: (len(self._q[j].prompt), -j))
        return self._take(i)

    def remove(self, rid: int) -> Optional[Request]:
        """Pull a specific queued request out (cancellation)."""
        for i, req in enumerate(self._q):
            if req.rid == rid:
                return self._take(i)
        return None

    def shed(self) -> Optional[Request]:
        """Drop the newest-largest waiter (load shedding under sustained
        saturation): among the queued requests, the one with the longest
        prompt, ties broken newest-first — the victim that frees the most
        budget while hurting the oldest waiters least."""
        if not self._q:
            return None
        i = max(range(len(self._q)),
                key=lambda j: (len(self._q[j].prompt), j))
        return self._take(i)

    def take_expired(self, now: float) -> List[Request]:
        """Remove and return every queued request whose TTFT or total
        deadline has already expired (queued requests have no first token
        yet, so both deadlines apply)."""
        out = []
        for i in range(len(self._q) - 1, -1, -1):
            req = self._q[i]
            waited = now - req.submit_time
            limit = min((d for d in (req.ttft_deadline, req.deadline)
                         if d is not None), default=None)
            if limit is not None and waited > limit:
                out.append(self._take(i))
        out.reverse()                  # oldest first, like arrival order
        return out
