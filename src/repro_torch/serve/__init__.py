"""Continuous-batching serving engine (FAST's O(1)-state decode, served) —
port of `repro.serve`.

    engine.ServeEngine   submit()/step()/stream()/cancel(): mixed
                         chunked-prefill + batched-decode ticks over a
                         fixed slot pool, with admission control,
                         deadlines, non-finite quarantine, and a watchdog
    slots.SlotManager    slot-indexed decode state, O(1) admit/evict
    scheduler.Scheduler  fcfs / longest-prefill-first admission over a
                         bounded queue (depth + prompt-token budget)
    prefix_cache         prompt-prefix snapshot reuse (LRU byte budget)
    errors               request lifecycle statuses + structured failures
    faults.FaultInjector deterministic chaos harness
                         (`tests/test_torch_serve_faults.py`)
"""
from repro_torch.serve.engine import FinishedRequest, ServeEngine  # noqa: F401
from repro_torch.serve.errors import (  # noqa: F401
    EngineOverloaded,
    EngineStalled,
    RequestStatus,
    RequestTimeout,
    ServeError,
    SlotQuarantined,
)
from repro_torch.serve.faults import FaultInjector  # noqa: F401
from repro_torch.serve.prefix_cache import PrefixCache  # noqa: F401
from repro_torch.serve.scheduler import Request, Scheduler  # noqa: F401
from repro_torch.serve.slots import SlotManager  # noqa: F401

__all__ = ["ServeEngine", "FinishedRequest", "PrefixCache", "Request",
           "Scheduler", "SlotManager", "RequestStatus", "ServeError",
           "EngineOverloaded", "EngineStalled", "RequestTimeout",
           "SlotQuarantined", "FaultInjector"]
