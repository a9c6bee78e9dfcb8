"""Fault tolerance (port of `repro.ft`): preemption handling, straggler
detection, auto-resume."""
from repro_torch.ft.runtime import (  # noqa: F401
    PreemptionHandler,
    StragglerMonitor,
    run_with_restarts,
)
