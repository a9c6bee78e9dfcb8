"""Fault tolerance (port of `repro.ft`): straggler detection. Preemption
handling and auto-resume come with checkpointing."""
from repro_torch.ft.runtime import StragglerMonitor  # noqa: F401
