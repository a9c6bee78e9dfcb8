"""Checkpointing (port of `repro.ckpt`): atomic, async, in the reference's
on-disk format, so a checkpoint written by either package restores in the
other."""
from repro_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
