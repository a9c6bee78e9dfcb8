"""Optimizers, schedules and gradient utilities of the port (port of
`repro.optim`): plain functions over nested dicts of tensors."""
from repro_torch.optim.grad_utils import (  # noqa: F401
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.optimizers import (  # noqa: F401
    OptState,
    adamw,
    lion,
    make_optimizer,
)
from repro_torch.optim.schedules import constant, warmup_cosine  # noqa: F401
