"""Placement: logical-axis rules -> specs on a device mesh
(DP/FSDP/TP/EP/SP) — port of `repro/sharding`."""
from repro_torch.sharding.rules import (  # noqa: F401
    DEFAULT_RULES,
    Spec,
    active_mesh,
    batch_spec,
    decode_state_shardings,
    param_shardings,
    spec_for,
    to_placements,
    use_mesh,
)
