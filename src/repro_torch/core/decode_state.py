"""Decode-state primitives — port of `repro/core/decode_state.py`.

The recurrent state of a fastmax layer is its moment tuple, of size
``Hkv * (1 + D + D^2) * (Dv + 1)`` floats whatever the context length.
"""
from __future__ import annotations

import torch

from repro_torch.core.fastmax import Moments

__all__ = ["init_fastmax_state"]


def init_fastmax_state(batch: int, h_kv: int, d: int, dv: int, *, p: int = 2,
                       dtype=torch.float32, device=None) -> Moments:
    """Zero moments for a fresh sequence (`p` kept for signature parity:
    m2/g2 are allocated at p=1 too, as zero placeholders)."""
    del p

    def z(*s):
        return torch.zeros((batch, h_kv) + s, dtype=dtype, device=device)

    return Moments(z(dv), z(d, dv), z(d, d, dv), z(), z(d), z(d, d))
