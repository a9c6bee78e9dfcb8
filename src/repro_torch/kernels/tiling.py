"""Tiling policy for the m-blocked degree-2 contractions.

Copy of the part of `repro/kernels/tiling.py` that the port uses (it
imports nothing of `repro`): `pick_bm` is the row block of the m-major
`m2 [D·D, Dv]` moment that the plain scan streams, bounding its
`[..., n, bm·D]` intermediates. The CUDA kernels pick their own tiles (see
their wrappers).
"""
from __future__ import annotations

import functools

__all__ = ["pick_bm", "divisors", "SCAN_BM_BUDGET"]

SCAN_BM_BUDGET = 2048    # plain chunked-scan intermediates


@functools.lru_cache(maxsize=None)
def divisors(n: int) -> tuple:
    """All divisors of `n`, ascending (n >= 1)."""
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"divisors() needs a positive int, got {n!r}")
    small, large = [], []
    i = 1
    while i * i <= n:
        if n % i == 0:
            small.append(i)
            if i != n // i:
                large.append(n // i)
        i += 1
    return tuple(small + large[::-1])


@functools.lru_cache(maxsize=None)
def pick_bm(d: int, budget: int) -> int:
    """Largest divisor of `d` with bm*d <= budget (always >= 1)."""
    if not isinstance(budget, int) or budget < 1:
        raise ValueError(f"budget must be a positive int, got {budget!r}")
    best = 1
    for bm in divisors(d):
        if bm * d <= budget:
            best = bm
    return best
