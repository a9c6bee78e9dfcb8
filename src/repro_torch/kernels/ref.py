"""Plain PyTorch versions of the kernels — port of `repro/kernels/ref.py`.

Same GQA interface as the kernels (q [B,Hq,N,D], k/v [B,Hkv,M,*]), on
PRE-normalized q̂/k̂. `fastmax_decode_ref` is the plain version of the
decode kernel; the prefill kernel's plain version is
`repro_torch.kernels.fastmax_causal.fastmax_causal_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.core.fastmax import (Moments, combine_with_queries,
                                      compute_moments)
from repro_torch.core.ref import fastmax_attention_ref

__all__ = ["fastmax_ref", "fastmax_decode_ref"]


def _bcast_kv(x: torch.Tensor, hq: int) -> torch.Tensor:
    b, hkv, m, d = x.shape
    return x[:, :, None].expand(b, hkv, hq // hkv, m, d).reshape(b, hq, m, d)


def fastmax_ref(q, k, v, *, p: int = 2, causal: bool = False,
                denom_eps: float = 1e-6):
    """O(N^2) oracle with GQA broadcast; expects pre-normalized q̂/k̂."""
    hq = q.shape[1]
    return fastmax_attention_ref(q, _bcast_kv(k, hq), _bcast_kv(v, hq), p=p,
                                 causal=causal, normalize=False,
                                 denom_eps=denom_eps)


def fastmax_decode_ref(q, k, v, state, *, p: int = 2,
                       denom_eps: float = 1e-6):
    """One decode step on an explicit moment tuple (pre-normalized).

    Folds (k, v) into the moments, then contracts the grouped queries with
    the UPDATED moments. Functional: returns (o [B,Hq,1,Dv], new state
    tuple) and leaves `state` as it was.
    """
    new = Moments(*state) + compute_moments(k, v, p=p)
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    num, den = combine_with_queries(q.reshape(b, hkv, hq // hkv, d), new, p=p)
    o = num / (den + denom_eps)[..., None]
    return o.reshape(b, hq, 1, -1).to(q.dtype), tuple(new)
