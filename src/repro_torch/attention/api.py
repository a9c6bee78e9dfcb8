"""`attention(q, k, v, spec, ...)` — the full-sequence attention entry
point, port of `repro/attention/api.py`. It resolves the spec's backend by
name and calls its `fn`; the port has no mesh, so no feature-sharding flag
is derived."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.attention.registry import resolve
from repro_torch.attention.spec import AttentionSpec

__all__ = ["attention"]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              spec: Optional[AttentionSpec] = None, *, causal: bool = False,
              kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Compute attention per `spec`. q [B,Hq,N,D]; k, v [B,Hkv,M,*].
    `kv_mask` ([B,Hkv,M], 1 = valid) exactly removes padding keys (chunked
    backend only)."""
    if spec is None:
        spec = AttentionSpec()
    return resolve(spec).fn(q, k, v, spec, causal=causal, kv_mask=kv_mask)
