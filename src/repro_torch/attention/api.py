"""`attention(q, k, v, spec, ...)` — the full-sequence attention entry
point, port of `repro/attention/api.py`. It resolves the spec's backend by
name and calls its `fn`; the port has no mesh, so no feature-sharding flag
is derived, and no fallback chain: a call that needs a capability its
backend lacks (dropout) raises, as the reference does under
`strict=True`."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.attention.registry import resolve
from repro_torch.attention.spec import AttentionSpec

__all__ = ["attention"]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              spec: Optional[AttentionSpec] = None, *, causal: bool = False,
              kv_mask: Optional[torch.Tensor] = None,
              rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """Compute attention per `spec`. q [B,Hq,N,D]; k, v [B,Hkv,M,*].
    `kv_mask` ([B,Hkv,M], 1 = valid) exactly removes padding keys (the
    softmax and chunked backends). `rng`, a `torch.Generator` on q's
    device, turns on the spec's dropout (training only; fastmax-rowwise
    alone has it)."""
    if spec is None:
        spec = AttentionSpec()
    backend = resolve(spec)
    if spec.dropout_rate > 0.0 and rng is not None \
            and not backend.caps.dropout:
        raise ValueError(
            f"backend {backend.name!r} has no dropout; the paper's "
            f"factorized dropout (Fig. 2) is on fastmax-rowwise only: use "
            f"fastmax2-rowwise (or fastmax1-rowwise)")
    return backend.fn(q, k, v, spec, causal=causal, kv_mask=kv_mask, rng=rng)
