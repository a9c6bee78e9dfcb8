"""Vanilla softmax attention baseline (paper Eqs. 1-4) with GQA — port of
`repro/core/softmax.py`.

The paper benchmarks fastmax against it everywhere, and the serving
engine's softmax backend decodes through it over a KV cache. Quadratic in
N. Written in plain torch as the reference writes it (float32 scores,
masked scores set to float32's most negative value), not as a call to
`torch.nn.functional.scaled_dot_product_attention`: a row whose keys are
all masked gives the reference's uniform average over its keys, not NaN.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["softmax_attention"]


def softmax_attention(q, k, v, *, causal: bool = False,
                      kv_mask: Optional[torch.Tensor] = None,
                      q_offset=0, scale: Optional[float] = None):
    """q [B,Hq,N,D]; k, v [B,Hkv,M,*]; Hq % Hkv == 0 (queries are grouped
    per kv head, no copies of k or v). `kv_mask` [B, Hkv|1, M] keeps keys
    where nonzero. `q_offset` (an int or a 0-d tensor) is the position of
    q[0] on the key timeline, so a resumed chunk or a decode query is
    masked causally against a longer cache. Scores and weights are float32
    (float64 for float64 inputs); o is in q's dtype."""
    b, hq, n, d = q.shape
    hkv, m = k.shape[1], k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, hkv, g, n, d).to(acc)
    s = torch.einsum("bhgnd,bhmd->bhgnm", qg, k.to(acc)) * scale
    neg = torch.finfo(torch.float32).min
    if causal:
        qpos = torch.arange(n, device=q.device)[:, None] + q_offset
        kpos = torch.arange(m, device=q.device)[None, :]
        s = s.masked_fill(~(kpos <= qpos), neg)
    if kv_mask is not None:
        keep = kv_mask[:, :, None, None, :].to(torch.bool)
        s = torch.where(keep, s, torch.full_like(s, neg))
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    a = e / e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgnm,bhmj->bhgnj", a, v.to(acc))
    return o.reshape(b, hq, n, -1).to(q.dtype)
