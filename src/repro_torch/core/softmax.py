"""Vanilla softmax attention baseline (paper Eqs. 1-4) with GQA — port of
`repro/core/softmax.py`.

The paper benchmarks fastmax against it everywhere, and the serving
engine's softmax backend decodes through it over a KV cache. Quadratic in
N. Written in plain torch as the reference writes it (float32 scores,
masked scores set to float32's most negative value), not as a call to
`torch.nn.functional.scaled_dot_product_attention`: a row whose keys are
all masked gives the reference's uniform average over its keys, not NaN.

`softmax_partials` is that softmax over a block of the keys, left
unnormalized (each row's max score m, l = sum exp(s - m), o = sum
exp(s - m) v): `softmax_attention` is o / l over all of them, and
`combine_partials` the softmax over several blocks' union from theirs
(the decode state's KV cache split over "model" along its timeline,
`attention.state`). A block whose keys are all masked scores float32's
most negative value on each, so it weighs nothing beside a block with a
valid key, and where no block has one the combine is the uniform
average over every key, as `softmax_attention` gives it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["softmax_attention", "softmax_partials", "combine_partials"]


def softmax_attention(q, k, v, *, causal: bool = False,
                      kv_mask: Optional[torch.Tensor] = None,
                      q_offset=0, scale: Optional[float] = None):
    """q [B,Hq,N,D]; k, v [B,Hkv,M,*]; Hq % Hkv == 0 (queries are grouped
    per kv head, no copies of k or v). `kv_mask` [B, Hkv|1, M] keeps keys
    where nonzero. `q_offset` (an int or a 0-d tensor) is the position of
    q[0] on the key timeline, so a resumed chunk or a decode query is
    masked causally against a longer cache. Scores and weights are float32
    (float64 for float64 inputs); o is in q's dtype."""
    _, l, o = softmax_partials(q, k, v, kv_mask=kv_mask,
                               q_offset=q_offset if causal else None,
                               scale=scale)
    return (o / l[..., None]).to(q.dtype)


def softmax_partials(q, k, v, *, kv_mask: Optional[torch.Tensor] = None,
                     q_offset=None, k_offset: int = 0,
                     scale: Optional[float] = None):
    """`softmax_attention` of q [B,Hq,N,D] over one block of keys k, v
    [B,Hkv,M,*], left unnormalized: (m [B,Hq,N], l [B,Hq,N], o
    [B,Hq,N,Dv]) in the score type. `q_offset` (None: no causal mask)
    and `k_offset` are the positions of q[0] and k[0] on the timeline."""
    b, hq, n, d = q.shape
    hkv, m = k.shape[1], k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(b, hkv, g, n, d).to(acc)
    s = torch.einsum("bhgnd,bhmd->bhgnm", qg, k.to(acc)) * scale
    neg = torch.finfo(torch.float32).min
    if q_offset is not None:
        qpos = torch.arange(n, device=q.device)[:, None] + q_offset
        kpos = torch.arange(m, device=q.device)[None, :] + k_offset
        s = s.masked_fill(~(kpos <= qpos), neg)
    if kv_mask is not None:
        keep = kv_mask[:, :, None, None, :].to(torch.bool)
        s = torch.where(keep, s, torch.full_like(s, neg))
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - mx)
    o = torch.einsum("bhgnm,bhmj->bhgnj", e, v.to(acc))
    return (mx.reshape(b, hq, n), e.sum(dim=-1).reshape(b, hq, n),
            o.reshape(b, hq, n, -1))


def combine_partials(m, l, o):
    """The softmax output over R blocks of keys from their partials
    stacked on a leading axis (m, l [R, ...], o [R, ..., Dv]): each
    block's sums rescaled to the largest max."""
    w = torch.exp(m - m.amax(dim=0))
    return (w[..., None] * o).sum(dim=0) / (w * l).sum(dim=0)[..., None]
