"""Decode-state primitives — port of `repro/core/decode_state.py`.

The recurrent state of a fastmax layer is its moment tuple, of size
``Hkv * (1 + D + D^2) * (Dv + 1)`` floats whatever the context length.
The decode-state protocol over every family (`attention.state`) builds on
these; `fastmax_prefill` and `fastmax_decode_step` are the fastmax-level
primitives, functional as in the reference (they return a new state).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.fastmax import (Moments, _causal_scan,
                                      combine_with_queries, compute_moments)
from repro_torch.core.ref import normalize_qk

__all__ = ["init_fastmax_state", "fastmax_decode_step", "fastmax_prefill",
           "decode_state_bytes"]


def decode_state_bytes(cfg, batch: int, max_len: int) -> int:
    """Bytes of the whole model's decode state for `batch` sequences of up
    to `max_len` tokens, without allocating it (the state is built on the
    `meta` device, the counterpart of the reference's `jax.eval_shape`),
    every leaf of every layer's state counted: attention's, and the Mamba
    (conv inputs, h) and xLSTM (mLSTM's C and n, sLSTM's c, n, m, h)
    recurrent states. Constant in `max_len` for the fastmax family and
    the SSM mixers, linear in it for the softmax KV cache. Under MLA the
    state is per query head at D = qk_nope_dim + qk_rope_dim
    (`models.layers._kv_dims`): deepseek-v2's is 2.45 GB per layer and
    sequence; xlstm-1.3b's mLSTM memory is 16.8 MB per layer and
    sequence."""
    # core must not import attention or models at top level
    from repro_torch.attention.state import state_leaves
    from repro_torch.models import init_decode_state

    state = init_decode_state(cfg, batch, max_len, device="meta")
    return sum(t.numel() * t.element_size() for t in state_leaves(state))


def init_fastmax_state(batch: int, h_kv: int, d: int, dv: int, *, p: int = 2,
                       dtype=torch.float32, device=None) -> Moments:
    """Zero moments for a fresh sequence (`p` kept for signature parity:
    m2/g2 are allocated at p=1 too, as zero placeholders)."""
    del p

    def z(*s):
        return torch.zeros((batch, h_kv) + s, dtype=dtype, device=device)

    return Moments(z(dv), z(d, dv), z(d, d, dv), z(), z(d), z(d, d))


def fastmax_prefill(q, k, v, *, p: int = 2, normalize: bool = True,
                    kv_mask: Optional[torch.Tensor] = None,
                    chunk_size: int = 128, denom_eps: float = 1e-6):
    """Causal prefill returning (o, final Moments) for streaming decode."""
    qh = normalize_qk(q) if normalize else q
    kh = normalize_qk(k) if normalize else k
    return _causal_scan(qh, kh, v, p=p, chunk_size=chunk_size,
                        kv_mask=kv_mask, denom_eps=denom_eps)


def fastmax_decode_step(state: Moments, q, k, v, *, p: int = 2,
                        normalize: bool = True, denom_eps: float = 1e-6):
    """One decode step: fold the new (k, v) into the moments and contract
    with q. q [B,Hq,1,D], k [B,Hkv,1,D], v [B,Hkv,1,Dv]. O(D^p Dv) per head
    per token, whatever the context length. Returns (o [B,Hq,1,Dv], new
    Moments); `state` is left as it was."""
    qh = normalize_qk(q) if normalize else q
    kh = normalize_qk(k) if normalize else k
    new_state = Moments(*state) + compute_moments(kh, v, p=p)
    b, hq, hkv = q.shape[0], q.shape[1], k.shape[1]
    # fold the query group into the token axis (no broadcast of the state)
    qg = qh.reshape(b, hkv, hq // hkv, q.shape[-1])
    num, den = combine_with_queries(qg, new_state, p=p)
    o = num / (den + denom_eps)[..., None]
    return o.reshape(b, hq, 1, -1).to(q.dtype), new_state
