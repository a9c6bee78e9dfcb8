"""Hybrid near/far-field causal attention: the CUDA kernel's wrapper and
its plain version.

Port of `repro/kernels/hybrid_causal.py::hybrid_causal_pallas` (with
`kv_mask` and `return_state`). The kernel is the causal prefill's pair of
launches in `csrc/fastmax_causal.cu` (design notes there): the same prefix
moments of every chunk of L = 128 keys (launch A), then the combine with
the near-field band (`hybrid_causal_combine`), run by
`fastmax_causal.prefill_call(..., band=w_eff)` over the same segments;
`hybrid_causal_ref` is the plain PyTorch version with the same signature,
built on `core.hybrid._hybrid_scan`. Both realize the band of the
reference's rule, cs = min(chunk_size, max(8, N)) and
w_eff = max(0, min(window, cs)), from the caller's `chunk_size`, not from
the kernel's chunk; at w_eff = 0 both are the fastmax prefill pair.
`kernels.ops.hybrid` and `kernels.ops.hybrid_prefill_kernel` pick between
them by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.core.hybrid import _hybrid_scan
from repro_torch.kernels import fastmax_causal as _fc

__all__ = ["hybrid_causal_cuda", "hybrid_causal_ref", "band_width",
           "launches"]

# calls of `hybrid_causal_cuda` that launched the kernel (one per call with
# a band, though each makes two CUDA launches a segment: prefix moments,
# then the band combine)
launches = 0


def band_width(window: int, chunk_size: int, n: int) -> int:
    """The band the kernel realizes on N tokens: the reference's
    w_eff = max(0, min(window, min(chunk_size, max(8, N))))."""
    return max(0, min(int(window), min(int(chunk_size), max(8, int(n)))))


def hybrid_causal_cuda(q, k, v, kv_mask=None, *, p: int = 2,
                       window: int = 64, chunk_size: int = 128,
                       denom_eps: float = 1e-6, return_state: bool = False,
                       schedule=None):
    """Launch the CUDA hybrid kernel on pre-normalized q̂ [B,Hq,N,D],
    k̂ [B,Hkv,N,D], v [B,Hkv,N,Dv] (float32 or bfloat16, contiguous, on
    one CUDA device); `kv_mask` [B, Hkv|1, N] removes keys from both legs.
    `window` and `chunk_size` give the band (`band_width`).

    Returns o [B,Hq,N,Dv] in q's dtype, or (o, state) with
    `return_state`: the final moment carry (m0, m1, m2, g0, g1, g2) in
    float32, m2 m-major [B,Hkv,D,D,Dv], zeros for m2 and g2 at p=1. At
    w_eff = 0 this is `fastmax_causal_cuda`. `schedule` sets the band
    combine's value columns a pass, as `fastmax_causal_cuda`'s sets its
    combine's. Raises on any input the
    kernel does not take and on a failed build or launch. Each call with
    a band adds one to `launches` (not to `fastmax_causal.launches`); its
    workspace (`fastmax_causal.workspace_bytes`) is freed on return.
    """
    global launches
    _fc._check_inputs(q, k, v)
    w_eff = band_width(window, chunk_size, q.shape[2])
    if w_eff == 0:
        o, state = _fc.fastmax_causal_cuda(q, k, v, kv_mask, p=p,
                                           denom_eps=denom_eps,
                                           schedule=schedule)
        return (o, state) if return_state else o
    o, state = _fc.prefill_call(q, k, v, kv_mask, p=p, denom_eps=denom_eps,
                                band=w_eff, schedule=schedule).run()
    launches += 1
    return (o, state) if return_state else o


def hybrid_causal_ref(q, k, v, kv_mask=None, *, p: int = 2,
                      window: int = 64, chunk_size: int = 128,
                      denom_eps: float = 1e-6, return_state: bool = False):
    """Plain PyTorch version of the hybrid kernel (same signature and
    results, up to rounding): the chunked hybrid scan at `chunk_size`,
    with the state in the accumulator type. At w_eff = 0 this is
    `fastmax_causal_ref`."""
    _fc._check_inputs(q, k, v)
    b, _, n, _ = q.shape
    hkv = k.shape[1]
    w_eff = band_width(window, chunk_size, n)
    if w_eff == 0:
        o, state = _fc.fastmax_causal_ref(q, k, v, kv_mask, p=p,
                                          chunk_size=chunk_size,
                                          denom_eps=denom_eps)
        return (o, state) if return_state else o
    if kv_mask is not None:
        kv_mask = kv_mask.expand(b, hkv, n)
    o, final = _hybrid_scan(q, k, v, p=p, window=w_eff,
                            chunk_size=chunk_size, kv_mask=kv_mask,
                            denom_eps=denom_eps)
    if p < 2:
        final = final._replace(m2=torch.zeros_like(final.m2),
                               g2=torch.zeros_like(final.g2))
    o = o.to(q.dtype)
    return (o, tuple(final)) if return_state else o
