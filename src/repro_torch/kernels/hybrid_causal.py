"""Hybrid near/far-field causal attention: the CUDA kernel's wrapper and
its plain version.

Port of `repro/kernels/hybrid_causal.py::hybrid_causal_pallas` (with
`kv_mask` and `return_state`). The kernel is `csrc/hybrid_causal.cu` (the
sequential chunk scan `csrc/causal_scan.cuh` with the near-field band);
`hybrid_causal_ref` is the plain PyTorch version with the same signature,
built on `core.hybrid._hybrid_scan`. Both realize the band of the
reference's rule, cs = min(chunk_size, max(8, N)) and
w_eff = max(0, min(window, cs)), from the caller's `chunk_size`, not from
the chunk the kernel picks for itself; at w_eff = 0 both are the fastmax
prefill pair. `kernels.ops.hybrid` picks between them by the tensors'
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hybrid import _hybrid_scan
from repro_torch.kernels import fastmax_causal as _fc

__all__ = ["hybrid_causal_cuda", "hybrid_causal_ref", "band_width",
           "launches"]

# kernel launches made by `hybrid_causal_cuda` (one per call with a band)
launches = 0


def _lib():
    from repro_torch.kernels import build

    lib = build.load("hybrid_causal")
    if not getattr(lib, "_typed", False):
        lib.hybrid_causal_forward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 11
            + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
        lib.hybrid_causal_forward.restype = ctypes.c_int
        lib.hybrid_causal_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.hybrid_causal_smem_bytes.restype = ctypes.c_long
        lib._typed = True
    return lib


def band_width(window: int, chunk_size: int, n: int) -> int:
    """The band the kernel realizes on N tokens: the reference's
    w_eff = max(0, min(window, min(chunk_size, max(8, N))))."""
    return max(0, min(int(window), min(int(chunk_size), max(8, int(n)))))


def hybrid_causal_cuda(q, k, v, kv_mask=None, *, p: int = 2,
                       window: int = 64, chunk_size: int = 128,
                       denom_eps: float = 1e-6, return_state: bool = False):
    """Launch the CUDA hybrid kernel on pre-normalized q̂ [B,Hq,N,D],
    k̂ [B,Hkv,N,D], v [B,Hkv,N,Dv] (float32 or bfloat16, contiguous, on
    one CUDA device); `kv_mask` [B, Hkv|1, N] removes keys from both legs.
    `window` and `chunk_size` give the band (`band_width`).

    Returns o [B,Hq,N,Dv] in q's dtype, or (o, state) with
    `return_state`: the final moment carry (m0, m1, m2, g0, g1, g2) in
    float32, m2 m-major [B,Hkv,D,D,Dv], zeros for m2 and g2 at p=1. At
    w_eff = 0 this is `fastmax_causal_cuda`. Raises on any input the
    kernel does not take and on a failed build or launch.
    """
    global launches
    _fc._check_inputs(q, k, v)
    b, hq, n, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    w_eff = band_width(window, chunk_size, n)
    if w_eff == 0:
        o, state = _fc.fastmax_causal_cuda(q, k, v, kv_mask, p=p,
                                           denom_eps=denom_eps)
        return (o, state) if return_state else o
    w = _fc.check_kernel_inputs(q, k, v, kv_mask, p, "hybrid_causal_cuda")
    dev, g, f32 = q.device, hq // hkv, torch.float32

    lib = _lib()
    c = _fc.pick_chunk(g, d, lib.hybrid_causal_smem_bytes)
    o = torch.empty(b, hq, n, dv, dtype=q.dtype, device=dev)
    state = tuple(torch.empty(s, dtype=f32, device=dev)
                  for s in _fc._state_shapes(b, hkv, d, dv))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.hybrid_causal_forward(
            _fc._KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), w.data_ptr(), o.data_ptr(),
            *[t.data_ptr() for t in state],
            b * hkv, g, n, d, dv, p, c, w_eff, float(denom_eps), stream)
    if err != 0:
        raise RuntimeError(f"hybrid_causal_forward launch failed: CUDA "
                           f"error {err}")
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
