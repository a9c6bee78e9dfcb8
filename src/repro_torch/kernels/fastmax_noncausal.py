"""Noncausal fastmax: the CUDA kernel's wrappers and their plain versions.

Port of `repro/kernels/fastmax_noncausal.py::fastmax_noncausal_pallas`,
whose two pallas_calls (`_moment_kernel`, `_combine_kernel`) become two
launches of `csrc/fastmax_noncausal.cu` (design notes there):
`noncausal_moments_cuda` (the global moments over all keys) and
`noncausal_combine_cuda` (the queries against them); `fastmax_noncausal_cuda`
runs both. Their plain versions, `noncausal_moments_ref`,
`noncausal_combine_ref` and `fastmax_noncausal_ref`, are built on
`core.fastmax`. `kernels.ops.fastmax(causal=False)` picks between them by
the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.fastmax import (Moments, _combine_grouped,
                                      _group_queries, _ungroup,
                                      compute_moments_chunked,
                                      fastmax_noncausal)

__all__ = ["noncausal_moments_cuda", "noncausal_combine_cuda",
           "fastmax_noncausal_cuda", "noncausal_moments_ref",
           "noncausal_combine_ref", "fastmax_noncausal_ref",
           "moment_launches", "combine_launches", "SPLIT_ROWS",
           "MAX_SPLIT_ROWS"]

# launches made by `noncausal_moments_cuda` / `noncausal_combine_cuda`
# (one per call each)
moment_launches = 0
combine_launches = 0

# Launch knobs of the combine, the defaults of `kernels.autotune`'s `rows`
# and `split` (a `schedule` overrides them per call):
# - feature rows each block of the split combine (few query rows) reads:
#   fewer rows give more blocks against the 132 SMs (17 a (batch, kv-head)
#   at whisper's R = 2145), and more partials for the sum launch to read.
SPLIT_ROWS = 128
# - the largest G·N (query rows a (batch, kv-head)) sent to the split
#   combine rather than `combine_rows_kernel` (tensor cores, one block per
#   64 query rows, each reading all R moment rows): kMaxQ in
#   csrc/fastmax_noncausal.cu, the split combine's largest query tile.
MAX_SPLIT_ROWS = 16

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    from repro_torch.kernels import build

    lib = build.load("fastmax_noncausal")
    if not getattr(lib, "_typed", False):
        lib.fastmax_noncausal_moments.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
            + [ctypes.c_void_p])
        lib.fastmax_noncausal_moments.restype = ctypes.c_int
        lib.fastmax_noncausal_combine.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])
        lib.fastmax_noncausal_combine.restype = ctypes.c_int
        lib.fastmax_noncausal_rows.argtypes = [ctypes.c_int] * 2
        lib.fastmax_noncausal_rows.restype = ctypes.c_int
        lib._typed = True
    return lib


def _moment_shapes(b, hkv, d, dv):
    return ((b, hkv, dv), (b, hkv, d, dv), (b, hkv, d, d, dv), (b, hkv),
            (b, hkv, d), (b, hkv, d, d))


def _check_p(p):
    if p not in (1, 2):
        raise ValueError(f"p must be 1 or 2, got {p}")


def _check_kv(k, v):
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError("k, v must be [B, Hkv, M, D]")
    if v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shape mismatch k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")


def _check_cuda(dims, **tensors):
    """Every tensor contiguous on one CUDA device, all of one kernel dtype;
    D and Dv as the kernel takes them."""
    first = next(iter(tensors.values()))
    dev, dtype = first.device, first.dtype
    if dev.type != "cuda":
        raise ValueError(f"the noncausal kernel needs CUDA tensors, got {dev}")
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"inputs must be float32 or bfloat16, got {dtype}")
    for name, t in tensors.items():
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {t.dtype} on {t.device} (contiguous="
                             f"{t.is_contiguous()}); expected contiguous "
                             f"{dtype} on {dev}")
    d, dv = dims
    if d % 4 or dv % 4 or not 4 <= d <= 255 or not 4 <= dv <= 1024:
        raise ValueError(f"the kernel needs D and Dv divisible by 4, "
                         f"4 <= D <= 255 and Dv <= 1024; got D={d}, Dv={dv}")
    return dev


def noncausal_moments_cuda(k, v, *, p: int = 2) -> Moments:
    """Launch the moment kernel on pre-normalized k̂ [B,Hkv,M,D] and
    v [B,Hkv,M,Dv] (float32 or bfloat16, contiguous, on one CUDA device).

    Returns the Moments over all M keys in float32, in
    `core.fastmax.compute_moments`'s layout (m2 [B,Hkv,D,D,Dv]); at p=1,
    m2 and g2 are zeros. Raises on any input the kernel does not take and
    on a failed build or launch."""
    global moment_launches
    _check_p(p)
    _check_kv(k, v)
    b, hkv, m, d = k.shape
    dv = v.shape[-1]
    dev = _check_cuda((d, dv), k=k, v=v)
    if m < 1:
        raise ValueError("k and v hold no keys")
    mom = Moments(*(torch.empty(s, dtype=torch.float32, device=dev)
                    for s in _moment_shapes(b, hkv, d, dv)))
    if p < 2:   # the kernel writes m2 and g2 only at p=2
        mom.m2.zero_()
        mom.g2.zero_()
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fastmax_noncausal_moments(
            _KERNEL_DTYPES[k.dtype], k.data_ptr(), v.data_ptr(),
            *[t.data_ptr() for t in mom], b * hkv, m, d, dv, p, stream)
    if err != 0:
        raise RuntimeError(f"fastmax_noncausal_moments launch failed: CUDA "
                           f"error {err}")
    moment_launches += 1
    return mom


def noncausal_combine_cuda(q, mom, *, p: int = 2, denom_eps: float = 1e-6,
                           schedule=None):
    """Launch the combine kernel: pre-normalized q̂ [B,Hq,N,D] (float32 or
    bfloat16) against the moments `mom` (six contiguous float32 leaves in
    `compute_moments`'s layout, Hq % Hkv == 0). `schedule` (a
    `kernels.autotune.Schedule`, or None for `SPLIT_ROWS` and
    `MAX_SPLIT_ROWS`) sets the launch's `rows` and `split`. Returns
    o [B,Hq,N,Dv] in q's dtype. Raises on any input the kernel does not
    take (a knob out of range included) and on a failed build or
    launch."""
    global combine_launches
    _check_p(p)
    if q.dim() != 4:
        raise ValueError("q must be [B, Hq, N, D]")
    b, hq, n, d = q.shape
    if len(mom) != 6:
        raise ValueError("mom must be the 6-tuple (m0, m1, m2, g0, g1, g2)")
    hkv, dv = mom[1].shape[1], mom[1].shape[-1]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} % Hkv={hkv} != 0")
    if n < 1:
        raise ValueError("q holds no queries")
    dev = _check_cuda((d, dv), q=q)
    for t, shp in zip(mom, _moment_shapes(b, hkv, d, dv)):
        if (tuple(t.shape) != shp or t.dtype != torch.float32
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(
                f"moment leaf {tuple(t.shape)} {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()}); expected contiguous "
                f"float32 {shp} on {dev}")
    g = hq // hkv
    rows, split = ((SPLIT_ROWS, MAX_SPLIT_ROWS) if schedule is None
                   else (schedule.rows, schedule.split))
    if rows < 1:
        raise ValueError(f"schedule rows must be >= 1, got {rows}")
    lib = _lib()
    part = None
    if g * n <= split:
        qt = 1 << (g * n - 1).bit_length()
        nsplit = -(-lib.fastmax_noncausal_rows(d, p) // rows)
        part = torch.empty(b * hkv * nsplit * qt * (dv + 1),
                           dtype=torch.float32, device=dev)
    o = torch.empty(b, hq, n, dv, dtype=q.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fastmax_noncausal_combine(
            _KERNEL_DTYPES[q.dtype], q.data_ptr(),
            *[t.data_ptr() for t in mom],
            None if part is None else part.data_ptr(), o.data_ptr(),
            b * hkv, g, n, d, dv, p, rows, split, float(denom_eps), stream)
    if err != 0:
        raise RuntimeError(f"fastmax_noncausal_combine launch failed: CUDA "
                           f"error {err}")
    combine_launches += 1
    return o


def fastmax_noncausal_cuda(q, k, v, *, p: int = 2, denom_eps: float = 1e-6,
                           schedule=None):
    """Both launches: o [B,Hq,N,Dv] in q's dtype for pre-normalized
    q̂ [B,Hq,N,D], k̂ [B,Hkv,M,D], v [B,Hkv,M,Dv] (one dtype, float32 or
    bfloat16). `schedule` sets the combine's knobs (the moments have
    none)."""
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one dtype, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape[0] != q.shape[0] or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)}")
    mom = noncausal_moments_cuda(k, v, p=p)
    return noncausal_combine_cuda(q, mom, p=p, denom_eps=denom_eps,
                                  schedule=schedule)


def noncausal_moments_ref(k, v, *, p: int = 2,
                          chunk_size: int = 512) -> Moments:
    """Plain version of the moment kernel: the chunked moment sum, in the
    accumulator type of k (zeros for m2 and g2 at p=1)."""
    _check_p(p)
    _check_kv(k, v)
    return compute_moments_chunked(k, v, p=p, chunk_size=chunk_size)


def noncausal_combine_ref(q, mom, *, p: int = 2, denom_eps: float = 1e-6):
    """Plain version of the combine kernel: o in q's dtype."""
    _check_p(p)
    num, den = _combine_grouped(_group_queries(q, mom[1].shape[1]),
                                Moments(*mom), p=p)
    return _ungroup(num / (den + denom_eps)[..., None]).to(q.dtype)


def fastmax_noncausal_ref(q, k, v, *, p: int = 2, chunk_size: int = 512,
                          denom_eps: float = 1e-6):
    """Plain version of both launches (same results up to rounding):
    `core.fastmax.fastmax_noncausal`, o in q's dtype."""
    _check_p(p)
    _check_kv(k, v)
    return fastmax_noncausal(q, k, v, p=p, denom_eps=denom_eps,
                             chunk_size=chunk_size)
