"""Causal fastmax prefill: the CUDA kernel's wrapper and its plain version.

Port of `repro/kernels/fastmax_causal.py::fastmax_causal_pallas` in its
prefill form (final carry emitted, optional `init_state` and `kv_mask`).
The kernel is `csrc/fastmax_causal.cu` (design notes there);
`fastmax_causal_ref` is the plain PyTorch version with the same signature,
built on `core.fastmax._causal_scan`. `kernels.ops.fastmax_prefill_kernel`
picks between them by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.fastmax import Moments, _causal_scan

__all__ = ["fastmax_causal_cuda", "fastmax_causal_ref", "pick_chunk",
           "launches"]

# kernel launches made by `fastmax_causal_cuda` (one per call)
launches = 0

_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_MAX_ROWS = 128       # G * C query rows per chunk (4 per thread)

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    from repro_torch.kernels import build

    lib = build.load("fastmax_causal")
    if not getattr(lib, "_typed", False):
        lib.fastmax_causal_prefill.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 17
            + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
        lib.fastmax_causal_prefill.restype = ctypes.c_int
        lib.fastmax_causal_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.fastmax_causal_smem_bytes.restype = ctypes.c_long
        lib._typed = True
    return lib


def pick_chunk(g: int, d: int, smem_bytes) -> int:
    """Chunk length of the kernel: at most 64 tokens and 128 query rows
    (G * C <= 128), halved until the block's shared memory fits the card."""
    if g > _MAX_ROWS:
        raise ValueError(f"G={g} query heads per kv head exceeds "
                         f"{_MAX_ROWS}")
    c = min(64, _MAX_ROWS // g)
    while smem_bytes(g, c, d) > _SMEM_LIMIT:
        if c == 1:
            raise ValueError(f"head dim D={d} does not fit the kernel's "
                             f"shared memory")
        c //= 2
    return c


def _state_shapes(b, hkv, d, dv):
    return ((b, hkv, dv), (b, hkv, d, dv), (b, hkv, d, d, dv), (b, hkv),
            (b, hkv, d), (b, hkv, d, d))


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, N, D]")
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    if k.shape != (b, hkv, n, d) or v.shape[:3] != (b, hkv, n):
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} % Hkv={hkv} != 0")


def fastmax_causal_cuda(q, k, v, kv_mask=None, *, p: int = 2,
                        denom_eps: float = 1e-6, init_state=None):
    """Launch the CUDA prefill kernel on pre-normalized q̂ [B,Hq,N,D],
    k̂ [B,Hkv,N,D], v [B,Hkv,N,Dv] (float32 or bfloat16, contiguous, on one
    CUDA device). `kv_mask` [B, Hkv|1, N] weights the keys; `init_state`
    seeds the carry with a moment tuple in the state layout.

    Returns (o [B,Hq,N,Dv] in q's dtype, state): the final carry
    (m0, m1, m2, g0, g1, g2) in float32, m2 m-major [B,Hkv,D,D,Dv]; at
    p=1, m2 and g2 are zeros. Raises on any input the kernel does not take
    and on a failed build or launch.
    """
    global launches
    _check_inputs(q, k, v)
    if p not in (1, 2):
        raise ValueError(f"p must be 1 or 2, got {p}")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"fastmax_causal_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, hq, n, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    if d % 4 or dv % 4:
        raise ValueError(f"the kernel needs D and Dv divisible by 4, got "
                         f"D={d}, Dv={dv}")
    g = hq // hkv
    f32 = torch.float32

    if kv_mask is None:
        w = torch.ones(b, hkv, n, dtype=f32, device=dev)
    else:
        if kv_mask.dim() != 3 or kv_mask.shape[0] != b \
                or kv_mask.shape[1] not in (1, hkv) or kv_mask.shape[2] != n:
            raise ValueError(f"kv_mask must be [B, Hkv|1, N], got "
                             f"{tuple(kv_mask.shape)}")
        w = kv_mask.to(device=dev, dtype=f32).expand(b, hkv, n).contiguous()
    shapes = _state_shapes(b, hkv, d, dv)
    if init_state is not None:
        init = []
        for t, shp in zip(init_state, shapes):
            if tuple(t.shape) != shp or t.device != dev:
                raise ValueError(f"init_state leaf {tuple(t.shape)} on "
                                 f"{t.device}, expected {shp} on {dev}")
            init.append(t.to(f32).contiguous())
        init_ptrs = [t.data_ptr() for t in init]
    else:
        init, init_ptrs = None, [None] * 6

    lib = _lib()
    c = pick_chunk(g, d, lib.fastmax_causal_smem_bytes)
    o = torch.empty(b, hq, n, dv, dtype=q.dtype, device=dev)
    state = tuple(torch.empty(s, dtype=f32, device=dev) for s in shapes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fastmax_causal_prefill(
            _KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            w.data_ptr(), *init_ptrs, o.data_ptr(),
            *[t.data_ptr() for t in state],
            b * hkv, g, n, d, dv, p, c, float(denom_eps), stream)
    if err != 0:
        raise RuntimeError(f"fastmax_causal_prefill launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return o, state


def fastmax_causal_ref(q, k, v, kv_mask=None, *, p: int = 2,
                       chunk_size: int = 128, denom_eps: float = 1e-6,
                       init_state=None):
    """Plain PyTorch version of the prefill kernel (same signature and
    results, up to rounding): the chunked causal scan. Returns (o in q's
    dtype, state tuple in the accumulator type)."""
    _check_inputs(q, k, v)
    b, _, n, _ = q.shape
    hkv = k.shape[1]
    if kv_mask is not None:
        kv_mask = kv_mask.expand(b, hkv, n)
    init = None if init_state is None else Moments(*init_state)
    o, final = _causal_scan(q, k, v, p=p, chunk_size=chunk_size,
                            kv_mask=kv_mask, denom_eps=denom_eps, init=init)
    if p < 2:
        final = final._replace(m2=torch.zeros_like(final.m2),
                               g2=torch.zeros_like(final.g2))
    return o.to(q.dtype), tuple(final)
