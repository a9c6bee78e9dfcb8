"""Causal fastmax backward (paper §2.5): the CUDA kernel's wrapper and its
plain version.

Port of `repro/kernels/fastmax_causal_bwd.py::fastmax_causal_bwd_pallas`.
The kernel is `csrc/fastmax_causal_bwd.cu` (design notes there);
`fastmax_causal_bwd_ref` is the plain PyTorch version with the same
results, built on `core.fastmax._causal_scan_cg_bwd`. `kernels.ops`
picks between them by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.fastmax import Moments, _causal_scan_cg_bwd
from repro_torch.kernels.fastmax_causal import (_KERNEL_DTYPES, _check_inputs,
                                                _state_shapes, pick_chunk)

__all__ = ["fastmax_causal_bwd_cuda", "fastmax_causal_bwd_ref", "kernel_chunk",
           "launches"]

# kernel launches made by `fastmax_causal_bwd_cuda` (one per call)
launches = 0

_COLS = 32           # Dv column block of the kernel
_MAX_GROUP = 64      # the kernel's chunk must hold an even number of keys


def _lib():
    from repro_torch.kernels import build

    lib = build.load("fastmax_causal_bwd")
    if not getattr(lib, "_typed", False):
        lib.fastmax_causal_bwd.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 19
            + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
        lib.fastmax_causal_bwd.restype = ctypes.c_int
        lib.fastmax_causal_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.fastmax_causal_bwd_smem_bytes.restype = ctypes.c_long
        lib._typed = True
    return lib


def kernel_chunk(g: int, d: int) -> int:
    """The kernel's own chunk length at group G and head dim D: the
    forward's rule rounded down to even (any chunking is exact, since the
    carry is a plain sum)."""
    c = pick_chunk(g, d, _lib().fastmax_causal_bwd_smem_bytes)
    c -= c % 2
    if c < 2:
        raise ValueError(f"G={g}, D={d} leaves the kernel no even chunk")
    return c


def _full_state(state, b, hkv, d, dv, like):
    """The six moments with m2/g2 filled in (None at p=1 -> zeros)."""
    shapes = _state_shapes(b, hkv, d, dv)
    out = []
    for t, shp in zip(state, shapes):
        if t is None:
            t = torch.zeros(shp, dtype=torch.float32, device=like.device)
        if tuple(t.shape) != shp:
            raise ValueError(f"state leaf {tuple(t.shape)}, expected {shp}")
        out.append(t)
    return out


def fastmax_causal_bwd_cuda(q, k, v, state, do, *, p: int = 2,
                            denom_eps: float = 1e-6,
                            return_dstate: bool = False):
    """Launch the CUDA §2.5 backward on pre-normalized q̂ [B,Hq,N,D],
    k̂ [B,Hkv,N,D], v [B,Hkv,N,Dv] (float32 or bfloat16, contiguous, one
    CUDA device), the forward's final carry `state` (f32, m2 m-major
    [B,Hkv,D,D,Dv], as `fastmax_causal_cuda` emits it; m2/g2 may be None
    at p=1) and the output cotangent `do` [B,Hq,N,Dv] in q's dtype.

    Returns (dq, dk, dv) in q's, k's and v's dtypes; with `return_dstate`
    also the cotangent of the scan's initial carry (f32 moment tuple). The
    residual `state` is never written: the kernel rebuilds the carry in a
    workspace copy. Raises on any input the kernel does not take and on a
    failed build or launch.
    """
    global launches
    _check_inputs(q, k, v)
    if p not in (1, 2):
        raise ValueError(f"p must be 1 or 2, got {p}")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"fastmax_causal_bwd_cuda needs CUDA tensors, got "
                         f"{dev}")
    if q.dtype not in _KERNEL_DTYPES or any(
            t.dtype != q.dtype for t in (k, v, do)):
        raise ValueError(f"q/k/v/do must share float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}/{do.dtype}")
    b, hq, n, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    if tuple(do.shape) != (b, hq, n, dv):
        raise ValueError(f"do {tuple(do.shape)}, expected {(b, hq, n, dv)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d % 4 or dv % 4:
        raise ValueError(f"the kernel needs D and Dv divisible by 4, got "
                         f"D={d}, Dv={dv}")
    g = hq // hkv
    if g > _MAX_GROUP:
        raise ValueError(f"G={g} query heads per kv head exceeds "
                         f"{_MAX_GROUP}")
    f32 = torch.float32
    m0, m1, m2, g0, g1, g2 = _full_state(state, b, hkv, d, dv, q)
    for t in (m0, m1, m2, g0, g1, g2):
        if t.device != dev:
            raise ValueError(f"state on {t.device}, q on {dev}")
    m0, m1, g0, g1 = (t.to(f32).contiguous() for t in (m0, m1, g0, g1))
    nb = -(-dv // _COLS)
    bh = b * hkv
    # workspaces: the kernel subtracts from copies, never from the residual
    m2w = m2.to(f32, memory_format=torch.contiguous_format, copy=True) \
        if p >= 2 else None
    # (repeat always copies; expand(...).contiguous() would hand the
    # residual itself to the kernel when nb == 1)
    g2w = g2.to(f32).reshape(1, bh, d, d).repeat(nb, 1, 1, 1)
    dq_part = torch.zeros(nb, b, hq, n, d, dtype=f32, device=dev)
    dk_part = torch.zeros(nb, b, hkv, n, d, dtype=f32, device=dev)
    dv_out = torch.empty(b, hkv, n, dv, dtype=v.dtype, device=dev)
    dm2 = torch.zeros(b, hkv, d, d, dv, dtype=f32, device=dev)
    dg2 = torch.zeros(nb, b, hkv, d, d, dtype=f32, device=dev)
    dm0 = torch.empty(b, hkv, dv, dtype=f32, device=dev)
    dm1 = torch.empty(b, hkv, d, dv, dtype=f32, device=dev)
    dg0 = torch.empty(nb, b, hkv, dtype=f32, device=dev)
    dg1 = torch.empty(nb, b, hkv, d, dtype=f32, device=dev)

    lib = _lib()
    c = kernel_chunk(g, d)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fastmax_causal_bwd(
            _KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), m0.data_ptr(), m1.data_ptr(), g0.data_ptr(),
            g1.data_ptr(), None if m2w is None else m2w.data_ptr(),
            g2w.data_ptr(), dq_part.data_ptr(), dk_part.data_ptr(),
            dv_out.data_ptr(), dm2.data_ptr(), dg2.data_ptr(),
            dm0.data_ptr(), dm1.data_ptr(), dg0.data_ptr(), dg1.data_ptr(),
            bh, g, n, d, dv, p, c, float(denom_eps), stream)
    if err != 0:
        raise RuntimeError(f"fastmax_causal_bwd launch failed: CUDA error "
                           f"{err}")
    launches += 1
    # per-Dv-block partials, summed in a fixed order
    grads = (dq_part.sum(0).to(q.dtype), dk_part.sum(0).to(k.dtype), dv_out)
    if not return_dstate:
        return grads
    return grads + ((dm0, dm1, dm2, dg0.sum(0), dg1.sum(0), dg2.sum(0)),)


def fastmax_causal_bwd_ref(q, k, v, state, do, *, p: int = 2,
                           chunk_size: int = 128, denom_eps: float = 1e-6,
                           return_dstate: bool = False):
    """Plain PyTorch version of the backward kernel (same signature and
    results, up to rounding): the §2.5 reverse scan at `chunk_size`.
    Returns (dq, dk, dv) in the input dtypes, plus the initial carry's
    cotangent (accumulator type) with `return_dstate`."""
    _check_inputs(q, k, v)
    b, _, _, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    final = Moments(*_full_state(state, b, hkv, d, dv, q))
    return _causal_scan_cg_bwd(p, chunk_size, denom_eps, (q, k, v, final),
                               do, return_dstate=return_dstate)
