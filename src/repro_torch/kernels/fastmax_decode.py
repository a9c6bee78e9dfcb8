"""One-token fastmax decode: the CUDA kernel's wrapper.

Port of `repro/kernels/fastmax_decode.py::fastmax_decode_pallas`. The
kernel is `csrc/fastmax_decode.cu` (design notes there); its plain version
is `repro_torch.kernels.ref.fastmax_decode_ref`.
`kernels.ops.fastmax_decode` picks between them by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["fastmax_decode_cuda", "launches", "M2_ROWS_PER_BLOCK", "GROUP"]

# kernel launches made by `fastmax_decode_cuda` (one per call)
launches = 0

# Launch knobs, the defaults of `kernels.autotune`'s `rows` and `group`
# (a `schedule` overrides them per call):
# - m2 rows each block of the first launch streams (16384 / 512 = 32 blocks
#   per (batch, kv-head) at D = 128). Fewer rows: more blocks against the
#   132 SMs (at B * Hkv = 4, 128 of them), but more partial numerators for
#   the second launch, one block per (batch, kv-head), to read and sum.
M2_ROWS_PER_BLOCK = 512
# - queries of one head a launch pair contracts at once (1..16, every group
#   size is compiled): a larger G runs the pair once per group of at most
#   this many, the token folded in by the first. A smaller group holds
#   fewer partials in registers (more blocks an SM) but re-reads m2 once
#   per group.
GROUP = 16

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    from repro_torch.kernels import build

    lib = build.load("fastmax_decode")
    if not getattr(lib, "_typed", False):
        lib.fastmax_decode_step.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p])
        lib.fastmax_decode_step.restype = ctypes.c_int
        lib._typed = True
    return lib


def fastmax_decode_cuda(q, k, v, state, *, p: int = 2,
                        denom_eps: float = 1e-6, schedule=None):
    """Launch the CUDA decode step on pre-normalized q̂ [B,Hq,1,D],
    k̂ [B,Hkv,1,D], v [B,Hkv,1,Dv] (float32 or bfloat16).

    `state` is the moment tuple (m0, m1, m2, g0, g1, g2) in float32, each
    leaf contiguous on the same device; it is UPDATED IN PLACE (the new
    token folded in), never copied, so a leaf may be a view into a stacked
    per-layer state. Any G = Hq / Hkv: past `GROUP` queries per head the
    kernel's launch pair runs once per group of queries, and only the
    first folds the token in. At p=1, m2 and g2 are left as they are.
    `schedule` (a `kernels.autotune.Schedule`, or None for
    `M2_ROWS_PER_BLOCK` and `GROUP`) sets the launch's `rows` and `group`.
    Returns o [B,Hq,1,Dv] in q's dtype. Raises on any input the kernel does
    not take (a knob out of range included) and on a failed build or
    launch.
    """
    global launches
    if p not in (1, 2):
        raise ValueError(f"p must be 1 or 2, got {p}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, 1, D]")
    b, hq, one, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    if one != 1 or k.shape != (b, hkv, 1, d) or v.shape[:3] != (b, hkv, 1):
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} % Hkv={hkv} != 0")
    if dv % 4 or dv > 1024:
        raise ValueError(f"the kernel needs Dv divisible by 4 and <= 1024, "
                         f"got {dv}")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"fastmax_decode_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    shapes = ((b, hkv, dv), (b, hkv, d, dv), (b, hkv, d, d, dv), (b, hkv),
              (b, hkv, d), (b, hkv, d, d))
    if len(state) != 6:
        raise ValueError("state must be the 6-tuple (m0, m1, m2, g0, g1, g2)")
    for t, shp in zip(state, shapes):
        if (tuple(t.shape) != shp or t.dtype != torch.float32
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(
                f"state leaf {tuple(t.shape)} {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()}); expected contiguous "
                f"float32 {shp} on {dev}")

    g = hq // hkv
    rows, group = ((M2_ROWS_PER_BLOCK, GROUP) if schedule is None
                   else (schedule.rows, schedule.group))
    if rows < 1:
        raise ValueError(f"schedule rows must be >= 1, got {rows}")
    rows = min(rows, d * d)
    nsplit = -(-d * d // rows) if p >= 2 else 0
    part = torch.empty(max(1, b * hkv * nsplit * min(g, group) * dv),
                       dtype=torch.float32, device=dev)
    o = torch.empty(b, hq, 1, dv, dtype=q.dtype, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fastmax_decode_step(
            _KERNEL_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *[t.data_ptr() for t in state], part.data_ptr(), o.data_ptr(),
            b * hkv, g, d, dv, p, rows, group, float(denom_eps), stream)
    if err != 0:
        raise RuntimeError(f"fastmax_decode_step launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return o
