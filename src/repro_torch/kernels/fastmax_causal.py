"""Causal fastmax prefill: the CUDA kernel's wrapper and its plain version.

Port of `repro/kernels/fastmax_causal.py::fastmax_causal_pallas` in its
prefill form (final carry emitted, optional `init_state` and `kv_mask`).
The kernel is `csrc/fastmax_causal.cu` (design notes there): two CUDA
launches, the prefix moments of every chunk of L = 128 keys into a
per-call workspace, then each chunk's queries against them plus the
chunk's own keys, over segments of the tokens that keep the workspace
within `_WORKSPACE_BUDGET`; `prefill_call` exposes the launches one by one
(and with `band` runs the hybrid kernel's combine, `kernels.hybrid_causal`);
`fastmax_causal_ref` is the plain PyTorch version with the same signature,
built on `core.fastmax._causal_scan`. `kernels.ops.fastmax_prefill_kernel`
picks between them by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.fastmax import Moments, _causal_scan

__all__ = ["fastmax_causal_cuda", "fastmax_causal_ref", "prefill_call",
           "CHUNK", "COLS", "column_groups", "feature_rows", "segment_tokens",
           "workspace_bytes", "check_kernel_inputs", "launches", "MAX_D"]

# calls of `fastmax_causal_cuda` that launched the kernel (one per call,
# though each call makes two CUDA launches: prefix moments, then combine)
launches = 0

# the prefill kernel's chunk L: keys per workspace slot (kL in the source)
CHUNK = 128
# value columns of one column group of the combine (kCols in the source)
COLS = 64
# bytes of workspace slots one call may hold: longer prompts run the two
# launches over segments of the tokens, each seeded with the last's carry
_WORKSPACE_BUDGET = 2 << 30

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the widest D the prefill and hybrid kernels take (`dims_ok` in the
# source: a feature row's code packs each index + 1 of its pair in 8 bits,
# `feature_table.cuh`)
MAX_D = 255


def _lib():
    from repro_torch.kernels import build

    lib = build.load("fastmax_causal")
    if not getattr(lib, "_typed", False):
        lib.fastmax_causal_prefix.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 19 + [ctypes.c_int] * 7
            + [ctypes.c_void_p])
        lib.fastmax_causal_prefix.restype = ctypes.c_int
        lib.fastmax_causal_combine.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p])
        lib.fastmax_causal_combine.restype = ctypes.c_int
        lib.hybrid_causal_combine.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
            + [ctypes.c_float, ctypes.c_void_p])
        lib.hybrid_causal_combine.restype = ctypes.c_int
        lib._typed = True
    return lib


def column_groups(dv: int) -> int:
    """The combine's default launch knob, column groups of `COLS` value
    columns a pass (the default of `kernels.autotune`'s `cols`, 64 x this;
    a `schedule` overrides it per call). Two (128 columns, one pass across
    Dv = 128: the query features are built once, not twice) above 64 value
    columns, else one: two hold twice the accumulators in registers, so an
    SM holds fewer blocks. Launch A keeps one: at two its 128 registers a
    thread halve the blocks an SM holds, and on an H100 it ran 5.9 against
    5.3 ms."""
    return 2 if dv > COLS else 1


def feature_rows(d: int, p: int) -> int:
    """Rows of the kernel's feature table: the constant, D linear, and at
    p=2 the D(D+1)/2 pairs a <= b."""
    return 1 + d + (d * (d + 1) // 2 if p >= 2 else 0)


def _slot_bytes(bh: int, d: int, dv: int, p: int) -> int:
    """Bytes of one workspace slot: BH x R rows of Dv float32 m entries
    and one float64 g entry."""
    return bh * feature_rows(d, p) * (4 * dv + 8)


def segment_tokens(bh: int, d: int, dv: int, p: int) -> int:
    """Tokens per segment (per pair of launches): as many chunks of L as
    keep the slots within `_WORKSPACE_BUDGET`, at least one."""
    return CHUNK * max(1, _WORKSPACE_BUDGET // _slot_bytes(bh, d, dv, p))


def workspace_bytes(bh: int, n: int, d: int, dv: int, p: int) -> int:
    """Bytes of one call's workspace: the slots of its longest segment,
    one carry per chunk of L, plus the float64 g column carried between
    segments (BH x R)."""
    chunks = -(-min(n, segment_tokens(bh, d, dv, p)) // CHUNK)
    return chunks * _slot_bytes(bh, d, dv, p) + 8 * bh * feature_rows(d, p)


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


def check_kernel_inputs(q, k, v, kv_mask, p: int, fn: str):
    """Check the inputs of a causal scan kernel (`fn`, for the messages):
    q [B,Hq,N,D], k [B,Hkv,N,D], v [B,Hkv,N,Dv], D and Dv divisible by 4
    with 4 <= D <= MAX_D (checked first, on any device), float32 or
    bfloat16, contiguous, on one CUDA device, p 1 or 2, and `kv_mask`
    [B, Hkv|1, N] or None. Returns the kernel's key weights, a contiguous
    float32 [B, Hkv, N] (ones without a mask)."""
    _check_inputs(q, k, v)
    d, dv = q.shape[-1], v.shape[-1]
    if d % 4 or dv % 4 or not (4 <= d <= MAX_D and dv >= 4):
        raise ValueError(f"{fn}: the kernel needs D and Dv divisible by 4, "
                         f"4 <= D <= {MAX_D} and Dv >= 4, got D={d}, "
                         f"Dv={dv}")
    if p not in (1, 2):
        raise ValueError(f"p must be 1 or 2, got {p}")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{fn} needs CUDA tensors, got {dev}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, _, n, _ = q.shape
    hkv = k.shape[1]
    if kv_mask is None:
        return torch.ones(b, hkv, n, dtype=torch.float32, device=dev)
    if kv_mask.dim() != 3 or kv_mask.shape[0] != b \
            or kv_mask.shape[1] not in (1, hkv) or kv_mask.shape[2] != n:
        raise ValueError(f"kv_mask must be [B, Hkv|1, N], got "
                         f"{tuple(kv_mask.shape)}")
    return kv_mask.to(device=dev, dtype=torch.float32).expand(
        b, hkv, n).contiguous()


def _aligned(t):
    """`t`, or a copy of it if it does not start on 16 bytes (the kernel
    reads the init_state rows as float4)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _Prefill:
    """One call of the prefill kernel with its inputs checked and its
    outputs and workspace allocated: `prefix(i)` and `combine(i)` make the
    two CUDA launches of segment i (timed apart by `chip_smoke.py`),
    `run()` every segment's in order. With `band` = w_eff >= 1 the combine
    is the hybrid kernel's (no `init_state`). `schedule.cols` (None:
    `column_groups`) sets the combine's value columns a pass."""

    def __init__(self, q, k, v, kv_mask, p, denom_eps, init_state, band=0,
                 schedule=None):
        self.w = check_kernel_inputs(
            q, k, v, kv_mask, p,
            "hybrid_causal_cuda" if band else "fastmax_causal_cuda")
        if band and init_state is not None:
            raise ValueError("the hybrid kernel takes no init_state")
        b, hq, n, d = q.shape
        hkv, dv = k.shape[1], v.shape[-1]
        dev, f32 = q.device, torch.float32
        shapes = _state_shapes(b, hkv, d, dv)
        self.init = [None] * 6
        if init_state is not None:
            self.init = []
            for t, shp in zip(init_state, shapes):
                if tuple(t.shape) != shp or t.device != dev:
                    raise ValueError(f"init_state leaf {tuple(t.shape)} on "
                                     f"{t.device}, expected {shp} on {dev}")
                self.init.append(_aligned(t.to(f32).contiguous()))
        self.q, self.k, self.v = q, k, v
        self.p, self.eps = p, float(denom_eps)
        self.bh, self.g, self.n, self.d, self.dv = b * hkv, hq // hkv, n, d, dv
        seg = segment_tokens(self.bh, d, dv, p)
        self.segments = [(t, min(seg, n - t)) for t in range(0, n, seg)]
        # the hybrid's chunks whose band reaches token 0 read no slot and
        # keys from token 0: they must lie in the first segment
        if min(band, n) > self.segments[0][1]:
            raise ValueError(f"a band of {band} tokens needs a first "
                             f"segment of as many, got "
                             f"{self.segments[0][1]}")
        self.band = band
        cols = COLS * column_groups(dv) if schedule is None else schedule.cols
        if cols % COLS:
            raise ValueError(f"schedule cols must be a multiple of {COLS}, "
                             f"got {cols}")
        self.ncg = cols // COLS
        self.workspace_bytes = workspace_bytes(self.bh, n, d, dv, p)
        r = self.bh * feature_rows(d, p)
        rows = -(-min(n, seg) // CHUNK) * r
        self.wsm = torch.empty(rows * dv, dtype=f32, device=dev)
        self.wsg = torch.empty(rows, dtype=torch.float64, device=dev)
        self.gcarry = torch.empty(r, dtype=torch.float64, device=dev)
        self.o = torch.empty(b, hq, n, dv, dtype=q.dtype, device=dev)
        # at p=1 the kernel writes no m2, g2
        alloc = torch.empty if p >= 2 else torch.zeros
        self.state = tuple(alloc(s, dtype=f32, device=dev) for s in shapes)
        self.dtype = _KERNEL_DTYPES[q.dtype]
        self.lib = _lib()

    def _check(self, err, what):
        if err != 0:
            raise RuntimeError(f"fastmax_causal {what} launch failed: CUDA "
                               f"error {err}")

    def prefix(self, i: int = 0):
        """Launch A of segment i: the carry before each of its chunks into
        the workspace, its final carry into `state` (and the g column,
        in float64, into `gcarry`). Segment 0 starts from `init_state`,
        a later one from the carry in `state` and `gcarry`."""
        t0, n = self.segments[i]
        init, gin = self.init, None
        if i > 0:
            init, gin = self.state, self.gcarry.data_ptr()
        with torch.cuda.device(self.q.device):
            stream = torch.cuda.current_stream().cuda_stream
            self._check(self.lib.fastmax_causal_prefix(
                self.dtype, self.k.data_ptr(), self.v.data_ptr(),
                self.w.data_ptr(),
                *[None if t is None else t.data_ptr() for t in init],
                *[t.data_ptr() for t in self.state], gin,
                self.gcarry.data_ptr(), self.wsm.data_ptr(),
                self.wsg.data_ptr(), self.bh, self.n, t0, n, self.d, self.dv,
                self.p, stream), "prefix")

    def combine(self, i: int = 0):
        """Launch B of segment i: its o from the workspace and each chunk's
        own keys (and with `band`, the band's keys before the chunk)."""
        t0, n = self.segments[i]
        args = (self.dtype, self.q.data_ptr(), self.k.data_ptr(),
                self.v.data_ptr(), self.w.data_ptr(), self.wsm.data_ptr(),
                self.wsg.data_ptr(), self.o.data_ptr(), self.bh, self.g,
                self.n, t0, n, self.d, self.dv, self.p)
        with torch.cuda.device(self.q.device):
            stream = torch.cuda.current_stream().cuda_stream
            if self.band:
                self._check(self.lib.hybrid_causal_combine(
                    *args, self.band, self.ncg, self.eps, stream),
                    "hybrid combine")
            else:
                self._check(self.lib.fastmax_causal_combine(
                    *args, self.ncg, self.eps, stream), "combine")

    def run(self):
        for i in range(len(self.segments)):
            self.prefix(i)
            self.combine(i)
        return self.o, self.state


def prefill_call(q, k, v, kv_mask=None, *, p: int = 2,
                 denom_eps: float = 1e-6, init_state=None,
                 band: int = 0, schedule=None) -> _Prefill:
    """The prefill kernel's call on these inputs, checked and allocated but
    not launched (its `prefix(i)`, `combine(i)` and `run()` launch; none of
    them counts in `launches`). Arguments as `fastmax_causal_cuda`; `band`
    >= 1 makes it the hybrid kernel's call with w_eff = `band`
    (`hybrid_causal.band_width`), which takes no `init_state`."""
    return _Prefill(q, k, v, kv_mask, p, denom_eps, init_state, band,
                    schedule)


def fastmax_causal_cuda(q, k, v, kv_mask=None, *, p: int = 2,
                        denom_eps: float = 1e-6, init_state=None,
                        schedule=None):
    """Launch the CUDA prefill kernel on pre-normalized q̂ [B,Hq,N,D],
    k̂ [B,Hkv,N,D], v [B,Hkv,N,Dv] (float32 or bfloat16, contiguous, on one
    CUDA device). `kv_mask` [B, Hkv|1, N] weights the keys; `init_state`
    seeds the carry with a moment tuple in the state layout. `schedule`
    (a `kernels.autotune.Schedule`, or None for `column_groups`) sets the
    combine's value columns a pass (`cols`).

    Returns (o [B,Hq,N,Dv] in q's dtype, state): the final carry
    (m0, m1, m2, g0, g1, g2) in float32, m2 m-major [B,Hkv,D,D,Dv]; at
    p=1, m2 and g2 are zeros. Raises on any input the kernel does not take
    and on a failed build or launch. Each call adds one to `launches`: the
    kernel is its two CUDA launches (prefix moments into a workspace of
    `workspace_bytes`, freed on return, then the combine), once per
    segment of `segment_tokens` (one at qwen3's prefill shapes).
    """
    global launches
    out = prefill_call(q, k, v, kv_mask, p=p, denom_eps=denom_eps,
                       init_state=init_state, schedule=schedule).run()
    launches += 1
    return out


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
