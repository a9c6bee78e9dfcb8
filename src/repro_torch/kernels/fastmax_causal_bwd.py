"""Causal fastmax backward (paper §2.5): the CUDA kernel's wrapper and its
plain version.

Port of `repro/kernels/fastmax_causal_bwd.py::fastmax_causal_bwd_pallas`.
The kernel is `csrc/fastmax_causal_bwd.cu` (design notes there): four CUDA
launches per segment of the tokens, run last segment first — the carry
before each chunk of L = 128 tokens rebuilt from the final carry into a
workspace, the queries (dq, and u and sden into a second workspace), the
cotangent of the carry after each chunk into a third, then the keys (dk,
dv); `bwd_call` exposes them one by one. `fastmax_causal_bwd_ref` is the
plain PyTorch version with the same results, built on
`core.fastmax._causal_scan_cg_bwd`. `kernels.ops` picks between them by
the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.fastmax import Moments, _causal_scan_cg_bwd
from repro_torch.kernels.fastmax_causal import (CHUNK, _KERNEL_DTYPES,
                                                _aligned, _check_inputs,
                                                _state_shapes, feature_rows,
                                                segment_tokens)

__all__ = ["fastmax_causal_bwd_cuda", "fastmax_causal_bwd_ref", "bwd_call",
           "bwd_workspace_bytes", "check_widths", "column_groups",
           "launch_smem_bytes", "launches", "MAX_D", "MAX_DV", "SMEM_LIMIT"]

# calls of `fastmax_causal_bwd_cuda` that launched the kernel (one per call,
# though each call makes four CUDA launches per segment)
launches = 0

MAX_D, MAX_DV = 192, 128   # D and Dv the kernel takes at most (kMaxD, kMaxDv)
# shared memory one block may have on an H100 (227 KB, opt-in)
SMEM_LIMIT = 232_448
# the source's tiling constants (feature_table.cuh, fastmax_causal_bwd.cu)
_THREADS, _TILE, _COLS, _STEP, _PS, _RT, _YS = 256, 64, 64, 32, 72, 64, 68


def check_widths(d: int, dv: int) -> None:
    """Raise unless the kernel takes D = `d` and Dv = `dv`."""
    if d % 4 or dv % 4 or not (4 <= d <= MAX_D and 4 <= dv <= MAX_DV):
        raise ValueError(f"the backward kernel needs D and Dv divisible by "
                         f"4, 4 <= D <= {MAX_D} and 4 <= Dv <= {MAX_DV}, "
                         f"got D={d}, Dv={dv}")


def column_groups(d: int, dv: int) -> tuple:
    """(NCV, NCK): the column groups of 64 over Dv and over D that launches
    B' and D are instantiated with (`width_of` in the source)."""
    if d > 2 * _COLS:
        return 2, 3
    g = 2 if d > _COLS or dv > _COLS else 1
    return g, g


def launch_smem_bytes(d: int, dv: int, p: int) -> dict:
    """Shared memory per block of each of the four launches, static and
    dynamic, by the source's formulas (`query_smem_floats`,
    `key_smem_floats` and the arrays each kernel declares)."""
    ncv, nck = column_groups(d, dv)
    qs, bcv, bck = d + 1, _COLS * ncv, _COLS * nck
    keys_rows = 4 * _STEP * qs                      # [32, D + 1] keys
    acc = 8 if p == 1 else 4                        # the g partials' type
    slots = 4 * 2 * _STEP * _TILE + acc * _THREADS + 4 * _TILE + keys_rows
    cot = 4 * 2 * _STEP * _TILE + 4 * (_THREADS + _STEP + _TILE) + keys_rows
    pass1 = _STEP * (bcv + _PS + qs)
    pass2 = _RT * (dv + 4 + _YS)
    intra_q = _STEP * (qs + bck + dv + 1 + _PS)
    queries = 4 * (2 * _TILE * qs + (dv + 4) * _TILE + _TILE
                   + max(pass1, pass2, intra_q) + _TILE + _RT)
    zs = max(bcv, dv + 4)
    zpass = _RT * (zs + _PS + _YS)
    us = bcv + 4 if nck > ncv else bcv + dv + 1     # u once, or twice
    intra_k = _STEP * (qs + bck + us + 2 * _PS) + _STEP
    keys = 4 * (2 * _TILE * qs + (dv + 4) * _TILE + max(zpass, intra_k)
                + _TILE + _STEP + _RT)
    return {"slots": slots, "queries": queries, "cot": cot, "keys": keys}


def _lib():
    from repro_torch.kernels import build

    lib = build.load("fastmax_causal_bwd")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fastmax_causal_bwd_slots.argtypes = (
            [i32] + [ptr] * 8 + [i32] + [ptr] * 2 + [i32] * 7 + [ptr])
        lib.fastmax_causal_bwd_queries.argtypes = (
            [i32] + [ptr] * 9 + [i32] * 8 + [ctypes.c_float, ptr])
        lib.fastmax_causal_bwd_cot.argtypes = (
            [i32] + [ptr] * 5 + [i32] + [ptr] * 8 + [i32] * 8 + [ptr])
        lib.fastmax_causal_bwd_keys.argtypes = (
            [i32] + [ptr] * 9 + [i32] * 8 + [ptr])
        for fn in ("slots", "queries", "cot", "keys"):
            getattr(lib, f"fastmax_causal_bwd_{fn}").restype = i32
        lib._typed = True
    return lib


def bwd_workspace_bytes(b: int, hq: int, hkv: int, n: int, d: int, dv: int,
                        p: int) -> int:
    """Bytes of one call's workspace: per chunk of the longest segment a
    carry slot (float32 m rows, float64 g column) and a cotangent slot
    (float32), u and sden for every query row (float32), and, over
    several segments, the cotangent carried between them."""
    bh, r = b * hkv, feature_rows(d, p)
    seg = segment_tokens(bh, d, dv, p)
    chunks = -(-min(n, seg) // CHUNK)
    carry = 4 * bh * r * (dv + 1) if n > seg else 0
    return (chunks * bh * r * ((4 * dv + 8) + (4 * dv + 4))
            + 4 * b * hq * n * (dv + 1) + carry)


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


class _Backward:
    """One call of the backward kernel with its inputs checked and its
    outputs and workspaces allocated: `slots(i)`, `queries(i)`, `cot(i)`
    and `keys(i)` make the four CUDA launches of segment i (timed apart by
    `chip_smoke.py`), `run()` every segment's, the last segment first."""

    def __init__(self, q, k, v, state, do, p, denom_eps, return_dstate):
        _check_inputs(q, k, v)
        if p not in (1, 2):
            raise ValueError(f"p must be 1 or 2, got {p}")
        check_widths(q.shape[-1], v.shape[-1])
        dev = q.device
        if dev.type != "cuda":
            raise ValueError(f"fastmax_causal_bwd_cuda needs CUDA tensors, "
                             f"got {dev}")
        if q.dtype not in _KERNEL_DTYPES or any(
                t.dtype != q.dtype for t in (k, v, do)):
            raise ValueError(f"q/k/v/do must share float32 or bfloat16, got "
                             f"{q.dtype}/{k.dtype}/{v.dtype}/{do.dtype}")
        b, hq, n, d = q.shape
        hkv, dv = k.shape[1], v.shape[-1]
        if tuple(do.shape) != (b, hq, n, dv):
            raise ValueError(f"do {tuple(do.shape)}, expected "
                             f"{(b, hq, n, dv)}")
        for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
            if t.device != dev:
                raise ValueError(f"{name} on {t.device}, q on {dev}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        f32 = torch.float32
        # read only: the residual is never written; m2, g2 unused at p=1
        self.fin = []
        for j, (t, shp) in enumerate(zip(state, _state_shapes(b, hkv, d,
                                                              dv))):
            if p < 2 and j in (2, 5):
                self.fin.append(None)
                continue
            if t is None or tuple(t.shape) != shp or t.device != dev:
                got = ("None" if t is None
                       else f"{tuple(t.shape)} on {t.device}")
                raise ValueError(f"state leaf {got}, expected {shp} on {dev}")
            self.fin.append(_aligned(t.to(f32).contiguous()))
        self.q, self.k, self.v, self.do = q, k, v, do
        self.p, self.eps = p, float(denom_eps)
        self.bh, self.g, self.n, self.d, self.dv = b * hkv, hq // hkv, n, d, dv
        seg = segment_tokens(self.bh, d, dv, p)
        self.segments = [(t, min(seg, n - t)) for t in range(0, n, seg)]
        self.workspace_bytes = bwd_workspace_bytes(b, hq, hkv, n, d, dv, p)
        r = self.bh * feature_rows(d, p)
        rows = -(-min(n, seg) // CHUNK) * r
        self.wsm = torch.empty(rows * dv, dtype=f32, device=dev)
        self.wsg = torch.empty(rows, dtype=torch.float64, device=dev)
        self.wzm = torch.empty(rows * dv, dtype=f32, device=dev)
        self.wzg = torch.empty(rows, dtype=f32, device=dev)
        self.uws = torch.empty(b * hq * n * dv, dtype=f32, device=dev)
        self.sws = torch.empty(b * hq * n, dtype=f32, device=dev)
        self.zc = None
        if len(self.segments) > 1:
            self.zc = (torch.empty(r * dv, dtype=f32, device=dev),
                       torch.empty(r, dtype=f32, device=dev))
        self.dq = torch.empty_like(q)
        self.dk = torch.empty_like(k)
        self.dvo = torch.empty_like(v)
        self.dstate = None
        if return_dstate:
            # at p=1 the kernel writes no m2, g2
            alloc = torch.empty if p >= 2 else torch.zeros
            self.dstate = tuple(alloc(s, dtype=f32, device=dev)
                                for s in _state_shapes(b, hkv, d, dv))
        self.dtype = _KERNEL_DTYPES[q.dtype]
        self.lib = _lib()

    def _launch(self, fn, *args):
        with torch.cuda.device(self.q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(self.lib, f"fastmax_causal_bwd_{fn}")(
                self.dtype, *args, stream)
        if err != 0:
            raise RuntimeError(f"fastmax_causal_bwd {fn} launch failed: CUDA "
                               f"error {err}")

    def _last(self, i):
        return i == len(self.segments) - 1

    def slots(self, i: int = 0):
        """Launch A' of segment i: the carry before each of its chunks into
        the carry slots, rebuilt from the final carry (the last segment) or
        from slot 0 of the segment after it (the launch before, in place)."""
        t0, n = self.segments[i]
        fin = [None if t is None else t.data_ptr() for t in self.fin]
        self._launch("slots", self.k.data_ptr(), self.v.data_ptr(), *fin,
                     int(not self._last(i)), self.wsm.data_ptr(),
                     self.wsg.data_ptr(), self.bh, self.n, t0, n, self.d,
                     self.dv, self.p)

    def queries(self, i: int = 0):
        """Launch B' of segment i: dq, u and sden of its query rows."""
        t0, n = self.segments[i]
        self._launch("queries", self.q.data_ptr(), self.k.data_ptr(),
                     self.v.data_ptr(), self.do.data_ptr(),
                     self.wsm.data_ptr(), self.wsg.data_ptr(),
                     self.dq.data_ptr(), self.uws.data_ptr(),
                     self.sws.data_ptr(), self.bh, self.g, self.n, t0, n,
                     self.d, self.dv, self.p, self.eps)

    def cot(self, i: int = 0):
        """Launch C of segment i: the cotangent of the carry after each of
        its chunks into the cotangent slots, seeded with the total of the
        segment after it; segment 0's total is dstate."""
        t0, n = self.segments[i]
        zc = (None, None) if self.zc is None else [t.data_ptr()
                                                   for t in self.zc]
        ds = [None] * 6
        if self.dstate is not None and i == 0:
            ds = [t.data_ptr() for t in self.dstate]
        self._launch("cot", self.q.data_ptr(), self.uws.data_ptr(),
                     self.sws.data_ptr(), *zc, int(not self._last(i)), *ds,
                     self.wzm.data_ptr(), self.wzg.data_ptr(), self.bh,
                     self.g, self.n, t0, n, self.d, self.dv, self.p)

    def keys(self, i: int = 0):
        """Launch D of segment i: dk and dv of its keys."""
        t0, n = self.segments[i]
        self._launch("keys", self.q.data_ptr(), self.k.data_ptr(),
                     self.v.data_ptr(), self.uws.data_ptr(),
                     self.sws.data_ptr(), self.wzm.data_ptr(),
                     self.wzg.data_ptr(), self.dk.data_ptr(),
                     self.dvo.data_ptr(), self.bh, self.g, self.n, t0, n,
                     self.d, self.dv, self.p)

    def run(self):
        for i in reversed(range(len(self.segments))):
            self.slots(i)
            self.queries(i)
            self.cot(i)
            self.keys(i)
        grads = (self.dq, self.dk, self.dvo)
        return grads if self.dstate is None else grads + (self.dstate,)


def bwd_call(q, k, v, state, do, *, p: int = 2, denom_eps: float = 1e-6,
             return_dstate: bool = False) -> _Backward:
    """The backward kernel's call on these inputs, checked and allocated
    but not launched (its `slots(i)`, `queries(i)`, `cot(i)`, `keys(i)` and
    `run()` launch; none of them counts in `launches`). Arguments as
    `fastmax_causal_bwd_cuda`."""
    return _Backward(q, k, v, state, do, p, denom_eps, return_dstate)


def fastmax_causal_bwd_cuda(q, k, v, state, do, *, p: int = 2,
                            denom_eps: float = 1e-6,
                            return_dstate: bool = False):
    """Launch the CUDA §2.5 backward on pre-normalized q̂ [B,Hq,N,D],
    k̂ [B,Hkv,N,D], v [B,Hkv,N,Dv] (float32 or bfloat16, contiguous, one
    CUDA device, D at most 192 and Dv at most 128), the forward's final
    carry `state` (f32, m2 m-major [B,Hkv,D,D,Dv], as `fastmax_causal_cuda`
    emits it; m2/g2 may be None at p=1) and the output cotangent `do`
    [B,Hq,N,Dv] in q's dtype.

    Returns (dq, dk, dv) in q's, k's and v's dtypes; with `return_dstate`
    also the cotangent of the scan's initial carry (f32 moment tuple). The
    residual `state` is never written. Raises on any input the kernel does
    not take and on a failed build or launch. Each call adds one to
    `launches`: the kernel is its four CUDA launches per segment of
    `segment_tokens` (one at qwen3's training shapes, eight of one chunk
    each at MLA's, B = 2 with 128 kv heads at D = 192), with a workspace of
    `bwd_workspace_bytes`, freed on return.
    """
    global launches
    out = bwd_call(q, k, v, state, do, p=p, denom_eps=denom_eps,
                   return_dstate=return_dstate).run()
    launches += 1
    return out


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
