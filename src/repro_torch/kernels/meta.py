"""The kernels' meta route: what a CUDA call would allocate, on `meta`.

Each function takes the `meta` tensors a kernel wrapper would be given and
returns `meta` outputs of the shapes and dtypes the CUDA wrapper returns.
On the way it allocates, on `meta`, every buffer the CUDA call allocates
(the input copies, the key weights, the workspaces and the outputs) in
the same order and for as long as the CUDA call holds them, so a count of
live storages (`launch/op_analysis.py`) sees the call's peak. Nothing is
launched, no plain version runs, and no value exists: reading one raises.
`kernels.ops` routes `meta` tensors here and records each would-be launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fastmax_causal as _fc
from repro_torch.kernels import fastmax_decode as _fd
from repro_torch.kernels import fastmax_noncausal as _fn
from repro_torch.kernels.work import feature_rows

__all__ = ["prefill", "bwd", "decode", "noncausal_moments",
           "noncausal_combine", "segments"]

_F32, _F64 = torch.float32, torch.float64


def segments(bh: int, n: int, d: int, dv: int, p: int) -> int:
    """Segments of the prefill's (and the backward's) launches at N."""
    return -(-n // _fc.segment_tokens(bh, d, dv, p))


def _key_weights(kv_mask, b, hkv, n, dev):
    # as `fastmax_causal.check_kernel_inputs` makes them
    if kv_mask is None:
        return torch.ones(b, hkv, n, dtype=_F32, device=dev)
    return kv_mask.to(device=dev, dtype=_F32).expand(b, hkv, n).contiguous()


def prefill(q, k, v, kv_mask=None, *, p: int = 2, init_state=None):
    """The causal prefill's call, or the hybrid kernel's (the same
    buffers): (o, final carry), and the key weights, the init_state copies
    and the workspace of `fastmax_causal.workspace_bytes` held until
    return."""
    b, hq, n, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    dev = q.device
    w = _key_weights(kv_mask, b, hkv, n, dev)
    init = ([] if init_state is None
            else [t.to(_F32).contiguous() for t in init_state])
    bh = b * hkv
    r = bh * feature_rows(d, p)
    rows = -(-min(n, _fc.segment_tokens(bh, d, dv, p)) // _fc.CHUNK) * r
    wsm = torch.empty(rows * dv, dtype=_F32, device=dev)
    wsg = torch.empty(rows, dtype=_F64, device=dev)
    gcarry = torch.empty(r, dtype=_F64, device=dev)
    o = torch.empty(b, hq, n, dv, dtype=q.dtype, device=dev)
    alloc = torch.empty if p >= 2 else torch.zeros
    state = tuple(alloc(s, dtype=_F32, device=dev)
                  for s in _fc._state_shapes(b, hkv, d, dv))
    del w, init, wsm, wsg, gcarry
    return o, state


def bwd(q, k, v, state, do, *, p: int = 2, return_dstate: bool = False):
    """The §2.5 backward's call: (dq, dk, dv[, dstate]), and the carry
    copies and the workspace of `fastmax_causal_bwd.bwd_workspace_bytes`
    held until return."""
    b, hq, n, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    dev = q.device
    fin = [None if (p < 2 and j in (2, 5)) else t.to(_F32).contiguous()
           for j, t in enumerate(state)]
    bh = b * hkv
    seg = _fc.segment_tokens(bh, d, dv, p)
    r = bh * feature_rows(d, p)
    rows = -(-min(n, seg) // _fc.CHUNK) * r
    ws = [torch.empty(rows * dv, dtype=_F32, device=dev),
          torch.empty(rows, dtype=_F64, device=dev),
          torch.empty(rows * dv, dtype=_F32, device=dev),
          torch.empty(rows, dtype=_F32, device=dev),
          torch.empty(b * hq * n * dv, dtype=_F32, device=dev),
          torch.empty(b * hq * n, dtype=_F32, device=dev)]
    if n > seg:
        ws += [torch.empty(r * dv, dtype=_F32, device=dev),
               torch.empty(r, dtype=_F32, device=dev)]
    grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    if return_dstate:
        alloc = torch.empty if p >= 2 else torch.zeros
        grads += (tuple(alloc(s, dtype=_F32, device=dev)
                        for s in _fc._state_shapes(b, hkv, d, dv)),)
    del fin, ws
    return grads


def decode(q, k, v, state, *, p: int = 2, schedule=None):
    """The decode step's call: o, and its partial numerators held until
    return. `state` is the carry the CUDA call updates in place: on meta
    there is nothing to update."""
    b, hq, _, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    g = hq // hkv
    rows, group = ((_fd.M2_ROWS_PER_BLOCK, _fd.GROUP) if schedule is None
                   else (schedule.rows, schedule.group))
    rows = min(rows, d * d)
    nsplit = -(-d * d // rows) if p >= 2 else 0
    part = torch.empty(max(1, b * hkv * nsplit * min(g, group) * dv),
                       dtype=_F32, device=q.device)
    o = torch.empty(b, hq, 1, dv, dtype=q.dtype, device=q.device)
    del part, state
    return o


def noncausal_moments(k, v, *, p: int = 2):
    """The moment launch's call: the float32 moments (`Moments`)."""
    b, hkv, _, d = k.shape
    dv = v.shape[-1]
    alloc = torch.empty if p >= 2 else torch.zeros
    shapes = _fn._moment_shapes(b, hkv, d, dv)
    return _fn.Moments(*(alloc(s, dtype=_F32, device=k.device)
                         for s in shapes))


def noncausal_combine(q, mom, *, p: int = 2, schedule=None):
    """The combine launch's call: o, and the split combine's partials
    (few query rows) held until return."""
    b, hq, n, d = q.shape
    hkv, dv = mom[1].shape[1], mom[1].shape[-1]
    g = hq // hkv
    rows, split = ((_fn.SPLIT_ROWS, _fn.MAX_SPLIT_ROWS) if schedule is None
                   else (schedule.rows, schedule.split))
    part = None
    if g * n <= split:
        qt = 1 << (g * n - 1).bit_length()
        nsplit = -(-feature_rows(d, p) // rows)
        part = torch.empty(b * hkv * nsplit * qt * (dv + 1), dtype=_F32,
                           device=q.device)
    o = torch.empty(b, hq, n, dv, dtype=q.dtype, device=q.device)
    del part
    return o
