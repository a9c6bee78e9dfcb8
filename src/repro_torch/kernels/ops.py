"""Kernel entry points — port of `repro/kernels/ops.py` (fastmax).

Dispatch is by the tensors' device, with no fallback:
  * CUDA tensors launch the hand-written kernels (`csrc/*.cu`), or raise;
  * CPU tensors take the kernels' plain versions — the tests' route.
The trainable causal `fastmax()` pairs the forward kernel, which emits its
final moment carry, with the §2.5 backward kernel; the carry is the only
residual beyond (q, k, v). The noncausal one pairs the two-launch noncausal
kernel with autograd of the plain `core.fastmax.fastmax_noncausal`, as the
reference does (it has no noncausal backward kernel).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fastmax_causal as _fc
from repro_torch.kernels import fastmax_causal_bwd as _fb
from repro_torch.kernels import fastmax_decode as _fd
from repro_torch.kernels import fastmax_noncausal as _fn
from repro_torch.kernels.ref import fastmax_decode_ref

__all__ = ["fastmax", "fastmax_bwd", "fastmax_prefill_kernel",
           "fastmax_decode", "launch_counts", "reset_launch_counts"]


def _route(x: torch.Tensor) -> str:
    if x.device.type == "cuda":
        return "cuda"
    if x.device.type == "cpu":
        return "plain"
    raise ValueError(f"no fastmax kernel for device {x.device}")


class _FastmaxCausal(torch.autograd.Function):
    """Causal fastmax on pre-normalized q̂/k̂: the forward kernel (which
    emits its final carry) paired with the §2.5 backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, p, chunk_size, denom_eps):
        o, state = fastmax_prefill_kernel(q, k, v, p=p, chunk_size=chunk_size,
                                          denom_eps=denom_eps)
        if p < 2:
            # don't hold the [B,Hkv,D,D,Dv] zeros placeholder as a residual
            state = state[:2] + (None,) + state[3:5] + (None,)
        ctx.save_for_backward(q, k, v, *(t for t in state if t is not None))
        ctx.cfg = (p, chunk_size, denom_eps)
        return o

    @staticmethod
    def backward(ctx, do):
        p, chunk_size, denom_eps = ctx.cfg
        q, k, v, *st = ctx.saved_tensors
        if p < 2:
            st = st[:2] + [None] + st[2:] + [None]
        dq, dk, dv = fastmax_bwd(q, k, v, tuple(st), do, p=p,
                                 chunk_size=chunk_size, denom_eps=denom_eps)
        return dq, dk, dv, None, None, None


class _FastmaxNoncausal(torch.autograd.Function):
    """Noncausal fastmax on pre-normalized q̂/k̂ (k, v may hold M != N
    keys): the moment + combine kernel forward; the backward is autograd
    of the plain moment path (one global moment sum, so no O(N M) scores),
    as the reference's `_fnc_bwd` is."""

    @staticmethod
    def forward(ctx, q, k, v, p, chunk_size, denom_eps):
        if _route(q) == "cuda":
            o = _fn.fastmax_noncausal_cuda(q.contiguous(), k.contiguous(),
                                           v.contiguous(), p=p,
                                           denom_eps=denom_eps)
        else:
            o = _fn.fastmax_noncausal_ref(q, k, v, p=p,
                                          chunk_size=chunk_size,
                                          denom_eps=denom_eps)
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (p, chunk_size, denom_eps)
        return o

    @staticmethod
    def backward(ctx, do):
        p, chunk_size, denom_eps = ctx.cfg
        prim = [x.detach().requires_grad_(True) for x in ctx.saved_tensors]
        with torch.enable_grad():
            o = _fn.fastmax_noncausal_ref(*prim, p=p,
                                          chunk_size=max(chunk_size, 512),
                                          denom_eps=denom_eps)
            dq, dk, dv = torch.autograd.grad(o, prim, do)
        return dq, dk, dv, None, None, None


def fastmax(q, k, v, *, p: int = 2, causal: bool = True,
            chunk_size: int = 128, denom_eps: float = 1e-6):
    """Trainable kernel-backed fastmax on pre-normalized q̂/k̂ (GQA-aware),
    o in q's dtype. Noncausal k, v may hold M != N keys (cross-attention).
    `chunk_size` is the plain versions' chunk; the kernels pick their
    own."""
    if not causal:
        return _FastmaxNoncausal.apply(q, k, v, p, chunk_size, denom_eps)
    return _FastmaxCausal.apply(q, k, v, p, chunk_size, denom_eps)


def fastmax_bwd(q, k, v, state, do, *, p: int = 2, chunk_size: int = 128,
                denom_eps: float = 1e-6, return_dstate: bool = False):
    """Causal fastmax backward on the forward's final carry: (dq, dk, dv),
    plus the initial carry's cotangent with `return_dstate`. CUDA tensors
    launch the §2.5 backward kernel, CPU tensors take its plain version.
    `state` may carry None for m2/g2 at p < 2."""
    if _route(q) == "cuda":
        return _fb.fastmax_causal_bwd_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), state,
            do.to(q.dtype).contiguous(), p=p, denom_eps=denom_eps,
            return_dstate=return_dstate)
    return _fb.fastmax_causal_bwd_ref(q, k, v, state, do, p=p,
                                      chunk_size=chunk_size,
                                      denom_eps=denom_eps,
                                      return_dstate=return_dstate)


def fastmax_prefill_kernel(q, k, v, *, p: int = 2, chunk_size: int = 128,
                           denom_eps: float = 1e-6, kv_mask=None,
                           init_state=None):
    """Causal prefill on pre-normalized q̂/k̂. Returns (o, state): o in q's
    dtype and the final moment carry (m0, m1, m2, g0, g1, g2), m2 m-major
    [B,Hkv,D,D,Dv] — the layout `fastmax_decode` reads. `init_state`
    seeds the carry (resumable prefill); `kv_mask` [B, Hkv|1, N] weights
    the keys. `chunk_size` is the plain version's chunk; the kernel picks
    its own (the fold is associative: only rounding differs)."""
    if _route(q) == "cuda":
        return _fc.fastmax_causal_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), kv_mask, p=p,
            denom_eps=denom_eps, init_state=init_state)
    return _fc.fastmax_causal_ref(q, k, v, kv_mask, p=p,
                                  chunk_size=chunk_size, denom_eps=denom_eps,
                                  init_state=init_state)


def fastmax_decode(q, k, v, state, *, p: int = 2, denom_eps: float = 1e-6):
    """One decode step on pre-normalized q̂/k̂: folds (k̂, v) into `state`
    IN PLACE (the tensors of the moment tuple are mutated) and returns
    o [B,Hq,1,Dv] in q's dtype, computed against the updated moments."""
    if _route(q) == "cuda":
        return _fd.fastmax_decode_cuda(q.contiguous(), k.contiguous(),
                                       v.contiguous(), tuple(state), p=p,
                                       denom_eps=denom_eps)
    o, new = fastmax_decode_ref(q, k, v, tuple(state), p=p,
                                denom_eps=denom_eps)
    for dst, src in zip(state, new):
        dst.copy_(src)
    return o


def launch_counts() -> dict:
    """Kernel launches so far, per kernel (CPU calls launch nothing)."""
    return {"fastmax_causal": _fc.launches,
            "fastmax_causal_bwd": _fb.launches,
            "fastmax_decode": _fd.launches,
            "fastmax_noncausal_moments": _fn.moment_launches,
            "fastmax_noncausal_combine": _fn.combine_launches}


def reset_launch_counts() -> None:
    _fc.launches = 0
    _fb.launches = 0
    _fd.launches = 0
    _fn.moment_launches = 0
    _fn.combine_launches = 0
