"""Kernel entry points — port of `repro/kernels/ops.py` (serving half).

Dispatch is by the tensors' device, with no fallback:
  * CUDA tensors launch the hand-written kernels (`csrc/*.cu`), or raise;
  * CPU tensors take the kernels' plain versions — the tests' route.
The trainable `fastmax()` (forward + §2.5 backward kernel) and the
autotuner lookup belong to later slices of the port.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fastmax_causal as _fc
from repro_torch.kernels import fastmax_decode as _fd
from repro_torch.kernels.ref import fastmax_decode_ref

__all__ = ["fastmax_prefill_kernel", "fastmax_decode", "launch_counts",
           "reset_launch_counts"]


def _route(x: torch.Tensor) -> str:
    if x.device.type == "cuda":
        return "cuda"
    if x.device.type == "cpu":
        return "plain"
    raise ValueError(f"no fastmax kernel for device {x.device}")


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
    return {"fastmax_causal": _fc.launches, "fastmax_decode": _fd.launches}


def reset_launch_counts() -> None:
    _fc.launches = 0
    _fd.launches = 0
