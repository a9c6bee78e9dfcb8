"""Decode-state protocol `init_state` / `prefill` / `step` for the fastmax
family — port of `repro/attention/state.py`.

The state of a fastmax layer is its moment tuple, independent of context
length. Backends declaring `decode_kernel` (fastmax-kernel) run prefill
and step through the CUDA kernels on that carry: prefill's final moments
come out of the prefill kernel, each step is the fused update+combine
decode kernel. There is no fallback for CUDA tensors; CPU tensors take the
kernels' plain versions (inside `kernels.ops`).

Unlike the functional reference, the port updates a layer's state IN
PLACE: `prefill` copies the new carry into the given moment tensors and
`step` folds the token into them, so the state may be a view into a
stacked [n_layers, ...] model state. The moments are therefore allocated
in their accumulator type from the start (float32 for bf16/f32
activations, float64 for float64 ones).

The softmax KV cache and the hybrid window leg come in later slices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.attention.registry import resolve
from repro_torch.attention.spec import AttentionSpec
from repro_torch.core.decode_state import init_fastmax_state
from repro_torch.core.fastmax import Moments, _causal_scan
from repro_torch.core.ref import normalize_qk
from repro_torch.kernels.ref import fastmax_decode_ref

__all__ = ["AttnState", "init_state", "prefill", "step"]


class AttnState(NamedTuple):
    """Per-layer decode state. fastmax uses `moments`; `kv` (the softmax
    KV cache) is not ported yet and stays None."""
    kv: Optional[object]
    moments: Optional[Moments]


def _check_fastmax(spec: AttentionSpec) -> None:
    if spec.family != "fastmax":
        raise NotImplementedError(
            f"{spec}: only the fastmax family is ported so far")


def init_state(spec: AttentionSpec, *, batch: int, n_kv_heads: int,
               q_head_dim: int, v_head_dim: int, max_len: int,
               dtype=torch.float32, device=None) -> AttnState:
    """Fresh per-layer state for `batch` sequences (max_len is unused by
    the fastmax family: its state does not grow)."""
    del max_len
    _check_fastmax(spec)
    backend = resolve(spec)
    if not backend.caps.decode:
        raise ValueError(f"backend {backend.name!r} has no decode path")
    mom = init_fastmax_state(batch, n_kv_heads, q_head_dim, v_head_dim,
                             p=spec.p,
                             dtype=torch.promote_types(dtype, torch.float32),
                             device=device)
    return AttnState(kv=None, moments=mom)


def _copy_into(dst: Moments, src) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


def prefill(q, k, v, spec: AttentionSpec, *, state: AttnState,
            kv_mask: Optional[torch.Tensor] = None,
            offset: Optional[int] = None):
    """Causal prefill of a prompt: returns (o, state) with the layer's
    moments replaced (in place) by the prompt's final carry.

    `offset` makes it resumable: `state` already holds tokens
    [0, offset) and this call appends [offset, offset + n), the scan (or
    the prefill kernel) seeded with the carried moments. `kv_mask` may be
    [B, N] or [B, Hkv, N].
    """
    _check_fastmax(spec)
    if state.moments is None:
        raise ValueError(f"AttnState carries no moments but spec is {spec}")
    b, n = q.shape[0], q.shape[2]
    hkv = k.shape[1]
    if kv_mask is not None and kv_mask.dim() == 2:
        kv_mask = kv_mask[:, None].expand(b, hkv, n)
    spec_r = spec.resolved()
    qh = normalize_qk(q) if spec.normalize else q
    kh = normalize_qk(k) if spec.normalize else k
    init = None if offset is None else state.moments
    if resolve(spec).caps.decode_kernel:
        from repro_torch.kernels import ops

        o, final = ops.fastmax_prefill_kernel(
            qh, kh, v, p=spec.p, chunk_size=spec_r.chunk_size,
            denom_eps=spec.denom_eps, kv_mask=kv_mask, init_state=init)
    else:
        o, final = _causal_scan(qh, kh, v, p=spec.p,
                                chunk_size=spec_r.chunk_size, kv_mask=kv_mask,
                                denom_eps=spec.denom_eps, init=init)
    _copy_into(state.moments, final)
    return o.to(q.dtype), state


def step(state: AttnState, q, k, v, spec: AttentionSpec):
    """One-token decode. q [B,Hq,1,D], k/v [B,Hkv,1,*]. Folds (k, v) into
    the moments in place and returns (o [B,Hq,1,Dv], state)."""
    _check_fastmax(spec)
    if state.moments is None:
        raise ValueError(f"AttnState carries no moments but spec is {spec}")
    qh = normalize_qk(q) if spec.normalize else q
    kh = normalize_qk(k) if spec.normalize else k
    if resolve(spec).caps.decode_kernel:
        from repro_torch.kernels import ops

        o = ops.fastmax_decode(qh, kh, v, state.moments, p=spec.p,
                               denom_eps=spec.denom_eps)
        return o.to(q.dtype), state
    o, new = fastmax_decode_ref(qh, kh, v, tuple(state.moments), p=spec.p,
                                denom_eps=spec.denom_eps)
    _copy_into(state.moments, new)
    return o.to(q.dtype), state
