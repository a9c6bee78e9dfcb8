"""Decode-state protocol `init_state` / `prefill` / `step` for the fastmax
and hybrid families — port of `repro/attention/state.py`.

The state of a fastmax layer is its moment tuple, independent of context
length. fastmax-kernel runs prefill and step through the CUDA kernels on
that carry (it declares `prefill_kernel` and `decode_kernel`): prefill's
final moments come out of the prefill kernel, each step is the fused
update+combine decode kernel. There is no fallback for CUDA tensors; CPU
tensors take the kernels' plain versions (inside `kernels.ops`).

A hybrid layer carries both legs: the fastmax moments and a `KVCache`
window of the last W = min(window, chunk_size) tokens (the exact
near-field band), still O(1) in context length; W = 0 carries the moments
only and runs the fastmax paths. Neither hybrid backend declares
`decode_kernel`, as in the reference, so a hybrid step adds the band's
(exp - f_p) correction to the plain moment step, and a resumed (`offset`)
hybrid prefill is the plain hybrid scan. A fresh hybrid prefill on a
backend declaring `prefill_kernel` (hybrid-kernel) runs the hybrid kernel
(`kernels.ops.hybrid_prefill_kernel`; where the reference runs its jnp
scan), otherwise the plain scan; both then `roll_window`.

Unlike the functional reference, the port updates a layer's state IN
PLACE: `prefill` copies the new carry (and window) into the given tensors
and `step` folds the token into them, so the state may be a view into a
stacked [n_layers, ...] model state. The moments are therefore allocated
in their accumulator type from the start (float32 for bf16/f32
activations, float64 for float64 ones). The window's `length` is a shared
scalar cursor (the reference's per-slot [B] lengths come with the serving
engine). The softmax KV cache comes in a later slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.attention.registry import resolve
from repro_torch.attention.spec import AttentionSpec
from repro_torch.core.decode_state import init_fastmax_state
from repro_torch.core.fastmax import (Moments, _causal_scan,
                                      combine_with_queries, compute_moments)
from repro_torch.core.hybrid import _hybrid_scan, effective_window, roll_window
from repro_torch.core.ref import normalize_qk, poly_kernel
from repro_torch.kernels.ref import fastmax_decode_ref

__all__ = ["KVCache", "AttnState", "init_state", "prefill", "step"]


class KVCache(NamedTuple):
    """A cache of keys and values. Here only the hybrid window: W slots,
    right-aligned (row W-1 the most recent token)."""
    k: torch.Tensor       # [B, Hkv, W, D]  normalized keys
    v: torch.Tensor       # [B, Hkv, W, Dv]
    length: torch.Tensor  # [] int32: tokens folded so far
    mask: torch.Tensor    # [B, Hkv, W] validity (1 = real token)


class AttnState(NamedTuple):
    """Per-layer decode state. fastmax uses `moments`; hybrid uses both,
    `kv` being its near-field window (None at W = 0); the softmax KV cache
    is not ported yet."""
    kv: Optional[KVCache]
    moments: Optional[Moments]


def _window_slots(spec: AttentionSpec) -> int:
    """Window size the hybrid state carries (0 = none)."""
    if spec.family != "hybrid":
        return 0
    return effective_window(spec.window, spec.resolved().chunk_size)


def _check_state(state: AttnState, spec: AttentionSpec) -> None:
    if spec.family == "softmax":
        raise NotImplementedError(
            f"{spec}: the softmax KV cache is not ported yet")
    if state.moments is None or (_window_slots(spec) > 0
                                 and state.kv is None):
        raise ValueError(
            f"AttnState lacks the legs {spec} needs: the state was "
            f"initialized for another attention family or window")


def init_state(spec: AttentionSpec, *, batch: int, n_kv_heads: int,
               q_head_dim: int, v_head_dim: int, max_len: int,
               dtype=torch.float32, device=None) -> AttnState:
    """Fresh per-layer state for `batch` sequences (max_len is unused: the
    fastmax and hybrid states do not grow). A hybrid window starts empty:
    zero keys and values, mask 0."""
    del max_len
    if spec.family == "softmax":
        raise NotImplementedError(
            f"{spec}: the softmax KV cache is not ported yet")
    backend = resolve(spec)
    if not backend.caps.decode:
        raise ValueError(f"backend {backend.name!r} has no decode path")
    mom = init_fastmax_state(batch, n_kv_heads, q_head_dim, v_head_dim,
                             p=spec.p,
                             dtype=torch.promote_types(dtype, torch.float32),
                             device=device)
    w = _window_slots(spec)
    if w == 0:
        return AttnState(kv=None, moments=mom)
    kv = KVCache(
        k=torch.zeros(batch, n_kv_heads, w, q_head_dim, dtype=dtype,
                      device=device),
        v=torch.zeros(batch, n_kv_heads, w, v_head_dim, dtype=dtype,
                      device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
        mask=torch.zeros(batch, n_kv_heads, w, dtype=torch.float32,
                         device=device))
    return AttnState(kv=kv, moments=mom)


def _copy_into(dst, src) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


def prefill(q, k, v, spec: AttentionSpec, *, state: AttnState,
            kv_mask: Optional[torch.Tensor] = None,
            offset: Optional[int] = None):
    """Causal prefill of a prompt: returns (o, state) with the layer's
    moments (and hybrid window) replaced, in place, by the prompt's.

    `offset` makes it resumable: `state` already holds tokens
    [0, offset) and this call appends [offset, offset + n), the scan (or
    the prefill kernel) seeded with the carried moments, and a hybrid scan
    with the carried window too. `kv_mask` may be [B, N] or [B, Hkv, N].
    """
    _check_state(state, spec)
    b, n = q.shape[0], q.shape[2]
    hkv = k.shape[1]
    if kv_mask is not None and kv_mask.dim() == 2:
        kv_mask = kv_mask[:, None].expand(b, hkv, n)
    spec_r = spec.resolved()
    qh = normalize_qk(q) if spec.normalize else q
    kh = normalize_qk(k) if spec.normalize else k
    init = None if offset is None else state.moments
    w_slots = _window_slots(spec)
    if w_slots > 0:
        # one hybrid kernel call or plain hybrid scan gives the outputs and
        # the final moments; the window is recompacted to the last <= W
        # valid (normalized) keys. With `offset` the carried window seeds
        # the scan's previous-chunk buffer and the carried moments its far
        # field (the kernel takes neither)
        kv = state.kv
        win = None if offset is None else (kv.k, kv.v, kv.mask)
        if offset is None and resolve(spec).caps.prefill_kernel:
            from repro_torch.kernels import ops

            o, final = ops.hybrid_prefill_kernel(
                qh, kh, v, p=spec.p, window=spec_r.window,
                chunk_size=spec_r.chunk_size, denom_eps=spec.denom_eps,
                kv_mask=kv_mask)
        else:
            o, final = _hybrid_scan(qh, kh, v, p=spec.p,
                                    window=spec_r.window,
                                    chunk_size=spec_r.chunk_size,
                                    kv_mask=kv_mask,
                                    denom_eps=spec.denom_eps, init=init,
                                    init_win=win)
        m = (torch.ones(b, hkv, n, dtype=torch.float32, device=k.device)
             if kv_mask is None else kv_mask.to(torch.float32))
        window = roll_window(*(win or (None, None, None)), kh, v, m,
                             w_slots)
        _copy_into((kv.k, kv.v, kv.mask), window)
        kv.length.fill_((0 if offset is None else int(offset)) + n)
    elif resolve(spec).caps.prefill_kernel:
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


def _hybrid_step(state: AttnState, qh, kh, v, spec: AttentionSpec):
    """One plain hybrid decode step on normalized q, k: the moment step,
    plus the (exp - f_p) correction for the token itself (distance 0) and
    window rows 1..W-1 (row r holds the token at distance W - r, so row 0
    is just out of band); then the token is shift-appended at row W-1.
    Updates the state in place; returns o [B,Hq,1,Dv]."""
    kv = state.kv
    b, hq, _, d = qh.shape
    hkv, w_slots = kh.shape[1], kv.k.shape[2]
    new = Moments(*state.moments) + compute_moments(kh, v, p=spec.p)
    qg = qh.reshape(b, hkv, hq // hkv, d)
    num, den = combine_with_queries(qg, new, p=spec.p)
    acc = torch.promote_types(qg.dtype, torch.float32)
    qf = qg.to(acc)
    s0 = torch.einsum("bhgd,bhtd->bhg", qf, kh.to(acc))
    c0 = torch.exp(s0) - poly_kernel(s0, spec.p)
    num = num + c0[..., None] * v[:, :, 0].to(num.dtype)[:, :, None]
    den = den + c0
    sw = torch.einsum("bhgd,bhwd->bhgw", qf, kv.k.to(acc))
    cw = torch.exp(sw) - poly_kernel(sw, spec.p)
    in_band = (torch.arange(w_slots, device=kh.device) >= 1).to(acc)
    cw = cw * (in_band[None, None, None, :] * kv.mask[:, :, None, :])
    num = num + torch.einsum("bhgw,bhwj->bhgj", cw,
                             kv.v.to(acc)).to(num.dtype)
    den = den + cw.sum(dim=-1)
    o = num / (den + spec.denom_eps)[..., None]
    _copy_into(state.moments, new)
    _copy_into((kv.k, kv.v, kv.mask), (
        torch.cat([kv.k[:, :, 1:], kh.to(kv.k.dtype)], dim=2),
        torch.cat([kv.v[:, :, 1:], v.to(kv.v.dtype)], dim=2),
        torch.cat([kv.mask[:, :, 1:], torch.ones_like(kv.mask[:, :, :1])],
                  dim=2)))
    kv.length.add_(1)
    return o.reshape(b, hq, 1, -1)


def step(state: AttnState, q, k, v, spec: AttentionSpec):
    """One-token decode. q [B,Hq,1,D], k/v [B,Hkv,1,*]. Folds (k, v) into
    the state in place and returns (o [B,Hq,1,Dv], state)."""
    _check_state(state, spec)
    qh = normalize_qk(q) if spec.normalize else q
    kh = normalize_qk(k) if spec.normalize else k
    if _window_slots(spec) > 0:
        return _hybrid_step(state, qh, kh, v, spec).to(q.dtype), state
    if resolve(spec).caps.decode_kernel:
        from repro_torch.kernels import ops

        o = ops.fastmax_decode(qh, kh, v, state.moments, p=spec.p,
                               denom_eps=spec.denom_eps)
        return o.to(q.dtype), state
    o, new = fastmax_decode_ref(qh, kh, v, tuple(state.moments), p=spec.p,
                                denom_eps=spec.denom_eps)
    _copy_into(state.moments, new)
    return o.to(q.dtype), state
