"""Decode-state protocol `init_state` / `prefill` / `step` — port of
`repro/attention/state.py`, for every family:

  softmax  -> `KVCache` (O(N) per sequence, the baseline's cost): keys and
              values [B, Hkv, Nmax, *], a validity mask lane that keeps
              prompt padding masked through every later step, and a write
              cursor `length`: one shared scalar, or a [B] lane per
              sequence in a serving engine's slot pool (`serve.slots`).
  fastmax  -> `Moments` (O(D^2 Dv) per kv head, independent of context).
  hybrid   -> both legs: the fastmax moments and a `KVCache` window of the
              last W = min(window, chunk_size) tokens (the exact near-field
              band), still O(1) in context length; W = 0 carries the
              moments only and runs the fastmax paths.

fastmax-kernel runs prefill and step through the CUDA kernels on the
moment carry (it declares `prefill_kernel` and `decode_kernel`): prefill's
final moments come out of the prefill kernel (a resumed, `offset`, prefill
seeds it with the carried moments), each step is the fused update+combine
decode kernel. There is no fallback for CUDA tensors; CPU tensors take
the kernels' plain versions (inside `kernels.ops`). Neither hybrid backend
declares `decode_kernel`, as in the reference, so a hybrid step adds the
band's (exp - f_p) correction to the plain moment step, and a resumed
hybrid prefill is the plain hybrid scan. A fresh hybrid prefill on a
backend declaring `prefill_kernel` (hybrid-kernel) runs the hybrid kernel
(`kernels.ops.hybrid_prefill_kernel`; where the reference runs its jnp
scan), otherwise the plain scan; both then `roll_window`. The softmax
cache is plain torch (`core.softmax`), as in the reference.

Under an active mesh (`sharding.rules.use_mesh`) the kernel paths plan
each call as the reference does (`kernels.sharded`): a fresh prefill and
each step run the sharded wrappers on the plan's shards of q, k, v (the
rank's kv heads, or its slice of Dv), o is gathered back, and the moments
stay in the plan's layout, which `init_state` allocates. Under a mesh
that neither kv heads nor Dv divide, every rank holds the whole heads and
runs the single-device kernels on them. A resumed (`offset`) prefill under a plan seeds the prefill
kernel on the same shards with the carried local moments (the reference
runs its jnp scan there).

Under an active mesh whose "model" axis m is larger than 1 the softmax
KV cache (k, v and the mask lane) is the rank's block of the reference's
`kv_cache_spec` (`sharding.rules.kv_cache_block`; `length`, the global
cursor, is replicated):
  heads     the rank's Hkv/m kv heads where m divides Hkv: the layer
            attends on its kv heads and their q heads (a tensor-parallel
            layer's own; a layer computed whole is cut to them here and
            o all-gathered over "model");
  sequence  else, where m divides Nmax, every kv head's rows [r·Nmax/m,
            (r+1)·Nmax/m) of "model" index r, a `KVCacheRows`: q and the
            new tokens' k and v are whole on every rank, a prefill writes
            the rows of its tokens that lie in the block, a step's token
            is written by the rank that holds the cursor's row (a masked
            write on the device: no host round trip), and each rank's
            partial softmax over its rows (`core.softmax.softmax_partials`)
            is combined over "model" by one all-gather of (m, l, o);
  whole     else.
One all-gather, not an all-reduce of the max and then of the rescaled
(l, o): a decode step's partials are a few hundred KB, so the step pays
one collective's latency a layer instead of two, and every model rank
combines the same gathered partials in rank order (the same o on each).
A state that is not the rank's block under the active mesh raises.

The moments of every moment backend (fastmax chunked or kernel, both
hybrid backends) are the rank's block of the reference's
`_moments_shardings` (`sharding.rules.moments_block`): its Hkv/m kv heads
where m divides Hkv, else (feature mode) its Dv/m columns of m0, m1 and
m2 with g0, g1 and g2 whole, else whole. A prefill and a step run on the
kernel plan's shards of q, k and v (`kernels.sharded.run_in_model_layout`:
the rank's heads, or v's Dv slice with q and k whole), so o's slice is
exact locally and every rank folds the same g-moments. The hybrid window
is the rank's block of `kv_cache_spec` on its W rows: the kv heads with
the moments', else (feature or whole moments) its rows [r·W/m, (r+1)·W/m)
where m divides W, a `KVCacheRows` as the softmax cache's rows, else
whole. A step's band correction over a rows window is each rank's
(exp - f_p) partials of num and den over its rows, combined over
"model"; the shift-append crosses the row blocks (rank r's row 0 becomes rank r-1's last row, the new token the
last rank's), and the boundary rows travel in the partials' all-gather:
one collective a layer. Row 0 of the whole window (rank 0's first) stays
the out-of-band row, as in the reference. A resumed hybrid prefill
gathers the rows first: the scan's previous-chunk buffer is the whole
window.

Unlike the functional reference, the port updates a layer's state IN
PLACE: `prefill` copies the new carry, cache rows and window into the
given tensors and `step` folds the token into them, so the state may be a
view into a stacked [n_groups, ...] model state or into one slot of a
serving pool. The moments are therefore allocated in their accumulator
type from the start (float32 for bf16/f32 activations, float64 for
float64 ones). A `length` with a batch axis ([B]: the hybrid window's
token count, the KV cache's write cursor) advances per sequence.
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
from repro_torch.core.softmax import (combine_partials, softmax_attention,
                                      softmax_partials)
from repro_torch.kernels.ops import note_route
from repro_torch.kernels.ref import fastmax_decode_ref
from repro_torch.sharding.rules import (active_mesh, kv_cache_block,
                                        model_axis_size, moments_block)

__all__ = ["KVCache", "KVCacheRows", "AttnState",
           "init_state", "prefill", "step", "map_state", "state_leaves"]


class KVCache(NamedTuple):
    """A cache of keys and values: the softmax KV cache (Nmax rows, row t
    the token at position t), or the hybrid window (W rows, right-aligned:
    row W-1 the most recent token, keys normalized)."""
    k: torch.Tensor       # [B, Hkv, Nmax|W, D]
    v: torch.Tensor       # [B, Hkv, Nmax|W, Dv]
    length: torch.Tensor  # [] or [B] int32: the softmax write cursor, the
    #                       hybrid window's count of tokens folded so far
    mask: torch.Tensor    # [B, Hkv, Nmax|W] validity (1 = real token)


class KVCacheRows(KVCache):
    """A `KVCache` (the softmax cache along its timeline, or the hybrid
    window) that holds the rank's rows of a cache split over "model"
    (`kv_cache_spec`'s sequence mode): rows [r·n, (r+1)·n) of m·n, r the
    rank's "model" index of m, n the rows it holds. The type records the
    split, so views and copies made by `map_state` keep it."""
    __slots__ = ()


class AttnState(NamedTuple):
    """Per-layer decode state. softmax uses `kv`, fastmax `moments`;
    hybrid uses both, `kv` being its near-field window (None at W = 0)."""
    kv: Optional[KVCache]
    moments: Optional[Moments]


def map_state(fn, *trees):
    """Apply `fn` leaf by leaf over decode states of one structure (a
    model's dict of `AttnState`s, or any of its NamedTuples; None legs
    stay None)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: map_state(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple):
        return type(first)(*(map_state(fn, *subs) for subs in zip(*trees)))
    return fn(*trees)


def state_leaves(tree) -> list:
    """The leaves of a decode state in `map_state`'s order."""
    out = []
    map_state(out.append, tree)
    return out


def _window_slots(spec: AttentionSpec) -> int:
    """Window size the hybrid state carries (0 = none)."""
    if spec.family != "hybrid":
        return 0
    return effective_window(spec.window, spec.resolved().chunk_size)


def _check_state(state: AttnState, spec: AttentionSpec) -> None:
    if spec.family == "softmax":
        if state.kv is None:
            raise ValueError(
                f"AttnState carries no KV cache but spec is {spec}: the "
                f"state was initialized for another attention family")
        return
    if state.moments is None or (_window_slots(spec) > 0
                                 and state.kv is None):
        raise ValueError(
            f"AttnState lacks the legs {spec} needs: the state was "
            f"initialized for another attention family or window")


def init_state(spec: AttentionSpec, *, batch: int, n_kv_heads: int,
               q_head_dim: int, v_head_dim: int, max_len: int,
               dtype=torch.float32, device=None) -> AttnState:
    """Fresh per-layer state for `batch` sequences of up to `max_len`
    tokens (only the softmax cache grows with it). The softmax cache
    starts with zero rows, all valid in its mask lane (a step masks the
    rows past the cursor); a hybrid window starts empty: zero keys and
    values, mask 0. The cursor is a shared scalar."""
    backend = resolve(spec)
    if not backend.caps.decode:
        raise ValueError(
            f"backend {backend.name!r} has no decode path; use a spec whose "
            f"backend declares decode=True")
    if spec.family == "softmax":
        # under an active mesh the rank's block of kv_cache_spec
        blk = kv_cache_block(n_kv_heads, max_len)
        cls = KVCacheRows if blk.mode == "sequence" else KVCache
        shape = (batch, blk.heads, blk.rows)
        kv = cls(
            k=torch.zeros(*shape, q_head_dim, dtype=dtype, device=device),
            v=torch.zeros(*shape, v_head_dim, dtype=dtype, device=device),
            length=torch.zeros((), dtype=torch.int32, device=device),
            mask=torch.ones(*shape, dtype=torch.float32, device=device))
        return AttnState(kv=kv, moments=None)
    # under an active mesh the rank's block of _moments_shardings, the
    # kernel plans' layout (heads mode needs Hq % m too: Hq = G·Hkv)
    blk = moments_block(n_kv_heads, v_head_dim)
    mom = init_fastmax_state(batch, blk.heads, q_head_dim, blk.dv,
                             p=spec.p,
                             dtype=torch.promote_types(dtype, torch.float32),
                             device=device)
    w = _window_slots(spec)
    if w == 0:
        return AttnState(kv=None, moments=mom)
    # and of kv_cache_spec on the window's W rows
    wblk = kv_cache_block(n_kv_heads, w)
    cls = KVCacheRows if wblk.mode == "sequence" else KVCache
    shape = (batch, wblk.heads, wblk.rows)
    kv = cls(
        k=torch.zeros(*shape, q_head_dim, dtype=dtype, device=device),
        v=torch.zeros(*shape, v_head_dim, dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
        mask=torch.zeros(*shape, dtype=torch.float32, device=device))
    return AttnState(kv=kv, moments=mom)


def _copy_into(dst, src) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


def _set_length(length, off: int, n: int, kv_mask) -> None:
    """`length` <- off + this prefill's tokens: all n for a shared cursor
    (padding rows stay in the cache, masked), each sequence's valid tokens
    for a [B] lane (its decode appends right after its last valid one)."""
    if length.dim() == 0 or kv_mask is None:
        length.fill_(off + n)
    else:
        length.copy_(off + (kv_mask[:, 0] > 0).sum(dim=-1))


def _cache_block(kv: KVCache, k, what: str = "KV cache"):
    """The rank's block of the softmax cache (or, `what` "hybrid window",
    the hybrid window) `kv` under the active mesh, for new keys `k` (the
    rank's kv heads inside `kernels.sharded.local_heads()`, else whole);
    raises where `kv` is not that block."""
    from repro_torch.kernels.sharded import in_local_heads

    seq = isinstance(kv, KVCacheRows)
    m = model_axis_size(active_mesh())
    hkv = k.shape[1] * (m if in_local_heads() else 1)
    blk = kv_cache_block(hkv, kv.k.shape[2] * (m if seq else 1))
    if (blk.mode == "sequence") != seq or \
            (blk.heads, blk.rows) != tuple(kv.k.shape[1:3]):
        kind = "the rows of a cache split" if seq else "a cache of"
        raise ValueError(
            f"the {what} {tuple(kv.k.shape)} ({kind} {kv.k.shape[1]} kv "
            f"heads) is not the rank's block of a {hkv}-head cache on "
            f"'model' {m}: {blk.mode}, {blk.heads} kv heads x {blk.rows} "
            f"rows; make the decode state under the mesh it runs on "
            f"(rules.use_mesh)")
    return blk


def _moment_block(mom: Moments, k, v):
    """The rank's block of the moments `mom` under the active mesh, for
    new keys `k` (as in `_cache_block`) and values `v` (whole); raises
    where `mom` is not that block."""
    from repro_torch.kernels.sharded import in_local_heads

    m = model_axis_size(active_mesh())
    hkv = k.shape[1] * (m if in_local_heads() else 1)
    blk = moments_block(hkv, v.shape[-1])
    held = (mom.m0.shape[-2], mom.m0.shape[-1], mom.g0.shape[-1])
    if held != (blk.heads, blk.dv, blk.heads):
        raise ValueError(
            f"the moments of {held[0]} kv heads x {held[1]} value columns "
            f"are not the rank's block of {hkv} kv heads x {v.shape[-1]} "
            f"on 'model' {m}: {blk.mode}, {blk.heads} x {blk.dv}; make "
            f"the decode state under the mesh it runs on (rules.use_mesh)")
    return blk


def _on_plan(plan, fn, q, k, v):
    """fn(q, k, v) -> o on the kernel plan's shards of model-layout q, k,
    v (o back in the model's layout), or on them as they are without a
    plan."""
    if plan is None:
        return fn(q, k, v)
    from repro_torch.kernels import sharded as S

    with torch.no_grad():      # the decode-state paths run without autograd
        return S.run_in_model_layout(plan, fn, q, k, v)


def _plan_mask(kv_mask, plan):
    """A [B, Hkv, N] kv_mask on the plan's kv heads: cut to the rank's
    where a heads plan cuts whole heads, else as it is."""
    from repro_torch.kernels import sharded as S

    if (kv_mask is not None and kv_mask.shape[1] > 1 and plan is not None
            and plan.mode == "heads" and plan.tp > 1
            and not S.in_local_heads()):
        return S.model_slice(kv_mask, 1, plan)
    return kv_mask


def _cut_heads(x, blk):
    """The rank's kv heads of a tensor with whole heads (dim 1)."""
    n = x.shape[1] // blk.size
    return x.narrow(1, blk.index * n, n)


def _on_cache_heads(blk, fn, q, k, v, kv_mask=None):
    """fn(q, k, v, kv_mask) -> o on the cache's kv heads: inputs with
    whole heads under a heads-mode cache are cut to the rank's heads and
    o all-gathered over "model"; anything else as it is."""
    if blk.mode != "heads" or k.shape[1] == blk.heads:
        return fn(q, k, v, kv_mask)
    if kv_mask is not None and kv_mask.shape[1] > 1:
        kv_mask = _cut_heads(kv_mask, blk)
    return _gather_model(fn(*(_cut_heads(x, blk) for x in (q, k, v)),
                            kv_mask), 1, blk)


def _gather_model(x, dim: int, blk):
    """The rank's slice of x's `dim` -> whole, all-gathered over the
    active mesh's "model" (`placed._collective` counts it)."""
    from repro_torch.sharding.placed import GatherModel

    return GatherModel.apply(x, dim, active_mesh().get_group("model"),
                             blk.index, blk.size)


def _attend_rows(q, kv_k, kv_v, mask, blk, q_offset=None):
    """q (whole heads) over the rank's rows of the cache, combined with
    the other model ranks' rows: one all-gather of each rank's (m, l, o)
    partials over "model"."""
    m, l, o = softmax_partials(q, kv_k, kv_v, kv_mask=mask,
                               q_offset=q_offset, k_offset=blk.row0)
    part = torch.cat([m[..., None], l[..., None], o], dim=-1)
    every = _gather_model(part[None], 0, blk)
    return combine_partials(every[..., 0], every[..., 1],
                            every[..., 2:]).to(q.dtype)


def _softmax_prefill(q, k, v, kv: KVCache, kv_mask, offset):
    """Write the chunk's keys and values (and its mask) into the cache at
    the offset; attend over the chunk alone, or, resumed, over the whole
    cache (rows before the offset are the carried prefix, valid per the
    mask lane; rows past the chunk are excluded causally). Under a mesh
    on the rank's block of the cache (module docstring)."""
    n = q.shape[2]
    off = 0 if offset is None else int(offset)
    blk = _cache_block(kv, k)
    if off + n > blk.nmax:
        raise ValueError(
            f"prefill of tokens [{off}, {off + n}) past the KV cache's "
            f"{blk.nmax} rows")
    if blk.mode == "sequence":
        o = _prefill_rows(q, k, v, kv, kv_mask, offset, blk)
    else:
        o = _on_cache_heads(blk, lambda q_, k_, v_, m_: _prefill_local(
            q_, k_, v_, kv, m_, offset), q, k, v, kv_mask)
    _set_length(kv.length, off, n, kv_mask)
    return o


def _prefill_local(q, k, v, kv: KVCache, kv_mask, offset):
    """`_softmax_prefill` on a cache that holds every row of its kv
    heads."""
    n = q.shape[2]
    off = 0 if offset is None else int(offset)
    kv.k[:, :, off:off + n].copy_(k)
    kv.v[:, :, off:off + n].copy_(v)
    if kv_mask is not None:
        # persist prompt padding so every later step keeps it masked
        kv.mask[:, :, off:off + n].copy_(kv_mask)
    if offset is None:
        return softmax_attention(q, k, v, causal=True, kv_mask=kv_mask)
    return softmax_attention(q, kv.k, kv.v, causal=True, q_offset=off,
                             kv_mask=kv.mask)


def _prefill_rows(q, k, v, kv: KVCache, kv_mask, offset, blk):
    """`_softmax_prefill` on the rank's rows of a cache split along its
    timeline: the tokens' rows that lie in the block are written; a fresh
    prefill attends over its own k and v, a resumed one over the cache's
    rows of every model rank (`_attend_rows`)."""
    n = q.shape[2]
    off = 0 if offset is None else int(offset)
    lo, hi = max(off, blk.row0), min(off + n, blk.row0 + blk.rows)
    if lo < hi:
        dst, src = slice(lo - blk.row0, hi - blk.row0), slice(lo - off,
                                                              hi - off)
        kv.k[:, :, dst].copy_(k[:, :, src])
        kv.v[:, :, dst].copy_(v[:, :, src])
        if kv_mask is not None:
            kv.mask[:, :, dst].copy_(kv_mask[:, :, src])
    if offset is None:
        return softmax_attention(q, k, v, causal=True, kv_mask=kv_mask)
    return _attend_rows(q, kv.k, kv.v, kv.mask, blk, q_offset=off)


def _softmax_step(kv: KVCache, q, k, v):
    """Append the token at the cursor (one row per sequence under a [B]
    cursor, its mask row set valid: a chunked prefill may have left a
    padding mark there) and attend over the rows up to it. Under a mesh
    on the rank's block of the cache (module docstring)."""
    blk = _cache_block(kv, k)
    if blk.mode == "sequence":
        o = _step_rows(kv, q, k, v, blk)
    else:
        o = _on_cache_heads(blk, lambda q_, k_, v_, _: _step_local(
            kv, q_, k_, v_), q, k, v)
    kv.length.add_(1)
    return o


def _step_local(kv: KVCache, q, k, v):
    """`_softmax_step` on a cache that holds every row of its kv heads."""
    nmax = kv.k.shape[2]
    # a write past the last row is clamped to it (the reference's
    # dynamic_update_slice clamps a shared cursor; a [B] cursor that far
    # is a free slot of a serving pool, which its next admit rewrites)
    row = kv.length.long().clamp(max=nmax - 1)
    if kv.length.dim() == 0:
        kv.k.index_copy_(2, row.view(1), k.to(kv.k.dtype))
        kv.v.index_copy_(2, row.view(1), v.to(kv.v.dtype))
        length_b = kv.length.view(1)
    else:
        bidx = torch.arange(kv.k.shape[0], device=kv.k.device)
        kv.k[bidx, :, row] = k[:, :, 0].to(kv.k.dtype)
        kv.v[bidx, :, row] = v[:, :, 0].to(kv.v.dtype)
        kv.mask[bidx, :, row] = 1.0
        length_b = kv.length
    pos = torch.arange(nmax, device=kv.k.device)
    mask = (pos[None, None, :] <= length_b[:, None, None]).to(
        torch.float32) * kv.mask
    return softmax_attention(q, kv.k, kv.v, causal=False, kv_mask=mask)


def _step_rows(kv: KVCache, q, k, v, blk):
    """`_softmax_step` on the rank's rows of a cache split along its
    timeline: the rank whose rows hold the cursor's (clamped as in
    `_step_local`) writes the token there, every other rank writes its
    row back unchanged (the owner found on the device), and q attends
    over every model rank's rows (`_attend_rows`)."""
    row = kv.length.long().clamp(max=blk.nmax - 1) - blk.row0
    own = (row >= 0) & (row < blk.rows)
    at = row.clamp(0, blk.rows - 1)
    if kv.length.dim() == 0:
        i = at.view(1)
        for dst, src in ((kv.k, k), (kv.v, v)):
            dst.index_copy_(2, i, torch.where(own, src.to(dst.dtype),
                                              dst.index_select(2, i)))
        length_b = kv.length.view(1)
    else:
        bidx = torch.arange(kv.k.shape[0], device=kv.k.device)
        for dst, src in ((kv.k, k), (kv.v, v)):
            dst[bidx, :, at] = torch.where(own[:, None, None],
                                           src[:, :, 0].to(dst.dtype),
                                           dst[bidx, :, at])
        kv.mask[bidx, :, at] = torch.where(own[:, None], 1.0,
                                           kv.mask[bidx, :, at])
        length_b = kv.length
    pos = blk.row0 + torch.arange(blk.rows, device=kv.k.device)
    mask = (pos[None, None, :] <= length_b[:, None, None]).to(
        torch.float32) * kv.mask
    return _attend_rows(q, kv.k, kv.v, mask, blk)


def prefill(q, k, v, spec: AttentionSpec, *, state: AttnState,
            kv_mask: Optional[torch.Tensor] = None,
            offset: Optional[int] = None):
    """Causal prefill of a prompt: returns (o, state) with the layer's
    state primed, in place, with the prompt: the softmax cache's rows, or
    the moments (and hybrid window) replaced by the prompt's.

    `offset` (an int) makes it resumable: `state` already holds tokens
    [0, offset) and this call appends [offset, offset + n): the softmax
    chunk is written at the offset and attends over the cache; the scan
    (or the prefill kernel) is seeded with the carried moments, and a
    hybrid scan with the carried window too. `kv_mask` may be [B, N] or
    [B, Hkv, N]. A [B] `length` lane (slot pools) advances per sequence by
    its valid tokens.
    """
    _check_state(state, spec)
    b, n = q.shape[0], q.shape[2]
    hkv = k.shape[1]
    if kv_mask is not None and kv_mask.dim() == 2:
        kv_mask = kv_mask[:, None].expand(b, hkv, n)
    if spec.family == "softmax":
        note_route("plain prefill: softmax KV cache")
        o = _softmax_prefill(q, k, v, state.kv, kv_mask, offset)
        return o, state
    from repro_torch.kernels import ops
    from repro_torch.kernels import sharded as S

    spec_r = spec.resolved()
    qh = normalize_qk(q) if spec.normalize else q
    kh = normalize_qk(k) if spec.normalize else k
    init = None if offset is None else state.moments
    # the moments' block under the active mesh and the plan that runs on
    # it (the kernel plan of q, k, v: the rank's heads, or v's Dv slice)
    mblk = _moment_block(state.moments, k, v)
    _, plan = S.plan_call(q, k, v)
    mask_p = _plan_mask(kv_mask, plan)
    kw = dict(p=spec.p, chunk_size=spec_r.chunk_size,
              denom_eps=spec.denom_eps, kv_mask=mask_p)
    out = {}
    if _window_slots(spec) > 0:
        o, final = _hybrid_prefill(qh, kh, v, spec, state, kv_mask, offset,
                                   mblk, plan)
    elif resolve(spec).caps.prefill_kernel:
        if plan is not None:
            o, final = _prefill_sharded(qh, kh, v, kw, plan, init)
        else:
            o, final = ops.fastmax_prefill_kernel(qh, kh, v, **kw,
                                                  init_state=init)
    else:
        note_route("plain prefill: fastmax chunked scan")

        def fn(a, b, c):
            o, out["final"] = _causal_scan(a, b, c, **kw, init=init)
            return o

        o, final = _on_plan(plan, fn, qh, kh, v), out["final"]
    _copy_into(state.moments, final)
    return o.to(q.dtype), state


def _hybrid_prefill(qh, kh, v, spec: AttentionSpec, state: AttnState,
                    kv_mask, offset, mblk, plan):
    """A hybrid prefill on the plan's shards: one hybrid kernel call
    (fresh, on a backend declaring `prefill_kernel`) or plain hybrid scan
    gives o and the final moments in the rank's block; the window is
    recompacted to the last <= W valid (normalized) keys and the rank's
    heads or rows of it written. With `offset` the carried window (its
    rows gathered whole over "model") seeds the scan's previous-chunk
    buffer and the carried moments its far field (the kernel takes
    neither)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sharded as S

    spec_r = spec.resolved()
    b, hkv, n = kh.shape[0], kh.shape[1], kh.shape[2]
    kv = state.kv
    wblk = _cache_block(kv, kh, "hybrid window")
    win = None if offset is None else _whole_window(kv, wblk)
    kw = dict(p=spec.p, window=spec_r.window, chunk_size=spec_r.chunk_size,
              denom_eps=spec.denom_eps, kv_mask=_plan_mask(kv_mask, plan))
    kernel = offset is None and resolve(spec).caps.prefill_kernel
    out = {}

    def fn(a, b_, c):
        if kernel and plan is not None:
            o, out["final"] = S.hybrid_prefill_sharded(a, b_, c, **kw,
                                                       plan=plan)
        elif kernel:
            o, out["final"] = ops.hybrid_prefill_kernel(a, b_, c, **kw)
        else:
            note_route("plain prefill: hybrid scan")
            w = win
            if w is not None and mblk.mode == "feature":
                # the scan runs on v's Dv slice: so does the window's v
                w = (w[0], w[1].narrow(-1, mblk.index * mblk.dv, mblk.dv),
                     w[2])
            o, out["final"] = _hybrid_scan(
                a, b_, c, **kw, init=None if offset is None else
                state.moments, init_win=w)
        return o

    o = _on_plan(plan, fn, qh, kh, v)
    m = (torch.ones(b, hkv, n, dtype=torch.float32, device=kh.device)
         if kv_mask is None else kv_mask.to(torch.float32))
    if wblk.mode == "heads" and hkv != wblk.heads:
        kh, v, m = (_cut_heads(x, wblk) for x in (kh, v, m))
    window = roll_window(*(win or (None, None, None)), kh, v, m,
                         _window_slots(spec))
    if wblk.mode == "sequence":
        window = (x.narrow(2, wblk.row0, wblk.rows) for x in window)
    _copy_into((kv.k, kv.v, kv.mask), window)
    _set_length(kv.length, 0 if offset is None else int(offset), n,
                kv_mask)
    return o, out["final"]


def _whole_window(kv: KVCache, wblk):
    """(k, v, mask) of the whole window: a rows block's rows of every
    model rank, gathered by one all-gather over "model" (k, v and the
    mask, whose 0/1 every type holds exactly, in one tensor); any other
    block as it is."""
    if wblk.mode != "sequence":
        return kv.k, kv.v, kv.mask
    d = kv.k.shape[-1]
    both = torch.cat([kv.k, kv.v, kv.mask[..., None].to(kv.k.dtype)], -1)
    every = _gather_model(both, 2, wblk)
    return (every[..., :d], every[..., d:-1],
            every[..., -1].to(torch.float32))


def _prefill_sharded(qh, kh, v, kw: dict, plan, init):
    """A kernel prefill under a plan: o in the model's layout and the
    final moments in the plan's (the state's layout under a mesh). A
    resumed one (`init`, the carried local moments) seeds the prefill
    kernel on the same shards (the reference runs its jnp scan there)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sharded as S

    out = {}

    def fn(a, b, c):
        if init is None:
            o, out["final"] = S.fastmax_prefill_sharded(a, b, c, **kw,
                                                        plan=plan)
        else:
            with ops.under_plan(plan.describe()):
                o, out["final"] = ops.fastmax_prefill_kernel(
                    a, b, c, **kw, init_state=init)
        return o

    return _on_plan(plan, fn, qh, kh, v), out["final"]


def _hybrid_step(state: AttnState, qh, kh, v, spec: AttentionSpec, mblk,
                 plan):
    """One plain hybrid decode step on normalized q, k, on the rank's
    block of the state: a heads block on the plan's heads; else q and k
    whole, the moment leg on the moments' columns of v (its Dv slice in
    feature mode, o's slice gathered back) and the window leg over the
    window's rows. Updates the state in place; returns o [B,Hq,1,Dv]."""
    from repro_torch.kernels import sharded as S

    wblk = _cache_block(state.kv, kh, "hybrid window")
    if mblk.mode == "heads":
        return _on_plan(plan, lambda a, b, c: _hybrid_step_block(
            state, a, b, c, c, 0, spec, wblk), qh, kh, v)
    if mblk.mode != "feature":
        return _hybrid_step_block(state, qh, kh, v, v, 0, spec, wblk)
    with torch.no_grad():
        o = _hybrid_step_block(state, qh, kh, v, S.model_slice(v, -1, plan),
                               mblk.index * mblk.dv, spec, wblk)
        return S.model_gather(o, -1, plan)


def _hybrid_step_block(state: AttnState, qh, kh, v, vs, col0: int,
                       spec: AttentionSpec, wblk):
    """`_hybrid_step` on one block: the moment step on `vs` (v's columns
    [col0, col0 + vs.shape[-1]) that the moments hold), plus the (exp -
    f_p) correction for the token itself (distance 0) and window rows
    1..W-1 (row r holds the token at distance W - r, so row 0 is just out
    of band) over the rows the rank holds, combined with the other model
    ranks' where the window is split by rows; then the token is
    shift-appended at row W-1. Returns o [B,Hq,1,vs's Dv]."""
    kv = state.kv
    b, hq, _, d = qh.shape
    hkv = kh.shape[1]
    new = Moments(*state.moments) + compute_moments(kh, vs, p=spec.p)
    qg = qh.reshape(b, hkv, hq // hkv, d)
    num, den = combine_with_queries(qg, new, p=spec.p)
    acc = torch.promote_types(qg.dtype, torch.float32)
    qf = qg.to(acc)
    s0 = torch.einsum("bhgd,bhtd->bhg", qf, kh.to(acc))
    c0 = torch.exp(s0) - poly_kernel(s0, spec.p)
    num = num + c0[..., None] * vs[:, :, 0].to(num.dtype)[:, :, None]
    den = den + c0
    sw = torch.einsum("bhgd,bhwd->bhgw", qf, kv.k.to(acc))
    cw = torch.exp(sw) - poly_kernel(sw, spec.p)
    pos = wblk.row0 + torch.arange(kv.k.shape[2], device=kh.device)
    in_band = (pos >= 1).to(acc)
    cw = cw * (in_band[None, None, None, :] * kv.mask[:, :, None, :])
    pn = torch.einsum("bhgw,bhwj->bhgj", cw, kv.v.to(acc))
    pd = cw.sum(dim=-1)
    tail = (kh, v, torch.ones_like(kv.mask[:, :, :1]))
    if wblk.mode == "sequence":
        pn, pd, nxt = _exchange_rows(pn, pd, kv, wblk)
        tail = tail if nxt is None else nxt
    num = num + pn.narrow(-1, col0, vs.shape[-1]).to(num.dtype)
    den = den + pd
    o = num / (den + spec.denom_eps)[..., None]
    _copy_into(state.moments, new)
    _copy_into((kv.k, kv.v, kv.mask), (
        torch.cat([kv.k[:, :, 1:], tail[0].to(kv.k.dtype)], dim=2),
        torch.cat([kv.v[:, :, 1:], tail[1].to(kv.v.dtype)], dim=2),
        torch.cat([kv.mask[:, :, 1:], tail[2].to(kv.mask.dtype)], dim=2)))
    kv.length.add_(1)
    return o.reshape(b, hq, 1, -1)


def _exchange_rows(pn, pd, kv: KVCache, wblk):
    """One all-gather over "model" of each rank's band partials (pn
    [B,Hkv,G,Dv], pd [B,Hkv,G]) and its window's row 0, packed in one
    tensor of pn's type (the rows' values and 0/1 mask exact in it).
    Returns (pn, pd summed over the ranks, the same on every rank; the
    next rank's row 0 as (k, v, mask) [B,Hkv,1,*], None on the last
    rank)."""
    row = (kv.k[:, :, :1], kv.v[:, :, :1], kv.mask[:, :, :1])
    parts = (pn, pd) + row
    every = _gather_model(torch.cat([x.reshape(-1).to(pn.dtype)
                                     for x in parts])[None], 0, wblk)
    split = every.split([x.numel() for x in parts], dim=1)
    total = [x.sum(dim=0) for x in split[:2]]
    nxt = None
    if wblk.index + 1 < wblk.size:
        nxt = tuple(x[wblk.index + 1].reshape(y.shape)
                    for x, y in zip(split[2:], row))
    return total[0].reshape(pn.shape), total[1].reshape(pd.shape), nxt


def step(state: AttnState, q, k, v, spec: AttentionSpec):
    """One-token decode. q [B,Hq,1,D], k/v [B,Hkv,1,*]. Appends (k, v) to
    the softmax cache, or folds them into the moments (and window), in
    place, and returns (o [B,Hq,1,Dv], state). Under a mesh on the
    rank's block of the state (module docstring)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sharded as S

    _check_state(state, spec)
    if spec.family == "softmax":
        note_route("plain decode: softmax KV cache")
        return _softmax_step(state.kv, q, k, v), state
    qh = normalize_qk(q) if spec.normalize else q
    kh = normalize_qk(k) if spec.normalize else k
    mblk = _moment_block(state.moments, k, v)
    _, plan = S.plan_call(q, k, v)
    if _window_slots(spec) > 0:
        note_route("plain decode: hybrid two-leg step")
        o = _hybrid_step(state, qh, kh, v, spec, mblk, plan)
        return o.to(q.dtype), state
    if resolve(spec).caps.decode_kernel:
        if plan is None:
            o = ops.fastmax_decode(qh, kh, v, state.moments, p=spec.p,
                                   denom_eps=spec.denom_eps)
        else:
            o = _on_plan(plan, lambda a, b, c: S.fastmax_decode_sharded(
                a, b, c, state.moments, p=spec.p, denom_eps=spec.denom_eps,
                plan=plan)[0], qh, kh, v)
        return o.to(q.dtype), state
    note_route("plain decode: fastmax moment step")

    def fn(a, b, c):
        o, new = fastmax_decode_ref(a, b, c, tuple(state.moments), p=spec.p,
                                    denom_eps=spec.denom_eps)
        _copy_into(state.moments, new)
        return o

    return _on_plan(plan, fn, qh, kh, v).to(q.dtype), state
