"""Built-in attention backends of the port — port of
`repro/attention/backends.py`.

  softmax         — the paper's baseline (Eqs. 1-4) in plain torch
                    (core.softmax), O(N^2), GQA by grouping queries; decode
                    through the KV cache.
  fastmax-chunked — the plain chunked prefix scan (core.fastmax), or the
                    global moment path when noncausal; exact kv masking;
                    the §2.5 custom backward; decode through the plain
                    moment step.
  fastmax-kernel  — the hand-written CUDA kernels (training forward and
                    §2.5 backward, prefill, decode, noncausal moments and
                    combine) on the native moment carry; CPU tensors take
                    the kernels' plain versions inside the wrappers.
  hybrid-chunked  — the plain hybrid scan (core.hybrid): the exact softmax
                    band plus the fastmax moments; exact kv masking; the
                    band-extended §2.5 backward. Causal only.
  hybrid-kernel   — the hybrid CUDA kernel forward with that backward
                    (kernels.ops.hybrid), and in a fresh prefill
                    (`prefill_kernel`). Causal only; no kv_mask.

  fastmax-oracle  — the O(N^2) reference (core.ref), per query group;
                    tests and validation only.
  fastmax-rowwise — the paper's own schedule through explicit phi
                    features (core.fastmax.fastmax_rowwise), the only
                    backend with the Fig. 2 factorized dropout. Causal
                    attention holds [B,Hkv,N,1+D+D²,Dv+1]: small N and D.

All fns share one signature: fn(q, k, v, spec, *, causal, kv_mask, rng)
-> o, with q [B,Hq,N,D], k/v [B,Hkv,M,*], Hq % Hkv == 0 (M = N when
causal); `rng` (a torch.Generator) reaches only the dropout backend.
Under an active mesh (`sharding.rules.use_mesh`) the kernel backends plan
each call (`kernels.sharded.plan_call`): heads, feature or, for a causal
fastmax call, seq mode, and run the kernels on the plan's shards; under a
mesh that neither heads nor Dv divide, every rank holds the whole heads
and runs the single-device kernels on them. The chunked
fastmax backend takes the seq plan too (its plain versions), since its
tokens are sharded as well; with no mesh, or one whose axes are all of
size 1, every call is as before.
The decode-state protocol (`attention.state`) routes on the capabilities;
both hybrid backends decode through the plain two-leg state, as in the
reference (neither declares `decode_kernel`), and hybrid-kernel runs a
fresh prefill through the hybrid kernel. Neither the oracle nor rowwise
has a decode path or takes a kv_mask (the reference drops the mask
silently; the port raises, as it does on the kernel backends).
"""
from __future__ import annotations

from repro_torch.attention.registry import Backend, Capabilities, register
from repro_torch.attention.spec import AttentionSpec
from repro_torch.kernels import sharded as S

__all__ = []


def _softmax_fn(q, k, v, spec: AttentionSpec, *, causal, kv_mask, rng):
    from repro_torch.core.softmax import softmax_attention
    from repro_torch.kernels.ops import note_route

    del spec, rng
    note_route("plain attention: softmax")
    # grouped queries per kv head, no Hq-broadcast copies of k/v; the mask
    # is per kv head: [B, Hkv|1, M]
    if kv_mask is not None and kv_mask.shape[1] not in (1, k.shape[1]):
        raise ValueError(f"kv_mask heads {kv_mask.shape[1]} must be 1 or "
                         f"Hkv={k.shape[1]}")
    return softmax_attention(q, k, v, causal=causal, kv_mask=kv_mask)


register(Backend(
    name="softmax",
    family="softmax",
    caps=Capabilities(decode=True),
    fn=_softmax_fn,
))


def _chunked_fn(q, k, v, spec: AttentionSpec, *, causal, kv_mask, rng):
    from repro_torch.core.fastmax import (fastmax_causal_chunked,
                                          fastmax_noncausal, normalize_qk)
    from repro_torch.kernels.ops import note_route

    del rng
    spec = spec.resolved()
    qh = normalize_qk(q) if spec.normalize else q
    kh = normalize_qk(k) if spec.normalize else k
    _, plan = S.plan_call(q, k, v, causal=causal, seq=True)
    note_route("plain attention: fastmax-chunked"
               + (f" {plan.describe()}" if plan is not None
                  and plan.mode == "seq" else ""))
    if plan is not None and plan.mode == "seq":
        # the rank holds a token shard: the plain versions under the seq
        # plan's carry exchange (any other plan runs the whole heads here)
        if kv_mask is not None:
            raise ValueError("context-parallel fastmax takes no kv_mask")
        return S.fastmax_sharded(qh, kh, v, p=spec.p, causal=True,
                                 chunk_size=spec.chunk_size,
                                 denom_eps=spec.denom_eps, plan=plan,
                                 plain=True)
    if causal:
        return fastmax_causal_chunked(
            qh, kh, v, p=spec.p, chunk_size=spec.chunk_size, kv_mask=kv_mask,
            denom_eps=spec.denom_eps, custom_grad=spec.custom_grad)
    return fastmax_noncausal(
        qh, kh, v, p=spec.p, kv_mask=kv_mask, denom_eps=spec.denom_eps,
        chunk_size=max(spec.chunk_size, 512))


def _kernel_fn(q, k, v, spec: AttentionSpec, *, causal, kv_mask, rng):
    from repro_torch.core.fastmax import normalize_qk
    from repro_torch.kernels import ops as kernel_ops

    del rng
    if kv_mask is not None:
        # the reference reroutes a masked causal call to its chunked backend
        # and drops the mask of a noncausal one; the port has no fallback
        # chain and drops nothing, so the caller picks that backend
        raise ValueError(
            "fastmax-kernel's full-sequence path takes no kv_mask (neither "
            "the §2.5 backward nor the noncausal kernel reads one); use "
            "fastmax2-chunked for masked full-sequence attention")
    spec = spec.resolved()
    qh = normalize_qk(q) if spec.normalize else q
    kh = normalize_qk(k) if spec.normalize else k
    _, plan = S.plan_call(q, k, v, causal=causal, seq=True)
    if plan is not None:
        # heads: the kernels per local (batch, kv head), no collectives;
        # feature: per Dv slice, the backward's partial dq/dk added across
        # "model"; seq: the rank's token shard, one carry exchange per
        # direction
        return S.run_in_model_layout(
            plan, lambda a, b, c: S.fastmax_sharded(
                a, b, c, p=spec.p, causal=causal, chunk_size=spec.chunk_size,
                denom_eps=spec.denom_eps, plan=plan), qh, kh, v)
    # no mesh, or kv heads and Dv both indivisible by "model": the kernels
    # on the whole heads every rank holds
    return kernel_ops.fastmax(qh, kh, v, p=spec.p, causal=causal,
                              chunk_size=spec.chunk_size,
                              denom_eps=spec.denom_eps)


def _refuse_mask(name, kv_mask):
    if kv_mask is not None:
        # the reference drops the mask silently; the port drops nothing
        raise ValueError(f"{name} takes no kv_mask; use fastmax2-chunked "
                         f"for masked attention")


def _oracle_fn(q, k, v, spec: AttentionSpec, *, causal, kv_mask, rng):
    from repro_torch.core.fastmax import _group_queries, _ungroup
    from repro_torch.core.ref import fastmax_attention_ref

    del rng
    _refuse_mask("fastmax-oracle", kv_mask)
    # each query group against its kv head: k, v broadcast over the group
    qg = _group_queries(q, k.shape[1])
    o = fastmax_attention_ref(qg, k[:, :, None], v[:, :, None], p=spec.p,
                              causal=causal, normalize=spec.normalize,
                              denom_eps=spec.denom_eps)
    return _ungroup(o)


def _rowwise_fn(q, k, v, spec: AttentionSpec, *, causal, kv_mask, rng):
    from repro_torch.core.fastmax import fastmax_rowwise

    _refuse_mask("fastmax-rowwise", kv_mask)
    if not spec.normalize:
        raise ValueError("fastmax-rowwise always normalizes (paper schedule)")
    return fastmax_rowwise(
        q, k, v, p=spec.p, causal=causal, denom_eps=spec.denom_eps,
        dropout_rate=spec.dropout_rate if rng is not None else 0.0,
        dropout_mode=spec.dropout_mode, generator=rng)


register(Backend(
    name="fastmax-oracle",
    family="fastmax",
    caps=Capabilities(),
    fn=_oracle_fn,
))

register(Backend(
    name="fastmax-rowwise",
    family="fastmax",
    caps=Capabilities(dropout=True),
    fn=_rowwise_fn,
))

register(Backend(
    name="fastmax-chunked",
    family="fastmax",
    caps=Capabilities(decode=True),
    fn=_chunked_fn,
))

register(Backend(
    name="fastmax-kernel",
    family="fastmax",
    caps=Capabilities(decode=True, decode_kernel=True, prefill_kernel=True),
    fn=_kernel_fn,
))


def _hybrid_chunked_fn(q, k, v, spec: AttentionSpec, *, causal, kv_mask,
                       rng):
    from repro_torch.core.fastmax import normalize_qk
    from repro_torch.core.hybrid import hybrid_causal_chunked
    from repro_torch.kernels.ops import note_route

    del rng
    if not causal:
        raise ValueError("hybrid attention is causal-only")
    note_route("plain attention: hybrid-chunked")
    spec = spec.resolved()
    qh = normalize_qk(q) if spec.normalize else q
    kh = normalize_qk(k) if spec.normalize else k
    # w_eff = 0 goes (inside hybrid_causal_chunked) to the fastmax scan
    return hybrid_causal_chunked(
        qh, kh, v, p=spec.p, window=spec.window, chunk_size=spec.chunk_size,
        kv_mask=kv_mask, denom_eps=spec.denom_eps,
        custom_grad=spec.custom_grad)


def _hybrid_kernel_fn(q, k, v, spec: AttentionSpec, *, causal, kv_mask,
                      rng):
    from repro_torch.core.fastmax import normalize_qk
    from repro_torch.kernels import ops as kernel_ops

    del rng
    if not causal:
        raise ValueError("hybrid attention is causal-only")
    if kv_mask is not None:
        # the reference drops the mask here and reroutes through its
        # fallback chain; the port has neither, so the caller picks the
        # backend that removes masked keys exactly
        raise ValueError(
            "hybrid-kernel takes no kv_mask (its §2.5 backward reads none); "
            "use hybrid2-chunked for masked attention")
    spec = spec.resolved()
    qh = normalize_qk(q) if spec.normalize else q
    kh = normalize_qk(k) if spec.normalize else k
    # no seq mode for the hybrid family, as in the reference
    _, plan = S.plan_call(q, k, v, causal=True)
    if plan is not None:
        return S.run_in_model_layout(
            plan, lambda a, b, c: S.hybrid_sharded(
                a, b, c, p=spec.p, window=spec.window,
                chunk_size=spec.chunk_size, denom_eps=spec.denom_eps,
                plan=plan), qh, kh, v)
    return kernel_ops.hybrid(qh, kh, v, p=spec.p, window=spec.window,
                             causal=causal, chunk_size=spec.chunk_size,
                             denom_eps=spec.denom_eps)


register(Backend(
    name="hybrid-chunked",
    family="hybrid",
    caps=Capabilities(decode=True),
    fn=_hybrid_chunked_fn,
))

# decode_kernel stays False, as in the reference: the hybrid decode state
# carries a rolling window beside the moments, which the decode kernel does
# not model, so the step and a resumed (offset) prefill run the plain
# two-leg protocol; a fresh prefill runs the hybrid kernel (at a window of
# 0, the fastmax prefill kernel)
register(Backend(
    name="hybrid-kernel",
    family="hybrid",
    caps=Capabilities(decode=True, decode_kernel=False, prefill_kernel=True),
    fn=_hybrid_kernel_fn,
))
