"""Built-in attention backends of the port — port of
`repro/attention/backends.py`.

  fastmax-chunked — the plain chunked prefix scan (core.fastmax), or the
                    global moment path when noncausal; exact kv masking;
                    the §2.5 custom backward; decode through the plain
                    moment step.
  fastmax-kernel  — the hand-written CUDA kernels (training forward and
                    §2.5 backward, prefill, decode, noncausal moments and
                    combine) on the native moment carry; CPU tensors take
                    the kernels' plain versions inside the wrappers.

Both fns share one signature: fn(q, k, v, spec, *, causal, kv_mask) -> o,
with q [B,Hq,N,D], k/v [B,Hkv,M,*], Hq % Hkv == 0 (M = N when causal).
The decode-state protocol (`attention.state`) routes on the capabilities.
softmax, oracle, rowwise and hybrid backends are not ported yet.
"""
from __future__ import annotations

from repro_torch.attention.registry import Backend, Capabilities, register
from repro_torch.attention.spec import AttentionSpec

__all__ = []


def _chunked_fn(q, k, v, spec: AttentionSpec, *, causal, kv_mask):
    from repro_torch.core.fastmax import (fastmax_causal_chunked,
                                          fastmax_noncausal, normalize_qk)

    spec = spec.resolved()
    qh = normalize_qk(q) if spec.normalize else q
    kh = normalize_qk(k) if spec.normalize else k
    if causal:
        return fastmax_causal_chunked(
            qh, kh, v, p=spec.p, chunk_size=spec.chunk_size, kv_mask=kv_mask,
            denom_eps=spec.denom_eps, custom_grad=spec.custom_grad)
    return fastmax_noncausal(
        qh, kh, v, p=spec.p, kv_mask=kv_mask, denom_eps=spec.denom_eps,
        chunk_size=max(spec.chunk_size, 512))


def _kernel_fn(q, k, v, spec: AttentionSpec, *, causal, kv_mask):
    from repro_torch.core.fastmax import normalize_qk
    from repro_torch.kernels import ops as kernel_ops

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
    return kernel_ops.fastmax(qh, kh, v, p=spec.p, causal=causal,
                              chunk_size=spec.chunk_size,
                              denom_eps=spec.denom_eps)


register(Backend(
    name="fastmax-chunked",
    family="fastmax",
    caps=Capabilities(decode=True),
    fn=_chunked_fn,
))

register(Backend(
    name="fastmax-kernel",
    family="fastmax",
    caps=Capabilities(decode=True, decode_kernel=True),
    fn=_kernel_fn,
))
