"""FAST / Fastmax attention — port of `repro/core/fastmax.py`.

f(x) = sum_{l<=p} x^l / l! on statistically normalized q, k factorizes
through key/value *moments*, so causal attention is a chunked prefix scan
with an O(D^{p+1}) carry. `_causal_scan` is the plain version of the CUDA
prefill kernel (`repro_torch.kernels.fastmax_causal`); `_causal_scan_cg`
pairs it with the paper's §2.5 reversible backward (`_causal_scan_cg_bwd`),
the plain version of the CUDA backward kernel
(`repro_torch.kernels.fastmax_causal_bwd`). `fastmax_noncausal` (global
moments over all keys, then one combine) is the plain version of the
noncausal kernel (`repro_torch.kernels.fastmax_noncausal`).

Shapes: q [B, Hq, N, D]; k, v [B, Hkv, M, *] with Hq % Hkv == 0 (M = N
for causal attention). Moments are computed once per kv head and shared by
the query group. `fastmax_rowwise` is the paper's own schedule through
explicit phi features, with the Fig. 2 dropout variants (plain torch: the
reference has no kernel for it). The port has no mesh, so the reference's
feature-sharded variants are left out.
"""
from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.ref import normalize_qk, poly_kernel
from repro_torch.kernels.tiling import SCAN_BM_BUDGET, pick_bm

__all__ = ["Moments", "compute_moments", "compute_moments_chunked",
           "combine_with_queries", "fastmax_noncausal",
           "fastmax_causal_chunked", "fastmax_rowwise", "fastmax_attention",
           "normalize_qk", "poly_kernel"]


class Moments(NamedTuple):
    """Factorized key/value moments (paper Eqs. 28-29), per batch x kv-head.

      m0 [..., Dv]        sum_n w_n v_n
      m1 [..., D, Dv]     sum_n w_n k_n v_n^T
      m2 [..., D, D, Dv]  sum_n w_n (k_n k_n^T) v_n  (zeros at p=1)
      g0 [...]            sum_n w_n
      g1 [..., D]         sum_n w_n k_n
      g2 [..., D, D]      sum_n w_n k_n k_n^T        (zeros at p=1)
    """

    m0: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor
    g0: torch.Tensor
    g1: torch.Tensor
    g2: torch.Tensor

    def __add__(self, other: "Moments") -> "Moments":
        return Moments(*(a + b for a, b in zip(self, other)))

    def __sub__(self, other: "Moments") -> "Moments":
        return Moments(*(a - b for a, b in zip(self, other)))


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """At-least-float32 accumulator type (bf16 -> f32; f64 stays f64)."""
    return torch.promote_types(x.dtype, torch.float32)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(_acc_dtype(x))


def _pick_bm(d: int) -> int:
    return pick_bm(d, SCAN_BM_BUDGET)


def compute_moments(k, v, *, p: int, kv_mask: Optional[torch.Tensor] = None,
                    accum_dtype=None) -> Moments:
    """Moments of (k, v) over the token axis. k [..., N, D], v [..., N, Dv].

    `kv_mask` ([..., N], 1 = valid) removes padding tokens from numerator
    and denominator alike.
    """
    d, dv = k.shape[-1], v.shape[-1]
    acc = accum_dtype or _acc_dtype(k)
    kf, vf = k.to(acc), v.to(acc)
    if kv_mask is not None:
        w = kv_mask.to(acc)
        kw, vw = kf * w[..., None], vf * w[..., None]
        g0 = w.sum(dim=-1)
    else:
        kw, vw = kf, vf
        g0 = torch.full(k.shape[:-2], float(k.shape[-2]), dtype=acc,
                        device=k.device)
    m0 = vw.sum(dim=-2)
    m1 = torch.einsum("...nm,...nj->...mj", kw, vf)
    g1 = kw.sum(dim=-2)
    if p >= 2:
        # m-blocked: never materialize [..., N, D, D]
        bm = _pick_bm(d)
        parts = []
        for s in range(0, d, bm):
            t = (kw[..., :, s:s + bm, None] * kf[..., :, None, :]).reshape(
                *k.shape[:-1], bm * d)
            w2 = torch.einsum("...nf,...nj->...fj", t, vf)
            parts.append(w2.reshape(*k.shape[:-2], bm, d, dv))
        m2 = torch.cat(parts, dim=-3)
        g2 = torch.einsum("...nm,...nl->...ml", kw, kf)
    else:
        shape = k.shape[:-2]
        m2 = torch.zeros(shape + (d, d, dv), dtype=acc, device=k.device)
        g2 = torch.zeros(shape + (d, d), dtype=acc, device=k.device)
    return Moments(m0, m1, m2, g0, g1, g2)


def combine_with_queries(q, mom: Moments, *, p: int):
    """Per-query contraction with moments (paper Eqs. 26-27).

    q [..., n, D]; moments broadcast against q's batch dims.
    Returns (num [..., n, Dv], den [..., n]).
    """
    acc = torch.promote_types(_acc_dtype(q), mom.m1.dtype)
    qf = q.to(acc)
    m = Moments(*(x.to(acc) for x in mom))
    num = m.m0[..., None, :] + torch.einsum("...nm,...mj->...nj", qf, m.m1)
    den = m.g0[..., None] + torch.einsum("...nm,...m->...n", qf, m.g1)
    if p >= 2:
        d, dv = qf.shape[-1], m.m2.shape[-1]
        bm = _pick_bm(d)
        num2 = None
        for s in range(0, d, bm):
            y = (qf[..., :, s:s + bm, None] * qf[..., :, None, :]).reshape(
                *qf.shape[:-1], bm * d)
            z = m.m2[..., s:s + bm, :, :].reshape(
                *m.m2.shape[:-3], bm * d, dv)
            c = torch.einsum("...nf,...fj->...nj", y, z)
            num2 = c if num2 is None else num2 + c
        num = num + 0.5 * num2
        t = torch.einsum("...nm,...ml->...nl", qf, m.g2)
        den = den + 0.5 * torch.einsum("...nl,...nl->...n", t, qf)
    return num, den


# ---------------------------------------------------------------------------
# GQA plumbing
# ---------------------------------------------------------------------------


def _group_queries(q: torch.Tensor, h_kv: int) -> torch.Tensor:
    """[B, Hq, N, D] -> [B, Hkv, G, N, D]."""
    b, hq, n, d = q.shape
    if hq % h_kv != 0:
        raise ValueError(f"Hq={hq} not divisible by Hkv={h_kv}")
    return q.reshape(b, h_kv, hq // h_kv, n, d)


def _ungroup(o: torch.Tensor) -> torch.Tensor:
    """[B, Hkv, G, N, Dv] -> [B, Hq, N, Dv]."""
    b, hkv, g, n, dv = o.shape
    return o.reshape(b, hkv * g, n, dv)


def _combine_grouped(qg, mom: Moments, *, p: int):
    """combine_with_queries with the G axis folded into the token axis."""
    b, hkv, g, n, d = qg.shape
    num, den = combine_with_queries(qg.reshape(b, hkv, g * n, d), mom, p=p)
    return num.reshape(b, hkv, g, n, -1), den.reshape(b, hkv, g, n)


# ---------------------------------------------------------------------------
# Noncausal factorized path
# ---------------------------------------------------------------------------


def compute_moments_chunked(k, v, *, p: int,
                            kv_mask: Optional[torch.Tensor] = None,
                            chunk_size: int = 512) -> Moments:
    """Full-sequence moments summed over chunks of `chunk_size` keys —
    peak memory O(chunk * bm * D) instead of O(M * bm * D). The last chunk
    is zero-padded and masked out. k [B,Hkv,M,D], v [B,Hkv,M,Dv]."""
    b, hkv, m, _ = k.shape
    if m <= chunk_size:
        return compute_moments(k, v, p=p, kv_mask=kv_mask)
    nc = -(-m // chunk_size)
    pad = nc * chunk_size - m
    kp = F.pad(k, (0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, pad))
    if kv_mask is None:
        mask = torch.ones(b, hkv, m, dtype=torch.float32, device=k.device)
    else:
        mask = kv_mask.to(torch.float32)
    maskp = F.pad(mask, (0, pad))
    mom = None
    for c in range(nc):
        sl = slice(c * chunk_size, (c + 1) * chunk_size)
        part = compute_moments(kp[:, :, sl], vp[:, :, sl], p=p,
                               kv_mask=maskp[..., sl])
        mom = part if mom is None else mom + part
    return mom


def fastmax_noncausal(q, k, v, *, p: int = 2,
                      kv_mask: Optional[torch.Tensor] = None,
                      denom_eps: float = 1e-6,
                      chunk_size: int = 512) -> torch.Tensor:
    """Bidirectional fastmax on pre-normalized q/k, in q's dtype.
    q [B,Hq,N,D]; k, v [B,Hkv,M,*] (N != M for cross-attention);
    O(N D^{p+1})."""
    hkv = k.shape[1]
    mom = compute_moments_chunked(k, v, p=p, kv_mask=kv_mask,
                                  chunk_size=chunk_size)
    num, den = _combine_grouped(_group_queries(q, hkv), mom, p=p)
    o = num / (den + denom_eps)[..., None]
    return _ungroup(o).to(q.dtype)


# ---------------------------------------------------------------------------
# Causal chunked scan
# ---------------------------------------------------------------------------


def _intra_chunk(qg, kc, vc, *, p: int, wc):
    """Exact within-chunk causal terms through the c x c score block.

    qg [B,Hkv,G,c,D], kc [B,Hkv,c,D], vc [B,Hkv,c,Dv], wc [B,Hkv,c].
    Returns (num [B,Hkv,G,c,Dv], den [B,Hkv,G,c]).
    """
    c = kc.shape[-2]
    acc = _acc_dtype(qg)
    s = torch.einsum("...gnd,...md->...gnm", qg.to(acc), kc.to(acc))
    fs = poly_kernel(s, p) * torch.ones(c, c, dtype=acc,
                                        device=s.device).tril()
    if wc is not None:
        fs = fs * wc[..., None, None, :].to(acc)
    num = torch.einsum("...gnm,...mj->...gnj", fs, vc.to(acc))
    return num, fs.sum(dim=-1)


def _causal_scan(q, k, v, *, p: int, chunk_size: int,
                 kv_mask: Optional[torch.Tensor], denom_eps: float,
                 init: Optional[Moments] = None):
    """Chunked causal fastmax. Returns (o [B,Hq,N,Dv], final Moments).

    The carry holds the moments of all previous chunks; each chunk adds an
    exact intra-chunk term. `init` seeds the carry (resumable prefill: the
    queries of this call also attend to every token folded into `init`).
    o and the moments come out in the accumulator type of k.
    """
    b, hq, n, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    cs = min(chunk_size, n)
    nc = -(-n // cs)
    pad = nc * cs - n
    if kv_mask is None:
        w = torch.ones(b, hkv, n, dtype=torch.float32, device=k.device)
    else:
        w = kv_mask.to(torch.float32)
    qp = F.pad(q, (0, 0, 0, pad))
    kp = F.pad(k, (0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, pad))
    wp = F.pad(w, (0, pad))
    qg = _group_queries(qp, hkv)
    g = qg.shape[2]

    acc = _acc_dtype(k)
    if init is None:
        carry = Moments(
            torch.zeros(b, hkv, dv, dtype=acc, device=k.device),
            torch.zeros(b, hkv, d, dv, dtype=acc, device=k.device),
            torch.zeros(b, hkv, d, d, dv, dtype=acc, device=k.device),
            torch.zeros(b, hkv, dtype=acc, device=k.device),
            torch.zeros(b, hkv, d, dtype=acc, device=k.device),
            torch.zeros(b, hkv, d, d, dtype=acc, device=k.device))
    else:
        carry = Moments(*(x.to(acc) for x in init))

    outs = []
    for c in range(nc):
        sl = slice(c * cs, (c + 1) * cs)
        qc, kc, vc, wc = qg[:, :, :, sl], kp[:, :, sl], vp[:, :, sl], wp[..., sl]
        num_i, den_i = _combine_grouped(qc, carry, p=p)
        num_a, den_a = _intra_chunk(qc, kc, vc, p=p, wc=wc)
        outs.append((num_i + num_a) / (den_i + den_a + denom_eps)[..., None])
        carry = carry + compute_moments(kc, vc, p=p, kv_mask=wc)
    o = torch.cat(outs, dim=3)
    return _ungroup(o)[:, :, :n], carry


def _chunk_fwd(carry: Moments, qc, kc, vc, wc, *, p: int, denom_eps: float):
    """One chunk of the forward scan: (o, carry after the chunk)."""
    num_i, den_i = _combine_grouped(qc, carry, p=p)
    num_a, den_a = _intra_chunk(qc, kc, vc, p=p, wc=wc)
    o = (num_i + num_a) / (den_i + den_a + denom_eps)[..., None]
    return o, carry + compute_moments(kc, vc, p=p, kv_mask=wc)


def _causal_scan_cg_bwd(p: int, chunk_size: int, denom_eps: float, res, do,
                        *, return_dstate: bool = False):
    """§2.5 reverse scan on the residual (q, k, v, final Moments).

    Walks the chunks backwards, rebuilding each chunk's incoming carry
    reversibly (moments are sums: carry_before = carry_after - delta) and
    differentiating the chunk's forward (re-run under autograd) against
    the output cotangent and the carry-cotangent of the later chunks.
    Returns (dq, dk, dv) in the input dtypes; `return_dstate=True` appends
    the cotangent of the scan's INITIAL carry (the seed's gradient when
    the forward was seeded), a Moments-layout tuple in the accumulator
    type."""
    if torch.is_inference_mode_enabled():
        # autograd records nothing there, and every grad would come back 0
        raise RuntimeError("the §2.5 backward re-runs each chunk under "
                           "autograd: call it outside torch.inference_mode()")
    q, k, v, final = res
    b, hq, n, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    cs = min(chunk_size, n)
    nc = -(-n // cs)
    pad = nc * cs - n
    acc = _acc_dtype(k)
    # widened once: each chunk's grads then come back in the accumulator
    # type and are rounded to the input dtype once, at the end (as the
    # kernel does). Differentiating the low-precision slices would round
    # each use's contribution and their sum to bf16 inside every chunk.
    qp = F.pad(q, (0, 0, 0, pad)).to(acc)
    kp = F.pad(k, (0, 0, 0, pad)).to(acc)
    vp = F.pad(v, (0, 0, 0, pad)).to(acc)
    # the chunk forward emits accumulator-type outputs: a low-precision
    # cotangent (the kernel path's do arrives in the input dtype) is
    # promoted to match
    dop = F.pad(do, (0, 0, 0, pad)).to(acc)
    # same validity mask as the forward scan: zeros on padded tail tokens
    wp = F.pad(torch.ones(b, hkv, n, dtype=torch.float32, device=k.device),
               (0, pad))
    qg = _group_queries(qp, hkv)
    dog = _group_queries(dop, hkv)
    g = qg.shape[2]

    carry = Moments(*(x.to(acc) for x in final))
    gcarry = Moments(*(torch.zeros_like(x) for x in carry))
    gqs, gks, gvs = [], [], []
    for c in reversed(range(nc)):
        sl = slice(c * cs, (c + 1) * cs)
        qc, kc, vc, wc = qg[:, :, :, sl], kp[:, :, sl], vp[:, :, sl], wp[..., sl]
        with torch.no_grad():
            carry = carry - compute_moments(kc, vc, p=p, kv_mask=wc)
        with torch.enable_grad():
            prim = [x.detach().requires_grad_(True)
                    for x in (*carry, qc, kc, vc)]
            o, new = _chunk_fwd(Moments(*prim[:6]), *prim[6:], wc, p=p,
                                denom_eps=denom_eps)
            outs = [o, *new]
            cots = [dog[:, :, :, sl], *gcarry]
            keep = [i for i, x in enumerate(outs) if x.requires_grad]
            grads = torch.autograd.grad([outs[i] for i in keep],
                                        prim, [cots[i] for i in keep],
                                        allow_unused=True)
        grads = [torch.zeros_like(x) if gr is None else gr
                 for x, gr in zip(prim, grads)]
        gcarry = Moments(*grads[:6])
        gqs.append(grads[6])
        gks.append(grads[7])
        gvs.append(grads[8])
    gq = torch.cat(gqs[::-1], dim=3).reshape(b, hkv * g, nc * cs, d)
    gk = torch.cat(gks[::-1], dim=2)
    gv = torch.cat(gvs[::-1], dim=2)
    out = (gq[:, :, :n].to(q.dtype), gk[:, :, :n].to(k.dtype),
           gv[:, :, :n].to(v.dtype))
    if return_dstate:
        return out + (tuple(gcarry),)
    return out


class _CausalScanCG(torch.autograd.Function):
    """Causal fastmax with the paper §2.5 memory-reduced gradient: the
    forward keeps only (q, k, v, final moments); the backward rebuilds the
    carry chunk by chunk in reverse (`_causal_scan_cg_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, p, chunk_size, denom_eps):
        o, final = _causal_scan(q, k, v, p=p, chunk_size=chunk_size,
                                kv_mask=None, denom_eps=denom_eps)
        ctx.save_for_backward(q, k, v, *final)
        ctx.cfg = (p, chunk_size, denom_eps)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, *final = ctx.saved_tensors
        dq, dk, dv = _causal_scan_cg_bwd(*ctx.cfg, (q, k, v, Moments(*final)),
                                         do)
        return dq, dk, dv, None, None, None


def _causal_scan_cg(q, k, v, p: int, chunk_size: int, denom_eps: float):
    return _CausalScanCG.apply(q, k, v, p, chunk_size, denom_eps)


def fastmax_causal_chunked(q, k, v, *, p: int = 2, chunk_size: int = 128,
                           kv_mask: Optional[torch.Tensor] = None,
                           denom_eps: float = 1e-6,
                           custom_grad: bool = True) -> torch.Tensor:
    """Causal fastmax on pre-normalized q/k through the chunked scan, in
    q's dtype. `custom_grad` (and no mask) pairs it with the §2.5
    backward; otherwise autograd differentiates the plain scan."""
    if custom_grad and kv_mask is None:
        o = _causal_scan_cg(q, k, v, p, chunk_size, denom_eps)
    else:
        o, _ = _causal_scan(q, k, v, p=p, chunk_size=chunk_size,
                            kv_mask=kv_mask, denom_eps=denom_eps)
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# The paper's rowwise schedule (+ the Fig. 2 dropout variants)
# ---------------------------------------------------------------------------


def _phi_features(x: torch.Tensor, *, p: int,
                  quad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """phi(x) with f(q.k) = phi(q).phi(k): [1, x, vec(x x^T)/sqrt(2)]."""
    parts = [torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device),
             x]
    if p >= 2:
        d = x.shape[-1]
        outer = (x[..., :, None] * x[..., None, :]) / math.sqrt(2.0)
        outer = outer.reshape(x.shape[:-1] + (d * d,))
        if quad_mask is not None:
            outer = outer * quad_mask
        parts.append(outer)
    return torch.cat(parts, dim=-1)


def draw_keep(shape, keep_prob: float, generator: torch.Generator,
              device) -> torch.Tensor:
    """A boolean keep mask, True with probability `keep_prob`, drawn from
    `generator` (on `device`). The dropout's one source of randomness: the
    port cannot reproduce `jax.random.bernoulli`'s bits, so parity tests
    replace this function with one that returns the reference's masks."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob


def fastmax_rowwise(q, k, v, *, p: int = 2, causal: bool = False,
                    denom_eps: float = 1e-6, dropout_rate: float = 0.0,
                    dropout_mode: str = "quadratic",
                    generator: Optional[torch.Generator] = None):
    """The paper's own schedule (Eqs. 26-35) through explicit phi features,
    on q, k that it normalizes itself; o in q's dtype.

    Causal attention is a running prefix sum over the tokens of
    phi(k_n) [v_n; 1]^T, the paper's O(N D^p)-memory layout
    ([B, Hkv, N, 1+D+D², Dv+1]: keep it small). With a `generator` and
    `dropout_rate` > 0, the Fig. 2 dropout variants:
      * "quadratic": a [B, Hkv, 1, D²] keep mask on the degree-2 feature
        dims, shared by queries and keys (the paper's best);
      * "1d": keep masks on whole dims of q and of k (two draws, q's
        first) before the factorization;
      * "none": no dropout.
    Kept entries are scaled by 1 / (1 - rate).
    """
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    qh = normalize_qk(_f32(q))
    kh = normalize_qk(_f32(k))

    quad_mask = None
    if dropout_rate > 0.0 and generator is not None:
        keep = 1.0 - dropout_rate
        if dropout_mode == "quadratic" and p >= 2:
            mask = draw_keep((b, hkv, 1, d * d), keep, generator, q.device)
            # float32, as the reference builds it, whatever the inputs
            quad_mask = mask.to(torch.float32) / keep
        elif dropout_mode == "1d":
            keep_q = draw_keep(qh.shape, keep, generator, q.device)
            keep_k = draw_keep(kh.shape, keep, generator, q.device)
            qh = qh * keep_q / keep
            kh = kh * keep_k / keep

    qg = _group_queries(qh, hkv)
    phq = _phi_features(qg, p=p, quad_mask=None if quad_mask is None
                        else quad_mask[:, :, None])
    phk = _phi_features(kh, p=p, quad_mask=quad_mask)
    acc = _acc_dtype(q)
    v1 = torch.cat([_f32(v), torch.ones(v.shape[:-1] + (1,), dtype=acc,
                                        device=v.device)], dim=-1)
    if causal:
        # running prefix of phi(k) [v;1]^T over the tokens
        pref = torch.cumsum(phk[..., :, None] * v1[..., None, :], dim=-3)
        fg = torch.einsum("...gnf,...nfj->...gnj", phq, pref)
    else:
        mom = torch.einsum("...nf,...nj->...fj", phk, v1)
        fg = torch.einsum("...gnf,...fj->...gnj", phq, mom)
    num, den = fg[..., :-1], fg[..., -1]
    o = num / (den + denom_eps)[..., None]
    return _ungroup(o).to(q.dtype)


# ---------------------------------------------------------------------------
# Deprecated entry point (use repro_torch.attention.attention)
# ---------------------------------------------------------------------------


def fastmax_attention(q, k, v, *, p: int = 2, causal: bool = False,
                      normalize: bool = True, impl: str = "chunked",
                      chunk_size: int = 128,
                      kv_mask: Optional[torch.Tensor] = None,
                      denom_eps: float = 1e-6, custom_grad: bool = True,
                      feature_shard: bool = False,
                      dropout_rate: float = 0.0,
                      dropout_mode: str = "quadratic",
                      dropout_rng: Optional[torch.Generator] = None):
    """DEPRECATED shim over `repro_torch.attention.attention`, kept so that
    callers of the reference's 13-kwarg entry point keep working: it builds
    an `AttentionSpec` and calls the dispatcher (`dropout_rng` is a
    `torch.Generator`; `feature_shard` is ignored: the port has no mesh)."""
    from repro_torch.attention import AttentionSpec, attention

    del feature_shard
    warnings.warn(
        "repro_torch.core.fastmax.fastmax_attention is deprecated; use "
        "repro_torch.attention.attention(q, k, v, AttentionSpec(...))",
        DeprecationWarning, stacklevel=2)
    spec = AttentionSpec(
        family="fastmax", p=p, impl=impl, chunk_size=chunk_size,
        normalize=normalize, denom_eps=denom_eps, custom_grad=custom_grad,
        dropout_rate=dropout_rate, dropout_mode=dropout_mode)
    return attention(q, k, v, spec, causal=causal, kv_mask=kv_mask,
                     rng=dropout_rng)
