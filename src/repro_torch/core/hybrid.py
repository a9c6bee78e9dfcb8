"""Hybrid near/far-field attention — port of `repro/core/hybrid.py`.

An exact softmax over a width-`window` causal band (the near field) plus
the fastmax moments over every causal token (the far field), under one
normalizer. With normalized scores s_ij = q̂_i·k̂_j and f_p the paper's
polynomial, the unnormalized weight is

    w_ij = f_p(s_ij)                   for all causal j      (moments)
         + [exp(s_ij) - f_p(s_ij)]     for 0 <= i - j < w    (band fix)

so w = 0 is fastmax and w >= N is softmax over the normalized scores. The
band is clamped to one chunk, w_eff = min(window, chunk_size), in the scan
and the decode state alike. exp(s) is unshifted, as in the reference: with
|s| up to D it overflows float32 above s ~ 88.7 (ROADMAP queue 3). Inside
a chunk the scan weighs each band pair exp(s) directly, where the
reference adds the f_p and (exp - f_p) blocks' sums, which cancel in
float32 (`_intra_hybrid`); the function is the same.

`_hybrid_scan` is the plain version of the CUDA hybrid kernel
(`repro_torch.kernels.hybrid_causal`); `hybrid_bwd_scan` is the §2.5
reverse scan extended with the band's residuals, the backward of both the
chunked scan (`_HybridScanCG`) and the kernel (`kernels.ops.hybrid`).
`roll_window` keeps the decode state's window of the last W valid tokens.
The reference's feature-sharded variants are left out: the port has no
mesh.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.fastmax import (Moments, _acc_dtype, _causal_scan,
                                      _causal_scan_cg_bwd, _combine_grouped,
                                      _group_queries, _ungroup,
                                      compute_moments, fastmax_causal_chunked)
from repro_torch.core.ref import normalize_qk, poly_kernel

__all__ = ["effective_window", "hybrid_attention_ref",
           "hybrid_causal_chunked", "hybrid_bwd_scan", "roll_window"]


def effective_window(window: int, chunk_size: int) -> int:
    """The band width the scan, kernel and decode paths realize."""
    return max(0, min(int(window), int(chunk_size)))


def _band_corr(qc, kc, vc, wc, band, *, p: int):
    """(exp - f_p) correction over a masked score block.

    qc [B,Hkv,G,n,D], kc [B,Hkv,m,D], vc [B,Hkv,m,Dv], wc [B,Hkv,m]
    validity (or None), band [n,m] mask. Returns (num [B,Hkv,G,n,Dv],
    den [B,Hkv,G,n]).
    """
    acc = _acc_dtype(qc)
    s = torch.einsum("...gnd,...md->...gnm", qc.to(acc), kc.to(acc))
    corr = (torch.exp(s) - poly_kernel(s, p)) * band.to(acc)
    if wc is not None:
        corr = corr * wc[..., None, None, :].to(acc)
    num = torch.einsum("...gnm,...mj->...gnj", corr, vc.to(acc))
    return num, corr.sum(dim=-1)


def _intra_hybrid(qc, kc, vc, wc, intra_band, *, p: int):
    """The exact in-chunk terms of the hybrid: weight exp(s) on the band's
    pairs and f_p(s) on the other causal pairs, times the validity wc.

    The reference sums the chunk's f_p(s) and the band's
    (exp(s) - f_p(s)) as two separate blocks and adds the sums; in the
    first w_eff rows, where every key is in the band, those sums cancel
    down to sum exp(s), which for very negative s is far below their
    float32 rounding (ROADMAP queue 3). Combining each pair first gives
    the same function without that cancellation. exp is taken of the
    band's scores only (0 elsewhere), so a score outside the band cannot
    overflow into the result or its gradient.
    Returns (num [B,Hkv,G,c,Dv], den [B,Hkv,G,c]).
    """
    c = kc.shape[-2]
    acc = _acc_dtype(qc)
    s = torch.einsum("...gnd,...md->...gnm", qc.to(acc), kc.to(acc))
    band = intra_band.to(torch.bool)
    tri = torch.ones(c, c, dtype=torch.bool, device=s.device).tril()
    wgt = torch.where(band, torch.exp(torch.where(band, s, 0.0)),
                      poly_kernel(s, p) * tri.to(acc))
    if wc is not None:
        wgt = wgt * wc[..., None, None, :].to(acc)
    num = torch.einsum("...gnm,...mj->...gnj", wgt, vc.to(acc))
    return num, wgt.sum(dim=-1)


def _band_masks(cs: int, w_eff: int, device=None, dtype=torch.float32):
    """(intra, prev) band masks for chunk length `cs`.

    intra[i, m]: key m of the SAME chunk is in band, 0 <= i - m < w_eff;
    prev[i, m]: key m of the PREVIOUS chunk is, i + cs - m < w_eff.
    """
    i = torch.arange(cs, device=device)[:, None]
    m = torch.arange(cs, device=device)[None, :]
    intra = ((i >= m) & (i - m < w_eff)).to(dtype)
    prev = ((i + cs - m) < w_eff).to(dtype)
    return intra, prev


# ---------------------------------------------------------------------------
# Composed O(N^2) oracle
# ---------------------------------------------------------------------------


def hybrid_attention_ref(q, k, v, *, p: int = 2, window: int = 64,
                         kv_mask: Optional[torch.Tensor] = None,
                         denom_eps: float = 1e-6,
                         normalize: bool = True) -> torch.Tensor:
    """Dense reference: banded exact softmax plus masked fastmax, one
    normalizer. q [B,Hq,N,D], k, v [B,Hkv,N,*]. Causal only."""
    hkv, n = k.shape[1], q.shape[2]
    acc = _acc_dtype(q)
    qh, kh = q.to(acc), k.to(acc)
    if normalize:
        qh, kh = normalize_qk(qh), normalize_qk(kh)
    s = torch.einsum("...gnd,...md->...gnm", _group_queries(qh, hkv), kh)
    i = torch.arange(n, device=q.device)[:, None]
    j = torch.arange(n, device=q.device)[None, :]
    tri = (i >= j).to(acc)
    band = ((i >= j) & (i - j < window)).to(acc)
    w = poly_kernel(s, p) * tri + (torch.exp(s) - poly_kernel(s, p)) * band
    if kv_mask is not None:
        w = w * kv_mask[..., None, None, :].to(acc)
    num = torch.einsum("...gnm,...mj->...gnj", w, v.to(acc))
    o = num / (w.sum(dim=-1) + denom_eps)[..., None]
    return _ungroup(o).to(q.dtype)


# ---------------------------------------------------------------------------
# Chunked causal scan (plain version of the CUDA kernel; chunked backend)
# ---------------------------------------------------------------------------


def _hybrid_scan(q, k, v, *, p: int, window: int, chunk_size: int,
                 kv_mask: Optional[torch.Tensor], denom_eps: float,
                 init: Optional[Moments] = None, init_win=None):
    """Chunked causal hybrid on normalized q, k. Returns (o, final
    Moments), both in the accumulator type of k.

    The carry holds the moments of all previous chunks and the previous
    chunk's (k, v, validity), so the band reaches one chunk back (hence
    w_eff = min(window, cs)). `init` seeds the moments; `init_win` =
    (wk, wv, wm) is the decode state's window of the last <= W tokens
    already folded, right-aligned, embedded in the last rows of a zeroed
    previous-chunk buffer so that each carried token sits at its token
    distance from this call's queries.
    """
    b, hq, n, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    cs = min(chunk_size, n)
    if init_win is not None:
        # the carried window must fit inside one previous-chunk buffer
        cs = min(chunk_size, max(n, init_win[0].shape[2]))
    w_eff = effective_window(window, cs)
    if w_eff == 0:
        return _causal_scan(q, k, v, p=p, chunk_size=chunk_size,
                            kv_mask=kv_mask, denom_eps=denom_eps, init=init)
    nc = -(-n // cs)
    pad = nc * cs - n
    if kv_mask is None:
        w = torch.ones(b, hkv, n, dtype=torch.float32, device=k.device)
    else:
        w = kv_mask.to(torch.float32)
    qg = _group_queries(F.pad(q, (0, 0, 0, pad)), hkv)
    kp = F.pad(k, (0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, pad))
    wp = F.pad(w, (0, pad))
    intra_band, prev_band = _band_masks(cs, w_eff, device=k.device)

    acc = _acc_dtype(k)
    if init is None:
        mom = Moments(*(torch.zeros(s, dtype=acc, device=k.device) for s in (
            (b, hkv, dv), (b, hkv, d, dv), (b, hkv, d, d, dv), (b, hkv),
            (b, hkv, d), (b, hkv, d, d))))
    else:
        mom = Moments(*(x.to(acc) for x in init))
    pk = torch.zeros(b, hkv, cs, d, dtype=k.dtype, device=k.device)
    pv = torch.zeros(b, hkv, cs, dv, dtype=v.dtype, device=k.device)
    pw = torch.zeros(b, hkv, cs, dtype=torch.float32, device=k.device)
    if init_win is not None:
        wk, wv, wm = init_win
        wlen = wk.shape[2]
        pk[:, :, cs - wlen:] = wk.to(pk.dtype)
        pv[:, :, cs - wlen:] = wv.to(pv.dtype)
        pw[:, :, cs - wlen:] = wm.to(pw.dtype)

    outs = []
    for c in range(nc):
        sl = slice(c * cs, (c + 1) * cs)
        qc, kc, vc, wc = qg[:, :, :, sl], kp[:, :, sl], vp[:, :, sl], wp[..., sl]
        oc, mom = _chunk_fwd(mom, qc, kc, vc, wc, pk, pv, pw,
                             (intra_band, prev_band), p=p,
                             denom_eps=denom_eps)
        outs.append(oc)
        pk, pv, pw = kc, vc, wc
    o = torch.cat(outs, dim=3)
    return _ungroup(o)[:, :, :n], mom


def _chunk_fwd(mom: Moments, qc, kc, vc, wc, kp_, vp_, wp_, bands, *,
               p: int, denom_eps: float):
    """One chunk of the hybrid scan: (o, moments after the chunk)."""
    intra_band, prev_band = bands
    num_i, den_i = _combine_grouped(qc, mom, p=p)
    num_a, den_a = _intra_hybrid(qc, kc, vc, wc, intra_band, p=p)
    num_p, den_p = _band_corr(qc, kp_, vp_, wp_, prev_band, p=p)
    num = num_i + num_a + num_p
    den = den_i + den_a + den_p
    o = num / (den + denom_eps)[..., None]
    return o, mom + compute_moments(kc, vc, p=p, kv_mask=wc)


def hybrid_bwd_scan(q, k, v, final, do, *, p: int, window: int,
                    chunk_size: int, denom_eps: float):
    """§2.5 reverse scan extended with the band's residuals. Returns
    (dq, dk, dv) in the input dtypes.

    As in `fastmax._causal_scan_cg_bwd`, each chunk's incoming moments are
    rebuilt reversibly (carry before = carry after - the chunk's moments)
    and the chunk's forward is re-run under autograd; here the chunk's
    forward also reads the PREVIOUS chunk's (k, v), whose cotangents are
    added to that chunk's grads. q, k, v are widened to the accumulator
    type once and each grad is rounded once, at the end. `final` is the
    forward's final moment carry (the kernel's emitted state, or the
    chunked scan's).
    """
    if torch.is_inference_mode_enabled():
        # autograd records nothing there, and every grad would come back 0
        raise RuntimeError("the §2.5 backward re-runs each chunk under "
                           "autograd: call it outside torch.inference_mode()")
    b, hq, n, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    cs = min(chunk_size, n)
    w_eff = effective_window(window, cs)
    if w_eff == 0:
        return _causal_scan_cg_bwd(p, chunk_size, denom_eps,
                                   (q, k, v, final), do)
    nc = -(-n // cs)
    pad = nc * cs - n
    acc = _acc_dtype(k)
    qg = _group_queries(F.pad(q, (0, 0, 0, pad)).to(acc), hkv)
    kp = F.pad(k, (0, 0, 0, pad)).to(acc)
    vp = F.pad(v, (0, 0, 0, pad)).to(acc)
    dog = _group_queries(F.pad(do, (0, 0, 0, pad)).to(acc), hkv)
    wp = F.pad(torch.ones(b, hkv, n, dtype=torch.float32, device=k.device),
               (0, pad))
    g = qg.shape[2]
    bands = _band_masks(cs, w_eff, device=k.device)
    zk = torch.zeros(b, hkv, cs, d, dtype=acc, device=k.device)
    zv = torch.zeros(b, hkv, cs, dv, dtype=acc, device=k.device)
    zw = torch.zeros(b, hkv, cs, dtype=torch.float32, device=k.device)

    mom = Moments(*(x.to(acc) for x in final))
    gmom = Moments(*(torch.zeros_like(x) for x in mom))
    gqs, gks, gvs = [None] * nc, [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        sl = slice(c * cs, (c + 1) * cs)
        qc, kc, vc, wc = qg[:, :, :, sl], kp[:, :, sl], vp[:, :, sl], wp[..., sl]
        if c > 0:
            ps = slice((c - 1) * cs, c * cs)
            kpc, vpc, wpc = kp[:, :, ps], vp[:, :, ps], wp[..., ps]
        else:
            kpc, vpc, wpc = zk, zv, zw
        with torch.no_grad():
            if c > 0:
                mom = mom - compute_moments(kc, vc, p=p, kv_mask=wc)
            else:
                # the carry before the first chunk is zero (the hybrid scan
                # takes no seed). Its rebuild leaves float32 rounding of the
                # final carry there, which the first w_eff rows cannot
                # absorb: their denominators are sums of exp(s) alone
                mom = Moments(*(torch.zeros_like(x) for x in mom))
        with torch.enable_grad():
            prim = [x.detach().requires_grad_(True)
                    for x in (*mom, qc, kc, vc, kpc, vpc)]
            o, new = _chunk_fwd(Moments(*prim[:6]), *prim[6:9], wc,
                                *prim[9:], wpc, bands, p=p,
                                denom_eps=denom_eps)
            outs = [o, *new]
            cots = [dog[:, :, :, sl], *gmom]
            keep = [i for i, x in enumerate(outs) if x.requires_grad]
            grads = torch.autograd.grad([outs[i] for i in keep], prim,
                                        [cots[i] for i in keep],
                                        allow_unused=True)
        grads = [torch.zeros_like(x) if gr is None else gr
                 for x, gr in zip(prim, grads)]
        gmom = Moments(*grads[:6])
        gqs[c] = grads[6]
        # this chunk's keys also fed the next chunk's band (added earlier)
        gks[c] = grads[7] if gks[c] is None else gks[c] + grads[7]
        gvs[c] = grads[8] if gvs[c] is None else gvs[c] + grads[8]
        if c > 0:
            gks[c - 1], gvs[c - 1] = grads[9], grads[10]
    gq = torch.cat(gqs, dim=3).reshape(b, hkv * g, nc * cs, d)
    gk = torch.cat(gks, dim=2)
    gv = torch.cat(gvs, dim=2)
    return (gq[:, :, :n].to(q.dtype), gk[:, :, :n].to(k.dtype),
            gv[:, :, :n].to(v.dtype))


class _HybridScanCG(torch.autograd.Function):
    """Hybrid causal scan with the §2.5 memory-reduced gradient: the
    forward keeps only (q, k, v, final moments); the backward is
    `hybrid_bwd_scan`."""

    @staticmethod
    def forward(ctx, q, k, v, p, window, chunk_size, denom_eps):
        o, final = _hybrid_scan(q, k, v, p=p, window=window,
                                chunk_size=chunk_size, kv_mask=None,
                                denom_eps=denom_eps)
        ctx.save_for_backward(q, k, v, *final)
        ctx.cfg = dict(p=p, window=window, chunk_size=chunk_size,
                       denom_eps=denom_eps)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, *final = ctx.saved_tensors
        dq, dk, dv = hybrid_bwd_scan(q, k, v, Moments(*final), do,
                                     **ctx.cfg)
        return dq, dk, dv, None, None, None, None


def hybrid_causal_chunked(q, k, v, *, p: int = 2, window: int = 64,
                          chunk_size: int = 128,
                          kv_mask: Optional[torch.Tensor] = None,
                          denom_eps: float = 1e-6,
                          custom_grad: bool = True) -> torch.Tensor:
    """Causal hybrid on normalized q, k through the chunked scan, in q's
    dtype; w_eff = 0 is `fastmax_causal_chunked` with the same arguments.
    `custom_grad` (and no mask) pairs it with the §2.5 backward; otherwise
    autograd differentiates the plain scan."""
    if effective_window(window, min(chunk_size, q.shape[2])) == 0:
        return fastmax_causal_chunked(q, k, v, p=p, chunk_size=chunk_size,
                                      kv_mask=kv_mask, denom_eps=denom_eps,
                                      custom_grad=custom_grad)
    if custom_grad and kv_mask is None:
        o = _HybridScanCG.apply(q, k, v, p, window, chunk_size, denom_eps)
    else:
        o, _ = _hybrid_scan(q, k, v, p=p, window=window,
                            chunk_size=chunk_size, kv_mask=kv_mask,
                            denom_eps=denom_eps)
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# Rolling window of the decode state
# ---------------------------------------------------------------------------


def roll_window(wk, wv, wm, k, v, m, W: int):
    """The last W VALID tokens of the carried window (wk, wv, wm; None for
    a fresh state) followed by this call's (k, v, validity m), right-
    aligned: row W-1 is the most recent valid token, unfilled rows have
    mask 0. Computed, as in the reference, as a one-hot contraction by
    each valid token's rank from the end. Returns (k [B,H,W,D],
    v [B,H,W,Dv], mask [B,H,W] float32)."""
    if wk is None:
        ck, cv, cm = k, v, m
    else:
        ck = torch.cat([wk.to(k.dtype), k], dim=2)
        cv = torch.cat([wv.to(v.dtype), v], dim=2)
        cm = torch.cat([wm.to(m.dtype), m], dim=2)
    # rank over valid entries counted from the end (1 = most recent);
    # invalid entries get rank 0 and go to the dropped row W
    r = (torch.flip(torch.cumsum(torch.flip(cm, (-1,)), dim=-1), (-1,))
         * cm).to(torch.int64)
    dest = torch.where((r >= 1) & (r <= W), W - r, torch.full_like(r, W))
    oh = dest[..., None] == torch.arange(W, device=dest.device)
    nk = torch.einsum("bhtw,bhtd->bhwd", oh.to(ck.dtype), ck)
    nv = torch.einsum("bhtw,bhtd->bhwd", oh.to(cv.dtype), cv)
    nm = oh.to(torch.float32).sum(dim=2)
    return nk, nv, nm
