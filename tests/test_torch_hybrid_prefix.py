"""The hybrid kernel's two-launch design, modelled in plain torch (float64)
and held against the Pallas kernel (interpret mode); and the serving route
of a fresh hybrid prefill through the kernel op.

`csrc/fastmax_causal.cu` computes the hybrid forward as the causal
prefill's two launches over segments of the tokens: launch A, the
prefill's own, writes the moment carry before every chunk of L keys (the
band holds no carry), and launch B with the band combines each chunk's
queries. A chunk [t0, t0 + len) with t0 >= w_eff takes its slot, weighs
its own band pairs exp(s) and the other causal pairs f(s), and adds
(exp(s) - f(s)) for the keys in [t0 - w_eff + 1, t0) within w_eff of the
query, read by absolute position (possibly from an earlier segment). A
chunk whose band reaches token 0 (t0 < w_eff) takes no slot and sums every
key from token 0 pair by pair: exp in the band, f outside it. Those chunks
lie in the first segment (the wrapper raises otherwise). The model below
follows that index math; the CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core.ref import normalize_qk as jnormalize  # noqa: E402
from repro.kernels.hybrid_causal import hybrid_causal_pallas  # noqa: E402
from repro_torch import attention as TA  # noqa: E402
from repro_torch.attention import state as TS  # noqa: E402
from repro_torch.core.hybrid import hybrid_attention_ref  # noqa: E402
from repro_torch.kernels import hybrid_causal as _hc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.fastmax_causal import feature_rows  # noqa: E402
from repro_torch.kernels.hybrid_causal import band_width  # noqa: E402
from torch_threads import share_cores  # noqa: F401,E402

TOL = 1e-10
F64 = torch.float64


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float64).copy())


def _rows(d, p):
    """The kernel's feature rows as (a, b): (-1, -1) the constant, (a, -1)
    the linear rows, then the pairs a <= b in row-major order."""
    rows = [(-1, -1)] + [(a, -1) for a in range(d)]
    if p >= 2:
        rows += [(a, b) for a in range(d) for b in range(a, d)]
    return rows


def _features(x, rows):
    """x [..., D] -> its feature rows [..., R]."""
    one = torch.ones_like(x[..., 0])
    return torch.stack([one if a < 0 else (x[..., a] if b < 0
                                           else x[..., a] * x[..., b])
                        for a, b in rows], dim=-1)


def band_model(q, k, v, w, p, chunk, w_eff, segment=None, eps=1e-6):
    """Plain model of the hybrid kernel's call: launch A and the band
    combine over segments of `segment` tokens (a multiple of `chunk`; all
    N without), each launch A seeded with the last segment's carry.
    Returns (o, state) as the kernel gives."""
    b, hq, n, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    g = hq // hkv
    segment = segment or n
    if min(w_eff, n) > min(segment, n):
        raise ValueError("the slotless chunks must lie in the first segment")
    rows = _rows(d, p)
    assert len(rows) == feature_rows(d, p)
    weight = torch.tensor([0.5 if a >= 0 and a == c else 1.0
                           for a, c in rows], dtype=F64)
    fk = _features(k, rows) * w[..., None]                 # [B,Hkv,N,R]
    va = torch.cat([v, torch.ones_like(v[..., :1])], -1)   # [B,Hkv,N,Dv+1]
    qg = q.reshape(b, hkv, g, n, d)
    o = torch.empty(b, hkv, g, n, dv, dtype=F64)
    table = torch.zeros(b, hkv, len(rows), dv + 1, dtype=F64)
    for t_begin in range(0, n, segment):
        t_end = min(n, t_begin + segment)
        starts = range(t_begin, t_end, chunk)
        # launch A: the carry before each chunk of the segment (seeded
        # with the last segment's final carry, symmetric: no init_state)
        slots = []
        for t0 in starts:
            slots.append(table)
            sl = slice(t0, min(t_end, t0 + chunk))
            table = table + torch.einsum("bhtr,bhtv->bhrv", fk[:, :, sl],
                                         va[:, :, sl])
        # launch B with the band
        for slot, t0 in zip(slots, starts):
            t1 = min(t_end, t0 + chunk)
            qc = qg[:, :, :, t0:t1]
            slot_on = t0 >= w_eff
            num = torch.zeros(b, hkv, g, t1 - t0, dv, dtype=F64)
            den = torch.zeros(b, hkv, g, t1 - t0, dtype=F64)
            if slot_on:
                nd = torch.einsum("bhgir,bhrv->bhgiv",
                                  _features(qc, rows) * weight, slot)
                num, den = num + nd[..., :dv], den + nd[..., dv]
            # keys [lo, t1): the band's before the chunk, then the chunk's
            lo = t0 - w_eff + 1 if slot_on else 0
            s = torch.einsum("bhgia,bhja->bhgij", qc, k[:, :, lo:t1])
            fs = 1 + s + (s * s / 2 if p >= 2 else 0)
            i = torch.arange(t0, t1)[:, None]
            j = torch.arange(lo, t1)[None, :]
            band = (i - j >= 0) & (i - j < w_eff)
            ex = torch.exp(torch.where(band, s, 0.0))
            inner = torch.where(band, ex, torch.where(i >= j, fs, 0.0))
            outer = torch.where(band, ex - fs, 0.0) if slot_on else inner
            wgt = torch.where(j >= t0, inner, outer)
            wgt = wgt * w[:, :, None, None, lo:t1]
            num = num + torch.einsum("bhgij,bhjv->bhgiv", wgt,
                                     v[:, :, lo:t1])
            den = den + wgt.sum(-1)
            o[:, :, :, t0:t1] = num / (den + eps)[..., None]
    # the final table in the state layout (m-major; both halves of a pair)
    m2 = torch.zeros(b, hkv, d, d, dv, dtype=F64)
    g2 = torch.zeros(b, hkv, d, d, dtype=F64)
    for r, (a, c) in enumerate(rows):
        if c >= 0:
            m2[:, :, a, c] = m2[:, :, c, a] = table[:, :, r, :dv]
            g2[:, :, a, c] = g2[:, :, c, a] = table[:, :, r, dv]
    state = (table[:, :, 0, :dv], table[:, :, 1:d + 1, :dv], m2,
             table[:, :, 0, dv], table[:, :, 1:d + 1, dv], g2)
    return o.reshape(b, hq, n, dv), state


def _inputs(rng, b, g, hkv, n, d, dv):
    q = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hkv * g, n,
                                                            d)))))
    k = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hkv, n, d)))))
    v = rng.normal(size=(b, hkv, n, dv))
    return q, k, v


def _check(q, k, v, mask, p, window, cs, chunk, segment, oracle=False):
    """The model at (chunk, segment) against Pallas at (window, cs): o and
    the six moments within TOL. With `oracle`, o is held to the dense
    `hybrid_attention_ref` within TOL and to Pallas within TOL plus
    Pallas's own distance from that oracle (see the wider-heads test)."""
    b, _, n, _ = q.shape
    hkv = k.shape[1]
    jo, jst = hybrid_causal_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        p=p, window=window, chunk_size=cs, return_state=True,
        interpret=True)
    jo = np.asarray(jo)
    w = _t(np.broadcast_to(mask, (b, hkv, n)))
    w_eff = band_width(window, cs, n)
    to, tst = band_model(_t(q), _t(k), _t(v), w, p, chunk, w_eff, segment)
    tol = TOL
    if oracle:
        want = hybrid_attention_ref(_t(q), _t(k), _t(v), p=p, window=w_eff,
                                    kv_mask=w, normalize=False).numpy()
        np.testing.assert_allclose(to.numpy(), want, rtol=0, atol=TOL)
        tol = TOL + np.abs(jo - want).max()
    np.testing.assert_allclose(to.numpy(), jo, rtol=0 if oracle else TOL,
                               atol=tol)
    for a, t in zip(jst, tst):
        assert tuple(a.shape) == tuple(t.shape)
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=TOL,
                                   atol=TOL)


# (N, L, window, chunk_size, segment) with w_eff = band_width: below L
# (ragged N), equal to L over three segments, above L and above 2L over
# three segments (their slotless chunks all in the first), one token
# (w_eff 8 > N), N below L (every key in the band), and a band shorter
# than a one-chunk segment reaching back into the previous segment
CASES = [(45, 8, 5, 16, None), (45, 8, 8, 8, 16), (45, 8, 12, 16, 16),
         (61, 8, 20, 32, 24), (1, 8, 64, 512, None), (20, 32, 64, 64, None),
         (40, 8, 3, 8, 8)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("p", [1, 2])
def test_band_model_matches_pallas(p, g, case, masked):
    n, chunk, window, cs, segment = case
    rng = np.random.default_rng(1000 * p + 100 * g + n + window + masked)
    b, hkv, d, dv = 2, 2, 8, 12
    q, k, v = _inputs(rng, b, g, hkv, n, d, dv)
    mask = ((rng.random(size=(b, 1, n)) > 0.3).astype(np.float64) if masked
            else np.ones((b, 1, n)))
    _check(q, k, v, mask, p, window, cs, chunk, segment)


@pytest.mark.parametrize("d", [16, 32])
def test_band_model_matches_pallas_wider_heads(d):
    """The pair rows' order at wider heads, with a band over two chunks
    of L and two segments. Scores reach |s| ~ D/2 here, so exp(s) reaches
    ~2e7 at D = 32, and the Pallas kernel's o, which sums the band's f and
    (exp - f) as separate blocks, carries float64 rounding of that size:
    6.9e-10 off the dense oracle at D = 32, where the model's pair-by-pair
    sum is 2.2e-11 off. So o is held to the oracle (TOL), and to Pallas
    within TOL plus Pallas's own error; the moments to Pallas (TOL)."""
    rng = np.random.default_rng(d)
    b, g, hkv, n = 1, 2, 1, 70
    q, k, v = _inputs(rng, b, g, hkv, n, d, d)
    _check(q, k, v, np.ones((b, 1, n)), 2, 20, 32, 8, 40, oracle=True)


def test_band_model_needs_the_slotless_chunks_in_the_first_segment():
    """The wrapper's rule, in the model: a band longer than the first
    segment raises; as long as it, it runs."""
    q = torch.zeros(1, 1, 40, 4, dtype=F64)
    v = torch.zeros(1, 1, 40, 4, dtype=F64)
    w = torch.ones(1, 1, 40, dtype=F64)
    with pytest.raises(ValueError, match="first segment"):
        band_model(q, q, v, w, 2, 8, 17, 16)
    o, _ = band_model(q, q, v, w, 2, 8, 16, 16)
    assert bool(torch.isfinite(o).all())


# ---------------------------------------------------------------------------
# the serving route: a fresh hybrid prefill on hybrid-kernel goes through
# `ops.hybrid_prefill_kernel` (on CPU tensors the kernel's plain version)
# ---------------------------------------------------------------------------


def _spec(impl, p):
    return TA.AttentionSpec(family="hybrid", impl=impl, p=p, window=6,
                            chunk_size=8)


def _fresh(spec, b, hkv, d, dtype):
    return TS.init_state(spec, batch=b, n_kv_heads=hkv, q_head_dim=d,
                         v_head_dim=d, max_len=64, dtype=dtype, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("p", [1, 2])
def test_fresh_hybrid_prefill_takes_the_kernel_op(monkeypatch, p, masked,
                                                  dtype):
    """On hybrid-kernel a prefill without `offset` calls the hybrid
    kernel's op once (here its plain version) and launches nothing; its
    o, moments and window equal bit for bit the plain scan's, the route
    hybrid-chunked (and before, hybrid-kernel) takes."""
    b, hq, hkv, n, d = 2, 4, 2, 21, 8
    gen = torch.Generator().manual_seed(7 * p + masked)
    q, k, v = (torch.randn(b, h, n, d, generator=gen, dtype=dtype)
               for h in (hq, hkv, hkv))
    mask = None
    if masked:
        mask = torch.ones(b, n)
        mask[1, -5:] = 0.0
    calls = []
    real = _hc.hybrid_causal_ref

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(_hc, "hybrid_causal_ref", spy)
    ops.reset_launch_counts()
    spec = _spec("kernel", p)
    o, st = TS.prefill(q, k, v, spec, state=_fresh(spec, b, hkv, d, dtype),
                       kv_mask=mask)
    assert len(calls) == 1 and calls[0]["return_state"]
    assert not any(ops.launch_counts().values())
    plain = _spec("chunked", p)
    po, pst = TS.prefill(q, k, v, plain,
                         state=_fresh(plain, b, hkv, d, dtype), kv_mask=mask)
    assert len(calls) == 1
    assert o.dtype == dtype and torch.equal(o, po)
    for a, want in zip(st.moments, pst.moments):
        assert torch.equal(a, want)
    for name in ("k", "v", "mask", "length"):
        assert torch.equal(getattr(st.kv, name), getattr(pst.kv, name))


def test_offset_hybrid_prefill_stays_on_the_plain_scan(monkeypatch):
    """A resumed (`offset`) hybrid prefill on hybrid-kernel seeds the plain
    scan with the carried moments and window, as the reference does: the
    kernel op is not called."""
    b, hq, hkv, n, d, cut = 1, 4, 2, 24, 8, 13
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(b, h, n, d, generator=gen, dtype=F64)
               for h in (hq, hkv, hkv))
    spec = _spec("kernel", 2)
    st = TS.prefill(q[:, :, :cut], k[:, :, :cut], v[:, :, :cut], spec,
                    state=_fresh(spec, b, hkv, d, F64))[1]

    def refuse(*a, **kw):
        raise AssertionError("a resumed prefill reached the kernel op")

    scans = []
    real = TS._hybrid_scan

    def spy(*a, **kw):
        scans.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "hybrid_prefill_kernel", refuse)
    monkeypatch.setattr(TS, "_hybrid_scan", spy)
    TS.prefill(q[:, :, cut:], k[:, :, cut:], v[:, :, cut:], spec, state=st,
               offset=cut)
    assert len(scans) == 1
    assert scans[0]["init"] is not None and scans[0]["init_win"] is not None
