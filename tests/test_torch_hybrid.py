"""Port parity of the hybrid near/far-field operator and its two-leg
decode state: the port's dense oracle, chunked scan, plain version of the
CUDA hybrid kernel (o and the emitted carry), band-extended §2.5 backward,
trainable `ops.hybrid`, backends, `roll_window` and decode protocol
against the JAX package in float64 at 1e-10 (the Pallas kernel in
interpret mode, as tests/test_hybrid.py runs it); the window edges; and
the unshifted exponential, which overflows float32 in both packages on the
same input. The CUDA kernel itself is held against its plain version on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import attention as JA  # noqa: E402
from repro.attention import state as JS  # noqa: E402
from repro.core import hybrid as JH  # noqa: E402
from repro.core.ref import normalize_qk as jnormalize  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.hybrid_causal import hybrid_causal_pallas  # noqa: E402
from repro_torch import attention as TA  # noqa: E402
from repro_torch.attention import state as TS  # noqa: E402
from repro_torch.core import hybrid as TH  # noqa: E402
from repro_torch.core.fastmax import Moments, fastmax_causal_chunked  # noqa: E402,E501
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.fastmax_causal import fastmax_causal_ref  # noqa: E402
from repro_torch.kernels.hybrid_causal import (  # noqa: E402
    band_width, hybrid_causal_cuda, hybrid_causal_ref)
from torch_threads import share_cores  # noqa: F401,E402

TOL = 1e-10
# (B, Hq, Hkv, N, D, Dv): MHA and GQA, as tests/test_hybrid.py
SHAPES = [(1, 2, 2, 33, 8, 8), (2, 4, 2, 29, 8, 8)]


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _close(a, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), t.detach().numpy(), rtol=tol,
                               atol=tol)


def _inputs(seed, b, hq, hkv, n, d, dv, masked=False):
    """Normalized q̂, k̂ (by the reference's function), v, and a mask with
    about a fifth of the keys off, as float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    q = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hq, n, d)))))
    k = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hkv, n, d)))))
    v = rng.normal(size=(b, hkv, n, dv))
    mask = ((rng.random(size=(b, hkv, n)) > 0.2).astype(np.float64)
            if masked else None)
    return q, k, v, mask


def _both(*xs):
    return ([None if x is None else jnp.asarray(x) for x in xs],
            [None if x is None else _t(x) for x in xs])


# ---------------------------------------------------------------------------
# the operator: oracle, scan, plain kernel version, backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("window", [1, 5, 16])
def test_attention_ref_matches_jax(window, masked):
    """Raw q, k (the oracle normalizes them), with and without a mask."""
    rng = np.random.default_rng(window)
    q, k, v = (rng.normal(size=s) for s in ((2, 4, 29, 8), (2, 2, 29, 8),
                                            (2, 2, 29, 8)))
    mask = (rng.random(size=(2, 2, 29)) > 0.2) * 1.0 if masked else None
    (jq, jk, jv, jm), (tq, tk, tv, tm) = _both(q, k, v, mask)
    _close(JH.hybrid_attention_ref(jq, jk, jv, window=window, kv_mask=jm),
           TH.hybrid_attention_ref(tq, tk, tv, window=window, kv_mask=tm))


@pytest.mark.parametrize("window", [1, 5, 16])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_scan_matches_jax(shape, window):
    """`_hybrid_scan` (o and the final moments) and the public
    `hybrid_causal_chunked` at chunk 16."""
    q, k, v, _ = _inputs(window + shape[3], *shape)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    kw = dict(p=2, window=window, chunk_size=16, kv_mask=None,
              denom_eps=1e-6)
    jo, jmom = JH._hybrid_scan(jq, jk, jv, **kw)
    to, tmom = TH._hybrid_scan(tq, tk, tv, **kw)
    _close(jo, to)
    for a, t in zip(jmom, tmom):
        _close(a, t)
    _close(JH.hybrid_causal_chunked(jq, jk, jv, window=window, chunk_size=16),
           TH.hybrid_causal_chunked(tq, tk, tv, window=window,
                                    chunk_size=16))


def test_window_clamped_to_chunk_matches_jax_and_the_clamped_oracle():
    """window 16 at chunk 8 realizes w_eff = 8."""
    q, k, v, _ = _inputs(41, 1, 2, 2, 33, 8, 8)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    to = TH.hybrid_causal_chunked(tq, tk, tv, window=16, chunk_size=8)
    _close(JH.hybrid_causal_chunked(jq, jk, jv, window=16, chunk_size=8), to)
    _close(JH.hybrid_attention_ref(jq, jk, jv, window=8, normalize=False), to)


@pytest.mark.parametrize("p", [1, 2])
def test_scan_with_a_mask_matches_jax(p):
    q, k, v, mask = _inputs(7 + p, 2, 4, 2, 29, 8, 8, masked=True)
    (jq, jk, jv, jm), (tq, tk, tv, tm) = _both(q, k, v, mask)
    _close(JH.hybrid_causal_chunked(jq, jk, jv, p=p, window=6, chunk_size=8,
                                    kv_mask=jm),
           TH.hybrid_causal_chunked(tq, tk, tv, p=p, window=6, chunk_size=8,
                                    kv_mask=tm))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("window", [1, 5, 16])
def test_plain_kernel_version_matches_pallas(window, p, masked):
    """`hybrid_causal_ref` against `hybrid_causal_pallas` in interpret
    mode: o and all six moments of the emitted carry."""
    q, k, v, mask = _inputs(10 * window + p, 1, 4, 2, 29, 8, 8,
                            masked=masked)
    (jq, jk, jv, jm), (tq, tk, tv, tm) = _both(q, k, v, mask)
    jo, jst = hybrid_causal_pallas(jq, jk, jv, jm, p=p, window=window,
                                   chunk_size=16, return_state=True,
                                   interpret=True)
    to, tst = hybrid_causal_ref(tq, tk, tv, tm, p=p, window=window,
                                chunk_size=16, return_state=True)
    _close(jo, to)
    assert len(tst) == 6
    for a, t in zip(jst, tst):
        assert tuple(a.shape) == tuple(t.shape)
        _close(a, t)


def test_plain_kernel_version_band_over_several_chunks():
    """window 20 at chunk_size 32 on N = 70: the band crosses two chunk
    boundaries, and the plain version equals the dense oracle."""
    q, k, v, _ = _inputs(3, 1, 2, 1, 70, 8, 8)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    assert band_width(20, 32, 70) == 20
    _close(JH.hybrid_attention_ref(jq, jk, jv, window=20, normalize=False),
           hybrid_causal_ref(tq, tk, tv, window=20, chunk_size=32))


@pytest.mark.parametrize("p", [1, 2])
def test_bwd_scan_matches_jax(p):
    """`hybrid_bwd_scan` on the scan's final carry, and the trainable
    chunked scan's grads against JAX's."""
    q, k, v, _ = _inputs(20 + p, 2, 4, 2, 29, 8, 8)
    do = np.random.default_rng(p).normal(size=(2, 4, 29, 8))
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(q, k, v, do)
    kw = dict(p=p, window=7, chunk_size=8, denom_eps=1e-6)
    _, jfin = JH._hybrid_scan(jq, jk, jv, kv_mask=None, **kw)
    _, tfin = TH._hybrid_scan(tq, tk, tv, kv_mask=None, **kw)
    jg = JH.hybrid_bwd_scan(jq, jk, jv, jfin, jdo, **kw)
    tg = TH.hybrid_bwd_scan(tq, tk, tv, tfin, tdo, **kw)
    for a, t in zip(jg, tg):
        _close(a, t)
    jg2 = jax.grad(lambda q_, k_, v_: jnp.sum(JH.hybrid_causal_chunked(
        q_, k_, v_, p=p, window=7, chunk_size=8) * jdo),
        argnums=(0, 1, 2))(jq, jk, jv)
    prim = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    tg2 = torch.autograd.grad(TH.hybrid_causal_chunked(
        *prim, p=p, window=7, chunk_size=8), prim, tdo)
    for a, t in zip(jg2, tg2):
        _close(a, t)


@pytest.mark.parametrize("p", [1, 2])
def test_ops_hybrid_grads_match_jax(p):
    """The trainable op on CPU tensors (the kernel's plain version forward,
    the band-extended §2.5 backward on its emitted carry) against JAX's
    `ops.hybrid` (Pallas forward in interpret mode): o and grads."""
    q, k, v, _ = _inputs(30 + p, 1, 4, 2, 29, 8, 8)
    do = np.random.default_rng(6).normal(size=(1, 4, 29, 8))
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(q, k, v, do)

    def jloss(q_, k_, v_):
        return jnp.sum(jops.hybrid(q_, k_, v_, p=p, window=7, chunk_size=8,
                                   interpret=True) * jdo)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    prim = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    ops.reset_launch_counts()
    to = ops.hybrid(*prim, p=p, window=7, chunk_size=8)
    tg = torch.autograd.grad(to, prim, tdo)
    assert not any(ops.launch_counts().values())
    _close(jops.hybrid(jq, jk, jv, p=p, window=7, chunk_size=8,
                       interpret=True), to)
    for a, t in zip(jg, tg):
        _close(a, t)


def test_bwd_rounds_bf16_grads_once_and_refuses_inference_mode():
    """bf16 inputs are widened once and each grad rounded once (the same
    bits as the float32 computation rounded at the end); under
    inference mode the backward raises instead of returning zeros."""
    q, k, v, _ = _inputs(5, 1, 4, 2, 40, 8, 8)
    do = np.random.default_rng(1).normal(size=(1, 4, 40, 8))
    x16 = [_t(x).to(torch.bfloat16) for x in (q, k, v, do)]
    kw = dict(p=2, window=6, chunk_size=16, denom_eps=1e-6)
    _, fin = TH._hybrid_scan(*[x.float() for x in x16[:3]], kv_mask=None,
                             **kw)
    got = TH.hybrid_bwd_scan(*x16[:3], fin, x16[3], **kw)
    want = TH.hybrid_bwd_scan(*[x.float() for x in x16[:3]], fin,
                              x16[3].float(), **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))
    with torch.inference_mode(), pytest.raises(RuntimeError,
                                               match="inference_mode"):
        TH.hybrid_bwd_scan(*x16[:3], fin, x16[3], **kw)


# ---------------------------------------------------------------------------
# window edges
# ---------------------------------------------------------------------------


def test_window_zero_is_bitwise_fastmax():
    """w_eff = 0 is the fastmax path itself: the scan, the trainable op
    (forward and grads) and the plain kernel version."""
    q, k, v, _ = _inputs(7, 1, 4, 2, 33, 8, 8)
    tq, tk, tv = (_t(x).float() for x in (q, k, v))
    assert torch.equal(
        TH.hybrid_causal_chunked(tq, tk, tv, window=0, chunk_size=8),
        fastmax_causal_chunked(tq, tk, tv, p=2, chunk_size=8))
    assert TH.effective_window(5, 0) == 0
    prim = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    do = torch.randn(1, 4, 33, 8, generator=torch.Generator().manual_seed(0))
    a = ops.hybrid(*prim, window=0, chunk_size=8)
    b = ops.fastmax(*prim, chunk_size=8)
    assert torch.equal(a, b)
    for x, y in zip(torch.autograd.grad(a, prim, do),
                    torch.autograd.grad(b, prim, do)):
        assert torch.equal(x, y)
    ho, hst = hybrid_causal_ref(tq, tk, tv, window=0, chunk_size=8,
                                return_state=True)
    fo, fst = fastmax_causal_ref(tq, tk, tv, chunk_size=8)
    assert torch.equal(ho, fo)
    for x, y in zip(hst, fst):
        assert torch.equal(x, y)


def test_window_covers_sequence_is_exact_softmax():
    """w_eff >= N leaves no far-field token: softmax over q̂·k̂ (scale 1)."""
    n = 24
    q, k, v, _ = _inputs(8, 1, 2, 2, n, 8, 8)
    tq, tk, tv = _t(q), _t(k), _t(v)
    s = torch.einsum("bhnd,bhmd->bhnm", tq, tk)
    s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(),
                      float("-inf"))
    ref = torch.softmax(s, dim=-1) @ tv
    out = TH.hybrid_causal_chunked(tq, tk, tv, window=n, chunk_size=n,
                                   denom_eps=0.0)
    torch.testing.assert_close(out, ref, rtol=1e-12, atol=1e-12)


def test_effective_window_band_width_and_names():
    assert TH.effective_window(64, 16) == JH.effective_window(64, 16) == 16
    assert TH.effective_window(5, 16) == 5
    assert TH.effective_window(-3, 16) == 0
    assert TH.effective_window(0, 16) == 0
    # the kernel's rule: the chunk is at least 8 tokens, even for N < 8
    assert band_width(64, 512, 1024) == 64
    assert band_width(64, 512, 3) == 8
    assert band_width(200, 128, 1024) == 128
    s = TA.AttentionSpec.parse("hybrid2-kernel")
    assert (s.family, s.p, s.impl, s.window) == ("hybrid", 2, "kernel", 64)
    assert str(s) == str(JA.AttentionSpec.parse("hybrid2-kernel")) \
        == "hybrid2/kernel/w64"
    assert TA.AttentionSpec.parse("hybrid1-chunked").p == 1
    assert TA.AttentionSpec.parse("hybrid").family == "hybrid"
    with pytest.raises(ValueError):
        TA.AttentionSpec.parse("hybrid2-rowwise")
    with pytest.raises(ValueError, match="window"):
        TA.AttentionSpec(family="hybrid", window=-1)


# ---------------------------------------------------------------------------
# backends and the dispatcher
# ---------------------------------------------------------------------------


def test_hybrid_backends_declare_capabilities_and_raise():
    ch, ke = TA.get_backend("hybrid-chunked"), TA.get_backend("hybrid-kernel")
    assert TA.resolve(TA.AttentionSpec.parse("hybrid2-kernel")) is ke
    assert TA.resolve(TA.AttentionSpec.parse("hybrid2")) is ch
    assert ch.caps.decode and ke.caps.decode
    assert not ch.caps.decode_kernel and not ke.caps.decode_kernel
    q = torch.randn(1, 2, 8, 8)
    for name in ("hybrid2-chunked", "hybrid2-kernel"):
        with pytest.raises(ValueError, match="causal-only"):
            TA.attention(q, q, q, TA.AttentionSpec.parse(name), causal=False)
    with pytest.raises(ValueError, match="hybrid2-chunked"):
        TA.attention(q, q, q, TA.AttentionSpec.parse("hybrid2-kernel"),
                     causal=True, kv_mask=torch.ones(1, 2, 8))
    with pytest.raises(ValueError, match="causal-only"):
        ops.hybrid(q, q, q, causal=False)
    with pytest.raises(ValueError, match="CUDA"):
        hybrid_causal_cuda(q, q, q, window=4)


@pytest.mark.parametrize("impl, masked", [("chunked", False),
                                           ("chunked", True),
                                           ("kernel", False)])
def test_dispatcher_matches_jax(impl, masked):
    """attention() on raw q, k (the backend normalizes): forward and grads
    against the JAX dispatcher; a mask only on the chunked backend (the
    kernel backend refuses one, above)."""
    rng = np.random.default_rng(hash(impl) % 2**31)
    q, k, v, do = (rng.normal(size=s) for s in (
        (2, 4, 29, 8), (2, 2, 29, 8), (2, 2, 29, 8), (2, 4, 29, 8)))
    mask = (rng.random(size=(2, 2, 29)) > 0.2) * 1.0 if masked else None
    (jq, jk, jv, jm, jdo), (tq, tk, tv, tm, tdo) = _both(q, k, v, mask, do)
    jspec = JA.AttentionSpec(family="hybrid", impl=impl, window=9,
                             chunk_size=16)
    tspec = TA.AttentionSpec(family="hybrid", impl=impl, window=9,
                             chunk_size=16)
    jg = jax.grad(lambda q_, k_, v_: jnp.sum(JA.attention(
        q_, k_, v_, jspec, causal=True, kv_mask=jm) * jdo),
        argnums=(0, 1, 2))(jq, jk, jv)
    prim = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    to = TA.attention(*prim, tspec, causal=True, kv_mask=tm)
    tg = torch.autograd.grad(to, prim, tdo)
    _close(JA.attention(jq, jk, jv, jspec, causal=True, kv_mask=jm), to)
    for a, t in zip(jg, tg):
        _close(a, t)


# ---------------------------------------------------------------------------
# the two-leg decode state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fresh", [True, False])
def test_roll_window_matches_jax(fresh):
    rng = np.random.default_rng(int(fresh))
    b, h, t, d, w = 2, 2, 11, 4, 6
    k, v = rng.normal(size=(b, h, t, d)), rng.normal(size=(b, h, t, d))
    m = (rng.random(size=(b, h, t)) > 0.3) * 1.0
    carried = (None, None, None) if fresh else (
        rng.normal(size=(b, h, w, d)), rng.normal(size=(b, h, w, d)),
        (rng.random(size=(b, h, w)) > 0.5) * 1.0)
    (jw, jv_, jm, jk, jvv, jmm), (tw, tv_, tm, tk, tvv, tmm) = _both(
        *carried, k, v, m)
    jout = JH.roll_window(jw, jv_, jm, jk, jvv, jmm, w)
    tout = TH.roll_window(tw, tv_, tm, tk, tvv, tmm, w)
    for a, b_ in zip(jout, tout):
        _close(a, b_)


def _state_pair(window, b, hkv, d, impl="kernel"):
    jspec = JA.AttentionSpec(family="hybrid", impl=impl, window=window,
                             chunk_size=8)
    tspec = TA.AttentionSpec(family="hybrid", impl=impl, window=window,
                             chunk_size=8)
    kw = dict(batch=b, n_kv_heads=hkv, q_head_dim=d, v_head_dim=d,
              max_len=64)
    return (jspec, tspec, JS.init_state(jspec, dtype=jnp.float64, **kw),
            TS.init_state(tspec, dtype=torch.float64, device="cpu", **kw))


@pytest.mark.parametrize("window", [0, 4, 64], ids=["w0", "w4", "wfull"])
def test_prefill_then_step_lockstep_with_jax(window):
    """prefill(prompt) then decode steps, the port against the JAX
    protocol (outputs, moments, window) and against its own one-shot
    forward."""
    b, hq, hkv, n, d, pre = 2, 4, 2, 21, 8, 13
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=(b, h, n, d)) for h in (hq, hkv, hkv))
    jspec, tspec, js, ts = _state_pair(window, b, hkv, d)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    full = TA.attention(tq, tk, tv, tspec, causal=True)
    jo, js = JS.prefill(jq[:, :, :pre], jk[:, :, :pre], jv[:, :, :pre],
                        jspec, state=js)
    to, ts = TS.prefill(tq[:, :, :pre], tk[:, :, :pre], tv[:, :, :pre],
                        tspec, state=ts)
    _close(jo, to)
    _close(full[:, :, :pre].numpy(), to)
    for t in range(pre, n):
        sl = slice(t, t + 1)
        jo, js = JS.step(js, jq[:, :, sl], jk[:, :, sl], jv[:, :, sl], jspec)
        to, ts = TS.step(ts, tq[:, :, sl], tk[:, :, sl], tv[:, :, sl], tspec)
        _close(jo, to)
        _close(full[:, :, sl].numpy(), to)
    for a, t in zip(js.moments, ts.moments):
        _close(a, t)
    if window:
        for name in ("k", "v", "mask", "length"):
            _close(getattr(js.kv, name), getattr(ts.kv, name))


def test_offset_prefill_matches_whole_and_jax():
    """A prompt prefilled in two pieces (the second with `offset`) with
    trailing padding (as a serving batch has; the window keeps the last
    VALID tokens, so an interior mask would move band distances across
    the cut, in the reference as here): the carried moments AND window
    seed the scan, so the outputs, moments and window equal one
    whole-prompt prefill's and JAX's."""
    b, hq, hkv, n, d, cut = 2, 4, 2, 32, 8, 16
    q, k, v, _ = _inputs(13, b, hq, hkv, n, d, d)
    mask = np.ones((b, hkv, n))
    mask[0, :, -5:] = 0.0
    mask[1, :, -9:] = 0.0
    jspec, tspec, js, ts = _state_pair(8, b, hkv, d, impl="chunked")
    whole = TS.init_state(tspec, batch=b, n_kv_heads=hkv, q_head_dim=d,
                          v_head_dim=d, max_len=n, dtype=torch.float64)
    (jq, jk, jv, jm), (tq, tk, tv, tm) = _both(q, k, v, mask)
    wo, _ = TS.prefill(tq, tk, tv, tspec, state=whole, kv_mask=tm)
    outs = []
    for sl, off in ((slice(0, cut), None), (slice(cut, n), cut)):
        jo, js = JS.prefill(jq[:, :, sl], jk[:, :, sl], jv[:, :, sl], jspec,
                            state=js, kv_mask=jm[:, :, sl],
                            offset=None if off is None else jnp.asarray(off))
        to, ts = TS.prefill(tq[:, :, sl], tk[:, :, sl], tv[:, :, sl], tspec,
                            state=ts, kv_mask=tm[:, :, sl], offset=off)
        _close(jo, to)
        outs.append(to)
    torch.testing.assert_close(torch.cat(outs, dim=2), wo, rtol=1e-12,
                               atol=1e-12)
    for a, t, w in zip(js.moments, ts.moments, whole.moments):
        _close(a, t)
        torch.testing.assert_close(t, w, rtol=1e-12, atol=1e-12)
    for name in ("k", "v", "mask", "length"):
        _close(getattr(js.kv, name), getattr(ts.kv, name))
        torch.testing.assert_close(getattr(ts.kv, name),
                                   getattr(whole.kv, name), rtol=1e-12,
                                   atol=1e-12)


def test_window_zero_state_has_no_kv_leg():
    for impl in ("chunked", "kernel"):
        spec = TA.AttentionSpec(family="hybrid", impl=impl, window=0)
        st = TS.init_state(spec, batch=1, n_kv_heads=2, q_head_dim=4,
                           v_head_dim=4, max_len=8)
        assert st.kv is None and st.moments is not None
    spec = TA.AttentionSpec(family="hybrid", window=64, chunk_size=16)
    st = TS.init_state(spec, batch=1, n_kv_heads=2, q_head_dim=4,
                       v_head_dim=4, max_len=8)
    assert st.kv.k.shape == (1, 2, 16, 4) and int(st.kv.length) == 0
    assert not st.kv.mask.any()
    with pytest.raises(ValueError, match="legs"):
        TS.step(TS.AttnState(kv=None, moments=st.moments), *(
            [torch.zeros(1, 2, 1, 4)] * 3), spec)


# ---------------------------------------------------------------------------
# the unshifted exponential (a property of the reference)
# ---------------------------------------------------------------------------


def test_unshifted_exp_overflows_float32_in_both_packages():
    """At D = 128 a key equal to its own query gives ŝ = |q̂|² ≈ 128 on the
    band's diagonal, past float32's exp limit (≈ 88.7): that row is
    non-finite in the JAX scan, the Pallas kernel and the port's scan and
    plain kernel version alike, and every other row is finite. In
    float64 both packages agree."""
    n, d, row = 24, 128, 10
    q, k, v, _ = _inputs(17, 1, 2, 2, n, d, d)
    k = k.copy()
    k[:, :, row] = q[:, :, row]
    assert (q[:, :, row] * k[:, :, row]).sum(-1).min() > 88.8
    kw = dict(p=2, window=8, chunk_size=16)
    for dt, tdt in ((np.float32, torch.float32), (np.float64, torch.float64)):
        jq, jk, jv = (jnp.asarray(x.astype(dt)) for x in (q, k, v))
        tq, tk, tv = (_t(x).to(tdt) for x in (q, k, v))
        outs = [np.asarray(JH.hybrid_causal_chunked(jq, jk, jv, **kw)),
                np.asarray(hybrid_causal_pallas(jq, jk, jv, interpret=True,
                                                **kw)),
                TH.hybrid_causal_chunked(tq, tk, tv, **kw).numpy(),
                hybrid_causal_ref(tq, tk, tv, **kw).numpy()]
        if dt == np.float32:
            for o in outs:
                assert not np.isfinite(o[:, :, row]).any()
                assert np.isfinite(np.delete(o, row, axis=2)).all()
        else:
            for o in outs[1:]:
                np.testing.assert_allclose(o, outs[0], rtol=TOL, atol=TOL)
            assert np.isfinite(outs[0]).all()


def test_decode_state_moments_are_the_accumulator_type():
    spec = TA.AttentionSpec.parse("hybrid2-kernel", chunk_size=16)
    st = TS.init_state(spec, batch=1, n_kv_heads=2, q_head_dim=4,
                       v_head_dim=4, max_len=8, dtype=torch.bfloat16)
    assert all(t.dtype == torch.float32 for t in st.moments)
    assert st.kv.k.dtype == torch.bfloat16 and isinstance(st.moments,
                                                          Moments)


def test_band_only_rows_cancel_in_float32_in_the_reference_only():
    """In the first w_eff rows every key is in the band and no far field
    is left, so the denominator is the sum of exp(ŝ) alone. The reference
    sums the chunk's f_p(ŝ) and the band's (exp(ŝ) - f_p(ŝ)) as separate
    blocks and adds the sums; when the band scores are all very negative
    (keys 0..31 point away from query 31: ŝ from -13 to -56, f_p(ŝ) in
    the hundreds, exp(ŝ) below 1e-5) they cancel in float32, and that row
    is off float64 by more than 1 in the JAX scan and the Pallas kernel.
    The port weighs each in-chunk band pair exp(ŝ) directly (the same
    function), so its scan and plain kernel version hold that row, and
    every row, to float64 within 1e-4, as the reference does past the
    band's reach."""
    n, d, w, row = 96, 128, 32, 31
    rng = np.random.default_rng(0)
    q = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(1, 1, n, d)))))
    k = rng.normal(size=(1, 1, n, d))
    k[:, :, :row + 1] += -0.3 * q[:, :, row:row + 1]
    k = np.asarray(jnormalize(jnp.asarray(k)))
    v = rng.normal(size=(1, 1, n, d))
    assert (q[0, 0, row] @ k[0, 0, :row + 1].T).max() < -10
    kw = dict(p=2, window=w, chunk_size=w)
    o64 = np.asarray(JH.hybrid_causal_chunked(*map(jnp.asarray, (q, k, v)),
                                              **kw))
    x32 = [x.astype(np.float32) for x in (q, k, v)]
    ref = [np.asarray(JH.hybrid_causal_chunked(*map(jnp.asarray, x32),
                                               **kw)),
           np.asarray(hybrid_causal_pallas(*map(jnp.asarray, x32),
                                           interpret=True, **kw))]
    port = [TH.hybrid_causal_chunked(*map(torch.from_numpy, x32),
                                     **kw).numpy(),
            hybrid_causal_ref(*map(torch.from_numpy, x32), **kw).numpy()]
    for o in ref + port:
        err = np.abs(o.astype(np.float64) - o64).max(axis=(0, 1, 3))
        assert err[w:].max() < 1e-4
        if any(o is x for x in ref):
            assert err[row] > 1.0
        else:
            assert err.max() < 1e-4


def test_decode_step_keeps_the_reference_cancelling_form_in_float32():
    """The decode step adds the band's (exp(ŝ) - f_p(ŝ)) on top of moments
    that hold every token, as the reference's step does, so at a position
    with no far field (here the 32nd token under a window of 32, every key
    in the band and pointing away from the query, as in the test above)
    it cancels in float32 in both packages: the step's row is off float64
    by more than 0.5 in JAX and in the port, where the port's prefill of
    the same 32 tokens holds that row within 1e-4 (ROADMAP queue 3)."""
    n, d, w, row = 32, 128, 32, 31
    rng = np.random.default_rng(0)
    q = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(1, 1, n, d)))))
    k = rng.normal(size=(1, 1, n, d))
    k[:, :, :row + 1] += -0.3 * q[:, :, row:row + 1]
    k = np.asarray(jnormalize(jnp.asarray(k)))
    v = rng.normal(size=(1, 1, n, d))
    assert (q[0, 0, row] @ k[0, 0, :row + 1].T).max() < -10
    o64 = np.asarray(JH.hybrid_causal_chunked(
        *map(jnp.asarray, (q, k, v)), p=2, window=w, chunk_size=w))[0, 0, row]
    x32 = [x.astype(np.float32) for x in (q, k, v)]
    (jq, jk, jv), (tq, tk, tv) = (list(map(jnp.asarray, x32)),
                                  list(map(torch.from_numpy, x32)))
    skw = dict(batch=1, n_kv_heads=1, q_head_dim=d, v_head_dim=d,
               max_len=64)
    jspec = JA.AttentionSpec(family="hybrid", impl="chunked", window=w,
                             chunk_size=w, normalize=False)
    tspec = TA.AttentionSpec(family="hybrid", impl="chunked", window=w,
                             chunk_size=w, normalize=False)
    js = JS.init_state(jspec, dtype=jnp.float32, **skw)
    ts = TS.init_state(tspec, dtype=torch.float32, device="cpu", **skw)
    pre, sl = slice(0, row), slice(row, row + 1)
    _, js = JS.prefill(jq[:, :, pre], jk[:, :, pre], jv[:, :, pre], jspec,
                       state=js)
    _, ts = TS.prefill(tq[:, :, pre], tk[:, :, pre], tv[:, :, pre], tspec,
                       state=ts)
    jo, _ = JS.step(js, jq[:, :, sl], jk[:, :, sl], jv[:, :, sl], jspec)
    to, _ = TS.step(ts, tq[:, :, sl], tk[:, :, sl], tv[:, :, sl], tspec)
    whole = TS.init_state(tspec, dtype=torch.float32, device="cpu", **skw)
    po, _ = TS.prefill(tq, tk, tv, tspec, state=whole)
    assert np.abs(np.asarray(jo)[0, 0, 0] - o64).max() > 0.5
    assert np.abs(to.numpy()[0, 0, 0] - o64).max() > 0.5
    assert np.abs(po.numpy()[0, 0, row] - o64).max() < 1e-4
