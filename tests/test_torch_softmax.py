"""Port parity of the softmax leg: `core.softmax.softmax_attention`,
`core.ref.softmax_attention_ref`, the `softmax` backend and the `KVCache`
leg of the decode-state protocol, against the JAX package on the same
numpy inputs; plus `core.decode_state` (`decode_state_bytes`,
`fastmax_prefill`, `fastmax_decode_step`).

The reference's `softmax_attention` computes its scores in float32 whatever
the input dtype (`repro/core/softmax.py`: `.astype(jnp.float32)`); the port
keeps float32 for float32 and bfloat16 inputs and computes float64 inputs
in float64. So the float64 cases run the reference's own code with a
`jnp` whose `float32` is float64 (`_reference_in_float64`; nothing in the
JAX package changes) and hold the port to it at 1e-10, and the float32
cases hold the port to the unmodified reference at float32 tolerance.
"""
import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.core.softmax as JS  # noqa: E402
from repro.attention import AttentionSpec as JSpec  # noqa: E402
from repro.attention import attention as jattention  # noqa: E402
from repro.attention import init_state as jinit_state  # noqa: E402
from repro.attention import prefill as jprefill  # noqa: E402
from repro.attention import step as jstep  # noqa: E402
from repro.core import decode_state as JD  # noqa: E402
from repro.core.ref import softmax_attention_ref as jsoftmax_ref  # noqa: E402
from repro_torch.attention import (AttentionSpec, attention,  # noqa: E402
                                   init_state, prefill, resolve, step)
from repro_torch.core import decode_state as TD  # noqa: E402
from repro_torch.core.ref import softmax_attention_ref  # noqa: E402
from repro_torch.core.softmax import softmax_attention  # noqa: E402
from torch_threads import share_cores  # noqa: F401,E402

TOL64 = 1e-10
TOL32 = 2e-6     # float32 scores summed in another order


class _JnpWithFloat64Scores:
    """`jax.numpy` with `float32` meaning float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def _reference_in_float64(monkeypatch):
    monkeypatch.setattr(JS, "jnp", _JnpWithFloat64Scores())


def mk(rng, b, hq, hkv, n, d, dv, m=None):
    m = n if m is None else m
    return (rng.normal(size=(b, hq, n, d)), rng.normal(size=(b, hkv, m, d)),
            rng.normal(size=(b, hkv, m, dv)))


def _t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


def _mask(rng, b, h, m, p=0.7):
    mask = (rng.random((b, h, m)) < p).astype(np.float64)
    mask[..., 0] = 1.0
    return mask


CASES = [  # (causal, mask heads (0: none), q_offset, N, M)
    (False, 0, 0, 9, 9), (True, 0, 0, 13, 13), (True, 2, 0, 13, 13),
    (False, 1, 0, 7, 11), (True, 2, 5, 6, 11), (True, 0, 10, 1, 11),
]


@pytest.mark.parametrize("causal,mheads,q_offset,n,m", CASES)
def test_softmax_attention_float64(_reference_in_float64, causal, mheads,
                                   q_offset, n, m):
    rng = np.random.default_rng(n * 31 + m + q_offset)
    q, k, v = mk(rng, 2, 4, 2, n, 8, 6, m)
    mask = _mask(rng, 2, mheads, m) if mheads else None
    want = JS.softmax_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                kv_mask=None if mask is None
                                else jnp.asarray(mask), q_offset=q_offset)
    got = softmax_attention(_t(q), _t(k), _t(v), causal=causal,
                            kv_mask=None if mask is None else _t(mask),
                            q_offset=q_offset)
    assert got.dtype == torch.float64
    _close(got, want, TOL64)


@pytest.mark.parametrize("causal,mheads,q_offset,n,m", CASES)
def test_softmax_attention_float32(causal, mheads, q_offset, n, m):
    rng = np.random.default_rng(n * 17 + m + q_offset)
    q, k, v = (x.astype(np.float32) for x in mk(rng, 2, 4, 2, n, 8, 6, m))
    mask = _mask(rng, 2, mheads, m) if mheads else None
    want = JS.softmax_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                kv_mask=None if mask is None
                                else jnp.asarray(mask), q_offset=q_offset)
    got = softmax_attention(_t(q, torch.float32), _t(k, torch.float32),
                            _t(v, torch.float32), causal=causal,
                            kv_mask=None if mask is None else _t(mask),
                            q_offset=q_offset)
    assert got.dtype == torch.float32
    _close(got, want, TOL32)


def test_fully_masked_row_is_the_uniform_average(_reference_in_float64):
    """A query whose keys are all masked averages every key uniformly, as
    the reference's finfo.min masking gives (no NaN)."""
    rng = np.random.default_rng(3)
    q, k, v = mk(rng, 1, 2, 1, 3, 4, 5)
    mask = np.zeros((1, 1, 3))
    got = softmax_attention(_t(q), _t(k), _t(v), kv_mask=_t(mask))
    want = JS.softmax_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), kv_mask=jnp.asarray(mask))
    _close(got, want, TOL64)
    _close(got[0, 0, 0], v[0, 0].mean(axis=0), TOL64)


@pytest.mark.parametrize("causal", [False, True])
def test_softmax_attention_ref(causal):
    rng = np.random.default_rng(4)
    q, k, v = mk(rng, 2, 3, 3, 10, 8, 5)
    want = jsoftmax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal)
    _close(softmax_attention_ref(_t(q), _t(k), _t(v), causal=causal), want,
           TOL64)


@pytest.mark.parametrize("mheads", [0, 1, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_softmax_backend(_reference_in_float64, causal, mheads):
    """The registered `softmax` backend through `attention()`: GQA, a mask
    of 1 or Hkv heads."""
    rng = np.random.default_rng(5 + mheads)
    q, k, v = mk(rng, 2, 4, 2, 12, 8, 8)
    mask = _mask(rng, 2, mheads, 12) if mheads else None
    want = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      JSpec.parse("softmax"), causal=causal,
                      kv_mask=None if mask is None else jnp.asarray(mask))
    got = attention(_t(q), _t(k), _t(v), AttentionSpec.parse("softmax"),
                    causal=causal,
                    kv_mask=None if mask is None else _t(mask))
    _close(got, want, TOL64)
    assert resolve(AttentionSpec.parse("softmax")).caps.decode
    with pytest.raises(ValueError, match="kv_mask heads"):
        attention(_t(q), _t(k), _t(v), AttentionSpec.parse("softmax"),
                  kv_mask=torch.ones(2, 3, 12))


SPEC = AttentionSpec(family="softmax")
JSPEC = JSpec(family="softmax")


def _states(b, hkv, d, nmax, slotted):
    """The port's and the reference's fresh KV caches; `slotted` gives
    both a [B] cursor lane, as a serving pool does."""
    ts = init_state(SPEC, batch=b, n_kv_heads=hkv, q_head_dim=d,
                    v_head_dim=d, max_len=nmax, dtype=torch.float64)
    js = jinit_state(JSPEC, batch=b, n_kv_heads=hkv, q_head_dim=d,
                     v_head_dim=d, max_len=nmax, dtype=jnp.float64)
    if slotted:
        ts = ts._replace(kv=ts.kv._replace(
            length=torch.zeros(b, dtype=torch.int32)))
        js = js._replace(kv=js.kv._replace(length=jnp.zeros(b, jnp.int32)))
    return ts, js


def _check_cache(ts, js):
    for name, a, r in zip(ts.kv._fields, ts.kv, js.kv):
        _close(a.numpy(), np.asarray(r), TOL64 if name != "length" else 0)


@pytest.mark.parametrize("slotted", [False, True], ids=["shared", "slots"])
def test_kv_prefill_then_steps(_reference_in_float64, slotted):
    """Prefill then steps, in place, against the reference's prefill and
    steps, and against full causal attention of the whole sequence."""
    rng = np.random.default_rng(7)
    b, hq, hkv, n, d, pre = 2, 4, 2, 21, 8, 13
    q, k, v = mk(rng, b, hq, hkv, n, d, d)
    ts, js = _states(b, hkv, d, n, slotted)
    cache = ts.kv.k
    o, ts2 = prefill(_t(q[:, :, :pre]), _t(k[:, :, :pre]), _t(v[:, :, :pre]),
                     SPEC, state=ts)
    assert ts2 is ts and ts.kv.k is cache          # written in place
    jo, js = jprefill(jnp.asarray(q[:, :, :pre]), jnp.asarray(k[:, :, :pre]),
                      jnp.asarray(v[:, :, :pre]), JSPEC, state=js)
    _close(o, jo, TOL64)
    _check_cache(ts, js)
    full = softmax_attention_ref(_t(q), _t(k).repeat_interleave(2, 1),
                                 _t(v).repeat_interleave(2, 1), causal=True)
    for t in range(pre, n):
        sl = slice(t, t + 1)
        o, _ = step(ts, _t(q[:, :, sl]), _t(k[:, :, sl]), _t(v[:, :, sl]),
                    SPEC)
        jo, js = jstep(js, jnp.asarray(q[:, :, sl]), jnp.asarray(k[:, :, sl]),
                       jnp.asarray(v[:, :, sl]), JSPEC)
        _close(o, jo, TOL64)
        _close(o[:, :, 0], full[:, :, t], TOL64)
    _check_cache(ts, js)


def test_kv_step_per_sequence_cursors(_reference_in_float64):
    """A [B] cursor lane at different lengths writes one row per sequence
    and marks it valid, as the reference's scatter does."""
    rng = np.random.default_rng(8)
    b, hq, hkv, d, nmax = 3, 4, 2, 8, 12
    ts, js = _states(b, hkv, d, nmax, slotted=True)
    lengths = np.array([0, 5, 9], np.int32)
    kc, vc = rng.normal(size=(2, b, hkv, nmax, d))
    mask = _mask(rng, b, hkv, nmax, 0.8)
    ts.kv.k.copy_(_t(kc))
    ts.kv.v.copy_(_t(vc))
    ts.kv.mask.copy_(_t(mask))
    ts.kv.length.copy_(torch.from_numpy(lengths))
    js = js._replace(kv=js.kv._replace(
        k=jnp.asarray(kc), v=jnp.asarray(vc), mask=jnp.asarray(mask),
        length=jnp.asarray(lengths)))
    for _ in range(3):
        q, k, v = mk(rng, b, hq, hkv, 1, d, d)
        o, _ = step(ts, _t(q), _t(k), _t(v), SPEC)
        jo, js = jstep(js, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       JSPEC)
        _close(o, jo, TOL64)
    _check_cache(ts, js)


@pytest.mark.parametrize("slotted", [False, True], ids=["shared", "slots"])
def test_kv_offset_resume_with_3d_mask_matches_whole(_reference_in_float64,
                                                     slotted):
    """A prompt prefilled in two `offset` chunks with a per-head [B, Hkv, N]
    mask gives the whole prompt's outputs, all against the reference's
    same calls, and the next step agrees with the reference's. With a
    shared cursor it also sees the whole prompt's cache (a [B] cursor
    advances by each chunk's valid tokens, which an interior mask makes
    differ from the whole prompt's, in both packages)."""
    rng = np.random.default_rng(22)
    b, hq, hkv, n, d, c = 2, 4, 2, 32, 8, 16
    q, k, v = mk(rng, b, hq, hkv, n, d, d)
    mask = _mask(rng, b, hkv, n)
    whole, jwhole = _states(b, hkv, d, n + 2, slotted)
    o_full, _ = prefill(_t(q), _t(k), _t(v), SPEC, state=whole,
                        kv_mask=_t(mask))
    ts, js = _states(b, hkv, d, n + 2, slotted)
    outs = []
    for off in (0, c):
        sl = slice(off, off + c)
        o, _ = prefill(_t(q[:, :, sl]), _t(k[:, :, sl]), _t(v[:, :, sl]),
                       SPEC, state=ts, kv_mask=_t(mask[:, :, sl]),
                       offset=off)
        jo, js = jprefill(jnp.asarray(q[:, :, sl]), jnp.asarray(k[:, :, sl]),
                          jnp.asarray(v[:, :, sl]), JSPEC, state=js,
                          kv_mask=jnp.asarray(mask[:, :, sl]),
                          offset=jnp.asarray(off, jnp.int32))
        _close(o, jo, TOL64)
        outs.append(o)
    _close(torch.cat(outs, dim=2), o_full, TOL64)
    _check_cache(ts, js)
    q1, k1, v1 = mk(rng, b, hq, hkv, 1, d, d)
    o_a, _ = step(ts, _t(q1), _t(k1), _t(v1), SPEC)
    jo, _ = jstep(js, jnp.asarray(q1), jnp.asarray(k1), jnp.asarray(v1),
                  JSPEC)
    _close(o_a, jo, TOL64)
    if not slotted:
        o_b, _ = step(whole, _t(q1), _t(k1), _t(v1), SPEC)
        _close(o_a, o_b, TOL64)


def test_kv_prefill_padding_persists_through_steps(_reference_in_float64):
    """Padding masked at prefill stays invisible in later steps (the mask
    lane carries it): a padded prompt decodes as the unpadded one does."""
    rng = np.random.default_rng(11)
    b, h, n, d, pad = 1, 2, 8, 4, 3
    q, k, v = mk(rng, b, h, h, n, d, d)
    mask = np.concatenate([np.ones((b, h, n - pad)), np.zeros((b, h, pad))],
                          axis=-1)
    padded, jpadded = _states(b, h, d, n + 3, slotted=False)
    prefill(_t(q), _t(k), _t(v), SPEC, state=padded, kv_mask=_t(mask))
    _, jpadded = jprefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          JSPEC, state=jpadded, kv_mask=jnp.asarray(mask))
    trunc, _ = _states(b, h, d, n + 3, slotted=False)
    keep = slice(0, n - pad)
    prefill(_t(q[:, :, keep]), _t(k[:, :, keep]), _t(v[:, :, keep]), SPEC,
            state=trunc)
    for _ in range(3):
        q1, k1, v1 = mk(rng, b, h, h, 1, d, d)
        o_masked, _ = step(padded, _t(q1), _t(k1), _t(v1), SPEC)
        o_trunc, _ = step(trunc, _t(q1), _t(k1), _t(v1), SPEC)
        jo, jpadded = jstep(jpadded, jnp.asarray(q1), jnp.asarray(k1),
                            jnp.asarray(v1), JSPEC)
        _close(o_masked, o_trunc, TOL64)
        _close(o_masked, jo, TOL64)


# ---------------------------------------------------------------------------
# core.decode_state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn", ["softmax", "fastmax2-chunked",
                                  "fastmax1-kernel", "hybrid2-chunked"])
@pytest.mark.parametrize("max_len", [128, 8192])
def test_decode_state_bytes_equals_jax(attn, max_len):
    from repro.configs import get_smoke_config as jsmoke
    from repro_torch.configs import get_smoke_config

    jcfg = dataclasses.replace(jsmoke("qwen3-1.7b"), attn=JSpec.parse(attn))
    tcfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                               attn=AttentionSpec.parse(attn))
    for batch in (1, 3):
        assert TD.decode_state_bytes(tcfg, batch, max_len) == \
            JD.decode_state_bytes(jcfg, batch, max_len)


def test_decode_state_bytes_constant_for_fastmax_linear_for_softmax():
    from repro_torch.configs import get_smoke_config

    def nbytes(attn, max_len):
        cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                                  attn=AttentionSpec.parse(attn))
        return TD.decode_state_bytes(cfg, 1, max_len)

    assert nbytes("fastmax2-chunked", 128) == nbytes("fastmax2-chunked", 8192)
    assert nbytes("softmax", 8192) > 32 * nbytes("softmax", 128)


@pytest.mark.parametrize("p", [1, 2])
def test_fastmax_prefill_and_decode_step(p):
    """The fastmax-level primitives against the reference's, float64: a
    masked prefill, then steps from its final moments."""
    rng = np.random.default_rng(30 + p)
    b, hq, hkv, n, d = 2, 4, 2, 19, 8
    q, k, v = mk(rng, b, hq, hkv, n, d, d)
    mask = _mask(rng, b, hkv, n)
    kw = dict(p=p, chunk_size=8, denom_eps=1e-6)
    o, st = TD.fastmax_prefill(_t(q), _t(k), _t(v), kv_mask=_t(mask), **kw)
    jo, jst = JD.fastmax_prefill(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), kv_mask=jnp.asarray(mask),
                                 **kw)
    _close(o, jo, TOL64)
    for a, r in zip(st, jst):
        _close(a, r, TOL64)
    for _ in range(3):
        q1, k1, v1 = mk(rng, b, hq, hkv, 1, d, d)
        before = [t.clone() for t in st]
        o, new = TD.fastmax_decode_step(st, _t(q1), _t(k1), _t(v1), p=p)
        jo, jst = JD.fastmax_decode_step(jst, jnp.asarray(q1),
                                         jnp.asarray(k1), jnp.asarray(v1),
                                         p=p)
        _close(o, jo, TOL64)
        for a, r, old in zip(new, jst, st):
            _close(a, r, TOL64)
        assert all(torch.equal(a, c) for a, c in zip(st, before))
        st = new
