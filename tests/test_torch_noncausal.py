"""Port parity of noncausal fastmax: the plain moment path
(`core.fastmax.compute_moments_chunked`, `fastmax_noncausal`) against the
JAX package's in float64, forward and grads; the trainable
`ops.fastmax(causal=False)` on CPU tensors (the plain versions of the
noncausal kernel's two launches) against the Pallas kernel in interpret
mode, with JAX's grads of the same op; the `attention()` dispatcher's
noncausal branches; and the CPU routing of the kernel wrappers. The CUDA
kernel itself is held against its plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import attention as JA  # noqa: E402
from repro.core import fastmax as JF  # noqa: E402
from repro.core.ref import normalize_qk as jnormalize  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import attention as TA  # noqa: E402
from repro_torch.core import fastmax as TF  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.fastmax_noncausal import (  # noqa: E402
    fastmax_noncausal_cuda, fastmax_noncausal_ref, noncausal_combine_cuda,
    noncausal_combine_ref, noncausal_moments_cuda, noncausal_moments_ref)
from torch_threads import share_cores  # noqa: F401,E402

TOL = 1e-10
ZERO_LAUNCHES = {"fastmax_causal": 0, "fastmax_causal_bwd": 0,
                 "fastmax_decode": 0, "fastmax_noncausal_moments": 0,
                 "fastmax_noncausal_combine": 0, "hybrid_causal": 0}


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x, dtype=np.float64))
    return t.requires_grad_(grad)


def _inputs(rng, b, hq, hkv, n, m, d, dv):
    """Pre-normalized q̂ [B,Hq,N,D], k̂ [B,Hkv,M,D], v, and a cotangent."""
    q = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hq, n, d)))))
    k = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hkv, m, d)))))
    v = rng.normal(size=(b, hkv, m, dv))
    do = rng.normal(size=(b, hq, n, dv))
    return q, k, v, do


def _close(a, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), t.detach().numpy(), rtol=tol,
                               atol=tol)


# N != M (cross-attention), M ragged against the chunk of 16
CASES = [(1, 1, 9, 37), (2, 2, 24, 37)]   # (g, hkv, n, m)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("p", [1, 2])
def test_plain_noncausal_matches_jax(p, case, masked):
    """Forward and the grads of q, k, v, float64, chunk 16 (three chunks
    over M = 37, the last one padded), with a ragged kv_mask or none."""
    g, hkv, n, m = case
    rng = np.random.default_rng(10 * p + g + 3 * masked)
    q, k, v, do = _inputs(rng, 2, hkv * g, hkv, n, m, 8, 12)
    mask = None
    if masked:
        mask = (rng.random(size=(2, hkv, m)) > 0.3).astype(np.float64)

    def jfn(q_, k_, v_):
        return JF.fastmax_noncausal(
            q_, k_, v_, p=p, chunk_size=16,
            kv_mask=None if mask is None else jnp.asarray(mask))

    jo, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = vjp(jnp.asarray(do))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    to = TF.fastmax_noncausal(tq, tk, tv, p=p, chunk_size=16,
                              kv_mask=None if mask is None else _t(mask))
    tg = torch.autograd.grad(to, (tq, tk, tv), _t(do))
    _close(jo, to)
    for a, b in zip(jg, tg):
        _close(a, b)


@pytest.mark.parametrize("p", [1, 2])
def test_chunked_moments_match_jax(p):
    """All six moments of `compute_moments_chunked` (M = 37 over chunks of
    16, masked), and its one-chunk path (M <= chunk)."""
    rng = np.random.default_rng(40 + p)
    _, k, v, _ = _inputs(rng, 2, 2, 2, 1, 37, 8, 12)
    mask = (rng.random(size=(2, 2, 37)) > 0.3).astype(np.float64)
    for cs in (16, 64):
        jm = JF.compute_moments_chunked(jnp.asarray(k), jnp.asarray(v), p=p,
                                        kv_mask=jnp.asarray(mask),
                                        chunk_size=cs)
        tm = TF.compute_moments_chunked(_t(k), _t(v), p=p, kv_mask=_t(mask),
                                        chunk_size=cs)
        for a, b in zip(jm, tm):
            assert tuple(a.shape) == tuple(b.shape)
            _close(a, b)


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("p", [1, 2])
def test_ops_noncausal_matches_pallas_interpret(p, case):
    """The trainable `ops.fastmax(causal=False)` on CPU tensors against
    `repro.kernels.ops.fastmax(causal=False, interpret=True)`: o, and the
    grads against JAX's grads of the same op (both autograd of the plain
    moment path)."""
    g, hkv, n, m = case
    rng = np.random.default_rng(60 + 10 * p + g)
    q, k, v, do = _inputs(rng, 2, hkv * g, hkv, n, m, 8, 12)

    def jfn(q_, k_, v_):
        return jops.fastmax(q_, k_, v_, p=p, causal=False, chunk_size=16,
                            interpret=True)

    jo, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = vjp(jnp.asarray(do))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    ops.reset_launch_counts()
    to = ops.fastmax(tq, tk, tv, p=p, causal=False, chunk_size=16)
    tg = torch.autograd.grad(to, (tq, tk, tv), _t(do))
    assert ops.launch_counts() == ZERO_LAUNCHES
    _close(jo, to)
    for a, b in zip(jg, tg):
        _close(a, b)


@pytest.mark.parametrize("p", [1, 2])
def test_plain_launches_compose(p):
    """The plain versions of the two launches compose to the plain whole:
    moments, then the combine, at another chunk than the whole's."""
    rng = np.random.default_rng(80 + p)
    q, k, v, _ = _inputs(rng, 2, 4, 2, 5, 37, 8, 12)
    q, k, v = _t(q), _t(k), _t(v)
    mom = noncausal_moments_ref(k, v, p=p, chunk_size=16)
    got = noncausal_combine_ref(q, mom, p=p, denom_eps=1e-6)
    want = fastmax_noncausal_ref(q, k, v, p=p, chunk_size=512)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    if p == 1:
        assert not mom.m2.any() and not mom.g2.any()


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
@pytest.mark.parametrize("p", [1, 2])
def test_attention_noncausal_matches_jax(p, impl):
    """`attention(causal=False)` on raw q/k (the backend normalizes) with
    M != N keys, float64: forward and grads against the JAX dispatcher's
    (the kernel backend runs the Pallas kernel in interpret mode there)."""
    rng = np.random.default_rng(90 + p)
    q = rng.normal(size=(2, 4, 11, 8))
    k = rng.normal(size=(2, 2, 29, 8))
    v = rng.normal(size=(2, 2, 29, 8))
    do = rng.normal(size=(2, 4, 11, 8))
    name = f"fastmax{p}-{impl}"
    jspec = JA.AttentionSpec.parse(name, chunk_size=16)

    def jfn(q_, k_, v_):
        return JA.attention(q_, k_, v_, jspec, causal=False)

    jo, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = vjp(jnp.asarray(do))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    to = TA.attention(tq, tk, tv, TA.AttentionSpec.parse(name, chunk_size=16),
                      causal=False)
    tg = torch.autograd.grad(to, (tq, tk, tv), _t(do))
    _close(jo, to)
    for a, b in zip(jg, tg):
        _close(a, b)


def test_chunked_attention_noncausal_takes_a_mask():
    """The chunked backend removes masked keys exactly (as dropping them);
    the kernel backend refuses the mask (the reference drops it
    silently)."""
    rng = np.random.default_rng(95)
    q = _t(rng.normal(size=(1, 2, 6, 8)))
    k = _t(rng.normal(size=(1, 2, 20, 8)))
    v = _t(rng.normal(size=(1, 2, 20, 8)))
    mask = torch.ones(1, 2, 20, dtype=torch.float64)
    mask[..., 13:] = 0
    spec = TA.AttentionSpec.parse("fastmax2-chunked")
    got = TA.attention(q, k, v, spec, causal=False, kv_mask=mask)
    want = TA.attention(q, k[:, :, :13], v[:, :, :13], spec, causal=False)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="fastmax2-chunked"):
        TA.attention(q, k, v, TA.AttentionSpec.parse("fastmax2-kernel"),
                     causal=False, kv_mask=mask)


def test_noncausal_bf16_on_cpu_rounds_once():
    """bf16 inputs on the CPU route: o in bf16, one rounding of the
    float32 result."""
    rng = np.random.default_rng(97)
    q, k, v, _ = _inputs(rng, 1, 2, 2, 7, 21, 8, 8)
    qb, kb, vb = (torch.tensor(x, dtype=torch.bfloat16) for x in (q, k, v))
    o = ops.fastmax(qb, kb, vb, p=2, causal=False, chunk_size=16)
    want = fastmax_noncausal_ref(qb.float(), kb.float(), vb.float(), p=2)
    assert o.dtype == torch.bfloat16
    torch.testing.assert_close(o, want.to(torch.bfloat16), rtol=0, atol=0)


def test_cuda_wrappers_refuse_cpu_tensors():
    rng = np.random.default_rng(99)
    q, k, v, _ = _inputs(rng, 1, 2, 2, 3, 9, 8, 8)
    q, k, v = (torch.tensor(x, dtype=torch.float32) for x in (q, k, v))
    with pytest.raises(ValueError, match="CUDA"):
        noncausal_moments_cuda(k, v, p=2)
    with pytest.raises(ValueError, match="CUDA"):
        noncausal_combine_cuda(q, noncausal_moments_ref(k, v, p=2), p=2)
    with pytest.raises(ValueError, match="CUDA"):
        fastmax_noncausal_cuda(q, k, v, p=2)
    with pytest.raises(ValueError, match="p must be"):
        noncausal_moments_cuda(k, v, p=3)
