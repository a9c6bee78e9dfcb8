"""Port parity: `repro_torch.core` against `repro.core`, float64 on the CPU.

The same numpy inputs (seeded) go through the JAX function and its
PyTorch counterpart; results agree to 1e-10 (the two frameworks sum in
different orders, so bitwise equality is not expected).
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import fastmax as jfm  # noqa: E402
from repro.core import ref as jref  # noqa: E402
from repro.kernels import tiling as jtiling  # noqa: E402
from repro_torch.core import fastmax as tfm  # noqa: E402
from repro_torch.core import ref as tref  # noqa: E402
from repro_torch.kernels import ref as tkref  # noqa: E402
from repro_torch.kernels import tiling as ttiling  # noqa: E402
from torch_threads import share_cores  # noqa: F401,E402

TOL = 1e-10
B, HKV, N, D, DV, CHUNK = 2, 2, 37, 8, 6, 16   # N not a multiple of CHUNK


def _inputs(seed, g, n=N, normalized=True):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, HKV * g, n, D))
    k = rng.normal(size=(B, HKV, n, D))
    v = rng.normal(size=(B, HKV, n, DV))
    if normalized:
        q = np.asarray(jref.normalize_qk(jnp.asarray(q)))
        k = np.asarray(jref.normalize_qk(jnp.asarray(k)))
    mask = (rng.random(size=(B, HKV, n)) > 0.3).astype(np.float64)
    return q, k, v, mask


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float64).copy())


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=tol,
                               atol=tol)


def _moments(seed, p, shape_lead=(B, HKV)):
    rng = np.random.default_rng(seed)
    shapes = [(DV,), (D, DV), (D, D, DV), (), (D,), (D, D)]
    leaves = [rng.normal(size=shape_lead + s) for s in shapes]
    leaves[3] = np.abs(leaves[3]) + 3.0   # g0 is a token count
    if p < 2:
        leaves[2] = np.zeros_like(leaves[2])
        leaves[5] = np.zeros_like(leaves[5])
    return leaves


def test_normalize_qk():
    x = np.random.default_rng(0).normal(size=(3, 5, 7, 16)) * 3 + 1
    _close(jref.normalize_qk(jnp.asarray(x)), tref.normalize_qk(_t(x)))


@pytest.mark.parametrize("p", [0, 1, 2, 3])
def test_poly_kernel(p):
    s = np.random.default_rng(p).normal(size=(4, 9)) * 2
    _close(jref.poly_kernel(jnp.asarray(s), p), tref.poly_kernel(_t(s), p))


@pytest.mark.parametrize("causal", [False, True])
def test_fastmax_attention_ref(causal):
    q, k, v, _ = _inputs(1, 1, n=11, normalized=False)
    _close(jref.fastmax_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), p=2, causal=causal),
           tref.fastmax_attention_ref(_t(q), _t(k), _t(v), p=2,
                                      causal=causal))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("p", [1, 2])
def test_compute_moments(p, masked):
    _, k, v, mask = _inputs(2, 1)
    jm = jfm.compute_moments(jnp.asarray(k), jnp.asarray(v), p=p,
                             kv_mask=jnp.asarray(mask) if masked else None)
    tm = tfm.compute_moments(_t(k), _t(v), p=p,
                             kv_mask=_t(mask) if masked else None)
    for a, b in zip(jm, tm):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("p", [1, 2])
def test_combine_with_queries(p, g):
    q, _, _, _ = _inputs(3, g)
    mom = _moments(4, p)
    qg = q.reshape(B, HKV, g * N, D)
    jn, jd = jfm.combine_with_queries(
        jnp.asarray(qg), jfm.Moments(*map(jnp.asarray, mom)), p=p)
    tn, td = tfm.combine_with_queries(_t(qg), tfm.Moments(*map(_t, mom)), p=p)
    _close(jn, tn)
    _close(jd, td)


@pytest.mark.parametrize("case", ["plain", "mask", "mask+init"])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("p", [1, 2])
def test_causal_scan(p, g, case):
    q, k, v, mask = _inputs(5 + g, g)
    m = mask if case != "plain" else None
    init = _moments(6, p) if case == "mask+init" else None
    jo, jst = jfm._causal_scan(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), p=p,
        chunk_size=CHUNK, kv_mask=None if m is None else jnp.asarray(m),
        denom_eps=1e-6,
        init=None if init is None else jfm.Moments(*map(jnp.asarray, init)))
    to, tst = tfm._causal_scan(
        _t(q), _t(k), _t(v), p=p, chunk_size=CHUNK,
        kv_mask=None if m is None else _t(m), denom_eps=1e-6,
        init=None if init is None else tfm.Moments(*map(_t, init)))
    _close(jo, to)
    for a, b in zip(jst, tst):
        _close(a, b)


@pytest.mark.parametrize("p", [1, 2])
def test_causal_scan_matches_quadratic_oracle(p):
    """The port's scan against the port's own O(N^2) oracle."""
    q, k, v, _ = _inputs(9, 2)
    o, _ = tfm._causal_scan(_t(q), _t(k), _t(v), p=p, chunk_size=CHUNK,
                            kv_mask=None, denom_eps=0.0)
    ref = tkref.fastmax_ref(_t(q), _t(k), _t(v), p=p, causal=True,
                            denom_eps=0.0)
    torch.testing.assert_close(o, ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("d", [1, 8, 16, 64, 96, 128])
def test_tiling_copy_matches_reference(d):
    assert ttiling.divisors(d) == jtiling.divisors(d)
    assert ttiling.SCAN_BM_BUDGET == jtiling.SCAN_BM_BUDGET
    for budget in (1, 512, ttiling.SCAN_BM_BUDGET):
        assert ttiling.pick_bm(d, budget) == jtiling.pick_bm(d, budget)
