"""Port parity of the two serving kernels' plain versions against the
Pallas kernels (interpret mode, float64), and the CPU routing of the `ops`
wrappers. The CUDA kernels themselves are held against their plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core.ref import normalize_qk as jnormalize  # noqa: E402
from repro.kernels.fastmax_causal import fastmax_causal_pallas  # noqa: E402
from repro.kernels.fastmax_decode import fastmax_decode_pallas  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.fastmax_causal import (  # noqa: E402
    fastmax_causal_cuda, fastmax_causal_ref, pick_chunk)
from repro_torch.kernels.fastmax_decode import fastmax_decode_cuda  # noqa: E402
from repro_torch.kernels.ref import fastmax_decode_ref  # noqa: E402

TOL = 1e-10


def _t(x, dtype=torch.float64):
    return torch.from_numpy(np.asarray(x, dtype=np.float64).copy()).to(dtype)


def _qkv(rng, b, hq, hkv, n, d, dv):
    q = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hq, n, d)))))
    k = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hkv, n, d)))))
    v = rng.normal(size=(b, hkv, n, dv))
    return q, k, v


def _state(rng, b, hkv, d, dv, p):
    shapes = [(dv,), (d, dv), (d, d, dv), (), (d,), (d, d)]
    leaves = [rng.normal(size=(b, hkv) + s) for s in shapes]
    leaves[3] = np.abs(leaves[3]) + 5.0
    if p < 2:
        leaves[2] = np.zeros_like(leaves[2])
        leaves[5] = np.zeros_like(leaves[5])
    return leaves


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("p", [1, 2])
def test_prefill_plain_matches_pallas(p, g, seeded):
    """o and all six final moments, with a ragged kv_mask and (optionally)
    an init_state, N not a multiple of the chunk."""
    rng = np.random.default_rng(10 * p + g)
    b, hkv, n, d, dv = 2, 2, 40, 8, 8
    q, k, v = _qkv(rng, b, hkv * g, hkv, n, d, dv)
    mask = (rng.random(size=(b, 1, n)) > 0.25).astype(np.float64)
    init = _state(rng, b, hkv, d, dv, p) if seeded else None
    jo, jst = fastmax_causal_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        p=p, chunk_size=16, return_state=True, interpret=True,
        init_state=None if init is None else tuple(map(jnp.asarray, init)))
    to, tst = fastmax_causal_ref(
        _t(q), _t(k), _t(v), _t(mask), p=p, chunk_size=16,
        init_state=None if init is None else tuple(map(_t, init)))
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), rtol=TOL, atol=TOL)
    assert len(tst) == 6
    for a, t in zip(jst, tst):
        assert tuple(a.shape) == tuple(t.shape)
        np.testing.assert_allclose(np.asarray(a), t.numpy(), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("p", [1, 2])
def test_decode_plain_matches_pallas_lockstep(p):
    """64 chained decode steps from a prefilled state: the plain version,
    the in-place `ops.fastmax_decode` on CPU tensors, and the Pallas
    kernel stay in lockstep."""
    rng = np.random.default_rng(20 + p)
    b, g, hkv, d, dv = 2, 2, 2, 8, 8
    q, k, v = _qkv(rng, b, hkv * g, hkv, 24, d, dv)
    _, st = fastmax_causal_ref(_t(q), _t(k), _t(v), p=p, chunk_size=16)
    jstate = tuple(jnp.asarray(x.numpy()) for x in st)
    tstate = tuple(x.clone() for x in st)
    inplace = tuple(x.clone() for x in st)
    for _ in range(64):
        qs, ks, vs = _qkv(rng, b, hkv * g, hkv, 1, d, dv)
        jo, jstate = fastmax_decode_pallas(
            jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(vs), jstate, p=p,
            interpret=True)
        to, tstate = fastmax_decode_ref(_t(qs), _t(ks), _t(vs), tstate, p=p)
        io = ops.fastmax_decode(_t(qs), _t(ks), _t(vs), inplace, p=p)
        np.testing.assert_allclose(np.asarray(jo), to.numpy(), rtol=TOL,
                                   atol=TOL)
        torch.testing.assert_close(io, to, rtol=0, atol=0)
    for a, t, i in zip(jstate, tstate, inplace):
        np.testing.assert_allclose(np.asarray(a), t.numpy(), rtol=TOL,
                                   atol=TOL)
        torch.testing.assert_close(i, t, rtol=0, atol=0)


def test_ops_on_cpu_take_plain_versions_and_launch_nothing():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 4, 2, 20, 8, 8)
    ops.reset_launch_counts()
    o, st = ops.fastmax_prefill_kernel(_t(q), _t(k), _t(v), p=2,
                                       chunk_size=8)
    ro, rst = fastmax_causal_ref(_t(q), _t(k), _t(v), p=2, chunk_size=8)
    torch.testing.assert_close(o, ro, rtol=0, atol=0)
    qs, ks, vs = _qkv(rng, 1, 4, 2, 1, 8, 8)
    want, _ = fastmax_decode_ref(_t(qs), _t(ks), _t(vs), st, p=2)
    got = ops.fastmax_decode(_t(qs), _t(ks), _t(vs), st, p=2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ops.launch_counts() == {"fastmax_causal": 0,
                                   "fastmax_causal_bwd": 0,
                                   "fastmax_decode": 0,
                                   "fastmax_noncausal_moments": 0,
                                   "fastmax_noncausal_combine": 0}


def test_ops_decode_on_cpu_updates_state_in_place():
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 1, 2, 2, 12, 8, 8)
    _, st = fastmax_causal_ref(_t(q), _t(k), _t(v), p=2, chunk_size=8)
    before = [x.clone() for x in st]
    ptrs = [x.data_ptr() for x in st]
    qs, ks, vs = _qkv(rng, 1, 2, 2, 1, 8, 8)
    ops.fastmax_decode(_t(qs), _t(ks), _t(vs), st, p=2)
    _, want = fastmax_decode_ref(_t(qs), _t(ks), _t(vs), before, p=2)
    assert [x.data_ptr() for x in st] == ptrs
    for got, w in zip(st, want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)


def test_cuda_wrappers_refuse_cpu_tensors():
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 1, 2, 2, 8, 8, 8)
    q32, k32, v32 = (_t(x, torch.float32) for x in (q, k, v))
    with pytest.raises(ValueError, match="CUDA"):
        fastmax_causal_cuda(q32, k32, v32)
    st = tuple(torch.zeros(s) for s in
               [(1, 2, 8), (1, 2, 8, 8), (1, 2, 8, 8, 8), (1, 2), (1, 2, 8),
                (1, 2, 8, 8)])
    with pytest.raises(ValueError, match="CUDA"):
        fastmax_decode_cuda(q32[:, :, :1], k32[:, :, :1], v32[:, :, :1], st)


def test_asking_for_cuda_without_a_card_raises(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import init_decode_state, init_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_decode_state(cfg, 1, 8)
    params = init_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.generate(params, cfg, torch.zeros(1, 4, dtype=torch.int64), 2)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--smoke", "--batch", "1", "--prompt-len", "4",
                    "--gen", "2"])


def test_pick_chunk_fits_shared_memory():
    assert pick_chunk(2, 128, lambda g, c, d: 0) == 64
    assert pick_chunk(4, 128, lambda g, c, d: 0) == 32
    assert pick_chunk(16, 128, lambda g, c, d: 0) == 8
    assert pick_chunk(128, 128, lambda g, c, d: 0) == 1
    # halves until the (fake) footprint fits 227 KB
    assert pick_chunk(1, 128, lambda g, c, d: c * 10_000) == 16
    with pytest.raises(ValueError):
        pick_chunk(129, 128, lambda g, c, d: 0)
    with pytest.raises(ValueError):
        pick_chunk(1, 512, lambda g, c, d: 10**9)
