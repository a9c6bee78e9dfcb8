"""Port parity of the §2.5 backward: the plain version of the CUDA backward
kernel (`fastmax_causal_bwd_ref`, on `core.fastmax._causal_scan_cg_bwd`)
against the Pallas backward kernel (interpret mode) in float64, the
trainable `ops.fastmax` on CPU tensors against autograd through the plain
scan, and the autograd residual left intact. The CUDA kernel itself is
held against its plain version on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core.ref import normalize_qk as jnormalize  # noqa: E402
from repro.kernels.fastmax_causal import fastmax_causal_pallas  # noqa: E402
from repro.kernels.fastmax_causal_bwd import (  # noqa: E402
    fastmax_causal_bwd_pallas)
from repro_torch.core.fastmax import fastmax_causal_chunked  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.fastmax_causal import fastmax_causal_ref  # noqa: E402
from repro_torch.kernels.fastmax_causal_bwd import (  # noqa: E402
    fastmax_causal_bwd_cuda, fastmax_causal_bwd_ref)
from repro_torch.kernels.fastmax_noncausal import (  # noqa: E402
    fastmax_noncausal_cuda, fastmax_noncausal_ref)
from torch_threads import share_cores  # noqa: F401,E402

TOL = 1e-10


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _inputs(rng, b, hq, hkv, n, d, dv):
    q = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hq, n, d)))))
    k = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hkv, n, d)))))
    v = rng.normal(size=(b, hkv, n, dv))
    do = rng.normal(size=(b, hq, n, dv))
    return q, k, v, do


def _assert_close(a, t, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), t.detach().numpy(), rtol=tol,
                               atol=tol)


SHAPES = [(1, 2, 1, 40, 8, 8),    # GQA g=2
          (1, 4, 2, 33, 8, 8),    # padding 33 -> 48 at chunk 16
          (1, 8, 2, 64, 8, 16)]   # g=4, Dv != D


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("p", [1, 2])
def test_plain_bwd_matches_pallas_bwd(shape, p):
    """dq, dk, dv and all six dstate moments, on the forward's final
    carry, f64, the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(100 * p + shape[3])
    q, k, v, do = _inputs(rng, *shape)
    _, st = fastmax_causal_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), p=p, chunk_size=16,
                                  return_state=True, interpret=True)
    st = [np.asarray(x) for x in st]
    j = fastmax_causal_bwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        tuple(map(jnp.asarray, st)), jnp.asarray(do), p=p, chunk_size=16,
        interpret=True, return_dstate=True)
    t = fastmax_causal_bwd_ref(_t(q), _t(k), _t(v), tuple(map(_t, st)),
                               _t(do), p=p, chunk_size=16,
                               return_dstate=True)
    for a, b in zip(j[:3], t[:3]):
        _assert_close(a, b)
    assert len(t[3]) == 6
    for a, b in zip(j[3], t[3]):
        assert tuple(a.shape) == tuple(b.shape)
        _assert_close(a, b)


@pytest.mark.parametrize("p", [1, 2])
def test_plain_bwd_matches_pallas_on_a_seeded_forward(p):
    """A forward seeded with init_state (ragged N): the reverse walk ends
    at the seed and dstate is the seed's gradient."""
    rng = np.random.default_rng(7 + p)
    q, k, v, do = _inputs(rng, 2, 4, 2, 37, 8, 8)
    q0, k0, v0, _ = _inputs(rng, 2, 4, 2, 20, 8, 8)
    _, seed = fastmax_causal_pallas(jnp.asarray(q0), jnp.asarray(k0),
                                    jnp.asarray(v0), p=p, chunk_size=16,
                                    return_state=True, interpret=True)
    _, st = fastmax_causal_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), p=p, chunk_size=16,
                                  return_state=True, interpret=True,
                                  init_state=seed)
    st = [np.asarray(x) for x in st]
    j = fastmax_causal_bwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        tuple(map(jnp.asarray, st)), jnp.asarray(do), p=p, chunk_size=16,
        interpret=True, return_dstate=True)
    t = fastmax_causal_bwd_ref(_t(q), _t(k), _t(v), tuple(map(_t, st)),
                               _t(do), p=p, chunk_size=8,
                               return_dstate=True)
    for a, b in zip(j[:3], t[:3]):
        _assert_close(a, b)
    for a, b in zip(j[3], t[3]):
        _assert_close(a, b)


def test_dstate_is_the_seed_gradient():
    """return_dstate on a seeded forward equals autograd of the seeded
    plain scan with respect to the seed."""
    rng = np.random.default_rng(3)
    q, k, v, do = (_t(x) for x in _inputs(rng, 1, 4, 2, 30, 8, 8))
    q0, k0, v0, _ = (_t(x) for x in _inputs(rng, 1, 4, 2, 12, 8, 8))
    _, seed = fastmax_causal_ref(q0, k0, v0, p=2, chunk_size=8)
    seed = [s.clone().requires_grad_(True) for s in seed]
    o, st = fastmax_causal_ref(q, k, v, p=2, chunk_size=8, init_state=seed)
    want = torch.autograd.grad(o, seed, do)
    got = fastmax_causal_bwd_ref(q, k, v, [s.detach() for s in st], do, p=2,
                                 chunk_size=8, return_dstate=True)[3]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


def _leaves(seed, n=40, shape=(1, 4, 2, 8, 8)):
    rng = np.random.default_rng(seed)
    b, hq, hkv, d, dv = shape
    q, k, v, do = (_t(x) for x in _inputs(rng, b, hq, hkv, n, d, dv))
    return [x.requires_grad_(True) for x in (q, k, v)], do


def test_ops_fastmax_grads_match_plain_autograd():
    """The trainable op on CPU tensors (the forward kernel's plain version
    + the §2.5 backward's) against autograd through the plain scan — the
    counterpart of tests/test_kernels.py::test_kernel_gradient_matches_
    chunked."""
    (q, k, v), do = _leaves(13)
    o = ops.fastmax(q, k, v, p=2, causal=True, chunk_size=16)
    gk = torch.autograd.grad(torch.sin(o).sum(), (q, k, v))
    o2 = fastmax_causal_chunked(q, k, v, p=2, chunk_size=16,
                                custom_grad=False)
    gj = torch.autograd.grad(torch.sin(o2).sum(), (q, k, v))
    torch.testing.assert_close(o, o2, rtol=TOL, atol=TOL)
    for a, b in zip(gk, gj):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("p", [1, 2])
def test_custom_grad_scan_matches_ops_fastmax(p):
    """The chunked backend's §2.5 path and the kernel op agree (both are
    the same reverse scan on CPU tensors)."""
    (q, k, v), do = _leaves(20 + p, n=33)
    ga = torch.autograd.grad(
        ops.fastmax(q, k, v, p=p, chunk_size=8), (q, k, v), do)
    gb = torch.autograd.grad(
        fastmax_causal_chunked(q, k, v, p=p, chunk_size=8), (q, k, v), do)
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


def test_backward_twice_leaves_the_residual_intact():
    """retain_graph: a second backward gives the same grads, so the saved
    carry was not mutated by the first."""
    (q, k, v), do = _leaves(5)
    o = ops.fastmax(q, k, v, p=2, chunk_size=16)
    g1 = torch.autograd.grad(o, (q, k, v), do, retain_graph=True)
    g2 = torch.autograd.grad(o, (q, k, v), do)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_bwd_does_not_write_the_state():
    (q, k, v), do = _leaves(6)
    _, st = fastmax_causal_ref(q.detach(), k.detach(), v.detach(), p=2,
                               chunk_size=16)
    before = [x.clone() for x in st]
    fastmax_causal_bwd_ref(q.detach(), k.detach(), v.detach(), st, do, p=2,
                           chunk_size=16, return_dstate=True)
    for a, b in zip(st, before):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ops_on_cpu_launch_nothing_and_noncausal_raises():
    """Causal and noncausal, forward and backward, CPU tensors launch no
    kernel (the noncausal op equals its plain version there); the
    noncausal kernel's wrapper raises on CPU tensors."""
    (q, k, v), do = _leaves(8)
    ops.reset_launch_counts()
    o = ops.fastmax(q, k, v, p=2, chunk_size=16)
    torch.autograd.grad(o, (q, k, v), do)
    onc = ops.fastmax(q, k, v, p=2, causal=False, chunk_size=16)
    torch.autograd.grad(onc, (q, k, v), do)
    assert ops.launch_counts() == {"fastmax_causal": 0,
                                   "fastmax_causal_bwd": 0,
                                   "fastmax_decode": 0,
                                   "fastmax_noncausal_moments": 0,
                                   "fastmax_noncausal_combine": 0,
                                   "hybrid_causal": 0}
    torch.testing.assert_close(
        onc, fastmax_noncausal_ref(q, k, v, p=2, chunk_size=16), rtol=0,
        atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        fastmax_noncausal_cuda(q.detach().float(), k.detach().float(),
                               v.detach().float(), p=2)


def test_bwd_cuda_wrapper_refuses_cpu_tensors():
    (q, k, v), do = _leaves(9)
    q, k, v, do = (x.detach().float() for x in (q, k, v, do))
    _, st = fastmax_causal_ref(q, k, v, p=2)
    with pytest.raises(ValueError, match="CUDA"):
        fastmax_causal_bwd_cuda(q, k, v, st, do, p=2)


def test_plain_bwd_refuses_inference_mode():
    """Autograd records nothing under inference mode; the plain backward
    raises there instead of returning zero grads."""
    (q, k, v), do = _leaves(10)
    q, k, v = (x.detach() for x in (q, k, v))
    _, st = fastmax_causal_ref(q, k, v, p=2, chunk_size=16)
    with torch.inference_mode():
        with pytest.raises(RuntimeError, match="inference_mode"):
            fastmax_causal_bwd_ref(q, k, v, st, do, p=2, chunk_size=16)


@pytest.mark.parametrize("p", [1, 2])
def test_plain_bwd_rounds_bf16_grads_once(p):
    """bf16 inputs: the plain backward works in float32 and rounds each grad
    to bf16 once, so it equals the float32 backward on the same values,
    rounded (as the kernel does). Differentiating the bf16 chunk slices
    instead rounds every use's grad and their sum inside each chunk."""
    (q, k, v), do = _leaves(11 + p, n=70, shape=(1, 4, 2, 16, 16))
    q, k, v, do = (x.detach().to(torch.bfloat16) for x in (q, k, v, do))
    _, st = fastmax_causal_ref(q, k, v, p=p, chunk_size=16)
    got = fastmax_causal_bwd_ref(q, k, v, st, do, p=p, chunk_size=16)
    want = fastmax_causal_bwd_ref(q.float(), k.float(), v.float(), st,
                                  do.float(), p=p, chunk_size=16)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, b.to(torch.bfloat16), rtol=0, atol=0)
