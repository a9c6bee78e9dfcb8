"""Port parity of the decode-state protocol (`attention.state`) and the
backend registry: prefill, resumable (offset) prefill and decode steps
against the JAX protocol, float64 on both sides, the JAX kernels in
interpret mode (`REPRO_DECODE_KERNEL=1`); and the kernel backend's routing
on CPU tensors (the prefill kernel's wrapper, never the plain scan
directly, also for a resumed prefill).
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.attention import AttentionSpec as JSpec  # noqa: E402
from repro.attention import state as JS  # noqa: E402
from repro_torch.attention import AttentionSpec, get_backend  # noqa: E402
from repro_torch.attention import list_backends, resolve  # noqa: E402
from repro_torch.attention import state as TS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = 1e-10
B, HQ, HKV, D, N, CUT = 2, 4, 2, 8, 30, 13   # CUT splits the prompt
SPECS = ["fastmax2-kernel", "fastmax1-kernel", "fastmax2-chunked"]


@pytest.fixture
def decode_kernel_env(monkeypatch):
    monkeypatch.setenv("REPRO_DECODE_KERNEL", "1")


def _specs(name):
    return (JSpec.parse(name, chunk_size=8),
            AttentionSpec.parse(name, chunk_size=8))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, HQ, N, D))
    k = rng.normal(size=(B, HKV, N, D))
    v = rng.normal(size=(B, HKV, N, D))
    mask = (rng.random(size=(B, HKV, N)) > 0.2).astype(np.float64)
    return q, k, v, mask


def _states(jspec, tspec):
    kw = dict(batch=B, n_kv_heads=HKV, q_head_dim=D, v_head_dim=D,
              max_len=N + 4)
    return (JS.init_state(jspec, dtype=jnp.float64, **kw),
            TS.init_state(tspec, dtype=torch.float64, device="cpu", **kw))


def _close(a, t):
    np.testing.assert_allclose(np.asarray(a), t.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", SPECS)
def test_resumable_prefill_and_steps_match_jax(name, decode_kernel_env):
    """A prompt prefilled in two pieces (the second with `offset`), then 4
    decode steps: outputs and all six moments match the JAX protocol, and
    the resumed state equals a whole-prompt prefill's."""
    jspec, tspec = _specs(name)
    q, k, v, mask = _inputs(1)
    js, ts = _states(jspec, tspec)
    for sl, off in ((slice(0, CUT), None), (slice(CUT, N), CUT)):
        args = [x[:, :, sl] for x in (q, k, v, mask)]
        jo, js = JS.prefill(*map(jnp.asarray, args[:3]), jspec, state=js,
                            kv_mask=jnp.asarray(args[3]),
                            offset=None if off is None else jnp.asarray(off))
        to, ts = TS.prefill(*map(torch.tensor, args[:3]), tspec, state=ts,
                            kv_mask=torch.tensor(args[3]), offset=off)
        _close(jo, to)
    for a, t in zip(js.moments, ts.moments):
        _close(a, t)

    _, whole = _states(jspec, tspec)
    TS.prefill(torch.tensor(q), torch.tensor(k), torch.tensor(v), tspec,
               state=whole, kv_mask=torch.tensor(mask))
    for a, t in zip(whole.moments, ts.moments):
        torch.testing.assert_close(a, t, rtol=TOL, atol=TOL)

    rng = np.random.default_rng(2)
    for _ in range(4):
        qs, ks, vs = (rng.normal(size=(B, h, 1, D)) for h in (HQ, HKV, HKV))
        jo, js = JS.step(js, *map(jnp.asarray, (qs, ks, vs)), jspec)
        to, ts = TS.step(ts, *map(torch.tensor, (qs, ks, vs)), tspec)
        _close(jo, to)
    for a, t in zip(js.moments, ts.moments):
        _close(a, t)


def test_kernel_backend_resumes_through_the_prefill_kernel(monkeypatch):
    """On the kernel backend a resumed prefill goes to the prefill kernel's
    wrapper seeded with the carried moments (so a CUDA tensor launches the
    kernel); the plain scan is not called from the protocol."""
    _, tspec = _specs("fastmax2-kernel")
    q, k, v, _ = (torch.tensor(x) for x in _inputs(3))
    ts = _states(*_specs("fastmax2-kernel"))[1]
    seen = []
    real = ops.fastmax_prefill_kernel

    def spy(*a, init_state=None, **kw):
        seen.append(init_state)
        return real(*a, init_state=init_state, **kw)

    def no_scan(*a, **kw):
        raise AssertionError("the protocol called the plain scan")

    monkeypatch.setattr(ops, "fastmax_prefill_kernel", spy)
    monkeypatch.setattr(TS, "_causal_scan", no_scan)
    ops.reset_launch_counts()
    TS.prefill(q[:, :, :CUT], k[:, :, :CUT], v[:, :, :CUT], tspec, state=ts)
    TS.prefill(q[:, :, CUT:], k[:, :, CUT:], v[:, :, CUT:], tspec, state=ts,
               offset=CUT)
    assert seen[0] is None
    assert seen[1] is ts.moments
    assert ops.launch_counts() == {"fastmax_causal": 0,
                                   "fastmax_causal_bwd": 0,
                                   "fastmax_decode": 0,
                                   "fastmax_noncausal_moments": 0,
                                   "fastmax_noncausal_combine": 0}


@pytest.mark.parametrize("name, backend, decode_kernel", [
    ("fastmax2-kernel", "fastmax-kernel", True),
    ("fastmax1-kernel", "fastmax-kernel", True),
    ("fastmax2-chunked", "fastmax-chunked", False),
    ("fastmax2", "fastmax-chunked", False),
])
def test_resolve_is_a_name_lookup(name, backend, decode_kernel):
    got = resolve(AttentionSpec.parse(name))
    assert got is get_backend(backend)
    assert got.caps.decode and got.caps.decode_kernel == decode_kernel
    assert backend in list_backends()


def test_unported_backends_are_refused():
    with pytest.raises(KeyError, match="no attention backend"):
        get_backend("softmax-flash")
    with pytest.raises(NotImplementedError):
        TS.init_state(AttentionSpec.parse("softmax"), batch=1, n_kv_heads=1,
                      q_head_dim=4, v_head_dim=4, max_len=4, device="cpu")
