"""Port parity of the attention API's last two backends: fastmax-oracle
(the O(N^2) reference per query group) and fastmax-rowwise (the paper's
schedule through explicit phi features, with the Fig. 2 factorized
dropout), against JAX in float64 at 1e-10, forward and grads.

The port cannot reproduce `jax.random.bernoulli`'s bits, so the dropout
cases draw the reference's keep masks with JAX and hand them to the port
through its one draw helper (`core.fastmax.draw_keep`)."""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import attention as JA  # noqa: E402
from repro_torch import attention as TA  # noqa: E402
from repro_torch.attention import state as TS  # noqa: E402
from repro_torch.core import fastmax as TF  # noqa: E402
from torch_threads import share_cores  # noqa: F401,E402

TOL = 1e-10
B, HKV, N, M, D, DV = 2, 2, 12, 10, 8, 6


def _inputs(g, causal, seed=0):
    rng = np.random.default_rng(seed)
    m = N if causal else M
    return (rng.normal(size=(B, HKV * g, N, D)),
            rng.normal(size=(B, HKV, m, D)),
            rng.normal(size=(B, HKV, m, DV)),
            rng.normal(size=(B, HKV * g, N, DV)))


def _both(name, q, k, v, do, causal, jrng=None, trng=None, **spec):
    """(JAX o, grads), (port o, grads) of sum(o * do)."""
    jspec = JA.AttentionSpec.parse(name, **spec)
    tspec = TA.AttentionSpec.parse(name, **spec)

    def jloss(q, k, v):
        o = JA.attention(q, k, v, jspec, causal=causal, rng=jrng)
        return jnp.sum(o * do), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    to = TA.attention(tq, tk, tv, tspec, causal=causal, rng=trng)
    tg = torch.autograd.grad(to, (tq, tk, tv), torch.tensor(do))
    return (jo, jg), (to.detach(), tg)


def _close(j, t):
    (jo, jg), (to, tg) = j, t
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL,
                               atol=TOL)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("impl", ["oracle", "rowwise"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("g", [1, 2])
def test_oracle_and_rowwise_match_jax(impl, causal, p, g):
    q, k, v, do = _inputs(g, causal, seed=p + 2 * g)
    _close(*_both(f"fastmax{p}-{impl}", q, k, v, do, causal))


def _jax_masks(key, mode, rate, g):
    """The keep masks the reference draws from `key`, in its order."""
    keep = 1.0 - rate
    if mode == "quadratic":
        return [jax.random.bernoulli(key, keep, shape=(B, HKV, 1, D * D))]
    if mode == "1d":
        return [jax.random.bernoulli(key, keep, shape=(B, HKV * g, N, D)),
                jax.random.bernoulli(jax.random.fold_in(key, 1), keep,
                                     shape=(B, HKV, N, D))]
    return []


@pytest.mark.parametrize("mode", ["quadratic", "1d", "none"])
@pytest.mark.parametrize("causal", [True, False])
def test_dropout_modes_match_jax_with_its_masks(mode, causal, monkeypatch):
    rate, g = 0.3, 2
    q, k, v, do = _inputs(g, causal=True, seed=5)
    key = jax.random.PRNGKey(7)
    masks = _jax_masks(key, mode, rate, g)
    drawn = []

    def injected(shape, keep_prob, generator, device):
        assert keep_prob == 1.0 - rate and generator is not None
        want = masks[len(drawn)]
        assert tuple(shape) == want.shape
        drawn.append(shape)
        return torch.from_numpy(np.array(want))

    monkeypatch.setattr(TF, "draw_keep", injected)
    j, t = _both("fastmax2-rowwise", q, k, v, do, causal, jrng=key,
                 trng=torch.Generator().manual_seed(0), dropout_rate=rate,
                 dropout_mode=mode)
    _close(j, t)
    assert len(drawn) == len(masks)
    # the masks reached the output
    plain = TA.attention(*map(torch.tensor, (q, k, v)),
                         TA.AttentionSpec.parse("fastmax2-rowwise"),
                         causal=causal)
    assert ((t[0] - plain).abs().max() > 1e-3) == bool(masks)


def test_quadratic_dropout_draws_nothing_at_p1(monkeypatch):
    monkeypatch.setattr(TF, "draw_keep", lambda *a: pytest.fail("drawn"))
    q, k, v, do = _inputs(1, causal=True)
    j, t = _both("fastmax1-rowwise", q, k, v, do, True,
                 jrng=jax.random.PRNGKey(0),
                 trng=torch.Generator().manual_seed(0), dropout_rate=0.5)
    _close(j, t)


def test_draw_keep_is_seeded_and_keeps_its_share():
    shape, keep = (4, 8, 1, 256), 0.7
    a = TF.draw_keep(shape, keep, torch.Generator().manual_seed(3), "cpu")
    b = TF.draw_keep(shape, keep, torch.Generator().manual_seed(3), "cpu")
    assert a.dtype == torch.bool and torch.equal(a, b)
    n = a.numel()
    share = a.float().mean().item()
    assert abs(share - keep) <= 4 * np.sqrt(keep * (1 - keep) / n)


def test_deprecated_shim_warns_and_equals_the_dispatcher():
    q, k, v, _ = (torch.tensor(x) for x in _inputs(2, causal=True))
    for impl, kw in (("rowwise", dict(dropout_rate=0.2)), ("chunked", {}),
                     ("oracle", {})):
        with pytest.warns(DeprecationWarning, match="deprecated"):
            o = TF.fastmax_attention(
                q, k, v, causal=True, impl=impl, chunk_size=4,
                dropout_rng=torch.Generator().manual_seed(1)
                if kw else None, **kw)
        spec = TA.AttentionSpec(impl=impl, chunk_size=4, **kw)
        want = TA.attention(q, k, v, spec, causal=True,
                            rng=torch.Generator().manual_seed(1)
                            if kw else None)
        assert torch.equal(o, want)


@pytest.mark.parametrize("name", ["fastmax2-chunked", "fastmax2-kernel",
                                  "fastmax2-oracle", "hybrid2-chunked",
                                  "softmax"])
def test_dropout_elsewhere_raises_naming_rowwise(name):
    q = torch.randn(1, 2, 8, 8)
    spec = TA.AttentionSpec.parse(name, dropout_rate=0.1)
    with pytest.raises(ValueError, match="fastmax2-rowwise"):
        TA.attention(q, q, q, spec, causal=True,
                     rng=torch.Generator().manual_seed(0))
    # without an rng the spec's dropout is off, as in the reference
    assert TA.attention(q, q, q, spec, causal=True).shape == q.shape


@pytest.mark.parametrize("name", ["fastmax2-oracle", "fastmax2-rowwise"])
def test_oracle_and_rowwise_refuse_a_mask_and_decode(name):
    q = torch.randn(1, 2, 8, 8)
    spec = TA.AttentionSpec.parse(name)
    with pytest.raises(ValueError, match="kv_mask"):
        TA.attention(q, q, q, spec, causal=True, kv_mask=torch.ones(1, 2, 8))
    with pytest.raises(ValueError, match="has no decode path"):
        TS.init_state(spec, batch=1, n_kv_heads=2, q_head_dim=8,
                      v_head_dim=8, max_len=8, device="cpu")
    caps = TA.resolve(spec).caps
    assert not caps.decode and caps.dropout == name.endswith("rowwise")
