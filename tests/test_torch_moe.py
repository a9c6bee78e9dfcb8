"""Port parity of the MoE FFN (`repro_torch.models.moe.apply_moe`) with the
reference's `repro.models.moe.apply_moe`, float64 on both sides.

The reference runs its router in float32 whatever the model's dtype (the
logits einsum, softmax, top_k and the renormalized gates), and XLA and
PyTorch round those float32 ops differently by an ulp. So, as the model
tests do with the norms:
  * the port's router island is held against the reference's at float32
    tolerance, with the same experts chosen;
  * everything past it (capacity, position-in-expert by token order,
    drops, the experts' SwiGLU, the gated combine, the shared experts) is
    held to 1e-10 with the reference's router values injected into the
    port (`_route`); the aux, a float32 mean over the tokens in the
    reference, to float32 rounding (2e-6 relative);
  * the grads of sum(y^2) + aux run through each framework's own router,
    so they are held at the island's float32 tolerance (1e-5 of each
    leaf's scale).
"""
import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from torch_threads import share_cores  # noqa: F401,E402

TOL = 1e-10          # float64 past the router island
ISLAND_TOL = 2e-6    # a few float32 ulps at unit scale
GRAD_TOL = 1e-5      # grads through each framework's float32 router


def _params(cfg, seed, skew=0.0):
    """A float64 MoE parameter dict at the config's widths; `skew` adds
    to one expert's router column so that it overflows its capacity on
    inputs with a positive mean (`_inputs`)."""
    rng = np.random.default_rng(seed)
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {"router": rng.normal(size=(d, e)) * 0.3,
         "wi_gate": rng.normal(size=(e, d, ff)) / np.sqrt(d),
         "wi_up": rng.normal(size=(e, d, ff)) / np.sqrt(d),
         "wo": rng.normal(size=(e, ff, d)) / np.sqrt(ff)}
    p["router"][:, 0] += skew
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        p.update(shared_wi_gate=rng.normal(size=(d, sff)) / np.sqrt(d),
                 shared_wi_up=rng.normal(size=(d, sff)) / np.sqrt(d),
                 shared_wo=rng.normal(size=(sff, d)) / np.sqrt(sff))
    return p


def _jax_route(xf, router, k):
    """The reference's router lines (`repro/models/moe.py` apply_moe),
    run eagerly as its apply_moe runs them."""
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32),
                        router.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gates, idx = jax.lax.top_k(probs, k)
    gates = gates / (jnp.sum(gates, axis=-1, keepdims=True) + 1e-9)
    return probs, gates, idx


@pytest.fixture
def jax_router(monkeypatch):
    """Run the port's router island with the reference's ops."""
    def route(xf, router, k):
        out = _jax_route(jnp.asarray(xf.detach().numpy()),
                         jnp.asarray(router.detach().numpy()), k)
        return tuple(torch.from_numpy(np.array(a)) for a in out)

    monkeypatch.setattr(TM, "_route", route)


def _cfgs(arch, **over):
    return jsmoke(arch, **over), get_smoke_config(arch, **over)


# (arch, n_shared, capacity_factor, full_capacity, tokens as (B, N), skew)
CASES = {
    "train-drops": ("kimi-k2-1t-a32b", 1, 1.25, False, (2, 40), 0.0),
    "train-cf1e-9": ("kimi-k2-1t-a32b", 1, 1e-9, False, (1, 64), 0.0),
    "train-no-shared": ("deepseek-v2-236b", 0, 1.25, False, (2, 40), 0.0),
    "full-t64": ("deepseek-v2-236b", 1, 1.25, True, (2, 32), 0.0),
    "full-t64-no-shared": ("kimi-k2-1t-a32b", 0, 1.25, True, (2, 32), 0.0),
    "full-t4100": ("kimi-k2-1t-a32b", 1, 1.25, True, (2, 2050), 0.6),
}


def _inputs(seed, shape, skew):
    x = np.random.default_rng(seed).normal(size=shape)
    return x + 1.0 if skew else x


def _run(case, seed=0):
    arch, shared, cf, full, (b, n), skew = CASES[case]
    jcfg, tcfg = _cfgs(arch, n_shared_experts=shared, capacity_factor=cf)
    p = _params(tcfg, seed, skew)
    x = _inputs(seed + 1, (b, n, tcfg.d_model), skew)
    jy, jaux = JM.apply_moe({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), jcfg, full_capacity=full)
    ty, taux = TM.apply_moe({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), tcfg, full_capacity=full)
    return (tcfg, p, x, full), (np.asarray(jy), np.asarray(jaux)), \
        (ty.numpy(), taux.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_moe_matches_jax(case, jax_router):
    (cfg, p, x, full), (jy, jaux), (ty, taux) = _run(case)
    assert ty.dtype == np.float64 and ty.shape == x.shape
    np.testing.assert_allclose(ty, jy, rtol=TOL, atol=TOL)
    # the aux is a float32 value in the reference (the mean of the float32
    # probs over the tokens): held at float32 rounding
    assert taux.dtype == np.float32 == jaux.dtype
    np.testing.assert_allclose(taux, jaux, rtol=ISLAND_TOL, atol=0)
    # the case reaches the branch it is named for: the capacity, and
    # pairs dropped where the name says so
    t, k, e = x.shape[0] * x.shape[1], cfg.moe_top_k, cfg.n_experts
    cap = TM.capacity(t, cfg, full)
    _, _, idx = _jax_route(jnp.asarray(x.reshape(t, -1)),
                           jnp.asarray(p["router"]), k)
    counts = np.bincount(np.asarray(idx).ravel(), minlength=e)
    dropped = int(np.maximum(counts - cap, 0).sum())
    if full and t <= 4096:
        assert cap == t and dropped == 0
    elif full:
        assert cap == min(t, int(2.0 * k * t / e)) < t and dropped > 0
    else:
        assert cap == max(1, int(k * t * cfg.capacity_factor / e))
        assert dropped > 0


@pytest.mark.parametrize("case", ["train-drops", "full-t64"])
def test_router_island_matches_jax(case):
    arch = CASES[case][0]
    _, cfg = _cfgs(arch)
    p = _params(cfg, 3)
    xf = np.random.default_rng(4).normal(size=(64, cfg.d_model))
    jp, jg, ji = _jax_route(jnp.asarray(xf), jnp.asarray(p["router"]),
                            cfg.moe_top_k)
    tp, tg, ti = TM._route(torch.from_numpy(xf),
                           torch.from_numpy(p["router"]), cfg.moe_top_k)
    assert tp.dtype == torch.float32 == tg.dtype
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for a, t in ((jp, tp), (jg, tg)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a),
                                   rtol=ISLAND_TOL, atol=ISLAND_TOL)


@pytest.mark.parametrize("case", ["train-drops", "full-t64-no-shared"])
def test_apply_moe_grads_match_jax(case):
    arch, shared, cf, full, (b, n), skew = CASES[case]
    jcfg, tcfg = _cfgs(arch, n_shared_experts=shared, capacity_factor=cf)
    p = _params(tcfg, 5, skew)
    x = np.random.default_rng(6).normal(size=(b, n, tcfg.d_model))

    def jloss(jp, jx):
        y, aux = JM.apply_moe(jp, jx, jcfg, full_capacity=full)
        return jnp.sum(jnp.square(y)) + aux

    jg = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = TM.apply_moe(tp, tx, tcfg, full_capacity=full)
    (y.square().sum() + aux).backward()
    pairs = [(jg[0][k], tp[k].grad) for k in p] + [(jg[1], tx.grad)]
    assert sorted(p) == sorted(jg[0])
    for a, t in pairs:
        a = np.asarray(a)
        s = max(np.abs(a).max(), 1e-30)
        np.testing.assert_allclose(t.numpy() / s, a / s, rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
    assert np.abs(tp["router"].grad.numpy()).max() > 0


def test_moe_dispatch_makes_no_token_by_slot_by_expert_tensor(monkeypatch):
    """No [T, k, E] (nor [T, E, C]) tensor is made: every tensor the call
    creates is at most max(T·E, T·k·d, E·d·ff)-sized."""
    _, cfg = _cfgs("kimi-k2-1t-a32b")
    p = {k: torch.from_numpy(v) for k, v in _params(cfg, 7).items()}
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(1, 256, 64)))
    t, k, e = 256, cfg.moe_top_k, cfg.n_experts
    sizes = []
    from torch.utils._python_dispatch import TorchDispatchMode

    class Sizes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    sizes.append(o.numel())
            return out

    with Sizes():
        TM.apply_moe(p, x, cfg, full_capacity=True)
    limit = max(t * e, t * k * 1, t * cfg.d_model,
                e * cfg.d_model * cfg.d_ff_expert)
    assert max(sizes) <= limit < t * k * e * cfg.d_model


def test_capacity_branches():
    _, cfg = _cfgs("deepseek-v2-236b")
    e, k = cfg.n_experts, cfg.moe_top_k
    assert TM.capacity(4096, cfg, True) == 4096
    assert TM.capacity(4100, cfg, True) == min(4100, int(2.0 * k * 4100 / e))
    assert TM.capacity(64, cfg, False) == int(k * 64 * 1.25 / e)
    tiny = dataclasses.replace(cfg, capacity_factor=1e-9)
    assert TM.capacity(64, tiny, False) == 1
