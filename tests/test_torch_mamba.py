"""Port parity of the Mamba mixer (`repro_torch.models.mamba`) with the
reference's `repro.models.mamba`, on numpy inputs from a seed.

  * `_selective_scan` and `_causal_conv` called directly in float64: the
    port's doubling scan against the reference's associative scan, at
    1e-10 (ragged N, a nonzero h0, N below one chunk, a carried conv state
    longer than the chunk it is applied to).
  * the block (`apply_mamba`, the stateful prefill, `mamba_decode`; the
    reference's functions jitted once per test) at the
    reference's float32 islands (the scan's inputs, A and D are float32
    even in a float64 model, and XLA and PyTorch round float32 exp,
    softplus and products differently by an ulp): ISLAND_TOL of the
    output's scale, with float64 weights and inputs.
  * the port against itself: chained decode steps equal the stateful
    prefill of the same tokens, and a prefill resumed from its state
    equals one prefill of the whole prompt (float32 rounding of two
    evaluation orders: ISLAND_TOL).
"""
import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.models.param import Builder as JBuilder  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import mamba as TM  # noqa: E402
from repro_torch.models.param import Builder, from_jax_params  # noqa: E402
from torch_threads import share_cores  # noqa: F401,E402

TOL = 1e-10            # float64, no float32 island in the way
ISLAND_TOL = 2e-5      # relative to the output's scale: float32 islands
DOUBLING_TOL = 1e-5    # float32 doubling scan against float64, of scale
ARCH = "jamba-v0.1-52b"
F64 = dict(param_dtype="float64", activ_dtype="float64")


def _cfgs(**over):
    return (dataclasses.replace(jsmoke(ARCH), **F64, **over),
            dataclasses.replace(get_smoke_config(ARCH), **F64, **over))


def _params(jcfg, tcfg, seed=0):
    b = JBuilder(jax.random.PRNGKey(seed), jnp.float64)
    JM.init_mamba(b, "m", jcfg)
    jp = b.params["m"]
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(got, want, tol, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    s = max(1.0, np.abs(want).max()) if scale is None else scale
    err = np.abs(got - want).max() / s
    assert err <= tol, err


@pytest.mark.parametrize("n,chunk,h0", [(37, 16, True), (16, 16, False),
                                        (5, 16, True), (64, 8, True)],
                         ids=["ragged", "one-chunk", "below-chunk", "eight"])
def test_selective_scan_matches_jax_f64(n, chunk, h0):
    rng = np.random.default_rng(n + chunk)
    b, di, ds = 2, 12, 5
    u = rng.normal(size=(b, n, di))
    delta = np.log1p(np.exp(rng.normal(size=(b, n, di))))  # softplus > 0
    a = -np.exp(rng.normal(size=(di, ds)))
    bm, cm = rng.normal(size=(b, n, ds)), rng.normal(size=(b, n, ds))
    dsk = rng.normal(size=(di,))
    h = rng.normal(size=(b, di, ds)) if h0 else np.zeros((b, di, ds))
    jy, jh = jax.jit(lambda *t: JM._selective_scan(*t[:6], h0=t[6],
                                                   chunk=chunk))(
        *map(jnp.asarray, (u, delta, a, bm, cm, dsk, h)))
    ty, th = TM._selective_scan(*map(_t, (u, delta, a, bm, cm, dsk)),
                                h0=_t(h), chunk=chunk)
    assert ty.dtype == th.dtype == torch.float64
    _close(ty.numpy(), jy, TOL)
    _close(th.numpy(), jh, TOL)


def test_doubling_scan_keeps_long_chunks_finite_in_float32():
    """Δ·A at its largest (d_state 16, Δ = 20) over one 512-token chunk in
    float32: the running products underflow to 0, never to inf or NaN
    (as exp(-cumsum(Δ·A)) would overflow), and the outputs and state are
    the token-by-token recurrence's in float64 to float32 rounding
    (DOUBLING_TOL of the scale: 9 steps of products)."""
    rng = np.random.default_rng(0)
    n, di, ds = 512, 4, 16
    delta = torch.full((1, n, di), 20.0, dtype=torch.float64)
    delta[:, ::3] = rng.uniform(0.0, 0.05)        # some slow decays too
    a = -torch.arange(1, ds + 1, dtype=torch.float64).expand(di, ds)
    u, bm, cm = (torch.from_numpy(rng.normal(size=(1, n, k)))
                 for k in (di, ds, ds))
    y, h = TM._selective_scan(*(t.float() for t in (u, delta, a, bm, cm)),
                              torch.zeros(di), h0=torch.zeros(1, di, ds),
                              chunk=512)
    hh, want = torch.zeros(1, di, ds, dtype=torch.float64), []
    for t in range(n):
        hh = torch.exp(delta[:, t, :, None] * a) * hh + (
            delta[:, t] * u[:, t])[..., None] * bm[:, t, None, :]
        want.append((hh * cm[:, t, None, :]).sum(-1))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    _close(y.double().numpy(), torch.stack(want, 1).numpy(), DOUBLING_TOL)
    _close(h.double().numpy(), hh.numpy(), DOUBLING_TOL)


@pytest.mark.parametrize("n", [1, 2, 7])
def test_causal_conv_carries_its_state_f64(n):
    """N below and above d_conv - 1 = 3, from a carried state: the output
    and the new state (the last 3 inputs of [state, x])."""
    rng = np.random.default_rng(n)
    x, w = rng.normal(size=(2, n, 6)), rng.normal(size=(4, 6))
    bias, st = rng.normal(size=(6,)), rng.normal(size=(2, 3, 6))
    jo, js = JM._causal_conv(*map(jnp.asarray, (x, w, bias)),
                             state=jnp.asarray(st))
    to, ts = TM._causal_conv(*map(_t, (x, w, bias)), state=_t(st))
    _close(to.numpy(), jo, 1e-13)
    _close(ts.numpy(), js, 0.0)
    jo, js = JM._causal_conv(*map(jnp.asarray, (x, w, bias)))
    to, ts = TM._causal_conv(*map(_t, (x, w, bias)))
    _close(to.numpy(), jo, 1e-13)
    _close(ts.numpy(), js, 0.0)


def test_apply_mamba_matches_jax_at_the_float32_islands():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    x = np.random.default_rng(1).normal(size=(2, 37, jcfg.d_model))
    want = jax.jit(lambda p, x: JM.apply_mamba(p, x, jcfg))(jp,
                                                             jnp.asarray(x))
    got = TM.apply_mamba(tp, _t(x), tcfg)
    assert got.dtype == torch.float64
    _close(got.detach().numpy(), want, ISLAND_TOL,
           scale=np.abs(np.asarray(want)).max())


def _jax_prefill(jp, x, jcfg, st):
    """The reference's stateful Mamba prefill (inlined in lm_prefill)."""
    xi, z, delta, a, bm_, cm_, conv = JM._pre_ssm(jp, x, jcfg,
                                                  conv_state=st.conv)
    y, hf = JM._selective_scan(
        xi.astype(jnp.float32), delta.astype(jnp.float32), a,
        bm_.astype(jnp.float32), cm_.astype(jnp.float32),
        jp["D"].astype(jnp.float32), h0=st.h, chunk=jcfg.chunk_size)
    y = jnp.einsum("bnd,de->bne", y.astype(x.dtype) * jax.nn.silu(z),
                   jp["out_proj"])
    return y, JM.MambaState(conv=conv, h=hf)


def test_prefill_then_decode_matches_jax_in_place():
    """A prefill of 21 tokens (two chunks of 16) then 4 decode steps, the
    port's state updated in place (the same tensors throughout)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg, seed=2)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 21, jcfg.d_model))
    jst = JM.init_mamba_state(jcfg, 2, jnp.float64)
    tst = TM.init_mamba_state(tcfg, 2, torch.float64)
    assert tst.conv.dtype == torch.float64 and tst.h.dtype == torch.float32
    ptrs = [t.data_ptr() for t in tst]
    jy, jst = jax.jit(lambda p, x, s: _jax_prefill(p, x, jcfg, s))(
        jp, jnp.asarray(x), jst)
    jdecode = jax.jit(lambda p, x, s: JM.mamba_decode(p, x, s, jcfg))
    with torch.no_grad():
        ty, out = TM.mamba_prefill(tp, _t(x), tcfg, tst)
    assert out is tst and [t.data_ptr() for t in tst] == ptrs
    _close(ty.numpy(), jy, ISLAND_TOL, scale=np.abs(np.asarray(jy)).max())
    for i in range(4):
        xt = rng.normal(size=(2, 1, jcfg.d_model))
        jy, jst = jdecode(jp, jnp.asarray(xt), jst)
        with torch.no_grad():
            ty, _ = TM.mamba_decode(tp, _t(xt), tst, tcfg)
        _close(ty.numpy(), jy, ISLAND_TOL,
               scale=np.abs(np.asarray(jy)).max())
        _close(tst.h.numpy(), jst.h, ISLAND_TOL)
        _close(tst.conv.numpy(), jst.conv, ISLAND_TOL)


def test_decode_chain_equals_prefill_and_prefill_resumes():
    """The port against itself: 9 decode steps give the stateful prefill's
    outputs and state; a prefill of 20 tokens resumed after 7 (a chunk
    shorter than one scan chunk, then one crossing it) gives the whole
    prompt's."""
    _, tcfg = _cfgs()
    g = torch.Generator().manual_seed(4)
    b = Builder(g, torch.float64, "cpu")
    TM.init_mamba(b, "m", tcfg)
    tp = b.params["m"]
    x = torch.randn(2, 20, tcfg.d_model, generator=g, dtype=torch.float64)
    with torch.no_grad():
        whole = TM.init_mamba_state(tcfg, 2, torch.float64)
        yw, _ = TM.mamba_prefill(tp, x, tcfg, whole)
        parts = TM.init_mamba_state(tcfg, 2, torch.float64)
        y1, _ = TM.mamba_prefill(tp, x[:, :7], tcfg, parts)
        y2, _ = TM.mamba_prefill(tp, x[:, 7:], tcfg, parts)
        steps = TM.init_mamba_state(tcfg, 2, torch.float64)
        ys = [TM.mamba_decode(tp, x[:, t:t + 1], steps, tcfg)[0]
              for t in range(9)]
    scale = yw.abs().max().item()
    _close(torch.cat([y1, y2], 1).numpy(), yw.numpy(), ISLAND_TOL, scale)
    for a_, b_ in zip(parts, whole):
        _close(a_.numpy(), b_.numpy(), ISLAND_TOL)
    _close(torch.cat(ys, 1).numpy(), yw[:, :9].numpy(), ISLAND_TOL, scale)
    nine = TM.init_mamba_state(tcfg, 2, torch.float64)
    with torch.no_grad():
        TM.mamba_prefill(tp, x[:, :9], tcfg, nine)
    for a_, b_ in zip(steps, nine):
        _close(a_.numpy(), b_.numpy(), ISLAND_TOL)


def test_builder_constant_rounds_a_log_as_the_reference():
    """A_log = log(1..d_state) in bf16 is stored rounded to bf16, as the
    reference stores it (not kept in float32), and repeated over a stacked
    builder's group axis."""
    jcfg = jsmoke(ARCH)
    tcfg = get_smoke_config(ARCH)
    b = JBuilder(jax.random.PRNGKey(0), jnp.bfloat16)
    JM.init_mamba(b, "m", jcfg)
    want = np.asarray(b.params["m"]["A_log"].astype(jnp.float32))
    tb = Builder(torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    TM.init_mamba(tb.stacked("blocks", 3), "m", tcfg)
    got = tb.params["blocks"]["m"]["A_log"]
    assert got.dtype == torch.bfloat16 and got.shape == (3,) + want.shape
    for g in range(3):
        np.testing.assert_array_equal(got[g].float().numpy(), want)
