"""Port parity of the xLSTM mixers (`repro_torch.models.xlstm`) with the
reference's `repro.models.xlstm`, on numpy inputs from a seed.

  * `_mlstm_chunk_scan` called directly in float64 at 1e-10 (ragged N, a
    nonzero (c0, n0), N below one chunk).
  * mLSTM (`apply_mlstm`, `apply_mlstm_stateful`, `mlstm_decode`) and
    sLSTM (`apply_slstm`, `apply_slstm_stateful`, `slstm_decode`) at the
    reference's float32 islands, with float64 weights and inputs: the
    forget and input gates (log-sigmoid, the capped exp, sLSTM's
    stabilizer) and the carried states are float32 in both packages, and
    XLA and PyTorch round float32 exp and log-sigmoid differently by an
    ulp; the head-wise norms' variances are float32 too. ISLAND_TOL of the
    output's scale.
  * the port against itself: chained decode steps equal the stateful
    prefill of the same tokens, whose state is updated in place.
"""
import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro.models.param import Builder as JBuilder  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.models.param import Builder, from_jax_params  # noqa: E402
from torch_threads import share_cores  # noqa: F401,E402

TOL = 1e-10            # float64, no float32 island in the way
ISLAND_TOL = 2e-5      # relative to the output's scale: float32 islands
ARCH = "xlstm-1.3b"
F64 = dict(param_dtype="float64", activ_dtype="float64")
B, N = 2, 37           # 37 tokens: two chunks of 16 and a ragged 5


def _cfgs():
    return (dataclasses.replace(jsmoke(ARCH), **F64),
            dataclasses.replace(get_smoke_config(ARCH), **F64))


def _params(kind, seed=0):
    jcfg, tcfg = _cfgs()
    b = JBuilder(jax.random.PRNGKey(seed), jnp.float64)
    getattr(JX, f"init_{kind}")(b, "m", jcfg)
    jp = b.params["m"]
    return jcfg, tcfg, jp, from_jax_params(jax.tree.map(np.asarray, jp),
                                           tcfg, "cpu")


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(got, want, tol, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    s = max(1.0, np.abs(want).max()) if scale is None else scale
    err = np.abs(got - want).max() / s
    assert err <= tol, err


def _out_close(got, want):
    _close(got.detach().numpy(), want, ISLAND_TOL,
           scale=np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("n,chunk,carry", [(37, 16, True), (32, 16, False),
                                           (5, 16, True)],
                         ids=["ragged", "two-chunks", "below-chunk"])
def test_mlstm_chunk_scan_matches_jax_f64(n, chunk, carry):
    rng = np.random.default_rng(n)
    h, dk, dv = 3, 6, 5
    q, k = rng.normal(size=(2, 2, h, n, dk))
    v = rng.normal(size=(2, h, n, dv))
    log_f = np.log(1 / (1 + np.exp(-rng.normal(2.0, 1.0, size=(2, h, n)))))
    ig = np.exp(np.minimum(rng.normal(size=(2, h, n)), 10.0))
    c0 = rng.normal(size=(2, h, dk, dv)) if carry else np.zeros((2, h, dk,
                                                                 dv))
    n0 = rng.normal(size=(2, h, dk)) if carry else np.zeros((2, h, dk))
    jh, (jc, jn) = jax.jit(lambda *t: JX._mlstm_chunk_scan(*t, chunk=chunk))(
        *map(jnp.asarray, (q, k, v, log_f, ig, c0, n0)))
    th, (tc, tn) = TX._mlstm_chunk_scan(
        *map(_t, (q, k, v, log_f, ig, c0, n0)), chunk=chunk)
    for got, want in ((th, jh), (tc, jc), (tn, jn)):
        assert got.dtype == torch.float64
        _close(got.numpy(), want, TOL)


def test_mlstm_matches_jax_at_the_float32_islands():
    jcfg, tcfg, jp, tp = _params("mlstm")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, N, jcfg.d_model))
    _out_close(TX.apply_mlstm(tp, _t(x), tcfg),
               jax.jit(lambda p, x: JX.apply_mlstm(p, x, jcfg))(
                   jp, jnp.asarray(x)))
    # stateful from a nonzero carry, the state updated in place
    jst = JX.MLSTMState(c=jnp.asarray(rng.normal(size=(B, 2, 32, 32)),
                                      jnp.float32),
                        n=jnp.asarray(rng.normal(size=(B, 2, 32)),
                                      jnp.float32))
    tst = TX.MLSTMState(*(_t(t) for t in jst))
    ptrs = [t.data_ptr() for t in tst]
    jy, jst = jax.jit(lambda p, x, s: JX.apply_mlstm_stateful(
        p, x, jcfg, s))(jp, jnp.asarray(x), jst)
    jdecode = jax.jit(lambda p, x, s: JX.mlstm_decode(p, x, s, jcfg))
    with torch.no_grad():
        ty, out = TX.apply_mlstm_stateful(tp, _t(x), tcfg, tst)
    assert out is tst and [t.data_ptr() for t in tst] == ptrs
    _out_close(ty, jy)
    for got, want in zip(tst, jst):
        assert got.dtype == torch.float32
        _close(got.numpy(), want, ISLAND_TOL)
    for i in range(3):
        xt = rng.normal(size=(B, 1, jcfg.d_model))
        jy, jst = jdecode(jp, jnp.asarray(xt), jst)
        with torch.no_grad():
            ty, _ = TX.mlstm_decode(tp, _t(xt), tst, tcfg)
        _out_close(ty, jy)
        for got, want in zip(tst, jst):
            _close(got.numpy(), want, ISLAND_TOL)


def test_slstm_matches_jax_at_the_float32_islands():
    jcfg, tcfg, jp, tp = _params("slstm", seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, N, jcfg.d_model))
    _out_close(TX.apply_slstm(tp, _t(x), tcfg),
               jax.jit(lambda p, x: JX.apply_slstm(p, x, jcfg))(
                   jp, jnp.asarray(x)))
    jst = JX.init_slstm_state(jcfg, B, jnp.float64)
    tst = TX.init_slstm_state(tcfg, B, torch.float64)
    assert [t.dtype for t in tst] == [torch.float32] * 3 + [torch.float64]
    assert float(tst.m.max()) == float(tst.m.min()) == float(
        np.float32(-1e9))
    ptrs = [t.data_ptr() for t in tst]
    jy, jst = jax.jit(lambda p, x, s: JX.apply_slstm_stateful(
        p, x, jcfg, s))(jp, jnp.asarray(x[:, :20]), jst)
    jdecode = jax.jit(lambda p, x, s: JX.slstm_decode(p, x, s, jcfg))
    with torch.no_grad():
        ty, out = TX.apply_slstm_stateful(tp, _t(x[:, :20]), tcfg, tst)
    assert out is tst and [t.data_ptr() for t in tst] == ptrs
    _out_close(ty, jy)
    for got, want in zip(tst, jst):
        _close(got.numpy(), want, ISLAND_TOL)
    for i in range(3):
        xt = rng.normal(size=(B, 1, jcfg.d_model))
        jy, jst = jdecode(jp, jnp.asarray(xt), jst)
        with torch.no_grad():
            ty, _ = TX.slstm_decode(tp, _t(xt), tst, tcfg)
        _out_close(ty, jy)
        for got, want in zip(tst, jst):
            _close(got.numpy(), want, ISLAND_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_chain_equals_the_stateful_prefill(kind):
    """The port against itself: 9 one-token steps from a fresh state give
    the stateful prefill's outputs and final state over the same 9 tokens
    (float32 rounding of two evaluation orders)."""
    _, tcfg = _cfgs()
    g = torch.Generator().manual_seed(3)
    b = Builder(g, torch.float64, "cpu")
    getattr(TX, f"init_{kind}")(b, "m", tcfg)
    tp = b.params["m"]
    x = torch.randn(B, 9, tcfg.d_model, generator=g, dtype=torch.float64)

    def fresh():
        if kind == "mlstm":
            return TX.init_mlstm_state(tcfg, B)
        return TX.init_slstm_state(tcfg, B, torch.float64)

    stateful = getattr(TX, f"apply_{kind}_stateful")
    decode = getattr(TX, f"{kind}_decode")
    with torch.no_grad():
        whole = fresh()
        yw, _ = stateful(tp, x, tcfg, whole)
        steps = fresh()
        ys = torch.cat([decode(tp, x[:, t:t + 1], steps, tcfg)[0]
                        for t in range(9)], dim=1)
    _close(ys.numpy(), yw.numpy(), ISLAND_TOL, yw.abs().max().item())
    for a_, b_ in zip(steps, whole):
        _close(a_.numpy(), b_.numpy(), ISLAND_TOL)


def test_forget_bias_constant_in_bf16():
    """mLSTM's forget bias 3.0 is a constant of the param dtype, repeated
    over a stacked builder's group axis."""
    tb = Builder(torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    TX.init_mlstm(tb.stacked("blocks", 2), "m", get_smoke_config(ARCH))
    bf = tb.params["blocks"]["m"]["bf"]
    assert bf.dtype == torch.bfloat16 and bf.shape == (2, 2)
    assert bool((bf == 3.0).all())
