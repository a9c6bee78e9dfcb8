"""Port parity of the whole serving slice on the qwen3-1.7b smoke config:
the same weights (a JAX `init_lm` tree converted with `from_jax_params`)
through `lm_prefill`, 8 `lm_decode_step`s and greedy generation, float64
on both sides. The JAX side runs its Pallas kernels in interpret mode
(`REPRO_DECODE_KERNEL=1`) and is called directly, not through
`repro.launch.serve.generate` (whose jit cache is keyed by config alone).

The reference computes its norms and RoPE in float32 even when the model
runs in float64 (`repro/models/layers.py` apply_norm, rms_norm_headwise,
apply_rope), and the port does the same. XLA and PyTorch round those
float32 reductions and cos/sin/rsqrt differently by an ulp, so:
  * the three float32 islands are held against JAX at float32 tolerance;
  * an attention layer (projections, RoPE, qk_norm, the paper's
    normalization, the prefill and decode kernels' plain versions, the
    moment state, the output projection), run eagerly on the JAX side
    with the JAX islands injected into the port, agrees to 1e-8;
  * the whole model end to end agrees to 1e-5 in the logits, and the
    greedy tokens are identical. 1e-8 is out of reach there: the jitted
    reference's own float32 islands differ from its eager ones by ~5e-7
    (XLA fuses them), so no port could match both.
"""
import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.attention import AttentionSpec as JSpec  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.attention import AttentionSpec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.param import from_jax_params  # noqa: E402

LOGIT_TOL = 1e-8        # float64 paths, float32 islands shared
E2E_LOGIT_TOL = 1e-5    # float32 islands computed by each framework
#                         (measured max difference ~9e-7 on this config)
ISLAND_TOL = 2e-6       # a few float32 ulps at unit scale
F64 = dict(param_dtype="float64", activ_dtype="float64")
B, PLEN, NDEC = 2, 21, 8   # prompt spans two chunks of 16


def _configs(attn):
    jcfg = dataclasses.replace(jsmoke("qwen3-1.7b"), attn=JSpec.parse(attn),
                               **F64)
    tcfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                               attn=AttentionSpec.parse(attn), **F64)
    return jcfg, tcfg


def _params(jcfg, tcfg):
    jparams, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, from_jax_params(tree, tcfg, "cpu")


@pytest.fixture
def decode_kernel_env(monkeypatch):
    monkeypatch.setenv("REPRO_DECODE_KERNEL", "1")


def _j(x):
    return jnp.asarray(x.detach().numpy())


def _tt(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def jax_float32_islands(monkeypatch):
    """Compute the port's float32 islands with the reference's functions,
    so the rest of the model is compared at float64 tolerance."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    monkeypatch.setattr(TL, "apply_norm", lambda params, x, **kw: _tt(
        JL.apply_norm({k: _j(v) for k, v in params.items()}, _j(x), **kw)))
    monkeypatch.setattr(TL, "rms_norm_headwise", lambda x, eps=1e-6: _tt(
        JL.rms_norm_headwise(_j(x), eps)))
    monkeypatch.setattr(TL, "apply_rope", lambda x, positions, theta: _tt(
        JL.apply_rope(_j(x), _j(positions), theta)))


def test_float32_islands_match_jax():
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    rng = np.random.default_rng(7)
    x, h = rng.normal(size=(2, 9, 64)), rng.normal(size=(2, 4, 9, 16))
    scale, pos = rng.normal(size=(64,)), np.arange(30, 39)
    pairs = [
        (JL.apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
         TL.apply_norm({"scale": torch.tensor(scale)}, torch.tensor(x))),
        (JL.rms_norm_headwise(jnp.asarray(h)),
         TL.rms_norm_headwise(torch.tensor(h))),
        (JL.apply_rope(jnp.asarray(h), jnp.asarray(pos), 1e6),
         TL.apply_rope(torch.tensor(h), torch.tensor(pos), 1e6)),
        (JL.rope_frequencies(16, 1e6), TL.rope_frequencies(16, 1e6)),
    ]
    for a, t in pairs:
        assert np.asarray(a).dtype == t.numpy().dtype
        np.testing.assert_allclose(np.asarray(a), t.numpy(), rtol=ISLAND_TOL,
                                   atol=ISLAND_TOL)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_from_jax_params_keeps_tree_and_values():
    jcfg, tcfg = _configs("fastmax2-kernel")
    jparams, tparams = _params(jcfg, tcfg)
    jflat, tflat = _flatten(jax.tree.map(np.asarray, jparams)), \
        _flatten(tparams)
    assert sorted(jflat) == sorted(tflat)
    assert tflat["/blocks_0/mixer/wq"].shape[0] == tcfg.n_layers
    for k, v in jflat.items():
        assert tflat[k].dtype == torch.float64
        np.testing.assert_array_equal(v, tflat[k].numpy())


def test_torch_init_matches_jax_tree_shapes():
    """The port's own initializer builds the JAX tree's layout and scales
    (normal x 1/sqrt(fan_in); embed at 1.0; norms at ones)."""
    jcfg, tcfg = _configs("fastmax2-kernel")
    jparams, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    jflat = _flatten(jax.tree.map(np.asarray, jparams))
    tflat = _flatten(TT.init_lm(tcfg, seed=0, device="cpu"))
    assert sorted(jflat) == sorted(tflat)
    for k, v in jflat.items():
        t = tflat[k].numpy()
        assert v.shape == t.shape, k
        if "norm" in k:
            np.testing.assert_array_equal(t, np.ones_like(t))
        else:   # std within 15% of the reference's draw
            assert abs(t.std() / v.std() - 1) < 0.15, k


@pytest.mark.parametrize("attn", ["fastmax2-kernel", "fastmax1-kernel",
                                  "fastmax2-chunked"])
def test_attention_layer_matches_jax(attn, decode_kernel_env,
                                     jax_float32_islands):
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    jcfg, tcfg = _configs(attn)
    jparams, tparams = _params(jcfg, tcfg)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks_0"]["mixer"])
    tp = {k: v[0] for k, v in tparams["blocks_0"]["mixer"].items()}
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, PLEN, jcfg.d_model))
    jst = JL.init_attn_state(jcfg, B, PLEN + NDEC, jnp.float64)
    tst = TL.init_attn_state(tcfg, B, PLEN + NDEC, torch.float64, "cpu")
    jy, jst = JL.attention_prefill(jp, jnp.asarray(x), jst, jcfg)
    ty, tst = TL.attention_prefill(tp, torch.tensor(x), tst, tcfg)
    np.testing.assert_allclose(np.asarray(jy), ty.numpy(), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for i in range(NDEC):
        xt = rng.normal(size=(B, 1, jcfg.d_model))
        jy, jst = JL.attention_decode(jp, jnp.asarray(xt), jst, jcfg,
                                      position=PLEN + i)
        ty, tst = TL.attention_decode(tp, torch.tensor(xt), tst, tcfg,
                                      position=PLEN + i)
        np.testing.assert_allclose(np.asarray(jy), ty.numpy(),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for a, t in zip(jst.moments, tst.moments):
        a = np.asarray(a)
        s = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(a / s, t.numpy() / s, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)


def _prefill_and_decode(attn, tol):
    jcfg, tcfg = _configs(attn)
    jparams, tparams = _params(jcfg, tcfg)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, jcfg.vocab_size, (B, PLEN))

    jstate = JT.init_lm_decode_state(jcfg, B, PLEN + NDEC)
    jprefill = jax.jit(lambda p, t, s: JT.lm_prefill(p, t, jcfg, s))
    jstep = jax.jit(lambda p, s, t, pos: JT.lm_decode_step(
        p, s, t, jcfg, position=pos))
    jlog, jstate = jprefill(jparams, jnp.asarray(prompts), jstate)

    tstate = TT.init_lm_decode_state(tcfg, B, PLEN + NDEC, device="cpu")
    with torch.inference_mode():
        tlog, tstate = TT.lm_prefill(tparams, torch.as_tensor(prompts), tcfg,
                                     tstate)
    np.testing.assert_allclose(np.asarray(jlog), tlog.numpy(), rtol=tol,
                               atol=tol)

    toks = rng.integers(0, jcfg.vocab_size, (NDEC, B))
    for i in range(NDEC):
        jl, jstate = jstep(jparams, jstate, jnp.asarray(toks[i]),
                           jnp.asarray(PLEN + i, jnp.int32))
        with torch.inference_mode():
            tl, tstate = TT.lm_decode_step(tparams, tstate,
                                           torch.as_tensor(toks[i]), tcfg,
                                           position=PLEN + i)
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=tol,
                                   atol=tol)
    # the carried moments agree too (stacked [n_layers, B, Hkv, ...]);
    # they are sums over ~30 tokens, so compare relative to their scale
    for a, t in zip(jstate["blocks_0"].moments, tstate["blocks_0"].moments):
        a = np.asarray(a)
        s = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(a / s, t.numpy() / s, rtol=tol, atol=tol)


# p=1 is left to the layer test: its sign-indefinite denominators amplify
# the float32-island ulps past any float64-style end-to-end tolerance
@pytest.mark.parametrize("attn", ["fastmax2-kernel", "fastmax2-chunked"])
def test_prefill_and_decode_logits_match_jax(attn, decode_kernel_env):
    _prefill_and_decode(attn, E2E_LOGIT_TOL)


def test_generate_tokens_match_jax(decode_kernel_env):
    jcfg, tcfg = _configs("fastmax2-kernel")
    jparams, tparams = _params(jcfg, tcfg)
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, PLEN))
    n_gen = 6

    jstate = JT.init_lm_decode_state(jcfg, B, PLEN + n_gen)
    jlog, jstate = JT.lm_prefill(jparams, jnp.asarray(prompts), jcfg, jstate)
    tok = jnp.argmax(jlog[:, -1], axis=-1).astype(jnp.int32)
    want = [np.asarray(tok)]
    jstep = jax.jit(lambda p, s, t, pos: JT.lm_decode_step(
        p, s, t, jcfg, position=pos))
    for i in range(n_gen - 1):
        lg, jstate = jstep(jparams, jstate, tok,
                           jnp.asarray(PLEN + i, jnp.int32))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
    want = np.stack(want, axis=1)

    got = generate(tparams, tcfg, torch.as_tensor(prompts), n_gen,
                   device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_eos_freezes_finished_sequences():
    _, tcfg = _configs("fastmax2-kernel")
    params = TT.init_lm(tcfg, seed=0, device="cpu")
    prompts = torch.as_tensor(
        np.random.default_rng(2).integers(0, tcfg.vocab_size, (B, PLEN)))
    free = generate(params, tcfg, prompts, 5, device="cpu")
    eos = int(free[0, 1])
    out = generate(params, tcfg, prompts, 5, eos_id=eos, device="cpu")
    row = out[0].tolist()
    assert row[:2] == free[0, :2].tolist()
    assert all(t == eos for t in row[1:])


def test_generate_timings_change_no_token():
    """`timings` fills in the same call's prefill and decode times and
    leaves the tokens as they are."""
    _, tcfg = _configs("fastmax2-kernel")
    params = TT.init_lm(tcfg, seed=0, device="cpu")
    prompts = torch.as_tensor(
        np.random.default_rng(5).integers(0, tcfg.vocab_size, (B, PLEN)))
    t = {}
    got = generate(params, tcfg, prompts, 5, device="cpu", timings=t)
    torch.testing.assert_close(
        got, generate(params, tcfg, prompts, 5, device="cpu"), rtol=0, atol=0)
    assert t["decode_steps"] == 4
    assert t["prefill_ms"] > 0 and t["decode_ms"] > 0


@pytest.mark.parametrize("kind", ["int", "scalar tensor", "per-sequence"])
def test_decode_position_forms_agree(kind):
    """A decode position given as an int, a 0-d tensor (what `generate`
    passes) or a [B] tensor gives the same logits and state."""
    _, tcfg = _configs("fastmax2-kernel")
    params = TT.init_lm(tcfg, seed=0, device="cpu")
    prompts = torch.as_tensor(
        np.random.default_rng(6).integers(0, tcfg.vocab_size, (B, PLEN)))
    tok = torch.as_tensor([3, 7])
    pos = {"int": PLEN, "scalar tensor": torch.tensor(PLEN),
           "per-sequence": torch.full((B,), PLEN)}[kind]
    out = []
    for p in (PLEN, pos):
        st = TT.init_lm_decode_state(tcfg, B, PLEN + 1, device="cpu")
        with torch.inference_mode():
            TT.lm_prefill(params, prompts, tcfg, st)
            logits, st = TT.lm_decode_step(params, st, tok, tcfg, position=p)
        out.append((logits, st["blocks_0"].moments))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_other_mixers_are_not_ported():
    _, tcfg = _configs("fastmax2-kernel")
    bad = dataclasses.replace(tcfg, pattern=("mamba:mlp",))
    with pytest.raises(NotImplementedError):
        TT.init_lm(bad, device="cpu")
