"""Port parity of the encoder-decoder serving slice on the whisper-small
smoke config: LayerNorm, the GELU MLP and the sinusoidal positions, the
parameter tree, `encode`, `forward_encdec`, `model_loss` (and its grads),
`lm_prefill` + `lm_decode_step` with `enc_out`, greedy `generate(enc_out=)`
and the serving CLI on the CPU.

Both sides start from the same weights (a JAX `init_model` tree converted
with `from_jax_params`) and run in float64. The reference computes its
norms in float32 even then (ROADMAP queue 3), and XLA and PyTorch round
those float32 islands differently by an ulp, so the islands are held at a
few float32 ulps, the model end to end at 1e-5 in the logits (the
tolerance measured for the qwen3 smoke model), and the greedy tokens
exactly. The JAX side runs its Pallas kernels in interpret mode
(`REPRO_DECODE_KERNEL=1` for the decode-state ones).
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
from repro.launch.serve import generate as jgenerate  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.attention import AttentionSpec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.param import from_jax_params  # noqa: E402
from torch_threads import share_cores  # noqa: F401,E402

E2E_TOL = 1e-5      # float32 islands computed by each framework
ISLAND_TOL = 2e-6   # a few float32 ulps at unit scale
F64 = dict(param_dtype="float64", activ_dtype="float64")
B, PLEN, NDEC = 2, 21, 6   # prompt spans two chunks of 16
ATTNS = ["fastmax2-chunked", "fastmax2-kernel"]


@pytest.fixture(autouse=True)
def decode_kernel_env(monkeypatch):
    monkeypatch.setenv("REPRO_DECODE_KERNEL", "1")


def _configs(attn):
    jcfg = dataclasses.replace(jsmoke("whisper-small"),
                               attn=JSpec.parse(attn), **F64)
    tcfg = dataclasses.replace(get_smoke_config("whisper-small"),
                               attn=AttentionSpec.parse(attn), **F64)
    return jcfg, tcfg


def _params(jcfg, tcfg):
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg)
    return jparams, from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                    "cpu")


def _frames(seed, cfg):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.encoder_seq, cfg.d_model))


def _close(a, t, tol):
    np.testing.assert_allclose(np.asarray(a), t.detach().numpy(), rtol=tol,
                               atol=tol)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_layernorm_matches_jax_float32_island():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 64)) * 3 + 1
    scale, bias = rng.normal(size=(64,)), rng.normal(size=(64,))
    for dtype in (np.float64, np.float32):
        xx = x.astype(dtype)
        j = JL.apply_norm({"scale": jnp.asarray(scale),
                           "bias": jnp.asarray(bias)}, jnp.asarray(xx),
                          norm_type="layernorm")
        t = TL.apply_norm({"scale": torch.tensor(scale),
                           "bias": torch.tensor(bias)}, torch.tensor(xx),
                          norm_type="layernorm")
        assert np.asarray(j).dtype == t.numpy().dtype
        np.testing.assert_allclose(np.asarray(j), t.numpy(),
                                   rtol=ISLAND_TOL, atol=ISLAND_TOL)


def test_gelu_mlp_matches_jax():
    """The reference's jax.nn.gelu is the tanh approximation; no float32
    island here, so float64 agrees to rounding."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 16)) * 2
    wi, wo = rng.normal(size=(16, 32)), rng.normal(size=(32, 16))
    j = JL.apply_mlp({"wi": jnp.asarray(wi), "wo": jnp.asarray(wo)},
                     jnp.asarray(x), act="gelu")
    t = TL.apply_mlp({"wi": torch.tensor(wi), "wo": torch.tensor(wo)},
                     torch.tensor(x), act="gelu")
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=1e-12,
                               atol=1e-12)
    # and not the exact (erf) GELU: the two differ by ~1e-3 at |x| ~ 2
    exact = torch.einsum("bnf,fd->bnd", torch.nn.functional.gelu(
        torch.einsum("bnd,df->bnf", torch.tensor(x), torch.tensor(wi))),
        torch.tensor(wo))
    assert (exact - t).abs().max() > 1e-4


def test_sinusoidal_matches_jax():
    j = JT._sinusoidal(40, 64, jnp.float32)
    t = TT._sinusoidal_at(torch.arange(40, dtype=torch.float32), 64,
                          torch.float32)
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=ISLAND_TOL,
                               atol=ISLAND_TOL)
    # at given positions (the decode form): rows `pos` of the table
    at = TT._sinusoidal_at(torch.tensor([3.0, 39.0]), 64, torch.float32)
    torch.testing.assert_close(at, t[[3, 39]], rtol=0, atol=0)


def test_from_jax_params_keeps_the_encdec_tree():
    jcfg, tcfg = _configs("fastmax2-kernel")
    jparams, tparams = _params(jcfg, tcfg)
    assert sorted(tparams) == ["decoder", "encoder"]
    jflat = _flatten(jax.tree.map(np.asarray, jparams))
    tflat = _flatten(tparams)
    assert sorted(jflat) == sorted(tflat)
    assert "/encoder/embed" not in tflat and "/decoder/embed" in tflat
    assert tflat["/decoder/blocks_0/cross/wq"].shape[0] == tcfg.n_layers
    for k, v in jflat.items():
        assert tflat[k].dtype == torch.float64
        np.testing.assert_array_equal(v, tflat[k].numpy())


def test_torch_init_matches_jax_tree_shapes():
    """The port's own initializer builds the JAX tree's layout and scales
    for both towers (LayerNorm scale ones, bias zeros)."""
    jcfg, tcfg = _configs("fastmax2-kernel")
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg)
    jflat = _flatten(jax.tree.map(np.asarray, jparams))
    tflat = _flatten(TM.init_model(tcfg, seed=0, device="cpu"))
    assert sorted(jflat) == sorted(tflat)
    for k, v in jflat.items():
        t = tflat[k].numpy()
        assert v.shape == t.shape, k
        if "norm" in k:
            want = np.zeros_like(t) if k.endswith("bias") else np.ones_like(t)
            np.testing.assert_array_equal(t, want)
        else:   # std within 15% of the reference's draw
            assert abs(t.std() / v.std() - 1) < 0.15, k


@pytest.mark.parametrize("attn", ATTNS)
def test_encode_and_forward_match_jax(attn):
    """Encoder hidden states, decoder logits of `forward_encdec`, and the
    model's loss."""
    jcfg, tcfg = _configs(attn)
    jparams, tparams = _params(jcfg, tcfg)
    frames = _frames(0, jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, PLEN))
    jh = JE.encode(jparams, jnp.asarray(frames), jcfg)
    jlog, _ = JE.forward_encdec(jparams, {"frames": jnp.asarray(frames),
                                          "tokens": jnp.asarray(toks)}, jcfg)
    jloss, _ = JM.model_loss(jparams, {"frames": jnp.asarray(frames),
                                       "tokens": jnp.asarray(toks)}, jcfg)
    batch = {"frames": torch.tensor(frames), "tokens": torch.as_tensor(toks)}
    with torch.no_grad():
        th = TE.encode(tparams, batch["frames"], tcfg)
        tlog, _ = TM.model_forward(tparams, batch, tcfg)
        tloss, _ = TM.model_loss(tparams, batch, tcfg)
    assert tuple(th.shape) == (B, tcfg.encoder_seq, tcfg.d_model)
    _close(jh, th, E2E_TOL)
    _close(jlog, tlog, E2E_TOL)
    _close(jloss, tloss, E2E_TOL)


def test_model_loss_grads_match_jax():
    """Every leaf's grad of the loss on the kernel path (the noncausal op's
    backward is autograd of the plain moment path on both sides), relative
    to the leaf's grad scale."""
    jcfg, tcfg = _configs("fastmax2-kernel")
    jparams, tparams = _params(jcfg, tcfg)
    frames = _frames(3, jcfg)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, PLEN))
    jg = jax.grad(lambda p: JM.model_loss(
        p, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)},
        jcfg)[0])(jparams)
    leaves = _flatten(tparams)
    for x in leaves.values():
        x.requires_grad_(True)
    loss, _ = TM.model_loss(tparams, {"frames": torch.tensor(frames),
                                      "tokens": torch.as_tensor(toks)}, tcfg)
    tg = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    for k, a in _flatten(jax.tree.map(np.asarray, jg)).items():
        s = max(1e-3, np.abs(a).max())
        np.testing.assert_allclose(a / s, tg[k].numpy() / s, rtol=0,
                                   atol=E2E_TOL, err_msg=k)


@pytest.mark.parametrize("attn", ATTNS)
def test_prefill_and_decode_logits_match_jax(attn):
    jcfg, tcfg = _configs(attn)
    jparams, tparams = _params(jcfg, tcfg)
    frames = _frames(5, jcfg)
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, jcfg.vocab_size, (B, PLEN))
    jenc = JE.encode(jparams, jnp.asarray(frames), jcfg)
    jdec = jparams["decoder"]
    jstate = JT.init_lm_decode_state(jcfg, B, PLEN + NDEC)
    jlog, jstate = jax.jit(lambda p, t, s, e: JT.lm_prefill(
        p, t, jcfg, s, enc_out=e))(jdec, jnp.asarray(prompts), jstate, jenc)
    jstep = jax.jit(lambda p, s, t, pos, e: JT.lm_decode_step(
        p, s, t, jcfg, position=pos, enc_out=e))

    tstate = TT.init_lm_decode_state(tcfg, B, PLEN + NDEC, device="cpu")
    with torch.inference_mode():
        tenc = TE.encode(tparams, torch.tensor(frames), tcfg)
        tlog, tstate = TT.lm_prefill(tparams["decoder"],
                                     torch.as_tensor(prompts), tcfg, tstate,
                                     enc_out=tenc)
    _close(jlog, tlog, E2E_TOL)
    toks = rng.integers(0, jcfg.vocab_size, (NDEC, B))
    for i in range(NDEC):
        jl, jstate = jstep(jdec, jstate, jnp.asarray(toks[i]),
                           jnp.asarray(PLEN + i, jnp.int32), jenc)
        with torch.inference_mode():
            tl, tstate = TT.lm_decode_step(
                tparams["decoder"], tstate, torch.as_tensor(toks[i]), tcfg,
                position=torch.tensor(PLEN + i), enc_out=tenc)
        _close(jl, tl, E2E_TOL)


def test_resumed_prefill_matches_jax():
    """A prompt prefilled in two pieces, the second at `offset` (its
    sinusoidal term starts there), against the reference's."""
    jcfg, tcfg = _configs("fastmax2-kernel")
    jparams, tparams = _params(jcfg, tcfg)
    frames = _frames(7, jcfg)
    prompts = np.random.default_rng(8).integers(0, jcfg.vocab_size,
                                                (B, PLEN))
    cut = 13
    jenc = JE.encode(jparams, jnp.asarray(frames), jcfg)
    jst = JT.init_lm_decode_state(jcfg, B, PLEN)
    _, jst = JT.lm_prefill(jparams["decoder"], jnp.asarray(prompts[:, :cut]),
                           jcfg, jst, enc_out=jenc)
    jlog, _ = JT.lm_prefill(jparams["decoder"], jnp.asarray(prompts[:, cut:]),
                            jcfg, jst, enc_out=jenc,
                            offset=jnp.asarray(cut, jnp.int32))
    tst = TT.init_lm_decode_state(tcfg, B, PLEN, device="cpu")
    with torch.inference_mode():
        tenc = TE.encode(tparams, torch.tensor(frames), tcfg)
        TT.lm_prefill(tparams["decoder"], torch.as_tensor(prompts[:, :cut]),
                      tcfg, tst, enc_out=tenc)
        tlog, _ = TT.lm_prefill(tparams["decoder"],
                                torch.as_tensor(prompts[:, cut:]), tcfg, tst,
                                enc_out=tenc, offset=cut)
    _close(jlog, tlog, E2E_TOL)


@pytest.mark.parametrize("attn", ATTNS)
def test_generate_tokens_match_jax(attn):
    jcfg, tcfg = _configs(attn)
    jparams, tparams = _params(jcfg, tcfg)
    frames = _frames(9, jcfg)
    prompts = np.random.default_rng(10).integers(0, jcfg.vocab_size,
                                                 (B, PLEN))
    jenc = JE.encode(jparams, jnp.asarray(frames), jcfg)
    want = jgenerate(jparams, jcfg, jnp.asarray(prompts), NDEC, enc_out=jenc)
    ops.reset_launch_counts()
    with torch.inference_mode():
        tenc = TE.encode(tparams, torch.tensor(frames), tcfg)
    got = TSV.generate(tparams, tcfg, torch.as_tensor(prompts), NDEC,
                       enc_out=tenc, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # CPU tensors take the plain versions: no kernel launches
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("kind", ["int", "scalar tensor", "per-sequence"])
def test_decode_position_forms_agree(kind):
    """A decode position given as an int, a 0-d tensor or a [B] tensor
    gives the same logits (the sinusoidal term is read at it)."""
    _, tcfg = _configs("fastmax2-kernel")
    params = TM.init_model(tcfg, seed=0, device="cpu")
    enc = torch.randn(B, tcfg.encoder_seq, tcfg.d_model, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(0))
    tok = torch.as_tensor([3, 7])
    pos = {"int": PLEN, "scalar tensor": torch.tensor(PLEN),
           "per-sequence": torch.full((B,), PLEN)}[kind]
    out = []
    for p in (PLEN, pos):
        st = TT.init_lm_decode_state(tcfg, B, PLEN + 1, device="cpu")
        with torch.inference_mode():
            logits, _ = TT.lm_decode_step(params["decoder"], st, tok, tcfg,
                                          position=p, enc_out=enc)
        out.append(logits)
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)


def test_serve_cli_runs_whisper_smoke_on_cpu(capsys):
    TSV.main(["--arch", "whisper-small", "--smoke", "--device", "cpu",
              "--attn", "fastmax2-kernel", "--batch", "2", "--prompt-len",
              "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "encoded (2, 16, 64) frames" in out
    assert "generated (2, 4)" in out
