"""Port parity of hybrid training and serving on the qwen3-1.7b smoke
config with `hybrid2-kernel` (window 64 clamped to the smoke chunk of 16):
the `attention()` dispatcher's forward and grads, `lm_loss` and every
leaf's grad, prefill and decode logits and greedy tokens against the JAX
package, the training forward's routing through the hybrid op, and the
training and serving CLIs on the CPU.

Both sides start from the same weights (a JAX `init_lm` tree converted
with `from_jax_params`), in float64. The reference computes its norms and
RoPE in float32 (ROADMAP queue 3), so the model-level comparisons hold
the float32-island tolerances of tests/test_torch_train.py and
tests/test_torch_model.py; the attention operator is held at 1e-10.
"""
import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import attention as JA  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import attention as TA  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import hybrid_causal as _hc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.param import from_jax_params  # noqa: E402
from torch_threads import share_cores  # noqa: F401,E402

TOL = 1e-10
# float32 islands in a float64 model (tests/test_torch_train.py,
# tests/test_torch_model.py): relative loss and per-leaf grad limits, and
# the end-to-end logit limit
LOSS_TOL = 1e-6
GRAD_TOL = 5e-6
E2E_LOGIT_TOL = 1e-5
F64 = dict(param_dtype="float64", activ_dtype="float64")
B, N = 2, 40      # spans three chunks of 16: the band crosses chunks
ATTN = "hybrid2-kernel"


def _rel(a, b):
    return np.abs(a - b).max() / max(1e-30, np.abs(b).max())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _setup(attn=ATTN, **over):
    jcfg = dataclasses.replace(jsmoke("qwen3-1.7b"),
                               attn=JA.AttentionSpec.parse(attn), **over)
    tcfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                               attn=TA.AttentionSpec.parse(attn), **over)
    jparams, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("attn", ["hybrid2-kernel", "hybrid1-kernel",
                                  "hybrid2-chunked"])
def test_attention_matches_jax_forward_and_grads(attn):
    rng = np.random.default_rng(12)
    q, k, v, do = (rng.normal(size=s) for s in (
        (2, 4, 21, 8), (2, 2, 21, 8), (2, 2, 21, 8), (2, 4, 21, 8)))
    jspec = JA.AttentionSpec.parse(attn, chunk_size=8, window=5)
    tspec = TA.AttentionSpec.parse(attn, chunk_size=8, window=5)
    jo = JA.attention(*map(jnp.asarray, (q, k, v)), jspec, causal=True)
    jg = jax.grad(lambda q_, k_, v_: jnp.sum(JA.attention(
        q_, k_, v_, jspec, causal=True) * do), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    to = TA.attention(tq, tk, tv, tspec, causal=True)
    tg = torch.autograd.grad(to, (tq, tk, tv), torch.tensor(do))
    np.testing.assert_allclose(np.asarray(jo), to.detach().numpy(),
                               rtol=TOL, atol=TOL)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=TOL,
                                   atol=TOL)


def test_lm_loss_and_every_grad_match_jax():
    jcfg, tcfg, jparams, tparams = _setup(**F64)
    batch = JSyntheticLM(jcfg.vocab_size, N, seed=1).batch(0, B)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, b, jcfg), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    flat_t = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}/{k}")
            else:
                v.requires_grad_(True)
                flat_t[f"{prefix}/{k}"] = v

    walk(tparams)
    tl, _ = TT.lm_loss(tparams, {k: torch.as_tensor(v)
                                 for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(tl, list(flat_t.values()))
    assert abs(float(jl) - tl.item()) <= LOSS_TOL * abs(float(jl))
    jflat = _flat(jax.tree.map(np.asarray, jg))
    assert sorted(jflat) == sorted(flat_t)
    for name, g in zip(flat_t, grads):
        assert _rel(g.numpy(), jflat[name]) <= GRAD_TOL, name


def test_training_forward_runs_the_hybrid_op_once_per_layer(monkeypatch):
    """Every layer's forward goes through the hybrid kernel's wrapper
    (twice under remat: forward and recompute), its backward through the
    band-extended §2.5 scan once, and no fastmax kernel wrapper runs."""
    _, tcfg, _, tparams = _setup()
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = _hc.hybrid_causal_ref, ops._hy.hybrid_bwd_scan

    def spy_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def spy_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    def no_fastmax(*a, **kw):
        raise AssertionError("a fastmax kernel wrapper ran")

    monkeypatch.setattr(_hc, "hybrid_causal_ref", spy_fwd)
    monkeypatch.setattr(ops._hy, "hybrid_bwd_scan", spy_bwd)
    monkeypatch.setattr(ops, "fastmax_prefill_kernel", no_fastmax)
    monkeypatch.setattr(ops, "fastmax_bwd", no_fastmax)
    batch = JSyntheticLM(tcfg.vocab_size, N, seed=1).batch(0, B)
    tparams["embed"].requires_grad_(True)
    ops.reset_launch_counts()
    loss, _ = TT.lm_loss(tparams, {k: torch.as_tensor(v)
                                   for k, v in batch.items()}, tcfg)
    torch.autograd.grad(loss, [tparams["embed"]])
    assert calls == {"fwd": 2 * tcfg.n_layers, "bwd": tcfg.n_layers}
    assert not any(ops.launch_counts().values())


def _decode_states(jcfg, tcfg, max_len):
    return (JT.init_lm_decode_state(jcfg, B, max_len),
            TT.init_lm_decode_state(tcfg, B, max_len, device="cpu"))


def test_prefill_and_decode_logits_match_jax():
    """Prefill (the plain hybrid scan) and 8 decode steps (moments plus the
    window correction) of the whole model."""
    jcfg, tcfg, jparams, tparams = _setup(**F64)
    prompts = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, 21))
    js, ts = _decode_states(jcfg, tcfg, 40)
    jl, js = JT.lm_prefill(jparams, jnp.asarray(prompts), jcfg, js)
    with torch.inference_mode():
        tl, ts = TT.lm_prefill(tparams, torch.as_tensor(prompts), tcfg, ts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               rtol=E2E_LOGIT_TOL, atol=E2E_LOGIT_TOL)
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
    for i in range(8):
        pos = 21 + i
        jl, js = JT.lm_decode_step(jparams, js, jnp.asarray(tok, jnp.int32),
                                   jcfg, position=jnp.asarray(pos))
        with torch.inference_mode():
            tl, ts = TT.lm_decode_step(tparams, ts, torch.tensor(tok),
                                       tcfg, position=pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=E2E_LOGIT_TOL, atol=E2E_LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1))
    window = ts["blocks_0"].kv
    assert window.k.shape[:4] == (tcfg.n_layers, B, tcfg.n_kv_heads, 16)
    np.testing.assert_array_equal(window.length.numpy(), 29)
    np.testing.assert_allclose(window.mask.numpy(),
                               np.asarray(js["blocks_0"].kv.mask))


def test_generate_tokens_match_jax():
    jcfg, tcfg, jparams, tparams = _setup(**F64)
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, 21))
    n_gen = 6
    jstate = JT.init_lm_decode_state(jcfg, B, 21 + n_gen)
    jlog, jstate = JT.lm_prefill(jparams, jnp.asarray(prompts), jcfg, jstate)
    tok = jnp.argmax(jlog[:, -1], axis=-1).astype(jnp.int32)
    want = [np.asarray(tok)]
    jstep = jax.jit(lambda p, s, t, pos: JT.lm_decode_step(
        p, s, t, jcfg, position=pos))
    for i in range(n_gen - 1):
        lg, jstate = jstep(jparams, jstate, tok,
                           jnp.asarray(21 + i, jnp.int32))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
    ops.reset_launch_counts()
    got = generate(tparams, tcfg, torch.as_tensor(prompts), n_gen,
                   device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))
    assert not any(ops.launch_counts().values())


def test_train_and_serve_clis_run_hybrid_on_cpu(capsys):
    from repro_torch.launch import serve, train

    _, losses = train.main(["--device", "cpu", "--smoke", "--attn", ATTN,
                            "--steps", "8", "--batch", "2", "--seq", "48",
                            "--lr", "3e-3", "--log-every", "4"])
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < losses[0]
    serve.main(["--device", "cpu", "--smoke", "--attn", ATTN, "--batch",
                "2", "--prompt-len", "20", "--gen", "4"])
    out = capsys.readouterr().out
    assert "attn=hybrid2/kernel/w64" in out and "generated (2, 4)" in out
