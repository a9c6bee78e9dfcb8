"""Port parity of the six attention-only architectures added beside
qwen3-1.7b and whisper-small: llama3-405b, qwen2.5-32b (QKV bias),
granite-20b (one kv head), chameleon-34b (qk_norm), deepseek-v2-236b (MLA,
a dense first block, MoE with a shared expert) and kimi-k2-1t-a32b (GQA,
a dense first block, MoE). Each smoke config runs in float64 with the
same weights on both sides (a JAX `init_lm` tree converted with
`from_jax_params`), on `fastmax2-kernel` in the port (the kernels' plain
versions on the CPU) and the reference's chunked scan.

The reference computes its norms, RoPE and the MoE router in float32 even
in a float64 model (see `tests/test_torch_model.py` and
`tests/test_torch_moe.py`), so the logits are held at 1e-5 end to end, the
aux at float32 rounding, and the greedy tokens exactly.
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
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.param import count_params, from_jax_params  # noqa
from torch_threads import share_cores  # noqa: F401,E402

NEW = ["llama3-405b", "qwen2.5-32b", "granite-20b", "chameleon-34b",
       "deepseek-v2-236b", "kimi-k2-1t-a32b"]
E2E_TOL = 1e-5
AUX_TOL = 2e-6          # relative: a float32 value in the reference
F64 = dict(param_dtype="float64", activ_dtype="float64")
B, PLEN, NDEC = 2, 21, 4   # the prompt spans two chunks of 16


def _configs(arch):
    jcfg = dataclasses.replace(jsmoke(arch), **F64,
                               attn=JSpec.parse("fastmax2-chunked"))
    tcfg = dataclasses.replace(get_smoke_config(arch), **F64,
                               attn=AttentionSpec.parse("fastmax2-kernel"))
    return jcfg, tcfg


_CACHE = {}


def _params(arch):
    if arch not in _CACHE:
        jcfg, tcfg = _configs(arch)
        jp, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
        _CACHE[arch] = (jcfg, tcfg, jp, from_jax_params(
            jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return _CACHE[arch]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in _flat(tree).items()}


def test_registry_lists_the_ported_archs():
    """All ten architectures are ported (the SSM slice added xlstm-1.3b
    and jamba-v0.1-52b); an unknown name raises."""
    assert set(NEW) | {"qwen3-1.7b", "whisper-small", "xlstm-1.3b",
                       "jamba-v0.1-52b"} == set(ARCH_IDS)
    for arch in ("xlstm-1.3b", "jamba-v0.1-52b"):
        assert get_smoke_config(arch).name == arch
    with pytest.raises(KeyError):
        get_smoke_config("no-such-arch")


@pytest.mark.parametrize("arch", NEW)
def test_init_tree_matches_jax_abstract(arch):
    """The port's own initializer builds the reference's tree at the full
    config's shapes (on the meta device) and at the smoke config's."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config

    for jcfg, tcfg in ((jget(arch), get_config(arch)), _configs(arch)):
        jshapes = _shapes(JT.init_lm(jax.random.PRNGKey(0), jcfg,
                                     abstract=True)[0])
        tparams = TT.init_lm(tcfg, device="meta")
        assert _shapes(tparams) == jshapes
        assert count_params(tparams) == sum(
            int(np.prod(s)) for s in jshapes.values())


@pytest.mark.parametrize("arch", NEW)
def test_forward_logits_and_aux_match_jax(arch):
    jcfg, tcfg, jp, tp = _params(arch)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, PLEN))
    jlog, jaux = jax.jit(lambda p, t: JT.forward_lm(p, t, jcfg))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        tlog, taux = TT.forward_lm(tp, torch.as_tensor(toks), tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=E2E_TOL,
                               atol=E2E_TOL)
    assert taux.dtype == torch.float32
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=AUX_TOL,
                               atol=0)
    assert (float(taux) > 0) == (tcfg.n_experts > 0)


@pytest.mark.parametrize("arch", NEW)
def test_prefill_decode_logits_and_tokens_match_jax(arch):
    """lm_prefill then NDEC lm_decode_steps (logits at 1e-5), then greedy
    `generate()` against the reference's greedy loop on the same prompts
    (tokens equal)."""
    jcfg, tcfg, jp, tp = _params(arch)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, jcfg.vocab_size, (B, PLEN))
    jst = JT.init_lm_decode_state(jcfg, B, PLEN + NDEC)
    jlog, jst = jax.jit(lambda p, t, s: JT.lm_prefill(p, t, jcfg, s))(
        jp, jnp.asarray(prompts), jst)
    tst = TT.init_lm_decode_state(tcfg, B, PLEN + NDEC, device="cpu")
    assert sorted(tst) == sorted(jst)
    with torch.inference_mode():
        tlog, tst = TT.lm_prefill(tp, torch.as_tensor(prompts), tcfg, tst)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=E2E_TOL,
                               atol=E2E_TOL)
    jstep = jax.jit(lambda p, s, t, pos: JT.lm_decode_step(
        p, s, t, jcfg, position=pos))
    tok = np.argmax(np.asarray(jlog[:, -1]), axis=-1)
    want = [tok]
    for i in range(NDEC):
        jl, jst = jstep(jp, jst, jnp.asarray(tok, jnp.int32),
                        jnp.asarray(PLEN + i, jnp.int32))
        with torch.inference_mode():
            tl, tst = TT.lm_decode_step(tp, tst, torch.as_tensor(tok), tcfg,
                                        position=PLEN + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=E2E_TOL,
                                   atol=E2E_TOL)
        tok = np.argmax(np.asarray(jl), axis=-1)
        want.append(tok)
    got = generate(tp, tcfg, torch.as_tensor(prompts), NDEC + 1,
                   device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))


def test_mixed_pattern_matches_jax():
    """A pattern of two blocks ("attn:moe", "attn:mlp") after a dense
    first block: `blocks_0` and `blocks_1` stacked over two groups, run in
    the reference's order; forward and prefill + decode logits."""
    over = dict(n_layers=5, pattern=("attn:moe", "attn:mlp"))
    jcfg, tcfg = (dataclasses.replace(c, **over)
                  for c in _configs("kimi-k2-1t-a32b"))
    jp, _ = JT.init_lm(jax.random.PRNGKey(1), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    assert sorted(tp) == ["blocks_0", "blocks_1", "dense_0", "embed",
                          "final_norm", "unembed"]
    assert "router" in tp["blocks_0"]["ffn"] and \
        "router" not in tp["blocks_1"]["ffn"]
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, PLEN))
    jlog, jaux = JT.forward_lm(jp, jnp.asarray(toks), jcfg)
    jst = JT.init_lm_decode_state(jcfg, B, PLEN + 1)
    jpre, jst = JT.lm_prefill(jp, jnp.asarray(toks), jcfg, jst)
    jdec, _ = JT.lm_decode_step(jp, jst, jnp.asarray(toks[:, 0]), jcfg,
                                position=PLEN)
    tst = TT.init_lm_decode_state(tcfg, B, PLEN + 1, device="cpu")
    with torch.no_grad():
        tlog, taux = TT.forward_lm(tp, torch.as_tensor(toks), tcfg)
        tpre, tst = TT.lm_prefill(tp, torch.as_tensor(toks), tcfg, tst)
        tdec, _ = TT.lm_decode_step(tp, tst, torch.as_tensor(toks[:, 0]),
                                    tcfg, position=PLEN)
    for a, t in ((jlog, tlog), (jpre, tpre), (jdec, tdec)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=E2E_TOL,
                                   atol=E2E_TOL)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=AUX_TOL,
                               atol=0)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_loss_adds_the_aux_as_jax(arch):
    """lm_loss = nll + the MoE blocks' aux, as the reference's."""
    jcfg, tcfg, jp, tp = _params(arch)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, PLEN))
    jloss, jparts = JT.lm_loss(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    with torch.no_grad():
        tloss, tparts = TT.lm_loss(tp, {"tokens": torch.as_tensor(toks)},
                                   tcfg)
    assert float(tparts["aux"]) > 0
    torch.testing.assert_close(tloss, tparts["nll"] + tparts["aux"],
                               rtol=0, atol=0)
    for a, t in ((jloss, tloss), (jparts["nll"], tparts["nll"])):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=E2E_TOL,
                                   atol=E2E_TOL)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_moe_checkpoint_carries_across_both_ways(arch, tmp_path):
    """The `dense_0` + stacked `blocks_0` tree with its MoE and MLA leaves
    keeps the reference's paths: a JAX checkpoint of the params loads in
    the port and the port's loads in JAX, bit for bit."""
    from repro import ckpt as JC
    from repro_torch.ckpt import load_checkpoint, save_checkpoint

    _, tcfg, jp, tp = _params(arch)
    JC.save_checkpoint(str(tmp_path / "j"), 1, jp)
    like = TT.init_lm(tcfg, device="cpu")
    tree, step, _ = load_checkpoint(str(tmp_path / "j"), like)
    assert step == 1 and _shapes(tree) == _shapes(tp)
    for key, t in _flat(tree).items():
        torch.testing.assert_close(t, _flat(tp)[key], rtol=0, atol=0)
    save_checkpoint(str(tmp_path / "t"), 1, tree)
    back, step, _ = JC.load_checkpoint(str(tmp_path / "t"), jp)
    assert step == 1
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def test_engine_tokens_equal_generate(arch):
    """The serving engine (a slot pool holding the `dense_0` state [B, ...]
    beside the stacked `blocks_0` [n_groups, B, ...]; chunked prefill,
    staggered admissions) gives each request `generate()`'s tokens at
    batch 1."""
    from repro_torch.serve import ServeEngine

    _, tcfg, _, tp = _params(arch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n in (21, 9, 30)]
    eng = ServeEngine(tp, tcfg, max_slots=2, max_len=40, chunk=16)
    rids = [eng.submit(p, max_new_tokens=5) for p in prompts]
    out = eng.run()
    for rid, p in zip(rids, prompts):
        want = generate(tp, tcfg, torch.as_tensor(p)[None], 5, device="cpu")
        assert list(out[rid]) == want[0].tolist()
