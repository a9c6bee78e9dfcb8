"""Port parity of the two SSM architectures, jamba-v0.1-52b (Mamba and
attention mixers, MLP and MoE ffns) and xlstm-1.3b (mLSTM and sLSTM, no
ffn), and of the registry: the port lists all ten of the reference's
architectures and builds each full config on the `meta` device.

The smoke models run in float64 with the same weights on both sides (the
port's `init_lm` tree handed to JAX as arrays), on
`fastmax2-kernel` in the port (the kernels' plain versions on the CPU)
and the reference's chunked scan. The reference computes its norms, the
MoE router and the SSM mixers' gates and states in float32 even in a
float64 model (`tests/test_torch_mamba.py`, `tests/test_torch_xlstm.py`),
so the logits and the loss are held at E2E_TOL = 1e-5, the grads at
GRAD_TOL of each leaf's scale, and the greedy tokens exactly. GRAD_TOL is
ten times the MoE tests' (1e-5 of scale, a float32 router only): here
every gate and recurrent state is float32, and the grads of the
weights drawn from seeds 0-2 differ by up to 2.3e-5 of their scale. The
xLSTM function is ill-conditioned where a head's output variance falls
below the head-wise norm's epsilon 1e-6 (seed 3: 2.6e-7 in block 5, whose
float32 scan rounding the norm then amplifies ~900 times in both
packages, 2.5e-4 in the logits); that is the reference's own float32
island, recorded in ROADMAP queue 3, not held here. The input
gates' biases (mLSTM's and sLSTM's `bi`) get no gradient in exact
arithmetic: the output is invariant to a common scale of a head's input
gates wherever its normalizer is at least 1 (mLSTM's max(|den|, 1),
sLSTM's stabilized n), so their grads (1e-9 to 1e-6, against 0.4 for
the largest leaf) are the rounding of the other terms. Each leaf's scale
is therefore at least GRAD_FLOOR of the largest leaf's. The
serving engine has no JAX counterpart here (the reference's own SSM
engine test takes about two minutes and is marked slow): the port's
engine is held to the port's `generate()`.
"""
import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.attention import AttentionSpec as JSpec  # noqa: E402
from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.attention import AttentionSpec  # noqa: E402
from repro_torch.attention.state import state_leaves  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.param import count_params  # noqa: E402
from torch_threads import share_cores  # noqa: F401,E402

SSM = ["jamba-v0.1-52b", "xlstm-1.3b"]
E2E_TOL = 1e-5
GRAD_TOL = 1e-4         # of each leaf's scale: float32 islands
GRAD_FLOOR = 1e-2       # a leaf's scale is at least this of the largest
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
    """(JAX config, port config, JAX params, port params): one set of
    float64 weights, drawn by the port's initializer and handed to JAX as
    arrays (the reference's `init_lm` would compile a vmap per stacked
    block; the trees are the same, `test_init_tree_matches_jax_abstract`)."""
    if arch not in _CACHE:
        jcfg, tcfg = _configs(arch)
        tp = TT.init_lm(tcfg, seed=0, device="cpu")
        _CACHE[arch] = (jcfg, tcfg, _to_jax(tp), tp)
    return _CACHE[arch]


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in _flat(tree).items()}


def test_registry_lists_all_ten_archs():
    assert ARCH_IDS == JARCH_IDS


@pytest.mark.parametrize("arch", sorted(JARCH_IDS))
def test_every_full_config_builds_on_meta(arch):
    """`_check_supported` refuses none of the reference's full configs:
    the parameters (as many as the reference's abstract tree) and the
    decode state build on the meta device."""
    cfg = get_config(arch)
    params = TT.init_lm(cfg, device="meta")
    jshapes = _shapes(JT.init_lm(jax.random.PRNGKey(0), jget(arch),
                                 abstract=True)[0])
    assert count_params(params) == sum(int(np.prod(s))
                                       for s in jshapes.values())
    state = TT.init_lm_decode_state(cfg, 2, 64, device="meta")
    assert sorted(state) == sorted(k for k in params if k.startswith(
        ("dense_", "blocks_")))


@pytest.mark.parametrize("arch", SSM)
def test_init_tree_matches_jax_abstract(arch):
    """The port's initializer builds the reference's tree, leaf for leaf,
    at the full config's shapes (on the meta device) and the smoke's."""
    for jcfg, tcfg in ((jget(arch), get_config(arch)), _configs(arch)):
        jshapes = _shapes(JT.init_lm(jax.random.PRNGKey(0), jcfg,
                                     abstract=True)[0])
        assert _shapes(TT.init_lm(tcfg, device="meta")) == jshapes


@pytest.mark.parametrize("arch", SSM)
def test_forward_loss_and_grads_match_jax(arch):
    """forward_lm's logits and aux, lm_loss, and its grads leaf by leaf."""
    jcfg, tcfg, jp, tp = _params(arch)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, PLEN))
    jlog, jaux = jax.jit(lambda p, t: JT.forward_lm(p, t, jcfg))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        tlog, taux = TT.forward_lm(tp, torch.as_tensor(toks), tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=E2E_TOL,
                               atol=E2E_TOL)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=2e-6,
                               atol=0)
    assert (float(taux) > 0) == (tcfg.n_experts > 0)

    batch = {"tokens": jnp.asarray(toks)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, batch, jcfg), has_aux=True))(jp)
    leaves = _flat(tp)
    for x in leaves.values():
        x.requires_grad_(True)
    tloss, _ = TT.lm_loss(tp, {"tokens": torch.as_tensor(toks)}, tcfg)
    tgrads = torch.autograd.grad(tloss, list(leaves.values()))
    for x in leaves.values():
        x.requires_grad_(False)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=E2E_TOL,
                               atol=E2E_TOL)
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    assert sorted(jflat) == sorted(leaves)
    top = max(np.abs(g).max() for g in jflat.values())
    for (name, _), g in zip(leaves.items(), tgrads):
        want = jflat[name]
        scale = max(np.abs(want).max(), GRAD_FLOOR * top)
        err = np.abs(g.numpy() - want).max() / scale
        assert err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("arch", SSM)
def test_prefill_decode_logits_and_tokens_match_jax(arch):
    """lm_prefill then NDEC lm_decode_steps (logits at E2E_TOL), then
    greedy `generate()` against the reference's greedy loop on the same
    prompts (tokens equal)."""
    jcfg, tcfg, jp, tp = _params(arch)
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                                (B, PLEN))
    jst = JT.init_lm_decode_state(jcfg, B, PLEN + NDEC)
    jlog, jst = jax.jit(lambda p, t, s: JT.lm_prefill(p, t, jcfg, s))(
        jp, jnp.asarray(prompts), jst)
    tst = TT.init_lm_decode_state(tcfg, B, PLEN + NDEC, device="cpu")
    assert sorted(tst) == sorted(jst)
    for key in tst:      # each block's state type, leaf shapes, dtypes
        assert type(tst[key]).__name__ == type(jst[key]).__name__
        assert [(tuple(a.shape), str(a.dtype)[6:])
                for a in state_leaves(tst[key])] == [
                    (a.shape, str(a.dtype)) for a in jax.tree.leaves(
                        jst[key])]
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


@pytest.mark.parametrize("arch", SSM)
def test_engine_tokens_equal_generate(arch):
    """The serving engine on the traffic of the reference's SSM engine
    test (`tests/test_serve.py::test_engine_parity_ssm_mixers`): 2 slots,
    ragged prompts of 33 and 17 tokens (the last chunks at their own
    length, 1 and 1 tokens past chunks of 16), the second submitted two
    ticks later, 5 new tokens; each request gets `generate()`'s tokens. A
    slot mid-prefill keeps its SSM state across the other's decode ticks
    (the engine's save and restore)."""
    from repro_torch.serve import ServeEngine

    _, tcfg, _, tp = _params(arch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n in (33, 17)]
    eng = ServeEngine(tp, tcfg, max_slots=2, max_len=64, chunk=16)
    rids, outs = [eng.submit(prompts[0], 5)], {}
    for _ in range(2):
        outs.update({f.rid: f.tokens for f in eng.step()})
    rids.append(eng.submit(prompts[1], 5))
    outs.update(eng.run())
    for rid, p in zip(rids, prompts):
        want = generate(tp, tcfg, torch.as_tensor(p)[None], 5, max_len=64,
                        device="cpu")
        assert list(outs[rid]) == want[0].tolist()


def test_prefix_cache_snapshots_the_ssm_states():
    """With a prefix cache, the engine snapshots each slot's Mamba,
    attention and conv states at chunk boundaries; a later request that
    shares a 32-token prefix resumes from the snapshot (a hit) and still
    gets `generate()`'s tokens; the snapshot is a copy, unchanged by the
    ticks after it."""
    from repro_torch.serve import ServeEngine

    _, tcfg, _, tp = _params("jamba-v0.1-52b")
    rng = np.random.default_rng(5)
    shared = rng.integers(0, tcfg.vocab_size, 32)
    prompts = [np.concatenate([shared, rng.integers(0, tcfg.vocab_size, n)])
               for n in (9, 4)]
    eng = ServeEngine(tp, tcfg, max_slots=1, max_len=64, chunk=16,
                      prefix_cache_bytes=1 << 24)
    rid0 = eng.submit(prompts[0], 4)
    out = eng.run()
    _, snap = eng.prefix_cache.lookup(prompts[1])
    kept = [t.clone() for t in state_leaves(snap)]
    rid1 = eng.submit(prompts[1], 4)
    out.update(eng.run())
    assert eng.prefix_cache.hits >= 1
    for rid, p in ((rid0, prompts[0]), (rid1, prompts[1])):
        want = generate(tp, tcfg, torch.as_tensor(p)[None], 4, max_len=64,
                        device="cpu")
        assert list(out[rid]) == want[0].tolist()
    for a, b in zip(state_leaves(snap), kept):
        assert torch.equal(a, b)
    kinds = {type(v).__name__ for v in snap.values()}
    assert kinds == {"MambaState", "AttnState"}


def test_ssm_state_is_slot_pooled():
    """Every new leaf has exactly one slot axis (axis 1 of a stacked
    leaf), `decode_state_bytes` counts them, and a slot resets to each
    leaf's fresh value (sLSTM's m to -1e9)."""
    from repro_torch.core.decode_state import decode_state_bytes
    from repro_torch.serve.slots import SlotManager

    for arch in SSM:
        _, tcfg, _, _ = _params(arch)
        pool = SlotManager(tcfg, 3, 40, device="cpu")
        leaves, axes = state_leaves(pool.state), state_leaves(pool.axes)
        assert set(axes) == {1}
        assert decode_state_bytes(tcfg, 3, 40) == sum(
            t.numel() * t.element_size() for t in leaves)
        for t in leaves:
            t.fill_(7.0)
        pool.reset(1)
        fresh = state_leaves(TT.init_lm_decode_state(tcfg, 3, 40,
                                                    device="cpu"))
        for t, f in zip(leaves, fresh):
            assert torch.equal(t[:, 1], f[:, 1])
            assert bool((t[:, 0] == 7.0).all())
    m = pool.state["blocks_7"].m
    assert m.dtype == torch.float32 and float(m[:, 1].max()) == float(
        np.float32(-1e9))


def test_kv_mask_with_an_ssm_mixer_raises():
    """Divergence from the reference, which drops a kv_mask silently in
    its SSM blocks (its engine never pads for them): the port raises, in
    the forward and in a prefill, and names the exact-length chunks."""
    for arch in SSM:
        _, tcfg, _, tp = _params(arch)
        toks = torch.zeros(1, 8, dtype=torch.int64)
        mask = torch.ones(1, 8)
        with pytest.raises(ValueError, match="exact-length chunks"):
            TT.forward_lm(tp, toks, tcfg, kv_mask=mask)
        st = TT.init_lm_decode_state(tcfg, 1, 8, device="cpu")
        with pytest.raises(ValueError, match="exact-length chunks"):
            TT.lm_prefill(tp, toks, tcfg, st, kv_mask=mask)


def test_jamba_checkpoint_carries_across_both_ways(tmp_path):
    """The jamba tree (Mamba's A_log and D beside the attention, MLP and
    MoE leaves) keeps the reference's paths: a JAX checkpoint of the
    params loads in the port and the port's loads in JAX, bit for bit."""
    from repro import ckpt as JC
    from repro_torch.ckpt import load_checkpoint, save_checkpoint

    _, tcfg, jp, tp = _params("jamba-v0.1-52b")
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


@pytest.mark.parametrize("arch", SSM)
def test_serve_and_train_clis_run_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve, train

    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                "2", "--prompt-len", "20", "--gen", "3"])
    assert "generated (2, 3)" in capsys.readouterr().out
    train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                "2", "--batch", "2", "--seq", "24"])
    assert "final loss" in capsys.readouterr().out
