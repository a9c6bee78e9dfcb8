"""Port parity of the training slice on the qwen3-1.7b smoke config: the
`attention()` dispatcher (forward and grads), `lm_loss` and every leaf's
grad, the optimizers, schedules and clipping, the synthetic data stream,
three train steps from one state, and the training CLI on the CPU.

Both sides start from the same weights (a JAX `init_lm` tree converted
with `from_jax_params`) and, for the train steps, the same optimizer state
(a JAX `OptState` converted leaf by leaf). The model runs in float64 on
both sides, but the reference computes its norms and RoPE in float32
(ROADMAP queue 3), and XLA and PyTorch round those float32 islands
differently by an ulp, so the model-level comparisons hold relative
float32-level tolerances (stated with each test); the attention operator,
which has no float32 island, is held at 1e-10.
"""
import dataclasses

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import attention as JA  # noqa: E402
from repro import optim as JO  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import attention as TA  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.param import from_jax_params  # noqa: E402
from repro_torch.optim.grad_utils import leaves as leaves_of  # noqa: E402
from torch_threads import share_cores  # noqa: F401,E402

TOL = 1e-10
# lm_loss and grads: float32 islands (norms, RoPE) in a float64 model;
# measured max relative differences 6.7e-8 (loss) and 5.0e-7 (the worst
# leaf's grad, max |diff| / max |grad|) on this config
LOSS_TOL = 1e-6
GRAD_TOL = 5e-6
F64 = dict(param_dtype="float64", activ_dtype="float64")
B, N = 2, 24      # spans two chunks of 16


def _j(x):
    return jnp.asarray(x.detach().numpy())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach().numpy()
                               if isinstance(tree, torch.Tensor) else tree)}


def _rel(a, b):
    return np.abs(a - b).max() / max(1e-30, np.abs(b).max())


# ---------------------------------------------------------------------------
# attention()
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn", ["fastmax2-chunked", "fastmax2-kernel",
                                  "fastmax1-kernel"])
def test_attention_matches_jax_forward_and_grads(attn):
    rng = np.random.default_rng(11)
    q = rng.normal(size=(2, 4, 21, 8))
    k = rng.normal(size=(2, 2, 21, 8))
    v = rng.normal(size=(2, 2, 21, 8))
    do = rng.normal(size=(2, 4, 21, 8))
    jspec = JA.AttentionSpec.parse(attn, chunk_size=8)
    tspec = TA.AttentionSpec.parse(attn, chunk_size=8)

    def jloss(q, k, v):
        return jnp.sum(JA.attention(q, k, v, jspec, causal=True) * do)

    jo = jax.jit(lambda q, k, v: JA.attention(q, k, v, jspec, causal=True))(
        *map(jnp.asarray, (q, k, v)))
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    to = TA.attention(tq, tk, tv, tspec, causal=True)
    tg = torch.autograd.grad(to, (tq, tk, tv), torch.tensor(do))
    np.testing.assert_allclose(np.asarray(jo), to.detach().numpy(), rtol=TOL,
                               atol=TOL)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=TOL,
                                   atol=TOL)


def test_kernel_backend_refuses_a_mask_and_noncausal():
    """The kernel backend refuses a kv_mask, causal or noncausal (the
    reference drops a noncausal one silently); unmasked noncausal
    attention runs there, on CPU tensors through the plain version, and
    launches nothing."""
    q = torch.randn(1, 2, 8, 8)
    spec = TA.AttentionSpec.parse("fastmax2-kernel")
    for causal in (True, False):
        with pytest.raises(ValueError, match="fastmax2-chunked"):
            TA.attention(q, q, q, spec, causal=causal,
                         kv_mask=torch.ones(1, 2, 8))
    ops.reset_launch_counts()
    o = TA.attention(q, q, q, spec, causal=False)
    assert o.shape == q.shape and not any(ops.launch_counts().values())
    torch.testing.assert_close(
        o, TA.attention(q, q, q, TA.AttentionSpec.parse("fastmax2-chunked"),
                        causal=False), rtol=1e-6, atol=1e-6)
    # the chunked backend takes the mask (autograd through the plain scan)
    o = TA.attention(q, q, q, TA.AttentionSpec.parse("fastmax2-chunked"),
                     causal=True, kv_mask=torch.ones(1, 2, 8))
    assert o.shape == q.shape


# ---------------------------------------------------------------------------
# the model's loss and grads
# ---------------------------------------------------------------------------


def _setup(attn, **over):
    jcfg = dataclasses.replace(jsmoke("qwen3-1.7b"),
                               attn=JA.AttentionSpec.parse(attn), **over)
    tcfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                               attn=TA.AttentionSpec.parse(attn), **over)
    jparams, _ = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    batch = JSyntheticLM(jcfg.vocab_size, N, seed=1).batch(0, B)
    return jcfg, tcfg, jparams, tparams, batch


@pytest.mark.parametrize("attn", ["fastmax2-kernel"])
def test_lm_loss_and_every_grad_match_jax(attn):
    """(The chunked backend's loss and gnorm are held by the train-step
    test below.)"""
    jcfg, tcfg, jparams, tparams, batch = _setup(attn, **F64)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
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
    tl, tm = TT.lm_loss(tparams, {k: torch.as_tensor(v)
                                  for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(tl, list(flat_t.values()))
    assert abs(float(jl) - tl.item()) <= LOSS_TOL * abs(float(jl))
    assert abs(float(jm["nll"]) - tm["nll"].item()) <= LOSS_TOL * float(jl)
    jflat = _flat(jax.tree.map(np.asarray, jg))
    assert sorted(jflat) == sorted(flat_t)
    errs = {name: _rel(g.numpy(), jflat[name])
            for name, g in zip(flat_t, grads)}
    for name, e in errs.items():
        assert e <= GRAD_TOL, name


REMATS = ("full", "none", "dots")


@pytest.mark.parametrize("remat", REMATS)
def test_remat_full_and_none_give_the_same_grads(remat):
    """Each remat policy's grads against the next one's (full -> none ->
    dots -> full: every pair is held)."""
    _, tcfg, _, tparams, batch = _setup("fastmax2-kernel")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    leaves = [tparams["embed"], tparams["blocks_0"]["mixer"]["wq"],
              tparams["blocks_0"]["ffn"]["wo"]]
    for x in leaves:
        x.requires_grad_(True)
    out = []
    for r in (remat, REMATS[(REMATS.index(remat) + 1) % len(REMATS)]):
        cfg = dataclasses.replace(tcfg, remat=r)
        loss, _ = TT.lm_loss(tparams, tb, cfg)
        out.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_remat_dots_loss_and_grads_match_jax():
    """remat="dots" against the reference's (checkpoint_dots_with_no_batch_
    dims), every leaf, at the float32-island tolerances above."""
    jcfg, tcfg, jparams, tparams, batch = _setup("fastmax2-kernel",
                                                 remat="dots", **F64)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, b, jcfg), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    named = [(n, x.requires_grad_(True)) for n, x in leaves_of(tparams)]
    tl, _ = TT.lm_loss(tparams, {k: torch.as_tensor(v)
                                 for k, v in batch.items()}, tcfg)
    grads = torch.autograd.grad(tl, [x for _, x in named])
    assert abs(float(jl) - tl.item()) <= LOSS_TOL * abs(float(jl))
    jflat = _flat(jax.tree.map(np.asarray, jg))
    assert sorted(jflat) == sorted(f"/{n}" for n, _ in named)
    for (name, _), g in zip(named, grads):
        assert _rel(g.numpy(), jflat[f"/{name}"]) <= GRAD_TOL, name


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def test_remat_dots_keeps_the_projections_and_recomputes_the_kernels(
        monkeypatch):
    """The backward under remat="dots" runs exactly the aten.mm calls of
    remat="none" (the grads' own): no projection is recomputed, where
    "full" recomputes them. The kernel wrappers are recomputed all the
    same (their ctypes launches and torch.empty buffers are nothing the
    policy saves): 2 n_layers forward calls and n_layers backward ones,
    as under "full"."""
    _, tcfg, _, tparams, batch = _setup("fastmax2-kernel")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ops.fastmax_prefill_kernel, ops.fastmax_bwd

    def spy(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ops, "fastmax_prefill_kernel", spy("fwd", fwd))
    monkeypatch.setattr(ops, "fastmax_bwd", spy("bwd", bwd))
    leaves = [x.requires_grad_(True) for _, x in leaves_of(tparams)]
    mm, launches = {}, {}
    for remat in ("none", "full", "dots"):
        calls.update(fwd=0, bwd=0)
        loss, _ = TT.lm_loss(tparams, tb,
                             dataclasses.replace(tcfg, remat=remat))
        with _CountMM() as counter:
            torch.autograd.grad(loss, leaves)
        mm[remat], launches[remat] = counter.n, dict(calls)
    # 7 projections per layer (q, k, v, o, gate, up, down); the recompute
    # stops once the backward has what it needs, before the last one
    assert mm["dots"] == mm["none"]
    assert mm["full"] - mm["none"] >= 6 * tcfg.n_layers
    assert launches["dots"] == launches["full"] == {
        "fwd": 2 * tcfg.n_layers, "bwd": tcfg.n_layers}
    assert launches["none"] == {"fwd": tcfg.n_layers, "bwd": tcfg.n_layers}


def test_kernel_training_forward_runs_the_kernel_wrappers_once_per_layer(
        monkeypatch):
    """On the kernel backend every layer goes through `ops.fastmax` (its
    forward under remat twice: forward and recompute) and its backward
    through `ops.fastmax_bwd` once."""
    _, tcfg, _, tparams, batch = _setup("fastmax2-kernel")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ops.fastmax_prefill_kernel, ops.fastmax_bwd

    def spy_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def spy_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(ops, "fastmax_prefill_kernel", spy_fwd)
    monkeypatch.setattr(ops, "fastmax_bwd", spy_bwd)
    tparams["embed"].requires_grad_(True)
    loss, _ = TT.lm_loss(tparams, {k: torch.as_tensor(v)
                                   for k, v in batch.items()}, tcfg)
    torch.autograd.grad(loss, [tparams["embed"]])
    assert calls == {"fwd": 2 * tcfg.n_layers, "bwd": tcfg.n_layers}


# ---------------------------------------------------------------------------
# optimizers, schedules, clipping, data
# ---------------------------------------------------------------------------


def _tree(rng, dtype):
    shapes = {"blocks_0": {"mixer": {"wq": (3, 5, 7), "q_norm_scale": (7,)},
                           "norm1": {"scale": (11,)}},
              "embed": (300, 4)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return rng.normal(size=s).astype(dtype)
    return make(shapes)


def _to_torch(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, dtype=np.float64)).to(dtype)


def _to_jax(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), tree)


@pytest.mark.parametrize("kind", ["adamw", "adamw_int8", "adamw_bf16",
                                  "lion"])
def test_optimizers_match_jax_over_three_steps(kind):
    rng = np.random.default_rng(5)
    lr_j = JO.warmup_cosine(1e-2, 2, 10)
    lr_t = TO.warmup_cosine(1e-2, 2, 10)
    if kind == "lion":
        jopt, topt = JO.lion(lr_j), TO.lion(lr_t)
    else:
        int8 = kind == "adamw_int8"
        jopt, topt = JO.adamw(lr_j, int8_m=int8), TO.adamw(lr_t, int8_m=int8)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if kind == "adamw_bf16"
              else (jnp.float32, torch.float32))
    p0 = _tree(rng, np.float32)
    jp, tp = _to_jax(p0, jd), _to_torch(p0, td)
    js, ts = jopt[0](jp), topt[0](tp)
    assert (js.master is None) == (ts.master is None) == (kind != "adamw_bf16")
    for _ in range(3):
        g = _tree(rng, np.float32)
        jp, js = jopt[1](_to_jax(g, jd), js, jp)
        tp, ts = topt[1](_to_torch(g, td), ts, tp)
    assert int(js.step) == int(ts.step) == 3
    a = _flat(jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), jp))
    b = _flat(jax.tree.map(lambda x: x.float(), tp))
    # float32 sums in either framework: a few ulps
    tol = 1e-2 if kind == "adamw_bf16" else 2e-6
    for name in a:
        np.testing.assert_allclose(b[name], a[name], rtol=tol, atol=tol)
    if kind == "adamw_bf16":
        for name, x in _flat(jax.tree.map(np.asarray, js.master)).items():
            np.testing.assert_allclose(
                _flat(ts.master)[name], x, rtol=2e-6, atol=2e-6)


def test_clip_and_schedules_match_jax():
    rng = np.random.default_rng(6)
    g = _tree(rng, np.float32)
    jc, jn = JO.clip_by_global_norm(_to_jax(g, jnp.float32), 1.0)
    tc, tn = TO.clip_by_global_norm(_to_torch(g, torch.float32), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for name, x in _flat(jax.tree.map(np.asarray, jc)).items():
        np.testing.assert_allclose(_flat(tc)[name], x, rtol=1e-6, atol=1e-7)
    for sched in ((1e-3, 10, 100), (3e-4, 0, 6), (1.0, 5, 5)):
        jl, tl = JO.warmup_cosine(*sched), TO.warmup_cosine(*sched)
        for s in (0, 1, 4, 5, 9, 50, 100, 200):
            np.testing.assert_allclose(
                float(tl(torch.tensor(s, dtype=torch.int32))),
                float(jl(jnp.asarray(s, jnp.int32))), rtol=1e-6, atol=1e-9)
    assert float(TO.constant(0.5)(torch.tensor(3))) == 0.5


def test_synthetic_batches_equal_the_reference():
    for seed, n in ((0, 32), (3, 100)):
        j, t = JSyntheticLM(512, n, seed=seed), SyntheticLM(512, n, seed=seed)
        for step in (0, 1, 7):
            a, b = j.batch(step, 3), t.batch(step, 3)
            assert sorted(a) == sorted(b)
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


def test_memmap_batches_and_iterator_equal_the_reference(tmp_path):
    """A token file written by the port reads back as the reference's
    batches, per host, and the prefetching iterator yields them in step
    order from `start_step`."""
    from repro import data as JD
    from repro_torch import data as TD

    path = str(tmp_path / "tokens.bin")
    TD.write_token_file(path, np.random.default_rng(7).integers(
        0, 1000, size=5000))
    j, t = JD.MemmapDataset(path, 64), TD.MemmapDataset(path, 64)
    for step, host in ((0, 0), (3, 1), (40, 1)):
        a = j.batch(step, 4, host_id=host, host_count=2)
        b = t.batch(step, 4, host_id=host, host_count=2)
        for key in ("tokens", "targets"):
            np.testing.assert_array_equal(a[key], b[key])
    it = TD.make_batch_iterator(t, 4, start_step=5)
    try:
        for want in (5, 6, 7):
            step, batch = next(it)
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          j.batch(want, 4)["tokens"])
    finally:
        it.close()


# ---------------------------------------------------------------------------
# train steps and the CLI
# ---------------------------------------------------------------------------


def _opt_state_from_jax(js, like_params):
    """A JAX OptState converted leaf by leaf into the port's."""
    conv = (lambda tree: None if tree is None else jax.tree.map(
        lambda x: torch.from_numpy(np.array(x)), tree))
    return TO.OptState(torch.tensor(int(js.step), dtype=torch.int32),
                       conv(js.m), conv(js.v), conv(js.master))


def test_three_train_steps_match_jax():
    jcfg, tcfg, jparams, tparams, _ = _setup("fastmax2-chunked", **F64)
    n = sum(x.size for x in jax.tree.leaves(jparams))
    jname, jopt = JS.pick_optimizer(jcfg, n, lr=3e-3, total_steps=10)
    tname, topt = TS.pick_optimizer(tcfg, n, lr=3e-3, total_steps=10)
    assert jname == tname == "adamw"
    js = jopt[0](jparams)
    ts = _opt_state_from_jax(js, tparams)
    jstep = jax.jit(JS.make_train_step(jcfg, jopt))
    tstep = TS.make_train_step(tcfg, topt)
    data = JSyntheticLM(jcfg.vocab_size, N, seed=0)
    for step in range(3):
        batch = data.batch(step, B)
        jparams, js, jm = jstep(jparams, js,
                                {k: jnp.asarray(v) for k, v in batch.items()})
        tparams, ts, tm = tstep(tparams, ts, batch)
        for key in ("loss", "gnorm", "nll", "aux"):
            assert tm[key].dtype == torch.float32
            np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                       rtol=GRAD_TOL, atol=1e-9)
    a = _flat(jax.tree.map(np.asarray, jparams))
    b = _flat(tparams)
    # Adam steps are ~lr each; the float32 islands move them by far less
    for name in a:
        np.testing.assert_allclose(b[name], a[name], rtol=0, atol=1e-5,
                                   err_msg=name)


def test_train_cli_on_cpu_loss_starts_near_reference_and_falls(capsys):
    from repro_torch.launch import train

    _, losses = train.main(["--smoke", "--device", "cpu", "--steps", "16",
                            "--batch", "4", "--seq", "64", "--lr", "3e-3",
                            "--log-every", "4"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "gnorm" in out
    assert out.strip().splitlines()[-1].startswith("final loss")
    assert len(losses) == 16
    # ln(512) = 6.24; random init sits above it (the reference's smoke
    # run starts at 7.14 at seq 32)
    assert 6.5 < losses[0] < 7.5
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) - 0.3


def test_train_cli_asks_for_a_card_by_default(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--smoke", "--steps", "1"])
