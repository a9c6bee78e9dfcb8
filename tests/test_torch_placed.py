"""The placed step (`repro_torch.sharding.placed`, `launch/steps.py` with a
mesh) against the reference on the CPU.

- Gloo worlds of four ranks (`launch/ranks.py`), (data 2, model 2) and
  (data 1, model 4), float64: the smoke qwen3-1.7b (GQA: heads split at
  model 2, the feature plan at 4) and granite-20b (MQA: kv heads
  replicated) on fastmax2, fastmax2-kernel (the kernels' plain versions
  through the kernel plans) and softmax. Two AdamW steps against JAX's
  single-device `make_train_step` on the same weights and batch: each
  step's loss and gnorm and every parameter and AdamW moment, gathered
  whole, within TOL; prefill and NDEC greedy decode steps against the
  reference's `lm_prefill` / `lm_decode_step`: logits within TOL, and
  the tokens of the placed `make_prefill_step` / `make_serve_step`
  equal. The placement changes no precision, so both sides compute their
  float32 islands (norms, RoPE, the loss, the gradient norm, AdamW, the
  metrics, the reference's float32 scores and decode moments) in
  float64: the
  reference through a `jnp` whose `float32` is float64 in its modules
  (nothing in the JAX package changes), the ranks through
  `torch_placed_cases.lift_islands`.
- The smoke xlstm-1.3b on (2, 2), its leaves gathered over "data"
  around each layer and its mixers split over "model" by heads, against
  JAX's loss and grads at the float32-island limits of
  `tests/test_torch_ssm_archs.py` (islands lifted:
  `tests/test_torch_placed_ssm.py`).
- A checkpoint saved on (2, 2) restores bit for bit on (2, 2), on
  (1, 4) and on one process; the (2, 2) restore continues bit for bit
  with the unbroken run, the others within TOL of it (their sums run in
  other orders).
- Refusals: AdamW's int8 m, a mesh axis no rule names (the MoE
  configs: `tests/test_torch_placed_moe.py`).
- On a fake world of 8 ranks, (data 4, model 2), the smoke qwen3-1.7b
  softmax train step's per-device matmul flops equal the reference's
  `analyze_hlo` of its 4 x 2 partitioned module, compiled in a
  subprocess with 8 host devices; the port's all-gather, reduce-scatter
  and all-reduce each move bytes, and its kinds are the module's (where
  XLA's CPU partitioner reduces the FSDP grads by all-reduce then a
  slice, the port reduce-scatters).
- On meta, no more than two layers' gathered weights are alive at once
  in full-width qwen3's placed train step (forward and recompute).
"""
import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import textwrap
import threading
import weakref
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import torch_placed_cases as C  # noqa: E402
from repro import optim as JO  # noqa: E402
from repro.attention import AttentionSpec as JSpec  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.attention import AttentionSpec  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.launch.op_analysis import OpCount  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.optim import constant, make_optimizer  # noqa: E402
from repro_torch.sharding import placed as P  # noqa: E402
from torch_threads import share_cores  # noqa: F401,E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-10
B, N, PLEN, NDEC, MAX_LEN, STEPS = 4, 32, 20, 4, 32, 2
LR = 2.0 ** -7           # a float32 constant both schedules hold exactly
WORLDS = {"2x2": (2, 2), "1x4": (1, 4)}
DENSE = [(arch, attn) for arch in ("qwen3-1.7b", "granite-20b")
         for attn in ("fastmax2", "fastmax2-kernel", "softmax")]
# the xlstm case: tests/test_torch_ssm_archs.py's float32-island limits
E2E_TOL, GRAD_TOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-2


class _JnpFloat64:
    """`jax.numpy` with `float32` meaning float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def _reference_in_float64():
    """The reference's float32 islands in float64, for the code inside."""
    import importlib

    mods = [importlib.import_module(m) for m in (
        "repro.models.layers", "repro.models.transformer",
        "repro.models.moe", "repro.models.mamba", "repro.optim.grad_utils", "repro.optim.optimizers",
        "repro.core.softmax", "repro.core.fastmax",
        "repro.attention.state", "repro.launch.steps")]
    saved = [m.jnp for m in mods]
    for m in mods:
        m.jnp = _JnpFloat64()
    try:
        yield
    finally:
        for m, j in zip(mods, saved):
            m.jnp = j


def _jcfg(arch, attn):
    return dataclasses.replace(jsmoke(arch), attn=JSpec.parse(attn),
                               **C.F64)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """One set of float64 weights, drawn by the port, as numpy."""
    return C.as_numpy_tree(init_model(C.config(arch, "fastmax2"), seed=0,
                                      device="cpu"))


def _jtree(tree):
    if isinstance(tree, dict):
        return {k: _jtree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


@functools.lru_cache(maxsize=None)
def _batch():
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 512, (B, N), dtype=np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}


@functools.lru_cache(maxsize=None)
def _prompt():
    return np.random.default_rng(8).integers(0, 512, (B, PLEN),
                                             dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _jax_train(arch, attn):
    jcfg = _jcfg(arch, attn)
    with _reference_in_float64():
        params = _jtree(_weights(arch))
        opt = JO.make_optimizer("adamw", JO.schedules.constant(LR))
        state = opt[0](params)
        step = jax.jit(JS.make_train_step(jcfg, opt))
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        loss, gnorm = [], []
        for _ in range(STEPS):
            params, state, m = step(params, state, batch)
            loss.append(float(m["loss"]))
            gnorm.append(float(m["gnorm"]))
    return {"loss": loss, "gnorm": gnorm, "params": _flat(params),
            "m": _flat(state.m), "v": _flat(state.v)}


@functools.lru_cache(maxsize=None)
def _jax_serve(arch, attn):
    jcfg = _jcfg(arch, attn)
    with _reference_in_float64():
        params = _jtree(_weights(arch))
        state = JT.init_lm_decode_state(jcfg, B, MAX_LEN)
        logits, state = jax.jit(lambda p, t, s: JT.lm_prefill(
            p, t, jcfg, s))(params, jnp.asarray(_prompt()), state)
        step = jax.jit(lambda p, s, t, pos: JT.lm_decode_step(
            p, s, t, jcfg, position=pos))
        out = {"prefill": np.asarray(logits), "decode": []}
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        toks = [tok]
        for i in range(NDEC):
            lg, state = step(params, state, tok, PLEN + i)
            out["decode"].append(np.asarray(lg))
            tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            toks.append(tok)
    out["tokens"] = np.stack([np.asarray(t) for t in toks], 1)
    return out


def _cases():
    out = []
    for arch, attn in DENSE:
        common = dict(arch=arch, attn=attn, params=_weights(arch))
        out.append(dict(name=f"train-{arch}-{attn}", kind="train",
                        batch=_batch(), lr=LR, steps=STEPS, **common))
        out.append(dict(name=f"serve-{arch}-{attn}", kind="serve",
                        tokens=_prompt(), max_len=MAX_LEN, n_dec=NDEC,
                        **common))
    return out


def _close(errors, name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        errors.append(f"{name}: shape {got.shape} != {want.shape}")
        return
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    if not err <= TOL * max(1.0, float(np.max(np.abs(want)))):
        errors.append(f"{name}: max |diff| {err:.3e}")


def _spawn(fn, args, tmp_path, out):
    out.append(run_ranks(fn, 4, args=args, workdir=tmp_path,
                         timeout=300)[0])


@pytest.mark.parametrize("world", list(WORLDS))
def test_placed_train_and_serve_equal_jax(world, tmp_path):
    """Every dense case of one world in one spawn, while the parent
    computes the JAX references; every failure reported together."""
    got = []
    t = threading.Thread(target=_spawn, args=(
        C.placed_cases, (WORLDS[world], _cases(), True), tmp_path, got))
    t.start()
    refs = {(a, t_): (_jax_train(a, t_), _jax_serve(a, t_))
            for a, t_ in DENSE}
    t.join()
    assert got, "a rank failed"
    res, errors = got[0], []
    for (arch, attn), (jtrain, jserve) in refs.items():
        tr = res[f"train-{arch}-{attn}"]
        tag = f"{world} {arch} {attn}"
        _close(errors, f"{tag} loss", tr["loss"], jtrain["loss"])
        _close(errors, f"{tag} gnorm", tr["gnorm"], jtrain["gnorm"])
        for part in ("params", "m", "v"):
            assert sorted(tr[part]) == sorted(jtrain[part]), part
            for name, want in jtrain[part].items():
                _close(errors, f"{tag} {part} {name}", tr[part][name],
                       want)
        sv = res[f"serve-{arch}-{attn}"]
        _close(errors, f"{tag} prefill logits", sv["prefill"],
               jserve["prefill"])
        for i, (a, b) in enumerate(zip(sv["decode"], jserve["decode"])):
            _close(errors, f"{tag} decode {i} logits", a, b)
        if not np.array_equal(sv["tokens"], jserve["tokens"]):
            errors.append(f"{tag} tokens {sv['tokens'].tolist()} != "
                          f"{jserve['tokens'].tolist()}")
    assert not errors, "\n".join(errors)


def test_placed_xlstm_grads_equal_jax(tmp_path):
    """xlstm-1.3b on (2, 2): every leaf gathered over "data" around its
    layer, the mixers on the rank's heads; the loss and each leaf's grad
    against JAX's."""
    arch = "xlstm-1.3b"
    case = dict(name="grads", kind="grads", arch=arch, attn="fastmax2",
                params=_weights(arch), batch=_batch())
    got = []
    t = threading.Thread(target=_spawn, args=(
        C.placed_cases, ((2, 2), [case], False), tmp_path, got))
    t.start()
    jcfg = _jcfg(arch, "fastmax2")
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, batch, jcfg), has_aux=True))(
        _jtree(_weights(arch)))
    t.join()
    assert got, "a rank failed"
    res = got[0]["grads"]
    assert abs(res["loss"] - float(jloss)) <= E2E_TOL * abs(float(jloss))
    want = _flat(jgrads)
    assert sorted(res["grads"]) == sorted(want)
    top = max(np.abs(g).max() for g in want.values())
    for name, g in want.items():
        scale = max(np.abs(g).max(), GRAD_FLOOR * top)
        err = np.abs(res["grads"][name] - g).max() / scale
        assert err <= GRAD_TOL, (name, err)


def test_placed_checkpoint_restores_elastically(tmp_path):
    arch = "qwen3-1.7b"
    case = dict(arch=arch, attn="fastmax2", params=_weights(arch),
                batch=_batch(), lr=LR, steps=4)
    res = run_ranks(C.elastic_ckpt, 4, args=(case, str(tmp_path / "ck")),
                    workdir=tmp_path / "ranks", timeout=300)[0]
    ref = res["unbroken"]
    assert len(ref["losses"]) == 4
    saved_params, saved_m = ref["restored"]
    for run in ("2x2", "1x4", "one"):
        params, m = res[run]["restored"]
        for name, x in saved_params.items():
            assert np.array_equal(params[name], x), (run, name)
        for name, x in saved_m.items():
            assert np.array_equal(m[name], x), (run, name)
        losses, final = res[run]["losses"], res[run]["final"]
        assert len(losses) == 2
        if run == "2x2":
            assert losses == ref["losses"][2:]
            for name, x in ref["final"].items():
                assert np.array_equal(final[name], x), name
        else:
            np.testing.assert_allclose(losses, ref["losses"][2:], rtol=TOL,
                                       atol=0)
            for name, x in ref["final"].items():
                np.testing.assert_allclose(final[name], x, rtol=0, atol=TOL,
                                           err_msg=f"{run} {name}")


# ---------------------------------------------------------------------------
# Refusals (a fake process group: nothing runs a collective)
# ---------------------------------------------------------------------------


def _fake_step(arch, shape, opt_name="adamw", attn="fastmax2"):
    cfg = C.config(arch, attn)
    mesh = make_test_mesh(shape, ("data", "model"))
    placement = P.Placement(cfg, mesh)
    params = placement.place(init_model(cfg, seed=0, device="cpu"))
    opt = make_optimizer(opt_name, constant(LR))
    batch = {"tokens": torch.zeros(4 // shape[0], 16, dtype=torch.int64)}
    return cfg, mesh, placement, params, opt, batch


def test_placed_refuses_int8_m():
    with D.fake_world(2):
        cfg, mesh, placement, params, opt, batch = _fake_step(
            "qwen3-1.7b", (2, 1), "adamw_int8")
        with pytest.raises(ValueError, match="int8 m"):
            placement.init_opt_state(opt[0], params)
        step = make_train_step(cfg, opt, mesh=mesh)
        with pytest.raises(ValueError, match="int8 m"):
            step(params, opt[0](params), batch)


def test_placed_refuses_an_unknown_axis():
    cfg = C.config("qwen3-1.7b", "fastmax2")
    with pytest.raises(ValueError, match=r"mesh has \['expert'\]"):
        P.Placement(cfg, {"data": 2, "expert": 2})


# ---------------------------------------------------------------------------
# Per-device counts on a fake world of 8 against the partitioned module
# ---------------------------------------------------------------------------

_REFERENCE_4x2 = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.attention import AttentionSpec
    from repro.configs import get_smoke_config
    from repro.launch.dryrun import _opt_shardings
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.launch.mesh import make_test_mesh
    from repro.launch.steps import make_train_step, pick_optimizer
    from repro.models import init_model, input_specs
    from repro.sharding import batch_spec, param_shardings

    cfg = get_smoke_config("qwen3-1.7b", attn=AttentionSpec.parse("softmax"))
    mesh = make_test_mesh((4, 2), ("data", "model"))
    shapes, axes = init_model(jax.random.PRNGKey(0), cfg, abstract=True)
    with mesh:
        psh = param_shardings(axes, shapes, mesh)
        _, opt = pick_optimizer(cfg, sum(x.size for x in
                                         jax.tree.leaves(shapes)))
        opt_shapes = jax.eval_shape(opt[0], shapes)
        osh = _opt_shardings(opt_shapes, psh, mesh)
        batch = input_specs(cfg, global_batch=8, seq_len=64, kind="train")
        bsp = batch_spec(mesh, batch_size=8)
        bsh = jax.tree.map(lambda s: NamedSharding(
            mesh, P(*(list(bsp) + [None] * (len(s.shape) - 1)))), batch)
        compiled = jax.jit(make_train_step(cfg, opt),
                           in_shardings=(psh, osh, bsh),
                           out_shardings=(psh, osh, None)).lower(
            shapes, opt_shapes, batch).compile()
    text = compiled.as_text()
    res = analyze_hlo(text)
    res["n_reduce_scatter_ops"] = text.count(" reduce-scatter(")
    print(json.dumps(res))
""")


def test_placed_4x2_counts_equal_the_partitioned_module():
    ref = subprocess.run(
        [sys.executable, "-c", _REFERENCE_4x2], capture_output=True,
        text=True, timeout=600, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu", "HOME": str(ROOT)})
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    with D.fake_world(8):
        cfg = C.config("qwen3-1.7b", "softmax")
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  activ_dtype="float32")
        mesh = make_test_mesh((4, 2), ("data", "model"))
        fn, args, _ = D.cell_step(cfg, ShapeSpec(64, 8, "train"),
                                  device="meta", mesh=mesh)
        with OpCount("meta") as count:
            fn(*args)
    got = count.result()
    # the projections, the MLP, the vocab-parallel logits and softmax on
    # the rank's heads: 56,623,104 a device on both sides
    assert got["matmul_flops"] == want["matmul_flops"] == 56_623_104
    for kind in ("all-gather", "reduce-scatter", "all-reduce"):
        assert got[f"coll_{kind}"] > 0, kind
    # XLA's CPU partitioner reduces the FSDP grads by an all-reduce and a
    # slice: its module has no reduce-scatter op, where the port has one
    assert want["n_reduce_scatter_ops"] == 0
    kinds = {k for k in got if k.startswith("coll_") and got[k] > 0}
    allowed = {k for k in want if k.startswith("coll_") and want[k] > 0}
    assert kinds <= allowed | {"coll_reduce-scatter"}, kinds - allowed


def test_placed_gathers_one_layer_at_a_time(monkeypatch):
    """A hook on `gather` keeps weak references to each layer's gathered
    leaves: at no gather are more than two layers' alive (a layer's
    forward, or its recompute in the backward, and the one before it
    whose last leaf is in flight), and every layer is gathered."""
    from repro_torch.models import transformer as TT

    alive: dict = {}
    most = [0]
    unbind = TT._unbind_layers

    def hook(fn):
        def gather(leaf, over, mesh, *, sum_over=()):
            out = fn(leaf, over, mesh, sum_over=sum_over)
            layer = getattr(leaf, "_layer", None)
            if layer is not None and out is not leaf:
                alive.setdefault(layer, []).append(weakref.ref(out))
                live = {i for i, refs in alive.items()
                        if any(r() is not None for r in refs)}
                most[0] = max(most[0], len(live))
            return out
        return gather

    def unbind_leaves(tree, n):
        if isinstance(tree, dict):
            subs = {k: unbind_leaves(v, n) for k, v in tree.items()}
            return [{k: v[i] for k, v in subs.items()} for i in range(n)]
        views = unbind(tree, n)
        for i, v in enumerate(views):
            v._layer = i
        return views

    monkeypatch.setattr(TT, "_unbind_layers", unbind_leaves)
    monkeypatch.setattr(P, "gather", hook(P.gather))
    cfg = get_config("qwen3-1.7b",
                     attn=AttentionSpec.parse("fastmax2-kernel"))
    assert cfg.remat == "full"
    with D.fake_world(4):
        mesh = make_test_mesh((2, 2), ("data", "model"))
        fn, args, _ = D.cell_step(cfg, ShapeSpec(256, 4, "train"),
                                  device="meta", mesh=mesh)
        fn(*args)
    assert sorted(alive) == list(range(cfg.n_groups))
    assert 1 <= most[0] <= 2, most[0]
