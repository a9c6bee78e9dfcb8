"""The SSM mixers split over "model" in the placed step (`models/mamba.py`,
`models/xlstm.py` under an active `Placement` with `ssm`) against
single-device JAX on the CPU.

- Gloo worlds (data 1, model 2) and (1, 4), one spawn per mesh running
  both configs, float64, fastmax2-kernel (the kernels' plain versions
  through the plans): the smoke jamba-v0.1-52b (Mamba d_inner 128,
  d_state 16: 64 and 32 channels a rank) and the smoke xlstm-1.3b
  (mLSTM d_inner 64 in 2 heads, sLSTM 32 in 2: whole heads a rank on
  (1, 2), each head across two ranks on (1, 4)). Two AdamW steps against
  JAX's single-device `make_train_step` on the same weights and batch:
  each step's loss and gnorm and every parameter and AdamW moment,
  gathered whole, within TOL = 1e-10 of scale; prefill and greedy decode
  against the reference's `lm_prefill` / `lm_decode_step`: logits within
  TOL, the placed steps' tokens equal. Both sides lift their float32
  islands to float64, Mamba's and the xLSTM mixers' included
  (`tests/test_torch_placed.py`). Each rank's SSM decode state holds the
  bytes `decode_state_shardings` plans for it.
- On a fake world of (2, 2), full-width jamba (8 layers) and xlstm-1.3b
  (8 layers) train on meta: no gather over "model" returns a whole
  in_proj, x_proj, out_proj, up_proj, down_proj, w{z,i,f,o}, wi or wf,
  each Mamba scan runs on d_inner / 2 channels and each mLSTM scan on 2
  of 4 heads. On a fake (1, 16), where one xlstm-1.3b head spans 4
  ranks: each mLSTM scan holds one head and its value slice of 256, the
  sLSTM recurrence runs its head whole (512 channels: the head's w
  columns gathered over its 4 ranks, never all of "model"), and the
  rank keeps its 128-channel slice of the head's output.
"""
import contextlib
import importlib
import threading

import pytest

import torch_placed_ssm_cases as SC
from repro_torch.attention import AttentionSpec
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import mamba as M
from repro_torch.models import xlstm as X
from repro_torch.sharding import placed as P
from test_torch_placed import (LR, MAX_LEN, NDEC, STEPS, B, _JnpFloat64,
                               _batch, _jax_serve, _jax_train,
                               _prompt, _weights)
from test_torch_placed_moe import _compare
from torch_threads import share_cores  # noqa: F401

ARCHS = ("jamba-v0.1-52b", "xlstm-1.3b")
ATTN = "fastmax2-kernel"
WORLDS = {"1x2": (1, 2), "1x4": (1, 4)}


@contextlib.contextmanager
def _xlstm_in_float64():
    """The reference's xLSTM float32 islands in float64 too (the other
    modules' are lifted by `test_torch_placed._reference_in_float64`)."""
    mod = importlib.import_module("repro.models.xlstm")
    saved, mod.jnp = mod.jnp, _JnpFloat64()
    try:
        yield
    finally:
        mod.jnp = saved


def _refs(arch):
    with _xlstm_in_float64():
        return _jax_train(arch, ATTN), _jax_serve(arch, ATTN)


def _cases():
    out = []
    for arch in ARCHS:
        common = dict(arch=arch, attn=ATTN, params=_weights(arch))
        out += [dict(name=f"train-{arch}", kind="train", batch=_batch(),
                     lr=LR, steps=STEPS, **common),
                dict(name=f"serve-{arch}", kind="serve", tokens=_prompt(),
                     max_len=MAX_LEN, n_dec=NDEC, **common),
                dict(name=f"state-{arch}", kind="state", batch_size=B,
                     max_len=MAX_LEN, **common)]
    return out


def _spawn(tmp_path, out):
    """Each mesh in its own spawn, one after the other."""
    for world, shape in WORLDS.items():
        out[world] = run_ranks(SC.ssm_cases, shape[0] * shape[1],
                               args=(shape, _cases()),
                               workdir=tmp_path / world, timeout=300)[0]


def test_placed_ssm_equals_jax(tmp_path):
    """Both meshes, one spawn each, while the parent computes the JAX
    references once; every failure reported together."""
    got = {}
    t = threading.Thread(target=_spawn, args=(tmp_path, got))
    t.start()
    refs = {arch: _refs(arch) for arch in ARCHS}
    t.join()
    assert sorted(got) == sorted(WORLDS), "a rank failed"
    errors = []
    for world, res in got.items():
        for arch, (jtrain, jserve) in refs.items():
            one = {f"{world}-{kind}": res[f"{kind}-{arch}"]
                   for kind in ("train", "serve")}
            for r in one.values():
                r.setdefault("stats", [])
            errors += _compare(one, arch, [WORLDS[world]], jtrain, jserve)
            st = res[f"state-{arch}"]
            if st["held"] != [st["planned"]] * len(st["held"]):
                errors.append(f"{world} {arch} SSM state bytes a rank "
                              f"{st['held']} != planned {st['planned']}")
    assert not errors, "\n".join(errors)


# full-width leaves no gather over "model" may return
def _whole_leaves(cfg) -> set:
    d = cfg.d_model
    if cfg.name.startswith("jamba"):
        di, dt_rank, ds, _ = M._dims(cfg)
        return {(d, 2 * di), (di, dt_rank + 2 * ds), (di, d)}
    di, nh, _ = X._dims(cfg)
    return {(d, 2 * di), (di, d), (di, nh), (d, d)}


def _meta_train(cfg, shape, monkeypatch) -> dict:
    """The placed train step of `cfg` on a fake world of `shape` on meta,
    spied: the shapes of gathers over "model" that return a whole leaf,
    the channels of every Mamba scan, the (heads, dk, dv) of every mLSTM
    scan, the (width, w's columns) of every sLSTM recurrence and the
    channels of the sLSTM output a rank keeps."""
    seen = {"whole": [], "mamba": set(), "mlstm": set(), "slstm": set(),
            "slstm_out": set()}
    whole = _whole_leaves(cfg)
    gather, scan, chunk = P.gather, M._selective_scan, X._mlstm_chunk_scan
    weights, out = X._slstm_weights, X._slstm_out

    def spy_gather(leaf, over, mesh, *, sum_over=()):
        res = gather(leaf, over, mesh, sum_over=sum_over)
        if ("model" in over and "model" in P.split_axes(P.spec_of(leaf))
                and tuple(res.shape) in whole):
            seen["whole"].append(tuple(res.shape))
        return res

    def spy_scan(u, *a, **kw):
        seen["mamba"].add(u.shape[-1])
        return scan(u, *a, **kw)

    def spy_chunk(q, k, v, *a, **kw):
        seen["mlstm"].add((q.shape[1], q.shape[-1], v.shape[-1]))
        return chunk(q, k, v, *a, **kw)

    def spy_weights(params, cfg_, lay):
        w, r, bias = weights(params, cfg_, lay)
        seen["slstm"].add((bias.shape[1], w.shape[-1]))
        return w, r, bias

    def spy_out(params, h, cfg_, dtype):
        y = out(params, h, cfg_, dtype)
        seen["slstm_out"].add(params["gn_scale"].shape[-1])
        return y

    monkeypatch.setattr(P, "gather", spy_gather)
    monkeypatch.setattr(M, "_selective_scan", spy_scan)
    monkeypatch.setattr(X, "_mlstm_chunk_scan", spy_chunk)
    monkeypatch.setattr(X, "_slstm_weights", spy_weights)
    monkeypatch.setattr(X, "_slstm_out", spy_out)
    with D.fake_world(shape[0] * shape[1]):
        mesh = make_test_mesh(shape, ("data", "model"))
        fn, args, _ = D.cell_step(cfg, ShapeSpec(256, 2 * shape[0],
                                                 "train"),
                                  device="meta", mesh=mesh)
        fn(*args)
    return seen


@pytest.mark.parametrize("arch, shape", [
    ("jamba-v0.1-52b", (2, 2)), ("xlstm-1.3b", (2, 2)),
    ("xlstm-1.3b", (1, 16))])
def test_placed_ssm_keeps_the_model_shards(arch, shape, monkeypatch):
    cfg = get_config(arch, n_layers=8,
                     attn=AttentionSpec.parse("fastmax2-kernel"))
    seen = _meta_train(cfg, shape, monkeypatch)
    assert not seen["whole"], seen["whole"]
    m = shape[1]
    if arch.startswith("jamba"):
        assert seen["mamba"] == {M._dims(cfg)[0] // m}
        return
    di, nh, hd = X._dims(cfg)
    sd, _, shd = X._sdims(cfg)
    if nh % m == 0:
        # whole heads a rank: 2 of 4, each 1024 wide; sLSTM's too
        assert seen["mlstm"] == {(nh // m, hd, hd)}
        assert seen["slstm"] == {(sd // m, sd // m)}
    else:
        # a head across m / nh = 4 ranks: mLSTM on its value slice, the
        # sLSTM head computed whole from its 4 ranks' columns
        assert seen["mlstm"] == {(1, hd, hd * nh // m)}
        assert seen["slstm"] == {(shd, shd)}
    assert seen["slstm_out"] == {sd // m}
