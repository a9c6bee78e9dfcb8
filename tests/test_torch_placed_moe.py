"""Expert parallelism in the placed step (`repro_torch.models.moe` under an
active `Placement`) against single-device JAX on the CPU.

- Gloo worlds of four ranks (`launch/ranks.py`), (data 2, model 2) and
  (data 4, model 1) in one spawn per config, float64, fastmax2-kernel
  (the kernels' plain versions through the plans): the smoke
  deepseek-v2-236b (MLA, 8 experts top-2, one shared expert), kimi-k2
  (GQA, the same MoE) and jamba-v0.1-52b (Mamba and attention mixers, 4
  experts top-2, no shared expert). On (2, 2) each rank holds 4 (jamba:
  2) experts and the shared expert's ff half; on (4, 1) one row of the
  batch. Two AdamW steps against JAX's single-device `make_train_step`
  on the same weights and batch: each step's loss and gnorm and every
  parameter and AdamW moment, gathered whole, within TOL; prefill and
  greedy decode against the reference's `lm_prefill` /
  `lm_decode_step`: logits within TOL, the placed steps' tokens equal.
  Both sides lift their float32 islands to float64, the router's and
  the Mamba scan's included (`tests/test_torch_placed.py`).
- deepseek-v2's training drops pairs past the global capacity, and a
  capacity of each rank's own tokens would drop a different set: the
  parity above then fails on per-rank router statistics.
- On a fake world of (2, 2), full-width deepseek-v2 cut to its dense
  layer and one MoE layer of 160 experts trains on meta: no gather
  returns a whole routed-expert leaf, every one of the rank's 80 experts
  is gathered, and no more than two experts' gathered weights are alive
  at once (forward, recompute and backward).
"""
import threading
import weakref

import numpy as np
import pytest
import torch

import torch_placed_moe_cases as MC
from repro_torch.attention import AttentionSpec
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import moe as MOE
from repro_torch.sharding import placed as P
from test_torch_placed import (LR, MAX_LEN, NDEC, STEPS, _batch, _close,
                               _jax_serve, _jax_train, _prompt, _weights)
from torch_threads import share_cores  # noqa: F401

ARCHS = ("deepseek-v2-236b", "kimi-k2-1t-a32b", "jamba-v0.1-52b")
ATTN = "fastmax2-kernel"
SHAPES = ((2, 2), (4, 1))
DROPS = "deepseek-v2-236b"     # the config whose training drops pairs


def _cases(arch):
    common = dict(arch=arch, attn=ATTN, params=_weights(arch))
    return [dict(name="train", kind="train", batch=_batch(), lr=LR,
                 steps=STEPS, **common),
            dict(name="serve", kind="serve", tokens=_prompt(),
                 max_len=MAX_LEN, n_dec=NDEC, **common)]


def _spawn(arch, tmp_path, out):
    out.append(run_ranks(MC.moe_cases, 4, args=(SHAPES, _cases(arch)),
                         workdir=tmp_path, timeout=300)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_moe_equals_jax(arch, tmp_path):
    """Both meshes in one spawn while the parent computes the JAX
    references; every failure reported together."""
    got = []
    t = threading.Thread(target=_spawn, args=(arch, tmp_path, got))
    t.start()
    jtrain, jserve = _jax_train(arch, ATTN), _jax_serve(arch, ATTN)
    t.join()
    assert got, "a rank failed"
    res = got[0]
    errors = _compare(res, arch, SHAPES, jtrain, jserve)
    if arch == DROPS:
        for shape in SHAPES:
            world = f"{shape[0]}x{shape[1]}"
            stats = res[f"{world}-train"]["stats"]
            dropped = sum(s["dropped"] for s in stats)
            differ = sum(s["differ"] for s in stats)
            assert dropped > 0 and differ > 0, (world, stats)
    assert not errors, "\n".join(errors)


def _compare(res, arch, shapes, jtrain, jserve) -> list:
    """The failures of the ranks' train and serve results on each mesh of
    `shapes` against JAX's: loss, gnorm, every parameter and AdamW moment,
    prefill and decode logits within TOL, the tokens equal; serving drops
    no pair (full capacity)."""
    errors = []
    for shape in shapes:
        world = f"{shape[0]}x{shape[1]}"
        tag = f"{world} {arch}"
        tr = res[f"{world}-train"]
        _close(errors, f"{tag} loss", tr["loss"], jtrain["loss"])
        _close(errors, f"{tag} gnorm", tr["gnorm"], jtrain["gnorm"])
        for part in ("params", "m", "v"):
            assert sorted(tr[part]) == sorted(jtrain[part]), part
            for name, want in jtrain[part].items():
                _close(errors, f"{tag} {part} {name}", tr[part][name],
                       want)
        sv = res[f"{world}-serve"]
        _close(errors, f"{tag} prefill logits", sv["prefill"],
               jserve["prefill"])
        for i, (a, b) in enumerate(zip(sv["decode"], jserve["decode"])):
            _close(errors, f"{tag} decode {i} logits", a, b)
        if not np.array_equal(sv["tokens"], jserve["tokens"]):
            errors.append(f"{tag} tokens {sv['tokens'].tolist()} != "
                          f"{jserve['tokens'].tolist()}")
        assert sum(s.get("dropped", 0) for s in sv["stats"]) == 0
    return errors


def test_placed_moe_gathers_one_expert_at_a_time(monkeypatch):
    """A hook on `gather` keeps weak references to each expert's gathered
    weights (the views `moe._experts` hands out are tagged with their
    expert): no gather returns a whole [E, ...] routed-expert leaf, every
    local expert is gathered, and at no gather are more than two
    experts' weights alive."""
    cfg = get_config("deepseek-v2-236b", n_layers=2,
                     attn=AttentionSpec.parse("fastmax2-kernel"))
    e = cfg.n_experts
    alive: dict = {}
    most, shapes = [0], set()
    experts = MOE._experts

    def tagged(params):
        first, ep, views = experts(params)
        for j, ws in enumerate(views):
            for w in ws:
                w._expert = first + j
        return first, ep, views

    def hook(fn):
        def gather(leaf, over, mesh, *, sum_over=()):
            out = fn(leaf, over, mesh, sum_over=sum_over)
            shapes.add(tuple(out.shape))
            ex = getattr(leaf, "_expert", None)
            if ex is not None:
                alive.setdefault(ex, []).append(weakref.ref(out))
                live = {i for i, refs in alive.items()
                        if any(r() is not None for r in refs)}
                most[0] = max(most[0], len(live))
            return out
        return gather

    monkeypatch.setattr(MOE, "_experts", tagged)
    monkeypatch.setattr(P, "gather", hook(P.gather))
    with D.fake_world(4):
        mesh = make_test_mesh((2, 2), ("data", "model"))
        fn, args, _ = D.cell_step(cfg, ShapeSpec(256, 4, "train"),
                                  device="meta", mesh=mesh)
        fn(*args)
    d, ff = cfg.d_model, cfg.d_ff_expert
    assert not {(e, d, ff), (e, ff, d), (e // 2, d, ff),
                (e // 2, ff, d)} & shapes
    # model rank 0 holds experts 0 .. 79
    assert sorted(alive) == list(range(e // 2))
    assert 1 <= most[0] <= 2, most[0]
