"""The attention mixers of the MoE configs split over "model" by heads in
the placed step (`models.layers` under an active `Placement` with
expert parallelism), against single-device JAX on the CPU.

- (data 1, model 4), a gloo world of four ranks in one spawn per config,
  float64, fastmax2-kernel (the kernels' plain versions through the
  plans): the smoke kimi-k2 and jamba (4 q heads, one a rank; 2 kv
  heads, whole on every rank: k and v computed from x, q gathered to
  whole heads for the attention, o cut back) and deepseek-v2 (MLA's 4
  heads, one a rank, k and v decompressed on the rank's head). N = 32
  is split over "model" between blocks. Two AdamW steps, prefill and
  greedy decode against the reference at TOL = 1e-10 of scale (both
  sides' float32 islands lifted to float64), as
  `tests/test_torch_placed_moe.py` holds (2, 2) and (4, 1).
- On (1, 2) every model rank's own grad of MLA's w_dkv (whole over
  "model", used on the rank's heads only) equals JAX's whole grad within
  TOL: the placed attention sums its partial grads over "model".
- On a fake world of (2, 2), full-width deepseek-v2 cut to 2 layers and
  kimi-k2 cut to its dense layer and one MoE layer train on meta: no
  gather over "model" returns a whole wq, wk, wv, w_uk, w_uv or wo, and
  every attention call gets the rank's heads (Hq / 2; MLA's and kimi's
  kv heads / 2 too).
- `layers._tp_split` raises where MLA's wq and w_uk / w_uv disagree on
  the heads split.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_placed_moe_cases as MC
from repro.models import transformer as JT
from repro_torch import attention as A
from repro_torch.attention import AttentionSpec
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import layers as L
from repro_torch.sharding import placed as P
from test_torch_placed import (TOL, _batch, _close, _flat, _jax_serve,
                               _jax_train, _jcfg, _jtree,
                               _reference_in_float64, _weights)
from test_torch_placed_moe import ATTN, _cases, _compare
from torch_threads import share_cores  # noqa: F401

ARCHS = ("kimi-k2-1t-a32b", "jamba-v0.1-52b", "deepseek-v2-236b")
UNEVEN = ((1, 4),)
MLA = "deepseek-v2-236b"
DKV = ("dense_0/mixer/w_dkv", "blocks_0/mixer/w_dkv")


def _spawn(world, args, tmp_path, out):
    out.append(run_ranks(MC.moe_cases, world, args=args, workdir=tmp_path,
                         timeout=300)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_mixers_split_unevenly_equal_jax(arch, tmp_path):
    """(1, 4): train and serve in one spawn while the parent computes the
    JAX references; every failure reported together."""
    got = []
    t = threading.Thread(target=_spawn, args=(
        4, (UNEVEN, _cases(arch)), tmp_path, got))
    t.start()
    jtrain, jserve = _jax_train(arch, ATTN), _jax_serve(arch, ATTN)
    t.join()
    assert got, "a rank failed"
    errors = _compare(got[0], arch, UNEVEN, jtrain, jserve)
    assert not errors, "\n".join(errors)


def test_placed_mla_w_dkv_grad_is_whole_on_every_model_rank(tmp_path):
    case = dict(name="grads", kind="rank_grads", arch=MLA, attn=ATTN,
                params=_weights(MLA), batch=_batch(), leaves=DKV)
    got = []
    t = threading.Thread(target=_spawn, args=(
        2, (((1, 2),), [case]), tmp_path, got))
    t.start()
    with _reference_in_float64():
        jcfg = _jcfg(MLA, ATTN)
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda p: JT.lm_loss(p, batch, jcfg), has_aux=True))(
            _jtree(_weights(MLA)))
    t.join()
    assert got, "a rank failed"
    res, want, errors = got[0]["1x2-grads"], _flat(jgrads), []
    _close(errors, "loss", res["loss"], float(jloss))
    for name in DKV:
        assert len(res["grads"][name]) == 2
        for r, g in enumerate(res["grads"][name]):
            _close(errors, f"rank {r} {name}", g, want[name])
    assert not errors, "\n".join(errors)


def _whole_mixer_shapes(cfg) -> set:
    d, hq, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    if cfg.use_mla:
        rank = cfg.kv_lora_rank
        return {(d, hq, cfg.qk_nope_dim + cfg.qk_rope_dim),
                (rank, hq, cfg.qk_nope_dim), (rank, hq, hd), (hq, hd, d)}
    return {(d, hq, hd), (d, cfg.n_kv_heads, hd), (hq, hd, d)}


@pytest.mark.parametrize("arch", (MLA, "kimi-k2-1t-a32b"))
def test_placed_mixers_gather_no_whole_leaf(arch, monkeypatch):
    """Full width cut to a dense and an MoE layer, (2, 2) on meta: the
    shapes of every gather over "model" and the heads of every attention
    call (forward and recompute)."""
    cfg = get_config(arch, n_layers=2,
                     attn=AttentionSpec.parse("fastmax2-kernel"))
    over_model, heads = set(), set()
    gather, attention = P.gather, A.attention

    def spy_gather(leaf, over, mesh, *, sum_over=()):
        out = gather(leaf, over, mesh, sum_over=sum_over)
        if "model" in over and "model" in P.split_axes(P.spec_of(leaf)):
            over_model.add(tuple(out.shape))
        return out

    def spy_attention(q, k, v, *args, **kw):
        heads.add((q.shape[1], k.shape[1], v.shape[1]))
        return attention(q, k, v, *args, **kw)

    monkeypatch.setattr(P, "gather", spy_gather)
    monkeypatch.setattr(A, "attention", spy_attention)
    with D.fake_world(4):
        mesh = make_test_mesh((2, 2), ("data", "model"))
        fn, args, _ = D.cell_step(cfg, ShapeSpec(256, 4, "train"),
                                  device="meta", mesh=mesh)
        fn(*args)
    assert not over_model & _whole_mixer_shapes(cfg), over_model
    kv = cfg.n_heads if cfg.use_mla else cfg.n_kv_heads
    assert heads == {(cfg.n_heads // 2, kv // 2, kv // 2)}, heads


def _mla_leaves(q: bool, k: bool, v: bool) -> dict:
    def leaf(split):
        return P.tag(torch.zeros(2, 4, 3), (None, "model" if split else None,
                                            None))
    return {"wq": leaf(q), "w_uk": leaf(k), "w_uv": leaf(v),
            "w_dkv": P.tag(torch.zeros(2, 5), (None, None)),
            "wo": leaf(q)}


@pytest.mark.parametrize("split", [(True, False, False), (True, True, False),
                                   (False, True, True), (False, False, True)])
def test_tp_split_refuses_mla_heads_that_disagree(split):
    with pytest.raises(ValueError, match="MLA's heads split"):
        L._tp_split(_mla_leaves(*split))


@pytest.mark.parametrize("split", [True, False])
def test_tp_split_of_mla_splits_q_and_kv_together(split):
    assert L._tp_split(_mla_leaves(split, split, split)) == (split, split)
