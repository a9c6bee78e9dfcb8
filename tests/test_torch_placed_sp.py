"""The placed training step's residual split over "model" along the
sequence (`sharding.placed.sequence_split`, the reference's
`maybe_constraint(x, ("pod", "data"), "model", None)` between blocks)
against the reference on the CPU.

Gloo worlds of (data 1, model 2) and (data 1, model 4), float64 with the
float32 islands lifted on both sides (`tests/test_torch_placed.py`), the
smoke qwen3-1.7b on fastmax2-kernel (the kernels' plain versions through
the kernel plans), remat "full", B = 4:

- N = 32: every block's checkpoint keeps the rank's 1/model slice of the
  sequence, exactly (the bytes `launch.op_analysis.SavedBytes` counts
  through `saved_tensors_hooks`); the placed grad fn's loss and every
  grad, gathered whole, equal JAX's `lm_loss` and its grads within TOL.
- On (1, 2) the forward's collectives are the embedding's
  reduce-scatter, then one all-gather and one reduce-scatter per
  tensor-parallel region (attention, MLP), then the logits' all-gather:
  no all-reduce of activations over "model".
- N = 30: "model" 4 does not divide it, so the rows stay whole (the
  whole sequence's bytes saved, the forward's all-reduces as before the
  split); "model" 2 divides it. Both equal JAX within TOL.
- The smoke whisper-small (fastmax2), both towers tensor-parallel over
  "model" (4 heads and d_ff 128 over 2 and 4) around the split residual:
  its 16 frames and N = 32 tokens split on both worlds, loss and grads
  against JAX's `encdec_loss` within TOL. Each rank's self-attention
  (both towers), cross-attention and GELU MLP hold their heads / ff
  shards and attend on the rank's heads, and no leaf is gathered whole
  over "model" (`torch_placed_cases.tp_spy`). On (1, 2) the forward's
  collectives are one all-gather and one reduce-scatter per
  tensor-parallel region (two a layer in the encoder, three in the
  decoder), the encoder's output gathered once for the decoder tower,
  and no all-reduce.
"""
import functools

import jax
import numpy as np
import pytest

import torch_placed_cases as C
import torch_placed_sp_cases as S
from repro.models.model import model_loss as jmodel_loss
from repro_torch.launch.ranks import run_ranks
from test_torch_placed import (TOL, _close, _flat, _jcfg, _jtree,
                               _reference_in_float64, _weights)
from torch_threads import share_cores  # noqa: F401

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

ARCH, ATTN, B = "qwen3-1.7b", "fastmax2-kernel", 4
WHISPER = "whisper-small"
SEQS = (32, 30)
WORLDS = {"1x2": (1, 2), "1x4": (1, 4)}
# name -> (arch, attention, N)
CASES = {**{f"n{n}": (ARCH, ATTN, n) for n in SEQS},
         "whisper": (WHISPER, "fastmax2", 32)}


@functools.lru_cache(maxsize=None)
def _batch(arch, n):
    cfg = C.config(arch, "fastmax2")
    rng = np.random.default_rng(7 + n)
    toks = rng.integers(0, cfg.vocab_size, (B, n), dtype=np.int32)
    out = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))
    return out


def _cases():
    return [dict(name=name, arch=arch, attn=attn, params=_weights(arch),
                 batch=_batch(arch, n), spy=arch == WHISPER)
            for name, (arch, attn, n) in CASES.items()]


_RUNS: dict = {}


@pytest.fixture
def ranks(tmp_path_factory):
    """ranks(world): rank 0's results of the cases on `world`, one spawn
    a world and process."""
    def run(world):
        if world not in _RUNS:
            shape = WORLDS[world]
            _RUNS[world] = run_ranks(
                S.split_cases, shape[0] * shape[1], args=(shape, _cases()),
                workdir=tmp_path_factory.mktemp(world), timeout=300)[0]
        return _RUNS[world]
    return run


@functools.lru_cache(maxsize=None)
def _jax_grads(name):
    arch, attn, n = CASES[name]
    jcfg = _jcfg(arch, attn)
    with _reference_in_float64():
        batch = {k: jnp.asarray(v) for k, v in _batch(arch, n).items()}
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jmodel_loss(p, batch, jcfg), has_aux=True))(
            _jtree(_weights(arch)))
    return float(loss), _flat(grads)


def _rank_residual_bytes(name, model):
    """float64 bytes of every layer's input over a rank's rows: each
    tower's sequence split where "model" divides it."""
    arch, _, n = CASES[name]
    cfg = C.config(arch, "fastmax2")
    towers = [(cfg.n_layers, n)]
    if cfg.encoder_layers:
        towers.append((cfg.encoder_layers, cfg.encoder_seq))
    return sum(layers * B * (seq // model if seq % model == 0 else seq)
               * cfg.d_model * 8 for layers, seq in towers)


@pytest.mark.parametrize("world", list(WORLDS))
def test_split_checkpoints_the_rank_s_slice(world, ranks):
    res, model = ranks(world), WORLDS[world][1]
    for name in CASES:
        got = res[name]["block_input_bytes"]
        want = _rank_residual_bytes(name, model)
        assert got == want, (name, got, want)
        assert res[name]["saved_bytes"] > got
    assert res["n32"]["block_input_bytes"] * model \
        == _rank_residual_bytes("n32", 1)


@pytest.mark.parametrize("world", list(WORLDS))
def test_split_equals_jax(world, ranks):
    res, errors = ranks(world), []
    for case in CASES:
        loss, grads = _jax_grads(case)
        got = res[case]
        _close(errors, f"{world} {case} loss", got["loss"], loss)
        assert sorted(got["grads"]) == sorted(grads)
        for name, want in grads.items():
            _close(errors, f"{world} {case} grad {name}",
                   got["grads"][name], want)
    assert not errors, "\n".join(errors)


def test_split_tensor_parallel_block_asks_no_all_reduce(ranks):
    """(1, 2), N = 32, kv heads split (the heads plan): [B, N/2, d] is
    gathered and the [B, N, d] partial sums reduce-scattered; a rank
    sends its operand (the gather's slice, the scatter's whole)."""
    cfg = C.config(ARCH, ATTN)
    fwd = ranks("1x2")["n32"]["forward"]
    half, whole = (16, B, cfg.d_model), (32, B, cfg.d_model)
    region = [("all-gather", half), ("reduce-scatter", whole)]
    assert fwd == ([("reduce-scatter", whole)] + region * 2 * cfg.n_layers
                   + [("all-gather", half)]), fwd


def test_indivisible_sequence_keeps_the_rows_whole(ranks):
    """(1, 4), N = 30: no reduce-scatter, the row-parallel outputs
    all-reduced whole as without the split."""
    cfg = C.config(ARCH, ATTN)
    fwd = ranks("1x4")["n30"]["forward"]
    kinds = {k for k, _ in fwd}
    assert "reduce-scatter" not in kinds
    assert fwd.count(("all-reduce", (B, 30, cfg.d_model))) \
        == 2 * cfg.n_layers + 1


@pytest.mark.parametrize("world", list(WORLDS))
def test_whisper_towers_keep_their_model_shards(world, ranks):
    """Every attention layer of both towers (the encoder's noncausal
    self-attention, the decoder's causal one and its cross-attention)
    holds wq, wk, wv and wo on the rank's 4/model heads, every GELU MLP
    wi and wo on its 128/model ff columns, each attention call runs on
    those heads, and no leaf is gathered whole over "model"."""
    model = WORLDS[world][1]
    cfg = C.config(WHISPER, "fastmax2")
    seen = ranks(world)["whisper"]["seen"]
    d, h, hd = cfg.d_model, cfg.n_heads // model, cfg.head_dim
    ff = cfg.d_ff // model
    proj = ((d, h, hd),) * 3 + ((h, hd, d),)
    assert seen["attention"] == {(site,) + proj for site in (
        "noncausal", "causal", "cross")}, seen["attention"]
    assert seen["mlp"] == {((d, ff), (ff, d))}, seen["mlp"]
    assert seen["heads"] == {("attention", h, h, h)}, seen["heads"]
    assert seen["whole"] == [], seen["whole"]


def test_whisper_forward_asks_no_all_reduce(ranks):
    """(1, 2), 16 frames and N = 32 tokens: the encoder's two regions a
    layer on its [B, 8, d] slices, its output all-gathered once for the
    whole decoder tower, the decoder's vocab-parallel embedding
    reduce-scattered, three regions a layer (self-attention,
    cross-attention, MLP), the logits' all-gather; no all-reduce of
    activations over "model"."""
    cfg = C.config(WHISPER, "fastmax2")
    fwd = ranks("1x2")["whisper"]["forward"]
    n, m, d = CASES["whisper"][2], cfg.encoder_seq, cfg.d_model

    def region(seq):
        return [("all-gather", (seq // 2, B, d)),
                ("reduce-scatter", (seq, B, d))]

    want = (region(m) * 2 * cfg.encoder_layers
            + [("all-gather", (m // 2, B, d)),
               ("reduce-scatter", (n, B, d))]
            + region(n) * 3 * cfg.n_layers
            + [("all-gather", (n // 2, B, d))])
    assert fwd == want, fwd
