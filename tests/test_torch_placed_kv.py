"""The softmax KV cache as the rank's block of the reference's
`kv_cache_spec` in the placed serve step (`attention/state.py` under an
active mesh) against the reference on the CPU.

- Gloo worlds (data 1, model 2), (1, 4) and (2, 2), one spawn each
  running `tests/torch_placed_kv_cases.py` (no JAX), float64 with the
  float32 islands lifted on both sides (`tests/test_torch_placed.py`):
  - each rank's k, v and mask have their `kv_cache_spec` block's shape,
    none is whole, and the bytes a rank are the planned ones: the smoke
    qwen3-1.7b (2 kv heads) in heads mode on "model" 2, in sequence mode
    on 4 (a `KVCacheRows`), the smoke granite-20b (1 kv head) in sequence
    mode on every world;
  - both configs' prefill and greedy decode against JAX's `lm_prefill` /
    `lm_decode_step`: logits within TOL = 1e-10 of scale, tokens equal
    (and the placed steps' tokens). A prompt of 14 tokens and 4 decode
    tokens at max_len 32: on (1, 4) the decode crosses from rank 1's rows
    (8-15) into rank 2's. A left-padded prompt whose 8 masked rows fill
    rank 0's block on (1, 4);
  - a resumed (`offset=`) prefill, and a [B] cursor lane
    (`serve.slots.to_slotted`) at a different length a row, each against
    the same calls on the whole cache in one process;
  - at the attention state: a row with no valid key on any rank is the
    whole cache's uniform average (a step and a resumed prefill), in
    sequence mode and, on "model" 2, heads mode through whole heads; a
    state that is not the rank's block raises;
  - on (1, 2), the smoke whisper-small, both towers tensor-parallel over
    "model" (2 of 4 heads, 64 of 128 ff columns a rank) with the decoder
    cache in heads mode (softmax) and with the moments (fastmax2, heads
    mode, each rank's bytes = planned): prefill and decode logits within
    TOL of JAX's and tokens equal; every attention layer (encoder,
    decoder prefill and decode, cross-attention) and MLP holds its
    "model" shards, every attention call runs on the rank's heads, and
    no leaf is gathered whole over "model" (`torch_placed_cases.tp_spy`).
- The dry run (`launch/dryrun.py`, a fake world of 256 or 512 ranks on
  meta) of `--attn softmax` cells: the placed step's argument bytes on
  rank 0 equal the planned ones, part by part, at `decode_32k` and
  `prefill_32k` for every config with an attention layer, at
  `decode_32k` on two pods for qwen3, granite, llama3-405b and
  deepseek-v2, and at jamba's `long_500k` (its batch-1 SSM states held
  as `tests/test_torch_dryrun.py` holds them).
"""
import functools
import threading

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import torch_placed_kv_cases as KC  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import SHAPES  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from test_torch_dryrun import MESHES, _ssm_state_bytes  # noqa: E402
from test_torch_placed import (TOL, _jcfg, _jtree,  # noqa: E402
                               _reference_in_float64, _weights)
from torch_threads import share_cores  # noqa: F401,E402

B, PLEN, NDEC, MAX_LEN = 4, 14, 4, 32
WORLDS = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
ARCHS = ("qwen3-1.7b", "granite-20b")
WHISPER = "whisper-small"
WHISPER_ATTNS = ("softmax", "fastmax2")   # a KV cache, moments
PAD = 8                  # rank 0's whole block on (1, 4)
SPLIT = 6                # the resumed prefill's chunk: rows 6-13
VALID = (14, 7, 10, 3)   # the [B] lane's tokens a row


@functools.lru_cache(maxsize=None)
def _prompt():
    return np.random.default_rng(11).integers(0, 512, (B, PLEN),
                                              dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _kv_mask():
    """Rows 0 and 2 left-padded by PAD tokens, row 1 by 3."""
    m = np.ones((B, PLEN))
    m[0, :PAD] = m[2, :PAD] = 0.0
    m[1, :3] = 0.0
    return m


@functools.lru_cache(maxsize=None)
def _frames():
    cfg = KC.C.config(WHISPER, "softmax")
    return np.random.default_rng(12).normal(
        size=(B, cfg.encoder_seq, cfg.d_model))


@functools.lru_cache(maxsize=None)
def _jax_serve(arch, padded: bool, attn: str = "softmax"):
    """JAX's prefill and greedy decode of the prompt (with the padded
    kv_mask, or whisper's frames through its encoder), float64 islands."""
    jcfg = _jcfg(arch, attn)
    mask = jnp.asarray(_kv_mask()) if padded else None
    with _reference_in_float64():
        params = _jtree(_weights(arch))
        enc = None
        if jcfg.encoder_layers:
            enc = JE.encode(params, jnp.asarray(_frames()), jcfg)
            params = params["decoder"]
        state = JT.init_lm_decode_state(jcfg, B, MAX_LEN)
        logits, state = jax.jit(lambda p, t, s, e: JT.lm_prefill(
            p, t, jcfg, s, kv_mask=mask, enc_out=e))(
            params, jnp.asarray(_prompt()), state, enc)
        step = jax.jit(lambda p, s, t, pos, e: JT.lm_decode_step(
            p, s, t, jcfg, position=pos, enc_out=e))
        out = {"prefill": np.asarray(logits), "decode": []}
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        toks = [tok]
        for i in range(NDEC):
            lg, state = step(params, state, tok, PLEN + i, enc)
            out["decode"].append(np.asarray(lg))
            tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            toks.append(tok)
    out["tokens"] = np.stack([np.asarray(t) for t in toks], 1)
    return out


def _cases(world):
    m = WORLDS[world][1]
    out = []
    for arch in ARCHS:
        common = dict(arch=arch, params=_weights(arch), max_len=MAX_LEN,
                      n_dec=NDEC)
        out += [
            dict(name=f"state-{arch}", kind="state", batch_size=B,
                 **common),
            dict(name=f"serve-{arch}", kind="serve", tokens=_prompt(),
                 **common),
            dict(name=f"padded-{arch}", kind="serve", tokens=_prompt(),
                 kv_mask=_kv_mask(), **common),
            dict(name=f"resume-{arch}", kind="resume", tokens=_prompt(),
                 split=SPLIT, **common),
            dict(name=f"lanes-{arch}", kind="lanes", tokens=_prompt(),
                 valid=np.asarray(VALID, np.int64), **common)]
    for hkv in (1, 2) if m == 2 else (1,):
        out += [dict(name=f"uniform-{hkv}", kind="uniform", hkv=hkv,
                     max_len=16),
                dict(name=f"refusals-{hkv}", kind="refusals", hkv=hkv,
                     max_len=16)]
    if world == "1x2":
        for attn in WHISPER_ATTNS:
            out.append(dict(name=f"serve-whisper-{attn}", kind="serve",
                            arch=WHISPER, attn=attn,
                            params=_weights(WHISPER), max_len=MAX_LEN,
                            n_dec=NDEC, tokens=_prompt(), frames=_frames(),
                            spy=True))
        out.append(dict(name="moments-whisper", kind="moments",
                        arch=WHISPER, attn="fastmax2", batch_size=B,
                        max_len=MAX_LEN))
    return out


def _close(errors, name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        errors.append(f"{name}: shape {got.shape} != {want.shape}")
        return
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    if not err <= TOL * max(1.0, float(np.max(np.abs(want)))):
        errors.append(f"{name}: max |diff| {err:.3e}")


def _spawn(world, tmp_path, out):
    shape = WORLDS[world]
    out.append(run_ranks(KC.kv_cases, shape[0] * shape[1],
                         args=(shape, _cases(world)), workdir=tmp_path,
                         timeout=300)[0])


def _check_state(errors, world, arch, st):
    m = WORLDS[world][1]
    heads = arch == "qwen3-1.7b" and m == 2
    want = ("heads", ["KVCache"]) if heads else ("sequence", ["KVCacheRows"])
    if (st["mode"], st["types"]) != want:
        errors.append(f"{world} {arch}: {st['mode']} {st['types']}, "
                      f"want {want}")
    if not st["shapes_ok"] or st["whole_leaves"]:
        errors.append(f"{world} {arch}: a leaf is not its block "
                      f"(whole leaves {st['whole_leaves']})")
    if st["held"] != [st["planned"]] * len(st["held"]):
        errors.append(f"{world} {arch}: KV bytes a rank {st['held']} != "
                      f"planned {st['planned']}")


def _check_serve(errors, tag, sv, ref):
    _close(errors, f"{tag} prefill logits", sv["prefill"], ref["prefill"])
    for i, (a, b) in enumerate(zip(sv["decode"], ref["decode"])):
        _close(errors, f"{tag} decode {i} logits", a, b)
    for key in ("greedy", "tokens"):
        if key in sv and not np.array_equal(sv[key], ref["tokens"]):
            errors.append(f"{tag} {key} {sv[key].tolist()} != "
                          f"{ref['tokens'].tolist()}")


@pytest.mark.parametrize("world", list(WORLDS))
def test_placed_kv_cache_equals_jax(world, tmp_path):
    """Every case of one world in one spawn, while the parent computes the
    JAX references; every failure reported together."""
    got = []
    t = threading.Thread(target=_spawn, args=(world, tmp_path, got))
    t.start()
    refs = {(arch, padded): _jax_serve(arch, padded)
            for arch in ARCHS for padded in (False, True)}
    if world == "1x2":
        for attn in WHISPER_ATTNS:
            refs[(WHISPER, attn)] = _jax_serve(WHISPER, False, attn)
    t.join()
    assert got, "a rank failed"
    res, errors = got[0], []
    for arch in ARCHS:
        _check_state(errors, world, arch, res[f"state-{arch}"])
        _check_serve(errors, f"{world} {arch}", res[f"serve-{arch}"],
                     refs[(arch, False)])
        _check_serve(errors, f"{world} {arch} padded",
                     res[f"padded-{arch}"], refs[(arch, True)])
        for kind in ("resume", "lanes"):
            r = res[f"{kind}-{arch}"]
            assert len(r["placed"]) == len(r["one"]) > 1
            for i, (a, b) in enumerate(zip(r["placed"], r["one"])):
                _close(errors, f"{world} {arch} {kind} {i}", a, b)
    for name in (n for n in res if n.startswith("uniform-")):
        u = res[name]
        want = "KVCache" if name == "uniform-2" else "KVCacheRows"
        if u["type"] != want:
            errors.append(f"{world} {name}: a {u['type']}, want {want}")
        for key in ("step", "resumed"):
            _close(errors, f"{world} {name} {key}", u["placed"][key],
                   u["one"][key])
        _close(errors, f"{world} {name} uniform row", u["placed"]["step"]
               [:1], u["uniform_step_row0"])
    for name in (n for n in res if n.startswith("refusals-")):
        if res[name]["raised"] != [True, True]:
            errors.append(f"{world} {name}: raised {res[name]}")
    if world == "1x2":
        for attn in WHISPER_ATTNS:
            sv = res[f"serve-whisper-{attn}"]
            _check_serve(errors, f"whisper {attn}", sv,
                         refs[(WHISPER, attn)])
            _check_whisper_heads(errors, attn, sv["seen"])
        _check_whisper_moments(errors, res["moments-whisper"])
    assert not errors, "\n".join(errors)


def _check_whisper_heads(errors, attn, seen):
    """Serving whisper on (1, 2): the encoder's self-attention, the
    decoder's prefill and decode steps and its cross-attention each hold
    wq, wk, wv and wo on the rank's 2 of 4 heads, the GELU MLPs wi and wo
    on 64 of 128 ff columns, every attention call runs on 2 heads, and
    no leaf is gathered whole over "model"."""
    cfg = KC.C.config(WHISPER, attn)
    d, h, hd, ff = cfg.d_model, cfg.n_heads // 2, cfg.head_dim, cfg.d_ff // 2
    proj = ((d, h, hd),) * 3 + ((h, hd, d),)
    want = {
        "attention": {(site,) + proj for site in (
            "noncausal", "cross", "prefill", "decode")},
        "mlp": {((d, ff), (ff, d))},
        "heads": {(entry, h, h, h) for entry in ("attention", "prefill",
                                                 "step")},
        "whole": []}
    for key, value in want.items():
        if seen[key] != value:
            errors.append(f"whisper {attn} {key}: {seen[key]} != {value}")


def _check_whisper_moments(errors, st):
    """Whisper's decoder moments (fastmax2) on (1, 2): heads mode, each
    rank's m0..g2 the block of 2 of 4 kv heads, bytes = planned."""
    if st["modes"] != ["heads", None] or not st["shapes_ok"] \
            or st["whole_split"] or st["held"] != [st["planned"]] * 2:
        errors.append(f"whisper moments: {st}")


# ---------------------------------------------------------------------------
# The dry run: executed = planned argument bytes of the softmax cells
# ---------------------------------------------------------------------------

_ATTN_ARCHS = sorted(a for a in D.all_arch_ids() if a != "xlstm-1.3b")
_KV_CELLS = ([(a, s, False) for a in _ATTN_ARCHS
              for s in ("decode_32k", "prefill_32k")]
             + [(a, "decode_32k", True) for a in (
                 "qwen3-1.7b", "granite-20b", "llama3-405b",
                 "deepseek-v2-236b")]
             + [("jamba-v0.1-52b", "long_500k", False)])


@pytest.mark.parametrize("arch, shape, multi", _KV_CELLS)
def test_placed_softmax_arguments_are_the_planned_bytes(arch, shape, multi):
    """The placed step's argument bytes on rank 0 equal the planned ones,
    part by part, with the softmax KV cache the rank's block; jamba's
    batch-1 SSM states as `_ssm_state_bytes` holds them."""
    res = D.run_cell(arch, shape, multi_pod=multi, attn="softmax")
    assert "skipped" not in res, res
    ex, pl = res["executed"], res["planned"]
    for part in ("params", "opt_state", "batch"):
        assert ex.get(part, 0) == pl[part], part
    names, sizes = MESHES["multi" if multi else "single"]
    planned_ssm, held_ssm = _ssm_state_bytes(arch, shape,
                                             dict(zip(names, sizes)))
    assert ex["decode_state"] == pl["decode_state"] - planned_ssm \
        + held_ssm
    assert pl["decode_state"] > planned_ssm
    if shape != "long_500k":
        assert held_ssm == planned_ssm
        assert ex["argument_bytes"] == pl["total"]
    assert SHAPES[shape].kind in ("decode", "prefill")
