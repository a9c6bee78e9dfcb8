"""The moment decode states without a decode kernel (fastmax chunked,
hybrid chunked, hybrid kernel) and the hybrid window as the rank's block
of the reference's `decode_state_shardings` in the placed serve step
(`attention/state.py` under an active mesh) against the reference on the
CPU.

- Gloo worlds (data 1, model 2), (1, 4) and (2, 2), one spawn each
  running `tests/torch_placed_hybrid_cases.py` (no JAX), float64 with the
  float32 islands lifted on both sides (`tests/test_torch_placed.py`):
  - each rank's moments and window have their block's shape, no leaf the
    plan splits over "model" is held whole, and the bytes a rank are the
    planned ones: the smoke qwen3-1.7b (2 kv heads) in heads mode on
    "model" 2 (moments and window by kv heads), in feature mode on 4
    (m0, m1, m2 by Dv, the window by rows, a `KVCacheRows`), the smoke
    granite-20b (1 kv head) in feature mode on every world, under
    `hybrid2-chunked` and `fastmax2`;
  - prefill and greedy decode of both configs under `hybrid2-chunked`,
    `hybrid2-kernel` (the hybrid kernel's plain version, on the plan's
    shards) and `fastmax2` against JAX's `lm_prefill` /
    `lm_decode_step`: logits within TOL = 1e-10 of scale, tokens equal
    (and the placed steps' tokens). The hybrid prefill's first W_EFF
    rows, where every key is in the band, are held to one process's
    prefill at TOL, and to JAX at TOL_BAND = 1e-9 of scale: there the
    reference sums f_p(ŝ) and the band's (exp(ŝ) - f_p(ŝ)) apart and the
    port each pair's exp(ŝ) (ROADMAP queue 3), which leaves the smoke
    qwen3's logits 1.95e-10 of scale apart in one process already. A
    prompt of 20 tokens, past the smoke chunk of 16, so the window (W =
    16, rows 8 or 4 a rank) is full after the prefill, and 4 decode tokens, each of which shifts a
    row across every block boundary; a left-padded prompt too;
  - a resumed (`offset=`) prefill of a left-padded prompt (the window's
    rows gathered whole for the scan's previous-chunk buffer) and its
    decode, against the same calls in one process;
  - a state that is not the rank's block raises.
- The dry run (`launch/dryrun.py`, a fake world of 256 or 512 ranks on
  meta): the placed step's argument bytes on rank 0 equal the planned
  ones, part by part, for `--attn hybrid2-kernel` at `decode_32k` and
  `prefill_32k` for every config with a causal attention layer (whisper
  excepted: the reference refuses a hybrid encoder), for `--attn
  fastmax2` at `decode_32k` for every attention config, and at
  `decode_32k` on two pods under `hybrid2-kernel` for qwen3, granite,
  llama3-405b and deepseek-v2.
"""
import functools
import threading

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import torch_placed_hybrid_cases as HC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import SHAPES  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from test_torch_dryrun import MESHES, _ssm_state_bytes  # noqa: E402
from test_torch_placed import (TOL, _jcfg, _jtree,  # noqa: E402
                               _reference_in_float64, _weights)
from torch_threads import share_cores  # noqa: F401,E402

B, PLEN, NDEC, MAX_LEN = 4, 20, 4, 32
WORLDS = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
ARCHS = ("qwen3-1.7b", "granite-20b")
ATTNS = ("hybrid2-chunked", "hybrid2-kernel", "fastmax2")
PLACED_STATE = ("hybrid2-chunked", "fastmax2")
SPLIT = 9                # the resumed prefill's chunk: tokens 9-19
W_EFF = 16               # the smoke chunk: the band's reach, min(64, 16)
# the hybrid prefill's first W_EFF rows against JAX, of scale: five times
# the 1.95e-10 one process reads there (ROADMAP queue 3, band-only rows)
TOL_BAND = 1e-9


@functools.lru_cache(maxsize=None)
def _prompt():
    return np.random.default_rng(21).integers(0, 512, (B, PLEN),
                                              dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _kv_mask():
    """Rows 0 and 2 left-padded by 5 tokens, row 1 by 12 (past SPLIT)."""
    m = np.ones((B, PLEN))
    m[0, :5] = m[2, :5] = 0.0
    m[1, :12] = 0.0
    return m


@functools.lru_cache(maxsize=None)
def _jax_serve(arch, attn, padded: bool):
    """JAX's prefill and greedy decode of the prompt (with the padded
    kv_mask), float64 islands."""
    jcfg = _jcfg(arch, attn)
    mask = jnp.asarray(_kv_mask()) if padded else None
    with _reference_in_float64():
        params = _jtree(_weights(arch))
        state = JT.init_lm_decode_state(jcfg, B, MAX_LEN)
        logits, state = jax.jit(lambda p, t, s: JT.lm_prefill(
            p, t, jcfg, s, kv_mask=mask))(params, jnp.asarray(_prompt()),
                                          state)
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


def _cases(world):
    m = WORLDS[world][1]
    out = []
    for arch in ARCHS:
        for attn in ATTNS:
            common = dict(arch=arch, attn=attn, params=_weights(arch),
                          max_len=MAX_LEN, n_dec=NDEC)
            if attn in PLACED_STATE:
                out += [dict(name=f"state-{arch}-{attn}", kind="state",
                             batch_size=B, **common),
                        dict(name=f"resume-{arch}-{attn}", kind="resume",
                             tokens=_prompt(), kv_mask=_kv_mask(),
                             split=SPLIT, **common)]
            out += [dict(name=f"serve-{arch}-{attn}", kind="serve",
                         tokens=_prompt(), **common),
                    dict(name=f"padded-{arch}-{attn}", kind="serve",
                         tokens=_prompt(), kv_mask=_kv_mask(), **common)]
    for attn in PLACED_STATE:
        for hkv in (1, 2) if m == 2 else (1,):
            out.append(dict(name=f"refusals-{attn}-{hkv}", kind="refusals",
                            attn=attn, hkv=hkv))
    return out


def _close(errors, name, got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        errors.append(f"{name}: shape {got.shape} != {want.shape}")
        return
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    if not err <= tol * max(1.0, float(np.max(np.abs(want)))):
        errors.append(f"{name}: max |diff| {err:.3e}")


def _spawn(world, tmp_path, out):
    shape = WORLDS[world]
    out.append(run_ranks(HC.hybrid_cases, shape[0] * shape[1],
                         args=(shape, _cases(world)), workdir=tmp_path,
                         timeout=400)[0])


def _check_state(errors, world, arch, attn, st):
    m = WORLDS[world][1]
    heads = arch == "qwen3-1.7b" and m == 2
    hybrid = attn.startswith("hybrid")
    want = (["heads", "heads" if hybrid else None],
            ["KVCache" if hybrid else "NoneType"]) if heads else \
        (["feature", "sequence" if hybrid else None],
         ["KVCacheRows" if hybrid else "NoneType"])
    if (st["modes"], st["types"]) != want:
        errors.append(f"{world} {arch} {attn}: {st['modes']} "
                      f"{st['types']}, want {want}")
    if not st["shapes_ok"] or st["whole_split"]:
        errors.append(f"{world} {arch} {attn}: a leaf is not its block "
                      f"(split leaves held whole {st['whole_split']})")
    if st["held"] != [st["planned"]] * len(st["held"]):
        errors.append(f"{world} {arch} {attn}: state bytes a rank "
                      f"{st['held']} != planned {st['planned']}")


def _check_serve(errors, tag, sv, ref, hybrid: bool):
    _close(errors, f"{tag} prefill logits, one process",
           sv["prefill"], sv["prefill_one"])
    rows = slice(W_EFF if hybrid else 0, None)
    _close(errors, f"{tag} prefill logits", sv["prefill"][:, rows],
           ref["prefill"][:, rows])
    if hybrid:
        _close(errors, f"{tag} prefill logits, band-only rows",
               sv["prefill"][:, :W_EFF], ref["prefill"][:, :W_EFF],
               TOL_BAND)
    for i, (a, b) in enumerate(zip(sv["decode"], ref["decode"])):
        _close(errors, f"{tag} decode {i} logits", a, b)
    for key in ("greedy", "tokens"):
        if key in sv and not np.array_equal(sv[key], ref["tokens"]):
            errors.append(f"{tag} {key} {sv[key].tolist()} != "
                          f"{ref['tokens'].tolist()}")


@pytest.mark.parametrize("world", list(WORLDS))
def test_placed_moment_states_equal_jax(world, tmp_path):
    """Every case of one world in one spawn, while the parent computes the
    JAX references; every failure reported together."""
    got = []
    t = threading.Thread(target=_spawn, args=(world, tmp_path, got))
    t.start()
    refs = {(arch, attn, padded): _jax_serve(arch, attn, padded)
            for arch in ARCHS for attn in ATTNS for padded in (False, True)}
    t.join()
    assert got, "a rank failed"
    res, errors = got[0], []
    for arch in ARCHS:
        for attn in ATTNS:
            tag = f"{world} {arch} {attn}"
            for kind, padded in (("serve", False), ("padded", True)):
                sv = res[f"{kind}-{arch}-{attn}"]
                _check_serve(errors, f"{tag} {kind}", sv,
                             refs[(arch, attn, padded)],
                             attn.startswith("hybrid"))
                # one sharded hybrid kernel call a layer, under a plan
                want = 2 if attn == "hybrid2-kernel" else 0
                if sv["hybrid_prefill_sharded"] != want:
                    errors.append(f"{tag} {kind}: "
                                  f"{sv['hybrid_prefill_sharded']} sharded "
                                  f"hybrid prefills, want {want}")
            if attn not in PLACED_STATE:
                continue
            _check_state(errors, world, arch, attn,
                         res[f"state-{arch}-{attn}"])
            r = res[f"resume-{arch}-{attn}"]
            assert len(r["placed"]) == len(r["one"]) == 2 + NDEC
            for i, (a, b) in enumerate(zip(r["placed"], r["one"])):
                _close(errors, f"{tag} resume {i}", a, b)
    for name in (n for n in res if n.startswith("refusals-")):
        if res[name]["raised"] != [True, True]:
            errors.append(f"{world} {name}: raised {res[name]}")
    assert not errors, "\n".join(errors)



# ---------------------------------------------------------------------------
# The dry run: executed = planned argument bytes of the moment cells
# ---------------------------------------------------------------------------

_ATTN_ARCHS = sorted(a for a in D.all_arch_ids() if a != "xlstm-1.3b")
_CAUSAL_ARCHS = [a for a in _ATTN_ARCHS if a != "whisper-small"]
_MOMENT_CELLS = ([(a, s, False, "hybrid2-kernel") for a in _CAUSAL_ARCHS
                  for s in ("decode_32k", "prefill_32k")]
                 + [(a, "decode_32k", False, "fastmax2")
                    for a in _ATTN_ARCHS]
                 + [(a, "decode_32k", True, "hybrid2-kernel") for a in (
                     "qwen3-1.7b", "granite-20b", "llama3-405b",
                     "deepseek-v2-236b")])


@pytest.mark.parametrize("arch, shape, multi, attn", _MOMENT_CELLS)
def test_placed_moment_arguments_are_the_planned_bytes(arch, shape, multi,
                                                       attn):
    """The placed step's argument bytes on rank 0 equal the planned ones,
    part by part, with the moments and the hybrid window the rank's
    block (the SSM states as `_ssm_state_bytes` holds them)."""
    res = D.run_cell(arch, shape, multi_pod=multi, attn=attn)
    assert "skipped" not in res, res
    ex, pl = res["executed"], res["planned"]
    for part in ("params", "opt_state", "batch"):
        assert ex.get(part, 0) == pl[part], part
    names, sizes = MESHES["multi" if multi else "single"]
    planned_ssm, held_ssm = _ssm_state_bytes(arch, shape,
                                             dict(zip(names, sizes)))
    assert held_ssm == planned_ssm
    assert ex["decode_state"] == pl["decode_state"] > planned_ssm
    assert ex["argument_bytes"] == pl["total"]
    assert SHAPES[shape].kind in ("decode", "prefill")
