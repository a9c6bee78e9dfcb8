"""The port's schedule autotuner (`repro_torch.kernels.autotune`) on the CPU.

Against the reference (`repro.kernels.autotune`) where the two share a
contract: the env modes, the key string's shared fields, `divisors`, and a
cache file written by the reference, which the port reads as misses. Then
the port's own contracts, mirroring `tests/test_autotune.py` where they
carry over: valid candidate sets holding the default, a deterministic cost
model that refuses what the kernels refuse, defaults equal to the
wrappers' constants (and to the CUDA sources'), the cache modes, and the
committed cache. The plumbing from `kernels.ops` to the C entry points is
held with a fake library that records each launch's arguments: with the
autotuner off they are the wrappers' constants, and a forced or cached
schedule reaches them. No kernel runs here; the schedules are held against
the plain versions on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py [autotune]`).
"""
import contextlib
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro.kernels import tiling as jtiling
from repro_torch.core.ref import normalize_qk
from repro_torch.kernels import autotune as at
from repro_torch.kernels import fastmax_causal as _fc
from repro_torch.kernels import fastmax_causal_bwd as _fb
from repro_torch.kernels import fastmax_decode as _fd
from repro_torch.kernels import fastmax_noncausal as _fn
from repro_torch.kernels import ops
from repro_torch.kernels import tiling
from repro_torch.kernels.autotune import Schedule, ShapeKey
from torch_threads import share_cores  # noqa: F401,E402

CSRC = Path(_fc.__file__).resolve().parent / "csrc"


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    """Autotune off, a throwaway cache path (never the committed one), no
    memo or provenance left from another test."""
    for name in ("REPRO_TORCH_AUTOTUNE", "REPRO_AUTOTUNE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "cache.json"))
    at.clear_lookups()
    at._MEMO.clear()
    yield
    at.clear_lookups()
    at._MEMO.clear()


def _key(kernel, n=40, d=16, dv=16, g=2, bh=4, dtype="float32",
         platform="cpu"):
    return ShapeKey(kernel, n, d, dv, g, bh, 2, dtype, platform)


def _lookup(kernel, device="cpu", **kw):
    args = dict(n=40, d=16, dv=16, g=2, bh=4, p=2, dtype=torch.float32)
    args.update(kw)
    return at.lookup_schedule(kernel, device=torch.device(device), **args)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env", ["", "0", "off", "never", "1", "on",
                                 "always", "offline", " OFFLINE ", "On",
                                 "banana", "2"])
def test_autotune_mode_matches_reference(monkeypatch, env):
    monkeypatch.setenv("REPRO_AUTOTUNE", env)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", env)
    try:
        want = jat.autotune_mode()
    except ValueError:
        with pytest.raises(ValueError, match="REPRO_TORCH_AUTOTUNE"):
            at.autotune_mode()
        return
    assert at.autotune_mode() == want


def test_mode_defaults_to_off():
    assert at.autotune_mode() == jat.autotune_mode() == "off"


@pytest.mark.parametrize("kernel", at.KERNELS)
def test_key_str_agrees_with_reference_on_shared_fields(kernel):
    ours = at.key_str(ShapeKey(kernel, 1024, 128, 64, 2, 32, 2, "bfloat16",
                               "cuda"))
    ref = jat.key_str(jat.ShapeKey(kernel, 1024, 128, 64, 2, 2, "bfloat16",
                                   "cuda"))
    assert ours.replace("bh=32,", "") == ref
    assert ",bh=32," in ours


@pytest.mark.parametrize("n", [1, 2, 12, 16, 97, 128, 192, 2145])
def test_divisors_agree(n):
    assert tiling.divisors(n) == jtiling.divisors(n)


def test_reference_cache_file_reads_as_misses(monkeypatch, tmp_path):
    """A cache the reference wrote (its schedule fields bm, blk,
    chunk_size, grid), even under the port's key strings, is read and
    yields misses: the cost model's schedule, never a decoded one."""
    path = tmp_path / "ref.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "offline")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    ref_sched = {"bm": 4, "blk": 16, "chunk_size": 128, "grid": "parallel"}
    keys = [_key(k) for k in at.KERNELS]
    jat.save_cache(str(path), {
        **{at.key_str(k): {"schedule": ref_sched, "source": "measured"}
           for k in keys},
        jat.key_str(jat.ShapeKey("decode", 1, 16, 16, 2, 2, "float32",
                                 "cpu")): {"schedule": ref_sched}})
    assert len(at.load_cache(str(path))) == len(keys) + 1
    for k in keys:
        s = _lookup(k.kernel, n=k.n)
        assert s == at.tune(k)[0]
        rec = next(r for r in at.snapshot_lookups()
                   if r["key"] == at.key_str(k))
        assert rec["cache"] == "miss" and rec["source"] == "cost_model"


# ---------------------------------------------------------------------------
# candidates, defaults, cost model
# ---------------------------------------------------------------------------

KEYS = [_key("causal_fwd"), _key("causal_fwd", d=128, dv=128),
        _key("hybrid_fwd", dv=96), _key("hybrid_fwd", d=128, dv=128),
        _key("causal_fwd", dv=64), _key("decode", n=1), _key("decode", n=1,
                                                            d=4, dv=4),
        _key("decode", n=1, d=128, dv=128, g=48), _key("noncausal"),
        _key("noncausal", n=1, g=1, d=64, dv=64),
        _key("noncausal", n=3, g=4)] + at.gate_keys("cuda")


@pytest.mark.parametrize("key", KEYS, ids=at.key_str)
def test_candidates_are_valid_and_contain_the_default(key):
    cands = at.candidate_schedules(key.kernel, key)
    assert cands[0] == at.default_schedule(key.kernel, key.d, key.dv)
    assert all(math.isfinite(at.cost_model(key, s)) for s in cands)
    effects = [at._effect(key, s) for s in cands]
    assert len(set(effects)) == len(effects)
    for s in cands:
        if key.kernel == "decode":
            assert 1 <= s.group <= 16 and s.rows >= 1
        elif key.kernel == "noncausal":
            assert 0 <= s.split <= 16 and s.rows >= 1
        else:
            assert s.cols in (64, 128) and s.rows is s.group is s.split \
                is None


def test_candidate_counts_at_the_gate_shapes():
    """The knobs the gate shapes really have: two column counts for the
    forward combines at Dv = 128, five row blocks for decode (times three
    groups at G = 48), and the split combine's five row blocks plus the row
    combine at whisper's N = 1."""
    got = {at.key_str(k): len(at.candidate_schedules(k.kernel, k))
           for k in at.gate_keys("cuda")}
    assert list(got.values()) == [2, 2, 2, 5, 5, 5, 15, 1, 1, 6, 2], got


def test_candidates_reject_unknown_kernel():
    with pytest.raises(ValueError, match="unknown kernel"):
        at.candidate_schedules("softmax", _key("decode"))
    with pytest.raises(ValueError, match="unknown kernel"):
        at.default_schedule("softmax", 16, 16)
    # the backward kernel has no knob, so no schedule
    with pytest.raises(ValueError, match="unknown kernel"):
        at.default_schedule("causal_bwd", 128, 128)


REFUSED = [
    (_key("decode", n=1), Schedule(rows=512, group=17)),
    (_key("decode", n=1), Schedule(rows=512, group=0)),
    (_key("decode", n=1), Schedule(rows=0, group=16)),
    (_key("decode", n=1), Schedule(rows=512, group=16, cols=64)),
    (_key("decode", n=1), Schedule(rows=512)),
    (_key("decode", n=1, dv=2048), Schedule(rows=512, group=16)),
    (_key("causal_fwd"), Schedule(cols=128)),           # Dv = 16 <= 64
    (_key("causal_fwd", dv=128), Schedule(cols=96)),
    (_key("causal_fwd", dv=128), Schedule(cols=256)),
    (_key("hybrid_fwd", dv=128), Schedule(cols=128, rows=128)),
    (_key("hybrid_fwd", dv=64), Schedule(cols=128)),      # Dv = 64
    (_key("decode", n=1), Schedule(rows=512, group=16, split=16)),
    (_key("noncausal"), Schedule(rows=128, split=17)),
    (_key("noncausal"), Schedule(rows=128, split=-1)),
    (_key("noncausal"), Schedule(rows=0, split=16)),
    (_key("noncausal"), Schedule(rows=128.0, split=16)),
    (_key("noncausal"), Schedule(rows=True, split=16)),
]


@pytest.mark.parametrize("key, sched", REFUSED)
def test_cost_model_refuses_what_the_kernels_refuse(key, sched):
    assert at.cost_model(key, sched) == math.inf


@pytest.mark.parametrize("key", KEYS, ids=at.key_str)
def test_cost_model_is_deterministic(key):
    for s in at.candidate_schedules(key.kernel, key):
        a, b = at.cost_model(key, s), at.cost_model(key, s)
        assert a == b and 0 < a < math.inf
    assert at.tune(key) == at.tune(key)
    assert at.tune(key)[1] == "cost_model"


@pytest.mark.parametrize("key", at.gate_keys("cuda"), ids=at.key_str)
def test_cost_model_keeps_the_default_within_its_margin(key):
    """The model's winner is the default unless it predicts a gain over the
    default of more than MODEL_MARGIN."""
    cands = at.candidate_schedules(key.kernel, key)
    scores = [at.cost_model(key, s) for s in cands]
    sched, source, score = at.tune(key)
    assert source == "cost_model"
    if min(scores) > (1 - at.MODEL_MARGIN) * scores[0]:
        assert (sched, score) == (cands[0], scores[0])
    else:
        assert score == min(scores) and sched == cands[scores.index(score)]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_cost_model_decode_rows_at_the_main_path_are_measured_best(
        arch, platform):
    """Offline (the cost model) at the decode shapes qwen3 and jamba serve
    picks rows 512 or 1024, the two the H100 measured fastest there (rows
    2048 measured 9 % slower than the default, PERF.md)."""
    d, dv, g, hkv = at._attention_dims(arch)
    key = ShapeKey("decode", 1, d, dv, g, 4 * hkv, 2, "bfloat16", platform)
    assert key in at.gate_keys(platform)
    sched = at.tune(key)[0]
    assert sched.rows in (512, 1024) and sched.group == 16


FORCED_ELSEWHERE = [
    ("prefill", Schedule(rows=512, group=16)),
    ("prefill", Schedule(cols=96)),
    ("decode", Schedule(cols=128)),
    ("decode", Schedule(rows=512, group=17)),
    ("noncausal", Schedule(cols=64)),
    ("noncausal", Schedule(rows=128, split=17)),
    ("hybrid", Schedule(rows=128, split=16)),
]


@pytest.mark.parametrize("route, sched", FORCED_ELSEWHERE)
def test_forced_schedule_the_kernel_does_not_take_raises(fake_lib, route,
                                                         sched):
    """A forced schedule of another kernel, or a knob out of range, is
    refused by name before any launch."""
    q, k, v = _qkv(1, 4, 2, 1 if route == "decode" else 40, 16, 128)
    call = {
        "prefill": lambda: ops.fastmax_prefill_kernel(q, k, v,
                                                      schedule=sched),
        "decode": lambda: ops.fastmax_decode(q, k, v, _state(1, 2, 16, 128),
                                             schedule=sched),
        "noncausal": lambda: ops.fastmax(q, k, v, causal=False,
                                         schedule=sched),
        "hybrid": lambda: ops.hybrid_prefill_kernel(q, k, v, window=8,
                                                    chunk_size=16,
                                                    schedule=sched)}[route]
    with pytest.raises(ValueError, match="kernel does not take schedule"):
        call()
    assert fake_lib.calls == []


@pytest.mark.parametrize("dv", [4, 16, 64, 68, 96, 128, 192])
def test_default_schedule_is_the_wrappers_constants(dv):
    """A later change to a wrapper's constant cannot drift from the
    autotuner's default, nor a Python constant from its CUDA source."""
    assert at.default_schedule("decode", 128, dv) == Schedule(
        rows=_fd.M2_ROWS_PER_BLOCK, group=_fd.GROUP) == Schedule(
        rows=512, group=16)
    assert at.default_schedule("noncausal", 64, dv) == Schedule(
        rows=_fn.SPLIT_ROWS, split=_fn.MAX_SPLIT_ROWS) == Schedule(
        rows=128, split=16)
    for kernel in ("causal_fwd", "hybrid_fwd"):
        assert at.default_schedule(kernel, 64, dv).cols == 64 * (
            2 if dv > 64 else 1) == _fc.COLS * _fc.column_groups(dv)
    src = {f: (CSRC / f).read_text() for f in (
        "fastmax_decode.cu", "fastmax_noncausal.cu", "feature_table.cuh")}
    assert re.search(r"constexpr int kMaxG = (\d+);",
                     src["fastmax_decode.cu"]).group(1) == str(at.MAX_GROUP)
    assert re.search(r"constexpr int kMaxQ = (\d+);",
                     src["fastmax_noncausal.cu"]).group(1) == str(
        _fn.MAX_SPLIT_ROWS)
    assert re.search(r"constexpr int kCols = (\d+);",
                     src["feature_table.cuh"]).group(1) == str(_fc.COLS)


# ---------------------------------------------------------------------------
# modes, provenance, cache
# ---------------------------------------------------------------------------

def test_mode_off_returns_none_and_records_the_default():
    assert _lookup("decode", n=1) is None
    assert _lookup("decode", n=1, device="cuda") is None
    recs = at.snapshot_lookups()
    assert [r["key"].split("|")[-1] for r in recs] == ["cpu", "cuda"]
    assert all(r["cache"] == "off" and r["source"] == "default"
               and r["schedule"] == {"rows": 512, "cols": None, "group": 16,
                                     "split": None} for r in recs)


def test_offline_mode_uses_cache_then_cost_model(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "offline")
    path = tmp_path / "cache.json"
    s1 = _lookup("decode", n=1)
    assert s1 == at.tune(_key("decode", n=1))[0]
    assert at.snapshot_lookups()[-1]["cache"] == "miss"
    assert not path.exists()            # offline never writes
    planted = Schedule(rows=128, group=4)
    at.save_cache(str(path), {at.key_str(_key("decode", n=1)): {
        "schedule": dict(planted._asdict()), "source": "measured"}})
    at.clear_lookups()
    assert _lookup("decode", n=1) == planted
    rec = at.snapshot_lookups()[-1]
    assert rec["cache"] == "hit" and rec["source"] == "measured"


def test_on_mode_on_cpu_never_measures(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")

    def no_measure(*a, **k):
        raise AssertionError("measured off the card")

    monkeypatch.setattr(at, "measure", no_measure)
    for kernel in at.KERNELS:
        assert isinstance(_lookup(kernel), Schedule)
    assert {r["source"] for r in at.snapshot_lookups()} == {"cost_model"}
    # a CUDA key off the card takes the cost model too
    assert isinstance(_lookup("decode", n=1, device="cuda"), Schedule)
    assert at.snapshot_lookups()[-1]["source"] == "cost_model"


def test_on_mode_persists_only_to_an_explicit_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    path = tmp_path / "mine.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    s = _lookup("noncausal", n=1, g=1)
    ks = at.key_str(_key("noncausal", n=1, g=1))
    entry = at.load_cache(str(path))[ks]
    assert entry["schedule"] == dict(s._asdict())
    assert entry["source"] == "cost_model" and "card" not in entry
    at.clear_lookups()
    assert _lookup("noncausal", n=1, g=1) == s
    assert at.snapshot_lookups()[-1]["cache"] == "hit"
    # without the variable: the default cache is read, never written
    default = tmp_path / "committed.json"
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    monkeypatch.setattr(at, "DEFAULT_CACHE", str(default))
    assert isinstance(_lookup("decode", n=1), Schedule)
    assert not default.exists()


def test_stale_entry_is_a_miss(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "offline")
    path = tmp_path / "cache.json"
    key = _key("decode", n=1)
    for bad in ({"rows": 512, "cols": None, "group": 17, "split": None},
                {"rows": 512, "cols": 64, "group": 16, "split": None},
                {"rows": 512, "group": 16},
                {"rows": 512, "cols": None, "group": 16, "split": None,
                 "grid": "parallel"}):
        at.save_cache(str(path), {at.key_str(key): {"schedule": bad}})
        at.clear_lookups()
        s = _lookup("decode", n=1)
        assert math.isfinite(at.cost_model(key, s))
        assert at.snapshot_lookups()[-1]["cache"] == "miss"


def test_lookups_are_memoized(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "offline")
    calls = []
    real = at.tune
    monkeypatch.setattr(at, "tune", lambda *a, **k: calls.append(a)
                        or real(*a, **k))
    for _ in range(3):
        _lookup("decode", n=1)
    assert len(calls) == 1
    at.clear_lookups()
    _lookup("decode", n=1)
    assert len(calls) == 1 and len(at.snapshot_lookups()) == 1


def test_cache_round_trip(tmp_path):
    path = tmp_path / "rt.json"
    entries = {"k1": {"schedule": {"rows": 256, "cols": None, "group": 8,
                                   "split": None},
                      "source": "measured", "score": 3e-4,
                      "card": "NVIDIA H100 80GB HBM3, 700.00 W"}}
    at.save_cache(str(path), entries)
    assert at.load_cache(str(path)) == entries
    raw = json.loads(path.read_text())
    assert raw["version"] == at.CACHE_VERSION
    raw["version"] = at.CACHE_VERSION + 1
    path.write_text(json.dumps(raw))
    assert at.load_cache(str(path)) == {}


def test_check_passes_on_the_committed_cache(capsys):
    assert at.build_gate_entries() == at.build_gate_entries()
    at.main(["--check"])
    assert "OK (11 gate entries" in capsys.readouterr().out
    assert at.DEFAULT_CACHE != jat.DEFAULT_CACHE
    committed = at.load_cache(at.DEFAULT_CACHE)
    assert all("|cpu" in k for k in committed)


def test_check_fails_on_a_stale_cache(tmp_path, capsys):
    path = tmp_path / "stale.json"
    entries = at.build_gate_entries()
    ks = next(k for k in entries if k.startswith("decode"))
    entries[ks] = {"schedule": {"rows": 128, "cols": None, "group": 4,
                                "split": None}}
    at.save_cache(str(path), entries)
    with pytest.raises(SystemExit, match="1 stale entry"):
        at.main(["--check", "--cache", str(path)])
    at.main(["--write", "--cache", str(path)])
    at.main(["--check", "--cache", str(path)])
    assert "OK" in capsys.readouterr().out.splitlines()[-1]


def test_hardware_label_off_the_card():
    assert at.hardware_label() == "cpu-plain"


def test_measure_refuses_off_the_card():
    with pytest.raises(RuntimeError, match="on the card"):
        at.measure(_key("decode", n=1, platform="cuda"),
                   Schedule(rows=512, group=16))
    with pytest.raises(RuntimeError, match="on the card"):
        at.measure(_key("decode", n=1), Schedule(rows=512, group=16))


def test_timing_launches_leave_the_launch_counts_alone():
    ops.reset_launch_counts()
    _fd.launches = 3
    with pytest.raises(ZeroDivisionError):
        with at._uncounted():
            _fd.launches += 7
            _fn.combine_launches += 2
            1 / 0
    assert ops.launch_counts()["fastmax_decode"] == 3
    assert ops.launch_counts()["fastmax_noncausal_combine"] == 0
    ops.reset_launch_counts()


# ---------------------------------------------------------------------------
# plumbing: ops -> lookup -> wrapper -> the C entry's arguments
# ---------------------------------------------------------------------------

class _Cuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the wrappers take their
    kernel route; with `_TorchOnCpu` and a fake library nothing launches."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(t):
    return torch.Tensor._make_subclass(_Cuda, t.contiguous())


class _TorchOnCpu:
    """The `torch` a wrapper module sees: allocations land on the CPU (as
    `_Cuda` tensors), and the CUDA stream and device context are
    stand-ins."""

    class cuda:
        @staticmethod
        def current_stream(dev=None):
            return type("Stream", (), {"cuda_stream": 0})()

        @staticmethod
        def device(dev):
            return contextlib.nullcontext()

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def empty(*a, device=None, **kw):
        return _cuda(torch.empty(*a, **kw))

    @staticmethod
    def zeros(*a, device=None, **kw):
        return _cuda(torch.zeros(*a, **kw))

    @staticmethod
    def ones(*a, device=None, **kw):
        return _cuda(torch.ones(*a, **kw))


class _FakeLib:
    """Records each C entry point's name and arguments; returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name == "fastmax_noncausal_rows":
            return lambda d, p: _fc.feature_rows(d, p)
        return lambda *args: self.calls.append((name, args)) or 0

    def args(self, name):
        return [a for n, a in self.calls if n == name]


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    for mod in (_fc, _fb, _fd, _fn):
        monkeypatch.setattr(mod, "torch", _TorchOnCpu())
        monkeypatch.setattr(mod, "_lib", lambda: lib)
    return lib


def _qkv(b, hq, hkv, n, d, dv, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (_cuda(normalize_qk(torch.randn(b, hq, n, d, generator=g))),
            _cuda(normalize_qk(torch.randn(b, hkv, n, d, generator=g))),
            _cuda(torch.randn(b, hkv, n, dv, generator=g)))


def _state(b, hkv, d, dv):
    return tuple(_cuda(torch.zeros(s)) for s in (
        (b, hkv, dv), (b, hkv, d, dv), (b, hkv, d, d, dv), (b, hkv),
        (b, hkv, d), (b, hkv, d, d)))


# (rows, group) of the decode step's C call: the arguments after `p`;
# (ncg) of the combines; (rows, split) of the noncausal combine
def _decode_knobs(lib):
    return [a[17:19] for a in lib.args("fastmax_decode_step")]


def _combine_knobs(lib, name):
    return [a[16] for a in lib.args(name)]


@pytest.mark.parametrize("d, g", [(16, 2), (128, 48), (64, 1)])
def test_mode_off_decode_launch_arguments_are_the_constants(fake_lib, d, g):
    q, k, v = _qkv(2, 2 * g, 2, 1, d, d)
    ops.fastmax_decode(q, k, v, _state(2, 2, d, d))
    assert _decode_knobs(fake_lib) == [(min(512, d * d), 16)]
    rec = at.snapshot_lookups()[-1]
    assert rec["cache"] == "off" and rec["key"].endswith("|cuda")
    assert f"g={g},bh=4," in rec["key"]


def test_forced_and_cached_decode_schedules_reach_the_launch(
        fake_lib, monkeypatch, tmp_path):
    q, k, v = _qkv(1, 48, 1, 1, 128, 128)
    ops.fastmax_decode(q, k, v, _state(1, 1, 128, 128),
                       schedule=Schedule(rows=2048, group=8))
    assert _decode_knobs(fake_lib)[-1] == (2048, 8)
    # the scratch of the m2 partials follows the knobs: [bh, D*D / rows,
    # min(G, group), Dv]
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "offline")
    path = tmp_path / "cache.json"
    key = ShapeKey("decode", 1, 128, 128, 48, 1, 2, "float32", "cuda")
    at.save_cache(str(path), {at.key_str(key): {"schedule": dict(
        Schedule(rows=256, group=4)._asdict()), "source": "measured"}})
    ops.fastmax_decode(q, k, v, _state(1, 1, 128, 128))
    assert _decode_knobs(fake_lib)[-1] == (256, 4)
    assert at.snapshot_lookups()[-1]["cache"] == "hit"


def test_causal_launch_arguments(fake_lib):
    """The prefill's and the hybrid's combines take the column groups of
    `column_groups` with the autotuner off, a forced `cols` otherwise; the
    backward has no knob: no lookup, and its launches take the arguments
    they took before the autotuner (20 and 19)."""
    q, k, v = _qkv(1, 4, 2, 40, 16, 128)
    ops.fastmax_prefill_kernel(q, k, v)
    ops.fastmax_prefill_kernel(q, k, v, schedule=Schedule(cols=64))
    assert _combine_knobs(fake_lib, "fastmax_causal_combine") == [2, 1]
    ops.hybrid_prefill_kernel(q, k, v, window=8, chunk_size=16)
    ops.hybrid_prefill_kernel(q, k, v, window=8, chunk_size=16,
                              schedule=Schedule(cols=64))
    assert [a[17] for a in fake_lib.args("hybrid_causal_combine")] == [2, 1]
    st = _state(1, 2, 16, 128)
    do = _cuda(torch.randn(1, 4, 40, 128))
    ops.fastmax_bwd(q, k, v, st, do)
    assert [len(a) for a in fake_lib.args("fastmax_causal_bwd_queries")] \
        == [20]
    assert [len(a) for a in fake_lib.args("fastmax_causal_bwd_keys")] == [19]
    kinds = [r["kernel"] for r in at.snapshot_lookups()]
    assert sorted(set(kinds)) == ["causal_fwd", "hybrid_fwd"]


@pytest.mark.parametrize("n, split, rows, route", [
    (1, None, None, (128, 16, True)),      # off: the split combine
    (40, None, None, (128, 16, False)),    # G·N = 80 > 16: the row combine
    (1, 0, 256, (256, 0, False)),          # forced: never split
    (1, 16, 1024, (1024, 16, True))])
def test_noncausal_launch_arguments(fake_lib, n, split, rows, route):
    q, k, v = _qkv(2, 4, 2, n, 64, 64)
    sched = None if split is None else Schedule(rows=rows, split=split)
    ops.fastmax(q, k, v, causal=False, schedule=sched)
    (args,) = fake_lib.args("fastmax_noncausal_combine")
    assert (args[16], args[17], args[8] is not None) == route
    recs = at.snapshot_lookups()
    assert [r["kernel"] for r in recs] == ([] if sched else ["noncausal"])


def test_training_op_consults_the_tuner_per_launch(monkeypatch):
    """The trainable causal op takes `causal_fwd`'s schedule (or the forced
    one) at its forward launch; its backward launch takes none and makes
    no lookup."""
    got = []

    def fwd(q, k, v, kv_mask=None, *, p, denom_eps, init_state, schedule):
        got.append(("fwd", schedule))
        b, _, n, d = q.shape
        dv, hkv = v.shape[-1], k.shape[1]
        return (torch.zeros(q.shape[:3] + (dv,)), _state(b, hkv, d, dv))

    def bwd(q, k, v, state, do, *, p, denom_eps, return_dstate):
        got.append(("bwd",))
        return (torch.zeros(q.shape), torch.zeros(k.shape),
                torch.zeros(v.shape))

    monkeypatch.setattr(_fc, "fastmax_causal_cuda", fwd)
    monkeypatch.setattr(_fb, "fastmax_causal_bwd_cuda", bwd)
    for forced in (None, Schedule(cols=64)):
        got.clear()
        at.clear_lookups()
        q, k, v = (t.requires_grad_(True) for t in _qkv(1, 4, 2, 40, 16,
                                                        16))
        ops.fastmax(q, k, v, schedule=forced).sum().backward()
        assert got == [("fwd", forced), ("bwd",)]
        assert [r["kernel"] for r in at.snapshot_lookups()] == (
            ["causal_fwd"] if forced is None else [])


def test_cpu_plain_path_ignores_the_schedule(monkeypatch):
    """On CPU tensors the plain versions run: a tuned or forced schedule
    is recorded (tuned) but changes no bit."""
    g = torch.Generator().manual_seed(1)
    q = normalize_qk(torch.randn(1, 4, 24, 16, generator=g))
    k = normalize_qk(torch.randn(1, 2, 24, 16, generator=g))
    v = torch.randn(1, 2, 24, 16, generator=g)
    base = ops.fastmax(q, k, v).numpy()
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "offline")
    tuned = ops.fastmax(q, k, v).numpy()
    forced = ops.fastmax(q, k, v, schedule=Schedule(cols=64)).numpy()
    assert base.tobytes() == tuned.tobytes() == forced.tobytes()
    assert np.isfinite(base).all()
    rec = at.snapshot_lookups()[-1]
    assert rec["cache"] == "miss" and rec["key"].endswith("|cpu")
