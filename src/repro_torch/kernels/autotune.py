"""Schedule autotuner for the port's CUDA kernels — port of
`repro/kernels/autotune.py`.

The kernels' launch shapes are constants chosen by hand in their wrappers.
This module sweeps a candidate set of schedules per (kernel, shape, dtype,
platform) and persists the winners, as the reference does:

  Schedule   the launch knobs the CUDA kernels take (as a launch argument,
             or as a template instance that is already compiled), threaded
             through `repro_torch.kernels.ops` into the wrappers; a field is
             None where the kernel has no such knob:
               rows   m2 / feature rows one block reads (decode's first
                      launch; the noncausal split combine);
               cols   value columns a pass, 64 x NCG with NCG in {1, 2}
                      (the causal and hybrid forwards' combine launch);
               group  queries of one head a decode launch pair takes, 1..16;
               split  the largest G·N sent to the noncausal split combine
                      rather than `combine_rows_kernel`, 0..16.
             The reference's knobs do not carry over: `bm`/`blk` are Pallas
             block shapes, `grid` is Mosaic's megacore semantics (nothing on
             a CUDA card corresponds), and the chunk is fixed at L = 128 in
             both causal kernels. Knobs that would need a new kernel body
             are left out: the chunk L, and a second column-group count for
             the causal launch A. The backward kernel has no knob at all: its
             queries and keys launches have no column loop, so one pass must
             cover all of D and Dv, and it makes no lookup.
  ShapeKey   (kernel, N, D, Dv, G, bh, p, dtype, platform). Unlike the
             reference's, it counts the (batch, kv-head) pairs `bh`: on an
             H100 they decide how many blocks fill the 132 SMs (granite's
             G = 48 decode at B = 4 has four). N is the query count (1 for
             decode); the noncausal key covers the combine, whose cost does
             not depend on the key count M (the moments launch has no knob).

Two scoring backends:

  * measured — launch the kernel's wrapper with the forced schedule on the
    card and time it with CUDA events (the median of k samples of
    back-to-back calls, after a warm-up). Only
    for a CUDA key on a machine with a card, and never during CUDA graph
    capture or while `torch.compile` traces (the counterpart of the
    reference's `_trace_clean`): those take the cost model.
  * cost model — a deterministic Hopper model (`cost_model`): each launch's
    bytes and operations over the card's rates, in waves of the blocks the
    SMs hold, plus a fixed launch cost; inf for what a kernel refuses. The
    only scorer off the card and in `offline` mode. It ranks; its seconds
    are not the card's, and it keeps the default unless a candidate beats it
    by more than MODEL_MARGIN.

Env protocol (read per lookup):

  REPRO_TORCH_AUTOTUNE=0 | unset  off — `lookup_schedule` returns None and
                           the wrappers launch with their constants, bit for
                           bit the launches of an autotune-free build.
  REPRO_TORCH_AUTOTUNE=1   on — cache lookup; on a miss, tune (measure on a
                           CUDA key, cost model elsewhere). The winner is
                           persisted to REPRO_TORCH_AUTOTUNE_CACHE when that
                           variable is set (the committed cache is the
                           CLI's); a measured entry carries the card's name
                           and power limit.
  REPRO_TORCH_AUTOTUNE=offline  cache lookup; on a miss, the cost model.
  REPRO_TORCH_AUTOTUNE_CACHE=path  the cache file (default: the committed
                           `src/repro_torch/kernels/autotune_cache.json`,
                           apart from the reference's).

A lookup costs a dict lookup after its key's first: the result is memoized
by key (a write through `save_cache` forgets its file's), the card's name is
read once per process, and nothing synchronizes the device. Every lookup
records a provenance entry (schedule, cache hit/miss/off, source) that
`snapshot_lookups` returns. A reference cache entry (fields bm, blk,
chunk_size, grid) and a stale one (a knob the kernel refuses at the key's
shape) read as misses.

CLI (the committed-cache workflow):

  python -m repro_torch.kernels.autotune --write   # cost-model winners
  python -m repro_torch.kernels.autotune --check   # fail if stale

The gate shapes are the shapes `chip_smoke.py` serves and trains (p = 2,
bf16), written under platform `cpu` by default: on the card, mode `on`
misses them and measures.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import fastmax_causal as _fc
from repro_torch.kernels import fastmax_decode as _fd
from repro_torch.kernels import fastmax_noncausal as _fn
from repro_torch.kernels import hybrid_causal as _hc

__all__ = ["Schedule", "ShapeKey", "KERNELS", "autotune_mode",
           "default_schedule", "candidate_schedules", "cost_model",
           "measure", "tune", "lookup_schedule", "load_cache", "save_cache",
           "key_str", "hardware_label", "clear_lookups", "snapshot_lookups",
           "check_schedule", "gate_keys", "build_gate_entries",
           "DEFAULT_CACHE", "CACHE_VERSION", "MODEL_MARGIN"]

KERNELS = ("causal_fwd", "decode", "noncausal", "hybrid_fwd")

CACHE_VERSION = 1
DEFAULT_CACHE = os.path.join(os.path.dirname(__file__),
                             "autotune_cache.json")
ENV_MODE = "REPRO_TORCH_AUTOTUNE"
ENV_CACHE = "REPRO_TORCH_AUTOTUNE_CACHE"

# cost-model card constants: one H100 SXM (NVIDIA's data sheet; PERF.md
# §3). Only the ranking of a key's candidates is used.
HBM_BYTES_S = 3.35e12       # device memory rate
F32_FLOPS = 67e12           # float32 on the CUDA cores
TF32_FLOPS = 495e12         # dense TF32 on the tensor cores
SMS = 132
SMEM_BLOCK = 232_448        # shared memory a block may use (227 KB)
SMEM_SM = 233_472           # shared memory of an SM (228 KB)
REGS_SM = 65_536
THREADS_SM = 2_048
LAUNCH_S = 3e-6             # fixed cost of one launch
# the predicted gain over the default below which the cost model keeps the
# default: on an H100 it put decode's rows=2048 0.7 % ahead of the default
# rows=512 at qwen3's and jamba's shapes, where the card measured it 9 %
# behind (PERF.md), so a smaller predicted gain is within its error
MODEL_MARGIN = 0.10

MAX_GROUP = 16              # kMaxG, csrc/fastmax_decode.cu
ROWS = (128, 256, 512, 1024, 2048)   # `rows` candidates, up to the table's


class Schedule(NamedTuple):
    """One schedule: the launch knobs of one kernel (None: no such knob)."""

    rows: Optional[int] = None
    cols: Optional[int] = None
    group: Optional[int] = None
    split: Optional[int] = None


class ShapeKey(NamedTuple):
    kernel: str
    n: int
    d: int
    dv: int
    g: int
    bh: int
    p: int
    dtype: str
    platform: str


def key_str(key: ShapeKey) -> str:
    return (f"{key.kernel}|n={key.n},d={key.d},dv={key.dv},g={key.g},"
            f"bh={key.bh},p={key.p}|{key.dtype}|{key.platform}")


def autotune_mode() -> str:
    """'off' | 'on' | 'offline' from REPRO_TORCH_AUTOTUNE (default off)."""
    env = os.environ.get(ENV_MODE, "0").strip().lower()
    if env in ("", "0", "off", "never"):
        return "off"
    if env in ("1", "on", "always"):
        return "on"
    if env == "offline":
        return "offline"
    raise ValueError(f"{ENV_MODE}={env!r}; expected 0, 1, or offline")


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


@functools.lru_cache(maxsize=None)
def hardware_label() -> str:
    """The card the kernels run on (`cuda:<name>`, read once per process),
    or `cpu-plain` where the wrappers run their plain versions: timings are
    never comparable across the two."""
    if torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name(0)}"
    return "cpu-plain"


@functools.lru_cache(maxsize=None)
def _card(index: int) -> str:
    """The card's name and power limit as nvidia-smi gives them, read once
    per process (a measured cache entry carries it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or f"{torch.cuda.get_device_name(index)}, power limit not read"


# ---------------------------------------------------------------------------
# candidate space
# ---------------------------------------------------------------------------

def default_schedule(kernel: str, d: int, dv: int) -> Schedule:
    """The untuned schedule: exactly the wrappers' own constants."""
    if kernel in ("causal_fwd", "hybrid_fwd"):
        return Schedule(cols=_fc.COLS * _fc.column_groups(dv))
    if kernel == "decode":
        return Schedule(rows=_fd.M2_ROWS_PER_BLOCK, group=_fd.GROUP)
    if kernel == "noncausal":
        return Schedule(rows=_fn.SPLIT_ROWS, split=_fn.MAX_SPLIT_ROWS)
    raise ValueError(f"unknown kernel {kernel!r}; expected {KERNELS}")


def _table_rows(key: ShapeKey) -> int:
    """Rows of the table the `rows` knob cuts: m2's D·D (decode) or the
    feature table's R (noncausal)."""
    if key.kernel == "decode":
        return key.d * key.d
    return _fc.feature_rows(key.d, key.p)


def _effect(key: ShapeKey, s: Schedule):
    """What a schedule changes in the launches at this key: two schedules
    of equal effect launch the same kernels with the same arguments."""
    if key.kernel == "decode":
        return (min(s.rows, _table_rows(key)) if key.p >= 2 else None,
                min(s.group, key.g))
    if key.kernel == "noncausal":
        if key.g * key.n <= s.split:
            return ("split", min(s.rows, _table_rows(key)))
        return ("rows", None)
    return s


def candidate_schedules(kernel: str, key: ShapeKey) -> list:
    """The bounded sweep set for one kernel and shape, the untuned default
    first. Every schedule in it is one the kernel takes at the key's shape
    (finite cost), and no two have the same effect (`_effect`)."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected {KERNELS}")
    default = default_schedule(kernel, key.d, key.dv)
    if kernel in ("causal_fwd", "hybrid_fwd"):
        cands = [Schedule(cols=c) for c in (64, 128)]
    else:
        rows = [default.rows] + [r for r in ROWS if r <= _table_rows(key)]
        if kernel == "decode":
            groups = [default.group] + [x for x in (4, 8, 16) if x <= key.g]
            cands = [Schedule(rows=r, group=x) for r in rows for x in groups]
        else:
            cands = [Schedule(rows=r, split=x) for x in (default.split, 0)
                     for r in rows]
    out, seen = [], set()
    for s in [default] + cands:
        if s == default or math.isfinite(cost_model(key, s)):
            eff = _effect(key, s)
            if eff not in seen:
                seen.add(eff)
                out.append(s)
    return out


# ---------------------------------------------------------------------------
# deterministic Hopper cost model
# ---------------------------------------------------------------------------

def _launch_s(blocks: int, threads: int, smem: int, regs: int,
              nbytes: float, flops: float, rate: float) -> float:
    """Seconds of one launch of `blocks` blocks, each moving `nbytes` and
    doing `flops` at `rate`: a fixed cost, then waves of the blocks the SMs
    hold (by threads, registers and shared memory); a block on an SM with
    k others resident gets 1/k of the SM's share of the card's rates. inf
    where a block cannot be placed."""
    if smem > SMEM_BLOCK or blocks < 1:
        return math.inf
    per_sm = min(THREADS_SM // threads, REGS_SM // (threads * regs),
                 SMEM_SM // max(smem, 1), 32)
    if per_sm < 1:
        return math.inf
    one = max(nbytes * SMS / HBM_BYTES_S, flops * SMS / rate)
    full, rest = divmod(blocks, SMS * per_sm)
    return LAUNCH_S + (full * per_sm + -(-rest // SMS)) * one


def _inb(key: ShapeKey) -> int:
    return {"bfloat16": 2, "float16": 2, "float64": 8}.get(key.dtype, 4)


def _prefix_s(key: ShapeKey) -> float:
    """The causal launch A: a block per 64 feature rows x 64 value columns,
    over all N tokens."""
    r, nc = _fc.feature_rows(key.d, key.p), -(-key.n // _fc.CHUNK)
    blocks = -(-r // 64) * -(-key.dv // 64) * key.bh
    return _launch_s(
        blocks, 256, 4 * 32 * (key.d + 1), 64,
        key.n * (key.d + 64) * _inb(key) + nc * 64 * 64 * 4,
        2.0 * key.n * 64 * 64 + 8.0 * key.n * 64, F32_FLOPS)


def _combine_s(key: ShapeKey, ncg: int, band: bool) -> float:
    """The causal launch B: a block per 64 query rows of a chunk, reading the chunk's slot of R x Dv in
    passes of 64 ncg columns, the query features built once a pass."""
    d, dv = key.d, key.dv
    r, nc = _fc.feature_rows(d, key.p), -(-key.n // _fc.CHUNK)
    bc, passes = 64 * ncg, -(-dv // (64 * ncg))
    keys = 2 * _fc.CHUNK if band else _fc.CHUNK
    smem = 4 * (32 * bc + 32 * 72 + 64 * (d + 1) + 64 + 32 * (d + 1) + 32)
    nbytes = (passes * (r * bc * 4 + keys * (d + bc) * _inb(key))
              + 64 * (d + dv) * _inb(key))
    flops = passes * (2.0 * 64 * r * bc + 8.0 * 64 * r
                      + 2.0 * 64 * keys * (d + bc))
    blocks = -(-key.g * _fc.CHUNK // 64) * nc * key.bh
    return _launch_s(blocks, 256, smem, 48 + 16 * ncg, nbytes, flops,
                     F32_FLOPS)


def _decode_s(key: ShapeKey, rows: int, group: int) -> float:
    """The decode step's launch pairs, one per group of queries: the m2
    launch (a block per `rows` m2 rows of each pair, the first group's
    writing the fold back) and the small-moment launch (a block per pair,
    summing the m2 launch's partials)."""
    d, dv, g, inb = key.d, key.dv, key.g, _inb(key)
    gt = min(group, g)
    rows = min(rows, d * d)
    nsplit = -(-d * d // rows) if key.p >= 2 else 0
    rpar = 256 // (dv // 4)
    t = 0.0
    for j0 in range(0, g, gt):
        first = 2 if j0 == 0 else 1     # the first group writes the fold
        n_q = min(gt, g - j0)
        if nsplit:
            t += _launch_s(
                nsplit * key.bh, 256,
                4 * (n_q * d + d + 4 + rpar * n_q * dv), 40 + 4 * n_q,
                first * rows * dv * 4 + n_q * (dv * 4 + d * inb),
                2.0 * rows * dv * (n_q + (j0 == 0)), F32_FLOPS)
        small = d * dv + dv + d + (d * d if key.p >= 2 else 0)
        t += _launch_s(
            key.bh, 128, 4 * (n_q * d + d + n_q * 128 + n_q), 32 + 2 * n_q,
            first * small * 4 + nsplit * n_q * dv * 4 + n_q * dv * inb,
            2.0 * n_q * small + nsplit * n_q * dv, F32_FLOPS)
    return t


def _noncausal_s(key: ShapeKey, rows: int, split: int) -> float:
    """The noncausal combine: at G·N <= split the split launch (a block per
    `rows` feature rows of each pair) and its sum launch, else
    `combine_rows_kernel`."""
    d, dv, inb = key.d, key.dv, _inb(key)
    r, gn = _fc.feature_rows(d, key.p), key.g * key.n
    if gn <= split:
        qt = 1 << (gn - 1).bit_length()
        rows = min(rows, r)
        nsplit = -(-r // rows)
        rpar = 256 // (dv // 4)
        return (_launch_s(nsplit * key.bh, 256,
                          4 * (rpar * qt * (dv + 1) + qt * d), 32 + 5 * qt,
                          rows * (dv + 1) * 4 + qt * ((dv + 1) * 4 + d * inb),
                          2.0 * rows * (dv + 1) * qt + 8.0 * rows * qt,
                          F32_FLOPS)
                + _launch_s(key.bh, 128, 0, 32,
                            nsplit * qt * (dv + 1) * 4 + gn * dv * inb,
                            1.0 * nsplit * qt * dv, F32_FLOPS))
    # combine_rows_kernel: 64 query rows a block against all R moment rows,
    # three TF32 products (split operands) on the tensor cores
    return _launch_s(-(-gn // 64) * key.bh, 128, 4 * 2 * 32 * 72 * 2, 128,
                     r * (dv + 1) * 4 + 64 * (d + dv) * inb,
                     3 * 2.0 * 64 * r * (dv + 1), TF32_FLOPS)


def _is_int(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


def cost_model(key: ShapeKey, sched: Schedule) -> float:
    """Estimated seconds of the kernel's launches at `key` under `sched`;
    inf for a schedule the kernel refuses (a knob it lacks set, a knob out
    of range, shared memory over a block's limit)."""
    kernel, d, dv = key.kernel, key.d, key.dv
    set_ = {f for f in Schedule._fields if getattr(sched, f) is not None}
    if not all(_is_int(getattr(sched, f)) for f in set_):
        return math.inf
    if kernel in ("causal_fwd", "hybrid_fwd"):
        if set_ != {"cols"} or sched.cols not in (64, 128):
            return math.inf
        ncg = sched.cols // 64
        if (ncg - 1) * 64 >= dv:
            return math.inf
        return _prefix_s(key) + _combine_s(key, ncg,
                                           band=kernel == "hybrid_fwd")
    if dv % 4 or dv // 4 > 256:
        return math.inf
    if kernel == "decode":
        if (set_ != {"rows", "group"} or sched.rows < 1
                or not 1 <= sched.group <= MAX_GROUP):
            return math.inf
        return _decode_s(key, sched.rows, sched.group)
    if kernel == "noncausal":
        if (set_ != {"rows", "split"} or sched.rows < 1
                or not 0 <= sched.split <= _fn.MAX_SPLIT_ROWS):
            return math.inf
        return _noncausal_s(key, sched.rows, sched.split)
    raise ValueError(f"unknown kernel {kernel!r}; expected {KERNELS}")


# ---------------------------------------------------------------------------
# measurement on the card
# ---------------------------------------------------------------------------

_COUNTERS = ((_fc, "launches"), (_fd, "launches"),
             (_fn, "moment_launches"), (_fn, "combine_launches"),
             (_hc, "launches"))


@contextlib.contextmanager
def _uncounted():
    """Launches made to time a schedule are not the caller's: the wrappers'
    launch counts are restored after."""
    saved = [getattr(m, a) for m, a in _COUNTERS]
    try:
        yield
    finally:
        for (m, a), c in zip(_COUNTERS, saved):
            setattr(m, a, c)


def _can_measure() -> bool:
    """A card, and neither CUDA graph capture nor torch.compile tracing."""
    return (torch.cuda.is_available()
            and not torch.cuda.is_current_stream_capturing()
            and not torch.compiler.is_compiling())


def _bench_fn(key: ShapeKey, sched: Schedule, dev: torch.device):
    """The wrapper's call under `sched` on inputs of the key's shape (batch
    1, `bh` kv heads of G query heads each), from a seeded generator."""
    from repro_torch.core.ref import normalize_qk

    gen = torch.Generator(device=dev).manual_seed(0)
    dt = getattr(torch, key.dtype)
    n, d, dv, p = max(key.n, 1), key.d, key.dv, key.p
    hq, hkv = key.g * key.bh, key.bh

    def rn(*s):
        return torch.randn(s, generator=gen, device=dev)

    q = normalize_qk(rn(1, hq, n, d)).to(dt)
    k = normalize_qk(rn(1, hkv, n, d)).to(dt)
    v = rn(1, hkv, n, dv).to(dt)
    if key.kernel == "causal_fwd":
        return lambda: _fc.fastmax_causal_cuda(q, k, v, p=p, schedule=sched)
    if key.kernel == "hybrid_fwd":
        return lambda: _hc.hybrid_causal_cuda(q, k, v, p=p, window=64,
                                              chunk_size=512, schedule=sched)
    if key.kernel == "decode":
        _, st = _fc.fastmax_causal_cuda(q, k, v, p=p)
        q1, k1, v1 = q[:, :, :1].contiguous(), k[:, :, :1].contiguous(), \
            v[:, :, :1].contiguous()
        return lambda: _fd.fastmax_decode_cuda(q1, k1, v1, st, p=p,
                                               schedule=sched)
    mom = _fn.noncausal_moments_cuda(k, v, p=p)
    return lambda: _fn.noncausal_combine_cuda(q, mom, p=p, schedule=sched)


def measure(key: ShapeKey, sched: Schedule, *, iters: int = 5,
            warmup: int = 2, sample_s: float = 2e-3) -> float:
    """Seconds of one call of the kernel's wrapper under `sched` at the
    key's shape, on the card: after `warmup` calls, the median of `iters`
    samples, each the mean of back-to-back calls between two CUDA events
    (as many as last about `sample_s`, at most 100: a lone short call
    would time the launch latency of an empty queue). The launches are not
    counted in the wrappers' launch counts. Raises off the card and on a
    failed launch."""
    if key.platform != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"measure times a CUDA kernel on the card; got "
                           f"platform {key.platform!r}, cuda available "
                           f"{torch.cuda.is_available()}")
    dev = torch.device("cuda", torch.cuda.current_device())
    with _uncounted(), torch.no_grad():
        fn = _bench_fn(key, sched, dev)

        def sample(reps: int) -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / reps

        for _ in range(warmup):
            fn()
        one = max(sample(1), 1e-7)
        reps = max(1, min(100, math.ceil(sample_s / one)))
        ts = sorted(sample(reps) for _ in range(iters))
    return ts[len(ts) // 2]


# ---------------------------------------------------------------------------
# tuning + cache
# ---------------------------------------------------------------------------

def tune(key: ShapeKey, *, allow_measure: bool = False):
    """Sweep the candidate set; returns (schedule, source, score).

    Measurement needs allow_measure, a CUDA key, a card, and no graph
    capture or compile trace; everything else scores with the cost model
    (ties break on candidate order, so the winner is reproducible), which
    keeps the default (the first candidate) unless the best beats it by
    more than MODEL_MARGIN. Every candidate is one the kernel takes, so a
    failed launch raises: nothing is skipped.
    """
    cands = candidate_schedules(key.kernel, key)
    measured = allow_measure and key.platform == "cuda" and _can_measure()
    scores = [measure(key, s) if measured else cost_model(key, s)
              for s in cands]
    best = min(range(len(cands)), key=scores.__getitem__)
    if math.isinf(scores[best]):  # the kernel refuses the shape: its own
        return cands[0], "default", math.inf   # check raises at the launch
    if not measured and scores[best] > (1 - MODEL_MARGIN) * scores[0]:
        best = 0
    return cands[best], ("measured" if measured else "cost_model"), \
        scores[best]


_FILE_CACHE: dict = {}   # path -> (mtime, entries)


def load_cache(path: str) -> dict:
    """Entries of the on-disk cache (mtime-memoized; {} when absent)."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return {}
    hit = _FILE_CACHE.get(path)
    if hit and hit[0] == mtime:
        return hit[1]
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"autotune: unreadable cache {path} ({e}) — ignoring",
              file=sys.stderr)
        return {}
    if raw.get("version") != CACHE_VERSION:
        print(f"autotune: cache {path} has version {raw.get('version')!r}, "
              f"expected {CACHE_VERSION} — ignoring", file=sys.stderr)
        return {}
    entries = raw.get("entries", {})
    _FILE_CACHE[path] = (mtime, entries)
    return entries


def save_cache(path: str, entries: dict) -> None:
    with open(path, "w") as f:
        json.dump({"version": CACHE_VERSION,
                   "entries": {k: entries[k] for k in sorted(entries)}},
                  f, indent=2)
        f.write("\n")
    _FILE_CACHE.pop(path, None)
    for memo in [m for m in _MEMO if m[1] == path]:
        del _MEMO[memo]


def _entry_schedule(entry: dict, key: ShapeKey) -> Optional[Schedule]:
    """Decode a cache entry against the key's shape: an entry of other
    fields (the reference's) or one the kernel refuses is a miss."""
    sched = entry.get("schedule") if isinstance(entry, dict) else None
    if not isinstance(sched, dict) or set(sched) != set(Schedule._fields):
        return None
    s = Schedule(**sched)
    return s if math.isfinite(cost_model(key, s)) else None


# provenance: one record per distinct key, until `clear_lookups`
_LOOKUPS: dict = {}
# (mode, cache path or None, the lookup's arguments) -> (schedule or None,
# its record)
_MEMO: dict = {}


def clear_lookups() -> None:
    _LOOKUPS.clear()


def snapshot_lookups() -> list:
    return [_LOOKUPS[k] for k in sorted(_LOOKUPS)]


def _record(key: ShapeKey, sched: Schedule, cache: str, source: str) -> dict:
    rec = {"kernel": key.kernel, "key": key_str(key),
           "schedule": dict(sched._asdict()),
           "cache": cache,      # "hit" | "miss" | "off"
           "source": source}    # "measured" | "cost_model" | "default"
    _LOOKUPS[rec["key"]] = rec
    return rec


def cache_path() -> str:
    return os.environ.get(ENV_CACHE, DEFAULT_CACHE)


def _key(kernel: str, n, d, dv, g, bh, p, dtype, device) -> ShapeKey:
    return ShapeKey(kernel, int(n), int(d), int(dv), int(g), int(bh), int(p),
                    _dtype_name(dtype),
                    "cuda" if device.type == "cuda" else "cpu")


def check_schedule(kernel: str, sched: Schedule, *, n: int, d: int, dv: int,
                   g: int, bh: int, p: int, dtype, device) -> Schedule:
    """A forced schedule (`schedule=` of the kernel ops), returned as it is
    if the kernel takes it at this launch's shape; ValueError otherwise."""
    key = _key(kernel, n, d, dv, g, bh, p, dtype, device)
    if not isinstance(sched, Schedule) or math.isinf(cost_model(key, sched)):
        raise ValueError(f"the {kernel} kernel does not take schedule "
                         f"{sched!r} at {key_str(key)}")
    return sched


def lookup_schedule(kernel: str, *, n: int, d: int, dv: int, g: int,
                    bh: int, p: int, dtype, device) -> Optional[Schedule]:
    """The runtime entry point, called by `repro_torch.kernels.ops` once
    per kernel launch with the launch's shape, the inputs' dtype and their
    `torch.device` (platform `cuda` for a CUDA device, `cpu` otherwise).

    Returns None when autotuning is off (the wrappers then launch with
    their constants); otherwise the cached or freshly tuned Schedule.
    Every call records a provenance entry, whatever the mode.
    """
    mode = autotune_mode()
    path = None if mode == "off" else cache_path()
    platform = "cuda" if device.type == "cuda" else "cpu"
    memo_key = (mode, path, kernel, n, d, dv, g, bh, p, dtype, platform)
    memo = _MEMO.get(memo_key)
    if memo is not None:
        _LOOKUPS[memo[1]["key"]] = memo[1]
        return memo[0]
    key = _key(kernel, n, d, dv, g, bh, p, dtype, device)
    if mode == "off":
        rec = _record(key, default_schedule(kernel, d, dv), "off", "default")
        _MEMO[memo_key] = (None, rec)
        return None
    entry = load_cache(path).get(key_str(key))
    sched = None if entry is None else _entry_schedule(entry, key)
    if sched is not None:
        rec = _record(key, sched, "hit", entry.get("source", "cost_model"))
        _MEMO[memo_key] = (sched, rec)
        return sched
    sched, source, score = tune(key, allow_measure=(mode == "on"))
    rec = _record(key, sched, "miss", source)
    if mode == "on" and ENV_CACHE in os.environ:
        # persisted only to a file the user names; the next lookup of the
        # key reads it back as a hit
        entries = dict(load_cache(path))
        entries[key_str(key)] = {
            "schedule": dict(sched._asdict()), "source": source,
            "score": None if math.isinf(score) else score,
            **({"card": _card(torch.cuda.current_device())}
               if source == "measured" else {})}
        save_cache(path, entries)
    else:
        _MEMO[memo_key] = (sched, rec)
    return sched


# ---------------------------------------------------------------------------
# gate shapes + CLI (the committed-cache workflow)
# ---------------------------------------------------------------------------

# (kernel, config, batch, query tokens N): the shapes chip_smoke.py serves
# and trains — qwen3's generate() and train step's forward, the hybrid's (window 64),
# jamba's G = 4, deepseek-v2's MLA, granite's G = 48 decode and whisper's
# noncausal N = 1500 (encoder), 128 (prefill) and 1 (decode steps)
_GATE = (("causal_fwd", "qwen3-1.7b", 4, 1024),
         ("causal_fwd", "jamba-v0.1-52b", 4, 1024),
         ("causal_fwd", "deepseek-v2-236b", 2, 1024),
         ("decode", "qwen3-1.7b", 4, 1),
         ("decode", "jamba-v0.1-52b", 4, 1),
         ("decode", "deepseek-v2-236b", 2, 1),
         ("decode", "granite-20b", 4, 1),
         ("noncausal", "whisper-small", 4, 1500),
         ("noncausal", "whisper-small", 4, 128),
         ("noncausal", "whisper-small", 4, 1),
         ("hybrid_fwd", "qwen3-1.7b", 4, 1024))


def _attention_dims(arch: str) -> tuple:
    """(D, Dv, G, Hkv) of a config's attention kernels: MLA's D is its
    nope + rope dims on as many kv heads as query heads."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cfg.use_mla:
        return (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.head_dim, 1,
                cfg.n_heads)
    return (cfg.head_dim, cfg.head_dim, cfg.n_heads // cfg.n_kv_heads,
            cfg.n_kv_heads)


def gate_keys(platform: str = "cpu") -> list:
    """The ShapeKeys the committed cache must cover (p = 2, bf16)."""
    out = []
    for kernel, arch, b, n in _GATE:
        d, dv, g, hkv = _attention_dims(arch)
        out.append(ShapeKey(kernel, n, d, dv, g, b * hkv, 2, "bfloat16",
                            platform))
    return out


def build_gate_entries(platform: str = "cpu") -> dict:
    """Cost-model winners for every gate shape (deterministic on any
    host)."""
    entries = {}
    for key in gate_keys(platform):
        sched, source, score = tune(key, allow_measure=False)
        entries[key_str(key)] = {
            "schedule": dict(sched._asdict()), "source": source,
            "score": None if math.isinf(score) else score}
    return entries


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="schedule autotuner of the port's CUDA kernels "
                    "(committed-cache workflow; runtime tuning is "
                    "env-driven, see the module docstring)")
    ap.add_argument("--cache", default=DEFAULT_CACHE,
                    help="cache file (default: the committed in-repo one)")
    ap.add_argument("--platform", default="cpu",
                    help="platform tag for the generated entries")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--write", action="store_true",
                   help="retune the gate shapes (cost model) and write "
                        "them into the cache, preserving other entries")
    g.add_argument("--check", action="store_true",
                   help="fail if the cache is stale against a fresh "
                        "cost-model sweep (schema or winner drift)")
    args = ap.parse_args(argv)

    fresh = build_gate_entries(args.platform)
    if args.write:
        entries = dict(load_cache(args.cache))
        entries.update(fresh)
        save_cache(args.cache, entries)
        print(f"autotune: wrote {len(fresh)} gate entries "
              f"({len(entries)} total) to {args.cache}")
        return

    drift = []
    try:
        with open(args.cache) as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SystemExit(f"autotune --check: cannot read {args.cache}: {e}")
    if raw.get("version") != CACHE_VERSION:
        drift.append(f"schema version {raw.get('version')!r} != "
                     f"{CACHE_VERSION}")
    committed = raw.get("entries", {})
    for ks, entry in fresh.items():
        have = committed.get(ks)
        if have is None:
            drift.append(f"missing entry: {ks}")
        elif have.get("schedule") != entry["schedule"]:
            drift.append(f"winner drift: {ks}: committed "
                         f"{have.get('schedule')} != fresh "
                         f"{entry['schedule']}")
    if drift:
        for line in drift:
            print(f"autotune --check: STALE — {line}")
        raise SystemExit(
            f"autotune --check: {len(drift)} stale entr"
            f"{'y' if len(drift) == 1 else 'ies'} — regenerate with "
            f"`python -m repro_torch.kernels.autotune --write` and commit "
            f"the cache")
    print(f"autotune --check: OK ({len(fresh)} gate entries up to date "
          f"in {args.cache})")


if __name__ == "__main__":
    main()
