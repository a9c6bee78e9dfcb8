"""Trace the serving loop on the card with `torch.profiler`.

  PYTHONPATH=src python -m repro_torch.launch.trace_decode [--out DIR]
      [--arch whisper-small --prompt-len 128]
      [--arch jamba-v0.1-52b --n-layers 8] [--arch xlstm-1.3b]

Builds the full-width arch (default qwen3-1.7b; attn fastmax2-kernel,
bf16, random weights from seed 0; `--n-layers` cuts its depth, as
jamba's 52 B parameters need to fit one card) and prints one JSON line. An
encoder-decoder arch first encodes seeded stub frames (batch 4, untraced)
and every `generate()` call below decodes against that encoder output.

`untraced`: the median host-clock time of `generate()` at the main path's
shape (batch 4, prompt `--prompt-len`, default 1024, 32 new tokens), of
the same call cut to its first token, and the decode time per token as
their difference over the other 31 tokens.

Then one traced `generate()` call with a short prompt (a decode step's cost
does not depend on the context): its host wall time and CUDA-event time;
the device time its kernels and copies took and the device's idle share,
over the call and over its decode steps, which begin where the last
prefill kernel ends (the decode steps' device time per step is also held
against the untraced decode time per token; an attention-free arch runs
no prefill kernel, so its decode split is null); the host's kernel launches
per token; the host calls that wait on the device (stream syncs, copies,
`.item()`) per decode step; and the top host operators and device kernels.
`--out DIR` also writes the Chrome trace there.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.attention import AttentionSpec
from repro_torch.configs import get_config
from repro_torch.launch.serve import generate
from repro_torch.models import init_model
from repro_torch.models.encdec import encode

BATCH, GEN = 4, 32                        # the untraced calls
TRACE_PROMPT, TRACE_GEN = 64, 17          # the traced call
REPS = 3

# host calls that block until the device has caught up (or copy through
# pageable memory, which does)
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy",
         "aten::_local_scalar_dense")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchKernelExC")
# the prefill's last launch (csrc/fastmax_causal.cu)
PREFILL_KERNEL = "causal_combine_kernel"


def _device_spans(prof):
    """(start, end) in us of every kernel and copy the card ran, and the
    end of the last prefill-kernel launch (where decode begins; None
    without one)."""
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    cut = max((e.time_range.end for e in evs if PREFILL_KERNEL in e.name),
              default=None)
    return spans, cut


def _union_us(spans) -> float:
    """Time covered by at least one span (kernels may overlap)."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (default: the config's)")
    args = ap.parse_args(argv)

    dev = torch.device("cuda")
    cfg = get_config(args.arch, attn=AttentionSpec.parse("fastmax2-kernel"))
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    params = init_model(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    short = torch.randint(0, cfg.vocab_size, (BATCH, TRACE_PROMPT),
                          generator=gen, device=dev)
    long = torch.randint(0, cfg.vocab_size, (BATCH, args.prompt_len),
                         generator=gen, device=dev)
    enc_out = None
    if cfg.encoder_layers > 0:
        frames = torch.randn(BATCH, cfg.encoder_seq, cfg.d_model,
                             generator=gen, device=dev).to(cfg.adtype())
        with torch.inference_mode():
            enc_out = encode(params, frames, cfg)

    def wall_ms(n_gen):
        times = []
        for _ in range(REPS + 1):          # the first call warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate(params, cfg, long, n_gen, enc_out=enc_out, device=dev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times[1:])[REPS // 2]

    full_ms, first_ms = wall_ms(GEN), wall_ms(1)
    untraced = {"arch": args.arch, "n_layers": cfg.n_layers, "batch": BATCH,
                "prompt_len": args.prompt_len, "gen": GEN,
                "median_of": REPS, "call_ms": full_ms,
                "first_token_ms": first_ms,
                "decode_ms_per_token": (full_ms - first_ms) / (GEN - 1)}

    generate(params, cfg, short, TRACE_GEN, enc_out=enc_out,
             device=dev)                                    # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        generate(params, cfg, short, TRACE_GEN, enc_out=enc_out, device=dev)
        end.record()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3

    ka = prof.key_averages()
    spans, cut = _device_spans(prof)
    steps = TRACE_GEN - 1
    dec_busy = dec_wall = None
    if cut is not None:
        dec = [(s, e) for s, e in spans if s >= cut]
        dec_busy = _union_us(dec) / 1e3 / steps
        dec_wall = (max((e for _, e in dec), default=cut) - cut) / 1e3 / steps
    busy_ms = _union_us(spans) / 1e3
    waits = {e.key: e.count for e in ka if e.key in WAITS}
    launches = sum(e.count for e in ka if e.key in LAUNCHES)
    by_host = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)
    by_dev = sorted((e for e in ka if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace_decode.json"))
    print(json.dumps({
        "untraced": untraced,
        "traced": {"batch": BATCH, "prompt_len": TRACE_PROMPT,
                   "gen": TRACE_GEN, "wall_ms": traced_ms,
                   "event_ms": start.elapsed_time(end),
                   "device_busy_ms": busy_ms,
                   "device_idle_share": max(0.0, 1.0 - busy_ms / traced_ms),
                   "device_ops": len(spans)},
        "decode_busy_ms_per_step": dec_busy,
        "decode_traced_ms_per_step": dec_wall,
        "decode_traced_idle_share": max(0.0, 1.0 - dec_busy / dec_wall)
        if dec_wall else None,
        "decode_idle_share_untraced": max(
            0.0, 1.0 - dec_busy / untraced["decode_ms_per_token"])
        if dec_busy is not None else None,
        "host_launches_per_token": launches / TRACE_GEN,
        "waits_per_decode_step": {k: v / steps for k, v in waits.items()},
        "top_host_ms": [[e.key, e.count, e.self_cpu_time_total / 1e3]
                        for e in by_host[:12]],
        "top_device_ms": [[e.key[:80], e.count,
                           e.self_device_time_total / 1e3]
                          for e in by_dev[:12]],
    }))


if __name__ == "__main__":
    main()
