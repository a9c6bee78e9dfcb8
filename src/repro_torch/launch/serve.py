"""Serving driver: batched prefill + greedy decode with O(1)-in-context
state — port of `repro/launch/serve.py`. Two paths:

  default          `generate()`: one static batch, whole-prompt prefill,
                   lockstep greedy decode (optionally eos-early-stopped).
                   An encoder-decoder arch (whisper-small) first encodes
                   stub frames drawn from the same numpy generator as the
                   prompts, then decodes against the encoder's output.
  --serve-engine   `serve.ServeEngine`: continuous batching over a slot
                   pool (staggered admissions, chunked prefill mixed with
                   decode), with --max-queue backpressure and
                   --ttft-deadline / --deadline timeouts; prints the
                   engine's two `[engine]` lines (decoder-only archs, as
                   in the reference).

Usage (on the card; `--device cpu` runs the plain versions on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --attn fastmax2-kernel --batch 4 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
      --attn fastmax2-kernel --batch 4 --prompt-len 128 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --attn fastmax2-kernel --serve-engine --slots 4 --batch 8 \
      --prompt-len 1024 --gen 32
Any arch of `repro_torch.configs.ARCH_IDS` (`--smoke` for its small
config; deepseek-v2-236b and kimi-k2-1t-a32b are MoE models, jamba-v0.1-52b
mixes Mamba and attention, xlstm-1.3b is attention-free):
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-236b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch jamba-v0.1-52b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.attention import AttentionSpec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import decoder_params, init_decode_state, init_model
from repro_torch.models.encdec import encode

__all__ = ["generate", "main"]


class _Marks:
    """Timestamps on the device's clock: CUDA events on a card (recorded in
    stream order, so the host never waits for them), the host clock on the
    CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                      self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


@torch.inference_mode()
def generate(params, cfg, prompts, n_gen: int, max_len: int | None = None,
             enc_out=None, eos_id: int | None = None, device=None,
             timings: dict | None = None):
    """prompts [B, P] int. Greedy decode of `n_gen` tokens on `device`
    (default cuda; `params` must live there). Returns [B, n_gen] int32.
    An encoder-decoder model takes its encoder's output `enc_out`
    [B, M, d] (from `models.encdec.encode`), which every prefill and
    decode step attends to.

    With `eos_id`, a sequence that emits it is frozen: its remaining
    positions are filled with `eos_id`, and the loop exits early once every
    sequence is done (a check that waits for the card at every step).

    With a `timings` dict, the call fills in `prefill_ms` (prompt to first
    token), `decode_ms` (all later tokens) and `decode_steps`, on the
    device's clock, and waits for the device before it returns.
    """
    dev = resolve_device(device)
    dec = decoder_params(params, cfg)
    if dec["embed"].device != dev:
        raise ValueError(f"params live on {dec['embed'].device}, "
                         f"generate() asked to run on {dev}")
    marks = _Marks(dev) if timings is not None else None
    if marks is not None:
        marks.mark()
    prompts = torch.as_tensor(prompts, device=dev)
    b, plen = prompts.shape
    state = init_decode_state(cfg, b, max_len or (plen + n_gen), device=dev)
    prefill, step = make_prefill_step(cfg), make_serve_step(cfg)
    # decode positions live on the device: a Python int would be copied
    # there at every step, and such a copy waits for the card to drain
    positions = plen + torch.arange(max(n_gen - 1, 0), device=dev)
    tok, state = prefill(params, state, prompts, enc_out)
    if marks is not None:
        marks.mark()
    done = (tok == eos_id) if eos_id is not None else None
    out = [tok]
    steps = 0
    for i in range(n_gen - 1):
        if done is not None and bool(done.all()):
            out.extend([torch.full_like(tok, eos_id)] * (n_gen - 1 - i))
            break
        tok, state = step(params, state, tok, positions[i], enc_out)
        steps += 1
        if done is not None:
            tok = torch.where(done, torch.full_like(tok, eos_id), tok)
            done = done | (tok == eos_id)
        out.append(tok)
    toks = torch.stack(out, dim=1)
    if marks is not None:
        marks.mark()
        pre, dec = marks.intervals_ms()
        timings.update(prefill_ms=pre, decode_ms=dec, decode_steps=steps)
    return toks


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _submit_all(eng, prompts, n_gen, args):
    """Submit the batch, absorbing backpressure: a bounded queue
    (--max-queue) rejects at submit time with EngineOverloaded, and we
    drain a tick and retry rather than fail the whole batch."""
    from repro_torch.serve import EngineOverloaded

    rids = []
    for p in prompts:
        while True:
            try:
                rids.append(eng.submit(
                    p, n_gen, ttft_deadline=args.ttft_deadline,
                    deadline=args.deadline))
                break
            except EngineOverloaded:
                eng.step()   # make room, then retry this prompt
    return rids


def _serve_engine(params, cfg, prompts, args) -> None:
    """Continuous batching: the batch submitted as requests, once as a
    warm-up (kernel builds, allocator), then timed through the same
    engine; prints the reference's two [engine] lines."""
    from repro_torch.serve import ServeEngine

    dev = params["embed"].device
    eng = ServeEngine(
        params, cfg, max_slots=args.slots,
        max_len=prompts.shape[1] + args.gen, eos_id=args.eos_id,
        policy=args.policy, prefix_cache_bytes=args.prefix_cache_mb << 20,
        max_queue=args.max_queue)
    _submit_all(eng, prompts, args.gen, args)
    eng.run()
    _sync(dev)
    t0 = time.monotonic()
    rids = _submit_all(eng, prompts, args.gen, args)
    outs = eng.run()
    _sync(dev)
    dt = time.monotonic() - t0
    n_tok = sum(len(outs.get(r, [])) for r in rids)
    ttfts = sorted(f.ttft for f in eng.history[-len(rids):]
                   if f.ttft is not None)
    ttft_ms = f"{ttfts[len(ttfts) // 2] * 1e3:.1f}ms" if ttfts else "n/a"
    st = eng.stats()
    print(f"[engine] generated {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s)  ttft p50 {ttft_ms}  "
          f"slot bytes {eng.slots.state_bytes_per_slot()}  sample: "
          f"{outs[rids[0]][:16]}")
    print(f"[engine] lifecycle: finished {st['finished']}  "
          f"failed {st['failed']}  cancelled {st['cancelled']}  "
          f"timed_out {st['timed_out']}  rejected {st['rejected']}  "
          f"shed {st['shed']}  quarantined {st['quarantined']}  "
          f"ticks {st['ticks']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--attn", default=None,
                    help="attention operator (AttentionSpec.parse name, "
                         "e.g. fastmax2-kernel, hybrid2-kernel)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--serve-engine", action="store_true",
                    help="continuous batching via serve.ServeEngine")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--policy", default="fcfs", choices=("fcfs", "lpf"))
    ap.add_argument("--prefix-cache-mb", type=int, default=0)
    ap.add_argument("--max-queue", type=int, default=256,
                    help="bounded admission queue depth; submits beyond it "
                         "raise EngineOverloaded (0 = unbounded)")
    ap.add_argument("--ttft-deadline", type=float, default=None,
                    help="seconds from submit to first token before the "
                         "request is timed out")
    ap.add_argument("--deadline", type=float, default=None,
                    help="seconds from submit to completion before the "
                         "request is timed out")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.attn:
        cfg = dataclasses.replace(cfg, attn=AttentionSpec.parse(args.attn))
    params = init_model(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    if args.serve_engine:
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.batch, args.prompt_len))
        _serve_engine(params, cfg, prompts, args)
        return
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int64, device=dev)
    enc_out = None
    if cfg.encoder_layers > 0:
        frames = torch.as_tensor(
            rng.normal(size=(args.batch, cfg.encoder_seq, cfg.d_model)),
            device=dev).to(cfg.adtype())
        with torch.inference_mode():
            encode(params, frames, cfg)   # warm-up
            _sync(dev)
            t0 = time.monotonic()
            enc_out = encode(params, frames, cfg)
            _sync(dev)
        print(f"encoded {tuple(frames.shape)} frames in "
              f"{(time.monotonic() - t0) * 1e3:.1f} ms")

    # warm-up (kernel build, allocator) outside the timed region
    generate(params, cfg, prompts, args.gen, enc_out=enc_out,
             eos_id=args.eos_id, device=dev)
    _sync(dev)
    t0 = time.monotonic()
    toks = generate(params, cfg, prompts, args.gen, enc_out=enc_out,
                    eos_id=args.eos_id, device=dev)
    _sync(dev)
    dt = time.monotonic() - t0
    print(f"generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)  sample: "
          f"{toks[0][:16].cpu().numpy()}")


if __name__ == "__main__":
    main()
