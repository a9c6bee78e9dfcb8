"""Training entry point — port of `repro/launch/train.py` (one device).

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 6 --batch 4 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --attn fastmax2-kernel --steps 20 --batch 4 --seq 1024
  (or --attn hybrid2-kernel: hybrid near/far-field attention)
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 6 --ckpt-dir /tmp/ck --ckpt-every 3   (then again with --resume)

Composes the model registry, the optimizer policy (`pick_optimizer`), the
synthetic data stream, the train step, the checkpoint manager
(`--ckpt-dir`, `--ckpt-every`, `--resume`) and the fault-tolerance hooks
(a SIGTERM/SIGINT saves and stops at the next step boundary; step times go
through `StragglerMonitor`). Context parallelism (`--cp`) is not ported
yet (ROADMAP queue 1).

Every checkpoint is labelled with the number of updates it holds (the
optimizer's `step`), and `--resume` from label L starts the batch stream
at batch L, so a resumed run takes the same batches and reaches the same
parameters as an unbroken one. The reference labels its periodic saves
one short of that and applies the batch at the label twice after a
resume (`tests/test_torch_train_resume.py`).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.attention import AttentionSpec
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLM, make_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.ft import PreemptionHandler, StragglerMonitor
from repro_torch.launch.steps import make_train_step, pick_optimizer
from repro_torch.models import init_model
from repro_torch.models.param import count_params


def build(args):
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if args.attn:
        cfg = dataclasses.replace(cfg, attn=AttentionSpec.parse(args.attn))
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--attn", default=None,
                    help="attention operator (AttentionSpec.parse name, "
                         "e.g. fastmax2, fastmax2-kernel, hybrid2-kernel)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="save (async) after every this many updates")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint under --ckpt-dir")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = build(args)
    params = init_model(cfg, seed=0, device=dev)
    n_params = count_params(params)
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M attn={cfg.attn} "
          f"device={dev}", flush=True)

    _, optimizer = pick_optimizer(cfg, n_params, lr=args.lr,
                                  total_steps=args.steps)
    opt_init, _ = optimizer
    opt_state = opt_init(params)
    train_step = make_train_step(cfg, optimizer)

    data = SyntheticLM(cfg.vocab_size, args.seq, seed=0)
    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if args.resume and mgr.latest_step() is not None:
            t0 = time.perf_counter()
            (params, opt_state), start_step, _ = mgr.restore(
                (params, opt_state))
            print(f"resumed from step {start_step} (restore "
                  f"{time.perf_counter() - t0:.3f} s)", flush=True)

    pre = PreemptionHandler()
    mon = StragglerMonitor()
    it = make_batch_iterator(data, args.batch, start_step=start_step)
    losses = []
    done = start_step                   # updates taken: the checkpoint label
    try:
        for step, batch in it:
            if step >= args.steps or pre.requested:
                break
            writing = mgr is not None and mgr.writing
            mon.start_step()
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])     # waits for the step
            dt = mon.end_step()
            done = step + 1
            losses.append(loss)
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['gnorm']):.3f} "
                      f"{dt*1e3:.0f}ms"
                      + (" [save in flight]" if writing else "")
                      + (" [STRAGGLER]" if mon.straggling else ""),
                      flush=True)
            if mgr and done % args.ckpt_every == 0 and done < args.steps:
                t0 = time.perf_counter()
                mgr.save(done, (params, opt_state), block=False)
                print(f"checkpoint {done} (async): "
                      f"{(time.perf_counter() - t0) * 1e3:.1f} ms on the "
                      f"loop's thread", flush=True)
    finally:
        it.close()
        pre.restore()
    if mgr:
        t0 = time.perf_counter()
        mgr.wait()                  # the periodic write still in flight
        t1 = time.perf_counter()
        mgr.save(done, (params, opt_state), block=True)
        print(f"checkpoint {done} (blocking): "
              f"{time.perf_counter() - t1:.3f} s (after {t1 - t0:.3f} s "
              f"waiting for the write before it)", flush=True)
    print(f"final loss {np.mean(losses[-10:]):.4f} "
          f"(first10 {np.mean(losses[:10]):.4f}) "
          f"step_stats={mon.stats()}", flush=True)
    return params, losses


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    main()
