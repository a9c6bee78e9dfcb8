"""Training entry point — port of `repro/launch/train.py` (one device).

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 6 --batch 4 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --attn fastmax2-kernel --steps 20 --batch 4 --seq 1024
  (or --attn hybrid2-kernel: hybrid near/far-field attention)

Composes the model registry, the optimizer policy (`pick_optimizer`), the
synthetic data stream and the train step. Checkpointing (`--ckpt-dir`,
`--resume`), the fault-tolerance hooks and context parallelism (`--cp`)
are not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.attention import AttentionSpec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLM, make_batch_iterator
from repro_torch.device import resolve_device
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
    ap.add_argument("--log-every", type=int, default=10)
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
    it = make_batch_iterator(data, args.batch)
    losses = []
    try:
        for step, batch in it:
            if step >= args.steps:
                break
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])     # waits for the step
            dt = time.perf_counter() - t0
            losses.append(loss)
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['gnorm']):.3f} "
                      f"{dt*1e3:.0f}ms", flush=True)
    finally:
        it.close()
    print(f"final loss {np.mean(losses[-10:]):.4f} "
          f"(first10 {np.mean(losses[:10]):.4f})", flush=True)
    return params, losses


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    main()
