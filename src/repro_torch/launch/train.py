"""Training entry point — port of `repro/launch/train.py`.

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
through `StragglerMonitor`).

Context parallelism (`--cp C`, one process per rank under `torchrun
--nproc-per-node W`): a (data = W / C, seq = C) mesh, as the reference's
`_cp_mesh_context`, and the placed step on it (`launch/steps.py`,
`sharding.placed`): each rank holds its shard of the parameters and the
optimizer state over "data" (the reference's cp mesh keeps `embed` on
"data") and trains on its rows and token shard. Fastmax attention on its
kernel and chunked backends runs on the shard and exchanges one moment
carry per boundary (`kernels/sharded.py`); every other mixer (softmax,
hybrid, rowwise, oracle, Mamba, mLSTM, sLSTM) and the MoE take the
sequence gathered over "seq", as the reference's GSPMD gathers it. An
encoder-decoder model is refused. `--cp 1` is the
single-process run. Each rank's device is cuda:(LOCAL_RANK % the device
count), so W ranks may share one card; the group is gloo (NCCL refuses
two ranks on one card). Only rank 0 prints; every rank takes part in a
save (each leaf is gathered whole, rank 0 writes) and restores its own
shard, so a checkpoint resumes at any --cp or on one process.

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --cp 2 \
      --arch qwen3-1.7b --attn fastmax2-kernel --steps 2 --batch 2 \
      --seq 2048

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
import datetime
import os
import time

import numpy as np
import torch

from repro_torch.attention import AttentionSpec
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import SyntheticLM, make_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.ft import PreemptionHandler, StragglerMonitor
from repro_torch.launch.steps import (check_cp, make_train_step,
                                      pick_optimizer)
from repro_torch.models import init_model, param_axes
from repro_torch.models.param import count_params
from repro_torch.sharding import placed


def build(args):
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if args.attn:
        cfg = dataclasses.replace(cfg, attn=AttentionSpec.parse(args.attn))
    return cfg


def _rank0() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _device(arg):
    """--device, else the rank's card: cuda:(LOCAL_RANK % device count)."""
    if arg is None and "LOCAL_RANK" in os.environ \
            and torch.cuda.is_available():
        local = int(os.environ["LOCAL_RANK"])
        arg = f"cuda:{local % torch.cuda.device_count()}"
    dev = resolve_device(arg)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _cp_mesh(args, dev):
    """The (data, seq) mesh of --cp > 1 over the process group (started
    here from torchrun's environment unless the caller started it), or
    None at --cp 1."""
    if args.cp <= 1:
        return None
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    if not dist.is_initialized():
        # gloo: it carries CPU and CUDA tensors, and ranks may share a card
        # (NCCL refuses two ranks on one)
        dist.init_process_group("gloo",
                                timeout=datetime.timedelta(seconds=300))
    world = dist.get_world_size()
    if args.cp > world or world % args.cp:
        raise SystemExit(f"--cp {args.cp} must divide the world size "
                         f"({world})")
    if args.seq % args.cp:
        raise SystemExit(f"--seq {args.seq} must be divisible by --cp "
                         f"{args.cp}")
    mesh = make_test_mesh((world // args.cp, args.cp), ("data", "seq"))
    if _rank0():
        print(f"context parallelism: cp={args.cp} mesh=(data="
              f"{world // args.cp}, seq={args.cp}) backend="
              f"{dist.get_backend()}", flush=True)
    return mesh


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
    ap.add_argument("--cp", type=int, default=1,
                    help="context-parallel degree: train under a "
                         "(data=world/cp, seq=cp) mesh, Fastmax attention "
                         "(kernel, chunked) sharding the sequence over "
                         "'seq' with one moment exchange per shard "
                         "boundary, every other mixer and the MoE on the "
                         "sequence gathered over 'seq'; not for "
                         "encoder-decoder models")
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

    dev = _device(args.device)
    cfg = build(args)
    if args.cp > 1:
        check_cp(cfg)
    mesh = _cp_mesh(args, dev)
    say = print if _rank0() else (lambda *a, **k: None)
    params = init_model(cfg, seed=0, device=dev)
    n_params = count_params(params)
    say(f"arch={cfg.name} params={n_params/1e6:.2f}M attn={cfg.attn} "
        f"device={dev}", flush=True)

    _, optimizer = pick_optimizer(cfg, n_params, lr=args.lr,
                                  total_steps=args.steps)
    opt_init, _ = optimizer
    if mesh is None:
        opt_state = opt_init(params)
    else:
        placement = placed.Placement(cfg, mesh)
        params = placement.place(params)
        opt_state = placement.init_opt_state(opt_init, params)
    train_step = make_train_step(cfg, optimizer, mesh=mesh,
                                 global_batch=args.batch)

    data = SyntheticLM(cfg.vocab_size, args.seq, seed=0)
    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if args.resume and mgr.latest_step() is not None:
            t0 = time.perf_counter()
            (params, opt_state), start_step, _ = mgr.restore(
                (params, opt_state), mesh=mesh,
                axes=None if mesh is None else param_axes(cfg))
            say(f"resumed from step {start_step} (restore "
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
            if mesh is not None:
                batch = placed.shard_batch(batch, mesh)
            mon.start_step()
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])     # waits for the step
            dt = mon.end_step()
            done = step + 1
            losses.append(loss)
            if step % args.log_every == 0:
                say(f"step {step:5d} loss {loss:.4f} "
                    f"gnorm {float(metrics['gnorm']):.3f} "
                    f"{dt*1e3:.0f}ms"
                    + (" [save in flight]" if writing else "")
                    + (" [STRAGGLER]" if mon.straggling else ""),
                    flush=True)
            if mgr and done % args.ckpt_every == 0 and done < args.steps:
                t0 = time.perf_counter()
                mgr.save(done, (params, opt_state), block=False, mesh=mesh)
                say(f"checkpoint {done} (async): "
                    f"{(time.perf_counter() - t0) * 1e3:.1f} ms on the "
                    f"loop's thread", flush=True)
    finally:
        it.close()
        pre.restore()
    if mgr:
        t0 = time.perf_counter()
        mgr.wait()                  # the periodic write still in flight
        t1 = time.perf_counter()
        mgr.save(done, (params, opt_state), block=True, mesh=mesh)
        say(f"checkpoint {done} (blocking): "
            f"{time.perf_counter() - t1:.3f} s (after {t1 - t0:.3f} s "
            f"waiting for the write before it)", flush=True)
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()              # the last checkpoint is on disk
    say(f"final loss {np.mean(losses[-10:]):.4f} "
        f"(first10 {np.mean(losses[:10]):.4f}) "
        f"step_stats={mon.stats()}", flush=True)
    return params, losses


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    main()
