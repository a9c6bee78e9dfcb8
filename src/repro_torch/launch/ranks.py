"""Run one function on several local ranks of a process group.

`run_ranks(fn, world, args=..., workdir=...)` spawns `world` processes
(start method `spawn`: a parent that holds a CUDA context cannot fork),
joins them in one gloo group through a `FileStore` under `workdir`
(no port to pick), calls `fn(rank, world, *args)` in each and returns
their results, rank by rank. A rank that raises, or a run past its
deadline, fails the whole call; every process is stopped before it
returns. The multi-rank tests and `chip_smoke.py` use it: several ranks
on the CPU, or on one card (gloo carries CUDA tensors too).
"""
from __future__ import annotations

import datetime
import pickle
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["run_ranks"]


def _entry(rank, fn, world, args, workdir, timeout, threads):
    if threads:
        torch.set_num_threads(threads)
    store = dist.FileStore(str(Path(workdir) / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(Path(workdir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn, world: int, *, args: tuple = (), workdir,
              timeout: float = 60.0, threads: int = 1) -> list:
    """[fn(r, world, *args) for each rank r], each run in its own
    process; `fn` must be importable by name (a module-level function),
    `args` and the results picklable. `threads` caps each rank's torch
    threads (0: torch's default)."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    for stale in (*workdir.glob("rank*.pkl"), workdir / "store"):
        stale.unlink(missing_ok=True)
    ctx = mp.start_processes(
        _entry, args=(fn, world, args, str(workdir), timeout, threads),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} passed "
                                   f"their {timeout:.0f} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(world):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    (workdir / "store").unlink(missing_ok=True)
    return out
