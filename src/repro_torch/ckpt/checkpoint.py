"""Atomic, async checkpointing — port of `repro/ckpt/checkpoint.py`.

Layout (the reference's, byte for byte in its manifest's keys):
    ckpt_dir/step_00000100/
        manifest.json           leaf paths, files, shapes, dtypes, step
        arrays/<leaf-id>.npy    one file per leaf, on the host
    ckpt_dir/LATEST             pointer, written last

  * ATOMIC: a step is written into `.tmp_step_*` and renamed; LATEST is
    replaced only after the rename, so a save cut short never damages the
    checkpoint before it.
  * ASYNC: `CheckpointManager.save(..., block=False)` copies every leaf to
    host memory on the caller's thread, then writes on a thread while the
    train loop goes on (the in-place optimizer may overwrite the leaves as
    soon as `save` returns).
  * SAME FORMAT AS THE REFERENCE: leaf paths are spelled as the
    reference's `_flatten` spells a jax.tree_util path (dict keys in
    sorted order joined by "/", tuple and list indices as numbers, a
    NamedTuple field as ".name", e.g. `1/.step`; None leaves skipped), and
    bfloat16 / float8 leaves are stored as a same-width unsigned view with
    the logical dtype in the manifest.

  * PLACED STATES (`sharding.placed`): with a `mesh`, a save gathers each
    placed leaf whole (one leaf at a time, on every rank: every rank
    calls it) and rank 0 writes the reference's format; a restore with a
    `mesh` and the model's logical `axes` cuts each leaf into the rank's
    shard by its spec on that mesh — the reference's
    `load_checkpoint(..., shardings=)`, elastic restore: a run saved on
    one mesh resumes on another, or on one device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "CheckpointManager"]

# numpy cannot hold these dtypes: stored as a same-width unsigned view
# (the reference's `_EXT_DTYPE_VIEW`); torch reinterprets them through an
# integer type of that width that both libraries have
_EXT_DTYPE_VIEW = {"bfloat16": (np.uint16, np.int16, torch.int16),
                   "float8_e4m3fn": (np.uint8, np.uint8, torch.uint8),
                   "float8_e5m2": (np.uint8, np.uint8, torch.uint8)}


def _to_host(x: torch.Tensor):
    """(a numpy copy of the leaf, never a view of a tensor the caller will
    update in place, with an extended dtype as its unsigned view; the
    logical dtype's name)."""
    t = x.detach().to("cpu", copy=True)
    name = str(t.dtype).removeprefix("torch.")
    if name in _EXT_DTYPE_VIEW:
        saved, _, as_int = _EXT_DTYPE_VIEW[name]
        return t.view(as_int).numpy().view(saved), name
    return t.numpy(), name


def _from_saved(arr: np.ndarray, name: str) -> torch.Tensor:
    if name in _EXT_DTYPE_VIEW:
        _, np_int, _ = _EXT_DTYPE_VIEW[name]
        return torch.from_numpy(arr.view(np_int)).view(getattr(torch, name))
    return torch.from_numpy(arr)


def _flatten(tree, prefix: str = ""):
    """[(path, leaf)] in the reference's order and spelling."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [(str(k), tree[k]) for k in keys]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        parts = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        parts = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for name, sub in parts:
        out += _flatten(sub, f"{prefix}/{name}" if prefix else name)
    return out


def _unflatten(like, values: dict, prefix: str = ""):
    """`like`'s structure with the leaf at each path taken from `values`
    (dicts keep `like`'s key order)."""
    def at(name):
        return f"{prefix}/{name}" if prefix else name

    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, values, at(str(k))) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), values, at(f".{f}"))
                            for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, values, at(str(i)))
                          for i, x in enumerate(like))
    return values[prefix]


def _structure(tree) -> str:
    """An informational rendering of the tree (the manifest's "treedef";
    restore reads `like`, not this)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (f"{type(tree).__name__}("
                + ", ".join(_structure(x) for x in tree) + ")")
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_structure(x) for x in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def _snapshot(tree, mesh=None):
    """Every leaf copied to the host, [(path, saveable array, logical
    dtype)], and the tree's rendering. With a `mesh`, each placed leaf is
    gathered whole first (a collective)."""
    if mesh is not None:
        from repro_torch.sharding.placed import full_leaf

        leaves = [(path, *_to_host(full_leaf(x, mesh)))
                  for path, x in _flatten(tree)]
    else:
        leaves = [(path, *_to_host(x)) for path, x in _flatten(tree)]
    return leaves, _structure(tree)


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or the
    only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _write(ckpt_dir: str, step: int, snapshot, extra: Optional[dict]) -> str:
    leaves, structure = snapshot
    tag = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, f".tmp_{tag}")
    final = os.path.join(ckpt_dir, tag)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)

    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (path, arr, dtype) in enumerate(leaves):
        fn = f"{i:05d}.npy"
        np.save(os.path.join(tmp, "arrays", fn), arr)
        manifest["leaves"].append(
            {"path": path, "file": fn, "shape": list(arr.shape),
             "dtype": dtype})
    manifest["treedef"] = structure   # informational; restore uses `like`
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    with open(os.path.join(ckpt_dir, ".LATEST_tmp"), "w") as f:
        f.write(tag)
    os.replace(os.path.join(ckpt_dir, ".LATEST_tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[dict] = None, *, mesh=None):
    """Synchronous atomic save. Returns the final checkpoint path. With a
    `mesh`, a placed tree: every rank calls it, rank 0 writes (the other
    ranks return None)."""
    snapshot = _snapshot(tree, mesh)
    if mesh is not None and not _writer():
        return None
    return _write(ckpt_dir, step, snapshot, extra)


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        tag = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, tag)):
        return None
    return int(tag.split("_")[1])


def _axes_for(path: str, flat_axes: dict):
    """The logical axes of the parameter whose path is the longest
    suffix of `path` (an optimizer state's m, v and master mirror the
    parameters), or None (replicated: the optimizer's step)."""
    parts = path.split("/")
    for i in range(len(parts)):
        hit = flat_axes.get("/".join(parts[i:]))
        if hit is not None:
            return hit
    return None


def _flat_axes(axes, prefix: str = "") -> dict:
    if isinstance(axes, dict):
        out = {}
        for k, v in axes.items():
            out.update(_flat_axes(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tuple(axes)}


def load_checkpoint(ckpt_dir: str, like: Any, *, step: Optional[int] = None,
                    device=None, mesh=None, axes=None):
    """Restore into the structure of `like` (a tree of tensors: nested
    dicts, tuples, NamedTuples such as `OptState`, None leaves skipped).
    Each leaf keeps the dtype it was saved with and goes to `device`, or
    else to the device of `like`'s leaf at its path. With a `mesh` and
    `axes` (the model's logical axes, `models.param_axes`), each leaf
    whose path ends in a parameter's path is cut into the rank's shard by
    its spec on that mesh and recorded as placed (`sharding.placed`); the
    rest (the optimizer's step) whole. Returns (tree, step, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {m["path"]: m for m in manifest["leaves"]}
    flat_axes = {} if mesh is None else _flat_axes(axes)
    values = {}
    for path, leaf in _flatten(like):
        m = by_path[path]
        t = _from_saved(np.load(os.path.join(d, "arrays", m["file"])),
                        m["dtype"])
        t = t.to(device if device is not None else leaf.device)
        ax = _axes_for(path, flat_axes) if mesh is not None else None
        if ax is not None:
            from repro_torch.kernels.sharded import shard_local
            from repro_torch.sharding.placed import tag
            from repro_torch.sharding.rules import spec_for

            spec = spec_for(ax, tuple(t.shape), mesh)
            t = tag(shard_local(t, spec, mesh), spec)
        values[path] = t
    return _unflatten(like, values), step, manifest.get("extra", {})


class CheckpointManager:
    """Async save + retention (`keep` newest steps). The snapshot to host
    memory is taken on the caller's thread; the disk write runs on a
    background thread, and `wait()` joins it (call it before exit; the
    next `save` joins the previous write itself)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             block: bool = True, mesh=None):
        """Save `tree` as `step`. With a `mesh`, a placed tree: every rank
        calls it (the snapshot gathers each leaf) and rank 0 writes."""
        snapshot = _snapshot(tree, mesh)
        self.wait()
        if mesh is not None and not _writer():
            return

        def work():
            _write(self.dir, step, snapshot, extra)
            self._gc()

        if block:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    @property
    def writing(self) -> bool:
        """True while a background write is in flight."""
        return self._thread is not None and self._thread.is_alive()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, like, *, step=None, device=None, mesh=None,
                axes=None):
        return load_checkpoint(self.dir, like, step=step, device=device,
                               mesh=mesh, axes=axes)

    def latest_step(self):
        return latest_step(self.dir)

    def _gc(self):
        tags = sorted(t for t in os.listdir(self.dir)
                      if t.startswith("step_"))
        for t in tags[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, t), ignore_errors=True)
