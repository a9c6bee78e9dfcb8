"""Production mesh construction — port of `repro/launch/mesh.py`.

Functions, not module-level constants, so importing touches no process
group. One pod is 16 x 16 = 256 devices as ("data", "model"); two pods
prepend "pod" = 2. The meshes are `torch.distributed.device_mesh`
DeviceMeshes over the default process group, which the caller starts
first (`torch.distributed.init_process_group` with its address, world
size and rank: nothing on a machine tells a program of its cluster).
"""
from __future__ import annotations

import math

__all__ = ["make_production_mesh", "make_test_mesh"]


def _make_mesh(shape, axes, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {n} ranks: call "
            f"torch.distributed.init_process_group first")
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh ({axes}) needs {n} ranks, the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, cp: int = 1,
                         device_type: str = "cuda"):
    """One pod (16, 16) as ("data", "model"); `multi_pod` prepends "pod" =
    2. `cp` > 1 trades "model" for a "seq" (context-parallel) axis: each
    pod's 256 devices become (data = 256 / cp, seq = cp); cp excludes the
    "model" axis, as in the reference."""
    if cp > 1:
        if 256 % cp:
            raise ValueError(f"cp={cp} must divide the 256 devices of a pod")
        shape = (2, 256 // cp, cp) if multi_pod else (256 // cp, cp)
        axes = ("pod", "data", "seq") if multi_pod else ("data", "seq")
        return _make_mesh(shape, axes, device_type)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cpu"):
    """A small mesh for tests."""
    return _make_mesh(shape, axes, device_type)
