"""Rank bodies of `tests/test_torch_placed_moe.py`: the placed step of the
MoE configs on the ranks' gloo group, every mesh in one spawn.

Like `tests/torch_placed_cases.py` (whose train and serve bodies these
ranks run) it imports torch and the port only, never JAX. The float32
islands of the MoE router and of the Mamba scan are lifted to float64
with the others (`lift_islands`). Each case also returns every rank's
`models.moe.stats`: the pairs dropped past the global capacity and those
a capacity of the rank's own tokens would keep or drop the other way.
"""
import importlib

import torch
import torch.distributed as dist

import torch_placed_cases as C
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import moe as MOE

MOE_ISLANDS = ("repro_torch.models.moe", "repro_torch.models.mamba")


def moe_cases(rank, world, shapes, cases):
    """Each case on each (data, model) mesh of `shapes`; rank 0 returns
    {"<data>x<model>-<name>": results}."""
    C.lift_islands()
    for name in MOE_ISLANDS:
        importlib.import_module(name)._F32 = torch.float64
    out = {}
    for shape in shapes:
        mesh = make_test_mesh(shape, ("data", "model"))
        for case in cases:
            MOE.stats.clear()
            res = C.KINDS[case["kind"]](case, mesh)
            res["stats"] = [None] * world
            dist.all_gather_object(res["stats"], dict(MOE.stats))
            out[f"{shape[0]}x{shape[1]}-{case['name']}"] = res
    return out if rank == 0 else None
