"""Rank bodies of `tests/test_torch_placed_moe.py`: the placed step of the
MoE configs on the ranks' gloo group, every mesh in one spawn.

Like `tests/torch_placed_cases.py` (whose train and serve bodies these
ranks run) it imports torch and the port only, never JAX. The float32
islands of the MoE router and of the Mamba scan are lifted to float64
with the others (`lift_islands`). Each case also returns every rank's
`models.moe.stats`: the pairs dropped past the global capacity and those
a capacity of the rank's own tokens would keep or drop the other way.
The "rank_grads" kind returns the placed grad fn's loss and, for the
leaves a case names, the grad each rank holds (not gathered).
"""
import importlib

import torch
import torch.distributed as dist

import torch_placed_cases as C
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import make_grad_fn
from repro_torch.models import moe as MOE
from repro_torch.models.param import from_jax_params
from repro_torch.optim.grad_utils import leaves
from repro_torch.sharding import placed as P

MOE_ISLANDS = ("repro_torch.models.moe", "repro_torch.models.mamba")


def _rank_grads(case, mesh):
    """The placed grad fn's loss and every rank's own grad of each leaf
    in `case["leaves"]` ([world] lists of arrays)."""
    cfg = C.config(case["arch"], case["attn"])
    placement = P.Placement(cfg, mesh)
    params = placement.place(from_jax_params(case["params"], cfg, "cpu"))
    batch = P.shard_batch({k: torch.as_tensor(v)
                           for k, v in case["batch"].items()}, mesh)
    loss, _, grads = make_grad_fn(cfg, mesh=mesh)(params, batch)
    mine = {n: g.detach().numpy().copy() for n, g in leaves(grads)
            if n in case["leaves"]}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return {"loss": float(loss),
            "grads": {n: [r[n] for r in every] for n in case["leaves"]}}


KINDS = {**C.KINDS, "rank_grads": _rank_grads}


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
            res = KINDS[case["kind"]](case, mesh)
            res["stats"] = [None] * world
            dist.all_gather_object(res["stats"], dict(MOE.stats))
            out[f"{shape[0]}x{shape[1]}-{case['name']}"] = res
    return out if rank == 0 else None
