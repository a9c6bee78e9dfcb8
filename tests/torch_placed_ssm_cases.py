"""Rank bodies of `tests/test_torch_placed_ssm.py`: the SSM mixers split
over "model" in the placed step, on the ranks' gloo group, both configs
in one spawn per mesh.

Like `tests/torch_placed_cases.py` (whose train and serve bodies these
ranks run) it imports torch and the port only, never JAX. The float32
islands of the MoE router, Mamba's scan and the xLSTM mixers are lifted
to float64 with the others (`lift_islands`). The "state" kind returns
each rank's SSM decode-state bytes beside rank 0's planned ones
(`rules.decode_state_shardings` of the whole state on the mesh).
"""
import importlib

import torch
import torch.distributed as dist

import torch_placed_cases as C
from repro_torch.launch.dryrun import _local_numel, _pairs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import decode_state_specs, init_decode_state
from repro_torch.models.transformer import _block_keys
from repro_torch.sharding.placed import SSM_MIXERS
from repro_torch.sharding.rules import decode_state_shardings, use_mesh

SSM_ISLANDS = ("repro_torch.models.moe", "repro_torch.models.mamba",
               "repro_torch.models.xlstm")


def ssm_state_bytes(cfg, batch: int, max_len: int, mesh) -> dict:
    """{"held": [bytes of each rank's SSM decode state, made under the
    mesh], "planned": rank 0's bytes of the whole state placed by
    `decode_state_shardings`}; collective (every rank calls it)."""
    whole = decode_state_specs(cfg, batch, max_len)
    specs = decode_state_shardings(whole, mesh, batch=batch)
    with use_mesh(mesh):
        local = init_decode_state(cfg, batch, max_len, device="meta")
    held = planned = 0
    for key, kind, _ in _block_keys(cfg):
        if kind.split(":")[0] not in SSM_MIXERS:
            continue
        for path, x, spec in _pairs(whole[key], specs[key]):
            planned += _local_numel(tuple(x.shape), spec, mesh, path) \
                * x.element_size()
        held += sum(x.numel() * x.element_size() for x in local[key])
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, held)
    return {"held": every, "planned": planned}


def _state(case, mesh):
    return ssm_state_bytes(C.config(case["arch"], case["attn"]),
                           case["batch_size"], case["max_len"], mesh)


KINDS = {**C.KINDS, "state": _state}


def ssm_cases(rank, world, shape, cases):
    """Each case on the (data, model) mesh of `shape`; rank 0 returns
    {name: results}."""
    del world
    C.lift_islands()
    for name in SSM_ISLANDS:
        importlib.import_module(name)._F32 = torch.float64
    mesh = make_test_mesh(shape, ("data", "model"))
    out = {case["name"]: KINDS[case["kind"]](case, mesh) for case in cases}
    return out if rank == 0 else None
