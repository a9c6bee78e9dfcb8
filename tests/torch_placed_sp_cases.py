"""Rank bodies of `tests/test_torch_placed_sp.py`: the placed training
step with its residual split over "model" along the sequence, on the
ranks' gloo group.

Like `tests/torch_placed_cases.py` (whose configs and float64 islands
these ranks take) it imports torch and the port only, never JAX. Rank 0
returns numpy results and the counts.
"""
import contextlib

import torch

import torch_placed_cases as C
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.op_analysis import SavedBytes
from repro_torch.launch.steps import make_grad_fn
from repro_torch.models import transformer as T
from repro_torch.models.param import from_jax_params
from repro_torch.sharding import placed as P


@contextlib.contextmanager
def _collectives(log: list, marks: list):
    """Inside: every collective the placed step asks for appended to `log`
    as (kind, shape of what the rank sends), and len(log) appended to
    `marks` as each call of `transformer._logits` returns (the forward's
    end: the loss's collectives come after)."""
    collective, logits = P._collective, T._logits

    def record(kind, x, group, *, op=None):
        log.append((kind, tuple(x.shape)))
        return collective(kind, x, group, op=op)

    def mark(*args, **kwargs):
        out = logits(*args, **kwargs)
        marks.append(len(log))
        return out

    P._collective, T._logits = record, mark
    try:
        yield
    finally:
        P._collective, T._logits = collective, logits


def split_cases(rank, world, shape, cases):
    """Each case's placed grad fn on a (data, model) mesh of `shape`, its
    weights and batch the case's, under `SavedBytes`: the loss and the
    grads gathered whole, the saved bytes, the collectives of the
    forward, and with the case's "spy" what its layers held and saw
    (`torch_placed_cases.tp_spy`). Rank 0 returns {name: results}."""
    del world
    C.lift_islands()
    mesh = make_test_mesh(shape, ("data", "model"))
    out = {}
    for case in cases:
        cfg = C.config(case["arch"], case["attn"])
        placement = P.Placement(cfg, mesh)
        params = placement.place(from_jax_params(case["params"], cfg, "cpu"))
        batch = P.shard_batch({k: torch.as_tensor(v)
                               for k, v in case["batch"].items()}, mesh)
        log, marks = [], []
        spy = C.tp_spy() if case.get("spy") else contextlib.nullcontext()
        with _collectives(log, marks), SavedBytes() as saved, spy as seen:
            loss, _, grads = make_grad_fn(cfg, mesh=mesh)(params, batch)
        out[case["name"]] = {
            "loss": float(loss), "grads": C._np(P.full(grads, mesh)),
            "saved_bytes": saved.total,
            "block_input_bytes": saved.block_inputs,
            "forward": log[:marks[0]], "seen": seen}
    return out if rank == 0 else None
