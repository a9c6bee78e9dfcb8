"""Rank bodies of `tests/test_torch_placed.py`: the placed step
(`repro_torch.sharding.placed`) on the ranks' gloo group.

`repro_torch.launch.ranks.run_ranks` spawns the ranks, which import this
module by name: it imports torch and the port only, never JAX (the parent
test computes the JAX references and hands the ranks numpy). Rank 0
returns numpy results gathered whole.

`lift_islands` makes the port's float32 islands (norms, RoPE, the loss,
the gradient norm and AdamW's state and arithmetic) compute in float64,
as the parent does to the reference's through a `jnp` whose `float32` is
float64: the placement changes no precision, so a float64 model is then
held at 1e-10.
"""
import contextlib
import importlib

import numpy as np
import torch

from repro_torch.attention import AttentionSpec
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import (make_grad_fn, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models import init_decode_state, param_axes
from repro_torch.models.param import from_jax_params
from repro_torch.models.transformer import lm_decode_step, lm_prefill
from repro_torch.optim import constant, make_optimizer
from repro_torch.optim.grad_utils import leaves
from repro_torch.sharding import placed as P
from repro_torch.sharding.rules import use_mesh

ISLANDS = ("repro_torch.models.layers", "repro_torch.models.transformer",
           "repro_torch.sharding.placed", "repro_torch.optim.grad_utils",
           "repro_torch.optim.optimizers", "repro_torch.launch.steps")
F64 = dict(param_dtype="float64", activ_dtype="float64")


def lift_islands(dtype=torch.float64) -> None:
    for name in ISLANDS:
        importlib.import_module(name)._F32 = dtype


def config(arch: str, attn: str):
    return get_smoke_config(arch, attn=AttentionSpec.parse(attn), **F64)


def _np(tree) -> dict:
    """Copies: the optimizer updates the leaves in place."""
    return {n: x.detach().cpu().numpy().copy() for n, x in leaves(tree)}


def _rows(x, mesh):
    """The global rows of a tensor whose dim 0 is split over "data"."""
    if mesh.size(0) == 1:
        return x
    return P._gather_dim(x.contiguous(), 0, mesh.get_group("data"))


@contextlib.contextmanager
def _placed(placement, mesh):
    with use_mesh(mesh), placement.active():
        yield


def _train(case, mesh):
    """`case["steps"]` placed AdamW steps from the case's weights: each
    step's loss and gnorm, then the parameters and AdamW's m and v
    gathered whole."""
    cfg = config(case["arch"], case["attn"])
    placement = P.Placement(cfg, mesh)
    params = placement.place(from_jax_params(case["params"], cfg, "cpu"))
    opt = make_optimizer("adamw", constant(case["lr"]))
    state = placement.init_opt_state(opt[0], params)
    step = make_train_step(cfg, opt, mesh=mesh)
    batch = P.shard_batch({k: torch.as_tensor(v)
                           for k, v in case["batch"].items()}, mesh)
    out = {"loss": [], "gnorm": []}
    for _ in range(case["steps"]):
        params, state, m = step(params, state, batch)
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["gnorm"]))
    out["params"] = _np(P.full(params, mesh))
    out["m"] = _np(P.full(state.m, mesh))
    out["v"] = _np(P.full(state.v, mesh))
    return out


def _serve(case, mesh):
    """lm_prefill then greedy lm_decode_steps on the placed model (the
    logits gathered whole, each rank's rows gathered back), and the
    tokens of the placed prefill and serve steps."""
    cfg = config(case["arch"], case["attn"])
    placement = P.Placement(cfg, mesh)
    params = placement.place(from_jax_params(case["params"], cfg, "cpu"))
    tokens = P.shard_batch({"t": torch.as_tensor(case["tokens"])},
                           mesh)["t"]
    b, plen = tokens.shape

    def state():
        with use_mesh(mesh):
            return init_decode_state(cfg, b, case["max_len"], device="cpu")

    logits = []
    with torch.no_grad():
        st = state()
        with _placed(placement, mesh):
            lg, st = lm_prefill(params, tokens, cfg, st)
            lg = P.gather_vocab(lg, cfg.vocab_size)
            logits.append(lg)
            tok = lg[:, -1].argmax(-1)
            for i in range(case["n_dec"]):
                lg, st = lm_decode_step(params, st, tok, cfg,
                                        position=plen + i)
                lg = P.gather_vocab(lg, cfg.vocab_size)
                logits.append(lg)
                tok = lg.argmax(-1)
        st = state()
        prefill, serve = (make_prefill_step(cfg, mesh=mesh),
                          make_serve_step(cfg, mesh=mesh))
        tok, st = prefill(params, st, tokens)
        toks = [tok]
        for i in range(case["n_dec"]):
            tok, st = serve(params, st, tok, plen + i)
            toks.append(tok)
    return {"prefill": _rows(logits[0], mesh).numpy(),
            "decode": [_rows(x, mesh).numpy() for x in logits[1:]],
            "tokens": _rows(torch.stack(toks, 1), mesh).numpy()}


def _grads(case, mesh):
    """The placed grad fn's loss and grads gathered whole."""
    cfg = config(case["arch"], case["attn"])
    placement = P.Placement(cfg, mesh)
    params = placement.place(from_jax_params(case["params"], cfg, "cpu"))
    batch = P.shard_batch({k: torch.as_tensor(v)
                           for k, v in case["batch"].items()}, mesh)
    loss, _, grads = make_grad_fn(cfg, mesh=mesh)(params, batch)
    return {"loss": float(loss), "grads": _np(P.full(grads, mesh))}


KINDS = {"train": _train, "serve": _serve, "grads": _grads}


def placed_cases(rank, world, shape, cases, lift):
    """Each case on a (data, model) mesh of `shape`; rank 0 returns
    {name: results}."""
    del world
    if lift:
        lift_islands()
    mesh = make_test_mesh(shape, ("data", "model"))
    out = {case["name"]: KINDS[case["kind"]](case, mesh) for case in cases}
    return out if rank == 0 else None


def elastic_ckpt(rank, world, case, ckpt_dir):
    """A run on (data 2, model 2) of `case["steps"]` AdamW steps that saves
    after 2; the same run restored from that checkpoint on (2, 2), on
    (1, 4) and (rank 0) on one process, each continued to the end.
    Rank 0 returns, per run, the losses after the restore, the restored
    state and the final parameters, gathered whole."""
    from repro_torch.ckpt import CheckpointManager

    del world
    lift_islands()
    cfg = config(case["arch"], case["attn"])
    opt = make_optimizer("adamw", constant(case["lr"]))
    axes = param_axes(cfg)
    whole = {k: torch.as_tensor(v) for k, v in case["batch"].items()}

    def run(mesh, restore: bool):
        params = from_jax_params(case["params"], cfg, "cpu")
        batch = whole
        if mesh is None:
            state = opt[0](params)
        else:
            placement = P.Placement(cfg, mesh)
            params = placement.place(params)
            state = placement.init_opt_state(opt[0], params)
            batch = P.shard_batch(whole, mesh)
        mgr = CheckpointManager(ckpt_dir)
        start, restored = 0, None
        if restore:
            (params, state), start, _ = mgr.restore(
                (params, state), mesh=mesh,
                axes=None if mesh is None else axes)
            restored = (_np(params if mesh is None else P.full(params, mesh)),
                        _np(state.m if mesh is None
                            else P.full(state.m, mesh)))
        step = make_train_step(cfg, opt, mesh=mesh)
        losses = []
        for i in range(start, case["steps"]):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            if not restore and i + 1 == 2:
                mgr.save(2, (params, state), mesh=mesh)
                saved = (_np(params if mesh is None
                             else P.full(params, mesh)),
                         _np(state.m if mesh is None
                             else P.full(state.m, mesh)))
        final = _np(params if mesh is None else P.full(params, mesh))
        return {"losses": losses, "final": final,
                "restored": saved if not restore else restored}

    out = {"unbroken": run(make_test_mesh((2, 2), ("data", "model")),
                           False)}
    torch.distributed.barrier()
    out["2x2"] = run(make_test_mesh((2, 2), ("data", "model")), True)
    out["1x4"] = run(make_test_mesh((1, 4), ("data", "model")), True)
    if rank == 0:
        out["one"] = run(None, True)
    torch.distributed.barrier()
    return out if rank == 0 else None


@contextlib.contextmanager
def tp_spy():
    """Inside, the model's attention and MLP layers record into the dict
    yielded: "attention", the set of (site, wq, wk, wv, wo shapes) of
    every attention layer's call (site "noncausal", "causal", "cross",
    "prefill" or "decode"); "mlp", the set of (wi, wo shapes) of every
    GELU MLP's call; "heads", the set of (entry point, q, k, v heads) of
    every call of the attention API; "whole", the shapes of the leaves a
    gather over "model" made whole (none under tensor parallelism)."""
    from repro_torch import attention as A
    from repro_torch.models import layers as L

    seen = {"attention": set(), "mlp": set(), "heads": set(), "whole": []}
    saved = {(L, n): getattr(L, n) for n in (
        "apply_attention", "attention_prefill", "attention_decode",
        "apply_mlp")}
    saved.update({(A, n): getattr(A, n) for n in ("attention", "prefill",
                                                   "step")})
    saved[(P, "gather")] = P.gather

    def shapes(p, names):
        return tuple(tuple(p[n].shape) for n in names)

    def layer(name):
        def call(params, x, *a, **kw):
            if name == "apply_mlp":
                seen["mlp"].add(shapes(params, ("wi", "wo")))
            else:
                site = {"attention_prefill": "prefill",
                        "attention_decode": "decode"}.get(name)
                if site is None:
                    site = ("cross" if kw.get("kv_x") is not None else
                            "causal" if kw.get("causal", True)
                            else "noncausal")
                seen["attention"].add((site,) + shapes(
                    params, ("wq", "wk", "wv", "wo")))
            return saved[(L, name)](params, x, *a, **kw)
        return call

    def api(name):
        at = 1 if name == "step" else 0          # where q sits

        def call(*args, **kw):
            q, k, v = args[at:at + 3]
            seen["heads"].add((name, q.shape[1], k.shape[1], v.shape[1]))
            return saved[(A, name)](*args, **kw)
        return call

    def gather(leaf, over, mesh, *, sum_over=()):
        out = saved[(P, "gather")](leaf, over, mesh, sum_over=sum_over)
        if "model" in over and "model" in P.split_axes(P.spec_of(leaf)):
            seen["whole"].append(tuple(out.shape))
        return out

    for (mod, name) in saved:
        setattr(mod, name, gather if mod is P else
                layer(name) if mod is L else api(name))
    try:
        yield seen
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def as_numpy_tree(tree):
    """A torch tree as numpy arrays (the form the ranks take weights in)."""
    if isinstance(tree, dict):
        return {k: as_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree.detach().cpu().numpy())
