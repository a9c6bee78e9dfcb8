"""Rank bodies of `tests/test_torch_placed_hybrid.py`: the moment decode
states (fastmax chunked, both hybrid backends) and the hybrid window as
the rank's block of `decode_state_shardings` in the placed serve step, on
the ranks' gloo group.

Like `tests/torch_placed_cases.py` (whose helpers these ranks use) it
imports torch and the port only, never JAX: the parent computes the JAX
references and hands the ranks numpy. The float32 islands are lifted to
float64 (`lift_islands`). Rank 0 returns each case's results, the ranks'
rows gathered over "data"; a case held against one process runs that
process's call on the rank's own rows beside the placed one.
"""
import torch
import torch.distributed as dist

import torch_placed_cases as C
from repro_torch import attention as A
from repro_torch.attention import AttentionSpec
from repro_torch.attention.state import AttnState
from repro_torch.kernels import sharded as S
from repro_torch.launch.dryrun import _local_numel
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import decode_state_specs, init_decode_state
from repro_torch.models.param import from_jax_params
from repro_torch.models.transformer import lm_decode_step, lm_prefill
from repro_torch.sharding import placed as P
from repro_torch.sharding.rules import (decode_state_shardings,
                                        kv_cache_block, mesh_axes,
                                        moments_block, use_mesh)


def attn_states(node, spec=None):
    """(state, its specs or None) of each AttnState in a decode state."""
    if isinstance(node, AttnState):
        yield node, spec
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from attn_states(v, None if spec is None else spec[k])


def _leaves(st):
    """[(name, leaf)] of an AttnState's moments and window (k, v, mask)."""
    out = list(zip(("m0", "m1", "m2", "g0", "g1", "g2"), st.moments))
    if st.kv is not None:
        out += [(n, getattr(st.kv, n)) for n in ("k", "v", "mask")]
    return out


def _state(case, mesh):
    """Each rank's moments and window against the plan: their modes and
    types, each leaf's shape against its block of the whole state, how
    many leaves the plan splits over "model" a rank holds whole, and the
    bytes a rank (each rank's) beside rank 0's planned ones."""
    cfg = C.config(case["arch"], case["attn"])
    b, n = case["batch_size"], case["max_len"]
    whole = decode_state_specs(cfg, b, n)
    specs = decode_state_shardings(whole, mesh, batch=b)
    sizes = mesh_axes(mesh)
    with use_mesh(mesh):
        local = init_decode_state(cfg, b // mesh.size(0), n, device="meta")
        one = next(attn_states(local))[0]
        modes = [moments_block(cfg.n_kv_heads, cfg.head_dim).mode,
                 None if one.kv is None else kv_cache_block(
                     cfg.n_kv_heads, one.kv.k.shape[2] * (
                         sizes["model"] if type(one.kv).__name__
                         == "KVCacheRows" else 1)).mode]
    planned = held = 0
    shapes_ok, whole_split, types = True, 0, set()
    for (st, _), (wst, sp) in zip(attn_states(local),
                                  attn_states(whole, specs)):
        types.add(type(st.kv).__name__)
        wsp = dict(zip(("m0", "m1", "m2", "g0", "g1", "g2"), sp.moments))
        if sp.kv is not None:
            wsp.update(k=sp.kv.k, v=sp.kv.v, mask=sp.kv.mask)
        for (name, x), (_, w) in zip(_leaves(st), _leaves(wst)):
            s = wsp[name]
            want, unsplit = list(w.shape), list(w.shape)
            for d, e in enumerate(s):
                for a in (() if e is None else (e,) if isinstance(e, str)
                          else e):
                    want[d] //= sizes[a]
                    if a != "model":
                        unsplit[d] //= sizes[a]
            shapes_ok = shapes_ok and list(x.shape) == want
            whole_split += int(want != unsplit and list(x.shape) == unsplit)
            planned += _local_numel(tuple(w.shape), s, mesh, name) \
                * w.element_size()
            held += x.numel() * x.element_size()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, held)
    return {"modes": modes, "types": sorted(types), "shapes_ok": shapes_ok,
            "whole_split": whole_split, "held": every, "planned": planned}


def _setup(case, mesh, whole: bool = False):
    """(cfg, the placement, placed params, the whole params if `whole`)."""
    cfg = C.config(case["arch"], case["attn"])
    placement = P.Placement(cfg, mesh)
    params = from_jax_params(case["params"], cfg, "cpu")
    return cfg, placement, placement.place(params), \
        (params if whole else None)


def _rows(case, key, mesh):
    return P.shard_batch({"t": torch.as_tensor(case[key])}, mesh)["t"]


def _serve(case, mesh):
    """lm_prefill (with the case's kv_mask, if any) then greedy
    lm_decode_steps on the placed model: the logits gathered whole over
    the vocab and "data", the greedy tokens, the sharded hybrid prefill
    calls, and one process's prefill logits on the whole model; without
    a kv_mask also the tokens of the placed prefill and serve steps."""
    cfg, placement, params, whole = _setup(case, mesh, whole=True)
    tokens = _rows(case, "tokens", mesh)
    mask = _rows(case, "kv_mask", mesh) if "kv_mask" in case else None
    b, plen = tokens.shape
    S.calls.clear()
    with torch.no_grad():
        one = lm_prefill(whole, tokens, cfg, init_decode_state(
            cfg, b, case["max_len"], device="cpu"), kv_mask=mask)[0]
        with use_mesh(mesh):
            st = init_decode_state(cfg, b, case["max_len"], device="cpu")
        logits = []
        with C._placed(placement, mesh):
            lg, st = lm_prefill(params, tokens, cfg, st, kv_mask=mask)
            lg = P.gather_vocab(lg, cfg.vocab_size)
            logits.append(lg)
            tok = lg[:, -1].argmax(-1)
            toks = [tok]
            for i in range(case["n_dec"]):
                lg, st = lm_decode_step(params, st, tok, cfg,
                                        position=plen + i)
                lg = P.gather_vocab(lg, cfg.vocab_size)
                logits.append(lg)
                tok = lg.argmax(-1)
                toks.append(tok)
        out = {"prefill": C._rows(logits[0], mesh).numpy(),
               "prefill_one": C._rows(one, mesh).numpy(),
               "decode": [C._rows(x, mesh).numpy() for x in logits[1:]],
               "greedy": C._rows(torch.stack(toks, 1), mesh).numpy(),
               "hybrid_prefill_sharded": S.calls["hybrid_prefill_sharded"]}
        if mask is None:
            with use_mesh(mesh):
                st = init_decode_state(cfg, b, case["max_len"],
                                       device="cpu")
            prefill, serve = (make_prefill_step(cfg, mesh=mesh),
                              make_serve_step(cfg, mesh=mesh))
            tok, st = prefill(params, st, tokens)
            toks = [tok]
            for i in range(case["n_dec"]):
                tok, st = serve(params, st, tok, plen + i)
                toks.append(tok)
            out["tokens"] = C._rows(torch.stack(toks, 1), mesh).numpy()
    return out


def _resume(case, mesh):
    """A left-padded prompt's first `split` tokens prefilled, the rest a
    resumed (`offset=`) prefill, then greedy decode steps, on the placed
    model and on the whole model in one process, both on the rank's
    rows: {"placed": [logits], "one": [logits]}, gathered."""
    cfg, placement, placed, whole = _setup(case, mesh, whole=True)
    tokens = _rows(case, "tokens", mesh)
    mask = _rows(case, "kv_mask", mesh)
    split, plen = case["split"], tokens.shape[1]
    b = tokens.shape[0]

    def run(params, st, scope):
        out = []
        with scope():
            lg, st = lm_prefill(params, tokens[:, :split], cfg, st,
                                kv_mask=mask[:, :split])
            out.append(lg)
            lg, st = lm_prefill(params, tokens[:, split:], cfg, st,
                                kv_mask=mask[:, split:], offset=split)
            out.append(lg)
            tok = (P.gather_vocab(lg, cfg.vocab_size) if P.active()
                   else lg)[:, -1].argmax(-1)
            for i in range(case["n_dec"]):
                lg, st = lm_decode_step(params, st, tok, cfg,
                                        position=plen + i)
                out.append(lg)
                tok = (P.gather_vocab(lg, cfg.vocab_size) if P.active()
                       else lg).argmax(-1)
        return out

    with torch.no_grad():
        with use_mesh(mesh):
            st = init_decode_state(cfg, b, case["max_len"], device="cpu")
        got = run(placed, st, lambda: C._placed(placement, mesh))
        want = run(whole, init_decode_state(cfg, b, case["max_len"],
                                            device="cpu"),
                   C.contextlib.nullcontext)

    def gathered(xs):
        return [C._rows(P.gather_vocab(x, cfg.vocab_size) if x.shape[-1]
                        != cfg.vocab_size else x, mesh).numpy()
                for x in xs]

    with C._placed(placement, mesh):
        return {"placed": gathered(got), "one": gathered(want)}


def _refusals(case, mesh):
    """A state that is not the rank's block raises: the whole state under
    the mesh, and the mesh's block without it (a step on each)."""
    spec = AttentionSpec.parse(case["attn"])
    hkv = case["hkv"]
    x = torch.zeros(2, 4, 1, 16, dtype=torch.float64)
    kv = torch.zeros(2, hkv, 1, 16, dtype=torch.float64)

    def init():
        return A.init_state(spec, batch=2, n_kv_heads=hkv, q_head_dim=16,
                            v_head_dim=16, max_len=32, dtype=torch.float64)

    raised = []
    whole = init()
    with use_mesh(mesh):
        block = init()
        try:
            A.step(whole, x, kv, kv, spec)
            raised.append(False)
        except ValueError:
            raised.append(True)
    try:
        A.step(block, x, kv, kv, spec)
        raised.append(False)
    except ValueError:
        raised.append(True)
    return {"raised": raised}


KINDS = {"state": _state, "serve": _serve, "resume": _resume,
         "refusals": _refusals}


def hybrid_cases(rank, world, shape, cases):
    """Each case on the (data, model) mesh of `shape`; rank 0 returns
    {name: results}."""
    del world
    C.lift_islands()
    mesh = make_test_mesh(shape, ("data", "model"))
    out = {case["name"]: KINDS[case["kind"]](case, mesh) for case in cases}
    return out if rank == 0 else None
