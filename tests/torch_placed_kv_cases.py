"""Rank bodies of `tests/test_torch_placed_kv.py`: the softmax KV cache as
the rank's block of `kv_cache_spec` in the placed serve step, on the
ranks' gloo group.

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
import torch_placed_hybrid_cases as HC
from repro_torch import attention as A
from repro_torch.attention import AttentionSpec
from repro_torch.attention.state import KVCache
from repro_torch.launch.dryrun import _local_numel
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import decode_state_specs, init_decode_state
from repro_torch.models.encdec import encode
from repro_torch.models.param import from_jax_params
from repro_torch.models.transformer import lm_decode_step, lm_prefill
from repro_torch.serve.slots import to_slotted
from repro_torch.sharding import placed as P
from repro_torch.sharding.rules import (decode_state_shardings,
                                        kv_cache_block, mesh_axes,
                                        use_mesh)


def kv_caches(node, spec=None):
    """(cache, its specs or None) of each KVCache in a decode state."""
    if isinstance(node, KVCache):
        yield node, spec
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from kv_caches(v, None if spec is None else spec[k])
    elif isinstance(node, tuple):
        for i, v in enumerate(node):
            yield from kv_caches(v, None if spec is None else spec[i])


def _state(case, mesh):
    """Each rank's KV caches against the plan: their mode, each leaf's
    shape against its `kv_cache_spec` block of the whole state, whether
    any leaf is whole, and the bytes a rank beside rank 0's planned
    ones."""
    cfg = C.config(case["arch"], "softmax")
    b, n = case["batch_size"], case["max_len"]
    whole = decode_state_specs(cfg, b, n)
    specs = decode_state_shardings(whole, mesh, batch=b)
    rows = b // mesh.size(0)
    with use_mesh(mesh):
        local = init_decode_state(cfg, rows, n, device="meta")
        mode = kv_cache_block(cfg.n_kv_heads, n).mode
    planned = held = 0
    shapes_ok, whole_leaves, types = True, 0, set()
    for (kv, _), (wkv, sp) in zip(kv_caches(local), kv_caches(whole, specs)):
        types.add(type(kv).__name__)
        for name in ("k", "v", "mask"):
            x, w, s = getattr(kv, name), getattr(wkv, name), getattr(sp, name)
            want = list(w.shape)
            sizes = mesh_axes(mesh)
            for d, e in enumerate(s):
                for a in (() if e is None else (e,) if isinstance(e, str)
                          else e):
                    want[d] //= sizes[a]
            shapes_ok = shapes_ok and list(x.shape) == want
            whole_leaves += int(tuple(x.shape) == tuple(w.shape))
            planned += _local_numel(tuple(w.shape), s, mesh, name) \
                * w.element_size()
            held += x.numel() * x.element_size()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, held)
    return {"mode": mode, "types": sorted(types), "shapes_ok": shapes_ok,
            "whole_leaves": whole_leaves, "held": every, "planned": planned}


def _setup(case, mesh, whole: bool = False):
    """(cfg, the placement, placed params, the whole params if `whole`)."""
    cfg = C.config(case["arch"], case.get("attn", "softmax"))
    placement = P.Placement(cfg, mesh)
    params = from_jax_params(case["params"], cfg, "cpu")
    return cfg, placement, placement.place(params), \
        (params if whole else None)


def _rows(case, key, mesh):
    return P.shard_batch({"t": torch.as_tensor(case[key])}, mesh)["t"]


def _enc_out(case, cfg, params, mesh=None, placement=None):
    """The encoder's output of the case's frames (None without frames):
    placed when a placement is given."""
    if "frames" not in case:
        return None
    frames = _rows(case, "frames", mesh)
    if placement is None:
        return encode(params, frames, cfg)
    with C._placed(placement, mesh):
        return encode(params, frames, cfg)


def _serve(case, mesh):
    """lm_prefill (with the case's kv_mask, if any) then greedy
    lm_decode_steps on the placed model: the logits gathered whole over
    the vocab and "data", the greedy tokens; without a kv_mask also the
    tokens of the placed prefill and serve steps; with the case's "spy"
    what the layers held and saw throughout (`C.tp_spy`)."""
    cfg, placement, params, _ = _setup(case, mesh)
    tokens = _rows(case, "tokens", mesh)
    mask = _rows(case, "kv_mask", mesh) if "kv_mask" in case else None
    b, plen = tokens.shape
    spy = C.tp_spy() if case.get("spy") else C.contextlib.nullcontext()
    with torch.no_grad(), spy as seen:
        enc = _enc_out(case, cfg, params, mesh, placement)
        dec = params["decoder"] if cfg.encoder_layers else params
        with use_mesh(mesh):
            st = init_decode_state(cfg, b, case["max_len"], device="cpu")
        logits = []
        with C._placed(placement, mesh):
            lg, st = lm_prefill(dec, tokens, cfg, st, kv_mask=mask,
                                enc_out=enc)
            lg = P.gather_vocab(lg, cfg.vocab_size)
            logits.append(lg)
            tok = lg[:, -1].argmax(-1)
            toks = [tok]
            for i in range(case["n_dec"]):
                lg, st = lm_decode_step(dec, st, tok, cfg, position=plen + i,
                                        enc_out=enc)
                lg = P.gather_vocab(lg, cfg.vocab_size)
                logits.append(lg)
                tok = lg.argmax(-1)
                toks.append(tok)
        out = {"prefill": C._rows(logits[0], mesh).numpy(),
               "decode": [C._rows(x, mesh).numpy() for x in logits[1:]],
               "greedy": C._rows(torch.stack(toks, 1), mesh).numpy()}
        if mask is None:
            with use_mesh(mesh):
                st = init_decode_state(cfg, b, case["max_len"],
                                       device="cpu")
            prefill, serve = (make_prefill_step(cfg, mesh=mesh),
                              make_serve_step(cfg, mesh=mesh))
            tok, st = prefill(params, st, tokens, enc)
            toks = [tok]
            for i in range(case["n_dec"]):
                tok, st = serve(params, st, tok, plen + i, enc)
                toks.append(tok)
            out["tokens"] = C._rows(torch.stack(toks, 1), mesh).numpy()
    if seen is not None:
        out["seen"] = seen
    return out


def _against_one(case, mesh, run):
    """run(params, cfg, state, scope) -> [logits] on the placed model and
    on the whole model in one process, both on the rank's rows:
    {"placed": [...], "one": [...]}, gathered."""
    cfg, placement, placed, whole = _setup(case, mesh, whole=True)
    b = _rows(case, "tokens", mesh).shape[0]
    with torch.no_grad():
        with use_mesh(mesh):
            st = init_decode_state(cfg, b, case["max_len"], device="cpu")
        got = run(placed, cfg, st, lambda: C._placed(placement, mesh))
        want = run(whole, cfg, init_decode_state(cfg, b, case["max_len"],
                                                 device="cpu"),
                   C.contextlib.nullcontext)

    def gathered(xs):
        return [C._rows(P.gather_vocab(x, cfg.vocab_size) if x.shape[-1]
                        != cfg.vocab_size else x, mesh).numpy()
                for x in xs]

    with C._placed(placement, mesh):
        return {"placed": gathered(got), "one": gathered(want)}


def _resume(case, mesh):
    """A prefill of the prompt's first `split` tokens, a resumed
    (`offset=`) prefill of the rest, then greedy decode steps."""
    tokens = _rows(case, "tokens", mesh)
    split, plen = case["split"], tokens.shape[1]

    def run(params, cfg, st, scope):
        out = []
        with scope():
            lg, st = lm_prefill(params, tokens[:, :split], cfg, st)
            out.append(lg)
            lg, st = lm_prefill(params, tokens[:, split:], cfg, st,
                                offset=split)
            out.append(lg)
            tok = P.gather_vocab(lg, cfg.vocab_size)[:, -1].argmax(-1) \
                if P.active() else lg[:, -1].argmax(-1)
            for i in range(case["n_dec"]):
                lg, st = lm_decode_step(params, st, tok, cfg,
                                        position=plen + i)
                out.append(lg)
                tok = (P.gather_vocab(lg, cfg.vocab_size) if P.active()
                       else lg).argmax(-1)
        return out

    return _against_one(case, mesh, run)


def _lanes(case, mesh):
    """A [B] cursor lane (`serve.slots.to_slotted`): a right-padded
    prefill leaves each row at its own length, and each decode step
    writes each row at its own cursor."""
    tokens = _rows(case, "tokens", mesh)
    valid = _rows(case, "valid", mesh)
    mask = (torch.arange(tokens.shape[1])[None] < valid[:, None]).to(
        torch.float64)

    def run(params, cfg, st, scope):
        st = to_slotted(st)
        out = []
        with scope():
            lg, st = lm_prefill(params, tokens, cfg, st, kv_mask=mask)
            out.append(lg)
            lg = P.gather_vocab(lg, cfg.vocab_size) if P.active() else lg
            tok = lg[torch.arange(len(valid)), valid.long() - 1].argmax(-1)
            pos = valid.clone()
            for _ in range(case["n_dec"]):
                lg, st = lm_decode_step(params, st, tok, cfg, position=pos)
                out.append(lg)
                tok = (P.gather_vocab(lg, cfg.vocab_size) if P.active()
                       else lg).argmax(-1)
                pos = pos + 1
        return out

    return _against_one(case, mesh, run)


def _uniform(case, mesh):
    """The attention state alone, 4 q heads on `case["hkv"]` kv heads: a
    prefill of the whole cache whose kv_mask leaves batch row 0 no valid
    key, a step (its cursor clamped to the last row, whose mask stays
    0), then a resumed prefill over a fresh cache whose chunks leave row
    0 no valid key either; o on the mesh and on one process's whole
    cache, and row 0's uniform average over the cache's values."""
    spec = AttentionSpec.parse("softmax")
    hkv, n, d = case["hkv"], case["max_len"], 8
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    q, k, v = rnd(2, 4, n, d), rnd(2, hkv, n, d), rnd(2, hkv, n, d)
    qt, kt, vt = rnd(2, 4, 1, d), rnd(2, hkv, 1, d), rnd(2, hkv, 1, d)
    mask = (rnd(2, n) > -0.5).to(torch.float64)
    mask[0] = 0.0
    half = n // 2

    def run():
        out = {}
        st = A.init_state(spec, batch=2, n_kv_heads=hkv, q_head_dim=d,
                          v_head_dim=d, max_len=n, dtype=torch.float64)
        A.prefill(q, k, v, spec, state=st, kv_mask=mask)
        out["step"] = A.step(st, qt, kt, vt, spec)[0]
        st = A.init_state(spec, batch=2, n_kv_heads=hkv, q_head_dim=d,
                          v_head_dim=d, max_len=n, dtype=torch.float64)
        A.prefill(q[:, :, :half], k[:, :, :half], v[:, :, :half], spec,
                  state=st, kv_mask=mask[:, :half])
        out["resumed"] = A.prefill(q[:, :, half:], k[:, :, half:],
                                   v[:, :, half:], spec, state=st,
                                   kv_mask=mask[:, half:], offset=half)[0]
        out["type"] = type(st.kv).__name__
        return out

    with use_mesh(mesh):
        got = run()
    want = run()
    # the step overwrote the last row (the clamped cursor) with its token
    vals = torch.cat([v[:1, :, :-1], vt[:1]], dim=2)
    avg = vals.mean(dim=2, keepdim=True).repeat_interleave(4 // hkv, 1)
    return {"placed": {k_: x.numpy() for k_, x in got.items()
                       if k_ != "type"},
            "one": {k_: x.numpy() for k_, x in want.items()
                    if k_ != "type"},
            "type": got["type"], "uniform_step_row0": avg.numpy()}


def _refusals(case, mesh):
    """A state that is not the rank's block raises: the whole cache under
    the mesh, and the mesh's block without it."""
    spec = AttentionSpec.parse("softmax")
    hkv, n = case["hkv"], case["max_len"]
    x = torch.zeros(2, 4, 1, 8, dtype=torch.float64)
    kv = torch.zeros(2, hkv, 1, 8, dtype=torch.float64)

    def init():
        return A.init_state(spec, batch=2, n_kv_heads=hkv, q_head_dim=8,
                            v_head_dim=8, max_len=n, dtype=torch.float64)

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
    return {"raised": raised, "types": [type(whole.kv).__name__,
                                        type(block.kv).__name__]}


KINDS = {"state": _state, "serve": _serve, "resume": _resume,
         "lanes": _lanes, "uniform": _uniform, "refusals": _refusals,
         "moments": HC._state}


def kv_cases(rank, world, shape, cases):
    """Each case on the (data, model) mesh of `shape`; rank 0 returns
    {name: results}."""
    del world
    C.lift_islands()
    mesh = make_test_mesh(shape, ("data", "model"))
    out = {case["name"]: KINDS[case["kind"]](case, mesh) for case in cases}
    return out if rank == 0 else None

