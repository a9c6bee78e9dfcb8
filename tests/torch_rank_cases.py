"""Rank bodies of the port's multi-process tests.

`repro_torch.launch.ranks.run_ranks` spawns the ranks, which import this
module by name: it imports torch and the port only, never JAX (the parent
test computes the JAX references and hands the ranks numpy). Each body
runs a list of cases on meshes of the ranks' gloo group and returns, on
rank 0, numpy results gathered back to global tensors.
"""
import collections
import os

import numpy as np
import torch

from repro_torch import attention as A
from repro_torch.kernels import ops as K
from repro_torch.kernels import sharded as S
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.sharding.rules import use_mesh

EPS = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _glob(t, spec, mesh):
    return S.gather_global(t.detach().contiguous(), spec, mesh).cpu().numpy()


def _plan(mesh, q, k, v, seq: bool):
    return S.plan_kernel_sharding(mesh, batch=q.shape[0], hq=q.shape[1],
                                  hkv=k.shape[1], dv=v.shape[-1],
                                  seq_len=q.shape[2] if seq else None)


def _train(case, mesh, x):
    """fastmax_sharded / hybrid_sharded forward and backward."""
    q, k, v = x["q"], x["k"], x["v"]
    causal = case.get("causal", True)
    plan = _plan(mesh, q, k, v, seq=causal and case["kind"] == "train")
    sp = S.plan_specs(plan)
    ql, kl, vl = (S.shard_local(x[n], sp[n], mesh).requires_grad_(True)
                  for n in "qkv")
    kw = dict(p=case["p"], chunk_size=case["cs"], denom_eps=EPS, plan=plan)
    if case["kind"] == "hybrid":
        o = S.hybrid_sharded(ql, kl, vl, window=case["window"], **kw)
    else:
        o = S.fastmax_sharded(ql, kl, vl, causal=causal, **kw)
    o.backward(S.shard_local(x["do"], sp["o"], mesh))
    return dict(mode=plan.mode, o=_glob(o, sp["o"], mesh),
                dq=_glob(ql.grad, sp["q"], mesh),
                dk=_glob(kl.grad, sp["k"], mesh),
                dv=_glob(vl.grad, sp["v"], mesh))


def _serve(case, mesh, x):
    """fastmax_prefill_sharded, then decode steps in lockstep."""
    q, k, v = x["q"], x["k"], x["v"]
    plan = _plan(mesh, q, k, v, seq=False)
    sp = S.plan_specs(plan)
    kw = dict(p=case["p"], denom_eps=EPS, plan=plan)
    o, st = S.fastmax_prefill_sharded(
        *(S.shard_local(x[n], sp[n], mesh) for n in "qkv"),
        chunk_size=case["cs"], **kw)
    res = dict(mode=plan.mode, o=_glob(o, sp["o"], mesh),
               state=[_glob(a, s, mesh) for a, s in zip(st, sp["moments"])])
    st, outs = tuple(st), []
    for i in range(x["qs"].shape[0]):
        o1, st = S.fastmax_decode_sharded(
            *(S.shard_local(x[n + "s"][i], sp[n], mesh) for n in "qkv"),
            st, **kw)
        outs.append(_glob(o1, sp["o"], mesh))
    res["decode_o"] = np.stack(outs)
    res["decode_state"] = [_glob(a, s, mesh)
                           for a, s in zip(st, sp["moments"])]
    return res


# calls of the kernels' single-device wrappers in this rank (on the CPU
# they run their plain versions; on the card each launches its kernel)
KERNEL_WRAPPERS = ("fastmax", "hybrid", "fastmax_prefill_kernel",
                   "fastmax_decode")
kernel_calls: collections.Counter = collections.Counter()


def _count_kernel_calls():
    """Wrap `KERNEL_WRAPPERS` in `repro_torch.kernels.ops` (once per
    rank) so that each call adds one to `kernel_calls`."""
    for name in KERNEL_WRAPPERS:
        fn = getattr(K, name)
        if getattr(fn, "_counted", False):
            continue

        def counted(*a, _fn=fn, _name=name, **kw):
            kernel_calls[_name] += 1
            return _fn(*a, **kw)

        counted._counted = True
        setattr(K, name, counted)


def _calls_during(fn):
    """fn()'s result and the sharded and single-device wrappers' calls
    it made, and its kernel launches ("launch:" + kernel; none on the
    CPU)."""
    s0, k0, l0 = dict(S.calls), dict(kernel_calls), K.launch_counts()
    out = fn()
    return out, {**{n: S.calls[n] - s0.get(n, 0) for n in S.calls},
                 **{n: kernel_calls[n] - k0.get(n, 0)
                    for n in KERNEL_WRAPPERS},
                 **{"launch:" + n: c - l0.get(n, 0)
                    for n, c in K.launch_counts().items()}}


def _route(case, mesh, x):
    """attention() and prefill/step under use_mesh against the same calls
    with no mesh, in the model's layout; the sharded wrappers' and the
    single-device kernel wrappers' calls counted. With `hybrid`, the
    hybrid kernel backend's attention() too."""
    _count_kernel_calls()
    spec = A.AttentionSpec.parse("fastmax2-kernel", p=case["p"],
                                 chunk_size=case["cs"])
    seq = "seq" in case["axes"]
    tok = S.Spec(None, None, "seq", None)

    def attend(active, spec=spec):
        """o and the grads of q, k, v, global; under the seq mesh each
        rank holds its token shard (the model's layout there)."""
        q, k, v, do = (x[n] for n in ("q", "k", "v", "do"))
        if active and seq:
            q, k, v, do = (S.shard_local(t, tok, mesh)
                           for t in (q, k, v, do))
        a, b, c = (t.clone().requires_grad_(True) for t in (q, k, v))
        with use_mesh(mesh if active else None):
            o = A.attention(a, b, c, spec, causal=True)
            o.backward(do)
        out = [o, a.grad, b.grad, c.grad]
        if active and seq:
            return [_glob(t, tok, mesh) for t in out]
        return [t.detach().cpu().numpy() for t in out]

    res = {}
    res["attend"], res["counts"] = _calls_during(lambda: attend(True))
    res["attend_ref"] = attend(False)
    if case.get("hybrid"):
        hspec = A.AttentionSpec.parse("hybrid2-kernel", p=case["p"],
                                      chunk_size=case["cs"],
                                      window=case["window"])
        res["hybrid"], res["hybrid_counts"] = _calls_during(
            lambda: attend(True, hspec))
        res["hybrid_ref"] = attend(False, hspec)
    if seq:
        return res
    b, hkv, d, dv = x["k"].shape[0], x["k"].shape[1], x["q"].shape[-1], \
        x["v"].shape[-1]

    def serve(active):
        outs = []
        with use_mesh(mesh if active else None):
            st = A.init_state(spec, batch=b, n_kv_heads=hkv, q_head_dim=d,
                              v_head_dim=dv, max_len=64,
                              dtype=x["q"].dtype, device=x["q"].device)
            o, st = A.prefill(x["q"], x["k"], x["v"], spec, state=st)
            outs.append(o)
            for i in range(x["qs"].shape[0]):
                o, st = A.step(st, x["qs"][i], x["ks"][i], x["vs"][i], spec)
                outs.append(o)
        return [t.cpu().numpy() for t in outs], [tuple(t.shape)
                                                 for t in st.moments]

    (res["serve"], res["state_shapes"]), res["serve_counts"] = \
        _calls_during(lambda: serve(True))
    res["serve_ref"], res["state_shapes_ref"] = serve(False)
    return res


KINDS = {"train": _train, "hybrid": _train, "serve": _serve,
         "route": _route}


def sharded_cases(rank, world, cases):
    """Run each case ({"name", "kind", "shape", "axes", "inputs", ...})
    on its mesh; rank 0 returns {name: results}."""
    del world
    out = {}
    meshes = {}
    for case in cases:
        os.environ["REPRO_CP_EXCHANGE"] = case.get("impl", "auto")
        key = (tuple(case["shape"]), tuple(case["axes"]))
        if key not in meshes:
            meshes[key] = make_test_mesh(*key)
        dev = case.get("device", "cpu")
        if dev != "cpu":
            torch.cuda.set_device(0)     # the ranks share one card
            torch.backends.cuda.matmul.allow_tf32 = False
        x = {n: _t(a).to(dev) for n, a in case["inputs"].items()}
        out[case["name"]] = KINDS[case["kind"]](case, meshes[key], x)
    return out if rank == 0 else None


def cp_train(rank, world, argv_runs, grad_args):
    """`launch.train.main(argv)` for each argv of `argv_runs` (returns
    their losses), then, with `grad_args` (cfg overrides, seed, batch),
    one context-parallel loss and grad on a (data, seq) mesh: rank 0
    returns them."""
    from repro_torch.launch import train

    losses = [train.main(argv)[1] for argv in argv_runs]
    grads = None
    if grad_args is not None:
        grads = cp_grads(grad_args)
    return (losses, grads) if rank == 0 else None


def cp_grads(grad_args):
    """(loss, {path: grad}) of the smoke model's CP grad fn: the placed
    step on a (data, seq) mesh, its grads gathered whole. `grad_args`:
    "arch", "attn" (None: the config's own), "cp", "batch"."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.models import init_model
    from repro_torch.optim.grad_utils import leaves
    from repro_torch.sharding import placed

    cfg = get_smoke_config(grad_args["arch"])
    if grad_args.get("attn"):
        cfg = dataclasses.replace(
            cfg, attn=A.AttentionSpec.parse(grad_args["attn"]))
    mesh = None
    params = init_model(cfg, seed=0, device="cpu")
    batch = grad_args["batch"]
    if grad_args["cp"] > 1:
        world = torch.distributed.get_world_size()
        mesh = make_test_mesh((world // grad_args["cp"], grad_args["cp"]),
                              ("data", "seq"))
        params = placed.Placement(cfg, mesh).place(params)
        batch = placed.shard_batch(batch, mesh)
    loss, metrics, grads = make_grad_fn(cfg, mesh=mesh)(params, batch)
    if mesh is not None:
        grads = placed.full(grads, mesh)
    return float(loss), {n: g.numpy() for n, g in leaves(grads)}


def _model_split_pair():
    """`placed.cp_enter` / `cp_exit` with the "model" split's backward
    over "seq" (`GatherModel` keeps the slice's grad, `SliceModel`
    gathers the slices' grads): the wrong pair for a layer computed whole
    on every seq rank."""
    from repro_torch.sharding import placed

    def args():
        pl = placed.active()
        return (1, pl.mesh.get_group("seq"), pl.mesh.get_local_rank("seq"),
                pl.sizes["seq"])

    def enter(x):
        return x if placed.cp_size() == 1 else placed.GatherModel.apply(
            x, *args())

    def exit_(y):
        return y if placed.cp_size() == 1 else placed.SliceModel.apply(
            y, *args())

    return enter, exit_


# the token counts of the hybrid kernel wrapper's calls in this rank
hybrid_tokens: list = []


def cp_mixers(rank, world, cases):
    """Each case ({"name", "grad_args"} and "model_backward": the
    entry/exit pair with the "model" split's backward) through `cp_grads`
    on a (world / cp, cp) mesh, with the sharded and single-device kernel
    wrappers' calls it made and the token count of each hybrid kernel
    wrapper call; rank 0 returns {name: (loss, grads, calls, tokens)}."""
    from repro_torch.sharding import placed

    del world
    _count_kernel_calls()
    hybrid = K.hybrid
    if not getattr(hybrid, "_tokens", False):
        def tokens(q, *a, _fn=hybrid, **kw):
            hybrid_tokens.append(q.shape[2])
            return _fn(q, *a, **kw)

        tokens._tokens = True
        K.hybrid = tokens
    out = {}
    for case in cases:
        pair = placed.cp_enter, placed.cp_exit
        if case.get("model_backward"):
            placed.cp_enter, placed.cp_exit = _model_split_pair()
        del hybrid_tokens[:]
        try:
            res, counts = _calls_during(
                lambda: cp_grads(case["grad_args"]))
        finally:
            placed.cp_enter, placed.cp_exit = pair
        out[case["name"]] = (*res, counts, list(hybrid_tokens))
    return out if rank == 0 else None
