"""The port's kernel plans (`repro_torch.kernels.sharded`) on gloo worlds
of 2 and 4 ranks against the JAX reference's SINGLE-device kernel ops.

The reference's own sharded tests need 8 XLA devices; they establish that
its sharded calls equal its single-device ones. So the port's gathered
results are held against `repro.kernels.ops` (interpret mode, float64) at
1e-10 of scale: heads, feature and seq modes, p in {1, 2}, GQA and MQA,
forward and backward, ring and allgather, prefill and 32 lockstep decode
steps; the hybrid kernel in heads and feature modes and the feature
mode's noncausal branch at p = 2. The routing cases run `attention()` and
`prefill`/`step` under `use_mesh` in the model's layout and count the
sharded wrappers' calls; under a mesh that neither the kv heads nor Dv
divide they count the single-device kernel wrappers' calls on the whole
heads.

Each world is one test: its ranks are spawned once (they import torch
only, `tests/torch_rank_cases.py`) while the parent computes the JAX
references its cases need, then every case's results are checked and
every failure is reported together.
"""
import jax

jax.config.update("jax_enable_x64", True)

import functools  # noqa: E402
import threading  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_rank_cases  # noqa: E402
from repro.kernels import ops as J  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from torch_threads import share_cores  # noqa: F401,E402

TOL = 1e-10
B, HQ, N, D, DV, CS, STEPS, WINDOW = 2, 4, 32, 4, 8, 8, 32, 4

TP = ((1, 2), ("data", "model"))
DP = ((2, 1), ("data", "model"))
CP2 = ((1, 2), ("data", "seq"))
TP4 = ((2, 2), ("data", "model"))
CP4x2 = ((2, 2), ("data", "seq"))
CP4 = ((1, 4), ("data", "seq"))

OUTPUTS = {"train": ("o", "dq", "dk", "dv"), "hybrid": ("o", "dq", "dk",
                                                        "dv"),
           "serve": ("o", "state", "decode_o", "decode_state")}


def _inputs(hkv, p, dv=DV):
    rng = np.random.default_rng(100 * hkv + p)

    def r(*shape, scale=1.0):
        return rng.standard_normal(shape) * scale

    s = 1 / np.sqrt(D)
    return dict(q=r(B, HQ, N, D, scale=s), k=r(B, hkv, N, D, scale=s),
                v=r(B, hkv, N, dv), do=r(B, HQ, N, dv),
                qs=r(STEPS, B, HQ, 1, D, scale=s),
                ks=r(STEPS, B, hkv, 1, D, scale=s), vs=r(STEPS, B, hkv, 1, dv))


# (name, kind, mesh, hkv, p, extra, mode): GQA hkv = 2 takes heads plans,
# MQA hkv = 1 feature plans on a "model" axis of 2, and MQA at an odd Dv
# no plan (mode None: the whole heads on every rank)
def _cases(world):
    out = []
    if world == 2:
        for p in (1, 2):
            for kind in ("train", "serve"):
                out.append((f"heads-{kind}-p{p}", kind, TP, 2, p, {},
                            "heads"))
                out.append((f"feature-{kind}-p{p}", kind, TP, 1, p, {},
                            "feature"))
                out.append((f"dp-{kind}-p{p}", kind, DP, 2, p, {}, "heads"))
            for impl in ("ring", "allgather"):
                out.append((f"seq-{impl}-p{p}", "train", CP2, 2, p,
                            {"impl": impl}, "seq"))
    else:
        # p = 1 runs the seq plan on the world of two
        for impl in ("ring", "allgather"):
            out.append((f"seq4-{impl}-p2", "train", CP4, 2, 2,
                        {"impl": impl}, "seq"))
    if world == 2:
        out += [("heads-hybrid-p2", "hybrid", TP, 2, 2, {}, "heads"),
                ("feature-hybrid-p2", "hybrid", TP, 1, 2, {}, "feature"),
                ("feature-noncausal-p2", "train", TP, 1, 2,
                 {"causal": False}, "feature"),
                ("route-heads-p2", "route", TP, 2, 2, {}, "heads"),
                ("route-feature-p2", "route", TP, 1, 2, {}, "feature"),
                ("route-seq-p2", "route", CP2, 2, 2, {}, "seq"),
                ("route-whole-p2", "route", TP, 1, 2,
                 {"dv": DV - 1, "hybrid": True}, None)]
    else:
        out += [("heads4-train-p2", "train", TP4, 2, 2, {}, "heads"),
                ("heads4-serve-p2", "serve", TP4, 2, 2, {}, "heads"),
                ("feature4-train-p2", "train", TP4, 1, 2, {}, "feature"),
                ("feature4-serve-p2", "serve", TP4, 1, 2, {}, "feature"),
                ("seq4x2-train-p2", "train", CP4x2, 2, 2, {}, "seq")]
    return out


@functools.lru_cache(maxsize=None)
def _jref(kind, hkv, p, causal=True):
    """The JAX single-device kernel ops' results on `_inputs(hkv, p)`
    (once per process: the two worlds share keys)."""
    x = {n: jnp.asarray(a) for n, a in _inputs(hkv, p).items()}
    if kind in ("train", "hybrid"):
        def f(q, k, v):
            if kind == "hybrid":
                return J.hybrid(q, k, v, p=p, window=WINDOW, causal=True,
                                chunk_size=CS, denom_eps=1e-6)
            return J.fastmax(q, k, v, p=p, causal=causal, chunk_size=CS,
                             denom_eps=1e-6)

        def fwd_bwd(q, k, v, do):
            o, vjp = jax.vjp(f, q, k, v)
            return (o,) + vjp(do)

        # the causal op runs eagerly (its first jit costs more than it
        # saves); the noncausal and hybrid ones jitted
        run = fwd_bwd if kind == "train" and causal else jax.jit(fwd_bwd)
        out = dict(zip(OUTPUTS["train"], run(x["q"], x["k"], x["v"],
                                             x["do"])))
    else:
        o, st = J.fastmax_prefill_kernel(x["q"], x["k"], x["v"], p=p,
                                         chunk_size=CS, denom_eps=1e-6)
        out = dict(o=o, state=list(st))
        step = jax.jit(lambda q, k, v, s: J.fastmax_decode(
            q, k, v, s, p=p, denom_eps=1e-6))
        st, outs = tuple(st), []
        for i in range(STEPS):
            o1, st = step(x["qs"][i], x["ks"][i], x["vs"][i], st)
            outs.append(o1)
        out["decode_o"] = jnp.stack(outs)
        out["decode_state"] = list(st)
    return {n: ([np.asarray(a) for a in v] if isinstance(v, list)
                else np.asarray(v)) for n, v in out.items()}


def _run(world, tmp_path):
    """The world's results (its ranks spawned in the background) and the
    JAX references of its cases, computed meanwhile."""
    cases = _cases(world)
    runs = {}

    def spawn():
        runs["out"] = run_ranks(
            torch_rank_cases.sharded_cases, world,
            args=([dict(name=n, kind=k, shape=m[0], axes=m[1], p=p, cs=CS,
                        window=WINDOW,
                        inputs=_inputs(hkv, p, extra.get("dv", DV)),
                        **extra)
                   for n, k, m, hkv, p, extra, _ in cases],),
            workdir=tmp_path, timeout=300)[0]

    thread = threading.Thread(target=spawn)
    thread.start()
    keys = {(k, hkv, p, extra.get("causal", True))
            for _, k, _, hkv, p, extra, _ in cases if k != "route"}
    refs = {key: _jref(*key) for key in sorted(keys)}
    thread.join()
    assert "out" in runs, "a rank failed (see its traceback above)"
    return cases, runs["out"], refs


def _err(got, ref):
    """max |got - ref| over max(1, max |ref|), over a list of leaves too."""
    pairs = zip(got, ref) if isinstance(ref, list) else [(got, ref)]
    worst = 0.0
    for g, r in pairs:
        g, r = np.asarray(g), np.asarray(r)
        if g.shape != r.shape:
            return float("inf")
        worst = max(worst, float(np.max(np.abs(g - r)))
                    / max(1.0, float(np.max(np.abs(r)))))
    return worst


def _check_world(world, tmp_path):
    cases, res, refs = _run(world, tmp_path)
    bad = []
    for name, kind, _, hkv, p, extra, mode in cases:
        got = res[name]
        if kind == "route":
            continue
        if got["mode"] != mode:
            bad.append(f"{name}: mode {got['mode']}, expected {mode}")
        ref = refs[(kind, hkv, p, extra.get("causal", True))]
        for out in OUTPUTS[kind]:
            e = _err(got[out], ref[out])
            if not e <= TOL:
                bad.append(f"{name}/{out}: {e:.3e} of scale")
    # the two exchanges differ in the order of summation only
    tag, ps = ("seq", (1, 2)) if world == 2 else ("seq4", (2,))
    for p in ps:
        a, b = res[f"{tag}-ring-p{p}"], res[f"{tag}-allgather-p{p}"]
        for n in OUTPUTS["train"]:
            if not np.allclose(a[n], b[n], rtol=1e-12, atol=1e-12):
                bad.append(f"{tag} p={p}: ring and allgather differ in {n}")
    return res, bad


def _route_errors(name, r, dv):
    """What a routing case's results get wrong: attention() (and, where
    run, the hybrid kernel's and prefill/step's) against the mesh-less
    calls."""
    bad = []
    pairs = [("attention()", r["attend"], r["attend_ref"])]
    if "hybrid" in r:
        pairs.append(("hybrid attention()", r["hybrid"], r["hybrid_ref"]))
    for what, got, ref in pairs:
        if got[0].shape != (B, HQ, N, dv):
            bad.append(f"{name}: {what} o of shape {got[0].shape}")
        for n, g, f in zip(OUTPUTS["train"], got, ref):
            if not _err(g, f) <= TOL:
                bad.append(f"{name}: {what} {n} differs")
    for i, (g, f) in enumerate(zip(r.get("serve", ()),
                                   r.get("serve_ref", ()))):
        if not _err(g, f) <= TOL:
            bad.append(f"{name}: serve output {i} differs")
    return bad


def test_world_of_two_ranks(tmp_path):
    """Heads, feature and DP-only heads plans on (1, 2) and (2, 1) meshes
    (prefill, 32 decode steps, forward and backward, p = 1 and 2), the
    hybrid kernel and the noncausal feature branch, seq mode on (1, 2)
    over the ring and allgather, all against the JAX single-device ops;
    then the routing: under use_mesh, attention() reaches fastmax_sharded
    once and gives the mesh-less call's o and grads (seq: gathered from
    the token shards); init_state allocates the plan's local moments,
    prefill and each step reach the sharded wrappers once, and the
    outputs equal the mesh-less protocol's. Under a "model" axis that
    neither the one kv head nor an odd Dv divides, no sharded wrapper is
    called: attention() (fastmax and hybrid), prefill and each step call
    the single-device kernel wrappers once on the whole heads, and the
    moments are whole."""
    res, bad = _check_world(2, tmp_path)
    for mode in ("heads", "feature", "seq"):
        r = res[f"route-{mode}-p2"]
        bad += _route_errors(f"route {mode}", r, DV)
        if r["counts"]["fastmax_sharded"] != 1:
            bad.append(f"route {mode}: {r['counts']} fastmax_sharded calls")
        if mode == "seq":
            continue
        c = r["serve_counts"]
        if (c["fastmax_prefill_sharded"],
                c["fastmax_decode_sharded"]) != (1, STEPS):
            bad.append(f"route {mode}: {c} prefill/decode calls")
        hkv = 2 if mode == "heads" else 1
        local, whole = r["state_shapes"], r["state_shapes_ref"]
        # m0: the rank's kv head, or its half of Dv; g0 whole in feature
        want = ([(B, 1, DV), (B, 1)] if mode == "heads"
                else [(B, hkv, DV // 2), (B, hkv)])
        if [local[0], local[3]] != want or whole[0] != (B, hkv, DV):
            bad.append(f"route {mode}: state shapes {local} / {whole}")
    r, dv = res["route-whole-p2"], DV - 1
    bad += _route_errors("route whole", r, dv)
    counts = {**r["counts"], **{"h_" + n: c for n, c in
                                r["hybrid_counts"].items()},
              **{"s_" + n: c for n, c in r["serve_counts"].items()}}
    # the trainable op's forward is the prefill wrapper (one kernel
    # launch on the card, its carry the backward's residual)
    want = {"fastmax": 1, "fastmax_prefill_kernel": 1, "h_hybrid": 1,
            "s_fastmax_prefill_kernel": 1, "s_fastmax_decode": STEPS}
    got = {n: c for n, c in counts.items() if c}
    if got != want:
        bad.append(f"route whole: wrapper calls {got}, expected {want}")
    if r["state_shapes"] != r["state_shapes_ref"] or \
            r["state_shapes"][0] != (B, 1, dv):
        bad.append(f"route whole: state shapes {r['state_shapes']}")
    assert not bad, "\n".join(bad)


def test_world_of_four_ranks(tmp_path):
    """Heads and feature plans on a (data 2, model 2) mesh (the batch
    over "data"), seq mode on (data 2, seq 2) and on (1, 4) over the ring
    (three hops) and the allgather, p = 2 (the world of two runs p = 1),
    against the JAX single-device ops."""
    _, bad = _check_world(4, tmp_path)
    assert not bad, "\n".join(bad)
