"""The port's dry run (`launch/dryrun.py`, `op_analysis.py`, `perfprobe.py`)
held to the reference's on the CPU.

- The shape table and the architecture lists equal the reference's.
- Parameter counts, bytes, active parameters and model flops equal, for
  all ten configs at all five shapes, the reference dry run's formula
  (`repro/launch/dryrun.py`, the lines after `# MODEL_FLOPS`) on its
  `init_model(abstract=True)` tree and axes: exactly.
- The planned bytes per device (parameters, optimizer state, batch,
  decode state) equal, exactly, the sums of the reference's
  `NamedSharding(...).shard_shape` on a `jax.sharding.AbstractMesh` (no
  devices, no compile) on the one-pod, two-pod and a cp mesh.
- The counted matmul flops of the smoke qwen3-1.7b softmax train,
  prefill and decode steps equal the reference's `analyze_hlo` of its
  compiled step, exactly; `fastmax2`'s chunked scans contract in other
  orders (stated below).
- The kernels' meta route: meta outputs of the CUDA route's shapes and
  dtypes, no plain version and no launch, the launch's work recorded,
  the CUDA call's workspace counted in the peak, no value to read.
- MoE on meta dispatches the balanced load; its ratio to the reference's
  static capacity is stated. On a fake world of (data 4, model 2) the
  rank's routed experts take half the flops of one device on its rows.
- On a fake world of (data 2, model 2) the placed train step's
  checkpointed residual is the rank's slice of the sequence.
- On a fake world of 4 ranks (data 2, seq 2) the placed context-parallel
  step's collectives: the FSDP gathers and reduce-scatters over "data",
  the all-reduces over "seq", one carry exchange of `cp_carry_bytes` per
  kernel launch.
- The CLI, the gate, one MoE cell and the probe.
- The placed step's argument bytes equal the planned ones, part by part,
  in each config's cheapest cell and every shape of qwen3-1.7b and
  granite-20b, on one pod and two (the SSM layers' decode state held
  whole over "model", ROADMAP queue 3).
"""
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro import configs as jconfigs
from repro.attention import AttentionSpec as JSpec
from repro.kernels.sharded import cp_boundary_model as jcp_boundary_model
from repro.launch import steps as jsteps
from repro.launch.hlo_analysis import analyze_hlo
from repro.models.model import decode_state_specs as jdecode_state_specs
from repro.models.model import init_model as jinit_model
from repro.models.model import input_specs as jinput_specs
from repro.sharding import rules as JR
from repro_torch import configs
from repro_torch.attention import AttentionSpec
from repro_torch.configs import SHAPES, ShapeSpec, get_config, \
    get_smoke_config
from repro_torch.kernels import fastmax_causal as FC
from repro_torch.kernels import fastmax_causal_bwd as FB
from repro_torch.kernels import fastmax_noncausal as FN
from repro_torch.kernels import hybrid_causal as HC
from repro_torch.kernels import ops
from repro_torch.kernels import work as W
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.op_analysis import OpCount, tree_bytes
from repro_torch.models import init_model
from repro_torch.models import moe as MOE
from repro_torch.sharding import rules as R
from torch_threads import share_cores  # noqa: F401,E402

ROOT = Path(__file__).resolve().parents[1]
FN_REF = FN.fastmax_noncausal_ref
ARCHS = sorted(configs.ARCH_IDS)
# (axis names, shape): one pod, two pods, context parallel (train_1M
# --cp 16's mesh)
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16)),
          "cp16": (("data", "seq"), (16, 16))}


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return jinit_model(jax.random.PRNGKey(0), jconfigs.get_config(arch),
                       abstract=True)


@functools.lru_cache(maxsize=None)
def _params(arch):
    return init_model(get_config(arch), device="meta", with_axes=True)


def test_shapes_and_arch_lists_are_the_reference_s():
    assert {k: tuple(v) for k, v in SHAPES.items()} \
        == {k: tuple(v) for k, v in jconfigs.SHAPES.items()}
    assert list(SHAPES) == list(jconfigs.SHAPES)
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert configs.all_arch_ids() == jconfigs.all_arch_ids()
    assert ShapeSpec._fields == jconfigs.ShapeSpec._fields


def _reference_counts(arch, shape):
    """The reference dry run's formula (`dryrun.py`, `# MODEL_FLOPS`) on
    its abstract tree and axes."""
    cfg = jconfigs.get_config(arch)
    params_shapes, axes = _jparams(arch)
    flat = jax.tree_util.tree_flatten_with_path(params_shapes)[0]
    ax_flat = jax.tree.leaves(axes, is_leaf=lambda x: isinstance(x, tuple))
    total_p = routed_p = embed_p = 0
    for (path, leaf), ax in zip(flat, ax_flat):
        npx = 1
        for d in leaf.shape:
            npx *= int(d)
        total_p += npx
        if "experts" in ax:
            routed_p += npx
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "embed":
            embed_p += npx
    active_p = total_p - (0 if cfg.n_experts == 0 else
                          routed_p * (1.0 - cfg.moe_top_k / cfg.n_experts))
    if not cfg.tie_embeddings:
        active_p -= embed_p
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind != "decode" else shape.global_batch)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * active_p * tokens
    nbytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                 for x in jax.tree.leaves(params_shapes))
    return {"n_params": total_p, "param_bytes_global": nbytes,
            "active_params": float(active_p), "model_flops": model_flops}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_are_the_reference_s(arch):
    params, axes = _params(arch)
    got = D.param_counts(get_config(arch), params, axes)
    for name, shape in SHAPES.items():
        want = _reference_counts(arch, jconfigs.SHAPES[name])
        assert {**got, "model_flops": D.model_flops(got["active_params"],
                                                    shape)} == want, name


def _jshard_bytes(tree, shardings) -> int:
    leaves = jax.tree.leaves(tree)
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs)
    return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
               for x, s in zip(leaves, shs))


def _reference_planned(arch, shape, mesh):
    """Rank 0's bytes under the reference dry run's shardings (`run_cell`:
    params, `_opt_shardings`, the batch's and the decode state's)."""
    cfg = jconfigs.get_config(arch)
    params_shapes, axes = _jparams(arch)
    b, n = shape.global_batch, shape.seq_len
    param_sh = JR.param_shardings(axes, params_shapes, mesh)
    out = {"params": _jshard_bytes(params_shapes, param_sh), "opt_state": 0,
           "batch": 0, "decode_state": 0}
    bspec = JR.batch_spec(mesh, batch_size=b)
    if shape.kind == "train":
        n_params = sum(int(np.prod(x.shape))
                       for x in jax.tree.leaves(params_shapes))
        _, (opt_init, _) = jsteps.pick_optimizer(cfg, n_params)
        opt = jax.eval_shape(opt_init, params_shapes)
        out["opt_state"] = opt.step.dtype.itemsize + sum(
            _jshard_bytes(t, JR.param_shardings(axes, t, mesh))
            for t in (opt.m, opt.v, opt.master) if t is not None)
        batch = jinput_specs(cfg, global_batch=b, seq_len=n, kind="train")
        out["batch"] = _jshard_bytes(batch, jax.tree.map(
            lambda s: NamedSharding(
                mesh, P(*(list(bspec) + [None] * (len(s.shape) - 1)))),
            batch))
    else:
        state = jdecode_state_specs(cfg, b, n)
        out["decode_state"] = _jshard_bytes(
            state, JR.decode_state_shardings(state, mesh, batch=b))
        enc = ([jax.ShapeDtypeStruct((b, cfg.encoder_seq, cfg.d_model),
                                     cfg.adtype())]
               if cfg.encoder_layers else [])
        if shape.kind == "prefill":
            args = [jax.ShapeDtypeStruct((b, n), jnp.int32)] + enc
            sh = [NamedSharding(mesh, P(*(list(bspec) + [None])))]
            sh += [NamedSharding(mesh, P(*(list(bspec) + [None, None])))
                   ] * len(enc)
        else:
            args = [jax.ShapeDtypeStruct((b,), jnp.int32),
                    jax.ShapeDtypeStruct((), jnp.int32)] + enc
            lead = list(bspec) if b > 1 else [None]
            sh = [NamedSharding(mesh, P(*lead) if b > 1 else P(None)),
                  NamedSharding(mesh, P())]
            sh += [NamedSharding(mesh, P(*(lead + [None, None])))
                   ] * len(enc)
        out["batch"] = _jshard_bytes(args, sh)
    out["total"] = sum(out.values())
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_planned_bytes_are_the_reference_s(arch):
    """Every shape on the one-pod and two-pod meshes, the train shapes on
    the cp mesh (cp trades "model" for "seq")."""
    cfg = get_config(arch)
    params, axes = _params(arch)
    opts = {}
    for mname, (names, sizes) in MESHES.items():
        jmesh = AbstractMesh(sizes, names)
        mesh = dict(zip(names, sizes))
        for sname, shape in SHAPES.items():
            if mname == "cp16" and shape.kind != "train":
                continue
            if shape.kind == "train" and "opt" not in opts:
                from repro_torch.launch.steps import pick_optimizer

                _, opt = pick_optimizer(cfg, D.param_counts(
                    cfg, params, axes)["n_params"])
                opts["opt"] = opt[0](params)
            got = D.planned_bytes(cfg, shape, mesh, params, axes,
                                  opts.get("opt"))
            want = _reference_planned(arch, jconfigs.SHAPES[sname], jmesh)
            assert got == want, (mname, sname)


def test_cp_boundary_is_the_reference_s():
    cfg = get_config("qwen3-1.7b",
                     attn=AttentionSpec.parse("fastmax2-kernel"))
    shape = SHAPES["train_1M"]
    from repro_torch.kernels.sharded import cp_boundary_model

    got = cp_boundary_model(n=shape.seq_len, b=shape.global_batch,
                            hkv=cfg.n_kv_heads, d=cfg.head_dim,
                            dv=cfg.head_dim, p=cfg.attn.p, cp=16)
    want = jcp_boundary_model(n=shape.seq_len, b=shape.global_batch,
                              hkv=cfg.n_kv_heads, d=cfg.head_dim,
                              dv=cfg.head_dim, p=cfg.attn.p, cp=16)
    assert got == want


# ---------------------------------------------------------------------------
# matmul flops against analyze_hlo, smoke qwen3-1.7b on one device
# ---------------------------------------------------------------------------

SMOKE_B, SMOKE_N = 2, 64


@functools.lru_cache(maxsize=None)
def _reference_flops(attn: str, kind: str) -> float:
    cfg = jconfigs.get_smoke_config("qwen3-1.7b", attn=JSpec.parse(attn))
    params, _ = jinit_model(jax.random.PRNGKey(0), cfg, abstract=True)
    b, n = SMOKE_B, SMOKE_N
    if kind == "train":
        n_params = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
        _, opt = jsteps.pick_optimizer(cfg, n_params)
        opt_state = jax.eval_shape(opt[0], params)
        batch = jinput_specs(cfg, global_batch=b, seq_len=n, kind="train")
        lowered = jax.jit(jsteps.make_train_step(cfg, opt)).lower(
            params, opt_state, batch)
    else:
        state = jdecode_state_specs(cfg, b, n)
        if kind == "prefill":
            lowered = jax.jit(jsteps.make_prefill_step(cfg)).lower(
                params, state, jax.ShapeDtypeStruct((b, n), jnp.int32))
        else:
            lowered = jax.jit(jsteps.make_serve_step(cfg)).lower(
                params, state, jax.ShapeDtypeStruct((b,), jnp.int32),
                jax.ShapeDtypeStruct((), jnp.int32))
    return analyze_hlo(lowered.compile().as_text())["matmul_flops"]


def _port_count(attn: str, kind: str, device="meta") -> OpCount:
    cfg = get_smoke_config("qwen3-1.7b", attn=AttentionSpec.parse(attn))
    fn, args, _ = D.cell_step(cfg, ShapeSpec(SMOKE_N, SMOKE_B, kind),
                              device=device)
    with OpCount(torch.device(device).type) as count:
        fn(*args)
    return count


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_softmax_matmul_flops_are_analyze_hlo_s(kind):
    assert _port_count("softmax", kind).matmul_flops \
        == _reference_flops("softmax", kind)


def test_fastmax2_matmul_flops_ratio():
    """The chunked scans contract in different orders: the port's
    `_causal_scan` and §2.5 backward einsums against the reference's
    fused dots. Measured at B=2, N=64 (CPU, both counts exact): the port
    177,537,024, the reference 172,720,128, a ratio of 1.0279."""
    port = _port_count("fastmax2", "train").matmul_flops
    ref = _reference_flops("fastmax2", "train")
    assert (port, ref) == (177_537_024, 172_720_128)
    assert port / ref == pytest.approx(1.0279, abs=1e-4)


def test_kernel_route_train_counts():
    """On meta the kernel backend's train step records one prefill launch
    per layer and forward (remat full runs the forward twice) and one
    backward launch per layer, each with its work, and routes no plain
    attention."""
    count = _port_count("fastmax2-kernel", "train")
    cfg = get_smoke_config("qwen3-1.7b")
    assert count.launches() == {"fastmax_causal": 2 * cfg.n_layers,
                                "fastmax_causal_bwd": cfg.n_layers}
    fwd = W.prefill_work(SMOKE_B, cfg.n_heads, cfg.n_kv_heads, SMOKE_N,
                         cfg.head_dim, cfg.head_dim, 4)
    bwd = W.bwd_work(SMOKE_B, cfg.n_heads, cfg.n_kv_heads, SMOKE_N,
                     cfg.head_dim, cfg.head_dim, 4)
    kw = count.kernel_work()
    assert (kw["fastmax_causal"]["ops"], kw["fastmax_causal"]["bytes"]) \
        == (2 * cfg.n_layers * fwd[0], 2 * cfg.n_layers * fwd[1])
    assert (kw["fastmax_causal_bwd"]["ops"],
            kw["fastmax_causal_bwd"]["bytes"]) \
        == (cfg.n_layers * bwd[0], cfg.n_layers * bwd[1])
    assert count.routes() == ["kernel fastmax_causal on one device",
                              "kernel fastmax_causal_bwd on one device"]


# ---------------------------------------------------------------------------
# the kernels' meta route
# ---------------------------------------------------------------------------


@pytest.fixture
def no_plain_no_launch(monkeypatch):
    """Every plain version and every CUDA wrapper raises if called, but
    for the noncausal backward, autograd of the plain moment path on both
    routes (the reference has no noncausal backward kernel either)."""
    def boom(*a, **k):
        if torch._C._current_autograd_node() is not None \
                and torch.is_grad_enabled():
            return FN_REF(*a, **k)
        raise AssertionError("the meta route ran a plain version or a launch")

    for mod, names in ((FC, ("fastmax_causal_ref", "fastmax_causal_cuda")),
                       (FB, ("fastmax_causal_bwd_ref",
                             "fastmax_causal_bwd_cuda")),
                       (FN, ("fastmax_noncausal_ref",
                             "fastmax_noncausal_cuda")),
                       (HC, ("hybrid_causal_ref", "hybrid_causal_cuda")),
                       (ops._fd, ("fastmax_decode_cuda",)),
                       (ops, ("fastmax_decode_ref",))):
        for name in names:
            monkeypatch.setattr(mod, name, boom)
    ops.reset_launch_counts()
    yield
    assert all(v == 0 for v in ops.launch_counts().values())


def _qkv(device, b=2, hq=4, hkv=2, n=40, d=8, dv=8, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)

    def make(*shp):
        x = torch.randn(shp, generator=g, dtype=torch.float64)
        return x.to(dtype).to(device)

    return make(b, hq, n, d), make(b, hkv, n, d), make(b, hkv, n, dv)


def _state(device, b=2, hkv=2, d=8, dv=8):
    return tuple(torch.zeros(s, device=device) for s in
                 ((b, hkv, dv), (b, hkv, d, dv), (b, hkv, d, d, dv), (b, hkv),
                  (b, hkv, d), (b, hkv, d, d)))


def _like(a, b):
    """Same structure, shapes and dtypes; `a` all meta."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.device.type == "meta"
        assert (tuple(x.shape), x.dtype) == (tuple(y.shape), y.dtype)


def tree_leaves(tree):
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


ENTRIES = ["prefill", "prefill_init_mask", "bwd", "bwd_dstate",
           "hybrid_prefill", "decode", "fastmax_train", "noncausal_train",
           "hybrid_train"]


def _entry(name, device):
    """(outputs, the recorded kernels' names) of one entry on `device`."""
    q, k, v = _qkv(device)
    if name == "prefill":
        return ops.fastmax_prefill_kernel(q, k, v, p=2, chunk_size=16), \
            ["fastmax_causal"]
    if name == "prefill_init_mask":
        mask = torch.ones(2, 1, 40, device=device)
        init = _state(device)
        return ops.fastmax_prefill_kernel(q, k, v, p=2, chunk_size=16,
                                          kv_mask=mask, init_state=init), \
            ["fastmax_causal"]
    if name in ("bwd", "bwd_dstate"):
        st = _state(device)
        do = torch.ones(2, 4, 40, 8, device=device)
        return ops.fastmax_bwd(q, k, v, st, do, p=2, chunk_size=16,
                               return_dstate=name == "bwd_dstate"), \
            ["fastmax_causal_bwd"]
    if name == "hybrid_prefill":
        return ops.hybrid_prefill_kernel(q, k, v, p=2, window=8,
                                         chunk_size=16), ["hybrid_causal"]
    if name == "decode":
        q1, k1, v1 = (x[:, :, :1].contiguous() for x in (q, k, v))
        return ops.fastmax_decode(q1, k1, v1, _state(device), p=2), \
            ["fastmax_decode"]
    prim = [x.requires_grad_(True) for x in (q, k, v)]
    if name == "fastmax_train":
        o = ops.fastmax(*prim, p=2, chunk_size=16)
        kernels = ["fastmax_causal", "fastmax_causal_bwd"]
    elif name == "noncausal_train":
        o = ops.fastmax(*prim, p=2, causal=False, chunk_size=16)
        kernels = ["fastmax_noncausal_moments", "fastmax_noncausal_combine"]
    else:
        o = ops.hybrid(*prim, p=2, window=8, chunk_size=16)
        kernels = ["hybrid_causal"]
    grads = torch.autograd.grad(o.sum(), prim)
    return (o, grads), kernels


@pytest.mark.parametrize("name", ENTRIES)
def test_meta_route(name, no_plain_no_launch, monkeypatch):
    with OpCount("meta") as count:
        out, kernels = _entry(name, "meta")
    monkeypatch.undo()
    ref, _ = _entry(name, "cpu")
    _like(out, ref)
    assert [r["kernel"] for r in count.record["launches"]] == kernels
    for r in count.record["launches"]:
        assert r["route"] == "meta" and r["ops"] > 0 and r["bytes"] > 0
    with pytest.raises(Exception):
        tree_leaves(out)[0].tolist()


def test_meta_route_records_the_work_and_counts_the_workspace():
    q, k, v = _qkv("meta", b=2, hq=4, hkv=2, n=300, d=16, dv=8)
    with OpCount("meta") as count:
        o, st = ops.fastmax_prefill_kernel(q, k, v, p=2)
    rec = count.record["launches"]
    assert len(rec) == 1
    assert (rec[0]["ops"], rec[0]["bytes"]) \
        == W.prefill_work(2, 4, 2, 300, 16, 8, 4)
    # the key weights, the workspace, o and the final carry
    want = (4 * 2 * 2 * 300 + FC.workspace_bytes(4, 300, 16, 8, 2)
            + tree_bytes((o, st)))
    assert count.peak == want
    st = _state("meta", d=16)
    do = torch.empty(2, 4, 300, 8, device="meta")
    with OpCount("meta") as count:
        grads = ops.fastmax_bwd(q, k, v, st, do, p=2)
    assert count.peak == FB.bwd_workspace_bytes(2, 4, 2, 300, 16, 8, 2) \
        + tree_bytes(grads)
    assert count.record["launches"][0]["bytes"] \
        == W.bwd_work(2, 4, 2, 300, 16, 8, 4)[1]


def test_hbm_bytes_are_counted_per_op():
    """Operand + output bytes of each aten op that moves data: an add
    reads two and writes one, a mul reads one and writes one; a view and
    an allocation move nothing."""
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(64, 32, device="meta")
    size = 64 * 32 * 4
    with OpCount("meta") as count:
        x = (a + b).view(32, 64)
        x * 2.0
        torch.empty(1000, device="meta")
    assert count.result()["hbm_bytes"] == 3 * size + 2 * size
    # x and the product live at once; the product is freed before the
    # allocation, which adds to x alone
    assert count.peak == 2 * size


def test_outside_the_context_nothing_is_recorded():
    assert ops._RECORD is None
    q, k, v = _qkv("cpu")
    ops.fastmax_prefill_kernel(q, k, v, p=2, chunk_size=16)
    with OpCount("cpu") as count:
        ops.fastmax_prefill_kernel(q, k, v, p=2, chunk_size=16)
    assert ops._RECORD is None
    assert count.record["launches"] == []
    assert count.routes() == ["plain fastmax_causal (the kernel's plain "
                              "version)"]


# ---------------------------------------------------------------------------
# MoE on meta: the balanced load
# ---------------------------------------------------------------------------


def test_moe_meta_dispatches_the_balanced_load():
    """deepseek-v2's smoke MoE in training (capacity k·t·1.25/E): on meta
    each expert runs min(C, its balanced load) rows, counted by their
    matmul flops; the reference compiles E·C rows. Here t = 2·64 tokens,
    k = 2 of E = 8 experts: C = 40, loads 32, so the reference's static
    capacity computes 40/32 = 1.25 times the rows."""
    cfg = get_smoke_config("deepseek-v2-236b")
    params = init_model(cfg, device="meta")
    moe = next(v["ffn"] for k, v in params.items()
               if k.startswith("blocks") and "router" in v.get("ffn", {}))
    moe = {k: v[0] for k, v in moe.items()}
    b, n = 2, 64
    x = torch.empty(b, n, cfg.d_model, device="meta", dtype=cfg.adtype())
    with OpCount("meta") as count:
        y, aux = MOE.apply_moe(moe, x, cfg)
    assert (y.shape, y.device.type, aux.shape) \
        == (x.shape, "meta", torch.Size([]))
    t, e, k = b * n, cfg.n_experts, cfg.moe_top_k
    cap = MOE.capacity(t, cfg, False)
    rows = sum(min(cap, c) for c in MOE.balanced_counts(t, k, e))
    d, ff = cfg.d_model, cfg.d_ff_expert
    router = 2 * t * d * e
    shared = (2 * t * d * ff * cfg.n_shared_experts * 3
              if cfg.n_shared_experts else 0)
    assert count.matmul_flops == router + shared + rows * 2 * d * ff * 3
    assert (t, k, e, cap, sum(MOE.balanced_counts(t, k, e))) \
        == (128, 2, 8, 40, 256)
    assert e * cap / rows == 1.25
    with pytest.raises(Exception):
        y.tolist()


def _routed_flops(cfg, shape, mesh=None) -> dict:
    """Matmul flops of the routed experts' forward and backward
    (`moe._Expert`) in one train step on meta, by site."""
    fn, args, _ = D.cell_step(cfg, shape, device="meta", mesh=mesh)
    with OpCount("meta") as count:
        fn(*args)
    sites = dict(count.flops_breakdown(1000))
    return {f: sites.get(f"repro_torch/models/moe.py:{f}", 0.0)
            for f in ("forward", "backward")}


def test_placed_moe_splits_the_experts_flops_over_model():
    """deepseek-v2's smoke train step (remat full) on a fake world of
    (data 4, model 2), global batch 8 x 64: the rank's 4 of 8 experts
    take their share of the global balanced load (512 tokens x 2 slots
    over 8 experts, 32 rows each from the rank's tokens, below C = 160),
    so its routed-expert matmul flops are half those of one device
    running the rank's 2 rows alone (C = 40): forward and recompute
    (3 products each), backward (6)."""
    cfg = get_smoke_config("deepseek-v2-236b")
    one = _routed_flops(cfg, ShapeSpec(64, 2, "train"))
    with D.fake_world(8):
        mesh = make_test_mesh((4, 2), ("data", "model"))
        placed = _routed_flops(cfg, ShapeSpec(64, 8, "train"), mesh)
    rows = sum(MOE.balanced_counts(2 * 64, cfg.moe_top_k, cfg.n_experts))
    per_pass = rows * 2 * cfg.d_model * cfg.d_ff_expert * 3 \
        * cfg.n_layers_scanned
    assert one == {"forward": 2 * per_pass, "backward": 2 * per_pass}
    assert placed == {k: v / 2 for k, v in one.items()}


# ---------------------------------------------------------------------------
# the context-parallel step's collectives on a fake world of 4 ranks
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_world4():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield
    dist.destroy_process_group()


def test_cp_step_collectives(fake_world4):
    """The placed context-parallel step on (data 2, seq 2): the FSDP
    gathers of each layer's data shards (forward and recompute), of the
    tied embedding (lookup and logits) and the final norm, and one carry
    exchange of `cp_carry_bytes` per kernel launch; one reduce-scatter of
    each gathered grad; all-reduces of every grad over "seq", of the
    leaves "data" does not split over "data", and of the scalars."""
    from repro_torch.kernels.sharded import cp_carry_bytes
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.grad_utils import leaves
    from repro_torch.sharding import placed as PL

    cfg = get_smoke_config("qwen3-1.7b",
                           attn=AttentionSpec.parse("fastmax2-kernel"))
    mesh = make_test_mesh((2, 2), ("data", "seq"))
    b, n = 4, 64
    fn, args, parts = D.cell_step(cfg, ShapeSpec(n, b, "train"),
                                  device="meta", mesh=mesh)
    with OpCount("meta") as count:
        fn(*args)
    res = count.result()
    params = parts["params"]

    def nbytes(x):
        return x.numel() * x.element_size()

    split = {k: nbytes(x) for k, x in leaves(params)
             if "data" in PL.split_axes(PL.spec_of(x))}
    blocks = sum(v for k, v in split.items() if k.startswith("blocks_"))
    embed, final = split["embed"], split["final_norm/scale"]
    assert sum(split.values()) == blocks + embed + final
    carry = cp_carry_bytes(b=b // 2, hkv=cfg.n_kv_heads, d=cfg.head_dim,
                           dv=cfg.head_dim, p=2)
    launches = count.launches()
    assert launches == {"fastmax_causal": 2 * cfg.n_layers,
                        "fastmax_causal_bwd": cfg.n_layers}
    # one exchange (allgather at this size) before each launch
    assert res["coll_all-gather"] == 2 * blocks + 2 * embed + final \
        + carry * sum(launches.values())
    # a reduce-scatter sends the gathered grad: twice the local shard
    assert res["coll_reduce-scatter"] == 2 * (blocks + 2 * embed + final)
    whole = tree_bytes(params) - sum(split.values())
    # the grads over "seq" and the replicated ones over "data"; the token
    # count, loss, nll and aux over both axes; gnorm's split leaves' sum
    assert res["coll_all-reduce"] == tree_bytes(params) + whole \
        + 4 * 2 + 3 * 4 * 2 + 4
    assert res["collective_bytes"] == res["coll_all-reduce"] \
        + res["coll_all-gather"] + res["coll_reduce-scatter"]
    assert all(ln.startswith("kernel ") and "shard_map[seq]" in ln
               for ln in count.routes())


def test_placed_residual_is_saved_on_the_rank_s_slice(fake_world4):
    """The smoke qwen3-1.7b train step (remat full) on meta, on a fake
    world of (data 2, model 2), global batch 4 x 64: each block's
    checkpoint keeps the rank's rows x 64 / 2 tokens x d of the residual
    (`SavedBytes`), every layer once; at 62 tokens as well ("model"
    divides it), and the logits whole over the sequence."""
    from repro_torch.launch.op_analysis import SavedBytes

    cfg = get_smoke_config("qwen3-1.7b",
                           attn=AttentionSpec.parse("fastmax2-kernel"))
    assert cfg.remat == "full"
    mesh = make_test_mesh((2, 2), ("data", "model"))
    for n in (64, 62):
        fn, args, _ = D.cell_step(cfg, ShapeSpec(n, 4, "train"),
                                  device="meta", mesh=mesh)
        with SavedBytes() as saved:
            fn(*args)
        item = torch.empty((), dtype=cfg.adtype()).element_size()
        assert saved.block_inputs == 2 * (n // 2) * cfg.d_model * item \
            * cfg.n_layers
        assert saved.total > saved.block_inputs


# ---------------------------------------------------------------------------
# the CLI, the gate, one MoE cell, the probe
# ---------------------------------------------------------------------------

FIELDS = ("arch", "shape", "kind", "cp", "cp_boundary", "attn_routing",
          "attn_schedule", "mesh", "n_chips", "attn_spec", "n_params",
          "param_bytes_global", "active_params", "model_flops", "planned",
          "executed", "ops", "launches", "kernel_work", "flops_breakdown",
          "roofline", "fits")


def _cli(tmp_path, *argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--out",
         str(tmp_path)], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)


def test_cli_kernel_route_gate(tmp_path):
    run = _cli(tmp_path, "--arch", "qwen3-1.7b", "--shape", "train_4k",
               "--attn", "fastmax2-kernel", "--assert-kernel-route")
    assert run.returncode == 0, run.stdout + run.stderr
    res = json.loads((tmp_path / "qwen3-1.7b__train_4k__single__"
                      "fastmax2-kernel.json").read_text())
    assert all(f in res for f in FIELDS), set(FIELDS) - set(res)
    # no SPMD partitioner, so no remat record (ROADMAP queue 3)
    assert "xla_remat" not in res
    assert res["mesh"] == "16x16" and res["n_chips"] == 256
    assert res["launches"] == {"fastmax_causal": 56, "fastmax_causal_bwd": 28}
    assert res["attn_routing"] == [
        "kernel fastmax_causal shard_map[feature] over (data=16xmodel=16)",
        "kernel fastmax_causal_bwd shard_map[feature] over "
        "(data=16xmodel=16)"]
    for key in ("compute_s", "memory_s", "collective_s",
                "useful_flops_ratio", "dominant"):
        assert key in res["roofline"]
    assert set(res["planned"]) == {"params", "opt_state", "batch",
                                   "decode_state", "total"}
    # the placed step holds rank 0's shards: the planned bytes, part by
    # part, and one layer's gathered weights at a time fit the card
    ex, pl = res["executed"], res["planned"]
    for part in ("params", "opt_state", "batch"):
        assert ex[part] == pl[part], part
    assert ex["argument_bytes"] == pl["total"]
    # 8 kv heads stay whole on "model" = 16: more than a 256th
    assert ex["params"] < res["param_bytes_global"] / 100
    assert res["fits"]["planned"] and res["fits"]["executed"]


def test_gate_refuses_the_plain_path(tmp_path):
    """fastmax2 is the plain chunked scan: the gate fails the cell. The
    decode cell takes the plain moment step (a train cell's chunked scan
    on meta takes minutes at full width)."""
    run = _cli(tmp_path, "--arch", "qwen3-1.7b", "--shape", "decode_32k",
               "--attn", "fastmax2", "--assert-kernel-route")
    assert run.returncode != 0
    assert "plain decode: fastmax moment step" in run.stdout
    res = D.route_errors({"n_chips": 256, "attn_routing": [
        "kernel fastmax_causal on the whole heads: no plan divides the "
        "mesh"]})
    assert res == ["no kernel routing line on a plan's shards recorded"]


def test_moe_cell_sizes_per_device():
    res = D.run_cell("deepseek-v2-236b", "decode_32k",
                     attn="fastmax2-kernel")
    cfg = get_config("deepseek-v2-236b")
    assert res["launches"] == {"fastmax_decode": cfg.n_layers}
    assert D.route_errors(res) == []
    # MLA's 128 kv heads split over "model" = 16: heads mode
    assert all("shard_map[heads]" in ln for ln in res["attn_routing"])
    ex, pl = res["executed"], res["planned"]
    # rank 0's shard of the model, its 1/256th, as planned
    assert ex["params"] == pl["params"] < res["param_bytes_global"] / 200
    # the decode state: 128 sequences over data = 16, heads over 16
    assert ex["decode_state"] == pl["decode_state"]
    assert ex["argument_bytes"] == pl["total"]
    # its 73.4 GB decode state and the temporaries of a layer whose 10
    # experts a rank are gathered one at a time (0.64 GB) fit the card
    assert ex["temp_peak_bytes"] < 3e9
    assert res["fits"]["planned"] and res["fits"]["executed"]
    assert res["n_params"] > 2.3e11


def test_perfprobe(tmp_path, capsys):
    from repro_torch.launch import perfprobe

    dump = tmp_path / "ops.json"
    perfprobe.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                    "--attn", "fastmax2-kernel", "--dump-ops", str(dump)])
    out = capsys.readouterr().out
    assert "per-device matmul flops" in out and "fastmax_decode" in out
    table = json.loads(dump.read_text())
    assert any(k.startswith("aten.mm") for k in table)
    assert math.isfinite(sum(r["flops"] for r in table.values()))


# ---------------------------------------------------------------------------
# the placed step's arguments: rank 0's shards, as planned
# ---------------------------------------------------------------------------

# each config's cheapest cell, and every shape of two dense configs and
# of whisper-small (its towers tensor-parallel) but train_1M; the SSM
# configs' one-sequence cell too
_SSM_ARCHS = ("jamba-v0.1-52b", "xlstm-1.3b")
_PLACED_CELLS = ([(arch, "decode_32k") for arch in ARCHS]
                 + [(arch, shape) for arch in ("qwen3-1.7b", "granite-20b")
                    for shape in SHAPES if shape != "decode_32k"]
                 + [("whisper-small", shape) for shape in (
                     "train_4k", "prefill_32k", "long_500k")]
                 + [(arch, "long_500k") for arch in _SSM_ARCHS])
# the cells whose planned SSM state splits a feature dim over "data": one
# sequence leaves the batch axes nothing to split, and the placed step
# holds the rank's channels over "model" only (ROADMAP queue 1 item D)
_SSM_STATE_WHOLE_ON_DATA = {(arch, "long_500k") for arch in _SSM_ARCHS}


def _ssm_state_bytes(arch, shape, mesh) -> tuple:
    """(planned, held) bytes of the SSM layers' decode state on rank 0:
    the reference's `decode_state_shardings` of the whole state, and what
    the placed step holds, the compute's layout: its rows over the batch
    axes, its channels over "model" (1/model of every SSM leaf)."""
    from repro_torch.models import decode_state_specs
    from repro_torch.models.transformer import _SSM, _block_keys

    cfg = get_config(arch)
    b, n = SHAPES[shape].global_batch, SHAPES[shape].seq_len
    state = decode_state_specs(cfg, b, n)
    specs = R.decode_state_shardings(state, mesh, batch=b)
    rows = b // D._dp_size(mesh, b)
    planned = held = 0
    for key, kind, _ in _block_keys(cfg):
        if kind.split(":")[0] not in _SSM:
            continue
        for path, x, spec in D._pairs(state[key], specs[key]):
            planned += D._local_numel(tuple(x.shape), spec, mesh, path) \
                * x.element_size()
            held += x.numel() // b * rows // mesh["model"] \
                * x.element_size()
    return planned, held


@pytest.mark.parametrize("multi", [False, True], ids=["one-pod", "two-pod"])
@pytest.mark.parametrize("arch, shape", _PLACED_CELLS)
def test_placed_arguments_are_the_planned_bytes(arch, shape, multi):
    """The placed step's argument bytes on rank 0 equal the planned ones,
    part by part: parameters, optimizer state, batch and decode state.
    The SSM layers' decode state is held as `_ssm_state_bytes` says: the
    planned bytes, but where one sequence leaves the plan's feature split
    over "data" to the batch axes (`_SSM_STATE_WHOLE_ON_DATA`)."""
    res = D.run_cell(arch, shape, multi_pod=multi, attn="fastmax2-kernel")
    ex, pl = res["executed"], res["planned"]
    for part in ("params", "opt_state", "batch"):
        assert ex.get(part, 0) == pl[part], part
    names, sizes = MESHES["multi" if multi else "single"]
    planned_ssm, held_ssm = _ssm_state_bytes(arch, shape,
                                             dict(zip(names, sizes)))
    assert ex.get("decode_state", 0) == pl["decode_state"] - planned_ssm \
        + held_ssm
    assert (planned_ssm > 0) == (arch in _SSM_ARCHS)
    if (arch, shape) in _SSM_STATE_WHOLE_ON_DATA:
        assert held_ssm > planned_ssm
    else:
        assert held_ssm == planned_ssm
        assert ex["argument_bytes"] == pl["total"]


@pytest.mark.parametrize("multi", [False, True], ids=["one-pod", "two-pod"])
@pytest.mark.parametrize("arch", _SSM_ARCHS)
def test_ssm_state_layout_differs_at_the_same_bytes(arch, multi):
    """The recorded layout divergence (ROADMAP queue 3): at decode_32k
    the reference's generic policy splits each SSM state leaf's last dim
    first, then its largest, over ("model", "data"), takes the stacked
    group dim for the batch dim (over "pod" in two pods, where it
    divides 4 or 6) and leaves the rows whole: jamba's Mamba h
    [4, 128, 8192, 16] gets d_state over "model" and d_inner over
    "data". The placed step holds its compute's layout (rows over the
    batch axes, channels over "model"), with no exchange per decode
    step, at the same bytes a rank, leaf by leaf."""
    from repro_torch.models import decode_state_specs
    from repro_torch.models.transformer import _SSM, _block_keys

    names, sizes = MESHES["multi" if multi else "single"]
    mesh = dict(zip(names, sizes))
    cfg = get_config(arch)
    b, n = SHAPES["decode_32k"].global_batch, SHAPES["decode_32k"].seq_len
    state = decode_state_specs(cfg, b, n)
    specs = R.decode_state_shardings(state, mesh, batch=b)
    rows = b // D._dp_size(mesh, b)
    assert rows < b
    seen = 0
    for key, kind, _ in _block_keys(cfg):
        if kind.split(":")[0] not in _SSM:
            continue
        for path, x, spec in D._pairs(state[key], specs[key]):
            # [G, B, ...]: the plan keeps the rows whole ...
            assert spec[1] is None, (path, spec)
            # ... and splits features over "data"
            assert any("data" in ((e,) if isinstance(e, str) else e or ())
                       for e in spec[2:]), (path, spec)
            assert D._local_numel(tuple(x.shape), spec, mesh, path) == \
                x.numel() // b * rows // mesh["model"], (path, spec)
            seen += 1
    if arch.startswith("jamba"):
        h = specs["blocks_0"].h
        assert (h[2], h[3]) == ("data", "model"), h
        assert seen == 2 * 7       # conv and h of 7 Mamba blocks
    else:
        assert seen == 2 * 7 + 4   # mLSTM's C, n; sLSTM's c, n, m, h


@pytest.mark.parametrize("multi", [False, True], ids=["one-pod", "two-pod"])
def test_placed_whisper_splits_its_mlps_over_model(multi):
    """whisper-small's `prefill_32k` on the production mesh: its 12 heads
    do not divide "model" 16, so every self- and cross-attention is
    computed whole on each rank, and the vocab (51865) is whole; each
    GELU MLP holds its 3072 / 16 ff columns. Rank 0's matmul flops are
    exactly those of its rows (32 over the data axes) with the MLPs'
    products at 1/16: per token and layer 2 (4 d² + 2 d²) (self-attention,
    the cross-attention's q and o) + 2 · 2 d ff / 16, the logits' 2 d V a
    token, the cross-attention's k and v 2 · 2 d² a frame and layer."""
    cfg = get_config("whisper-small")
    res = D.run_cell("whisper-small", "prefill_32k", multi_pod=multi,
                     attn="fastmax2-kernel")
    names, sizes = MESHES["multi" if multi else "single"]
    m = dict(zip(names, sizes))["model"]
    rows = SHAPES["prefill_32k"].global_batch // D._dp_size(
        dict(zip(names, sizes)), SHAPES["prefill_32k"].global_batch)
    d, ff, layers = cfg.d_model, cfg.d_ff, cfg.n_layers
    token = layers * (12 * d * d + 4 * d * ff // m) + 2 * d * cfg.vocab_size
    frame = layers * 4 * d * d
    want = rows * (SHAPES["prefill_32k"].seq_len * token
                   + cfg.encoder_seq * frame)
    assert cfg.n_heads % m and cfg.d_ff % m == 0
    assert res["ops"]["matmul_flops"] == want
