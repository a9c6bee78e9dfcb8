"""Dry run: count every (arch x shape x mesh) cell per device, without a
card — the port's counterpart of `repro/launch/dryrun.py`.

The reference lowers and compiles each cell's step for 512 placeholder
devices and reads the compiled module. The port runs its own eager step on
the `meta` device (no memory, no values) under `launch/op_analysis.py`'s
count, as one rank of the production mesh runs it:

  * the mesh: a fake process group (`torch.distributed`'s "fake" backend:
    one process, no communication) of 256 or 512 ranks, this process rank
    0, and `launch/mesh.py::make_production_mesh` on it; `mesh=None` is
    one device with no group (the card's check in `chip_smoke.py`);
  * planned, per device: the bytes of the parameters, the optimizer state,
    the batch and the decode state on rank 0 under the reference's
    placement (`sharding.rules`: `param_shardings`, `batch_spec`,
    `decode_state_shardings`, through `to_placements`) — the counterpart
    of the compiled module's argument size;
  * executed, per device: the port's step as rank 0 runs it — under a
    mesh the placed step (`sharding.placed`, `launch/steps.py`): rank 0's
    shard of the parameters and the optimizer state, its rows of the
    batch (under `--cp` its token shard of them over "seq"), each layer's
    leaves gathered around their use, the dense decoders split over
    "model", attention through the kernel plans of `kernels/sharded.py`
    under `use_mesh` — counted op by op: argument bytes (equal to the
    planned ones but where the decode state is held whole over an axis
    the plan splits it on: the batch-1 SSM states over "data", ROADMAP
    queue 1 item D), the temp
    peak, matmul flops, the kernels' launches and work, HBM bytes and
    collective bytes by kind;
  * the reference's own fields where they mean the same (n_params,
    param_bytes_global, active_params, model_flops, cp_boundary,
    attn_schedule, mesh, n_chips, attn_spec), the routing lines
    (`attn_routing`), a roofline at the H100's rates (`kernels/work.py`)
    and whether each footprint fits the card's 80 GB.

Not ported: the reference's `xla_remat` and `--assert-no-remat` (torch has
no SPMD partitioner to rematerialize) and `_kernel_cell_env` (the port has
no platform reroute: a kernel cell takes the kernels' meta route).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
      --attn fastmax2-kernel --assert-kernel-route
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, ShapeSpec, all_arch_ids, get_config
from repro_torch.kernels import work as W

__all__ = ["run_cell", "cell_step", "planned_bytes", "param_counts",
           "fake_world", "main"]


def _cfg(arch: str, attn=None, extra_cfg: dict | None = None):
    from repro_torch.attention import AttentionSpec

    overrides = dict(extra_cfg or {})
    if attn:
        overrides["attn"] = (AttentionSpec.parse(attn)
                             if isinstance(attn, str) else attn)
    return get_config(arch, **overrides)


def _shape(shape) -> tuple:
    """(name, ShapeSpec) of a SHAPES name or a ShapeSpec."""
    if isinstance(shape, str):
        return shape, SHAPES[shape]
    return f"{shape.kind}_{shape.global_batch}x{shape.seq_len}", shape


@contextlib.contextmanager
def fake_world(world_size: int):
    """A single-process fake process group of `world_size` ranks, this
    process rank 0, destroyed on exit."""
    import torch.distributed as dist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own (fake) process group; "
                           "one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Parameters, active parameters, model flops (the reference's formula)
# ---------------------------------------------------------------------------


def _leaf_items(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_items(v, path + (k,))
    else:
        yield path, tree


def param_counts(cfg, params, axes) -> dict:
    """n_params, param_bytes_global, active_params: the total minus the
    routed experts not chosen (top_k of n_experts) and, untied, the input
    embedding (`dryrun.py` of the reference)."""
    ax = dict(_leaf_items(axes))
    total = routed = embed = nbytes = 0
    for path, leaf in _leaf_items(params):
        n = leaf.numel()
        total += n
        nbytes += n * leaf.element_size()
        if "experts" in ax[path]:
            routed += n
        if path[-1] == "embed":
            embed += n
    active = total - (0 if cfg.n_experts == 0 else
                      routed * (1.0 - cfg.moe_top_k / cfg.n_experts))
    if not cfg.tie_embeddings:
        active -= embed
    return {"n_params": total, "param_bytes_global": nbytes,
            "active_params": float(active)}


def model_flops(active: float, shape: ShapeSpec) -> float:
    """6·N_active·tokens (train) / 2·N_active·tokens (serve)."""
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind != "decode" else shape.global_batch)
    return (6.0 if shape.kind == "train" else 2.0) * active * tokens


# ---------------------------------------------------------------------------
# Planned: the reference's placement, rank 0's bytes
# ---------------------------------------------------------------------------


def _local_numel(shape, spec, mesh, name: str) -> int:
    """Elements of rank 0's shard of a tensor of `shape` placed by `spec`
    (its `to_placements` on the mesh; the rules split only dims the mesh
    axes divide)."""
    from repro_torch.sharding.rules import mesh_axes, to_placements

    sizes = list(mesh_axes(mesh).values())
    local = list(shape)
    for i, pl in enumerate(to_placements(spec, mesh, name)):
        d = getattr(pl, "dim", None)
        if d is None:
            continue
        if local[d] % sizes[i]:
            raise ValueError(f"{name}: dim {d} of {tuple(shape)} does not "
                             f"split over mesh dim {i} ({sizes[i]})")
        local[d] //= sizes[i]
    return math.prod(local)


def _pairs(tree, specs, path=""):
    """(path, leaf, spec) of a tree of tensors and the same tree of
    specs (dicts, NamedTuples; None legs skipped)."""
    from repro_torch.sharding.rules import Spec

    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield path, tree, specs
    elif isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], specs[k], f"{path}/{k}")
    elif isinstance(tree, tuple) and not isinstance(tree, Spec):
        for i, (x, s) in enumerate(zip(tree, specs)):
            yield from _pairs(x, s, f"{path}/{i}")
    else:
        raise TypeError(f"{path}: {type(tree).__name__}")


def _tree_local_bytes(tree, specs, mesh) -> int:
    return sum(_local_numel(tuple(x.shape), s, mesh, p) * x.element_size()
               for p, x, s in _pairs(tree, specs))


def _batch_tree_specs(tree, bspec, scalar=()):
    from repro_torch.sharding.rules import Spec

    return {k: (Spec() if k in scalar else
                Spec(*(tuple(bspec) + (None,) * (v.dim() - 1))))
            for k, v in tree.items()}


def planned_bytes(cfg, shape: ShapeSpec, mesh, params, axes,
                  opt_state=None) -> dict:
    """Per-device bytes of rank 0 under the reference's placement: the
    parameters, the optimizer state (moments and master like the
    parameters, its step replicated), the batch and the decode state.
    `mesh` a DeviceMesh or a mapping axis -> size ({} for one device)."""
    from repro_torch.models import decode_state_specs, input_specs
    from repro_torch.sharding.rules import (Spec, batch_spec,
                                            decode_state_shardings,
                                            param_shardings)

    b, n = shape.global_batch, shape.seq_len
    psh = param_shardings(axes, params, mesh)
    out = {"params": _tree_local_bytes(params, psh, mesh), "opt_state": 0,
           "batch": 0, "decode_state": 0}
    bspec = batch_spec(mesh, batch_size=b)
    if shape.kind == "train":
        out["opt_state"] = opt_state.step.element_size() + sum(
            _tree_local_bytes(t, param_shardings(axes, t, mesh), mesh)
            for t in (opt_state.m, opt_state.v, opt_state.master)
            if t is not None)
        batch = input_specs(cfg, global_batch=b, seq_len=n, kind="train")
        out["batch"] = _tree_local_bytes(batch, _batch_tree_specs(batch,
                                                                  bspec),
                                         mesh)
    else:
        state = decode_state_specs(cfg, b, n)
        out["decode_state"] = _tree_local_bytes(
            state, decode_state_shardings(state, mesh, batch=b), mesh)
        if shape.kind == "prefill":
            batch = {"tokens": torch.empty(b, n, dtype=torch.int32,
                                           device="meta")}
            if cfg.encoder_layers:
                batch["enc_out"] = input_specs(
                    cfg, global_batch=b, seq_len=1, kind="decode")["enc_out"]
            specs = _batch_tree_specs(batch, bspec)
        else:
            batch = input_specs(cfg, global_batch=b, seq_len=1, kind="decode")
            batch["position"] = torch.empty((), dtype=torch.int32,
                                            device="meta")
            tok = bspec if b > 1 else Spec(None)
            specs = _batch_tree_specs(batch, tok, scalar=("position",))
        out["batch"] = _tree_local_bytes(batch, specs, mesh)
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# Executed: the port's step as rank 0 runs it
# ---------------------------------------------------------------------------


def _dp_size(mesh, batch: int) -> int:
    """Ranks the batch splits over (its batch_spec's axes)."""
    if mesh is None:
        return 1
    from repro_torch.sharding.rules import batch_spec, mesh_axes

    sizes = mesh_axes(mesh)
    entry = tuple(batch_spec(mesh, batch_size=batch))[0]
    axes = () if entry is None else ((entry,) if isinstance(entry, str)
                                     else entry)
    return math.prod(sizes[a] for a in axes)


def cell_step(cfg, shape: ShapeSpec, *, device, mesh=None, seed: int = 0,
              params=None):
    """The step rank 0 runs for this cell and its arguments on `device`
    (`meta`, or a card with seeded weights and tokens): (fn, args, parts),
    fn(*args) runs the step once and `parts` names the arguments' groups
    (params, opt_state, batch, decode_state) for their bytes. `params`
    are the whole model's (made from `seed` if None). Under a mesh the
    placed step: rank 0's shards of the parameters (and the optimizer
    state), its rows of the batch, its decode state made under the mesh
    (the kernel plans keep local moments). Decode runs at position
    seq_len - 1, a scalar argument."""
    from repro_torch.launch.steps import (make_prefill_step,
                                          make_serve_step, make_train_step,
                                          pick_optimizer)
    from repro_torch.models import init_decode_state, init_model
    from repro_torch.models.param import count_params
    from repro_torch.sharding.rules import use_mesh

    dev = torch.device(device)
    if params is None:
        params = init_model(cfg, seed=seed, device=dev)
    n_params = count_params(params)
    placement = None
    if mesh is not None:
        from repro_torch.sharding.placed import Placement

        placement = Placement(cfg, mesh)
        params = placement.place(params)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(seed)

    def tokens(*shp):
        if gen is None:
            return torch.empty(shp, dtype=torch.int32, device=dev)
        return torch.randint(0, cfg.vocab_size, shp, generator=gen,
                             device=dev, dtype=torch.int32)

    def acts(*shp):
        if gen is None:
            return torch.empty(shp, dtype=cfg.adtype(), device=dev)
        return torch.randn(shp, generator=gen, device=dev,
                           dtype=torch.float32).to(cfg.adtype())

    b, n = shape.global_batch, shape.seq_len
    b_l = b // _dp_size(mesh, b)
    enc = ((lambda bb: acts(bb, cfg.encoder_seq, cfg.d_model))
           if cfg.encoder_layers else None)

    def scope():
        return contextlib.nullcontext() if mesh is None else use_mesh(mesh)

    if shape.kind == "train":
        _, opt = pick_optimizer(cfg, n_params)
        opt_state = (opt[0](params) if placement is None
                     else placement.init_opt_state(opt[0], params))
        batch = {"tokens": tokens(b_l, n), "targets": tokens(b_l, n)}
        if enc is not None:
            batch["frames"] = enc(b_l)
        step = make_train_step(cfg, opt, mesh=mesh, global_batch=b)
        parts = {"params": params, "opt_state": opt_state, "batch": batch}
        return step, (params, opt_state, batch), parts
    with scope():
        state = init_decode_state(cfg, b_l, n, device=dev)
    extra = () if enc is None else (enc(b_l),)
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, mesh=mesh)
        args = (params, state, tokens(b_l, n)) + extra
        batch = {"tokens": args[2]}
    else:
        step = make_serve_step(cfg, mesh=mesh)
        pos = torch.full((), n - 1, dtype=torch.int32, device=dev)
        args = (params, state, tokens(b_l), pos) + extra
        batch = {"token": args[2], "position": pos}
    if extra:
        batch["enc_out"] = extra[0]

    def fn(*a):
        with torch.no_grad():
            return step(*a)

    return fn, args, {"params": params, "decode_state": state,
                      "batch": batch}


def _roofline(counted: dict, mflops: float, n_chips: int) -> dict:
    flops = counted["matmul_flops"] + counted["kernel_ops"]
    compute_s = flops / W.H100_BF16_FLOPS
    memory_s = counted["hbm_bytes"] / W.H100_BYTES_PER_S
    collective_s = counted["collective_bytes"] / W.NVLINK_BYTES_PER_S
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s,
            "useful_flops_ratio": mflops / max(1.0, flops * n_chips),
            "dominant": max([("compute", compute_s), ("memory", memory_s),
                             ("collective", collective_s)],
                            key=lambda kv: kv[1])[0]}


def run_cell(arch: str, shape_name, *, multi_pod: bool = False,
             attn=None, extra_cfg: dict | None = None, cp: int = 1,
             mesh: str | None = "production", keep_ops: bool = False
             ) -> dict:
    """One cell: `shape_name` a SHAPES name or a ShapeSpec; `mesh`
    "production" (the fake group of 256, or 512 with `multi_pod`, and the
    production mesh, "seq" = `cp`) or None (one device, no group). With
    `keep_ops` the result carries the op table under "op_table"."""
    from repro_torch.kernels import autotune
    from repro_torch.launch.op_analysis import OpCount, tree_bytes
    from repro_torch.models import init_model

    t0 = time.time()
    name, shape = _shape(shape_name)
    cfg = _cfg(arch, attn, extra_cfg)
    if name == "long_500k" and cfg.attn.family == "softmax" \
            and cfg.family not in ("ssm", "hybrid"):
        return {"arch": arch, "shape": name, "skipped":
                "long_500k needs sub-quadratic attention; softmax baseline "
                "is pure full attention"}
    if cp > 1 and shape.seq_len % cp:
        raise ValueError(f"--cp {cp} must divide seq_len={shape.seq_len}")
    if mesh is None and cp > 1:
        raise ValueError("--cp needs the production mesh")
    autotune.clear_lookups()
    params, axes = init_model(cfg, device="meta", with_axes=True)
    counts = param_counts(cfg, params, axes)
    world = contextlib.nullcontext()
    if mesh is not None:
        world = fake_world(512 if multi_pod else 256)
    with world:
        dmesh = None
        if mesh is not None:
            from repro_torch.launch.mesh import make_production_mesh

            dmesh = make_production_mesh(multi_pod=multi_pod, cp=cp,
                                         device_type="cpu")
        fn, args, parts = cell_step(cfg, shape, device="meta", mesh=dmesh,
                                    params=params)
        opt_state = None
        if shape.kind == "train":
            from repro_torch.launch.steps import pick_optimizer

            _, opt = pick_optimizer(cfg, counts["n_params"])
            opt_state = opt[0](params)      # the whole state, on meta
        planned = planned_bytes(cfg, shape, {} if dmesh is None else dmesh,
                                params, axes, opt_state)
        arg_parts = {k: tree_bytes(v) for k, v in parts.items()}
        arg_bytes = tree_bytes(args)
        with OpCount("meta", keep_ops=keep_ops) as count:
            fn(*args)
        del fn, args, parts, opt_state
        n_chips = 1 if dmesh is None else dmesh.size()
        mesh_s = ("1" if dmesh is None else
                  "x".join(str(s) for s in dmesh.shape))
    counted = count.result()
    mflops = model_flops(counts["active_params"], shape)
    cp_boundary = None
    if cp > 1 and shape.kind == "train":
        from repro_torch.kernels.sharded import cp_boundary_model

        cp_boundary = cp_boundary_model(
            n=shape.seq_len, b=shape.global_batch, hkv=cfg.n_kv_heads,
            d=cfg.head_dim, dv=cfg.head_dim, p=cfg.attn.p, cp=cp)
    executed = {"argument_bytes": arg_bytes, **arg_parts,
                "temp_peak_bytes": int(counted["temp_peak_bytes"]),
                "total": arg_bytes + int(counted["temp_peak_bytes"])}
    out = {
        "arch": arch, "shape": name, "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "cp": cp, "cp_boundary": cp_boundary,
        "attn_routing": count.routes(),
        "attn_schedule": autotune.snapshot_lookups(),
        "mesh": mesh_s, "n_chips": int(n_chips),
        "attn_spec": str(cfg.attn),
        **counts,
        "planned": planned,
        "executed": executed,
        "ops": counted,
        "launches": count.launches(),
        "kernel_work": count.kernel_work(),
        "flops_breakdown": count.flops_breakdown(25),
        "model_flops": mflops,
        "roofline": _roofline(counted, mflops, n_chips),
        "fits": {"hbm_bytes": W.HBM_BYTES, "card": W.CARD,
                 "planned": planned["total"] <= W.HBM_BYTES,
                 "executed": executed["total"] <= W.HBM_BYTES},
        "seconds": time.time() - t0,
    }
    if keep_ops:
        out["op_table"] = {k: {"calls": c, "flops": f, "bytes": nb}
                           for k, (c, f, nb) in sorted(
                               count.op_table.items())}
    return out


def route_errors(res: dict) -> list:
    """--assert-kernel-route: a plain routing line refuses the cell, and a
    kernel line must be there — under a mesh one that runs on a plan's
    shards ("shard_map[")."""
    routing = res.get("attn_routing", [])
    plain = [ln for ln in routing if ln.startswith("plain")]
    if plain:
        return ["attention took a plain path: " + plain[0]]
    want = "shard_map[" if res.get("n_chips", 1) > 1 else ""
    if not any(ln.startswith("kernel ") and want in ln for ln in routing):
        return ["no kernel routing line" + (" on a plan's shards"
                                            if want else "") + " recorded"]
    return []


def _gb(x) -> str:
    return f"{x / 1e9:.2f}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--attn", default=None,
                    help="attention operator (AttentionSpec.parse name, "
                         "e.g. softmax, fastmax2, fastmax2-kernel)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cp", type=int, default=1,
                    help="context-parallel degree: trade the 'model' mesh "
                         "axis for a 'seq' axis of this size (train cells "
                         "run the context-parallel step)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--assert-kernel-route", action="store_true",
                    help="fail a cell whose attention took a plain path, "
                         "or that recorded no kernel launch on a plan's "
                         "shards")
    args = ap.parse_args(argv)

    archs = all_arch_ids() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = f"{arch}__{shape}__{'multi' if multi else 'single'}" \
                    + (f"__{args.attn}" if args.attn else "") \
                    + (f"__cp{args.cp}" if args.cp > 1 else "")
                try:
                    res = run_cell(arch, shape, multi_pod=multi,
                                   attn=args.attn, cp=args.cp)
                    status = "SKIP" if "skipped" in res else "OK"
                    errs = (route_errors(res) if args.assert_kernel_route
                            and status == "OK" else [])
                    if errs:
                        status = "FAIL"
                        failures += 1
                        res["error"] = "; ".join(errs)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    res = {"arch": arch, "shape": shape,
                           "mesh": "multi" if multi else "single",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    status = "FAIL"
                    failures += 1
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(res, f, indent=2)
                if not args.quiet:
                    line = f"[{status}] {tag}"
                    if status == "OK":
                        r, ex = res["roofline"], res["executed"]
                        line += (f"  compute={r['compute_s']:.3e}s "
                                 f"memory={r['memory_s']:.3e}s "
                                 f"collective={r['collective_s']:.3e}s "
                                 f"dominant={r['dominant']} "
                                 f"planned/dev={_gb(res['planned']['total'])}"
                                 f" GB executed/dev={_gb(ex['total'])} GB "
                                 f"(args {_gb(ex['argument_bytes'])} + temp "
                                 f"{_gb(ex['temp_peak_bytes'])}) fits "
                                 f"{res['fits']['planned']}/"
                                 f"{res['fits']['executed']} "
                                 f"{res['seconds']:.0f}s")
                    elif status == "FAIL":
                        line += "  " + res["error"][:160]
                    print(line, flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
