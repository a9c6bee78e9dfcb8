"""Logical-axis -> mesh-axis placement rules — port of
`repro/sharding/rules.py` (MaxText-style).

Every parameter carries a tuple of logical axis names
(`repro_torch.models.param.Builder`); `spec_for` maps them to a `Spec` on
a mesh with the reference's divisibility fallback: where a mesh-axis
product does not divide the dim (kv_heads = 8 on model = 16, MQA's kv = 1)
the dim falls back to fewer axes or to replication, never to an invalid
spec.

Parallelism map (one pod (data=16, model=16); two pods add "pod"):
  DP    batch            -> ("pod", "data")
  FSDP  weights' embed   -> "data"
  TP    heads/ff/vocab   -> "model"
  EP    experts          -> "model"
  SP    a long-context decode state's feature dims -> ("model", "data")
        when the batch cannot use "data" (batch 1)

A `Spec` mirrors JAX's `PartitionSpec`: one entry per tensor dim, None,
a mesh axis name or a tuple of names. The planning functions take a
`torch.distributed.device_mesh.DeviceMesh` (its `mesh_dim_names` and
shape) or a plain mapping from axis name to size, and `to_placements`
turns a spec into the DTensor placements of one tensor on a DeviceMesh.

`use_mesh(mesh)` activates a mesh for the code inside it and
`active_mesh()` returns it (the reference's `jax.sharding.use_mesh` and
`active_mesh`): the attention backends and the decode-state protocol plan
their kernel calls on it (`kernels.sharded`). The reference's in-graph
helpers (`maybe_constraint`, `replicate`, `shard_stacked`,
`constrain_kv_cache`) are XLA layout hints that change no number. The
port runs SPMD over local shards: each rank's tensors already are its
shard, and nothing lays them out afterwards, so the helpers are identity
functions kept for the reference's call sites. `kv_cache_block` is the
rank's block of a KV cache under `kv_cache_spec` (the softmax cache, the
hybrid's window) and `moments_block` that of a `Moments` state under
`_moments_shardings`, which the decode state is made as
(`attention.state.init_state`).
"""
from __future__ import annotations

import contextlib
import math
from collections.abc import Mapping
from typing import NamedTuple, Optional

__all__ = ["DEFAULT_RULES", "NO_FSDP_RULES", "Spec", "spec_for",
           "param_shardings", "batch_spec", "kv_cache_spec",
           "decode_state_shardings", "KVBlock", "kv_cache_block",
           "MomentsBlock", "moments_block", "model_axis_size", "mesh_axes",
           "to_placements", "active_mesh", "use_mesh", "maybe_constraint",
           "replicate", "shard_stacked", "constrain_kv_cache"]

_ACTIVE = []    # the stack of meshes `use_mesh` activated


def active_mesh():
    """The mesh `use_mesh` activated, innermost first, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate `mesh` (a DeviceMesh, or a mapping from axis name to
    size for planning only) for the code inside the block."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def maybe_constraint(x, *want_axes):
    """Identity: the reference's graceful `with_sharding_constraint`."""
    del want_axes
    return x


def replicate(x, *, batch_dim=None):
    """Identity: the reference pins x model-replicated."""
    del batch_dim
    return x


def shard_stacked(x, *, batch_dim=1, model_dim=None, seq_dim=None):
    """Identity: the reference pins a scan-stacked chunk tensor to one
    layout."""
    del batch_dim, model_dim, seq_dim
    return x


def constrain_kv_cache(x, *, lead: int = 0):
    """Identity: the reference pins a KV cache to `kv_cache_spec`; the
    port's cache is the rank's block of it by construction
    (`kv_cache_block`), and its prefill and step write only that
    block."""
    del lead
    return x


class Spec(tuple):
    """A placement spec: one entry per tensor dim, None (replicated), a
    mesh axis name, or a tuple of names (the dim split over their
    product). Hashable and equal to the tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


DEFAULT_RULES = {
    "embed": ("data",),       # FSDP / ZeRO-3 for weight matrices
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "layers": (),
}

NO_FSDP_RULES = {**DEFAULT_RULES, "embed": ()}


def mesh_axes(mesh) -> dict:
    """{axis name: size} in the mesh's dim order, from a DeviceMesh (its
    `mesh_dim_names` and shape) or a mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def _entry(chosen: list):
    if not chosen:
        return None
    return chosen[0] if len(chosen) == 1 else tuple(chosen)


def spec_for(axes: tuple, shape: tuple, mesh,
             rules: Optional[dict] = None) -> Spec:
    """The spec of one tensor with these logical axes and shape: each
    logical axis takes the greedy prefix of its rule's unused mesh axes
    whose product divides the dim."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_axes(mesh)
    used: set = set()
    out = []
    for logical, size in zip(axes, shape):
        if logical is None:
            out.append(None)
            continue
        want = [a for a in rules.get(logical, ()) if a not in used
                and a in sizes]
        chosen, prod = [], 1
        for a in want:
            if size % (prod * sizes[a]) == 0:
                chosen.append(a)
                prod *= sizes[a]
        out.append(_entry(chosen))
        used.update(chosen)
    return Spec(*out)


def _map_axes(fn, axes_tree, shape_tree):
    """`fn(axes, leaf)` over a parameter tree (nested dicts)."""
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, shape_tree[k])
                for k, v in axes_tree.items()}
    return fn(axes_tree, shape_tree)


def param_shardings(axes_tree, shape_tree, mesh,
                    rules: Optional[dict] = None):
    """The tree of specs of a parameter tree (or a state of the same
    shapes): `axes_tree` the logical axes (`models.param_axes`), the
    leaves of `shape_tree` anything with a `.shape` (meta tensors)."""
    return _map_axes(lambda ax, leaf: spec_for(ax, tuple(leaf.shape), mesh,
                                               rules),
                     axes_tree, shape_tree)


def batch_spec(mesh, *, batch_size: int) -> Spec:
    """The batch dim's spec: as much DP as divides the global batch."""
    sizes = mesh_axes(mesh)
    chosen, prod = [], 1
    for a in ("pod", "data"):
        if a in sizes and batch_size % (prod * sizes[a]) == 0:
            chosen.append(a)
            prod *= sizes[a]
    return Spec(_entry(chosen))


def model_axis_size(mesh=None) -> int:
    """Size of the mesh's "model" (TP) axis; 1 without a mesh or axis."""
    if mesh is None:
        return 1
    return mesh_axes(mesh).get("model", 1)


def _dim_spec(size: int, sizes: dict, prefer: list, used: set):
    """Greedy: `size` over the first unused axes that divide it."""
    chosen, prod = [], 1
    for a in prefer:
        if a in sizes and a not in used and size % (prod * sizes[a]) == 0:
            chosen.append(a)
            prod *= sizes[a]
    used.update(chosen)
    return _entry(chosen)


def _batch_entry(sizes: dict, size: int):
    """The greedy DP entry of a batch-like dim, and the axes it took."""
    chosen, prod = [], 1
    for a in ("pod", "data"):
        if a in sizes and size > 1 and size % (prod * sizes[a]) == 0:
            chosen.append(a)
            prod *= sizes[a]
    return _entry(chosen), set(chosen)


def kv_cache_spec(shape: tuple, mesh, *, lead: int = 0) -> Spec:
    """The spec of a KV-cache leaf [*lead, B, Hkv, Nmax, *feat]: batch over
    the DP axes, then kv heads over "model" where they divide it, else the
    sequence dim; the trailing feature dim never (no consumer product
    keeps it)."""
    sizes = mesh_axes(mesh)
    entries = [None] * len(shape)
    entries[lead], _ = _batch_entry(sizes, shape[lead])
    tp = sizes.get("model", 1)
    if tp > 1 and len(shape) > lead + 2:
        hkv, nmax = shape[lead + 1], shape[lead + 2]
        if hkv % tp == 0:
            entries[lead + 1] = "model"
        elif nmax % tp == 0:
            entries[lead + 2] = "model"
    return Spec(*entries)


class KVBlock(NamedTuple):
    """The rank's block of a KV cache [B, Hkv, Nmax, ·] under
    `kv_cache_spec` (its "model" entries; the batch rows are the
    caller's): "heads" holds kv heads [r·h, (r+1)·h) whole along the
    timeline, "sequence" every kv head's rows [row0, row0 + rows),
    "whole" the cache whole over "model"."""
    mode: str     # "heads", "sequence" or "whole"
    heads: int    # the rank's kv heads
    rows: int     # its rows of the timeline
    row0: int     # the position of its first row
    index: int    # its "model" index (0 on a mesh given as a mapping)
    size: int     # the "model" size
    nmax: int     # the whole cache's rows


def _model_coord(mesh) -> tuple:
    """({axis: size}, the "model" size, the rank's "model" index) of
    `mesh` (None: the active mesh, if any; index 0 on a mapping)."""
    if mesh is None:
        mesh = active_mesh()
    sizes = {} if mesh is None else mesh_axes(mesh)
    m = sizes.get("model", 1)
    idx = 0 if m == 1 or isinstance(mesh, Mapping) \
        else mesh.get_local_rank("model")
    return sizes, m, idx


def kv_cache_block(hkv: int, nmax: int, mesh=None) -> KVBlock:
    """The rank's block of a KV cache of `hkv` kv heads and `nmax` rows on
    `mesh` (None: the active mesh, if any): kv heads over "model" where
    they divide it, else the rows (the rank of "model" index r holds
    [r·nmax/m, (r+1)·nmax/m)), else whole, as `kv_cache_spec` places
    it."""
    sizes, m, idx = _model_coord(mesh)
    spec = kv_cache_spec((1, hkv, nmax, 1), sizes)
    if spec[1] == "model":
        return KVBlock("heads", hkv // m, nmax, 0, idx, m, nmax)
    if spec[2] == "model":
        return KVBlock("sequence", hkv, nmax // m, idx * (nmax // m), idx,
                       m, nmax)
    return KVBlock("whole", hkv, nmax, 0, idx, m, nmax)


# base ndims of the Moments fields (batch, kv-heads leading): any extra
# leading axes of a state leaf are layer stacking
_MOMENT_NDIM = {"m0": 3, "m1": 4, "m2": 5, "g0": 2, "g1": 3, "g2": 4}


def _moments_mode(hkv, dv, tp: int) -> str:
    """"heads" (Hkv % tp == 0), else "feature" (Dv % tp == 0), else
    "whole": how "model" of size tp splits a Moments state."""
    if tp > 1 and hkv is not None and hkv % tp == 0:
        return "heads"
    if tp > 1 and dv is not None and dv % tp == 0:
        return "feature"
    return "whole"


def _moments_shardings(mom, sizes: dict):
    """Specs of a Moments state, as the reference's sharded kernels place
    it: heads mode (Hkv % tp == 0) the kv-head dim over "model"; feature
    mode (else, Dv % tp == 0) the value dim of m0, m1, m2 over "model",
    the g moments replicated over it."""
    lead = mom[0].ndim - _MOMENT_NDIM["m0"]
    hkv = mom[0].shape[lead + 1] if lead >= 0 else None
    dv = mom[0].shape[-1] if lead >= 0 else None
    mode = _moments_mode(hkv, dv, sizes.get("model", 1))

    def one(name, leaf):
        nd = _MOMENT_NDIM.get(name)
        if nd is None or leaf.ndim < nd:
            return Spec()
        ld = leaf.ndim - nd
        entries = [None] * leaf.ndim
        entries[ld], _ = _batch_entry(sizes, leaf.shape[ld])
        if mode == "heads":
            entries[ld + 1] = "model"
        elif mode == "feature" and name in ("m0", "m1", "m2"):
            entries[-1] = "model"
        return Spec(*entries)

    return type(mom)(*(one(n, leaf) for n, leaf in zip(type(mom)._fields,
                                                        mom)))


class MomentsBlock(NamedTuple):
    """The rank's block of a Moments state [B, Hkv, ...] under
    `_moments_shardings` (its "model" entries; the batch rows are the
    caller's): "heads" holds kv heads [r·h, (r+1)·h), "feature" the value
    columns [r·dv, (r+1)·dv) of m0, m1 and m2 with g0, g1 and g2 whole,
    "whole" the state whole over "model"."""
    mode: str     # "heads", "feature" or "whole"
    heads: int    # the rank's kv heads
    dv: int       # its value columns of m0, m1 and m2
    index: int    # its "model" index (0 on a mesh given as a mapping)
    size: int     # the "model" size


def moments_block(hkv: int, dv: int, mesh=None) -> MomentsBlock:
    """The rank's block of a Moments state of `hkv` kv heads and `dv`
    value columns on `mesh` (None: the active mesh, if any), by the rule
    of `_moments_shardings`."""
    _, m, idx = _model_coord(mesh)
    mode = _moments_mode(hkv, dv, m)
    return MomentsBlock(mode, hkv // m if mode == "heads" else hkv,
                        dv // m if mode == "feature" else dv, idx, m)


def decode_state_shardings(state_shapes, mesh, *, batch: int):
    """Specs of a decode-state tree (`models.decode_state_specs`): a
    `Moments` node as the sharded kernels place it, a `KVCache`'s k, v and
    mask by `kv_cache_spec` (its length replicated), and every other leaf
    (Mamba and xLSTM states) greedily: dim 0 (batch) over the DP axes where
    they divide it, then the last dim and the largest others over the
    remaining axes, "model" first. With batch 1 that gives a feature dim
    ("model", "data"): full feature sharding of a long-context state."""
    from repro_torch.attention.state import KVCache
    from repro_torch.core.fastmax import Moments

    del batch   # the leaves' own batch dims decide, as in the reference
    sizes = mesh_axes(mesh)

    def generic(leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return Spec()
        b_entry, used = _batch_entry(sizes, shape[0])
        order = sorted(range(1, len(shape)),
                       key=lambda i: (0 if i == len(shape) - 1 else 1,
                                      -shape[i]))
        specs = {i: _dim_spec(shape[i], sizes, ["model", "data", "pod"],
                              used) for i in order}
        return Spec(b_entry, *(specs[i] for i in range(1, len(shape))))

    def node(x):
        if x is None:
            return None
        if isinstance(x, Moments):
            return _moments_shardings(x, sizes)
        if isinstance(x, KVCache):
            lead = x.k.ndim - 4
            return KVCache(*(kv_cache_spec(tuple(leaf.shape), sizes,
                                           lead=lead)
                             if name != "length" else Spec()
                             for name, leaf in zip(KVCache._fields, x)))
        if isinstance(x, dict):
            return {k: node(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return type(x)(*(node(v) for v in x))
        return generic(x)

    return node(state_shapes)


def to_placements(spec, mesh, name: str = "") -> tuple:
    """The DTensor placements of a tensor with this spec on `mesh`, one
    per mesh dim in its order: `Shard(d)` on the mesh dims tensor dim d is
    split over, else `Replicate()`. A dim split over several mesh dims
    takes the spec's order, the first named axis the major one, as a
    `PartitionSpec` does: where that is not the mesh's order (("model",
    "data") on a ("data", "model") mesh) a mesh dim processed before a
    more major axis of the spec gets `_StridedShard(d, split_factor=...)`,
    the product of the sizes of those axes. `name` (the leaf) goes into
    the message of a spec naming an axis the mesh lacks."""
    from torch.distributed.tensor import Replicate, Shard
    # a private DTensor placement (torch 2.13): a shard taken within each
    # of split_factor equal parts of the dim, as FSDP2 + TP lays one out
    from torch.distributed.tensor.placement_types import _StridedShard

    sizes = mesh_axes(mesh)
    order = list(sizes)
    placements = [Replicate()] * len(order)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        missing = [a for a in axes if a not in sizes]
        if missing:
            raise ValueError(f"{name or 'leaf'}: spec {tuple(spec)} names "
                             f"{missing}, not in the mesh {tuple(order)}")
        for pos, a in enumerate(axes):
            i = order.index(a)
            sf = math.prod(sizes[b] for b in axes[:pos]
                           if order.index(b) > i)
            placements[i] = (Shard(d) if sf == 1
                             else _StridedShard(d, split_factor=sf))
    return tuple(placements)
