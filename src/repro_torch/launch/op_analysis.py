"""A count of one eager call, op by op — the port's counterpart of
`repro/launch/hlo_analysis.py`.

The reference compiles a step and walks its HLO; the port runs its step
eagerly, so the count is a `TorchDispatchMode` over the call, which sees
every aten op the call dispatches (forward, autograd's backward and the
collectives of `torch.distributed`), on any device: `meta` tensors for the
dry run (`launch/dryrun.py`), CUDA tensors for the same step on the card.
An eager loop is unrolled, so no trip count needs correcting.

Counted per call (`OpCount.result()`):
  * matmul_flops     — `torch.utils.flop_counter`'s counts of the aten ops
                       it knows (mm, bmm, addmm, convolutions, SDPA, ...):
                       2 · prod(out) · prod(contracted), as the reference's
                       dot count
  * kernel_ops,      — the hand-written kernels' launches: each launch the
    kernel_bytes,      wrappers make (CUDA) or would make (meta), with its
    launches           operations and bytes (`kernels.work`), recorded by
                       `kernels.ops` inside this context
  * hbm_bytes        — Σ (operand + output bytes) over the aten ops that
                       move data, plus the kernels' bytes: the reference's
                       proxy at op granularity instead of fusion
                       granularity (an eager op does read and write HBM).
                       Views, aliases, allocations and collectives move no
                       HBM bytes here
  * coll_<kind>,     — operand bytes of each collective (`c10d.*` ops) by
    collective_bytes   the reference's kinds: all-reduce, all-gather,
                       reduce-scatter, all-to-all, collective-permute (a
                       send; its receive is the other rank's send)
  * temp_peak_bytes  — the peak of the bytes of live storages made inside
                       the call on the counted device (tracked by weak
                       reference to each new storage, an op's output that
                       aliases none of its inputs): what the call needs
                       beyond its arguments
  * routes           — the routing lines of the attention and kernel
                       paths the call took (`kernels.ops.note_route`)

`SavedBytes` counts, over the code inside it, the bytes autograd saves
for the backward (`torch.autograd.graph.saved_tensors_hooks`), and of
those the residual stream's block inputs of `models.transformer.forward_lm`
(under remat="full" what each block's checkpoint keeps).

`flops_breakdown(top)` attributes the matmul flops to the innermost
function of `repro_torch` on the Python stack of the op (`file:function`;
the port's models are functions on parameter trees, so this stands in
for XLA's `op_name`); an op autograd's engine runs itself counts as
"<backward> " and its autograd node's name.
"""
from __future__ import annotations

import collections
import os
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCount", "SavedBytes", "COLLECTIVES", "tree_bytes"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d op -> (kind, index of the argument holding what the rank sends);
# a receive is counted as the sender's send
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
    "broadcast_": ("all-gather", 0),
}
# ops that allocate without writing, or only relabel a storage
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_unsafe_view", "set_", "resize_"}

_TENSOR = object()   # marks a tensor's metadata in the meta cache
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF = os.path.abspath(__file__)


def _flatten(tree, out: list) -> list:
    """The leaves of an op's arguments or outputs (tuples, lists, dicts)."""
    if isinstance(tree, (list, tuple)):
        for x in tree:
            _flatten(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _flatten(x, out)
    else:
        out.append(tree)
    return out


def _tensors(tree) -> list:
    return [t for t in _flatten(tree, []) if isinstance(t, torch.Tensor)]


def _key(tree):
    """A hashable description of an op's arguments: each tensor's
    metadata, every other leaf itself (TypeError if one is unhashable)."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.stride(), tree.storage_offset(),
                tree.dtype, tree.device.type)
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_key(x) for x in tree)
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _key(v)) for k, v in tree.items())
    hash(tree)
    return tree


def _extent(t: torch.Tensor) -> int:
    """Bytes `empty_strided` allocates for `t`'s sizes and strides."""
    if t.numel() == 0:
        return 0
    return (1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))) \
        * t.element_size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a tree (dicts, lists, tuples, NamedTuples),
    each storage once."""
    seen, total = set(), 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def _site() -> str:
    """`file:function` of the innermost repro_torch frame on the stack,
    or, for an op autograd's engine runs itself, "<backward> " and its
    node's name (the engine's caller is not the op's site)."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG) and path != _SELF:
            rel = os.path.relpath(path, os.path.dirname(_PKG))
            return f"{rel}:{f.f_code.co_name}"
        if f.f_code.co_name == "_engine_run_backward":
            break
        f = f.f_back
    node = torch._C._current_autograd_node()
    return "<backward> " + (node.name() if node is not None else "?")


class OpCount(TorchDispatchMode):
    """Count the ops a call dispatches; `device_type` ("meta", "cuda")
    is the device whose new storages make the temp peak. With
    `keep_ops`, also the calls, flops and bytes of each aten op
    (`op_table`)."""

    def __init__(self, device_type: str, *, keep_ops: bool = False):
        super().__init__()
        self.device_type = device_type
        self.keep_ops = keep_ops
        self.matmul_flops = 0
        self.aten_bytes = 0
        self.coll = {k: 0 for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self.by_site = collections.Counter()
        self.op_table: dict = {}
        self.record = {"launches": [], "routes": set()}
        self._prior = None
        self._meta_cache: dict = {}

    def __enter__(self):
        from repro_torch.kernels import ops

        self._prior = ops._RECORD
        ops._RECORD = self.record
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops._RECORD = self._prior
        return super().__exit__(*exc)

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _meta_outputs(self, func, args, kwargs):
        """The op's outputs on meta: from the cache of output metadata
        (a functional op's outputs depend only on its arguments'
        metadata), else from its meta kernel, cached when the outputs are
        fresh storages `empty_strided` remakes exactly. Python meta
        kernels take hundreds of microseconds an op; the dry run's steps
        repeat the same ops layer after layer."""
        try:
            key = (func, _key(args), _key(kwargs))
        except TypeError:
            return func(*args, **kwargs)
        hit = self._meta_cache.get(key)
        if hit is not None:
            spec, leaves = hit
            return tree_unflatten(
                [torch.empty_strided(x[1], x[2], dtype=x[3], device="meta")
                 if isinstance(x, tuple) and x and x[0] is _TENSOR else x
                 for x in leaves], spec)
        out = func(*args, **kwargs)
        if func.is_view or func._overloadpacket.__name__.endswith("_") \
                or "out" in kwargs:
            return out
        leaves, spec = tree_flatten(out)
        ins = {id(t.untyped_storage()) for t in _tensors((args, kwargs))}
        seen, meta = set(), []
        for x in leaves:
            if isinstance(x, torch.Tensor):
                st = x.untyped_storage()
                if (x.device.type != "meta" or id(st) in ins
                        or id(st) in seen or x.storage_offset()
                        or st.nbytes() != _extent(x)):
                    return out
                seen.add(id(st))
                meta.append((_TENSOR, tuple(x.shape), x.stride(), x.dtype))
            else:
                meta.append(x)
        self._meta_cache[key] = (spec, meta)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        if self.device_type == "meta" and ns != "c10d":
            out = self._meta_outputs(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
            if flops:
                self.matmul_flops += flops
                self.by_site[_site()] += flops
        nbytes = 0
        if ns == "c10d":
            kind = _C10D.get(name)
            if kind is not None:
                self.coll[kind[0]] += sum(
                    _nbytes(t) for t in _tensors(args[kind[1]]))
            return out
        outs = _tensors(out)
        in_st = {id(t.untyped_storage()) for t in ins}
        fresh = [t for t in outs if id(t.untyped_storage()) not in in_st]
        if name not in _NO_TRAFFIC and (fresh or name.endswith("_")
                                        or "out" in kwargs):
            nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                                        for t in outs)
            self.aten_bytes += nbytes
        seen = set()
        for t in fresh:
            st = t.untyped_storage()
            if t.device.type != self.device_type or id(st) in seen:
                continue
            seen.add(id(st))
            size = st.nbytes()
            self.live += size
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, size)
        if self.keep_ops:
            row = self.op_table.setdefault(str(func), [0, 0, 0])
            row[0] += 1
            row[1] += flops
            row[2] += nbytes
        return out

    def launches(self) -> dict:
        """Launches per kernel."""
        return dict(collections.Counter(r["kernel"]
                                        for r in self.record["launches"]))

    def kernel_work(self) -> dict:
        """Per kernel: launches, operations and bytes summed."""
        out: dict = {}
        for r in self.record["launches"]:
            w = out.setdefault(r["kernel"], {"launches": 0, "ops": 0,
                                             "bytes": 0})
            w["launches"] += 1
            w["ops"] += r["ops"]
            w["bytes"] += r["bytes"]
        return out

    def result(self) -> dict:
        kops = sum(r["ops"] for r in self.record["launches"])
        kbytes = sum(r["bytes"] for r in self.record["launches"])
        out = {"matmul_flops": float(self.matmul_flops),
               "kernel_ops": float(kops),
               "kernel_bytes": float(kbytes),
               "hbm_bytes": float(self.aten_bytes + kbytes),
               **{f"coll_{k}": float(v) for k, v in self.coll.items()},
               "collective_bytes": float(sum(self.coll.values())),
               "temp_peak_bytes": float(self.peak)}
        return out

    def routes(self) -> list:
        return sorted(self.record["routes"])

    def flops_breakdown(self, top: int = 25) -> list:
        """[(site, matmul flops)] largest first."""
        return self.by_site.most_common(top)


class SavedBytes:
    """The bytes autograd saves for the backward inside the block, each
    saved tensor once (its own elements, not its storage's): `total`,
    and of those `block_inputs`, the tensors `models.transformer.
    forward_lm` hands its blocks (the residual stream between blocks:
    what a block's checkpoint keeps under remat="full"). A checkpointed
    region's own saves are the checkpoint's (its hooks take them) and
    are not counted; the recompute in the backward saves nothing here.
    Counting makes every save go through Python: time a step without
    it."""

    def __init__(self):
        self.total = 0
        self.block_inputs = 0
        # id -> weak reference: the tensors saved, the blocks' inputs and
        # those counted as both
        self._saved: dict = {}
        self._inputs: dict = {}
        self._both: dict = {}

    def __enter__(self):
        from repro_torch.models import transformer

        self._module, self._block = transformer, transformer._train_block

        def block(params_b, x, *args, **kwargs):
            # a checkpoint saves its inputs before it calls the block
            self._inputs[id(x)] = weakref.ref(x)
            self._count_input(x)
            return self._block(params_b, x, *args, **kwargs)

        transformer._train_block = block
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t)
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self._hooks.__exit__(*exc)
        self._module._train_block = self._block
        for refs in (self._saved, self._inputs, self._both):
            refs.clear()

    @staticmethod
    def _has(refs: dict, t) -> bool:
        ref = refs.get(id(t))
        return ref is not None and ref() is t

    def _count_input(self, t) -> None:
        if (self._has(self._saved, t) and self._has(self._inputs, t)
                and not self._has(self._both, t)):
            self._both[id(t)] = weakref.ref(t)
            self.block_inputs += t.numel() * t.element_size()

    def _pack(self, t):
        if not self._has(self._saved, t):
            self._saved[id(t)] = weakref.ref(t)
            self.total += t.numel() * t.element_size()
            self._count_input(t)
        return t
