"""The placed state: each rank holds only its shard of the parameters,
their grads and the optimizer state — the port's counterpart of the
reference's partitioned step (`repro/launch/dryrun.py`: `jax.jit(step,
in_shardings=(param_sh, opt_sh, batch_sh), out_shardings=(param_sh,
opt_sh, None))`, GSPMD splitting the compute around it).

A leaf's shard is the one its spec gives: `models.param_axes(cfg)` ->
`rules.param_shardings` (DEFAULT_RULES: the "embed" dim over "data",
FSDP; heads, kv heads, ff, vocab and experts over "model") ->
`rules.to_placements`. A shard is a plain local tensor with its spec
recorded on it (`spec_of`); `place` cuts a whole tree into the rank's
shards and `full` gathers them back (tests, checkpoints). AdamW's m, v
and float32 master and Lion's m are made from the shards (their update is
elementwise); the optimizer's step stays replicated, as the reference's
`_opt_shardings` has it. AdamW's `int8_m` takes absmax blocks over the
whole flattened leaf, so a shard's blocks are not the reference's: the
placed step refuses it.

Around its use, a layer's leaves are gathered (`materialize`), one layer
at a time (a stacked leaf's row of the layer is sliced out of the local
shard first) and again in the layer's recompute under remat:
  * over the data axes of their spec ("pod", "data"): the backward
    reduce-scatters their grads over the axes the batch is split on
    (the FSDP grad path) and keeps the rank's slice over the others;
  * over "model" too, except in a tensor-parallel block. The compute is
    then whole on every rank, so the backward keeps the rank's slice.
A leaf that an axis of the batch does not split stays replicated there:
`reduce_grads` all-reduces its grad over those axes after the backward.

Expert parallelism over "model" (`Placement.ep`: configs with routed
experts, `models.moe`) keeps the routed experts' "model" shards (each
rank runs its experts, one expert's slice gathered over the data axes at
a time: `weight`, `weight_grad`) and splits the FFNs (the MLP blocks, the
shared experts), the attention mixers (GQA and MLA, by heads), the
embedding lookup and the logits by their "model" shards as `tp` does
(`leaf(t, split=True)`). The router's statistics are the whole batch's:
each rank's per-expert counts are all-gathered over the batch axes in
the order of the global rows (`expert_rows`).

The SSM mixers over "model" (`Placement.ssm`: configs with Mamba, mLSTM
or sLSTM layers, jamba and xlstm) keep their "ff" and "heads" shards and
split their compute by them (`models.mamba`, `models.xlstm`), and the
embedding lookup and the logits go vocab-parallel. Their input
projections (in_proj, up_proj: [xi | z] split contiguously over
"model") reach the rank's channels of both halves by one all-to-all of
the weight shard (`halves`: each rank sends its two halves of blocks to
the ranks that compute them; the backward sends the grads back). A
row-parallel product whose output feeds the rank's channels only
(Mamba's x_proj, xLSTM's gate projections) is summed over "model" in
the forward and its grad in the backward (`psum`). Where one xLSTM head
spans several "model" ranks the head's ranks form a group of their own
(`head_group`) for the head's whole input (`gather_sum`) and its norm.

Tensor parallelism over "model" (`Placement.tp`: the dense "attn:mlp"
decoders and both towers of whisper) keeps the "model" shards that the
spec gives and splits the compute by them (`models.layers`):
column-parallel projections take `tp_enter(x)` (identity, all-reduce of
the grad over "model"), the row-parallel output goes through `tp_exit`
(all-reduce, identity grad), vocab-parallel embedding lookup
(`embed_lookup`) and logits, and a vocab-parallel cross-entropy
(`token_nll`) whose max and sums are all-reduced over "model": no rank
builds a whole [B, N, vocab] row. A replicated leaf or input used on the
rank's heads only (qk_norm's scales; the encoder's output that a
cross-attention's k and v are projected from) takes `sum_grad`, so that
every model rank ends with the same grad. Which leaves are split the
layers read off the specs recorded on the gathered leaves (`model_dim`):
heads that do not divide "model" stay whole (whisper's 12 on 16), and
such a layer is computed whole on every model rank.

The residual stream between blocks (Megatron-style sequence
parallelism, the reference's `maybe_constraint(x, ("pod", "data"),
"model", None)` in `forward_lm`): under a placement whose "model" axis
is larger than 1 and divides the sequence (`splits_sequence`), the
training forward holds x as the rank's rows × its 1/model slice of the
sequence × d (`sequence_split`, `seq_split`; serving never sets it, and
where "model" does not divide N the rows stay whole, as the reference's
constraint applies an axis only where it divides the dim). There
`tp_enter` is an all-gather of the sequence (dim 1) whose backward
reduce-scatters the rank's partial grads (`_GatherSum`), and `tp_exit` a
reduce-scatter of the row-parallel output whose backward all-gathers
(`_SeqExit`): a tensor-parallel block's forward asks for no all-reduce
of activations over "model". The vocab-parallel embedding lookup ends in
that reduce-scatter; a whole-vocab lookup, and a layer computed whole on
every model rank, take the slice of a whole tensor (`seq_slice`:
`SliceModel`) or gather it (`seq_gather`: `GatherModel`) on dim 1. A
replicated leaf used on the slice (the norms' scales) takes `on_slice`:
its partial grad summed over "model".

Context parallelism ("seq" > 1, `launch/train.py --cp`): each rank holds
its token shard of its rows, and "seq" is one of the batch axes, so
every leaf's grad is summed over it (`reduce_grads`, and `gather`'s
reduce-scatter over the data axes beside it). A mixer with a seq plan
(`kernels.sharded`) runs on the shard; every other one, and the MoE,
needs the whole sequence, as the reference's GSPMD gathers it there:
`cp_enter` all-gathers the sequence (dim 1) over "seq" in rank order and
reduce-scatters the grad, `cp_exit` keeps the rank's rows of the output
and zero-pads their grad. The layer between them is computed whole on
every seq rank, but its output's grad is the rank's rows' only, so each
rank's parameter grads are its rows' share and the sum over "seq" makes
them whole. (The "model" split's `seq_gather` / `seq_slice` pair keeps
the slice's grad and gathers the slices' grads: there every rank's grads
would be whole, and the sum over "seq" would count them `cp` times.)
Under remat the recompute gathers again: every gather, its backward's
reduce-scatter and the recompute's gather go through `_collective` and
are counted in `asked`.

Every collective goes through `_collective`, which adds the bytes the
rank sends to `asked[kind]` and the host time to `asked_ms[kind]` by the
kind the step asked for. On gloo (ranks sharing one card, or the CPU)
each is staged through one all-reduce in host memory (`_gloo`), but an
all-to-all, which gloo runs on host tensors itself; the count is still
the collective asked for, and the dry run's fake group takes the
collective itself.
"""
from __future__ import annotations

import collections
import contextlib
import math
import time

import torch
import torch.distributed as dist

from repro_torch.optim.grad_utils import leaves, tree_map
from repro_torch.sharding.rules import (Spec, batch_spec, mesh_axes,
                                        param_shardings)

__all__ = ["Placement", "place", "full", "gather", "spec_of", "tag",
           "model_dim", "leaf", "unbind",
           "active", "materialize", "tensor_parallel", "expert_parallel",
           "ssm_parallel", "ssm_model_size", "shard_batch", "halves",
           "psum", "gather_sum", "head_group",
           "tp_enter", "tp_exit", "sum_grad", "embed_lookup", "token_nll",
           "gather_vocab", "gather_model", "slice_model", "global_norm",
           "splits_sequence", "sequence_split", "seq_split", "seq_gather",
           "seq_slice", "seq_len", "seq_start", "on_slice",
           "cp_size", "cp_enter", "cp_exit",
           "asked", "asked_ms", "reset_asked"]

_F32 = torch.float32
KNOWN_AXES = ("pod", "data", "model", "seq")
DATA_AXES = ("pod", "data")
_ATTR = "_placed_spec"

# bytes each rank sent, and host ms, of the collectives the placed step
# asked for, by kind
asked: collections.Counter = collections.Counter()
asked_ms: collections.Counter = collections.Counter()


def reset_asked() -> None:
    asked.clear()
    asked_ms.clear()


def spec_of(t):
    """The spec recorded on a placed leaf, or None."""
    return getattr(t, _ATTR, None)


def tag(t: torch.Tensor, spec) -> torch.Tensor:
    """Record `spec` on `t` as its placement (returns `t`)."""
    setattr(t, _ATTR, Spec(*spec))
    return t


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def split_axes(spec) -> tuple:
    """The mesh axes a leaf with this spec is split over."""
    return tuple(a for e in spec for a in _names(e))


def model_dim(t):
    """The dim of a placed (or gathered) leaf that is split over "model",
    or None (not placed, or whole on "model")."""
    spec = spec_of(t)
    if spec is None:
        return None
    for d, e in enumerate(spec):
        if "model" in _names(e):
            return d
    return None


def tensor_parallel(cfg) -> bool:
    """Whether the placed step splits all of `cfg`'s compute over "model":
    every block an "attn:mlp" of GQA attention — the dense decoders, and
    both towers of an encoder-decoder model (whisper; its encoder's
    `encoder_config` too), the decoder's cross-attention included. The
    MoE configs split their experts, FFNs, attention mixers and vocab
    (`expert_parallel`), the SSM configs their mixers and vocab
    (`ssm_parallel`)."""
    return (tuple(cfg.pattern) == ("attn:mlp",) and cfg.first_k_dense == 0
            and not cfg.use_mla)


def expert_parallel(cfg) -> bool:
    """Whether `cfg` has routed experts, which the placed step splits over
    "model" (`models.moe`), beside the consumers that split their compute
    by their "model" shards (`Placement.leaf(t, split=True)`: the FFNs,
    the attention mixers, the embedding and the logits)."""
    return any(k.split(":")[1] == "moe" for k in cfg.pattern) \
        and cfg.n_layers_scanned > 0


SSM_MIXERS = ("mamba", "mlstm", "slstm")


def ssm_parallel(cfg) -> bool:
    """Whether `cfg` has SSM mixers (Mamba, mLSTM, sLSTM), which the
    placed step splits over "model" by their "ff" and "heads" shards
    (`models.mamba`, `models.xlstm`), beside a vocab-parallel embedding
    lookup and logits (`Placement.leaf(t, split=True)`)."""
    return any(k.split(":")[0] in SSM_MIXERS for k in cfg.pattern) \
        and cfg.n_layers_scanned > 0


def ssm_model_size(cfg) -> int:
    """The "model" size of the active mesh (`rules.use_mesh`) where it
    splits `cfg`'s SSM mixers, else 1: the decode state a rank holds is
    its slice of theirs (`models.transformer.init_lm_decode_state`)."""
    from repro_torch.sharding.rules import active_mesh

    mesh = active_mesh()
    m = 1 if mesh is None else mesh_axes(mesh).get("model", 1)
    return m if ssm_parallel(cfg) else 1


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _collective(kind: str, x: torch.Tensor, group, *, op=None,
                splits=None):
    """One collective over `group` of what the rank sends, `x`:
    all-reduce (on a copy; `op` a ReduceOp), all-gather along dim 0,
    reduce-scatter along dim 0 or all-to-all along dim 0 (`splits`: the
    rows received from and sent to each rank). Returns the result."""
    asked[kind] += x.numel() * x.element_size()
    t0 = time.perf_counter()
    if kind == "all-to-all":
        out = _all_to_all(x, group, *splits)
    elif dist.get_backend(group) == "gloo":
        out = _gloo(kind, x, group, op)
    elif kind == "all-reduce":
        out = x.clone()
        dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    elif kind == "all-gather":
        out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                          + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    elif kind == "reduce-scatter":
        out = x.new_empty((x.shape[0] // dist.get_world_size(group),)
                          + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    else:
        raise ValueError(kind)
    asked_ms[kind] += (time.perf_counter() - t0) * 1e3
    return out


def _gloo(kind: str, x: torch.Tensor, group, op):
    """`_collective` on gloo, staged through one all-reduce in host
    memory: gloo sends no CUDA tensor in its all-gather and
    reduce-scatter, and its all-reduce is its fastest collective (on two
    local ranks 2x its all-gather's rate for the same result). An
    all-gather all-reduces the rank's rows placed in zeros (exact); a
    reduce-scatter keeps the rank's rows of the sum."""
    n, idx = dist.get_world_size(group), dist.get_group_rank(
        group, dist.get_rank())
    src = x.detach().to("cpu").contiguous()
    if kind == "all-gather":
        buf = src.new_zeros((n * src.shape[0],) + tuple(src.shape[1:]))
        buf[idx * src.shape[0]:(idx + 1) * src.shape[0]].copy_(src)
    elif kind in ("all-reduce", "reduce-scatter"):
        buf = src.clone() if src.data_ptr() == x.data_ptr() else src
    else:
        raise ValueError(kind)
    dist.all_reduce(buf, op=op or dist.ReduceOp.SUM, group=group)
    if kind == "reduce-scatter":
        rows = src.shape[0] // n
        buf = buf[idx * rows:(idx + 1) * rows]
    return buf.to(x.device)


def _all_to_all(x, group, recv: list, send: list):
    """`all_to_all_single` of x's rows: send[r] rows to rank r, recv[r]
    from it, in rank order. On gloo through host memory (gloo sends no
    CUDA tensor)."""
    src = x.contiguous()
    if dist.get_backend(group) == "gloo":
        src = src.to("cpu")
    out = src.new_empty((sum(recv),) + tuple(src.shape[1:]))
    dist.all_to_all_single(out, src, recv, send, group=group)
    return out.to(x.device)


def _permute_blocks(x, dim: int, to: list, frm: list, group):
    """x cut into len(to) equal blocks along `dim`, block i sent to rank
    to[i] of `group`; returns the blocks received from frm[0], frm[1], …
    concatenated in that order (one all-to-all; the entries of `to` and
    of `frm` are distinct)."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0)
    size = xt.shape[0] // len(to)
    blocks = xt.split(size)
    send = [0] * n
    for r in to:
        send[r] = size
    recv = [0] * n
    for r in frm:
        recv[r] = size
    order = sorted(range(len(to)), key=lambda i: to[i])
    out = _collective("all-to-all", torch.cat([blocks[i] for i in order]),
                      group, splits=(recv, send))
    got = dict(zip(sorted(frm), out.split(size)))
    return torch.cat([got[r] for r in frm]).movedim(0, dim)


def _halves_ranks(idx: int, n: int) -> tuple:
    """(to, frm) of `halves` on model rank idx of n: its shard holds
    blocks 2·idx and 2·idx + 1 of the 2n blocks of [A | B] (A's block b
    computed on rank b, B's on rank b); it receives A's block idx and
    B's block idx from their holders."""
    return [(2 * idx + i) % n for i in (0, 1)], [idx // 2, (n + idx) // 2]


class _Halves(torch.autograd.Function):
    """The rank's contiguous 1/n of [A | B] along `dim` -> [A_idx |
    B_idx]; the backward sends the grads' blocks back."""

    @staticmethod
    def forward(ctx, x, dim, group, idx, n):
        to, frm = _halves_ranks(idx, n)
        ctx.cfg = (dim, group, to, frm)
        return _permute_blocks(x, dim, to, frm, group)

    @staticmethod
    def backward(ctx, g):
        dim, group, to, frm = ctx.cfg
        return _permute_blocks(g, dim, frm, to, group), None, None, None, \
            None


def _gather_dim(x, d: int, group):
    out = _collective("all-gather", x.movedim(d, 0), group)
    return out.movedim(0, d).contiguous() if d else out


def _scatter_dim(g, d: int, group):
    out = _collective("reduce-scatter", g.movedim(d, 0), group)
    return out.movedim(0, d).contiguous() if d else out


def _slice_dim(g, d: int, idx: int, n: int):
    size = g.shape[d] // n
    return g.narrow(d, idx * size, size).contiguous()


def _order(spec, over) -> list:
    """[(dim, axis)] to gather, minor axis of each dim first (a dim split
    over (a, b) holds chunk i_a·|b| + i_b)."""
    out = []
    for d, e in enumerate(spec):
        for a in reversed(_names(e)):
            if a in over:
                out.append((d, a))
    return out


def _rest(spec, gathered) -> Spec:
    """The spec left after gathering the (dim, axis) pairs."""
    done = set(gathered)
    ents = []
    for d, e in enumerate(spec):
        left = tuple(a for a in _names(e) if (d, a) not in done)
        ents.append(None if not left else left[0] if len(left) == 1
                    else left)
    return Spec(*ents)


def _gather_grad(g, mesh, order, sum_over):
    """The grad of a shard from the grad `g` of its gather over `order`:
    reduce-scattered over the axes in `sum_over`, the rank's slice over
    the others."""
    sizes = mesh_axes(mesh)
    for d, a in reversed(order):
        if a in sum_over:
            g = _scatter_dim(g, d, mesh.get_group(a))
        else:
            g = _slice_dim(g, d, mesh.get_local_rank(a), sizes[a])
    return g


class _Gather(torch.autograd.Function):
    """Gather a shard over mesh axes; the backward is `_gather_grad`."""

    @staticmethod
    def forward(ctx, x, mesh, order, sum_over):
        ctx.cfg = (mesh, order, sum_over)
        for d, a in order:
            x = _gather_dim(x, d, mesh.get_group(a))
        return x

    @staticmethod
    def backward(ctx, g):
        return _gather_grad(g, *ctx.cfg), None, None, None


def gather(leaf: torch.Tensor, over, mesh, *, sum_over=()):
    """`leaf` (a placed shard) gathered over the mesh axes `over` of its
    spec, `all_gather_into_tensor` on each axis's sub-group; the backward
    is a `reduce_scatter_tensor` over the axes of `sum_over` (those the
    batch is split on: the FSDP grad path) and the rank's slice over the
    rest. The result carries the spec that is left."""
    spec = spec_of(leaf)
    order = _order(spec, tuple(over))
    if not order:
        return leaf
    out = _Gather.apply(leaf, mesh, order, tuple(sum_over))
    return tag(out, _rest(spec, order))


class SumGrad(torch.autograd.Function):
    """Identity; the backward all-reduces the grad over `group` (also
    the kernel plans' feature-mode dq and dk, `kernels.sharded`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _collective("all-reduce", g, ctx.group), None


class _Exit(torch.autograd.Function):
    """All-reduce over `group`; the backward passes the grad through."""

    @staticmethod
    def forward(ctx, x, group):
        return _collective("all-reduce", x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherModel(torch.autograd.Function):
    """The rank's slice of `dim` over "model" -> the whole tensor; the
    backward keeps the slice's grad (the whole grad is the same on every
    model rank)."""

    @staticmethod
    def forward(ctx, x, dim, group, idx, n):
        ctx.cfg = (dim, idx, n)
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, idx, n = ctx.cfg
        return _slice_dim(g, dim, idx, n), None, None, None, None


class SliceModel(torch.autograd.Function):
    """A whole tensor (the same on every model rank) -> the rank's slice
    of `dim`; the backward gathers the slices' grads."""

    @staticmethod
    def forward(ctx, x, dim, group, idx, n):
        ctx.cfg = (dim, group)
        return _slice_dim(x, dim, idx, n)

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.cfg
        return _gather_dim(g, dim, group), None, None, None, None


class _GatherSum(torch.autograd.Function):
    """The rank's slice of `dim` -> whole, all-gathered over `group`; the
    backward reduce-scatters the rank's partial grad (the entry of a
    tensor-parallel region under the sequence split, dim 1; a head's
    whole input on its ranks)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.cfg = (dim, group)
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.cfg
        return _scatter_dim(g, dim, group), None, None


class _SeqShard(torch.autograd.Function):
    """The whole sequence (dim 1) -> the rank's token shard `idx` of `n`;
    the backward zero-pads the shard's grad to the whole sequence (the
    exit of a layer computed whole on every "seq" rank)."""

    @staticmethod
    def forward(ctx, y, idx, n):
        ctx.cfg = (idx, y.shape[1])
        return _slice_dim(y, 1, idx, n)

    @staticmethod
    def backward(ctx, g):
        idx, whole = ctx.cfg
        out = g.new_zeros(g.shape[:1] + (whole,) + g.shape[2:])
        out.narrow(1, idx * g.shape[1], g.shape[1]).copy_(g)
        return out, None, None


class _Psum(torch.autograd.Function):
    """A partial sum -> the whole sum over `group`, for consumers split
    over the group: the backward sums their partial grads too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _collective("all-reduce", x, group)

    @staticmethod
    def backward(ctx, g):
        return _collective("all-reduce", g, ctx.group), None


class _SeqExit(torch.autograd.Function):
    """A partial sum over `group` -> the rank's slice of the sequence of
    the whole sum (reduce-scatter on dim 1); the backward all-gathers."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _scatter_dim(y, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, 1, ctx.group), None


# ---------------------------------------------------------------------------
# The placement of one model on one mesh
# ---------------------------------------------------------------------------


_ACTIVE = []


def active():
    """The placement the running step activated, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _pairs(tree, specs):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    else:
        yield tree, specs


class Placement:
    """`cfg`'s parameters on `mesh` under the reference's rules: the specs
    (`specs`, a tree like the parameters'), whether the compute is split
    over "model" (`tp`), and the axes a training batch is split on
    (`batch_axes`: the reference's `batch_spec` of `global_batch` — "pod"
    and "data" as far as they divide it; all of them without one — and
    "seq" under context parallelism). A mesh axis the rules do not know
    raises."""

    def __init__(self, cfg, mesh, rules=None, global_batch=None):
        from repro_torch.models import init_model

        sizes = mesh_axes(mesh)
        unknown = [a for a in sizes if a not in KNOWN_AXES]
        if unknown:
            raise ValueError(
                f"the placed step knows the mesh axes {KNOWN_AXES}; the "
                f"mesh has {unknown}, which no placement rule names")
        self.cfg, self.mesh, self.sizes = cfg, mesh, sizes
        shapes, self.axes = init_model(cfg, device="meta", with_axes=True)
        self.specs = param_shardings(self.axes, shapes, mesh, rules)
        self.tp = tensor_parallel(cfg) and sizes.get("model", 1) > 1
        self.ep = expert_parallel(cfg) and sizes.get("model", 1) > 1
        self.ssm = ssm_parallel(cfg) and sizes.get("model", 1) > 1
        # the running forward holds the residual's slice of the sequence
        # over "model" (`sequence_split`)
        self.sp = False
        dp = DATA_AXES
        if global_batch is not None:
            dp = _names(batch_spec(mesh, batch_size=global_batch)[0])
        self.batch_axes = tuple(a for a in DATA_AXES + ("seq",)
                                if sizes.get(a, 1) > 1
                                and (a in dp or a == "seq"))

    @contextlib.contextmanager
    def active(self):
        """Activate the placement for the model code inside the block."""
        _ACTIVE.append(self)
        try:
            yield self
        finally:
            _ACTIVE.pop()

    # -- the state ---------------------------------------------------------

    def place(self, tree):
        """The rank's shards of a whole parameter tree, specs recorded."""
        from repro_torch.kernels.sharded import shard_local

        return _place(tree, self.specs, self.mesh, shard_local)

    def init_opt_state(self, opt_init, params):
        """The optimizer state of placed `params` (m, v and master are
        shards of the same specs; the step is replicated). AdamW's int8 m
        raises (its absmax blocks span the whole leaf)."""
        state = opt_init(params)
        refuse_int8(params, state)
        for sub in (state.m, state.v, state.master):
            if sub is not None:
                for x, ref in _pairs(sub, params):
                    tag(x, spec_of(ref))
        return state

    def row_axes(self) -> tuple:
        """The batch axes that split the rows: `batch_axes` but "seq"."""
        return tuple(a for a in self.batch_axes if a != "seq")

    def row_ranks(self) -> int:
        """The number of rank groups holding distinct rows."""
        return math.prod(self.sizes[a] for a in self.row_axes())

    # -- around a layer ----------------------------------------------------

    def _over(self, spec, keep=None) -> list:
        return [a for a in split_axes(spec)
                if a != keep and self.sizes[a] > 1]

    def leaf(self, t, split: bool = False):
        """A placed leaf gathered for its use (see the module docstring);
        anything else as it is. The result's spec keeps only a "model"
        split that the tensor-parallel compute uses: every leaf's under
        `tp`, under `ep` or `ssm` those of a consumer that splits its
        compute by it (`split`: the FFNs, the mixers, the embedding and
        the logits)."""
        spec = spec_of(t)
        if spec is None:
            return t
        keep = "model" if self.tp or (split and (self.ep or self.ssm)) \
            else None
        over = self._over(spec, keep)
        out = gather(t, over, self.mesh, sum_over=self.batch_axes)
        if out is t:
            out = t.view_as(t)
        return tag(out, Spec(*(keep if keep in _names(e) else None
                                for e in spec)))

    def weight(self, t):
        """A placed slice gathered whole, called where autograd records
        nothing (an expert's weights inside its own forward and backward,
        `models.moe`)."""
        return gather(t, self._over(spec_of(t)), self.mesh)

    def weight_grad(self, g, t):
        """The grad of the placed slice `t` from the grad `g` of
        `weight(t)`: the gather's backward, reduce-scattered over the
        batch axes."""
        spec = spec_of(t)
        return _gather_grad(g, self.mesh, _order(spec, self._over(spec)),
                            self.batch_axes)

    def expert_rows(self, counts):
        """([R, E] each batch rank's `counts` [E] in the order of its rows
        of the global batch, this rank's index in it): one all-gather
        over the axes that split the rows (`row_axes`), minor axis first
        (`shard_batch`'s order). The MoE's tokens are whole sequences:
        under "seq" it gathers its input's sequence (`cp_enter`), so every
        seq rank of a data rank holds that data rank's rows, and "seq" is
        left out."""
        axes = self.row_axes()
        x, r = counts[None], 0
        for a in reversed(axes):
            x = _gather_dim(x, 0, self.mesh.get_group(a))
        for a in axes:
            r = r * self.sizes[a] + self.mesh.get_local_rank(a)
        return x, r

    def reduce_grads(self, grads) -> None:
        """All-reduce, in place, each leaf's grad over the axes the batch
        is split on and the leaf is not: flat buffers of at most
        `REDUCE_BUCKET` bytes per (axis, dtype), a larger leaf cut into
        pieces of that size (a whole-model buffer would double the
        grads' memory: 15 GB for jamba's first two layers under "seq")."""
        from torch._utils import (_flatten_dense_tensors,
                                  _unflatten_dense_tensors)

        for a in self.batch_axes:
            by_dtype: dict = {}
            for _, g in leaves(grads):
                if a not in split_axes(spec_of(g) or ()):
                    by_dtype.setdefault(g.dtype, []).append(g)
            for xs in by_dtype.values():
                for bucket in _buckets(xs, REDUCE_BUCKET):
                    flat = _collective("all-reduce",
                                       _flatten_dense_tensors(bucket),
                                       self.mesh.get_group(a))
                    for x, y in zip(bucket,
                                    _unflatten_dense_tensors(flat, bucket)):
                        x.copy_(y)

    def sum_over_batch(self, x):
        """x summed over the axes the batch is split on."""
        for a in self.batch_axes:
            x = _collective("all-reduce", x, self.mesh.get_group(a))
        return x

    def model(self):
        """(group, index, size) of the "model" axis."""
        return (self.mesh.get_group("model"),
                self.mesh.get_local_rank("model"), self.sizes["model"])

    def head_group(self, k: int):
        """(group, index in it) of the k consecutive "model" ranks around
        this one (k divides "model"): one head's ranks. Every rank makes
        every such group of the mesh once, in one order (`new_group` is
        collective over the world), kept on the mesh; (None, 0) for
        k = 1."""
        if k == 1:
            return None, 0
        made = self.mesh.__dict__.setdefault("_head_groups", {})
        if k not in made:
            names = list(self.mesh.mesh_dim_names)
            ranks = self.mesh.mesh.movedim(names.index("model"), -1)
            me = dist.get_rank()
            for row in ranks.reshape(-1, k).tolist():
                g = dist.new_group(row)
                if me in row:
                    made[k] = g
        return made[k], self.mesh.get_local_rank("model") % k


# bytes of one all-reduce of `Placement.reduce_grads`
REDUCE_BUCKET = 256 * 1024 * 1024


def _buckets(xs, limit: int) -> list:
    """`xs` (tensors of one dtype) in lists of at most `limit` bytes, in
    order; a contiguous tensor larger than that cut into views of it."""
    out, cur, size = [], [], 0
    for x in xs:
        pieces = [x]
        if x.numel() * x.element_size() > limit and x.is_contiguous():
            pieces = list(x.view(-1).split(max(1, limit // x.element_size())))
        for piece in pieces:
            b = piece.numel() * piece.element_size()
            if cur and size + b > limit:
                out.append(cur)
                cur, size = [], 0
            cur.append(piece)
            size += b
    return out + [cur] if cur else out


def _place(tree, specs, mesh, shard_local):
    if isinstance(tree, dict):
        return {k: _place(v, specs[k], mesh, shard_local)
                for k, v in tree.items()}
    return tag(shard_local(tree.detach(), specs, mesh), specs)


def place(tree, axes, mesh, rules=None):
    """The rank's shards of the whole tree `tree` whose logical axes are
    `axes` (`models.param_axes`), each with its spec recorded."""
    from repro_torch.kernels.sharded import shard_local

    specs = param_shardings(axes, tree, mesh, rules)
    return _place(tree, specs, mesh, shard_local)


def full_leaf(t: torch.Tensor, mesh) -> torch.Tensor:
    """The whole tensor of a placed shard, on every rank (no grad)."""
    spec = spec_of(t)
    if spec is None:
        return t
    sizes = mesh_axes(mesh)
    with torch.no_grad():
        x = t
        for d, a in _order(spec, [a for a in split_axes(spec)
                                  if sizes[a] > 1]):
            x = _gather_dim(x, d, mesh.get_group(a))
    return x


def full(tree, mesh):
    """Every placed leaf of a tree (dicts, tuples, NamedTuples; None kept)
    gathered whole on every rank; collective: every rank calls it."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: full(v, mesh) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [full(v, mesh) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return full_leaf(tree, mesh)


def refuse_int8(params, state) -> None:
    """Raise if `state` is AdamW's int8 m (a {"q", "s"} dict per leaf)."""
    from repro_torch.optim.optimizers import _zip

    if state.m is not None and any(isinstance(m, dict) for _, _, m in
                                   _zip(params, state.m)):
        raise ValueError(
            "the placed step cannot update AdamW's int8 m: its absmax "
            "blocks run over the whole flattened leaf, so a shard's blocks "
            "are not the reference's; use adamw (float32 m) or lion")


# ---------------------------------------------------------------------------
# In the model's code (no-ops without an active placement)
# ---------------------------------------------------------------------------


def materialize(tree, split: bool = False):
    """A layer's parameter subtree with every placed leaf gathered for its
    use (`Placement.leaf`); without an active placement, `tree`."""
    pl = active()
    return tree if pl is None else tree_map(lambda t: pl.leaf(t, split),
                                            tree)


def leaf(t, split: bool = False):
    pl = active()
    return t if pl is None else pl.leaf(t, split)


def unbind(t) -> list:
    """Views of `t` along dim 0; a placed leaf's views carry its spec
    without that dim."""
    views = list(t.unbind(0))
    spec = spec_of(t)
    if spec is not None:
        for v in views:
            tag(v, spec[1:])
    return views


def splits_sequence(n: int) -> bool:
    """Whether a training forward of `n` tokens a row holds its residual
    split over "model" (`sequence_split`): an active placement whose
    "model" axis is larger than 1 and divides n."""
    pl = active()
    m = 1 if pl is None else pl.sizes.get("model", 1)
    return m > 1 and n % m == 0


@contextlib.contextmanager
def sequence_split(on: bool):
    """The code inside holds the residual stream as the rank's slice of
    the sequence over "model" (`on`), or whole; without an active
    placement a no-op."""
    pl = active()
    if pl is None:
        yield
        return
    prev, pl.sp = pl.sp, bool(on)
    try:
        yield
    finally:
        pl.sp = prev


def seq_split() -> bool:
    """Whether the running forward holds the sequence split over "model"."""
    pl = active()
    return pl is not None and pl.sp


def seq_gather(x):
    """Under the sequence split, the rank's slice of dim 1 -> whole, for
    a layer computed whole on every model rank (the backward keeps the
    slice's grad); else x."""
    return gather_model(x, 1) if seq_split() else x


def seq_slice(x):
    """Under the sequence split, a whole tensor (the same on every model
    rank) -> the rank's slice of dim 1 (the backward gathers the slices'
    grads); else x."""
    return slice_model(x, 1) if seq_split() else x


def seq_len(n_local: int) -> int:
    """The whole sequence's length from the rank's slice of `n_local`
    tokens under the sequence split; n_local else."""
    return n_local * active().sizes["model"] if seq_split() else n_local


def seq_start(n_local: int) -> int:
    """The first position of the rank's slice of `n_local` tokens under
    the sequence split; 0 else."""
    return active().model()[1] * n_local if seq_split() else 0


def on_slice(tree):
    """Replicated leaves used on the rank's slice of the sequence (the
    norms' scales): under the sequence split each one's partial grad is
    summed over "model"; else `tree`."""
    if not seq_split():
        return tree
    return tree_map(sum_grad, tree)


def cp_size() -> int:
    """The "seq" size of the active placement (context parallelism); 1
    without one."""
    pl = active()
    return 1 if pl is None else pl.sizes.get("seq", 1)


def cp_enter(x):
    """Under context parallelism, the rank's token shard (dim 1) -> the
    whole sequence, all-gathered over "seq" in rank order; the backward
    reduce-scatters the rank's partial grad (module docstring). Else x."""
    if cp_size() == 1:
        return x
    return _GatherSum.apply(x, 1, active().mesh.get_group("seq"))


def cp_exit(y):
    """Under context parallelism, the whole sequence (dim 1) -> the
    rank's token shard; the backward zero-pads its grad (module
    docstring). Else y."""
    if cp_size() == 1:
        return y
    pl = active()
    return _SeqShard.apply(y, pl.mesh.get_local_rank("seq"), pl.sizes["seq"])


def tp_enter(x):
    """The entry of a tensor-parallel region: identity, the grad summed
    over "model"; under the sequence split the sequence (dim 1)
    all-gathered, the grad reduce-scattered."""
    group = active().mesh.get_group("model")
    return _GatherSum.apply(x, 1, group) if seq_split() else SumGrad.apply(
        x, group)


def tp_exit(y):
    """The row-parallel output summed over "model", the grad as it is;
    under the sequence split reduce-scattered to the rank's slice of the
    sequence (dim 1), the grad all-gathered."""
    group = active().mesh.get_group("model")
    return _SeqExit.apply(y, group) if seq_split() else _Exit.apply(y, group)


def sum_grad(t):
    """A replicated leaf used on the rank's split of the compute: its
    partial grad summed over "model"."""
    return SumGrad.apply(t, active().mesh.get_group("model"))


def halves(w, dim: int):
    """A leaf [.., 2·di, ..] gathered with its "model" shard of `dim`
    (the rank's contiguous 1/model of [A | B], A and B each di wide) ->
    [A's | B's] slices of the rank's index, one all-to-all over "model"
    each way (`_Halves`); w itself where `dim` is whole."""
    if model_dim(w) != dim % w.dim():
        return w
    group, idx, n = active().model()
    return _Halves.apply(w, dim % w.dim(), group, idx, n)


def psum(x, group=None):
    """A row-parallel partial product whose consumers are split the same
    way: summed over `group` ("model" by default) forward and backward."""
    if group is None:
        group = active().mesh.get_group("model")
    return _Psum.apply(x, group)


def gather_sum(x, dim: int, group):
    """The rank's slice of `dim` -> whole over `group`, for consumers
    that each take a partial grad: the backward reduce-scatters it."""
    return _GatherSum.apply(x, dim % x.dim(), group)


def head_group(k: int):
    """The active placement's `head_group(k)`."""
    return active().head_group(k)


def gather_model(x, dim: int):
    """The rank's slice of `dim` over "model" -> whole (autograd)."""
    group, idx, n = active().model()
    return GatherModel.apply(x, dim % x.dim(), group, idx, n)


def slice_model(x, dim: int):
    """A whole tensor -> the rank's slice of `dim` over "model"."""
    group, idx, n = active().model()
    return SliceModel.apply(x, dim % x.dim(), group, idx, n)


def embed_lookup(table, tokens, vocab: int):
    """Rows of the embedding `table` (gathered for its use) for `tokens`.
    A table split over "model" by vocab (`vocab` rows whole) looks up
    the rank's rows, zeros elsewhere, and all-reduces over "model" (under
    the sequence split: reduce-scatters to the rank's slice of the
    sequence; a whole table's lookup takes that slice)."""
    if table.shape[0] == vocab:
        return seq_slice(table[tokens])
    _, idx, _ = active().model()
    rows = table.shape[0]
    local = tokens.long() - idx * rows
    inside = (local >= 0) & (local < rows)
    out = table[local.clamp(0, rows - 1)] * inside[..., None].to(table.dtype)
    return tp_exit(out)


class _VocabNLL(torch.autograd.Function):
    """Cross-entropy of vocab-parallel logits [..., V/tp]: the max, the
    sum of exps and the target's logit all-reduced over "model"."""

    @staticmethod
    def forward(ctx, logits, targets, group, lo):
        lf = logits.to(_F32)
        m = _collective("all-reduce", lf.amax(dim=-1), group,
                        op=dist.ReduceOp.MAX)
        e = torch.exp(lf - m[..., None])
        s = _collective("all-reduce", e.sum(dim=-1), group)
        t = targets.long() - lo
        inside = (t >= 0) & (t < lf.shape[-1])
        t = t.clamp(0, lf.shape[-1] - 1)
        gold = torch.gather(lf, -1, t[..., None])[..., 0] * inside.to(
            lf.dtype)
        gold = _collective("all-reduce", gold, group)
        ctx.save_for_backward(e, s, t, inside)
        ctx.dtype = logits.dtype
        return (torch.log(s) + m) - gold

    @staticmethod
    def backward(ctx, dnll):
        e, s, t, inside = ctx.saved_tensors
        p = e / s[..., None]
        p.scatter_add_(-1, t[..., None], -inside[..., None].to(p.dtype))
        return (p * dnll[..., None]).to(ctx.dtype), None, None, None


def token_nll(logits, targets, vocab: int):
    """Each token's next-token cross-entropy [B, N], in float32; logits
    split over "model" by vocab take the vocab-parallel path."""
    if logits.shape[-1] == vocab:
        from repro_torch.models.transformer import token_nll as whole

        return whole(logits, targets)
    group, idx, _ = active().model()
    return _VocabNLL.apply(logits, targets, group, idx * logits.shape[-1])


def gather_vocab(logits, vocab: int):
    """Whole-vocab logits from vocab-parallel ones (no grad)."""
    if logits.shape[-1] == vocab:
        return logits
    group, _, _ = active().model()
    with torch.no_grad():
        return _gather_dim(logits, logits.dim() - 1, group)


def shard_batch(batch: dict, mesh) -> dict:
    """The rank's rows of a global training batch (copies: the global
    batch can go): dim 0 of every tensor split over the mesh's "pod" and
    "data" axes as the reference's `batch_spec` splits it."""
    sizes = mesh_axes(mesh)
    at = dict(zip(sizes, mesh.get_coordinate()))
    rows = len(next(iter(batch.values())))
    dp, row = 1, 0
    for a in _names(batch_spec(mesh, batch_size=rows)[0]):
        dp, row = dp * sizes[a], row * sizes[a] + at[a]
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        n = v.shape[0] // dp
        out[k] = v[row * n:(row + 1) * n].clone()
    return out


def global_norm(tree, mesh) -> torch.Tensor:
    """sqrt of the sum of squares of a tree of placed grads, in float32:
    each leaf's local sum all-reduced over the axes it is split on, so a
    replicated leaf counts once."""
    sizes = mesh_axes(mesh)
    by_axes: dict = {}
    for _, x in leaves(tree):
        key = tuple(a for a in split_axes(spec_of(x) or ()) if sizes[a] > 1)
        by_axes.setdefault(key, []).append(x.to(_F32).square().sum())
    total = None
    for axes, parts in by_axes.items():
        s = torch.stack(parts).sum()
        for a in axes:
            s = _collective("all-reduce", s, mesh.get_group(a))
        total = s if total is None else total + s
    return torch.sqrt(total)
