"""Kernel plans on a mesh — port of `repro/kernels/sharded.py` on
torch.distributed.

Each rank runs the SAME kernel on its shard, with the partitioning chosen
once per call site:

  heads mode    Hkv % tp == 0: batch over the DP axes ("pod", "data"), kv
                heads (and their aligned query groups) over "model". Every
                kernel (forward, §2.5 backward, prefill, decode) is
                independent per (batch, kv head), so the call has no
                collectives.
  seq mode      context parallelism for causal TRAINING: the sequence
                sharded over "seq", each rank scanning its contiguous
                token shard. The chunk fold is associative, so one
                constant-size exchange per direction suffices: forward,
                each rank folds its local moments and receives the
                exclusive prefix sum of the earlier shards' (ring or
                allgather, by modelled bytes: `pick_cp_exchange`), which
                seeds its prefill launch; backward, the §2.5 kernel emits
                its seed's cotangent dC and the suffix sum over the later
                shards is what the rank's own moment fold receives,
                chained through the fold's vjp. The boundary traffic is
                O(D²·Dv) per pair of ranks whatever N is, where ring
                attention's is O(N·D) (`cp_boundary_model`).
  feature mode  Hkv % tp != 0 but Dv % tp == 0: v and the m-moments
                sharded on the value dim over "model", q, k and the
                g-moments whole on every rank. Prefill and decode need no
                collective; the backward (the §2.5 kernel on the rank's Dv
                slice of v, do and the m-moments) adds the partial dq and
                dk across "model" once per launch.

SPMD over local shards. Where the reference's `shard_map` cuts global
arrays by PartitionSpecs, here every rank already holds its shard: each
wrapper takes the rank's LOCAL tensors in the layout its plan's specs give
and returns local tensors, and the collectives are explicit calls on the
mesh's sub-groups (`mesh.get_group(axis)`). With B_l the rank's batch
shard over the plan's batch entry:

  heads    q [B_l, Hq/tp, N, D], k [B_l, Hkv/tp, N, D], v and o
           [B_l, H/tp, N, Dv]; the moments' kv-head dim over tp.
  feature  q [B_l, Hq, N, D], k [B_l, Hkv, N, D], v [B_l, Hkv, N, Dv/tp],
           o [B_l, Hq, N, Dv/tp]; m0, m1, m2 Dv/tp, g0, g1, g2 whole.
  seq      q, k, v, o [B_l, H, N/cp, *]: the token shard of the rank's
           "seq" coordinate.

`shard_local` cuts a rank's slice out of a global tensor by a `Spec` and
the rank's mesh coordinates; `gather_global` puts the slices back
together. `plan_call` and `run_in_model_layout` carry a call from the
model's layout (the rank's batch and token shard, heads and features
whole) into a plan's and back; the attention backends and the
decode-state protocol route through them under an active mesh
(`sharding.rules.use_mesh`). The plans launch the existing kernels of
`kernels.ops` on each shard: CUDA tensors launch them or raise, CPU
tensors take their plain versions. gloo moves CUDA tensors in its
all-reduce and list all-gather but not point to point: there the ring's
hops go through host memory. The "model"-axis slice, gather and grad sum
are `sharding.placed`'s (`SliceModel`, `GatherModel`, `SumGrad`).

Under the placed step (`sharding.placed`) the projections of a dense
decoder already hold the rank's heads over "model" where the kv heads
divide it: inside `local_heads()` the plan is made on the heads times the
"model" size, and a heads plan runs on the tensors as they are (neither
slice nor gather). The feature mode and the no-plan case take whole
heads, as before: the placed attention gathers q there first.

`plan_kernel_sharding` returns None when neither heads nor features
divide the "model" axis (every rank holds the whole heads, and the
caller launches the single-device kernels on them), and
`nontrivial_mesh()` tells "no mesh" (a plain single-device kernel call)
from "a mesh".
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import math
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.core.fastmax import compute_moments_chunked
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.tiling import SCAN_BM_BUDGET, pick_bm
from repro_torch.sharding import placed
from repro_torch.sharding.rules import Spec, _batch_entry, mesh_axes

__all__ = ["ShardPlan", "nontrivial_mesh", "plan_kernel_sharding",
           "fastmax_sharded", "fastmax_prefill_sharded",
           "fastmax_decode_sharded", "hybrid_sharded",
           "hybrid_prefill_sharded", "pick_cp_exchange",
           "cp_carry_bytes", "cp_boundary_model", "SEQ_PLAN_BACKENDS"]

# the attention backends that offer a causal training call seq mode
# (`plan_call(..., seq=True)`): under "seq" they run on the rank's token
# shard, and the model gathers the sequence around every other mixer
# (`models.transformer.takes_token_shard`)
SEQ_PLAN_BACKENDS = ("fastmax-chunked", "fastmax-kernel")

# calls of each public wrapper (the routing's tests count them)
calls: collections.Counter = collections.Counter()


class ShardPlan(NamedTuple):
    """How one fastmax kernel call partitions over the active mesh."""

    mesh: object            # a DeviceMesh, or a mapping axis -> size
    batch: object           # Spec entry of the batch dim
    mode: str               # "heads" | "feature" | "seq"
    tp: int                 # size of the "model" axis (1 = no TP)
    cp: int = 1             # size of the "seq" axis (1 = no CP)

    @property
    def head(self):
        return "model" if (self.mode == "heads" and self.tp > 1) else None

    @property
    def feat(self):
        return "model" if self.mode == "feature" else None

    def describe(self) -> str:
        mesh_s = "x".join(f"{a}={s}" for a, s in mesh_axes(self.mesh).items())
        return f"shard_map[{self.mode}] over ({mesh_s})"


def nontrivial_mesh():
    """The active mesh when any axis has size > 1, else None."""
    from repro_torch.sharding.rules import active_mesh

    mesh = active_mesh()
    if mesh is None or all(s == 1 for s in mesh_axes(mesh).values()):
        return None
    return mesh


def plan_kernel_sharding(mesh, *, batch: int, hq: int, hkv: int,
                         dv: int, seq_len: int | None = None,
                         ) -> Optional[ShardPlan]:
    """Pick the partitioning for a fastmax kernel call, or None.

    None: the mesh has a "model" axis of size > 1 that neither the kv
    heads (with the query heads) nor the value dim divide; the caller
    runs the single-device kernels on the whole heads (the reference
    runs its chunked scan there). `seq_len` opts into seq mode: callers pass it
    only for causal, training-shaped calls; it plans seq mode at tp = 1
    on a "seq" axis of size > 1 that divides it. CP×TP is deferred, as in
    the reference: at tp > 1 the heads and feature modes win. Any other
    mesh gets a degenerate heads plan (DP only, heads whole)."""
    if mesh is None:
        return None
    sizes = mesh_axes(mesh)
    tp, cp = sizes.get("model", 1), sizes.get("seq", 1)
    b_entry, _ = _batch_entry(sizes, batch)
    if tp > 1:
        if hkv % tp == 0 and hq % tp == 0:
            mode = "heads"
        elif dv % tp == 0:
            mode = "feature"
        else:
            return None
    elif cp > 1 and seq_len is not None and seq_len % cp == 0:
        return ShardPlan(mesh=mesh, batch=b_entry, mode="seq", tp=tp, cp=cp)
    else:
        mode = "heads"
    return ShardPlan(mesh=mesh, batch=b_entry, mode=mode, tp=tp)


def _moment_specs(plan: ShardPlan):
    """Specs of a moment tuple [B,Hkv,...] under the plan."""
    ba, h, f = plan.batch, plan.head, plan.feat
    return (Spec(ba, h, f),                     # m0 [B,Hkv,Dv]
            Spec(ba, h, None, f),               # m1 [B,Hkv,D,Dv]
            Spec(ba, h, None, None, f),         # m2 [B,Hkv,D,D,Dv]
            Spec(ba, h),                        # g0 [B,Hkv]
            Spec(ba, h, None),                  # g1 [B,Hkv,D]
            Spec(ba, h, None, None))            # g2 [B,Hkv,D,D]


def _seq_state_specs(ba):
    """Specs of the per-shard final carries stacked on a leading "seq"
    axis [cp, B, Hkv, ...]: each shard's carry differs."""
    return (Spec("seq", ba, None, None),
            Spec("seq", ba, None, None, None),
            Spec("seq", ba, None, None, None, None),
            Spec("seq", ba, None),
            Spec("seq", ba, None, None),
            Spec("seq", ba, None, None, None))


def plan_specs(plan: ShardPlan) -> dict:
    """The specs of a wrapper's tensors under the plan: "q", "k", "v",
    "o" (and "do", "dq", ... alike) and "moments" (a tuple of six)."""
    ba = plan.batch
    if plan.mode == "seq":
        tok = Spec(ba, None, "seq", None)
        return dict(q=tok, k=tok, v=tok, o=tok,
                    moments=_seq_state_specs(ba))
    whole = Spec(ba, plan.head, None, None)
    sliced = Spec(ba, plan.head, None, plan.feat)
    return dict(q=whole, k=whole, v=sliced, o=sliced,
                moments=_moment_specs(plan))


# ---------------------------------------------------------------------------
# Local slices of global tensors
# ---------------------------------------------------------------------------


def _coords(mesh, coord=None) -> dict:
    if coord is not None:
        return dict(coord)
    return dict(zip(mesh_axes(mesh), mesh.get_coordinate()))


def shard_local(x: torch.Tensor, spec, mesh, coord=None) -> torch.Tensor:
    """The rank's slice of the global tensor `x` under `spec`: each dim
    split over its entry's axes, the first named the major one (chunk
    Σ_a idx_a · Π_{b after a} |b|). `coord` ({axis: index}) defaults to
    the calling rank's coordinates on the DeviceMesh. A new contiguous
    tensor."""
    sizes, at = mesh_axes(mesh), _coords(mesh, coord)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = 0, 1
        for a in ((entry,) if isinstance(entry, str) else entry):
            idx, n = idx * sizes[a] + at[a], n * sizes[a]
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"over {entry} ({n} shards)")
        size = x.shape[d] // n
        x = x.narrow(d, idx * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def gather_global(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global tensor whose `shard_local` slices the ranks hold: an
    all-gather over the default process group, which the DeviceMesh
    `mesh` spans."""
    sizes = mesh_axes(mesh)
    parts = _all_gather(x.contiguous(), None)
    shape = list(x.shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            shape[d] *= math.prod(
                sizes[a] for a in ((entry,) if isinstance(entry, str)
                                   else entry))
    out = x.new_empty(shape)
    names = list(sizes)
    for at in itertools.product(*(range(n) for n in sizes.values())):
        coord = dict(zip(names, at))
        view = out
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            idx = 0
            for a in ((entry,) if isinstance(entry, str) else entry):
                idx = idx * sizes[a] + coord[a]
            view = view.narrow(d, idx * x.shape[d], x.shape[d])
        view.copy_(parts[int(mesh.mesh[at])])
    return out


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _all_gather(x: torch.Tensor, group) -> list:
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return out


def _sendrecv(x: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    """Send x to group rank `dst` and receive a tensor like it from group
    rank `src`."""
    # gloo sends and receives host tensors only: stage CUDA ones there
    host = x.device.type != "cpu" and dist.get_backend(group) == "gloo"
    send = x.cpu() if host else x.contiguous()
    recv = torch.empty_like(send)
    reqs = [dist.isend(send, dist.get_global_rank(group, dst), group=group),
            dist.irecv(recv, dist.get_global_rank(group, src), group=group)]
    for r in reqs:
        r.wait()
    return recv.to(x.device) if host else recv


def _model(plan: ShardPlan):
    return (plan.mesh.get_group("model"),
            plan.mesh.get_local_rank("model"), plan.tp)


def model_slice(x, dim: int, plan: ShardPlan):
    """A whole tensor -> the rank's slice of `dim` over "model"; the
    backward gathers the slices' grads (each rank holds the same whole
    tensor, so each gets the whole grad)."""
    group, idx, n = _model(plan)
    return placed.SliceModel.apply(x, dim % x.dim(), group, idx, n)


def model_gather(x, dim: int, plan: ShardPlan):
    """The rank's slice of `dim` -> the whole tensor on every rank; the
    backward keeps the slice's own grad."""
    group, idx, n = _model(plan)
    return placed.GatherModel.apply(x, dim % x.dim(), group, idx, n)


# ---------------------------------------------------------------------------
# Context parallelism (seq mode)
# ---------------------------------------------------------------------------

# temp-memory budget of the allgather exchange: gathering cp carries holds
# cp × carry_bytes per rank; past it the ring's cp - 1 hops are taken
_CP_ALLGATHER_BUDGET = 256 * 1024 * 1024


def cp_carry_bytes(*, b: int, hkv: int, d: int, dv: int, p: int,
                   itemsize: int = 4) -> int:
    """Bytes of ONE rank's exchanged moment carry (the per-boundary
    payload). m2 and g2 exist only at p >= 2 (zeros the exchange skips at
    p = 1)."""
    elems = dv + d * dv + 1 + d
    if p >= 2:
        elems += d * d * dv + d * d
    return b * hkv * elems * itemsize


def pick_cp_exchange(cp: int, carry_bytes: int) -> str:
    """'allgather' (one collective, cp·carry_bytes of temp memory) under
    the budget, else 'ring' (cp - 1 hops, constant memory).
    REPRO_CP_EXCHANGE=auto|ring|allgather overrides (the two differ in
    the ORDER of summation: compare them within allclose)."""
    forced = os.environ.get("REPRO_CP_EXCHANGE", "auto").lower()
    if forced in ("ring", "allgather"):
        return forced
    return "allgather" if cp * carry_bytes <= _CP_ALLGATHER_BUDGET else "ring"


def cp_boundary_model(*, n: int, b: int, hkv: int, d: int, dv: int, p: int,
                      cp: int, itemsize: int = 4) -> dict:
    """Modelled bytes per boundary: the CP carry exchange against ring
    attention's (each hop rotates a neighbour's K/V shard of n/cp tokens,
    O(N·D); the carry is O(D²·Dv) whatever N is)."""
    carry = cp_carry_bytes(b=b, hkv=hkv, d=d, dv=dv, p=p, itemsize=itemsize)
    ring_attn = b * hkv * (n // max(cp, 1)) * (d + dv) * itemsize
    return {
        "cp": cp,
        "exchange": pick_cp_exchange(cp, carry),
        "carry_bytes_per_boundary": carry,
        "ring_attention_bytes_per_boundary": ring_attn,
        "carry_to_ring_ratio": carry / ring_attn if ring_attn else None,
    }


def _cp_prefix_sum(leaves: tuple, mesh, impl: str, reverse: bool = False):
    """EXCLUSIVE prefix sum (Σ_{j<i}; reverse=True the suffix Σ_{j>i}) of
    the ranks' tensors over the "seq" axis, the leaves moved as one flat
    buffer. allgather: one collective, then the sum of the shards on the
    wanted side. ring: cp - 1 hops to the next rank (the previous one
    reversed); after s hops rank i holds shard i ∓ s and adds it iff that
    shard is on the wanted side (no wraparound term)."""
    group = mesh.get_group("seq")
    cp, idx = dist.get_world_size(group), mesh.get_local_rank("seq")
    flat = torch.cat([x.reshape(-1) for x in leaves])
    acc = torch.zeros_like(flat)
    if impl == "allgather":
        for j, part in enumerate(_all_gather(flat, group)):
            if (j > idx) if reverse else (j < idx):
                acc = acc + part
    else:
        shift = -1 if reverse else 1
        msg = flat
        for s in range(1, cp):
            msg = _sendrecv(msg, (idx + shift) % cp, (idx - shift) % cp,
                            group)
            if (idx < cp - s) if reverse else (idx >= s):
                acc = acc + msg
    out, at = [], 0
    for x in leaves:
        out.append(acc[at:at + x.numel()].view(x.shape))
        at += x.numel()
    return tuple(out)


def _live(mom, p: int) -> tuple:
    """The leaves an exchange moves: all six, or (m0, m1, g0, g1) at p<2."""
    return tuple(mom) if p >= 2 else (mom[0], mom[1], mom[3], mom[4])


# bytes of the seq plan's moment fold's intermediate per chunk: the fold
# (`core.fastmax.compute_moments_chunked`, plain torch on every device)
# holds [B, Hkv, c, bm, D] float32 products per chunk of c tokens, and
# takes chunks of as many tokens as keep them within this budget (at
# least the model's chunk): a long shard is folded in a few chunks, not
# N / chunk_size turns of its Python loop
_CP_FOLD_BUDGET = 256 * 1024 * 1024


def _fold_chunk(k, chunk_size: int) -> int:
    """Tokens per chunk of the seq plan's moment fold of `k`'s shard."""
    b, hkv, _, d = k.shape
    per_token = b * hkv * pick_bm(d, SCAN_BM_BUDGET) * d * 4
    return max(chunk_size, _CP_FOLD_BUDGET // per_token)


def _seq_impl(q, k, v, p: int, plan: ShardPlan) -> str:
    b, _, _, d = q.shape
    return pick_cp_exchange(plan.cp, cp_carry_bytes(
        b=b, hkv=k.shape[1], d=d, dv=v.shape[-1], p=p))


def _seq_fns(plain: bool):
    """(prefill, backward) of seq mode: the kernels' wrappers, or their
    plain versions on any device (the chunked backend)."""
    if not plain:
        return kernel_ops.fastmax_prefill_kernel, kernel_ops.fastmax_bwd
    from repro_torch.kernels.fastmax_causal import fastmax_causal_ref
    from repro_torch.kernels.fastmax_causal_bwd import fastmax_causal_bwd_ref

    def prefill(q, k, v, *, init_state, schedule, **kw):
        del schedule
        return fastmax_causal_ref(q, k, v, init_state=init_state, **kw)

    return prefill, fastmax_causal_bwd_ref


def _seq_fwd_launch(q, k, v, p, chunk_size, denom_eps, plan, schedule,
                    plain=False):
    """Seq-mode forward on the rank's token shard: (o, its final carry).
    Fold the shard's moments (plain chunked fold, as the reference's jnp
    fold outside Pallas), take the exclusive prefix of the earlier
    shards' carries, then one prefill launch seeded with it: the exact
    causal outputs of the whole sequence on this shard."""
    prefill, _ = _seq_fns(plain)
    with torch.no_grad():
        mom = compute_moments_chunked(k, v, p=p,
                                      chunk_size=_fold_chunk(k, chunk_size))
    carry = _cp_prefix_sum(_live(mom, p), plan.mesh,
                           _seq_impl(q, k, v, p, plan))
    if p < 2:
        carry = (carry[0], carry[1], torch.zeros_like(mom[2]), carry[2],
                 carry[3], torch.zeros_like(mom[5]))
    return prefill(q, k, v, p=p, chunk_size=chunk_size, denom_eps=denom_eps,
                   init_state=carry, schedule=schedule)


class _SeqCausal(torch.autograd.Function):
    """Seq-mode trainable attention (see `_seq_fwd_launch`). Backward:
    the §2.5 kernel with `return_dstate` on the seeded forward's final
    carry gives the shard's local grads and dC, the seed's cotangent; the
    suffix sum of the later shards' dC is the cotangent of this shard's
    moment fold, whose vjp adds to dk and dv."""

    @staticmethod
    def forward(ctx, q, k, v, p, chunk_size, denom_eps, plan, schedule,
                plain):
        o, state = _seq_fwd_launch(q, k, v, p, chunk_size, denom_eps, plan,
                                   schedule, plain)
        if p < 2:
            # don't hold the [B,Hkv,D,D,Dv] zeros placeholder as a residual
            state = state[:2] + (None,) + state[3:5] + (None,)
        ctx.save_for_backward(q, k, v, *(t for t in state if t is not None))
        ctx.cfg = (p, chunk_size, denom_eps, plan, plain)
        return o

    @staticmethod
    def backward(ctx, do):
        p, chunk_size, denom_eps, plan, plain = ctx.cfg
        q, k, v, *st = ctx.saved_tensors
        if p < 2:
            st = st[:2] + [None] + st[2:] + [None]
        _, bwd = _seq_fns(plain)
        with kernel_ops.under_plan(plan.describe()):
            dq, dk, dv, dC = bwd(q, k, v, tuple(st), do, p=p,
                                 chunk_size=chunk_size, denom_eps=denom_eps,
                                 return_dstate=True)
        dM = _cp_prefix_sum(_live(dC, p), plan.mesh,
                            _seq_impl(q, k, v, p, plan), reverse=True)
        with torch.enable_grad():
            kk, vv = (x.detach().requires_grad_(True) for x in (k, v))
            prim = _live(compute_moments_chunked(kk, vv, p=p,
                                                 chunk_size=_fold_chunk(
                                                     kk, chunk_size)), p)
            # g0 (the token count) depends on neither k nor v
            pairs = [(x, g.to(x.dtype)) for x, g in zip(prim, dM)
                     if x.requires_grad]
            dk_x, dv_x = torch.autograd.grad(
                [x for x, _ in pairs], (kk, vv), [g for _, g in pairs])
        acc = torch.promote_types(q.dtype, torch.float32)
        dk = (dk.to(acc) + dk_x.to(acc)).to(k.dtype)
        dv = (dv.to(acc) + dv_x.to(acc)).to(v.dtype)
        return dq, dk, dv, None, None, None, None, None, None


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------


def _feature_qk(q, k, plan: ShardPlan):
    """q, k whole on every rank of a feature plan: their gradients are
    the launch's partials over the rank's Dv columns, added across
    "model" once per launch."""
    group = plan.mesh.get_group("model")
    return placed.SumGrad.apply(q, group), placed.SumGrad.apply(k, group)


def fastmax_sharded(q, k, v, *, p: int, causal: bool, chunk_size: int,
                    denom_eps: float, plan: ShardPlan, schedule=None,
                    plain: bool = False):
    """Trainable kernel attention on the rank's shards (layouts in the
    module docstring). heads: `ops.fastmax` on the local heads, no
    collectives. feature: `ops.fastmax` on the rank's Dv slice of v
    (causal: the prefill kernel, then the §2.5 kernel on that slice;
    noncausal: the noncausal kernel and the plain moment backward), its
    partial dq and dk added across "model". seq (causal only): one
    prefix exchange forward, one suffix exchange backward; `plain` runs
    the plain versions there on any device (the chunked backend).
    `schedule` forces one schedule on every local forward launch."""
    calls["fastmax_sharded"] += 1
    if plan.mode == "seq":
        if not causal:
            raise ValueError(
                "seq-mode (context-parallel) attention is causal-only")
        with kernel_ops.under_plan(plan.describe()):
            return _SeqCausal.apply(q, k, v, p, chunk_size, denom_eps, plan,
                                    schedule, plain)
    if plan.mode == "feature":
        q, k = _feature_qk(q, k, plan)
    elif plan.mode != "heads":
        raise ValueError(f"unknown plan mode {plan.mode!r}")
    with kernel_ops.under_plan(plan.describe()):
        return kernel_ops.fastmax(q, k, v, p=p, causal=causal,
                                  chunk_size=chunk_size, denom_eps=denom_eps,
                                  schedule=schedule)


def hybrid_sharded(q, k, v, *, p: int, window: int, chunk_size: int,
                   denom_eps: float, plan: ShardPlan, schedule=None):
    """Trainable hybrid kernel attention (causal) on the rank's shards.
    heads: `ops.hybrid` on the local heads. feature: `ops.hybrid` on the
    rank's Dv slice of v (the band's denominator comes from q, k whole,
    so each slice of o is exact), the plain band-extended backward's
    partial dq and dk added across "model". No seq mode, as in the
    reference."""
    calls["hybrid_sharded"] += 1
    if plan.mode not in ("heads", "feature"):
        raise ValueError(f"hybrid_sharded supports heads/feature modes, got "
                         f"{plan.mode!r}")
    if plan.mode == "feature":
        q, k = _feature_qk(q, k, plan)
    with kernel_ops.under_plan(plan.describe()):
        return kernel_ops.hybrid(q, k, v, p=p, window=window, causal=True,
                                 chunk_size=chunk_size, denom_eps=denom_eps,
                                 schedule=schedule)


def fastmax_prefill_sharded(q, k, v, *, p: int, chunk_size: int,
                            denom_eps: float, kv_mask=None,
                            plan: ShardPlan, schedule=None):
    """Causal prefill on the rank's shards: (o, final moment tuple), in
    the heads or feature layout, no collectives (feature: each rank keeps
    the identical g-moments). `kv_mask` is the rank's [B_l, Hkv_l|1, N]:
    a [B, 1, N] mask weighs every local kv head, as the reference's
    broadcast to the kv heads does before its cut."""
    calls["fastmax_prefill_sharded"] += 1
    if plan.mode not in ("heads", "feature"):
        raise ValueError(f"prefill plans heads/feature modes, got "
                         f"{plan.mode!r}")
    with kernel_ops.under_plan(plan.describe()):
        return kernel_ops.fastmax_prefill_kernel(
            q, k, v, p=p, chunk_size=chunk_size, denom_eps=denom_eps,
            kv_mask=kv_mask, schedule=schedule)


def hybrid_prefill_sharded(q, k, v, *, p: int, window: int,
                           chunk_size: int, denom_eps: float, kv_mask=None,
                           plan: ShardPlan, schedule=None):
    """Hybrid causal prefill on the rank's shards: (o, final moment
    tuple), in the heads or feature layout, no collectives (feature: the
    band's denominator comes from q, k whole, so each slice of o is
    exact, and each rank keeps the identical g-moments). `kv_mask` as
    `fastmax_prefill_sharded`'s."""
    calls["hybrid_prefill_sharded"] += 1
    if plan.mode not in ("heads", "feature"):
        raise ValueError(f"hybrid prefill plans heads/feature modes, got "
                         f"{plan.mode!r}")
    with kernel_ops.under_plan(plan.describe()):
        return kernel_ops.hybrid_prefill_kernel(
            q, k, v, p=p, window=window, chunk_size=chunk_size,
            denom_eps=denom_eps, kv_mask=kv_mask, schedule=schedule)


def fastmax_decode_sharded(q, k, v, state, *, p: int, denom_eps: float,
                           plan: ShardPlan, schedule=None):
    """One fused decode step on the rank's shards: (o, state), the local
    moment tuple updated IN PLACE (as `ops.fastmax_decode`). Each rank
    streams only its moments: its heads, or 1/tp of m2 in feature mode;
    no collectives."""
    calls["fastmax_decode_sharded"] += 1
    if plan.mode not in ("heads", "feature"):
        raise ValueError(f"decode plans heads/feature modes, got "
                         f"{plan.mode!r}")
    with kernel_ops.under_plan(plan.describe()):
        o = kernel_ops.fastmax_decode(q, k, v, state, p=p,
                                      denom_eps=denom_eps, schedule=schedule)
    return o, tuple(state)


# ---------------------------------------------------------------------------
# The model's layout
# ---------------------------------------------------------------------------

_LOCAL_HEADS = []


@contextlib.contextmanager
def local_heads():
    """q, k and v of the calls inside hold the rank's heads over "model"
    (the placed projections' layout): plans are made on the whole heads
    and a heads plan runs on them as they are."""
    _LOCAL_HEADS.append(True)
    try:
        yield
    finally:
        _LOCAL_HEADS.pop()


def in_local_heads() -> bool:
    return bool(_LOCAL_HEADS)



def plan_call(q, k, v, *, causal: bool = True, seq: bool = False):
    """(mesh, plan) of a call in the model's layout under the active
    mesh: (None, None) without a nontrivial one. The model holds the
    rank's batch shard over the DP axes and, under "seq", its token
    shard, heads and features whole: the plan is made on the call's
    global shape (batch × the DP axes, tokens × cp). `seq` offers seq
    mode to a causal self-attention call (training)."""
    mesh = nontrivial_mesh()
    if mesh is None:
        return None, None
    sizes = mesh_axes(mesh)
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    heads = sizes.get("model", 1) if _LOCAL_HEADS else 1
    seq_len = (q.shape[2] * sizes.get("seq", 1)
               if seq and causal and q.shape[2] == k.shape[2] else None)
    plan = plan_kernel_sharding(mesh, batch=q.shape[0] * dp,
                                hq=q.shape[1] * heads,
                                hkv=k.shape[1] * heads, dv=v.shape[-1],
                                seq_len=seq_len)
    return mesh, plan


def local_kv_dims(plan: ShardPlan, hkv: int, dv: int) -> tuple:
    """(kv heads, value dim) of a rank's moments under the plan."""
    if plan.mode == "heads":
        return hkv // plan.tp, dv
    if plan.mode == "feature":
        return hkv, dv // plan.tp
    return hkv, dv


def run_in_model_layout(plan: ShardPlan, fn, q, k, v):
    """fn(q, k, v) -> o on the plan's shards of model-layout q, k, v,
    with o back in the model's layout: heads mode at tp > 1 cuts the
    heads over "model" and gathers o's; feature mode cuts v's value dim
    and gathers o's; otherwise the tensors already are the plan's. Inside
    `local_heads()` they are a heads plan's already."""
    if _LOCAL_HEADS:
        if plan.mode != "heads":
            raise ValueError(f"local heads take a heads plan, got "
                             f"{plan.mode!r}")
        return fn(q, k, v)
    if plan.mode == "heads" and plan.tp > 1:
        o = fn(*(model_slice(x, 1, plan) for x in (q, k, v)))
        return model_gather(o, 1, plan)
    if plan.mode == "feature":
        return model_gather(fn(q, k, model_slice(v, -1, plan)), -1, plan)
    return fn(q, k, v)
