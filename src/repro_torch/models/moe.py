"""Mixture-of-Experts FFN — port of `repro/models/moe.py`: top-k routing,
capacity dropping, shared experts and the Switch load-balance aux.

The function is the reference's: the router in float32 (softmax over the
experts, `top_k`, the gates renormalized with `+ 1e-9`), the capacity C
of each expert (every token at inference up to 4096 tokens; 2·k·t/E past
that; k·t·capacity_factor/E in training), each (token, slot) placed in
its expert by token order and dropped past C, the shared experts on the
same input, and the aux E·Σ_e mean(probs)_e·counts_e/(t·k) times
`router_aux_weight`, counted over every top-k choice, kept or dropped.

The dispatch is PyTorch idiom rather than the reference's zero-padded
[E, C, d] buffer (160 × 2048 × 5120 bf16 = 3.4 GB per deepseek-v2 layer at
a 2048-token prefill): the (token, slot) pairs are sorted by expert once
(a stable sort, so token order within an expert), and each expert with a
kept pair runs its SwiGLU on its kept rows only (gather, three matmuls,
`index_add_` of the gated rows). A dropped pair adds nothing, as its
zeroed row of the buffer does in the reference, and the padded rows the
reference computes are never used there. No [T, k, E] tensor is made.
The loop over experts needs their counts on the host: one read-back per
call.

On the `meta` device (the dry run, `launch/dryrun.py`) there are no counts
to read back: `apply_moe` dispatches the balanced load instead, the t·k
pairs spread evenly over the E experts (t·k // E each, one more for the
first t·k mod E), each expert keeping at most C of them
(`balanced_counts`). That is the load `model_flops`' active-parameter
count assumes. The reference compiles a static capacity instead (every
expert runs C rows, padding included), which costs E·C rows where this
costs Σ_e min(C, load_e).

Under the placed step (`sharding.placed`, an active `Placement`) the MoE
is expert parallel, as the reference's partitioned step is (its experts
over "model", its batch over "data", GSPMD's capacity, positions and aux
over the global token axis). Each rank routes its own rows; their
per-expert counts are all-gathered over the batch axes (one [E] int64
all-gather a call), so that C is the whole batch's, a rank's pairs of
expert e take the global positions after those of the ranks whose rows
come before it (a pair is dropped where its global position is ≥ C),
and the aux uses the global counts, its mean prob the rank's share of
the global mean (the step sums the loss over the batch axes). The
routed experts stay the rank's "model" shard of [E, d, ff]: the tokens
are the same on every "model" rank, each runs its own experts (on the
pairs routed there and kept, an expert with no kept pair on this rank
on no rows where another data rank keeps one: its gathers are
collectives), and the routed output is summed over "model" (`tp_enter`
on the input, `tp_exit` on the output, `sum_grad` on the gates). Inside
the loop one expert's slice is gathered over the data axes at a time,
in its forward and again in its backward (`_Expert`): no rank holds a
whole routed-expert leaf, nor its "model" shard gathered. The router is
gathered whole; the shared experts keep their ff shards over "model"
(column/row parallel, their partial output summed with the routed one).
On meta the rank's pairs are its share of the whole batch's balanced
load. Under the training forward's sequence split
(`placed.sequence_split`) x is the rank's slice of the sequence: it is
gathered whole before the router (every pair's position needs the rank's
rows whole, in row order), and the summed output is reduce-scattered back
to the slice (`tp_exit`), or sliced where nothing of it is partial.
Under context parallelism ("seq" > 1) x is the rank's token shard: the
MoE takes its sequence gathered over "seq" (`placed.cp_enter`), routes
its data rank's whole rows, in the reference's flat token order, and
keeps its shard's rows of y (`placed.cp_exit`). The counts then go over
the data axes only (`Placement.expert_rows`), and the aux, computed whole
on every seq rank and summed over "seq" with the loss, is divided by the
"seq" size.
"""
from __future__ import annotations

import collections
import itertools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense
from repro_torch.models.param import Builder
from repro_torch.sharding import placed as P

__all__ = ["init_moe", "apply_moe", "materialize", "capacity",
           "balanced_counts", "stats"]

_F32 = torch.float32
ROUTED = ("wi_gate", "wi_up", "wo")     # the routed experts' [E, ...] leaves

# under a placement, on real values: the (token, slot) pairs of the
# rank's tokens ("pairs"), those dropped past the global capacity
# ("dropped"), and those a capacity of the rank's own tokens would keep or
# drop the other way ("differ")
stats: collections.Counter = collections.Counter()


def init_moe(b: Builder, name: str, cfg) -> None:
    sub = b.sub(name)
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    sub.add("router", (d, e), ("embed", "experts"), scale=0.02)
    sub.add("wi_gate", (e, d, ff), ("experts", "embed", "ff"), fan_in=d)
    sub.add("wi_up", (e, d, ff), ("experts", "embed", "ff"), fan_in=d)
    sub.add("wo", (e, ff, d), ("experts", "ff", "embed"), fan_in=ff)
    if cfg.n_shared_experts > 0:
        sff = ff * cfg.n_shared_experts
        sub.add("shared_wi_gate", (d, sff), ("embed", "ff"))
        sub.add("shared_wi_up", (d, sff), ("embed", "ff"))
        sub.add("shared_wo", (sff, d), ("ff", "embed"))


def capacity(t: int, cfg, full_capacity: bool) -> int:
    """Rows each expert keeps for `t` tokens (the reference's three
    branches)."""
    e, k = cfg.n_experts, cfg.moe_top_k
    if full_capacity and t <= 4096:
        return t                     # decode / small prefill: never drop
    if full_capacity:
        # long prefill: 2x the expected load makes drops vanishingly rare
        return min(t, max(1, int(2.0 * k * t / e)))
    return max(1, int(k * t * cfg.capacity_factor / e))


def balanced_counts(t: int, k: int, e: int) -> list:
    """The balanced load of `t` tokens' top-`k` choices over `e` experts:
    t·k // e pairs each, one more for the first t·k mod e experts (the
    dry run's dispatch on `meta`, before the capacity cut)."""
    per, extra = divmod(t * k, e)
    return [per + (1 if ex < extra else 0) for ex in range(e)]


def _route(xf, router, k: int):
    """The router, a float32 island as in the reference: probs [T, E],
    renormalized top-k gates [T, k] and their experts [T, k]."""
    logits = xf.to(_F32) @ router.to(_F32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    return probs, gates, idx


class _Load(NamedTuple):
    """The routed pairs by expert: `t` the tokens of the whole batch,
    `local` the rank's pairs per expert, `before` the pairs of the ranks
    whose rows come before it, `total` every rank's, `counts` `total` as a
    tensor [E] (for the aux)."""
    t: int
    local: list
    before: list
    total: list
    counts: torch.Tensor


def _load(flat_e, t: int, k: int, e: int, pl) -> _Load:
    """The load of the rank's pairs `flat_e` [t·k], and of the whole
    batch: under a placement whose rows are split, each rank's counts
    all-gathered in the order of its rows (one read-back); on `meta` the
    balanced load of the whole batch, each expert's share split evenly
    over the row ranks in rank order ("seq" ranks hold the same rows)."""
    dp = 1 if pl is None else pl.row_ranks()
    dev = flat_e.device
    if dev.type == "meta":
        counts = torch.empty(e, dtype=torch.int64, device=dev)
        # the all-gather the card makes (counted); its values unknown
        r = pl.expert_rows(counts)[1] if dp > 1 else 0
        total = balanced_counts(t * dp, k, e)
        split = [divmod(c, dp) for c in total]
        local = [q + (1 if r < m else 0) for q, m in split]
        before = [r * q + min(r, m) for q, m in split]
        return _Load(t * dp, local, before, total, counts)
    counts = torch.bincount(flat_e, minlength=e)
    if dp == 1:
        local = counts.tolist()
        return _Load(t, local, [0] * e, local, counts)
    rows, r = pl.expert_rows(counts)
    rows_h = rows.tolist()
    before = [sum(c) for c in zip(*rows_h[:r])] if r else [0] * e
    return _Load(t * dp, rows_h[r], before,
                 [sum(c) for c in zip(*rows_h)], rows.sum(dim=0))


def _experts(params) -> Tuple[int, bool, list]:
    """(the global index of the rank's first expert, whether the experts
    are split over "model", [(wi_gate, wi_up, wo)] the rank's experts,
    views of its local shards). Without a placement every expert."""
    views = list(zip(*(P.unbind(params[w]) for w in ROUTED)))
    spec, pl = P.spec_of(params["wi_gate"]), P.active()
    if spec is None or pl is None:
        return 0, False, views
    axes = [a for a in P.split_axes(spec[:1]) if pl.sizes[a] > 1]
    if not axes:
        return 0, False, views
    if axes != ["model"]:
        raise ValueError(f"the routed experts are split over {axes}; the "
                         f"placed MoE splits them over 'model' only")
    return pl.mesh.get_local_rank("model") * len(views), True, views


class _Expert(torch.autograd.Function):
    """One expert's SwiGLU on its rows xe [r, d]. Under a placement its
    weights are the rank's slices, gathered whole in the forward and
    again in the backward (`Placement.weight`): only the slices, the rows
    and the two products are saved, so one expert's gathered weights are
    alive at a time; the weights' grads go back through the gather's
    backward (`Placement.weight_grad`: reduce-scattered over the batch
    axes)."""

    @staticmethod
    def forward(ctx, xe, wg, wu, wo):
        pl = P.active()
        # the slices themselves (views of the leaves, which carry their
        # specs), not copies
        ctx.pl, ctx.ws = pl, (wg, wu, wo)
        wg_, wu_, wo_ = ctx.ws if pl is None else map(pl.weight, ctx.ws)
        g, u = xe @ wg_, xe @ wu_
        ctx.save_for_backward(xe, g, u)
        return (F.silu(g) * u) @ wo_

    @staticmethod
    def backward(ctx, dy):
        xe, g, u = ctx.saved_tensors
        pl, ws = ctx.pl, ctx.ws
        wg_, wu_, wo_ = ws if pl is None else map(pl.weight, ws)
        # autograd's own backward of the forward's ops
        act = F.silu(g)
        dh = dy @ wo_.T
        dg = torch.ops.aten.silu_backward(dh * u, g)
        du = dh * act
        grads = [xe.T @ dg, xe.T @ du, (act * u).T @ dy]
        if pl is not None:
            grads = [pl.weight_grad(gw, w) for gw, w in zip(grads, ws)]
        dx = dg @ wg_.T + du @ wu_.T if ctx.needs_input_grad[0] else None
        return (dx, *grads)


def _sum(xs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def materialize(params):
    """The MoE's leaves for their use under a placement: the router
    gathered whole, the shared experts keeping a "model" split of their
    ff dim (column/row parallel, as `layers.apply_mlp`), the routed
    experts left as the rank's shards (`apply_moe` gathers one expert at
    a time). Without a placement, `params`."""
    return {k: v if k in ROUTED else P.leaf(v, k.startswith("shared_"))
            for k, v in params.items()}


def apply_moe(params, x, cfg, *, full_capacity: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, N, d]. Returns (y [B, N, d] in x's dtype, aux: a float32
    scalar). `full_capacity=True` is the inference mode (prefill and
    decode): no token is dropped up to 4096 tokens per call.

    Under a placement (`materialize`d leaves) x is the rank's rows, the
    same on every "model" rank: the capacity, each pair's position in its
    expert and the aux's statistics are those of the whole batch (the
    rank's pairs come after those of the ranks whose rows come before
    it); the rank runs its own experts and the routed output is summed
    over "model"; its aux is its tokens' share, which the step sums over
    the batch axes. Under the sequence split x and y are the rank's
    slice of the sequence, the routing the whole rows'; under context
    parallelism they are its token shard, and its aux is divided by the
    "seq" size (module docstring)."""
    x = P.cp_enter(P.seq_gather(x))
    b, n, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    t = b * n
    pl = P.active()
    xf = x.reshape(t, d)
    probs, gates, idx = _route(xf, params["router"], k)

    # the (token, slot) pairs sorted by expert; within an expert by token
    # (a token's k experts are distinct, and the sort is stable)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    load = _load(flat_e, t, k, e, pl)
    cap = capacity(load.t, cfg, full_capacity)
    # the rank's pairs of expert ex whose global position is below C
    kept = [max(0, min(n_e, cap - b_e))
            for n_e, b_e in zip(load.local, load.before)]
    starts = list(itertools.accumulate([0] + load.local[:-1]))
    if pl is not None and x.device.type != "meta":
        own = capacity(t, cfg, full_capacity)
        stats["pairs"] += t * k
        stats["dropped"] += sum(load.local) - sum(kept)
        stats["differ"] += sum(abs(kp - min(n_e, own))
                               for kp, n_e in zip(kept, load.local))

    first, ep, weights = _experts(params)
    shared = cfg.n_shared_experts > 0
    sh_split = shared and P.model_dim(params["shared_wo"]) == 0
    # the input of the compute split over "model": its grad summed there
    xin = P.sum_grad(xf) if ep or sh_split else xf
    gate_flat = gates.reshape(-1)
    if ep:
        # the rank's gates' grads summed over "model" (the aux's are the
        # same on every model rank)
        gate_flat = P.sum_grad(gate_flat)
    xr = xin if ep else xf
    y = torch.zeros_like(xf)
    for j, (wg, wu, wo) in enumerate(weights):
        ex = first + j
        # an expert that keeps a pair on any rank runs on every rank (its
        # gathers are collectives), on no rows where the rank keeps none
        if min(load.total[ex], cap) == 0:
            continue
        pair = order[starts[ex]:starts[ex] + kept[ex]]
        tok = torch.div(pair, k, rounding_mode="floor")
        ye = _Expert.apply(xr[tok], wg, wu, wo)
        y.index_add_(0, tok, ye * gate_flat[pair].to(ye.dtype)[:, None])

    # the outputs partial over "model" (the rank's experts; the shared
    # experts' ff shard) are summed over it once (under the sequence
    # split: reduce-scattered to the rank's slice), the whole ones sliced
    partial, whole = ([y], []) if ep else ([], [y])
    if shared:
        xs = xin if sh_split else xf
        h = F.silu(_dense(xs, params["shared_wi_gate"])) \
            * _dense(xs, params["shared_wi_up"])
        (partial if sh_split else whole).append(
            _dense(h, params["shared_wo"]))
    y = None
    if partial:
        y = P.tp_exit(_sum(partial).reshape(b, n, d))
    if whole:
        yw = P.seq_slice(_sum(whole).reshape(b, n, d))
        y = yw if y is None else y + yw

    # Switch-style load balance: E * sum_e (mean prob_e * share of choices_e)
    # over the whole batch; the rank's share of the mean prob
    me = probs.mean(dim=0) if load.t == t else probs.sum(dim=0) / load.t
    ce = load.counts.to(_F32) / (load.t * k)
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight
    return P.cp_exit(y.to(x.dtype)), aux / P.cp_size()
