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
"""
from __future__ import annotations

import itertools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense
from repro_torch.models.param import Builder

__all__ = ["init_moe", "apply_moe", "capacity", "balanced_counts"]

_F32 = torch.float32


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


def apply_moe(params, x, cfg, *, full_capacity: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, N, d]. Returns (y [B, N, d] in x's dtype, aux: a float32
    scalar). `full_capacity=True` is the inference mode (prefill and
    decode): no token is dropped up to 4096 tokens per call."""
    b, n, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    t = b * n
    xf = x.reshape(t, d)
    probs, gates, idx = _route(xf, params["router"], k)
    cap = capacity(t, cfg, full_capacity)

    # the (token, slot) pairs sorted by expert; within an expert by token
    # (a token's k experts are distinct, and the sort is stable)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    if x.device.type == "meta":
        # no values to count on meta: the balanced load
        n_e = balanced_counts(t, k, e)
        s_e = list(itertools.accumulate([0] + n_e[:-1]))
        counts = torch.empty(e, dtype=torch.int64, device=x.device)
    else:
        counts = torch.bincount(flat_e, minlength=e)
        starts = torch.cumsum(counts, 0) - counts
        n_e, s_e = counts.tolist(), starts.tolist()
    gate_flat = gates.reshape(-1)
    wg, wu, wo = (params[w].unbind(0) for w in ("wi_gate", "wi_up", "wo"))
    y = torch.zeros_like(xf)
    for ex in range(e):
        kept = min(n_e[ex], cap)          # pairs past C are dropped
        if kept == 0:
            continue
        pair = order[s_e[ex]:s_e[ex] + kept]
        tok = torch.div(pair, k, rounding_mode="floor")
        xe = xf[tok]
        h = F.silu(xe @ wg[ex]) * (xe @ wu[ex])
        ye = h @ wo[ex]
        y.index_add_(0, tok, ye * gate_flat[pair].to(ye.dtype)[:, None])

    if cfg.n_shared_experts > 0:
        h = F.silu(_dense(xf, params["shared_wi_gate"])) \
            * _dense(xf, params["shared_wi_up"])
        y = y + _dense(h, params["shared_wo"])

    # Switch-style load balance: E * sum_e (mean prob_e * share of choices_e)
    me = probs.mean(dim=0)
    ce = counts.to(_F32) / (t * k)
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight
    return y.reshape(b, n, d).to(x.dtype), aux
