"""xLSTM mixers, mLSTM (matrix memory) and sLSTM (scalar memory) — port
of `repro/models/xlstm.py`.

mLSTM runs chunkwise in the gated-linear-attention form, as the
reference does: inside a chunk the gate-weighted q·k block is formed
directly (every decay ratio exp(lcum_i - lcum_j) with j ≤ i is at most 1,
the input gate is exp-capped at `_ICAP`), and across chunks the matrix
memory C [B, H, dk, dv] and the normalizer n [B, H, dk] are carried in
float32. Chunks are not padded: the last one runs at its own length (the
reference pads with log f = 0 and i = 0, which add nothing). sLSTM's gates
read h_{t-1}, so it is sequential over time, a Python loop of one step per
token (the reference's `lax.scan`); the gates' input projections of all
tokens are one matmul per gate before the loop, and the four recurrent
head-wise products one batched matmul per step.

Stateful calls (`apply_mlstm_stateful`, `mlstm_decode`,
`apply_slstm_stateful`, `slstm_decode`) update the given state IN PLACE
(`copy_`), as the attention layers do: it may be a view into a stacked
[n_groups, ...] model state or into one slot of a serving pool. The
state dtypes are the reference's: C, n and sLSTM's c, n, m float32, sLSTM's
h in the activation dtype, m starting at -1e9 (a slot pool resets each
leaf to its fresh fill). Attention-free, so FAST does not apply; the
reference has no kernel here, so plain torch is the only version.

Under the placed step's SSM split (`sharding.placed`: the leaves' "ff"
shards over "model", and their "heads" shards where "model" divides the
heads) a rank computes its d_inner / model channels of the mixer, which
are either whole heads (model divides the heads) or a contiguous slice
of one head (the heads divide model: a head spans k = model / heads
consecutive ranks, its `placed.head_group`). x enters through
`tp_enter`, the row-parallel down_proj leaves through `tp_exit`.

mLSTM. up_proj's shard is exchanged for the rank's channels of xi and
of z (`placed.halves`). The rank's heads take their whole xi (gathered
over the head's ranks, `placed.gather_sum`), so q and k are the head's
whole, v is the rank's slice of the head's value dim (dv / k): the
matrix memory C [B, heads, dk, dv / k] of a rank is its value slice; the
normalizer n [B, heads, dk / k] its key slice, its dot with q summed over
the head's ranks (a decode step; a prefill gathers n once and keeps its
slice of the result). wi and wf contract all of d_inner: their [B, N,
heads] output is a partial sum over "model" (`placed.psum`). The
per-head norm sums its squares over the head's ranks. The layer's output
channels are then the rank's "ff" slice, as gn_scale, z and down_proj's
rows hold it. wq, wk, wv, bi and bf whole over "model" (heads not
divisible) are indexed at the rank's head and take `sum_grad`.

sLSTM is block-diagonal per head: head-parallel where "model" divides
the heads. Where a head spans k ranks, each of them computes the head
whole (the recurrence would otherwise need h exchanged every token,
inside the per-token loop): w{z,i,f,o}'s and b{z,i,f,o}'s columns of the
head are gathered over its k ranks (not over all of "model"), the head's
state slices likewise at each stateful call, and each rank keeps its
slice of the head's output and of its final state.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense
from repro_torch.models.param import Builder
from repro_torch.sharding import placed as P

__all__ = [
    "init_mlstm", "apply_mlstm", "apply_mlstm_stateful", "mlstm_decode",
    "init_mlstm_state", "init_slstm", "apply_slstm", "apply_slstm_stateful",
    "slstm_decode", "init_slstm_state", "MLSTMState", "SLSTMState",
]

_F32 = torch.float32
_ICAP = 10.0  # input-gate exp cap (numerical guard)
_GATES = ("z", "i", "f", "o")


def _dims(cfg):
    di = 2 * cfg.d_model             # proj_factor 2 (xLSTM-1.3b)
    nh = cfg.n_heads
    return di, nh, di // nh


def _headwise_norm(h, nh: int, out_dtype, group=None, width=None):
    """Per-head RMS norm of h [B, N, di] (no scale), computed in float32 on
    h's values, cast to `out_dtype`. With `group`, h holds a slice of
    each head, `width` wide whole: its sum of squares is summed over the
    group."""
    bsz, n, di = h.shape
    hn = h.reshape(bsz, n, nh, di // nh)
    if group is None:
        var = hn.to(_F32).square().mean(dim=-1, keepdim=True)
    else:
        var = P.psum(hn.to(_F32).square().sum(dim=-1, keepdim=True),
                     group) / width
    return (hn * torch.rsqrt(var + 1e-6)).reshape(bsz, n, di).to(out_dtype)


class _Layout(NamedTuple):
    """A rank's part of a mixer of `nh` heads of `hd` channels under the
    placed step's split over `model` ranks: heads [h0, h0 + nl), of
    which it holds the channels slice j of k (k ranks to a head; k = 1:
    whole heads), and the head's group of ranks (None for k = 1)."""
    h0: int
    nl: int
    k: int
    j: int
    group: object
    hd: int


def _layout(params, out_leaf: str, nh: int, hd: int):
    """The rank's `_Layout` where its gathered leaves hold its channels
    (`out_leaf` row-parallel over "model"), else None."""
    if P.model_dim(params[out_leaf]) != 0:
        return None
    _, idx, m = P.active().model()
    if nh % m == 0:
        return _Layout(idx * (nh // m), nh // m, 1, 0, None, hd)
    if m % nh:
        raise ValueError(f"the xLSTM split over 'model' = {m} needs it to "
                         f"divide the {nh} heads or be a multiple of them")
    k = m // nh
    group, j = P.head_group(k)
    return _Layout(idx // k, 1, k, j, group, hd)


def _local_dims(nh: int, hd: int, model: int) -> tuple:
    """(heads, channels a head) of a rank's state under a split over
    `model` ranks: whole heads where it divides them, else a 1/k slice
    of one head."""
    if model == 1 or nh % model == 0:
        return nh // model, hd
    return 1, hd // (model // nh)


def _heads(params, name: str, lay: _Layout):
    """The rank's heads [h0, h0 + nl) of a leaf with a leading heads dim:
    the leaf itself where it is their shard, else indexed (its grad
    summed over "model": every rank uses its heads only)."""
    w = params[name]
    if P.model_dim(w) == 0:
        return w
    return P.sum_grad(w)[lay.h0:lay.h0 + lay.nl]


def _slice(x, dim: int, lay: _Layout):
    """The rank's slice j of k of `dim`."""
    size = x.shape[dim] // lay.k
    return x.narrow(dim, lay.j * size, size)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLSTMState(NamedTuple):
    c: torch.Tensor   # [B, H, dk, dv] float32
    n: torch.Tensor   # [B, H, dk] float32


def init_mlstm(b: Builder, name: str, cfg) -> None:
    sub = b.sub(name)
    d = cfg.d_model
    di, nh, hd = _dims(cfg)
    sub.add("up_proj", (d, 2 * di), ("embed", "ff"))
    # headwise (block-diagonal) q/k/v projections, per the xLSTM paper
    sub.add("wq", (nh, hd, hd), ("heads", None, "head_dim"), fan_in=hd)
    sub.add("wk", (nh, hd, hd), ("heads", None, "head_dim"), fan_in=hd)
    sub.add("wv", (nh, hd, hd), ("heads", None, "head_dim"), fan_in=hd)
    sub.add("wi", (di, nh), ("ff", "heads"), scale=0.02)
    sub.add("wf", (di, nh), ("ff", "heads"), scale=0.02)
    sub.add("bi", (nh,), ("heads",), init="zeros")
    # positive forget bias -> long memory at init (paper init)
    sub.constant("bf", torch.full((nh,), 3.0, dtype=_F32), ("heads",))
    sub.add("gn_scale", (di,), ("ff",), init="ones")
    sub.add("down_proj", (di, d), ("ff", "embed"))


def _mlstm_gates(params, xi, lay=None):
    """xi [B, N, di] -> (q, k, v [B,H,N,hd], log_f [B,H,N], i [B,H,N]);
    under a split (`lay`) xi holds the rank's channels and the result its
    heads, v the rank's slice of their value dim."""
    if lay is None:
        wq, wk, wv, bf, bi = (params[n] for n in ("wq", "wk", "wv", "bf",
                                                  "bi"))
        xh = xi
    else:
        wq, wk, wv, bf, bi = (_heads(params, n, lay)
                              for n in ("wq", "wk", "wv", "bf", "bi"))
        # the rank's heads whole: a head's slices gathered over its ranks
        xh = xi if lay.k == 1 else P.gather_sum(xi, -1, lay.group)
        wv = _slice(wv, 2, lay)
    nh, hd = wq.shape[0], wq.shape[1]
    xh = xh.reshape(xh.shape[0], xh.shape[1], nh, hd)
    q = torch.einsum("bnhk,hkl->bhnl", xh, wq)
    k = torch.einsum("bnhk,hkl->bhnl", xh, wk) / math.sqrt(hd)
    v = torch.einsum("bnhk,hkl->bhnl", xh, wv)
    fpre, ipre = _dense(xi, params["wf"]), _dense(xi, params["wi"])
    if lay is not None:
        # wi, wf contract all of d_inner: partial sums over "model"
        fi = P.psum(torch.stack([fpre, ipre]))
        fi = fi[..., lay.h0:lay.h0 + lay.nl]
        fpre, ipre = fi[0], fi[1]
    fpre = fpre.transpose(1, 2) + bf[:, None]
    ipre = ipre.transpose(1, 2) + bi[:, None]
    log_f = F.logsigmoid(fpre.to(_F32))
    ig = torch.exp(torch.clamp(ipre.to(_F32), max=_ICAP))
    return q, k, v, log_f, ig


def _mlstm_chunk_scan(q, k, v, log_f, ig, c0, n0, *, chunk):
    """Chunked gated linear attention. q, k [B,H,N,dk], v [B,H,N,dv],
    log_f, ig [B,H,N]; carry (c0 [B,H,dk,dv], n0 [B,H,dk]). Returns
    (h [B,H,N,dv], (c, n))."""
    n = q.shape[2]
    cs = min(chunk, n)
    c_prev, n_prev, hs = c0, n0, []
    for s in range(0, n, cs):
        qc, kc, vc = q[:, :, s:s + cs], k[:, :, s:s + cs], v[:, :, s:s + cs]
        lfc, igc = log_f[..., s:s + cs], ig[..., s:s + cs]
        m = qc.shape[2]
        lcum = torch.cumsum(lfc, dim=-1)                 # [B,H,c] ≤ 0
        # intra: w_ij = exp(lcum_i - lcum_j) * ig_j, j <= i (ratio ≤ 1)
        ratio = torch.exp(lcum[..., :, None] - lcum[..., None, :])
        tri = torch.tril(torch.ones(m, m, dtype=_F32, device=q.device))
        w = ratio * igc[..., None, :] * tri
        s_ = torch.matmul(qc, kc.transpose(-1, -2)) * w
        num = torch.matmul(s_, vc)
        den = s_.sum(dim=-1)
        # inter: the carry, scaled by exp(lcum_i)
        scale_i = torch.exp(lcum)
        num = num + scale_i[..., None] * torch.matmul(qc, c_prev)
        den = den + scale_i * torch.matmul(qc, n_prev[..., None])[..., 0]
        hs.append(num / torch.clamp(den.abs(), min=1.0)[..., None])
        # carry: decay by the chunk's total forget, add its contributions
        tot = lcum[..., -1:]
        dec_j = torch.exp(tot - lcum) * igc              # [B,H,c]
        c_prev = torch.exp(tot)[..., None] * c_prev + torch.matmul(
            (kc * dec_j[..., None]).transpose(-1, -2), vc)
        n_prev = torch.exp(tot) * n_prev + (kc * dec_j[..., None]).sum(-2)
    return torch.cat(hs, dim=2), (c_prev, n_prev)


def _mlstm_layout(params, cfg):
    _, nh, hd = _dims(cfg)
    return _layout(params, "down_proj", nh, hd)


def _mlstm_in(params, x, lay):
    """(xi, z) of x [B, N, d]: the rank's channels of each under a split
    (x entering the tensor-parallel region)."""
    w = params["up_proj"]
    if lay is not None:
        x, w = P.tp_enter(x), P.halves(w, 1)
    return _dense(x, w).chunk(2, dim=-1)


def _mlstm_out(params, h, z, nh: int, lay, dtype):
    """h [B, H, N, dv] -> the block's output: the per-head norm (on h's
    values, cast to `dtype`), the scale, the output gate z and down_proj
    (row-parallel under a split)."""
    bsz, _, n, _ = h.shape
    h = h.transpose(1, 2).reshape(bsz, n, -1)
    if lay is None or lay.k == 1:
        h = _headwise_norm(h, nh if lay is None else lay.nl, dtype)
    else:
        h = _headwise_norm(h, 1, dtype, group=lay.group, width=lay.hd)
    out = _dense(h * params["gn_scale"] * F.silu(z), params["down_proj"])
    return out if lay is None else P.tp_exit(out)


def _mlstm(params, x, cfg, c0, n0):
    """The mLSTM block over x [B, N, d] from (c0, n0): (out, c, n).
    Under a split c0 is the rank's value slice and n0 its heads' whole
    normalizer (the result's n too)."""
    _, nh, _ = _dims(cfg)
    lay = _mlstm_layout(params, cfg)
    xi, z = _mlstm_in(params, x, lay)
    q, k, v, log_f, ig = _mlstm_gates(params, xi, lay)
    h, (cf, nf) = _mlstm_chunk_scan(
        q.to(_F32), k.to(_F32), v.to(_F32), log_f, ig, c0, n0,
        chunk=min(cfg.chunk_size, 128))
    return _mlstm_out(params, h.to(x.dtype), z, nh, lay, x.dtype), cf, nf


def apply_mlstm_stateful(params, x, cfg, state: MLSTMState):
    """mLSTM over x [B, N, d] resumed from `state`. Returns (out, state),
    the state updated in place."""
    lay = _mlstm_layout(params, cfg)
    n0 = state.n
    if lay is not None and lay.k > 1:
        # the head's whole normalizer from its ranks' key slices
        with torch.no_grad():
            n0 = P.gather_sum(n0, -1, lay.group)
    out, cf, nf = _mlstm(params, x, cfg, state.c, n0)
    state.c.copy_(cf)
    state.n.copy_(nf if n0 is state.n else _slice(nf, -1, lay))
    return out, state


def apply_mlstm(params, x, cfg):
    """Full-sequence mLSTM from a zero state (differentiable); under a
    split the rank's state, its heads' normalizer whole."""
    lay = _mlstm_layout(params, cfg)
    _, nh, hd = _dims(cfg)
    nl, dv = (nh, hd) if lay is None else (lay.nl, hd // lay.k)
    c0 = torch.zeros(x.shape[0], nl, hd, dv, dtype=_F32, device=x.device)
    n0 = torch.zeros(x.shape[0], nl, hd, dtype=_F32, device=x.device)
    return _mlstm(params, x, cfg, c0, n0)[0]


def init_mlstm_state(cfg, batch: int, device=None,
                     model: int = 1) -> MLSTMState:
    """A fresh state; with `model` > 1, a rank's under the placed step's
    split: its heads' C with the rank's slice of their value dim, n with
    its slice of their key dim."""
    di, nh, hd = _dims(cfg)
    nl, part = (nh, hd) if di % model else _local_dims(nh, hd, model)
    return MLSTMState(
        c=torch.zeros(batch, nl, hd, part, dtype=_F32, device=device),
        n=torch.zeros(batch, nl, part, dtype=_F32, device=device))


def mlstm_decode(params, x_t, state: MLSTMState, cfg):
    """One-token decode. x_t [B, 1, d]. Returns (out [B, 1, d], state),
    the state updated in place."""
    _, nh, _ = _dims(cfg)
    lay = _mlstm_layout(params, cfg)
    xi, z = _mlstm_in(params, x_t, lay)
    q, k, v, log_f, ig = _mlstm_gates(params, xi, lay)
    q, k, v = (t[:, :, 0].to(_F32) for t in (q, k, v))
    f = torch.exp(log_f[..., 0])
    i = ig[..., 0]
    c = f[..., None, None] * state.c + i[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    num = torch.matmul(q[..., None, :], c)[..., 0, :]
    if lay is None or lay.k == 1:
        nn_ = f[..., None] * state.n + i[..., None] * k
        den = (q * nn_).sum(dim=-1)
    else:
        # the rank's key slice of n; q·n summed over the head's ranks
        nn_ = f[..., None] * state.n + i[..., None] * _slice(k, -1, lay)
        den = P.psum((_slice(q, -1, lay) * nn_).sum(dim=-1), lay.group)
    h = num / torch.clamp(den.abs(), min=1.0)[..., None]
    out = _mlstm_out(params, h[:, :, None], z, nh, lay, x_t.dtype)
    state.c.copy_(c)
    state.n.copy_(nn_)
    return out, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTMState(NamedTuple):
    c: torch.Tensor  # [B, di] float32
    n: torch.Tensor  # [B, di] float32
    m: torch.Tensor  # [B, di] float32, the log-stabilizer (starts at -1e9)
    h: torch.Tensor  # [B, di] the activation dtype


def _sdims(cfg):
    di = cfg.d_model                 # sLSTM operates at model width
    nh = cfg.n_heads
    return di, nh, di // nh


def init_slstm(b: Builder, name: str, cfg) -> None:
    sub = b.sub(name)
    d = cfg.d_model
    di, nh, hd = _sdims(cfg)
    for gate in _GATES:
        sub.add(f"w{gate}", (d, di), ("embed", "ff"))
        # recurrent weights: block-diagonal per head [H, hd, hd]
        sub.add(f"r{gate}", (nh, hd, hd), ("heads", None, None),
                fan_in=hd)
        sub.add(f"b{gate}", (di,), ("ff",),
                init="zeros" if gate != "f" else "ones")
    sub.add("gn_scale", (di,), ("ff",), init="ones")
    sub.add("down_proj", (di, d), ("ff", "embed"))


def _slstm_layout(params, cfg):
    _, nh, hd = _sdims(cfg)
    return _layout(params, "down_proj", nh, hd)


def _slstm_weights(params, cfg, lay):
    """(w [d, 4, width], r [H, hd, 4·hd], bias [4, width]) of the heads
    the rank computes whole: all heads, the rank's heads (k = 1), or its
    one head with the columns gathered over the head's ranks."""
    _, nh, hd = _sdims(cfg)
    w = torch.stack([params[f"w{g}"] for g in _GATES], dim=1)
    bias = torch.stack([params[f"b{g}"] for g in _GATES])
    if lay is None:
        r = [params[f"r{g}"] for g in _GATES]
    else:
        r = [_heads(params, f"r{g}", lay) for g in _GATES]
        if lay.k > 1:
            w = P.gather_sum(w, -1, lay.group)
            bias = P.gather_sum(bias, -1, lay.group)
        nh = lay.nl
    return w, torch.stack(r, dim=2).reshape(nh, hd, 4 * hd), bias


def _slstm_scan(params, x, cfg, state: SLSTMState):
    """The recurrence over x [B, N, d] from `state`: (h [B, N, di], the
    final (c, n, m, h)). Each step is the reference's `_slstm_step`: gate
    pre-activations (x_t·W + h_{t-1}·R) + b, the input and forget gates in
    float32 with the log-stabilizer m. Under a split x has entered the
    tensor-parallel region and `state` is the heads the rank computes
    whole; so is the result."""
    bsz, n, _ = x.shape
    _, _, hd = _sdims(cfg)
    w, r, bias = _slstm_weights(params, cfg, _slstm_layout(params, cfg))
    nh, di = r.shape[0], bias.shape[1]
    wx = _dense(x, w.reshape(w.shape[0], -1)).reshape(bsz, n, 4, di)
    c, nn_, m, h = state
    hs = []
    for t in range(n):
        rh = torch.einsum("bhk,hkl->bhl", h.reshape(bsz, nh, hd), r)
        rh = rh.reshape(bsz, nh, 4, hd).transpose(1, 2).reshape(bsz, 4, di)
        g = wx[:, t] + rh + bias                             # [B, 4, di]
        z = torch.tanh(g[:, 0])
        o = torch.sigmoid(g[:, 3])
        itil = g[:, 1].to(_F32)
        log_f = F.logsigmoid(g[:, 2].to(_F32))
        m_new = torch.maximum(log_f + m, itil)
        i_p = torch.exp(itil - m_new)
        f_p = torch.exp(log_f + m - m_new)
        c = f_p * c + i_p * z.to(_F32)
        nn_ = f_p * nn_ + i_p
        m = m_new
        h = (o.to(_F32) * c / torch.clamp(nn_, min=1e-6)).to(x.dtype)
        hs.append(h)
    return torch.stack(hs, dim=1), (c, nn_, m, h)


def _slstm_out(params, h, cfg, dtype):
    """The per-head norm of h [B, N, width] (the heads the rank computes),
    the scale and down_proj; under a split the rank's slice of a head
    computed whole on its ranks, down_proj row-parallel."""
    _, nh, _ = _sdims(cfg)
    lay = _slstm_layout(params, cfg)
    hn = _headwise_norm(h, nh if lay is None else lay.nl, dtype)
    if lay is not None and lay.k > 1:
        hn = _slice(hn, -1, lay)
    out = _dense(hn * params["gn_scale"], params["down_proj"])
    return out if lay is None else P.tp_exit(out)


def _slstm_enter(params, x, cfg):
    """x entering the tensor-parallel region under a split; else x."""
    return x if _slstm_layout(params, cfg) is None else P.tp_enter(x)


def apply_slstm_stateful(params, x, cfg, state: SLSTMState):
    """sLSTM over x [B, N, d] resumed from `state`. Returns (out, state),
    the state updated in place (under a split the rank's slice of it; a
    head computed whole on its ranks gathers their slices first)."""
    lay = _slstm_layout(params, cfg)
    whole = lay is not None and lay.k > 1
    st = state
    if whole:
        with torch.no_grad():
            st = SLSTMState(*(P.gather_sum(t, -1, lay.group)
                              for t in state))
    hs, final = _slstm_scan(params, _slstm_enter(params, x, cfg), cfg, st)
    for dst, src in zip(state, final):
        dst.copy_(_slice(src, -1, lay) if whole else src)
    return _slstm_out(params, hs, cfg, x.dtype), state


def apply_slstm(params, x, cfg):
    """Full-sequence sLSTM from a fresh state (differentiable)."""
    lay = _slstm_layout(params, cfg)
    _, nh, hd = _sdims(cfg)
    width = None if lay is None else lay.nl * hd
    st = init_slstm_state(cfg, x.shape[0], x.dtype, device=x.device,
                          width=width)
    hs = _slstm_scan(params, _slstm_enter(params, x, cfg), cfg, st)[0]
    return _slstm_out(params, hs, cfg, x.dtype)


def init_slstm_state(cfg, batch: int, dtype, device=None, model: int = 1,
                     width=None) -> SLSTMState:
    """A fresh state, `width` channels wide (default: d_model, or a
    rank's d_model / `model` under the placed step's split)."""
    di, _, _ = _sdims(cfg)
    if width is None:
        width = di if di % model else di // model

    def full(v, dt):
        return torch.full((batch, width), v, dtype=dt, device=device)

    return SLSTMState(c=full(0.0, _F32), n=full(0.0, _F32),
                      m=full(-1e9, _F32), h=full(0.0, dtype))


def slstm_decode(params, x_t, state: SLSTMState, cfg):
    """One-token decode. x_t [B, 1, d]. Returns (out [B, 1, d], state),
    the state updated in place."""
    return apply_slstm_stateful(params, x_t, cfg, state)
