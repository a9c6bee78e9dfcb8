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
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense
from repro_torch.models.param import Builder

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


def _headwise_norm(h, nh: int, out_dtype):
    """Per-head RMS norm of h [B, N, di] (no scale), computed in float32 on
    h's values, cast to `out_dtype`."""
    bsz, n, di = h.shape
    hn = h.reshape(bsz, n, nh, di // nh)
    var = hn.to(_F32).square().mean(dim=-1, keepdim=True)
    return (hn * torch.rsqrt(var + 1e-6)).reshape(bsz, n, di).to(out_dtype)


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


def _mlstm_gates(params, xi):
    """xi [B, N, di] -> (q, k, v [B,H,N,hd], log_f [B,H,N], i [B,H,N])."""
    nh, hd = params["wq"].shape[0], params["wq"].shape[1]
    xh = xi.reshape(xi.shape[0], xi.shape[1], nh, hd)
    q = torch.einsum("bnhk,hkl->bhnl", xh, params["wq"])
    k = torch.einsum("bnhk,hkl->bhnl", xh, params["wk"]) / math.sqrt(hd)
    v = torch.einsum("bnhk,hkl->bhnl", xh, params["wv"])
    fpre = _dense(xi, params["wf"]).transpose(1, 2) + params["bf"][:, None]
    ipre = _dense(xi, params["wi"]).transpose(1, 2) + params["bi"][:, None]
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


def _mlstm(params, x, cfg, c0, n0):
    """The mLSTM block over x [B, N, d] from (c0, n0): (out, c, n)."""
    bsz, n, _ = x.shape
    di, nh, _ = _dims(cfg)
    ug = _dense(x, params["up_proj"])
    xi, z = ug.chunk(2, dim=-1)
    q, k, v, log_f, ig = _mlstm_gates(params, xi)
    h, (cf, nf) = _mlstm_chunk_scan(
        q.to(_F32), k.to(_F32), v.to(_F32), log_f, ig, c0, n0,
        chunk=min(cfg.chunk_size, 128))
    h = h.transpose(1, 2).reshape(bsz, n, di).to(x.dtype)
    h = _headwise_norm(h, nh, x.dtype) * params["gn_scale"] * F.silu(z)
    return _dense(h, params["down_proj"]), cf, nf


def apply_mlstm_stateful(params, x, cfg, state: MLSTMState):
    """mLSTM over x [B, N, d] resumed from `state`. Returns (out, state),
    the state updated in place."""
    out, cf, nf = _mlstm(params, x, cfg, state.c, state.n)
    state.c.copy_(cf)
    state.n.copy_(nf)
    return out, state


def apply_mlstm(params, x, cfg):
    """Full-sequence mLSTM from a zero state (differentiable)."""
    st = init_mlstm_state(cfg, x.shape[0], device=x.device)
    return _mlstm(params, x, cfg, st.c, st.n)[0]


def init_mlstm_state(cfg, batch: int, device=None) -> MLSTMState:
    _, nh, hd = _dims(cfg)
    return MLSTMState(
        c=torch.zeros(batch, nh, hd, hd, dtype=_F32, device=device),
        n=torch.zeros(batch, nh, hd, dtype=_F32, device=device))


def mlstm_decode(params, x_t, state: MLSTMState, cfg):
    """One-token decode. x_t [B, 1, d]. Returns (out [B, 1, d], state),
    the state updated in place."""
    bsz = x_t.shape[0]
    di, nh, hd = _dims(cfg)
    ug = _dense(x_t, params["up_proj"])
    xi, z = ug.chunk(2, dim=-1)
    q, k, v, log_f, ig = _mlstm_gates(params, xi)
    q, k, v = (t[:, :, 0].to(_F32) for t in (q, k, v))
    f = torch.exp(log_f[..., 0])
    i = ig[..., 0]
    c = f[..., None, None] * state.c + i[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    nn_ = f[..., None] * state.n + i[..., None] * k
    num = torch.matmul(q[..., None, :], c)[..., 0, :]
    den = (q * nn_).sum(dim=-1)
    h = num / torch.clamp(den.abs(), min=1.0)[..., None]
    h = _headwise_norm(h.reshape(bsz, 1, di), nh, x_t.dtype)
    h = h * params["gn_scale"] * F.silu(z)
    out = _dense(h, params["down_proj"])
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


def _slstm_scan(params, x, cfg, state: SLSTMState):
    """The recurrence over x [B, N, d] from `state`: (h [B, N, di], the
    final (c, n, m, h)). Each step is the reference's `_slstm_step`: gate
    pre-activations (x_t·W + h_{t-1}·R) + b, the input and forget gates in
    float32 with the log-stabilizer m."""
    bsz, n, _ = x.shape
    di, nh, hd = _sdims(cfg)
    wx = torch.stack([_dense(x, params[f"w{g}"]) for g in _GATES], dim=2)
    # the four recurrent head-wise products as one: [H, hd, 4·hd]
    r = torch.stack([params[f"r{g}"] for g in _GATES], dim=2) \
        .reshape(nh, hd, 4 * hd)
    bias = torch.stack([params[f"b{g}"] for g in _GATES])     # [4, di]
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
    _, nh, _ = _sdims(cfg)
    hn = _headwise_norm(h, nh, dtype)
    return _dense(hn * params["gn_scale"], params["down_proj"])


def apply_slstm_stateful(params, x, cfg, state: SLSTMState):
    """sLSTM over x [B, N, d] resumed from `state`. Returns (out, state),
    the state updated in place."""
    hs, final = _slstm_scan(params, x, cfg, state)
    for dst, src in zip(state, final):
        dst.copy_(src)
    return _slstm_out(params, hs, cfg, x.dtype), state


def apply_slstm(params, x, cfg):
    """Full-sequence sLSTM from a fresh state (differentiable)."""
    st = init_slstm_state(cfg, x.shape[0], x.dtype, device=x.device)
    return _slstm_out(params, _slstm_scan(params, x, cfg, st)[0], cfg,
                      x.dtype)


def init_slstm_state(cfg, batch: int, dtype, device=None) -> SLSTMState:
    di, _, _ = _sdims(cfg)

    def full(v, dt):
        return torch.full((batch, di), v, dtype=dt, device=device)

    return SLSTMState(c=full(0.0, _F32), n=full(0.0, _F32),
                      m=full(-1e9, _F32), h=full(0.0, dtype))


def slstm_decode(params, x_t, state: SLSTMState, cfg):
    """One-token decode. x_t [B, 1, d]. Returns (out [B, 1, d], state),
    the state updated in place."""
    return apply_slstm_stateful(params, x_t, cfg, state)
