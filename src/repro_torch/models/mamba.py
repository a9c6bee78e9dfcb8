"""Mamba (selective SSM) mixer — port of `repro/models/mamba.py`, for
the jamba hybrid architecture.

h_t = exp(Δ_t A)·h_{t-1} + Δ_t·B_t·u_t and y_t = C_t·h_t + D·u_t over a
[B, d_inner, d_state] float32 state, evaluated in chunks of `chunk`
tokens so that the per-token states of one chunk, [B, chunk, d_inner,
d_state], are the largest tensor; decode carries (the last d_conv - 1
conv inputs, h) and costs O(1) per token. The reference's float32 islands
are kept: the scan's inputs, `A` and `D` are float32 even in a float64
model, the decode step folds Δ·u in the activation dtype before its cast.

The scan inside a chunk. The reference runs `lax.associative_scan` with
the combine (a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2). torch has no
associative scan, and turning the recurrence into a cumulative sum
through exp(-cumsum(Δ·A)) is not an option: Δ·A reaches -16·softplus(·)
per token, so that sum over a 512-token chunk leaves float32's exp
range. This port runs a Hillis–Steele doubling scan with the reference's
own combine: log2(chunk) steps, each one combine of every token with the
token 2^j before it (9 steps at jamba's chunk of 512, each over [B, 512,
8192, 16] float32, 1.07 GB per operand at B = 4: a few GB of
temporaries, a few dozen launches per chunk, where a per-token loop would
take about four launches per token). It is bound by memory traffic, about
a dozen operand passes per step: on an H100 one jamba Mamba layer's
prefill at B = 4, N = 1024 takes 99 ms (`chip_smoke.py [ssm]`). Chunks
are not padded: the last one runs at its own length (the reference pads,
harmless there because Δ = 0 gives da = 1, dbu = 0).

Stateful calls (`mamba_prefill`, `mamba_decode`) update the given
`MambaState` IN PLACE (`copy_`), as the attention layers do: the state may
be a view into a stacked [n_groups, ...] model state or into one slot of
a serving pool. FAST does not apply to this mixer (it is
attention-free); the reference has no kernel for it, so plain torch is
its only version, on the card too.

Under the placed step's SSM split (`sharding.placed`, the leaves' "ff"
shards over "model") a rank computes its d_inner / model channels: x
enters through `tp_enter`, in_proj's shard is exchanged for the rank's
columns of xi and of z (`placed.halves`), the conv, dt_proj, dt_bias,
A_log, D and the scan are per channel, x_proj is row-parallel with its
[B, N, dt_rank + 2·d_state] output summed over "model" forward and
backward (`placed.psum`: Δ, B and C feed the rank's channels only), and
out_proj is row-parallel through `tp_exit`. A rank's decode state is its
channels' (`init_mamba_state(..., model=m)`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _dense
from repro_torch.models.param import Builder
from repro_torch.sharding import placed as P

__all__ = ["MambaState", "init_mamba", "apply_mamba", "mamba_prefill",
           "mamba_decode", "init_mamba_state"]

_F32 = torch.float32


class MambaState(NamedTuple):
    conv: torch.Tensor  # [B, d_conv-1, d_inner], the activation dtype
    h: torch.Tensor     # [B, d_inner, d_state] float32


def _dims(cfg):
    di = cfg.mamba_expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return di, dt_rank, cfg.mamba_d_state, cfg.mamba_d_conv


def init_mamba(b: Builder, name: str, cfg) -> None:
    sub = b.sub(name)
    d = cfg.d_model
    di, dt_rank, ds, dc = _dims(cfg)
    sub.add("in_proj", (d, 2 * di), ("embed", "ff"))
    sub.add("conv_w", (dc, di), (None, "ff"), scale=1.0 / math.sqrt(dc))
    sub.add("conv_b", (di,), ("ff",), init="zeros")
    sub.add("x_proj", (di, dt_rank + 2 * ds), ("ff", None))
    sub.add("dt_proj", (dt_rank, di), (None, "ff"), scale=dt_rank ** -0.5)
    sub.add("dt_bias", (di,), ("ff",), init="zeros")
    # S4D-real init: A = -[1..ds] per channel (the log taken in float32)
    a = torch.arange(1, ds + 1, dtype=_F32).expand(di, ds)
    sub.constant("A_log", torch.log(a), ("ff", None))
    sub.add("D", (di,), ("ff",), init="ones")
    sub.add("out_proj", (di, d), ("ff", "embed"))


def _causal_conv(x, w, b_, *, state=None):
    """Depthwise causal conv of kernel dc over x [B, N, di], after the
    carried `state` (the last dc - 1 inputs; zeros without one). Returns
    (out, new state): the last dc - 1 rows of [state, x], so a chunk
    shorter than dc - 1 keeps part of the old state."""
    dc = w.shape[0]
    if state is None:
        pad = x.new_zeros(x.shape[0], dc - 1, x.shape[2])
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    n = x.shape[1]
    out = sum(xp[:, i:i + n] * w[i][None, None, :] for i in range(dc))
    new_state = xp[:, -(dc - 1):] if dc > 1 else pad
    return out + b_[None, None, :], new_state


def _doubling_scan(a, b):
    """Inclusive scan over axis 1 of the pairs (a_t, b_t) under the
    reference's combine (a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2):
    Hillis–Steele, ceil(log2 n) steps, out of place (autograd-safe)."""
    n, k = a.shape[1], 1
    while k < n:
        b = torch.cat([b[:, :k], torch.addcmul(b[:, k:], a[:, k:],
                                               b[:, :-k])], dim=1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return a, b


def _selective_scan(u, delta, a, bmat, cmat, d_skip, *, h0, chunk=128):
    """h_t = exp(Δ_t A)·h_{t-1} + Δ_t·B_t·u_t ;  y_t = C_t·h_t + D·u_t.

    u, delta [B, N, di]; bmat, cmat [B, N, ds]; a [di, ds]; h0
    [B, di, ds]. Chunks of `chunk` tokens, each a doubling scan seeded
    with the carry. Returns (y [B, N, di], h_final)."""
    n = u.shape[1]
    cs = min(chunk, n)
    h, ys = h0, []
    for s in range(0, n, cs):
        uc, dc_ = u[:, s:s + cs], delta[:, s:s + cs]
        bc, cc = bmat[:, s:s + cs], cmat[:, s:s + cs]
        da = torch.exp(dc_[..., None] * a[None, None])       # [B,c,di,ds]
        dbu = (dc_ * uc)[..., None] * bc[:, :, None, :]       # [B,c,di,ds]
        a_cum, b_cum = _doubling_scan(da, dbu)
        del da, dbu
        hseq = torch.addcmul(b_cum, a_cum, h[:, None])       # [B,c,di,ds]
        del a_cum, b_cum
        ys.append(torch.matmul(hseq, cc[..., None])[..., 0])  # [B,c,di]
        h = hseq[:, -1].contiguous()   # frees the chunk's states
    y = torch.cat(ys, dim=1)
    return y + u * d_skip[None, None, :], h


def _split(params) -> bool:
    """Whether the gathered leaves hold the rank's channels (the placed
    step's SSM split): out_proj row-parallel over "model"."""
    return P.model_dim(params["out_proj"]) == 0


def _pre_ssm(params, x, cfg, conv_state=None):
    _, dt_rank, ds, _ = _dims(cfg)
    w_in = params["in_proj"]
    if _split(params):
        x = P.tp_enter(x)
        w_in = P.halves(w_in, 1)
    xz = _dense(x, w_in)
    xi, z = xz.chunk(2, dim=-1)
    xi, new_conv = _causal_conv(xi, params["conv_w"], params["conv_b"],
                                state=conv_state)
    xi = F.silu(xi)
    proj = _dense(xi, params["x_proj"])
    if _split(params):
        proj = P.psum(proj)
    dt, bmat, cmat = proj.split([dt_rank, ds, ds], dim=-1)
    delta = F.softplus(_dense(dt, params["dt_proj"]) + params["dt_bias"])
    a = -torch.exp(params["A_log"].to(_F32))
    return xi, z, delta, a, bmat, cmat, new_conv


def _ssm(params, x, cfg, h0, conv_state=None):
    """The block over x [B, N, d] from (conv_state, h0): (out, new conv
    state, h_final)."""
    xi, z, delta, a, bmat, cmat, conv = _pre_ssm(params, x, cfg,
                                                 conv_state=conv_state)
    y, hf = _selective_scan(
        xi.to(_F32), delta.to(_F32), a, bmat.to(_F32), cmat.to(_F32),
        params["D"].to(_F32), h0=h0, chunk=cfg.chunk_size)
    y = y.to(x.dtype) * F.silu(z)
    return _out(params, y), conv, hf


def _out(params, y):
    out = _dense(y, params["out_proj"])
    return P.tp_exit(out) if _split(params) else out


def apply_mamba(params, x, cfg):
    """Full-sequence Mamba mixer from a zero state. x [B, N, d] (under
    the sequence split the rank's slice of N)."""
    # the rank's channels under the placed step's split
    di, ds = params["A_log"].shape
    h0 = torch.zeros(x.shape[0], di, ds, dtype=_F32, device=x.device)
    return _ssm(params, x, cfg, h0)[0]


def mamba_prefill(params, x, cfg, state: MambaState):
    """Prefill x [B, N, d] (any N ≥ 1) resumed from `state`, the prefill
    the reference inlines in `lm_prefill`. Returns (y, state), the state
    updated in place."""
    y, conv, hf = _ssm(params, x, cfg, state.h, conv_state=state.conv)
    state.conv.copy_(conv)
    state.h.copy_(hf)
    return y, state


def init_mamba_state(cfg, batch: int, dtype, device=None,
                     model: int = 1) -> MambaState:
    """A fresh state; with `model` > 1 dividing d_inner, the state of a
    rank's d_inner / model channels (the placed step's split)."""
    di, _, ds, dc = _dims(cfg)
    if di % model == 0:
        di //= model
    return MambaState(
        conv=torch.zeros(batch, dc - 1, di, dtype=dtype, device=device),
        h=torch.zeros(batch, di, ds, dtype=_F32, device=device))


def mamba_decode(params, x_t, state: MambaState, cfg):
    """One-token decode. x_t [B, 1, d]. Returns (out [B, 1, d], state),
    the state updated in place."""
    xi, z, delta, a, bmat, cmat, new_conv = _pre_ssm(
        params, x_t, cfg, conv_state=state.conv)
    da = torch.exp(delta[:, 0, :, None].to(_F32) * a[None])
    dbu = (delta * xi)[:, 0, :, None].to(_F32) \
        * bmat[:, 0, None, :].to(_F32)
    h = da * state.h + dbu
    y = torch.matmul(h, cmat[:, 0, :, None].to(_F32))[..., 0]
    y = y + xi[:, 0].to(_F32) * params["D"].to(_F32)
    y = y[:, None].to(x_t.dtype) * F.silu(z)
    out = _out(params, y)
    state.conv.copy_(new_conv)
    state.h.copy_(h)
    return out, state
