"""Model layers for the dense GQA decoder — port of `repro/models/layers.py`.

RMS norms (computed in float32 and cast back, as the reference does), RoPE
in the half-split layout, the SwiGLU MLP, GQA projections with optional
bias and qk_norm, full-sequence attention (training), and the attention
prefill/decode steps over the `repro_torch.attention` state protocol.
LayerNorm, GELU and the MLA projections come with the architectures that
use them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import attention as A
from repro_torch.attention import AttnState
from repro_torch.models.param import Builder

_F32 = torch.float32

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(b: Builder, name: str, dim: int):
    b.sub(name).add("scale", (dim,), init="ones")


def apply_norm(params, x, *, norm_type: str = "rmsnorm", eps: float = 1e-5):
    if norm_type != "rmsnorm":
        raise NotImplementedError(f"norm_type={norm_type!r} is not ported")
    xf = x.to(_F32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"].to(_F32)
    return out.to(x.dtype)


def rms_norm_headwise(x, eps: float = 1e-6):
    """Parameter-free per-head RMS norm (qk_norm; callers apply the scale)."""
    xf = x.to(_F32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=_F32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x [B, H, N, D]; positions [B, N] or [N]. Half-split layout: the
    first D/2 features pair with the last D/2."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[:, None, :, None].to(_F32) * freqs     # [B,1,N,D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.to(_F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(b: Builder, name: str, d_model: int, d_ff: int):
    sub = b.sub(name)
    sub.add("wi_gate", (d_model, d_ff))
    sub.add("wi_up", (d_model, d_ff))
    sub.add("wo", (d_ff, d_model))


def apply_mlp(params, x, *, act: str = "swiglu"):
    if act != "swiglu":
        raise NotImplementedError(f"mlp_act={act!r} is not ported")
    g = torch.einsum("bnd,df->bnf", x, params["wi_gate"])
    u = torch.einsum("bnd,df->bnf", x, params["wi_up"])
    return torch.einsum("bnf,fd->bnd", F.silu(g) * u, params["wo"])


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------


def init_attention(b: Builder, name: str, cfg) -> None:
    sub = b.sub(name)
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sub.add("wq", (d, hq, hd))
    sub.add("wk", (d, hkv, hd))
    sub.add("wv", (d, hkv, hd))
    sub.add("wo", (hq, hd, d), fan_in=hq * hd)
    if cfg.qkv_bias:
        sub.add("bq", (hq, hd), init="zeros")
        sub.add("bk", (hkv, hd), init="zeros")
        sub.add("bv", (hkv, hd), init="zeros")
    if cfg.qk_norm:
        sub.add("q_norm_scale", (hd,), init="ones")
        sub.add("k_norm_scale", (hd,), init="ones")


def _project_qkv(params, x, cfg, positions):
    """q [B,Hq,N,D], k [B,Hkv,N,D], v [B,Hkv,N,Dv]."""
    q = torch.einsum("bnd,dhk->bhnk", x, params["wq"])
    k = torch.einsum("bnd,dhk->bhnk", x, params["wk"])
    v = torch.einsum("bnd,dhk->bhnk", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"][None, :, None, :]
        k = k + params["bk"][None, :, None, :]
        v = v + params["bv"][None, :, None, :]
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.qk_norm:
        q = rms_norm_headwise(q) * params["q_norm_scale"]
        k = rms_norm_headwise(k) * params["k_norm_scale"]
    return q, k, v


def apply_attention(params, x, cfg):
    """Full-sequence causal self-attention (training forward). x [B, N, d]."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    o = A.attention(q, k, v, cfg.attn_spec, causal=True)
    return torch.einsum("bhnk,hkd->bnd", o.to(x.dtype), params["wo"])


def init_attn_state(cfg, batch: int, max_len: int, dtype,
                    device=None) -> AttnState:
    return A.init_state(cfg.attn_spec, batch=batch, n_kv_heads=cfg.n_kv_heads,
                        q_head_dim=cfg.head_dim, v_head_dim=cfg.head_dim,
                        max_len=max_len, dtype=dtype, device=device)


def attention_decode(params, x_t, state: AttnState, cfg, *, position):
    """One-token decode. x_t [B, 1, d]; `position` a scalar or [B],
    best a tensor already on x_t's device: a Python int is copied to the
    card, and that copy waits for the card to finish its queued work.
    Returns (y_t, state) with `state` updated in place."""
    pos = torch.as_tensor(position, device=x_t.device).reshape(-1)[:, None]
    q, k, v = _project_qkv(params, x_t, cfg, pos)
    o, state = A.step(state, q, k, v, cfg.attn_spec)
    y = torch.einsum("bhnk,hkd->bnd", o.to(x_t.dtype), params["wo"])
    return y, state


def attention_prefill(params, x, state: AttnState, cfg, *, positions=None,
                      kv_mask=None, offset=None):
    """Prefill a prompt; returns (y, state) with the layer's state primed
    in place. With `offset` the tokens sit at [offset, offset + n)."""
    n = x.shape[1]
    if positions is None:
        off = 0 if offset is None else offset
        positions = off + torch.arange(n, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    o, state = A.prefill(q, k, v, cfg.attn_spec, state=state,
                         kv_mask=kv_mask, offset=offset)
    y = torch.einsum("bhnk,hkd->bnd", o.to(x.dtype), params["wo"])
    return y, state
