"""Model layers of the dense GQA transformer — port of
`repro/models/layers.py`.

RMS norms and LayerNorm (computed in float32 and cast back, as the
reference does), RoPE in the half-split layout, the SwiGLU and GELU MLPs,
GQA projections with optional bias and qk_norm, full-sequence attention
(causal or not, and cross-attention to another sequence), and the attention
prefill/decode steps over the `repro_torch.attention` state protocol. The
MLA projections come with the architectures that use them.
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


def init_norm(b: Builder, name: str, dim: int, norm_type: str = "rmsnorm"):
    sub = b.sub(name)
    sub.add("scale", (dim,), init="ones")
    if norm_type == "layernorm":
        sub.add("bias", (dim,), init="zeros")


def apply_norm(params, x, *, norm_type: str = "rmsnorm", eps: float = 1e-5):
    xf = x.to(_F32)
    if norm_type == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * params["scale"].to(_F32)
    elif norm_type == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)   # biased, as jnp
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * params["scale"].to(_F32) + params["bias"].to(_F32)
    else:
        raise ValueError(norm_type)
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


def init_mlp(b: Builder, name: str, d_model: int, d_ff: int,
             act: str = "swiglu"):
    sub = b.sub(name)
    if act == "swiglu":
        sub.add("wi_gate", (d_model, d_ff))
        sub.add("wi_up", (d_model, d_ff))
    else:
        sub.add("wi", (d_model, d_ff))
    sub.add("wo", (d_ff, d_model))


def apply_mlp(params, x, *, act: str = "swiglu"):
    if act == "swiglu":
        g = torch.einsum("bnd,df->bnf", x, params["wi_gate"])
        u = torch.einsum("bnd,df->bnf", x, params["wi_up"])
        h = F.silu(g) * u
    else:
        # the reference's jax.nn.gelu defaults to the tanh approximation;
        # this follows it, not OpenAI whisper's exact (erf) GELU
        h = F.gelu(torch.einsum("bnd,df->bnf", x, params["wi"]),
                   approximate="tanh")
    return torch.einsum("bnf,fd->bnd", h, params["wo"])


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


def _project_q(params, x, cfg, positions):
    """q [B,Hq,N,D]."""
    q = torch.einsum("bnd,dhk->bhnk", x, params["wq"])
    if cfg.qkv_bias:
        q = q + params["bq"][None, :, None, :]
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
    if cfg.qk_norm:
        q = rms_norm_headwise(q) * params["q_norm_scale"]
    return q


def _project_kv(params, x, cfg, positions):
    """k [B,Hkv,N,D], v [B,Hkv,N,Dv]."""
    k = torch.einsum("bnd,dhk->bhnk", x, params["wk"])
    v = torch.einsum("bnd,dhk->bhnk", x, params["wv"])
    if cfg.qkv_bias:
        k = k + params["bk"][None, :, None, :]
        v = v + params["bv"][None, :, None, :]
    if cfg.rope_theta > 0:
        k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.qk_norm:
        k = rms_norm_headwise(k) * params["k_norm_scale"]
    return k, v


def _project_qkv(params, x, cfg, positions):
    """q [B,Hq,N,D], k [B,Hkv,N,D], v [B,Hkv,N,Dv]."""
    return (_project_q(params, x, cfg, positions),
            *_project_kv(params, x, cfg, positions))


def apply_attention(params, x, cfg, *, causal=True, kv_mask=None,
                    kv_x=None):
    """Full-sequence attention. x [B, N, d]; `kv_x` [B, M, d] makes it
    cross-attention: q from x, k/v from kv_x at positions arange(M)."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    if kv_x is None:
        q, k, v = _project_qkv(params, x, cfg, positions)
    else:
        # the reference projects q from kv_x too and drops it
        q = _project_q(params, x, cfg, positions)
        kv_pos = torch.arange(kv_x.shape[1], dtype=torch.int32,
                              device=x.device)
        k, v = _project_kv(params, kv_x, cfg, kv_pos)
    o = A.attention(q, k, v, cfg.attn_spec, causal=causal, kv_mask=kv_mask)
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
