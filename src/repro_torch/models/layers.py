"""Model layers of the transformer — port of `repro/models/layers.py`.

RMS norms and LayerNorm (computed in float32 and cast back, as the
reference does), RoPE in the half-split layout, the SwiGLU and GELU MLPs,
GQA projections with optional bias and qk_norm, the MLA projections
(deepseek-v2: q at qk_nope_dim + qk_rope_dim per head, k and v
decompressed per query head from a kv_lora_rank latent, RoPE on the rope
part only, its key part shared by every head), full-sequence attention
(causal or not, and cross-attention to another sequence), and the attention
prefill/decode steps over the `repro_torch.attention` state protocol.

Under the placed step's tensor parallelism (`sharding.placed`: the dense
decoders' and whisper's towers' leaves keep their "model" shards, as do
the MoE configs' FFNs and attention mixers) the MLP and the attention
split their compute by the shards the layer's leaves hold: the
column-parallel products (wi, wq, and wk / wv where the kv heads divide
"model") take `tp_enter(x)`, the row-parallel wo's output `tp_exit`. A
cross-attention's (whisper's decoder, in training, prefill and each
decode step) q takes `tp_enter(x)` and its k and v the encoder's output,
whole on every rank, its grad summed over "model" (`sum_grad`). MLA's
wq, w_uk, w_uv and wo all carry the heads and split together (k and v
decompressed on the rank's heads: Hkv = Hq there too; a layer whose wq
and w_uk / w_uv disagree raises); w_dkv is whole over "model", and the
latent and the key's rope part it makes feed the rank's heads only, so
its grad takes `sum_grad`.
Where the kv heads do not divide "model" (MQA, or 8 kv heads on 16) k and
v are computed whole from x on every rank, q is gathered to whole heads,
the attention runs in the model's layout (the kernels' feature plan, or
the whole heads) and o is cut back to the rank's heads for wo. Serving
keeps every decode state as the rank's block of the reference's
`decode_state_shardings` (`attention.state`): where the kv heads divide
"model" the softmax KV cache, the moments and the hybrid window hold the
rank's kv heads and the layer attends on them; else q is gathered to
whole heads, the KV cache and the window hold rows of their timeline
(the partials combined over "model"), the moments v's Dv slice, and o is
cut back. Under the training
forward's sequence split (`placed.sequence_split`) x is the rank's slice
of the sequence: `tp_enter` gathers it and `tp_exit` reduce-scatters
back to it, and k and v computed whole take x gathered whole.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import attention as A
from repro_torch.attention import AttnState
from repro_torch.models.param import Builder
from repro_torch.sharding import placed as P

_F32 = torch.float32


def _dense(x, w, n_in: int = 1):
    """Contract x's last `n_in` axes with w's first `n_in` as ONE
    un-batched matmul (aten.mm): the reference's projection einsums are
    dot_generals without batch dims, the outputs that remat="dots" keeps
    (torch.einsum would run them as a bmm)."""
    k = math.prod(w.shape[:n_in])
    y = x.reshape(-1, k) @ w.reshape(k, -1)
    return y.reshape(*x.shape[:x.dim() - n_in], *w.shape[n_in:])

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(b: Builder, name: str, dim: int, norm_type: str = "rmsnorm"):
    sub = b.sub(name)
    sub.add("scale", (dim,), ("embed",), init="ones")
    if norm_type == "layernorm":
        sub.add("bias", (dim,), ("embed",), init="zeros")


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
        sub.add("wi_gate", (d_model, d_ff), ("embed", "ff"))
        sub.add("wi_up", (d_model, d_ff), ("embed", "ff"))
    else:
        sub.add("wi", (d_model, d_ff), ("embed", "ff"))
    sub.add("wo", (d_ff, d_model), ("ff", "embed"))


_ROW_OUT = ("wo", "out_proj", "down_proj")


def tensor_parallel(params) -> bool:
    """Whether a layer's gathered leaves split its compute over "model":
    the column/row-parallel attention, MLP and SSM mixers, whose
    row-parallel output projection (wo; Mamba's out_proj, xLSTM's
    down_proj) keeps its "model" shard (heads or ff)."""
    return any(k in params and P.model_dim(params[k]) == 0
               for k in _ROW_OUT)


def apply_mlp(params, x, *, act: str = "swiglu"):
    """The MLP; column- then row-parallel where its leaves hold their ff
    shards over "model" (the placed step's tensor parallelism)."""
    tp = P.model_dim(params["wo"]) == 0
    if tp:
        x = P.tp_enter(x)
    if act == "swiglu":
        g = _dense(x, params["wi_gate"])
        u = _dense(x, params["wi_up"])
        h = F.silu(g) * u
    else:
        # the reference's jax.nn.gelu defaults to the tanh approximation;
        # this follows it, not OpenAI whisper's exact (erf) GELU
        h = F.gelu(_dense(x, params["wi"]), approximate="tanh")
    y = _dense(h, params["wo"])
    return P.tp_exit(y) if tp else y


# ---------------------------------------------------------------------------
# Attention (GQA, or MLA's projections)
# ---------------------------------------------------------------------------


def init_attention(b: Builder, name: str, cfg) -> None:
    sub = b.sub(name)
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.use_mla:
        rank = cfg.kv_lora_rank
        qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
        sub.add("wq", (d, hq, qk_dim), ("embed", "heads", "head_dim"))
        sub.add("w_dkv", (d, rank + cfg.qk_rope_dim), ("embed", None))
        sub.add("w_uk", (rank, hq, cfg.qk_nope_dim),
                (None, "heads", "head_dim"))
        sub.add("w_uv", (rank, hq, hd), (None, "heads", "head_dim"))
        sub.add("wo", (hq, hd, d), ("heads", "head_dim", "embed"),
                fan_in=hq * hd)
    else:
        sub.add("wq", (d, hq, hd), ("embed", "heads", "head_dim"))
        sub.add("wk", (d, hkv, hd), ("embed", "kv_heads", "head_dim"))
        sub.add("wv", (d, hkv, hd), ("embed", "kv_heads", "head_dim"))
        sub.add("wo", (hq, hd, d), ("heads", "head_dim", "embed"),
                fan_in=hq * hd)
        if cfg.qkv_bias:
            sub.add("bq", (hq, hd), ("heads", "head_dim"), init="zeros")
            sub.add("bk", (hkv, hd), ("kv_heads", "head_dim"), init="zeros")
            sub.add("bv", (hkv, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        _, dq = _kv_dims(cfg)
        sub.add("q_norm_scale", (dq,), (None,), init="ones")
        sub.add("k_norm_scale", (dq,), (None,), init="ones")


def _project_q(params, x, cfg, positions):
    """q [B,Hq,N,D] (D = qk_nope_dim + qk_rope_dim under MLA, RoPE on the
    last qk_rope_dim features only)."""
    q = _dense(x, params["wq"]).transpose(1, 2)
    if cfg.use_mla:
        nope = cfg.qk_nope_dim
        q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], positions,
                                                 cfg.rope_theta)], dim=-1)
    else:
        if cfg.qkv_bias:
            q = q + params["bq"][None, :, None, :]
        if cfg.rope_theta > 0:
            q = apply_rope(q, positions, cfg.rope_theta)
    if cfg.qk_norm:
        q = rms_norm_headwise(q) * params["q_norm_scale"]
    return q


def _project_kv_mla(params, x, cfg, positions):
    """MLA: k [B,Hq,N,D], v [B,Hq,N,Dv], both decompressed per query head
    from the latent c = x w_dkv[:, :rank]; the key's rope part, x
    w_dkv[:, rank:] rotated, is one per token and broadcast to every
    head."""
    rank = cfg.kv_lora_rank
    ckv = _dense(x, params["w_dkv"])
    c, k_rope = ckv[..., :rank], ckv[..., rank:]
    k_nope = _dense(c, params["w_uk"]).transpose(1, 2)
    v = _dense(c, params["w_uv"]).transpose(1, 2)
    k_rope = apply_rope(k_rope[:, None], positions, cfg.rope_theta)
    k = torch.cat([k_nope, k_rope.expand(-1, k_nope.shape[1], -1, -1)],
                  dim=-1)
    return k, v


def _project_kv(params, x, cfg, positions):
    """k [B,Hkv,N,D], v [B,Hkv,N,Dv] (Hkv = Hq under MLA)."""
    if cfg.use_mla:
        k, v = _project_kv_mla(params, x, cfg, positions)
    else:
        k = _dense(x, params["wk"]).transpose(1, 2)
        v = _dense(x, params["wv"]).transpose(1, 2)
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


def _out_proj(o, wo):
    """o [B,Hq,N,Dv] through wo [Hq,Dv,d] -> [B,N,d]."""
    return _dense(o.transpose(1, 2), wo, n_in=2)


def _tp_split(params) -> tuple:
    """(q heads split, kv heads split) over "model" of a layer's placed
    projections; (False, False) outside the placed step's tensor
    parallelism. MLA's k and v are decompressed per query head (w_uk,
    w_uv): they split with q or not at all, and a mismatch raises."""
    split_q = P.model_dim(params["wq"]) == 1
    if "w_uk" in params:
        kv = [P.model_dim(params[n]) == 1 for n in ("w_uk", "w_uv")]
        if kv != [split_q] * 2:
            raise ValueError(
                f"MLA's heads split over 'model' disagree: wq {split_q}, "
                f"w_uk {kv[0]}, w_uv {kv[1]}; k and v are decompressed per "
                f"query head, so all three split or none")
        return split_q, split_q
    if not split_q:
        return False, False
    return True, P.model_dim(params["wk"]) == 1


def _tp_qkv(params, x, cfg, positions, split_kv: bool, kv_x=None):
    """q on the rank's heads; k and v on its kv heads (split_kv) or whole,
    computed from x itself: their grads are then whole on every rank.
    Under the sequence split x is the rank's slice: gathered by
    `tp_enter`, or (k and v whole) once for all three, its grad summed
    over "model" where q takes it. A cross-attention projects k and v
    from `kv_x` (whole on every model rank) at positions arange(M): on
    the rank's kv heads its grad is partial, summed over "model" once a
    layer (`sum_grad`)."""
    if kv_x is not None:
        xt = P.tp_enter(x)
        src = P.sum_grad(kv_x) if split_kv else kv_x
        kv_pos = torch.arange(kv_x.shape[1], dtype=torch.int32,
                              device=x.device)
    elif split_kv:
        xt = src = P.tp_enter(x)
        kv_pos = positions
    else:
        src = P.seq_gather(x)
        xt, kv_pos = P.sum_grad(src), positions
    params = dict(params)
    if cfg.use_mla:
        # the latent and the key's rope part (x w_dkv) feed the rank's
        # heads only: w_dkv's grad is partial (x's is summed by tp_enter)
        params["w_dkv"] = P.sum_grad(params["w_dkv"])
    if cfg.qk_norm:
        # the scales multiply the rank's heads only: their grads partial
        params["q_norm_scale"] = P.sum_grad(params["q_norm_scale"])
        if split_kv:
            params["k_norm_scale"] = P.sum_grad(params["k_norm_scale"])
    q = _project_q(params, xt, cfg, positions)
    k, v = _project_kv(params, src, cfg, kv_pos)
    return q, k, v


def _tp_attend(q, k, v, split_kv: bool, attend):
    """attend(q, k, v) -> o on the placed layout: the rank's heads as they
    are where the kv heads are split, else q gathered to whole heads and
    o cut back to the rank's heads."""
    if split_kv:
        from repro_torch.kernels.sharded import local_heads

        with local_heads():
            return attend(q, k, v)
    return P.slice_model(attend(P.gather_model(q, 1), k, v), 1)


def apply_attention(params, x, cfg, *, causal=True, kv_mask=None,
                    kv_x=None, offset=None):
    """Full-sequence attention. x [B, N, d] at positions offset ..
    offset+N-1 (offset None: 0; a context-parallel rank's token shard
    starts past 0); `kv_x` [B, M, d] makes it cross-attention: q from x,
    k/v from kv_x at positions arange(M). Where the layer's leaves hold
    their heads over "model" it runs on the rank's heads (`_tp_qkv`,
    `_tp_attend`) between `tp_enter` and `tp_exit`."""
    tp, split_kv = _tp_split(params)
    # a tensor-parallel layer under the sequence split takes the rank's
    # slice of the sequence; its q, k and v are whole
    n = P.seq_len(x.shape[1]) if tp else x.shape[1]
    positions = torch.arange(n, dtype=torch.int32, device=x.device)
    if offset is not None:
        positions = positions + offset
    if tp:
        q, k, v = _tp_qkv(params, x, cfg, positions, split_kv, kv_x)
        o = _tp_attend(q, k, v, split_kv, lambda a, b, c: A.attention(
            a, b, c, cfg.attn_spec, causal=causal, kv_mask=kv_mask))
        return P.tp_exit(_out_proj(o.to(x.dtype), params["wo"]))
    if kv_x is None:
        q, k, v = _project_qkv(params, x, cfg, positions)
    else:
        # the reference projects q from kv_x too and drops it
        q = _project_q(params, x, cfg, positions)
        kv_pos = torch.arange(kv_x.shape[1], dtype=torch.int32,
                              device=x.device)
        k, v = _project_kv(params, kv_x, cfg, kv_pos)
    o = A.attention(q, k, v, cfg.attn_spec, causal=causal, kv_mask=kv_mask)
    return _out_proj(o.to(x.dtype), params["wo"])


def _kv_dims(cfg):
    """(n_kv_heads, q_head_dim) as the decode state sees them: MLA
    decompresses k and v per query head, so Hkv = Hq and D = qk_nope_dim +
    qk_rope_dim there (Dv stays head_dim)."""
    hkv = cfg.n_heads if cfg.use_mla else cfg.n_kv_heads
    dq = (cfg.qk_nope_dim + cfg.qk_rope_dim) if cfg.use_mla else cfg.head_dim
    return hkv, dq


def init_attn_state(cfg, batch: int, max_len: int, dtype,
                    device=None) -> AttnState:
    hkv, dq = _kv_dims(cfg)
    return A.init_state(cfg.attn_spec, batch=batch, n_kv_heads=hkv,
                        q_head_dim=dq, v_head_dim=cfg.head_dim,
                        max_len=max_len, dtype=dtype, device=device)


def attention_decode(params, x_t, state: AttnState, cfg, *, position):
    """One-token decode. x_t [B, 1, d]; `position` a scalar or [B],
    best a tensor already on x_t's device: a Python int is copied to the
    card, and that copy waits for the card to finish its queued work.
    Returns (y_t, state) with `state` updated in place."""
    pos = torch.as_tensor(position, device=x_t.device).reshape(-1)[:, None]
    if _tp_split(params)[0]:
        y = _tp_serve(params, x_t, cfg, pos,
                      lambda q, k, v: A.step(state, q, k, v, cfg.attn_spec)[0])
        return y, state
    q, k, v = _project_qkv(params, x_t, cfg, pos)
    o, state = A.step(state, q, k, v, cfg.attn_spec)
    y = _out_proj(o.to(x_t.dtype), params["wo"])
    return y, state


def _tp_serve(params, x, cfg, positions, attend):
    """A prefill or decode step under tensor parallelism: on the rank's
    heads where the kv heads are split (every decode state then holds
    them: the softmax KV cache's heads block, the moments' and the hybrid
    window's), else on whole heads (the cache's or window's rows, the
    moments' Dv slice)."""
    _, split_kv = _tp_split(params)
    q, k, v = _tp_qkv(params, x, cfg, positions, split_kv)
    o = _tp_attend(q, k, v, split_kv, attend)
    return P.tp_exit(_out_proj(o.to(x.dtype), params["wo"]))


def attention_prefill(params, x, state: AttnState, cfg, *, positions=None,
                      kv_mask=None, offset=None):
    """Prefill a prompt; returns (y, state) with the layer's state primed
    in place. With `offset` the tokens sit at [offset, offset + n)."""
    n = x.shape[1]
    if positions is None:
        off = 0 if offset is None else offset
        positions = off + torch.arange(n, dtype=torch.int32, device=x.device)
    if _tp_split(params)[0]:
        y = _tp_serve(params, x, cfg, positions, lambda q, k, v: A.prefill(
            q, k, v, cfg.attn_spec, state=state, kv_mask=kv_mask,
            offset=offset)[0])
        return y, state
    q, k, v = _project_qkv(params, x, cfg, positions)
    o, state = A.prefill(q, k, v, cfg.attn_spec, state=state,
                         kv_mask=kv_mask, offset=offset)
    y = _out_proj(o.to(x.dtype), params["wo"])
    return y, state
