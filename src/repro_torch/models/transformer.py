"""Transformer LM — port of `repro/models/transformer.py`.

The dense `"attn:mlp"` pattern (qwen3, llama3, qwen2.5, granite, and both
towers of whisper) is ported: config, initialization, the training forward
and loss, prefill and one-token decode. Encoder towers take embeddings in
place of tokens and attend noncausally; decoder blocks of an
encoder-decoder model add a cross-attention to the encoder's output
(`enc_out`), recomputed from it at every call as the reference does.
Layers run as a Python loop over the stacked `blocks_0` parameters (the
reference scans them); under `remat="full"` each layer is recomputed in
the backward (`torch.utils.checkpoint`), as the reference checkpoints each
scanned group with `nothing_saveable`. The decode state is stacked the same
way, [n_layers, B, ...], and each layer's state is a contiguous view that
the attention step updates in place. Other mixers (MoE, MLA, Mamba, xLSTM)
come in later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.attention import AttentionSpec, AttnState
from repro_torch.core.fastmax import Moments
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.param import Builder

_F32 = torch.float32

__all__ = ["ModelConfig", "init_lm", "forward_lm", "lm_loss",
           "init_lm_decode_state", "lm_prefill", "lm_decode_step"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    d_ff: int = 2048
    pattern: Tuple[str, ...] = ("attn:mlp",)
    first_k_dense: int = 0
    attn: AttentionSpec = AttentionSpec()
    chunk_size: int = 128
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    mlp_act: str = "swiglu"
    norm_type: str = "rmsnorm"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500
    cross_attention: bool = False
    pos_emb: str = "none"           # none | sinusoidal (frontends w/o rope)
    input_embeddings_only: bool = False  # encoder towers (no vocab/unembed)
    param_dtype: str = "float32"
    activ_dtype: str = "float32"
    remat: str = "full"             # none | full ("dots" is not ported)
    logits_softcap: float = 0.0

    @property
    def attn_spec(self) -> AttentionSpec:
        """The attention spec with the model's chunk_size filled in."""
        if self.attn.chunk_size is not None:
            return self.attn
        return dataclasses.replace(self.attn, chunk_size=self.chunk_size)

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def adtype(self) -> torch.dtype:
        return getattr(torch, self.activ_dtype)


def _check_supported(cfg: ModelConfig) -> None:
    if tuple(cfg.pattern) != ("attn:mlp",) or cfg.first_k_dense:
        raise NotImplementedError(
            f"{cfg.name}: only the dense 'attn:mlp' pattern is ported "
            f"(got {cfg.pattern}, first_k_dense={cfg.first_k_dense})")
    if cfg.norm_type not in ("rmsnorm", "layernorm") \
            or cfg.mlp_act not in ("swiglu", "gelu"):
        raise NotImplementedError(
            f"{cfg.name}: only rmsnorm/layernorm + swiglu/gelu are ported "
            f"(got {cfg.norm_type}, {cfg.mlp_act})")
    if cfg.pos_emb not in ("none", "sinusoidal"):
        raise NotImplementedError(f"{cfg.name}: pos_emb={cfg.pos_emb!r}")


def init_lm(cfg: ModelConfig, *, seed: int = 0,
            generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Random parameters at the config's widths, drawn from `generator` (or
    a fresh one seeded with `seed`) on `device` (default cuda)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    b = Builder(generator, cfg.dtype(), dev)
    if not cfg.input_embeddings_only:
        b.add("embed", (cfg.vocab_size, cfg.d_model), scale=1.0)
    blk = b.stacked("blocks_0", cfg.n_layers)
    L.init_norm(blk, "norm1", cfg.d_model, cfg.norm_type)
    L.init_attention(blk, "mixer", cfg)
    if cfg.cross_attention:
        L.init_norm(blk, "norm_x", cfg.d_model, cfg.norm_type)
        L.init_attention(blk, "cross", cfg)
    L.init_norm(blk, "norm2", cfg.d_model, cfg.norm_type)
    L.init_mlp(blk, "ffn", cfg.d_model, cfg.d_ff, cfg.mlp_act)
    L.init_norm(b, "final_norm", cfg.d_model, cfg.norm_type)
    if not cfg.tie_embeddings and not cfg.input_embeddings_only:
        b.add("unembed", (cfg.d_model, cfg.vocab_size))
    return b.params


def _sinusoidal_at(pos, d: int, dtype):
    """Sinusoidal embeddings [*pos.shape, d] of float32 positions `pos`:
    sin of pos / 10000^(2i/d) in the first half, cos in the second."""
    dim = torch.arange(0, d, 2, dtype=_F32, device=pos.device)
    ang = pos[..., None] / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind_layers(tree, n: int) -> list:
    """Per-layer views of a stacked parameter tree."""
    if isinstance(tree, dict):
        subs = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in subs.items()} for i in range(n)]
    return list(tree.unbind(0))


def _layer_state(state: AttnState, i: int) -> AttnState:
    return AttnState(kv=None, moments=Moments(*(t[i] for t in state.moments)))


def init_lm_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                         device=None) -> dict:
    """Zero decode state for `batch` sequences: {"blocks_0": AttnState}
    whose moments are stacked [n_layers, B, Hkv, ...]."""
    _check_supported(cfg)
    dev = resolve_device(device)
    one = L.init_attn_state(cfg, 1, max_len, cfg.adtype(), device="meta")
    moments = Moments(*(
        torch.zeros((cfg.n_layers, batch) + tuple(t.shape[1:]),
                    dtype=t.dtype, device=dev) for t in one.moments))
    return {"blocks_0": AttnState(kv=None, moments=moments)}


def _logits(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        # tied head, scaled by 1/sqrt(d) (embeddings are unit-scale)
        logits = torch.einsum("bnd,vd->bnv", x, params["embed"]) \
            * (cfg.d_model ** -0.5)
    else:
        logits = torch.einsum("bnd,dv->bnv", x, params["unembed"])
    if cfg.logits_softcap > 0:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _block(params_b, x, cfg: ModelConfig, attn, enc_out=None):
    h = L.apply_norm(params_b["norm1"], x, norm_type=cfg.norm_type,
                     eps=cfg.norm_eps)
    x = x + attn(params_b["mixer"], h)
    if cfg.cross_attention and enc_out is not None:
        h = L.apply_norm(params_b["norm_x"], x, norm_type=cfg.norm_type,
                         eps=cfg.norm_eps)
        x = x + L.apply_attention(params_b["cross"], h, cfg, causal=False,
                                  kv_x=enc_out)
    h = L.apply_norm(params_b["norm2"], x, norm_type=cfg.norm_type,
                     eps=cfg.norm_eps)
    return x + L.apply_mlp(params_b["ffn"], h, act=cfg.mlp_act)


def _train_block(params_b, x, cfg: ModelConfig, causal, kv_mask, enc_out):
    return _block(params_b, x, cfg,
                  lambda p, h: L.apply_attention(p, h, cfg, causal=causal,
                                                 kv_mask=kv_mask),
                  enc_out=enc_out)


def _embed(params, tokens, cfg: ModelConfig, embeddings=None, offset=None):
    """Token (or given) embeddings plus, where the config has them, the
    sinusoidal terms of positions offset .. offset+N-1 (offset None: 0)."""
    if embeddings is not None:
        x = embeddings.to(cfg.adtype())
    else:
        x = params["embed"][tokens].to(cfg.adtype())
    if cfg.pos_emb == "sinusoidal":
        pos = torch.arange(x.shape[1], device=x.device)
        if offset is not None:
            pos = torch.as_tensor(offset, device=x.device) + pos
        x = x + _sinusoidal_at(pos.to(_F32), cfg.d_model, x.dtype)[None]
    return x


def forward_lm(params, tokens, cfg: ModelConfig, *, causal=True,
               kv_mask=None, embeddings=None, enc_out=None,
               return_hidden=False):
    """Full-sequence forward. tokens [B, N] int, or `embeddings`
    [B, N, d] (stub frontends, encoder towers); `enc_out` [B, M, d] feeds
    the cross-attention of a decoder tower. Returns (logits [B, N, vocab],
    aux loss — a float32 zero: the dense pattern has no router), or the
    final-normed hidden states in place of the logits with
    `return_hidden`."""
    _check_supported(cfg)
    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported (ROADMAP queue 1 item 1)")
    x = _embed(params, tokens, cfg, embeddings)
    # one unbind per stacked leaf: its backward stacks the 28 layer grads
    # once, where per-layer indexing would scatter each into a full copy
    layers = _unbind_layers(params["blocks_0"], cfg.n_layers)
    # recompute only where a backward will run: without grad there is
    # nothing to save
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for p_i in layers:
        if remat:
            x = checkpoint(_train_block, p_i, x, cfg, causal, kv_mask,
                           enc_out, use_reentrant=False)
        else:
            x = _train_block(p_i, x, cfg, causal, kv_mask, enc_out)
    x = L.apply_norm(params["final_norm"], x, norm_type=cfg.norm_type,
                     eps=cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return _logits(params, x, cfg), aux


def lm_loss(params, batch, cfg: ModelConfig):
    """Next-token cross-entropy. batch: {tokens, targets?, loss_mask?,
    embeddings?, enc_out?} (tensors on the params' device). Returns
    (loss, {"nll", "aux"})."""
    tokens = batch["tokens"]
    targets = batch.get("targets")
    if targets is None:
        targets = F.pad(tokens[:, 1:], (0, 1))
    logits, aux = forward_lm(params, tokens, cfg,
                             embeddings=batch.get("embeddings"),
                             enc_out=batch.get("enc_out"))
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(nll)
        mask[:, -1] = 0.0
    nll = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll + aux, {"nll": nll, "aux": aux}


def lm_prefill(params, tokens, cfg: ModelConfig, state, *, enc_out=None,
               offset=None, kv_mask=None):
    """Prefill a prompt: returns (logits [B, N, vocab], state), the state
    primed in place. `offset` resumes an already-primed state (tokens at
    [offset, offset + n)); `kv_mask` [B, N] masks right-padding; `enc_out`
    [B, M, d] feeds the cross-attention of an encoder-decoder model."""
    _check_supported(cfg)
    x = _embed(params, tokens, cfg, offset=offset)
    st = state["blocks_0"]
    for i in range(cfg.n_layers):
        st_i = _layer_state(st, i)
        x = _block(_layer(params["blocks_0"], i), x, cfg,
                   lambda p, h: L.attention_prefill(
                       p, h, st_i, cfg, kv_mask=kv_mask, offset=offset)[0],
                   enc_out=enc_out)
    x = L.apply_norm(params["final_norm"], x, norm_type=cfg.norm_type,
                     eps=cfg.norm_eps)
    return _logits(params, x, cfg), state


def lm_decode_step(params, state, token_t, cfg: ModelConfig, *, position,
                   enc_out=None):
    """One token for the whole model. token_t [B] int; `position` a
    scalar or [B] (see `layers.attention_decode`; an int is moved to the
    device once here, not once per layer); `enc_out` [B, M, d] feeds the
    cross-attention of an encoder-decoder model. Returns (logits
    [B, vocab], state), the state updated in place."""
    _check_supported(cfg)
    x = params["embed"][token_t][:, None].to(cfg.adtype())
    position = torch.as_tensor(position, device=x.device)
    if cfg.pos_emb == "sinusoidal":
        pos = position.reshape(-1).to(_F32)          # [1] or [B]
        x = x + _sinusoidal_at(pos, cfg.d_model, x.dtype)[:, None]
    st = state["blocks_0"]
    for i in range(cfg.n_layers):
        st_i = _layer_state(st, i)
        x = _block(_layer(params["blocks_0"], i), x, cfg,
                   lambda p, h: L.attention_decode(
                       p, h, st_i, cfg, position=position)[0],
                   enc_out=enc_out)
    x = L.apply_norm(params["final_norm"], x, norm_type=cfg.norm_type,
                     eps=cfg.norm_eps)
    return _logits(params, x, cfg)[:, 0], state
