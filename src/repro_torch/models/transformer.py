"""Transformer LM — port of `repro/models/transformer.py`.

One `ModelConfig` expresses every architecture of the reference through a
repeating `pattern` of blocks ("mixer:ffn"): `"attn:mlp"` (qwen3,
qwen2.5, granite, llama3, chameleon, and both towers of whisper),
`"attn:moe"` (deepseek-v2 with MLA projections, kimi-k2), jamba's eight
blocks of Mamba and attention mixers with MLP and MoE ffns, and xlstm's
seven `"mlstm:none"` blocks and one `"slstm:none"` (an ffn of "none": no
second norm, no ffn). Any number of blocks per group, with
`first_k_dense` leading blocks whose ffn is an MLP at `d_ff` (`dense_i`,
unstacked), then `n_groups` groups of the pattern, each entry's
parameters stacked on a leading group axis (`blocks_i`): the reference's
tree, so `from_jax_params` converts a JAX tree as it is. (The
reference's module docstring shows jamba's pattern as attention at index
3; its config, which decides, has it at index 4 and MoE at the odd
indices.) The config, initialization, the training forward and loss (the
MoE blocks' aux added to the loss), prefill and one-token decode are
ported; prefill and decode run the MoE at full capacity. Encoder towers
take embeddings in place of tokens and attend noncausally; decoder
blocks of an encoder-decoder model add a cross-attention to the
encoder's output (`enc_out`), recomputed from it at every call as the
reference does. Layers run as a Python loop (the reference scans the
groups); under `remat="full"` each layer is recomputed in the backward
(`torch.utils.checkpoint`), as the reference checkpoints each scanned
group with `nothing_saveable`; under `remat="dots"` the outputs of the
un-batched matmuls (the projections, the MLP and the experts, `aten.mm`)
are kept and everything else is recomputed, the reference's
`checkpoint_dots_with_no_batch_dims`. The decode state has the same keys:
`dense_i` [B, ...], `blocks_i` stacked [n_groups, B, ...] (an attention
layer's `AttnState`: the softmax KV cache, or the moments and a hybrid
spec's window; a `MambaState`, `MLSTMState` or `SLSTMState`), and each
layer's state is a contiguous view that its prefill and decode steps
update in place.

Under the placed step (`sharding.placed`, an active `Placement`) the
parameters are the rank's shards: each block gathers its leaves around
its use (`_block`, inside the recompute under remat), the embedding, the
final norm and the unembedding around theirs; a stacked leaf's layer is
sliced out of the local shard before its gather. Every mixer keeps the
"model" shards that its placement splits the compute by (attention by
heads, Mamba and xLSTM by their "ff" and "heads" shards: `models.mamba`,
`models.xlstm`), and under an active mesh that splits the SSM mixers
`init_lm_decode_state` makes each rank's slice of their states. Under
tensor parallelism the embedding lookup and the logits are vocab-parallel:
`forward_lm`, `lm_prefill` and `lm_decode_step` then return the rank's
vocab shard of the logits (`placed.gather_vocab` makes them whole).
Under a placement whose "model" axis is larger than 1 and divides N,
`forward_lm` holds the residual stream between blocks as the rank's
1/model slice of the sequence, as the reference's forward constrains it
(`placed.sequence_split`): the embedding produces the slice, each block
is checkpointed on it and runs its norms on it, a tensor-parallel layer
gathers the sequence on entry and reduce-scatters on exit (`tp_enter`,
`tp_exit`; the MoE configs' GQA and MLA, the SSM mixers and whisper's
self- and cross-attention are split so too), a layer computed whole on
every model rank (heads that do not divide "model") is wrapped in a
gather and a slice, the MoE gathers its rows before the router, and the
sequence is gathered before the logits (or the returned hidden states:
an encoder's output, gathered once and fed whole to every
cross-attention of the decoder tower). `lm_prefill` and
`lm_decode_step` stay whole.

Under context parallelism (a placement with "seq" > 1, the training
forward of `launch/train.py --cp`) x is the rank's token shard from the
embedding to the logits. A mixer with a seq plan (`takes_token_shard`:
causal Fastmax on its chunked and kernel backends) runs on the shard at
the shard's offset; every other mixer (softmax, the oracle, rowwise and
both hybrid backends, GQA or MLA; Mamba, mLSTM, sLSTM) takes the
sequence gathered over "seq", runs on the whole of it at positions
0..N-1 and keeps its rows of the output (`_layer`, `placed.cp_enter`,
`cp_exit`), as the reference's GSPMD gathers it; so does the MoE
(`models.moe`). The MLPs and the norms are tokenwise: they run on the
shard.

A `kv_mask` with an SSM mixer (mamba, mlstm, slstm) raises: the SSM
mixers take exact-length chunks (a padded token would enter their
recurrent state). The reference drops the mask there silently; its
engine never pads for SSM models, and the port's engine never pads.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.attention import AttentionSpec
from repro_torch.attention.state import map_state
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as X
from repro_torch.models.param import Builder
from repro_torch.sharding import placed as P

_F32 = torch.float32

__all__ = ["ModelConfig", "init_lm", "forward_lm", "lm_loss",
           "init_lm_decode_state", "lm_prefill", "lm_decode_step",
           "takes_token_shard"]


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
    # MLA (deepseek-v2)
    use_mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    # MLP / MoE
    mlp_act: str = "swiglu"
    n_experts: int = 0
    moe_top_k: int = 2
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # ssm (Mamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
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
    remat: str = "full"             # none | full | dots
    logits_softcap: float = 0.0

    @property
    def attn_spec(self) -> AttentionSpec:
        """The attention spec with the model's chunk_size filled in."""
        if self.attn.chunk_size is not None:
            return self.attn
        return dataclasses.replace(self.attn, chunk_size=self.chunk_size)

    @property
    def n_groups(self) -> int:
        assert self.n_layers_scanned % len(self.pattern) == 0, (
            self.n_layers_scanned, self.pattern)
        return self.n_layers_scanned // len(self.pattern)

    @property
    def n_layers_scanned(self) -> int:
        return self.n_layers - self.first_k_dense

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def adtype(self) -> torch.dtype:
        return getattr(torch, self.activ_dtype)


_SSM = ("mamba", "mlstm", "slstm")


def _check_supported(cfg: ModelConfig) -> None:
    for kind in cfg.pattern:
        mixer, ffn = kind.split(":")
        if mixer not in ("attn",) + _SSM or ffn not in ("mlp", "moe",
                                                        "none"):
            raise NotImplementedError(
                f"{cfg.name}: unknown block {kind!r} in {cfg.pattern}")
        if ffn == "moe" and cfg.n_experts < 1:
            raise ValueError(f"{cfg.name}: {kind!r} needs n_experts >= 1")
    if cfg.norm_type not in ("rmsnorm", "layernorm") \
            or cfg.mlp_act not in ("swiglu", "gelu"):
        raise NotImplementedError(
            f"{cfg.name}: only rmsnorm/layernorm + swiglu/gelu are ported "
            f"(got {cfg.norm_type}, {cfg.mlp_act})")
    if cfg.pos_emb not in ("none", "sinusoidal"):
        raise NotImplementedError(f"{cfg.name}: pos_emb={cfg.pos_emb!r}")
    if cfg.n_layers_scanned < 0 or cfg.n_layers_scanned % len(cfg.pattern):
        raise ValueError(
            f"{cfg.name}: n_layers - first_k_dense = {cfg.n_layers_scanned} "
            f"is not a whole number of {len(cfg.pattern)}-block groups")


def _check_mask(cfg: ModelConfig, kv_mask) -> None:
    """A kv_mask reaches only attention; an SSM mixer would take the
    padded tokens into its recurrent state, so it raises."""
    ssm = sorted({k.split(":")[0] for k in cfg.pattern} & set(_SSM))
    if kv_mask is not None and ssm:
        raise ValueError(
            f"{cfg.name}: kv_mask with SSM mixers {ssm}: they take "
            f"exact-length chunks (a padded token would enter their "
            f"recurrent state); prefill a ragged chunk at its own length")


def _block_keys(cfg: ModelConfig) -> list:
    """(parameter / state key, kind, stacked) of every block entry: the
    `first_k_dense` leading blocks (their ffn forced to an MLP), then one
    stacked entry per pattern position."""
    out = [(f"dense_{i}", cfg.pattern[0], False)
           for i in range(cfg.first_k_dense)]
    return out + [(f"blocks_{i}", kind, True)
                  for i, kind in enumerate(cfg.pattern)]


def _init_block(b: Builder, kind: str, cfg: ModelConfig,
                force_mlp: bool = False) -> None:
    mixer, ffn = kind.split(":")
    L.init_norm(b, "norm1", cfg.d_model, cfg.norm_type)
    if mixer == "attn":
        L.init_attention(b, "mixer", cfg)
        if cfg.cross_attention:
            L.init_norm(b, "norm_x", cfg.d_model, cfg.norm_type)
            L.init_attention(b, "cross", cfg)
    else:
        {"mamba": M.init_mamba, "mlstm": X.init_mlstm,
         "slstm": X.init_slstm}[mixer](b, "mixer", cfg)
    if ffn == "none":
        return
    L.init_norm(b, "norm2", cfg.d_model, cfg.norm_type)
    if ffn == "moe" and not force_mlp:
        MOE.init_moe(b, "ffn", cfg)
    else:
        L.init_mlp(b, "ffn", cfg.d_model, cfg.d_ff, cfg.mlp_act)


def init_lm(cfg: ModelConfig, *, seed: int = 0,
            generator: Optional[torch.Generator] = None, device=None,
            with_axes: bool = False):
    """Random parameters at the config's widths, drawn from `generator` (or
    a fresh one seeded with `seed`) on `device` (default cuda). On the
    `meta` device it only describes the shapes (`param.count_params`).
    With `with_axes`, (params, their logical axes): the reference's
    `init_lm` return, a tuple of axis names per leaf in a parallel tree
    (the draws are the same either way)."""
    _check_supported(cfg)
    dev = device if str(device) == "meta" else resolve_device(device)
    if generator is None:
        generator = torch.Generator(
            device="cpu" if str(dev) == "meta" else dev).manual_seed(seed)
    b = Builder(generator, cfg.dtype(), dev)
    if not cfg.input_embeddings_only:
        b.add("embed", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
              scale=1.0)
    for key, kind, stacked in _block_keys(cfg):
        sub = b.stacked(key, cfg.n_groups) if stacked else b.sub(key)
        _init_block(sub, kind, cfg, force_mlp=not stacked)
    L.init_norm(b, "final_norm", cfg.d_model, cfg.norm_type)
    if not cfg.tie_embeddings and not cfg.input_embeddings_only:
        b.add("unembed", (cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return (b.params, b.axes) if with_axes else b.params


def _sinusoidal_at(pos, d: int, dtype):
    """Sinusoidal embeddings [*pos.shape, d] of float32 positions `pos`:
    sin of pos / 10000^(2i/d) in the first half, cos in the second."""
    dim = torch.arange(0, d, 2, dtype=_F32, device=pos.device)
    ang = pos[..., None] / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _unbind_layers(tree, n: int) -> list:
    """Per-layer views of a stacked parameter tree (a placed leaf's views
    carry its spec without the stacked axis)."""
    if isinstance(tree, dict):
        subs = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in subs.items()} for i in range(n)]
    return P.unbind(tree)


def _layers(params, cfg: ModelConfig) -> list:
    """(key, mixer, group, parameters) of every layer in the order they
    run: the `dense_i` blocks (group None), then each group's pattern
    entries (views into the stacked `blocks_i`; one unbind per stacked
    leaf, whose backward stacks the layers' grads once where per-layer
    indexing would scatter each into a full copy)."""
    out = [(key, kind.split(":")[0], None, params[key])
           for key, kind, stacked in _block_keys(cfg) if not stacked]
    stacked = [(key, kind.split(":")[0],
                _unbind_layers(params[key], cfg.n_groups))
               for key, kind, st in _block_keys(cfg) if st]
    for g in range(cfg.n_groups):
        out += [(key, mixer, g, per[g]) for key, mixer, per in stacked]
    return out


def _layer_state(state: dict, key: str, g):
    """The state of layer (key, group): `state[key]` itself for a dense
    block, else contiguous views of group g of the stacked leaves (any
    state type: `AttnState`, `MambaState`, `MLSTMState`, `SLSTMState`)."""
    st = state[key]
    return st if g is None else map_state(lambda t: t[g], st)


def _init_block_state(kind: str, cfg: ModelConfig, batch: int,
                      max_len: int, device):
    mixer, dtype = kind.split(":")[0], cfg.adtype()
    if mixer == "attn":
        return L.init_attn_state(cfg, batch, max_len, dtype, device=device)
    # a rank's slice under an active mesh that splits the SSM mixers
    m = P.ssm_model_size(cfg)
    if mixer == "mamba":
        return M.init_mamba_state(cfg, batch, dtype, device=device, model=m)
    if mixer == "mlstm":
        return X.init_mlstm_state(cfg, batch, device=device, model=m)
    return X.init_slstm_state(cfg, batch, dtype, device=device, model=m)


def init_lm_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                         device=None) -> dict:
    """Fresh decode state for `batch` sequences of up to `max_len` tokens,
    one per key of the parameter tree: `dense_i` with leaves [B, ...]
    (each cache's length []), `blocks_i` with leaves stacked
    [n_groups, B, ...] (each cache's length [n_groups]). An attention
    layer's is an `AttnState` (the softmax KV cache, or the moments and a
    hybrid spec's window), a Mamba layer's a `MambaState` (conv inputs in
    the activation dtype, h float32), an xLSTM layer's an `MLSTMState` or
    `SLSTMState` (float32 but sLSTM's h). On the `meta` device it only
    describes the shapes (`core.decode_state.decode_state_bytes`). Under
    an active mesh (`rules.use_mesh`) an attention layer's state is the
    rank's block of `decode_state_shardings` (`attention.state`) and an
    SSM layer's the rank's slice of its channels over "model"
    (`placed.ssm_model_size`)."""
    _check_supported(cfg)
    dev = device if str(device) == "meta" else resolve_device(device)

    def stack(t):
        return t.unsqueeze(0).expand((cfg.n_groups,) + tuple(t.shape)) \
            .contiguous()

    state = {}
    for key, kind, stacked in _block_keys(cfg):
        one = _init_block_state(kind, cfg, batch, max_len, dev)
        state[key] = map_state(stack, one) if stacked else one
    return state


def _logits(params, x, cfg: ModelConfig):
    w = P.leaf(params["embed" if cfg.tie_embeddings else "unembed"],
               split=True)
    if P.model_dim(w) is not None:
        # vocab-parallel: the rank's vocab columns of the logits (under
        # the sequence split the sequence is gathered here)
        x = P.tp_enter(x)
    else:
        x = P.seq_gather(x)
    if cfg.tie_embeddings:
        # tied head, scaled by 1/sqrt(d) (embeddings are unit-scale)
        logits = torch.einsum("bnd,vd->bnv", x, w) * (cfg.d_model ** -0.5)
    else:
        logits = torch.einsum("bnd,dv->bnv", x, w)
    if cfg.logits_softcap > 0:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _norm(params, x, cfg: ModelConfig):
    """A norm of the residual (its leaves' grads summed over "model" under
    the sequence split: they see the rank's tokens only)."""
    return L.apply_norm(P.on_slice(params), x, norm_type=cfg.norm_type,
                        eps=cfg.norm_eps)


def takes_token_shard(mixer: str, cfg: ModelConfig, causal=True) -> bool:
    """Whether a training mixer runs on a context-parallel rank's token
    shard: causal attention on a backend with a seq plan
    (`kernels.sharded.SEQ_PLAN_BACKENDS`). Every other takes the sequence
    gathered over "seq" (`_layer`)."""
    from repro_torch.attention.registry import resolve
    from repro_torch.kernels.sharded import SEQ_PLAN_BACKENDS

    return (mixer == "attn" and causal
            and resolve(cfg.attn_spec).name in SEQ_PLAN_BACKENDS)


def _layer(fn, params, h, whole_seq: bool = False):
    """fn(params, h) on the residual's layout: a tensor-parallel layer
    (attention and cross-attention, MLP, Mamba, xLSTM with their "model"
    shards) takes the rank's slice of the sequence as it is (it gathers
    and reduce-scatters itself), any other is computed on the whole
    sequence (nothing split inside) and sliced back. Under context
    parallelism h is the rank's token shard: a mixer without a seq plan
    (`whole_seq`, `takes_token_shard` false) takes the sequence gathered
    over "seq" and keeps its shard's rows of the output; any other layer
    runs on the shard."""
    if whole_seq:
        return P.cp_exit(fn(params, P.cp_enter(h)))
    if L.tensor_parallel(params) or not P.seq_split():
        return fn(params, h)
    h = P.seq_gather(h)
    with P.sequence_split(False):
        y = fn(params, h)
    return P.seq_slice(y)


def _block(params_b, x, cfg: ModelConfig, mixer, enc_out=None, *,
           full_capacity: bool = False, whole_seq: bool = False):
    """One block, its mixer the callable `mixer(params, h)` (`whole_seq`:
    it takes the sequence gathered over "seq", `_layer`); returns (x,
    the MoE's aux or None). A block whose ffn has no router runs the MLP
    (the `dense_i` blocks of an "attn:moe" pattern, as in the reference);
    a block without an ffn ("none") has no second norm. Placed leaves are
    gathered for their use here (an MoE's routed experts one at a time,
    in `moe.apply_moe`; the FFNs and the mixers keep their "model"
    shards where the placement splits them). Under the sequence split x
    is the rank's slice of the sequence (`_layer`)."""
    ffn, mix = params_b.get("ffn"), params_b["mixer"]
    params_b = P.materialize({k: v for k, v in params_b.items()
                              if k not in ("ffn", "mixer")})
    # an attention mixer (GQA or MLA) splits its compute by its heads
    # shards over "model", Mamba and xLSTM by their "ff" and "heads" ones;
    # a cross-attention keeps its heads shards under `tp` (Placement.leaf)
    params_b["mixer"] = P.materialize(mix, split=True)
    if ffn is not None:
        params_b["ffn"] = (MOE.materialize(ffn) if "router" in ffn
                           else P.materialize(ffn, split=True))
    h = _norm(params_b["norm1"], x, cfg)
    x = x + _layer(mixer, params_b["mixer"], h, whole_seq)
    if "cross" in params_b and enc_out is not None:
        h = _norm(params_b["norm_x"], x, cfg)
        x = x + _layer(lambda p, t: L.apply_attention(
            p, t, cfg, causal=False, kv_x=enc_out), params_b["cross"], h)
    if "ffn" not in params_b:
        return x, None
    h = _norm(params_b["norm2"], x, cfg)
    if "router" in params_b["ffn"]:
        y, aux = MOE.apply_moe(params_b["ffn"], h, cfg,
                               full_capacity=full_capacity)
        return x + y, aux
    return x + _layer(lambda p, t: L.apply_mlp(p, t, act=cfg.mlp_act),
                      params_b["ffn"], h), None


def _train_mixer(mixer: str, cfg: ModelConfig, causal, kv_mask,
                 offset=None):
    if mixer == "attn":
        return lambda p, h: L.apply_attention(p, h, cfg, causal=causal,
                                              kv_mask=kv_mask, offset=offset)
    fn = {"mamba": M.apply_mamba, "mlstm": X.apply_mlstm,
          "slstm": X.apply_slstm}[mixer]
    return lambda p, h: fn(p, h, cfg)


def _prefill_mixer(mixer: str, st, cfg: ModelConfig, kv_mask, offset):
    """The mixer of a prefill, priming the layer's state `st` in place.
    The SSM mixers resume from their state whatever the offset."""
    if mixer == "attn":
        return lambda p, h: L.attention_prefill(
            p, h, st, cfg, kv_mask=kv_mask, offset=offset)[0]
    fn = {"mamba": M.mamba_prefill, "mlstm": X.apply_mlstm_stateful,
          "slstm": X.apply_slstm_stateful}[mixer]
    return lambda p, h: fn(p, h, cfg, st)[0]


def _decode_mixer(mixer: str, st, cfg: ModelConfig, position):
    if mixer == "attn":
        return lambda p, h: L.attention_decode(p, h, st, cfg,
                                               position=position)[0]
    fn = {"mamba": M.mamba_decode, "mlstm": X.mlstm_decode,
          "slstm": X.slstm_decode}[mixer]
    return lambda p, h: fn(p, h, st, cfg)[0]


# remat="dots": the un-batched matmuls' outputs are saved, everything else
# (the attention's batched products and the CUDA kernels, which launch
# through ctypes into buffers from torch.empty) is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_SAVE_DOTS = functools.partial(create_selective_checkpoint_contexts,
                               _dots_policy)


def _train_block(params_b, x, cfg: ModelConfig, mixer: str, causal, kv_mask,
                 enc_out, offset=None, split: bool = False):
    # `split` is entered here so that remat's recompute sees it too; under
    # context parallelism a gathered mixer sees positions 0..N-1, one with
    # a seq plan its shard's (`offset`)
    gather = P.cp_size() > 1 and not takes_token_shard(mixer, cfg, causal)
    with P.sequence_split(split):
        return _block(params_b, x, cfg,
                      _train_mixer(mixer, cfg, causal, kv_mask,
                                   None if gather else offset),
                      enc_out=enc_out, whole_seq=gather)


def _lookup(params, tokens, cfg: ModelConfig):
    """The tokens' embeddings in the activation dtype (vocab-parallel
    under tensor parallelism; the rank's slice of the sequence under the
    sequence split)."""
    if P.active() is None:
        return params["embed"][tokens].to(cfg.adtype())
    return P.embed_lookup(P.leaf(params["embed"], split=True), tokens,
                          cfg.vocab_size).to(cfg.adtype())


def _final_norm(params, x, cfg: ModelConfig):
    return _norm(P.materialize(params["final_norm"]), x, cfg)


def _embed(params, tokens, cfg: ModelConfig, embeddings=None, offset=None):
    """Token (or given) embeddings plus, where the config has them, the
    sinusoidal terms of positions offset .. offset+N-1 (offset None: 0);
    under the sequence split the rank's slice of them."""
    if embeddings is not None:
        x = P.seq_slice(embeddings.to(cfg.adtype()))
    else:
        x = _lookup(params, tokens, cfg)
    if cfg.pos_emb == "sinusoidal":
        pos = torch.arange(x.shape[1], device=x.device) + P.seq_start(
            x.shape[1])
        if offset is not None:
            pos = torch.as_tensor(offset, device=x.device) + pos
        x = x + _sinusoidal_at(pos.to(_F32), cfg.d_model, x.dtype)[None]
    return x


def forward_lm(params, tokens, cfg: ModelConfig, *, causal=True,
               kv_mask=None, embeddings=None, enc_out=None,
               return_hidden=False, offset=None):
    """Full-sequence forward. tokens [B, N] int, or `embeddings`
    [B, N, d] (stub frontends, encoder towers); `enc_out` [B, M, d] feeds
    the cross-attention of a decoder tower. `offset` (an int) places the
    tokens at positions offset .. offset+N-1: a context-parallel rank's
    shard of the sequence. Returns (logits [B, N, vocab], aux loss — the
    float32 sum of the MoE blocks' load-balance terms, zero without a
    router), or the final-normed hidden states in place of the logits
    with `return_hidden`. Under a placement whose "model" axis divides N
    the blocks run on the rank's slice of the sequence (module
    docstring); what it returns is whole."""
    _check_supported(cfg)
    _check_mask(cfg, kv_mask)
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    split = P.splits_sequence(
        (tokens if embeddings is None else embeddings).shape[1])
    with P.sequence_split(split):
        x = _embed(params, tokens, cfg, embeddings, offset=offset)
        # recompute only where a backward will run: without grad there is
        # nothing to save
        remat = cfg.remat != "none" and torch.is_grad_enabled()
        kw = {"context_fn": _SAVE_DOTS} if cfg.remat == "dots" else {}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for _, mixer, _, p_i in _layers(params, cfg):
            if remat:
                x, a = checkpoint(_train_block, p_i, x, cfg, mixer, causal,
                                  kv_mask, enc_out, offset, split,
                                  use_reentrant=False, **kw)
            else:
                x, a = _train_block(p_i, x, cfg, mixer, causal, kv_mask,
                                    enc_out, offset, split)
            if a is not None:
                aux = aux + a
        x = _final_norm(params, x, cfg)
        if return_hidden:
            return P.seq_gather(x), aux
        return _logits(params, x, cfg), aux


def token_nll(logits, targets):
    """Each token's next-token cross-entropy [B, N], in float32."""
    logits = logits.to(_F32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return logz - gold


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
    nll = token_nll(logits, targets)
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
    _check_mask(cfg, kv_mask)
    x = _embed(params, tokens, cfg, offset=offset)
    for key, mixer, g, p_i in _layers(params, cfg):
        st_i = _layer_state(state, key, g)
        x, _ = _block(p_i, x, cfg,
                      _prefill_mixer(mixer, st_i, cfg, kv_mask, offset),
                      enc_out=enc_out, full_capacity=True)
    x = _final_norm(params, x, cfg)
    return _logits(params, x, cfg), state


def lm_decode_step(params, state, token_t, cfg: ModelConfig, *, position,
                   enc_out=None):
    """One token for the whole model. token_t [B] int; `position` a
    scalar or [B] (see `layers.attention_decode`; an int is moved to the
    device once here, not once per layer); `enc_out` [B, M, d] feeds the
    cross-attention of an encoder-decoder model. Returns (logits
    [B, vocab], state), the state updated in place."""
    _check_supported(cfg)
    x = _lookup(params, token_t, cfg)[:, None]
    position = torch.as_tensor(position, device=x.device)
    if cfg.pos_emb == "sinusoidal":
        pos = position.reshape(-1).to(_F32)          # [1] or [B]
        x = x + _sinusoidal_at(pos, cfg.d_model, x.dtype)[:, None]
    for key, mixer, g, p_i in _layers(params, cfg):
        st_i = _layer_state(state, key, g)
        x, _ = _block(p_i, x, cfg, _decode_mixer(mixer, st_i, cfg, position),
                      enc_out=enc_out, full_capacity=True)
    x = _final_norm(params, x, cfg)
    return _logits(params, x, cfg)[:, 0], state
