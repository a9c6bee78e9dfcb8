"""whisper-small [audio]: 12L(enc)+12L(dec) d=768 12H d_ff=3072 vocab=51865.
Encoder-decoder; the conv frontend is a stub (the encoder takes frame
embeddings). Port of `repro/configs/whisper_small.py`; `config()` and
`smoke_config()` are unchanged."""
import dataclasses

from repro_torch.attention import AttentionSpec
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="audio",
        vocab_size=51865, d_model=768, n_layers=12,
        n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072,
        pattern=("attn:mlp",),
        encoder_layers=12, encoder_seq=1500, cross_attention=True,
        rope_theta=0.0, pos_emb="sinusoidal",
        mlp_act="gelu", norm_type="layernorm",
        attn=AttentionSpec(family="fastmax", p=2), chunk_size=512,
        param_dtype="bfloat16", activ_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), d_model=64, n_layers=2, encoder_layers=2, encoder_seq=16,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        param_dtype="float32", activ_dtype="float32", chunk_size=16)
