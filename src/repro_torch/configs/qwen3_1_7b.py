"""qwen3-1.7b [dense]: 28L d=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
qk_norm + GQA, tied embeddings. Port of `repro/configs/qwen3_1_7b.py`;
`config()` and `smoke_config()` are unchanged."""
import dataclasses

from repro_torch.attention import AttentionSpec
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b", family="dense",
        vocab_size=151936, d_model=2048, n_layers=28,
        n_heads=16, n_kv_heads=8, head_dim=128, d_ff=6144,
        pattern=("attn:mlp",),
        qk_norm=True, rope_theta=1e6, tie_embeddings=True,
        mlp_act="swiglu", norm_type="rmsnorm",
        attn=AttentionSpec(family="fastmax", p=2), chunk_size=512,
        param_dtype="bfloat16", activ_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        param_dtype="float32", activ_dtype="float32", chunk_size=16)
