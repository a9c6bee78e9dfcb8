"""llama3-405b [dense]: 126L d=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
GQA, 128k vocab. [arXiv:2407.21783; unverified]
Port of `repro/configs/llama3_405b.py`; `config()` and
`smoke_config()` are unchanged."""
import dataclasses

from repro_torch.attention import AttentionSpec
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family="dense",
        vocab_size=128256, d_model=16384, n_layers=126,
        n_heads=128, n_kv_heads=8, head_dim=128, d_ff=53248,
        pattern=("attn:mlp",),
        rope_theta=5e5, mlp_act="swiglu", norm_type="rmsnorm",
        attn=AttentionSpec(family="fastmax", p=2), chunk_size=512,
        param_dtype="bfloat16", activ_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), d_model=64, n_layers=2, n_heads=8, n_kv_heads=2,
        head_dim=16, d_ff=160, vocab_size=512,
        param_dtype="float32", activ_dtype="float32", chunk_size=16)
