"""qwen2.5-32b [dense]: 64L d=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
GQA + QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]
Port of `repro/configs/qwen2_5_32b.py`; `config()` and
`smoke_config()` are unchanged."""
import dataclasses

from repro_torch.attention import AttentionSpec
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", family="dense",
        vocab_size=152064, d_model=5120, n_layers=64,
        n_heads=40, n_kv_heads=8, head_dim=128, d_ff=27648,
        pattern=("attn:mlp",),
        qkv_bias=True, rope_theta=1e6,
        mlp_act="swiglu", norm_type="rmsnorm",
        attn=AttentionSpec(family="fastmax", p=2), chunk_size=512,
        param_dtype="bfloat16", activ_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        param_dtype="float32", activ_dtype="float32", chunk_size=16)
