"""granite-20b [dense]: 52L d=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
llama-arch, code. [arXiv:2405.04324; hf]
Port of `repro/configs/granite_20b.py`; `config()` and
`smoke_config()` are unchanged."""
import dataclasses

from repro_torch.attention import AttentionSpec
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense",
        vocab_size=49152, d_model=6144, n_layers=52,
        n_heads=48, n_kv_heads=1, head_dim=128, d_ff=24576,
        pattern=("attn:mlp",),
        rope_theta=1e4, mlp_act="swiglu", norm_type="rmsnorm",
        attn=AttentionSpec(family="fastmax", p=2), chunk_size=512,
        param_dtype="bfloat16", activ_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), d_model=64, n_layers=2, n_heads=4, n_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=512,
        param_dtype="float32", activ_dtype="float32", chunk_size=16)
