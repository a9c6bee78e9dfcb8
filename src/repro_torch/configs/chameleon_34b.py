"""chameleon-34b [vlm]: 48L d=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
Early fusion: VQ image tokens are ordinary vocab ids (frontend stubbed);
qk_norm per the Chameleon stability fix. [arXiv:2405.09818; unverified]
Port of `repro/configs/chameleon_34b.py`; `config()` and
`smoke_config()` are unchanged."""
import dataclasses

from repro_torch.attention import AttentionSpec
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm",
        vocab_size=65536, d_model=8192, n_layers=48,
        n_heads=64, n_kv_heads=8, head_dim=128, d_ff=22016,
        pattern=("attn:mlp",),
        qk_norm=True, rope_theta=1e4,
        mlp_act="swiglu", norm_type="rmsnorm",
        attn=AttentionSpec(family="fastmax", p=2), chunk_size=512,
        param_dtype="bfloat16", activ_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        param_dtype="float32", activ_dtype="float32", chunk_size=16)
