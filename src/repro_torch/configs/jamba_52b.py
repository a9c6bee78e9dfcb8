"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2. Mamba + attention 7:1 interleave (attention at
pattern index 4), MoE every other layer (the odd indices).
[arXiv:2403.19887; hf]
Port of `repro/configs/jamba_52b.py`; `config()` and `smoke_config()` are
unchanged."""
import dataclasses

from repro_torch.attention import AttentionSpec
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        vocab_size=65536, d_model=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
        pattern=("mamba:mlp", "mamba:moe", "mamba:mlp", "mamba:moe",
                 "attn:mlp", "mamba:moe", "mamba:mlp", "mamba:moe"),
        n_experts=16, moe_top_k=2, d_ff_expert=14336,
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
        rope_theta=0.0,  # jamba uses no positional encoding
        mlp_act="swiglu", norm_type="rmsnorm",
        attn=AttentionSpec(family="fastmax", p=2), chunk_size=512,
        param_dtype="bfloat16", activ_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), d_model=64, n_layers=8, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        n_experts=4, moe_top_k=2, d_ff_expert=64,
        param_dtype="float32", activ_dtype="float32", chunk_size=16)
