"""kimi-k2-1t-a32b [moe]: 61L d=7168 64H (GQA kv=8) d_ff(expert)=2048
vocab=163840, MoE 384e top-8 (+1 shared), first layer dense.
Trillion-param MoE (paper-table). [arXiv:2501.kimi2; unverified]
Port of `repro/configs/kimi_k2_1t.py`; `config()` and
`smoke_config()` are unchanged."""
import dataclasses

from repro_torch.attention import AttentionSpec
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        vocab_size=163840, d_model=7168, n_layers=61,
        n_heads=64, n_kv_heads=8, head_dim=128, d_ff=18432,
        pattern=("attn:moe",), first_k_dense=1,
        n_experts=384, moe_top_k=8, n_shared_experts=1, d_ff_expert=2048,
        rope_theta=5e4, mlp_act="swiglu", norm_type="rmsnorm",
        attn=AttentionSpec(family="fastmax", p=2), chunk_size=512,
        param_dtype="bfloat16", activ_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), d_model=64, n_layers=3, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, first_k_dense=1,
        n_experts=8, moe_top_k=2, n_shared_experts=1, d_ff_expert=32,
        param_dtype="float32", activ_dtype="float32", chunk_size=16)
