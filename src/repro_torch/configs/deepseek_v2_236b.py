"""deepseek-v2-236b [moe]: 60L d=5120 128H d_ff(expert)=1536 vocab=102400.
MLA kv_lora=512, MoE 2 shared + 160 routed top-6, first layer dense.
[arXiv:2405.04434; hf]
Port of `repro/configs/deepseek_v2_236b.py`; `config()` and
`smoke_config()` are unchanged."""
import dataclasses

from repro_torch.attention import AttentionSpec
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        vocab_size=102400, d_model=5120, n_layers=60,
        n_heads=128, n_kv_heads=128, head_dim=128, d_ff=12288,
        pattern=("attn:moe",), first_k_dense=1,
        use_mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
        n_experts=160, moe_top_k=6, n_shared_experts=2, d_ff_expert=1536,
        rope_theta=1e4, mlp_act="swiglu", norm_type="rmsnorm",
        attn=AttentionSpec(family="fastmax", p=2), chunk_size=512,
        param_dtype="bfloat16", activ_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), d_model=64, n_layers=3, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, first_k_dense=1,
        kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
        n_experts=8, moe_top_k=2, n_shared_experts=1, d_ff_expert=32,
        param_dtype="float32", activ_dtype="float32", chunk_size=16)
