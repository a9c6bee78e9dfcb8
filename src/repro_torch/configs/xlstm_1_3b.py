"""xlstm-1.3b [ssm]: 48L d=2048 4H d_ff=0 vocab=50304. sLSTM + mLSTM
blocks (xLSTM[7:1] interleave), no ffn. Attention-free: FAST does not
apply (the attention spec is unused). [arXiv:2405.04517]
Port of `repro/configs/xlstm_1_3b.py`; `config()` and `smoke_config()`
are unchanged."""
import dataclasses

from repro_torch.attention import AttentionSpec
from repro_torch.models.transformer import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        vocab_size=50304, d_model=2048, n_layers=48,
        n_heads=4, n_kv_heads=4, head_dim=512, d_ff=0,
        pattern=("mlstm:none",) * 7 + ("slstm:none",),
        rope_theta=0.0, norm_type="rmsnorm", tie_embeddings=True,
        attn=AttentionSpec(family="fastmax", p=2),  # no attention blocks
        param_dtype="bfloat16", activ_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), d_model=32, n_layers=8, n_heads=2, n_kv_heads=2,
        head_dim=16, vocab_size=512,
        param_dtype="float32", activ_dtype="float32", chunk_size=16)
