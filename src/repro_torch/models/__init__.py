"""Model substrate of the port: layers (GQA and MLA attention, MLPs), the
MoE FFN, the Mamba and xLSTM mixers, the transformer LM and the
encoder-decoder assembly."""
from repro_torch.models import mamba, moe, xlstm  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    decode_state_specs,
    decode_step,
    decoder_params,
    init_decode_state,
    init_model,
    input_specs,
    model_forward,
    model_loss,
    param_axes,
)
from repro_torch.models.transformer import ModelConfig  # noqa: F401
