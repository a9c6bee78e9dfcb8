"""Model substrate of the port: layers, the dense transformer LM and the
encoder-decoder assembly."""
from repro_torch.models.model import (  # noqa: F401
    decode_step,
    decoder_params,
    init_decode_state,
    init_model,
    model_forward,
    model_loss,
)
from repro_torch.models.transformer import ModelConfig  # noqa: F401
