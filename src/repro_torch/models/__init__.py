"""Model substrate of the port: layers and the dense decoder LM."""
from repro_torch.models.model import (  # noqa: F401
    decode_step,
    init_decode_state,
    init_model,
    model_loss,
)
from repro_torch.models.transformer import ModelConfig  # noqa: F401
