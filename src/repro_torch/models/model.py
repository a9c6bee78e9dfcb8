"""Model entry points — port of `repro/models/model.py` (decoder-only LMs;
encoder-decoder models are not ported yet)."""
from __future__ import annotations

from repro_torch.models.transformer import (ModelConfig, init_lm,
                                            init_lm_decode_state,
                                            lm_decode_step, lm_loss)

__all__ = ["init_model", "model_loss", "init_decode_state", "decode_step"]


def init_model(cfg: ModelConfig, *, seed: int = 0, generator=None,
               device=None) -> dict:
    return init_lm(cfg, seed=seed, generator=generator, device=device)


def model_loss(params, batch, cfg: ModelConfig):
    return lm_loss(params, batch, cfg)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device=None) -> dict:
    return init_lm_decode_state(cfg, batch, max_len, device=device)


def decode_step(params, state, token, cfg: ModelConfig, *, position):
    return lm_decode_step(params, state, token, cfg, position=position)
