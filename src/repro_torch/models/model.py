"""Model entry points — port of `repro/models/model.py`: decoder-only LMs
and encoder-decoder models (a config with `encoder_layers > 0`)."""
from __future__ import annotations

from repro_torch.models import encdec as ED
from repro_torch.models.transformer import (ModelConfig, forward_lm, init_lm,
                                            init_lm_decode_state,
                                            lm_decode_step, lm_loss)

__all__ = ["init_model", "model_loss", "model_forward", "init_decode_state",
           "decode_step", "decoder_params"]


def _is_encdec(cfg: ModelConfig) -> bool:
    return cfg.encoder_layers > 0


def decoder_params(params, cfg: ModelConfig) -> dict:
    """The tower that prefills and decodes: the "decoder" parameters of an
    encoder-decoder model, else the whole LM."""
    return params["decoder"] if _is_encdec(cfg) else params


def init_model(cfg: ModelConfig, *, seed: int = 0, generator=None,
               device=None) -> dict:
    if _is_encdec(cfg):
        return ED.init_encdec(cfg, seed=seed, generator=generator,
                              device=device)
    return init_lm(cfg, seed=seed, generator=generator, device=device)


def model_loss(params, batch, cfg: ModelConfig):
    if _is_encdec(cfg):
        return ED.encdec_loss(params, batch, cfg)
    return lm_loss(params, batch, cfg)


def model_forward(params, batch, cfg: ModelConfig):
    if _is_encdec(cfg):
        return ED.forward_encdec(params, batch, cfg)
    return forward_lm(params, batch["tokens"], cfg,
                      embeddings=batch.get("embeddings"))


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device=None) -> dict:
    return init_lm_decode_state(cfg, batch, max_len, device=device)


def decode_step(params, state, token, cfg: ModelConfig, *, position,
                enc_out=None):
    """One decode token; `params` are the decoder's for an encoder-decoder
    model (as in the reference)."""
    return lm_decode_step(params, state, token, cfg, position=position,
                          enc_out=enc_out)
