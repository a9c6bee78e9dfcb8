"""Model entry points — port of `repro/models/model.py`: decoder-only LMs
and encoder-decoder models (a config with `encoder_layers > 0`).

`param_axes`, `input_specs` and `decode_state_specs` describe a model
without allocating it (`meta` tensors, the reference's ShapeDtypeStructs):
the placement layer (`repro_torch.sharding`) maps them to a mesh."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import encdec as ED
from repro_torch.models.transformer import (ModelConfig, forward_lm, init_lm,
                                            init_lm_decode_state,
                                            lm_decode_step, lm_loss)

__all__ = ["init_model", "model_loss", "model_forward", "init_decode_state",
           "decode_step", "decoder_params", "param_axes", "input_specs",
           "decode_state_specs"]


def _is_encdec(cfg: ModelConfig) -> bool:
    return cfg.encoder_layers > 0


def decoder_params(params, cfg: ModelConfig) -> dict:
    """The tower that prefills and decodes: the "decoder" parameters of an
    encoder-decoder model, else the whole LM."""
    return params["decoder"] if _is_encdec(cfg) else params


def init_model(cfg: ModelConfig, *, seed: int = 0, generator=None,
               device=None, with_axes: bool = False):
    """The model's parameters; with `with_axes`, (params, logical axes)."""
    if _is_encdec(cfg):
        return ED.init_encdec(cfg, seed=seed, generator=generator,
                              device=device, with_axes=with_axes)
    return init_lm(cfg, seed=seed, generator=generator, device=device,
                   with_axes=with_axes)


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every parameter (a tuple of names per leaf, the
    tree of `init_model`), built on the `meta` device."""
    return init_model(cfg, device="meta", with_axes=True)[1]


def input_specs(cfg: ModelConfig, *, global_batch: int, seq_len: int,
                kind: str = "train") -> Dict[str, Any]:
    """`meta` tensors of the inputs of a train step (kind "train": tokens
    and targets, an encoder-decoder model's frames) or of a decode step's
    per-step inputs (kind "decode": one token per sequence, the encoder
    output), with the reference's shapes and dtypes."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    enc = (global_batch, cfg.encoder_seq, cfg.d_model)
    if kind == "train":
        tok = (global_batch, seq_len)
        specs = {"tokens": meta(tok, torch.int32),
                 "targets": meta(tok, torch.int32)}
        if _is_encdec(cfg):
            specs["frames"] = meta(enc, cfg.adtype())
        return specs
    if kind == "decode":
        specs = {"token": meta((global_batch,), torch.int32)}
        if _is_encdec(cfg):
            specs["enc_out"] = meta(enc, cfg.adtype())
        return specs
    raise ValueError(kind)


def decode_state_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The decode state's tree with `meta` leaves: its shapes and dtypes
    without allocating it."""
    return init_lm_decode_state(cfg, batch, max_len, device="meta")


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
