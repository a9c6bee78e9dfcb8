"""Encoder-decoder assembly (whisper-small backbone) — port of
`repro/models/encdec.py`.

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings [B, n_frames, d_model]. The backbone is real:
an encoder of noncausal self-attention blocks, and a decoder of causal
self-attention plus cross-attention to the encoder's output. Fastmax runs
at all three attention sites: noncausal in the encoder and the
cross-attention, causal in the decoder's self-attention.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import (ModelConfig, forward_lm, init_lm,
                                            lm_loss)

__all__ = ["encoder_config", "init_encdec", "forward_encdec", "encdec_loss",
           "encode"]


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg,
        n_layers=cfg.encoder_layers,
        first_k_dense=0,
        cross_attention=False,
        input_embeddings_only=True,
        rope_theta=0.0,
        pos_emb="sinusoidal",
    )


def init_encdec(cfg: ModelConfig, *, seed: int = 0,
                generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """{"encoder", "decoder"} parameters, both towers drawn in turn from
    one `generator` (or a fresh one seeded with `seed`) on `device`
    (default cuda)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    enc = init_lm(encoder_config(cfg), generator=generator, device=dev)
    dec = init_lm(cfg, generator=generator, device=dev)
    return {"encoder": enc, "decoder": dec}


def encode(params, frames, cfg: ModelConfig):
    """frames [B, T_enc, d_model] (stub frontend output) -> the encoder's
    final-normed hidden states, same shape."""
    hidden, _ = forward_lm(params["encoder"], None, encoder_config(cfg),
                           causal=False, embeddings=frames,
                           return_hidden=True)
    return hidden


def forward_encdec(params, batch, cfg: ModelConfig):
    enc_out = encode(params, batch["frames"], cfg)
    return forward_lm(params["decoder"], batch["tokens"], cfg,
                      enc_out=enc_out)


def encdec_loss(params, batch, cfg: ModelConfig):
    enc_out = encode(params, batch["frames"], cfg)
    return lm_loss(params["decoder"], {**batch, "enc_out": enc_out}, cfg)
