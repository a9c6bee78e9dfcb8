"""Serving step factories — port of the serving half of
`repro/launch/steps.py` (the train step comes with the training slice)."""
from __future__ import annotations

import torch

from repro_torch.models import decode_step
from repro_torch.models.transformer import ModelConfig, lm_prefill

__all__ = ["make_prefill_step", "make_serve_step"]


def make_serve_step(cfg: ModelConfig):
    """step(params, state, token [B], position) -> (next token [B], state)."""

    def serve_step(params, state, token, position):
        logits, state = decode_step(params, state, token, cfg,
                                    position=position)
        return torch.argmax(logits, dim=-1).to(torch.int32), state

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """prefill(params, state, tokens [B, P]) -> (first token [B], state)."""

    def prefill_step(params, state, tokens):
        logits, state = lm_prefill(params, tokens, cfg, state)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), state

    return prefill_step
