"""Step factories — port of `repro/launch/steps.py`.

train_step = forward + loss + backward + global-norm clip + optimizer
update (in place). serve_step / prefill_step = one decode token / a prompt
prefill for the whole model.
"""
from __future__ import annotations

import torch

from repro_torch.models import decode_step, decoder_params, model_loss
from repro_torch.models.transformer import ModelConfig, lm_prefill
from repro_torch.optim import clip_by_global_norm, make_optimizer, \
    warmup_cosine
from repro_torch.optim.grad_utils import leaves, tree_map

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step",
           "pick_optimizer"]


def pick_optimizer(cfg: ModelConfig, n_params: int, *, lr=3e-4,
                   total_steps=100_000):
    """Policy: Lion (2B/param state) for >=100B-param configs, AdamW below."""
    del cfg
    name = "lion" if n_params >= 100e9 else "adamw"
    lr_fn = warmup_cosine(lr, min(2000, total_steps // 10), total_steps)
    return name, make_optimizer(name, lr_fn)


def make_train_step(cfg: ModelConfig, optimizer, *, clip_norm: float = 1.0):
    """step(params, opt_state, batch) -> (params, opt_state, metrics).

    `batch` holds "tokens" and "targets" [B, N] (numpy or tensors); they
    are moved to the params' device. The params and the optimizer state
    are updated in place. Metrics ("loss", "gnorm", "nll", "aux") are
    float32 tensors on the device: the step never waits on the host."""
    _, opt_update = optimizer

    def train_step(params, opt_state, batch):
        named = leaves(params)
        dev = named[0][1].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        for _, x in named:
            x.requires_grad_(True)
        try:
            loss, metrics = model_loss(params, batch, cfg)
            loss.backward()
        finally:
            for _, x in named:
                x.requires_grad_(False)
        grads = tree_map(lambda x: x.grad, params)
        for _, x in named:
            x.grad = None
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        params, opt_state = opt_update(grads, opt_state, params)
        out = {"loss": loss.detach().float(), "gnorm": gnorm.float(),
               **{k: v.detach().float() for k, v in metrics.items()}}
        return params, opt_state, out

    return train_step


def make_serve_step(cfg: ModelConfig):
    """step(params, state, token [B], position, enc_out=None) -> (next
    token [B], state). An encoder-decoder model decodes with its
    "decoder" parameters against `enc_out`."""

    def serve_step(params, state, token, position, enc_out=None):
        logits, state = decode_step(decoder_params(params, cfg), state,
                                    token, cfg, position=position,
                                    enc_out=enc_out)
        return torch.argmax(logits, dim=-1).to(torch.int32), state

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """prefill(params, state, tokens [B, P], enc_out=None) -> (first token
    [B], state)."""

    def prefill_step(params, state, tokens, enc_out=None):
        logits, state = lm_prefill(decoder_params(params, cfg), tokens, cfg,
                                   state, enc_out=enc_out)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), state

    return prefill_step
