"""Step factories — port of `repro/launch/steps.py`.

train_step = forward + loss + backward + global-norm clip + optimizer
update (in place). serve_step / prefill_step = one decode token / a prompt
prefill for the whole model.

Context parallelism (a `mesh` with a "seq" axis, `launch/train.py --cp`):
the reference's GSPMD partitions the step outside the attention; here the
step does it by hand. Every rank takes the same global batch, builds its
targets and loss mask on the whole sequence, and keeps its batch shard
over the DP axes and its token shard over "seq"; its embeddings and RoPE
start at the shard's offset, and its attention runs the seq plan
(`kernels.sharded`) under the active mesh. The loss is the global token
mean: each rank's sum of nll·mask over the global count. The grads are
summed over every rank before the clip, so each rank updates the same
replicated weights. Only mixers whose plan covers a token shard take it
(`check_cp`): Fastmax on its kernel or chunked backend.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models import decode_step, decoder_params, model_loss
from repro_torch.models.transformer import (ModelConfig, forward_lm,
                                            lm_prefill, token_nll)
from repro_torch.optim import clip_by_global_norm, make_optimizer, \
    warmup_cosine
from repro_torch.optim.grad_utils import leaves, tree_map

__all__ = ["make_train_step", "make_grad_fn", "make_serve_step",
           "make_prefill_step", "pick_optimizer", "check_cp"]


def pick_optimizer(cfg: ModelConfig, n_params: int, *, lr=3e-4,
                   total_steps=100_000):
    """Policy: Lion (2B/param state) for >=100B-param configs, AdamW below."""
    del cfg
    name = "lion" if n_params >= 100e9 else "adamw"
    lr_fn = warmup_cosine(lr, min(2000, total_steps // 10), total_steps)
    return name, make_optimizer(name, lr_fn)


def check_cp(cfg: ModelConfig) -> None:
    """Raise unless every layer of `cfg` can train on a token shard: the
    seq plan covers Fastmax attention on its kernel and chunked backends;
    softmax, hybrid, Mamba, xLSTM and MoE layers (whose router statistics
    are per batch) need the whole sequence on one rank."""
    from repro_torch.attention.registry import resolve

    remedy = "train it with --cp 1"
    if cfg.encoder_layers or cfg.cross_attention:
        raise ValueError(f"--cp: {cfg.name} is an encoder-decoder model; "
                         f"{remedy}")
    for kind in cfg.pattern:
        mixer, ffn = kind.split(":")
        if mixer != "attn":
            raise ValueError(f"--cp: {cfg.name}'s {mixer} mixer needs the "
                             f"whole sequence on one rank; {remedy}")
        if ffn == "moe" and cfg.n_layers_scanned:
            raise ValueError(f"--cp: {cfg.name}'s MoE layers route on "
                             f"statistics of the whole batch; {remedy}")
    backend = resolve(cfg.attn_spec).name
    if backend not in ("fastmax-kernel", "fastmax-chunked"):
        raise ValueError(
            f"--cp: the {backend} attention backend needs the whole "
            f"sequence on one rank; use --attn fastmax2-kernel (or "
            f"fastmax2-chunked), or {remedy}")


def _cp_shard(batch: dict, mesh, dev):
    """The rank's (tokens, targets, loss_mask) shard of the global batch
    (batch over the DP axes, tokens over "seq") and its token offset.
    Targets and mask are made on the whole sequence first: only the
    sequence's last token is masked, not each shard's."""
    from repro_torch.sharding.rules import mesh_axes

    tokens = torch.as_tensor(batch["tokens"], device=dev)
    targets = batch.get("targets")
    targets = (F.pad(tokens[:, 1:], (0, 1)) if targets is None
               else torch.as_tensor(targets, device=dev))
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32, device=dev)
        mask[:, -1] = 0.0
    else:
        mask = torch.as_tensor(mask, device=dev, dtype=torch.float32)
    sizes = mesh_axes(mesh)
    at = dict(zip(sizes, mesh.get_coordinate()))
    dp_axes = [a for a in ("pod", "data") if a in sizes]
    dp, row = 1, 0
    for a in dp_axes:
        dp, row = dp * sizes[a], row * sizes[a] + at[a]
    cp, col = sizes.get("seq", 1), at.get("seq", 0)
    b, n = tokens.shape
    if b % dp or n % cp:
        raise ValueError(f"batch {b} x seq {n} does not split over "
                         f"{dp} data-parallel x {cp} context-parallel ranks")
    rows = slice(row * (b // dp), (row + 1) * (b // dp))
    cols = slice(col * (n // cp), (col + 1) * (n // cp))
    return ((tokens[rows, cols], targets[rows, cols], mask[rows, cols]),
            col * (n // cp))


def _all_reduce_tree(tree) -> None:
    """Sum every leaf over all ranks, in place: one flat buffer per
    dtype."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    by_dtype: dict = {}
    for _, x in leaves(tree):
        by_dtype.setdefault(x.dtype, []).append(x)
    for xs in by_dtype.values():
        flat = _flatten_dense_tensors(xs)
        dist.all_reduce(flat)
        for x, y in zip(xs, _unflatten_dense_tensors(flat, xs)):
            x.copy_(y)


def make_grad_fn(cfg: ModelConfig, *, mesh=None):
    """grad_fn(params, batch) -> (loss, metrics, grads), the params'
    grads in a tree like theirs. With a `mesh` (a DeviceMesh with a
    "seq" axis, every rank in it), context-parallel as the module
    docstring says: the loss is the global token mean, the grads summed
    over every rank."""
    if mesh is not None:
        check_cp(cfg)

    def local_loss(params, batch, dev):
        if mesh is None:
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
            return model_loss(params, batch, cfg)
        from repro_torch.sharding.rules import use_mesh

        (tokens, targets, mask), off = _cp_shard(batch, mesh, dev)
        count = mask.sum()
        dist.all_reduce(count)
        with use_mesh(mesh):
            logits, aux = forward_lm(params, tokens, cfg, offset=off)
        nll = (token_nll(logits, targets) * mask).sum() / torch.clamp(
            count, min=1.0)
        return nll + aux, {"nll": nll, "aux": aux}

    def grad_fn(params, batch):
        named = leaves(params)
        dev = named[0][1].device
        for _, x in named:
            x.requires_grad_(True)
        try:
            loss, metrics = local_loss(params, batch, dev)
            if mesh is None:
                loss.backward()
            else:
                from repro_torch.sharding.rules import use_mesh

                with use_mesh(mesh):
                    loss.backward()
        finally:
            for _, x in named:
                x.requires_grad_(False)
        # a leaf the loss does not use (the empty stacked block of a config
        # cut to its first_k_dense layers) gets a zero gradient, as
        # jax.grad gives it in the reference
        grads = tree_map(lambda x: torch.zeros_like(x) if x.grad is None
                         else x.grad, params)
        for _, x in named:
            x.grad = None
        loss = loss.detach().float()
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        if mesh is not None:
            _all_reduce_tree(grads)
            for x in (loss, *metrics.values()):
                dist.all_reduce(x)
        return loss, metrics, grads

    return grad_fn


def make_train_step(cfg: ModelConfig, optimizer, *, clip_norm: float = 1.0,
                    mesh=None):
    """step(params, opt_state, batch) -> (params, opt_state, metrics).

    `batch` holds "tokens" and "targets" [B, N] (numpy or tensors); they
    are moved to the params' device. The params and the optimizer state
    are updated in place. Metrics ("loss", "gnorm", "nll", "aux") are
    float32 tensors on the device: the step never waits on the host.
    `mesh`: context-parallel over its "seq" axis (`make_grad_fn`)."""
    _, opt_update = optimizer
    grad_fn = make_grad_fn(cfg, mesh=mesh)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grad_fn(params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        params, opt_state = opt_update(grads, opt_state, params)
        out = {"loss": loss, "gnorm": gnorm.float(), **metrics}
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
