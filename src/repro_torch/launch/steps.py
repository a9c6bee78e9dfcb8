"""Step factories — port of `repro/launch/steps.py`.

train_step = forward + loss + backward + global-norm clip + optimizer
update (in place). serve_step / prefill_step = one decode token / a prompt
prefill for the whole model.

With a `mesh` (a DeviceMesh whose axes are the reference's: ("data",
"model") or ("pod", "data", "model"), and ("data", "seq") or ("pod",
"data", "seq") for context parallelism) the steps are the placed step,
the port's counterpart of the reference's partitioned step
(`sharding.placed`): the parameters and the optimizer state are the
rank's shards by the reference's specs (`Placement.place`,
`Placement.init_opt_state`), each layer gathers its leaves around its
use, the dense decoders split their compute over "model", and the grads
come out in the placement (reduce-scattered over the data axes, summed
over the batch axes a leaf is not split on). A train step takes the
rank's rows of the global batch (`placed.shard_batch`: dim 0 over "pod"
and "data"); under "seq" each rank keeps its token shard of them and
builds its targets and loss mask on the whole rows first. A mixer with
a seq plan (causal Fastmax on its kernel and chunked backends,
`kernels.sharded`) runs on the shard, its RoPE at the shard's offset;
every other mixer and the MoE take the sequence gathered over "seq" and
keep their rows of the output (`models.transformer`,
`placed.cp_enter`). The loss is the global token mean: each rank's sum
of nll·mask over the count all-reduced over the batch axes; an MoE
layer's router statistics and capacity are the whole batch's
(`models.moe`), its aux the rank's share, summed with the loss. Refused
with the reason: AdamW's int8 m, a mesh axis the rules do not know, and
under "seq" an encoder-decoder model (`check_cp`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import decode_step, decoder_params, model_loss
from repro_torch.models.transformer import ModelConfig, forward_lm, lm_prefill
from repro_torch.optim import clip_by_global_norm, make_optimizer, \
    warmup_cosine
from repro_torch.optim.grad_utils import leaves, tree_map

_F32 = torch.float32   # the metrics' dtype

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
    """Raise if `cfg` cannot train under context parallelism: an
    encoder-decoder model (the reference's CLI feeds it no encoder input
    either). Every decoder mixer trains: one with a seq plan on the
    rank's token shard, every other, and the MoE, on the sequence
    gathered over "seq" (module docstring)."""
    if cfg.encoder_layers or cfg.cross_attention:
        raise ValueError(f"--cp: {cfg.name} is an encoder-decoder model; "
                         f"train it with --cp 1")


def _local_rows(batch: dict, placement, dev):
    """(tokens, targets, loss_mask, extra inputs) of the rank's rows and,
    under "seq", its token shard and offset. Targets and mask are made
    on the whole rows first: only a row's last token is masked."""
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
    extra = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
             if k in ("frames", "embeddings")}
    cp = placement.sizes.get("seq", 1)
    if cp == 1:
        return tokens, targets, mask, extra, None
    n = tokens.shape[1]
    if n % cp:
        raise ValueError(f"seq {n} does not split over {cp} "
                         f"context-parallel ranks")
    col = placement.mesh.get_local_rank("seq")
    cols = slice(col * (n // cp), (col + 1) * (n // cp))
    return (tokens[:, cols], targets[:, cols], mask[:, cols], extra,
            col * (n // cp))


def make_grad_fn(cfg: ModelConfig, *, mesh=None, global_batch=None):
    """grad_fn(params, batch) -> (loss, metrics, grads), the params'
    grads in a tree like theirs. With a `mesh`, the placed step (module
    docstring): `params` the rank's shards, `batch` its rows (of a global
    batch of `global_batch` rows, split as `batch_spec` splits it; None:
    over every data axis), the grads its shards, the loss the global
    token mean. Under "seq" > 1 an encoder-decoder model raises
    (`check_cp`) before anything is placed."""
    if mesh is None:
        def local_loss(params, batch, dev):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
            return model_loss(params, batch, cfg)
        return _grad_fn(local_loss, None)

    from repro_torch.models.encdec import encode
    from repro_torch.sharding import placed as P
    from repro_torch.sharding.rules import mesh_axes, use_mesh

    if mesh_axes(mesh).get("seq", 1) > 1:
        check_cp(cfg)
    placement = P.Placement(cfg, mesh, global_batch=global_batch)

    def local_loss(params, batch, dev):
        tokens, targets, mask, extra, off = _local_rows(batch, placement,
                                                        dev)
        count = placement.sum_over_batch(mask.sum())
        with use_mesh(mesh), placement.active():
            lm = params
            enc_out = None
            if cfg.encoder_layers:
                enc_out = encode(params, extra["frames"], cfg)
                lm = params["decoder"]
            logits, aux = forward_lm(lm, tokens, cfg, offset=off,
                                     embeddings=extra.get("embeddings"),
                                     enc_out=enc_out)
            nll = (P.token_nll(logits, targets, cfg.vocab_size)
                   * mask).sum() / torch.clamp(count, min=1.0)
        return nll + aux, {"nll": nll, "aux": aux}

    def backward(loss):
        with use_mesh(mesh), placement.active():
            loss.backward()

    return _grad_fn(local_loss, placement, backward)


def _grad_fn(local_loss, placement, backward=None):
    def grad_fn(params, batch):
        named = leaves(params)
        dev = named[0][1].device
        for _, x in named:
            x.requires_grad_(True)
        try:
            loss, metrics = local_loss(params, batch, dev)
            if backward is None:
                loss.backward()
            else:
                backward(loss)
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
        loss = loss.detach().to(_F32)
        metrics = {k: v.detach().to(_F32) for k, v in metrics.items()}
        if placement is not None:
            from repro_torch.sharding import placed as P

            for (_, g), (_, x) in zip(leaves(grads), named):
                P.tag(g, P.spec_of(x))
            placement.reduce_grads(grads)
            loss = placement.sum_over_batch(loss)
            metrics = {k: placement.sum_over_batch(v)
                       for k, v in metrics.items()}
        return loss, metrics, grads

    return grad_fn


def make_train_step(cfg: ModelConfig, optimizer, *, clip_norm: float = 1.0,
                    mesh=None, global_batch=None):
    """step(params, opt_state, batch) -> (params, opt_state, metrics).

    `batch` holds "tokens" and "targets" [B, N] (numpy or tensors); they
    are moved to the params' device. The params and the optimizer state
    are updated in place. Metrics ("loss", "gnorm", "nll", "aux") are
    float32 tensors on the device: the step never waits on the host.
    `mesh`: the placed step (module docstring) on the rank's shards and
    rows (`global_batch` as in `make_grad_fn`); its gnorm sums each
    leaf's squares over the axes it is split on."""
    _, opt_update = optimizer
    grad_fn = make_grad_fn(cfg, mesh=mesh, global_batch=global_batch)

    def train_step(params, opt_state, batch):
        if mesh is not None:
            from repro_torch.sharding.placed import refuse_int8

            refuse_int8(params, opt_state)
        loss, metrics, grads = grad_fn(params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm, mesh=mesh)
        params, opt_state = opt_update(grads, opt_state, params)
        out = {"loss": loss, "gnorm": gnorm.to(_F32), **metrics}
        return params, opt_state, out

    return train_step


def _placed_scope(cfg: ModelConfig, mesh):
    """(a context manager running the model placed on `mesh`, a function
    making a vocab shard of logits whole); a no-op pair without a mesh."""
    import contextlib

    if mesh is None:
        return contextlib.nullcontext, lambda logits: logits
    from repro_torch.sharding import placed as P
    from repro_torch.sharding.rules import use_mesh

    placement = P.Placement(cfg, mesh)

    @contextlib.contextmanager
    def scope():
        with use_mesh(mesh), placement.active():
            yield

    def whole(logits):
        with placement.active():
            return P.gather_vocab(logits, cfg.vocab_size)

    return scope, whole


def make_serve_step(cfg: ModelConfig, *, mesh=None):
    """step(params, state, token [B], position, enc_out=None) -> (next
    token [B], state). An encoder-decoder model decodes with its
    "decoder" parameters against `enc_out`. With a `mesh`, on the rank's
    placed parameters, rows and decode state (made under `use_mesh`)."""
    scope, whole = _placed_scope(cfg, mesh)

    def serve_step(params, state, token, position, enc_out=None):
        with scope():
            logits, state = decode_step(decoder_params(params, cfg), state,
                                        token, cfg, position=position,
                                        enc_out=enc_out)
        return torch.argmax(whole(logits), dim=-1).to(torch.int32), state

    return serve_step


def make_prefill_step(cfg: ModelConfig, *, mesh=None):
    """prefill(params, state, tokens [B, P], enc_out=None) -> (first token
    [B], state). With a `mesh`, as `make_serve_step`."""
    scope, whole = _placed_scope(cfg, mesh)

    def prefill_step(params, state, tokens, enc_out=None):
        with scope():
            logits, state = lm_prefill(decoder_params(params, cfg), tokens,
                                       cfg, state, enc_out=enc_out)
        return (torch.argmax(whole(logits[:, -1]), dim=-1).to(torch.int32),
                state)

    return prefill_step
