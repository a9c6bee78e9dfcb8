"""AdamW and Lion with big-model state options — port of
`repro/optim/optimizers.py`.

State layouts, as in the reference:
  adamw:       m fp32, v fp32 (+ master fp32 if any param is not fp32)
  adamw_int8:  m int8 (per-block absmax) {"q", "s"}, v fp32
  lion:        m bf16 — 2 bytes/param
`OptState(step, m, v, master)` holds nested dicts shaped like the params;
`step` is an int32 tensor on the params' device, so the update never waits
on the host.

Unlike the functional reference, `update(grads, state, params)` works IN
PLACE under `torch.no_grad()`: the params' tensors, m, v and master are
overwritten (the caller's references stay valid), and it returns (params,
state) for symmetry with the reference. The bf16-param / f32-master update
and the weight-decay mask (`_wd_mask`, by leaf path) are the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.optim.grad_utils import leaves, tree_map

__all__ = ["OptState", "adamw", "lion", "make_optimizer"]

_QBLOCK = 256
_F32 = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any           # None for lion
    master: Any      # fp32 master params (None if params already fp32)


def _q8(x: torch.Tensor):
    """Per-block absmax int8 quantization of the flattened tensor."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % _QBLOCK))
    blocks = flat.reshape(-1, _QBLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(_F32)


def _dq8(q, scale, shape):
    flat = (q.to(_F32) * scale).reshape(-1)
    return flat[: torch.Size(shape).numel()].reshape(shape)


def _wd_mask(name: str) -> bool:
    """No weight decay on norms/biases/scalars."""
    skip = ("scale", "bias", "bq", "bk", "bv", "bi", "bf", "bz", "bo",
            "dt_bias", "A_log", "D")
    return not any(name.endswith(s) for s in skip)


def _zip(params, *trees, prefix: str = ""):
    """(path, param, the same path's subtree of each of `trees`) for every
    leaf of `params`, in one walk; a tree that is None gives None."""
    if not isinstance(params, dict):
        yield (prefix, params, *trees)
        return
    for k, x in params.items():
        yield from _zip(x, *(None if t is None else t[k] for t in trees),
                        prefix=f"{prefix}/{k}" if prefix else str(k))


def adamw(lr: Callable, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          int8_m: bool = False, master_fp32: bool = True):
    """Returns (init_fn, update_fn). update(grads, state, params)."""

    def init(params):
        def m_like(x):
            zeros = torch.zeros(x.shape, dtype=_F32, device=x.device)
            if int8_m:
                q, s = _q8(zeros)
                return {"q": q, "s": s}
            return zeros

        m = tree_map(m_like, params)
        v = tree_map(lambda x: torch.zeros(x.shape, dtype=_F32,
                                           device=x.device), params)
        master = None
        if master_fp32 and any(x.dtype != _F32
                               for _, x in leaves(params)):
            master = tree_map(lambda x: x.detach().to(_F32,
                                                      copy=True), params)
        dev = leaves(params)[0][1].device
        return OptState(torch.zeros((), dtype=torch.int32, device=dev), m, v,
                        master)

    @torch.no_grad()
    def update(grads, state: OptState, params):
        step = state.step + 1
        lr_t = lr(step)
        stepf = step.to(_F32)
        b1c = 1.0 - torch.pow(torch.tensor(b1, dtype=_F32,
                                           device=stepf.device), stepf)
        b2c = 1.0 - torch.pow(torch.tensor(b2, dtype=_F32,
                                           device=stepf.device), stepf)
        for name, p, g, m, v, master in _zip(params, grads, state.m,
                                             state.v, state.master):
            ref = p if master is None else master
            g = g.to(_F32)
            m_f = _dq8(m["q"], m["s"], g.shape) if int8_m else m
            m_new = b1 * m_f + (1 - b1) * g
            v.mul_(b2).add_((1 - b2) * g.square())
            delta = (m_new / b1c) / (torch.sqrt(v / b2c) + eps)
            if weight_decay > 0 and _wd_mask(name):
                delta = delta + weight_decay * ref.to(_F32)
            p_new = ref.to(_F32) - lr_t * delta
            if int8_m:
                q, s = _q8(m_new)
                m["q"].copy_(q)
                m["s"].copy_(s)
            else:
                m_f.copy_(m_new)
            if master is not None:
                master.copy_(p_new)
            p.copy_(p_new.to(p.dtype))
        return params, OptState(step, state.m, state.v, state.master)

    return init, update


def lion(lr: Callable, *, b1=0.9, b2=0.99, weight_decay=0.1):
    """Lion: sign-momentum, 2-bytes/param state (bf16 momentum)."""

    def init(params):
        m = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.bfloat16,
                                           device=x.device), params)
        dev = leaves(params)[0][1].device
        return OptState(torch.zeros((), dtype=torch.int32, device=dev), m,
                        None, None)

    @torch.no_grad()
    def update(grads, state: OptState, params):
        step = state.step + 1
        lr_t = lr(step)
        for name, p, g, m in _zip(params, grads, state.m):
            g = g.to(_F32)
            m_f = m.to(_F32)
            u = torch.sign(b1 * m_f + (1 - b1) * g)
            if weight_decay > 0 and _wd_mask(name):
                u = u + weight_decay * p.to(_F32)
            p.copy_((p.to(_F32) - lr_t * u).to(p.dtype))
            m.copy_((b2 * m_f + (1 - b2) * g).to(torch.bfloat16))
        return params, OptState(step, state.m, None, None)

    return init, update


def make_optimizer(name: str, lr_fn, **kw):
    if name == "adamw":
        return adamw(lr_fn, **kw)
    if name == "adamw_int8":
        return adamw(lr_fn, int8_m=True, **kw)
    if name == "lion":
        return lion(lr_fn, **kw)
    raise ValueError(name)
