"""Parameter construction — port of `repro/models/param.py`.

Parameters are nested dicts of tensors with the reference's tree layout
(stacked blocks carry a leading layer axis). `Builder` draws them from an
explicit `torch.Generator` with the reference Builder's scales: normal x
1/sqrt(fan_in) (fan_in = the per-layer shape's first dim unless given),
"ones"/"zeros" inits, explicit `scale` where set (embed: 1.0). The numbers
differ from JAX's for the same seed; parity tests instead convert a JAX
params tree with `from_jax_params`.

Beside the values the Builder records the reference's logical axes, one
tuple of names per parameter in a parallel `axes` tree (a stacked block's
prefixed with "layers"), which `repro_torch.sharding` maps to mesh axes:
  "embed"    model width (d_model)        -> the FSDP axis
  "heads"    attention heads              -> tensor parallel
  "kv_heads" kv heads (GQA)               -> tensor parallel iff it divides
  "head_dim" per-head dim                 -> replicated
  "ff"       MLP hidden                   -> tensor parallel
  "vocab"    embedding / logit vocab      -> tensor parallel
  "experts"  MoE experts                  -> expert parallel
  "layers"   the stacked layer axis       -> replicated
  None       replicated
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Builder", "from_jax_params", "count_params"]


class Builder:
    """Fills a nested dict of parameters and the parallel tree of their
    logical axes. `lead` is a shape prefix (the stacked layer axis) added
    to every parameter of this builder, and "layers" to its axes."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device, lead: tuple = ()):
        self.generator = generator
        self.dtype = dtype
        self.device = device
        self.lead = tuple(lead)
        self.params: dict = {}
        self.axes: dict = {}

    def _child(self, name: str, lead: tuple) -> "Builder":
        child = Builder(self.generator, self.dtype, self.device, lead)
        self.params[name] = child.params
        self.axes[name] = child.axes
        return child

    def sub(self, name: str) -> "Builder":
        return self._child(name, self.lead)

    def stacked(self, name: str, n: int) -> "Builder":
        """A sub-builder whose parameters carry a leading axis of n layers."""
        return self._child(name, self.lead + (n,))

    def _record(self, name: str, shape: tuple, axes) -> None:
        axes = tuple(axes)
        if len(axes) != len(shape):
            raise ValueError(f"{name}: axes {axes} for shape {shape}")
        self.axes[name] = ("layers",) * len(self.lead) + axes

    def add(self, name: str, shape: Sequence[int],
            axes: Sequence[Optional[str]], init: str = "normal",
            scale: Optional[float] = None,
            fan_in: Optional[int] = None) -> None:
        self._record(name, tuple(shape), axes)
        full = self.lead + tuple(shape)
        if init == "zeros":
            val = torch.zeros(full, dtype=self.dtype, device=self.device)
        elif init == "ones":
            val = torch.ones(full, dtype=self.dtype, device=self.device)
        elif init == "normal":
            if scale is None:
                fi = fan_in if fan_in is not None else shape[0]
                scale = 1.0 / math.sqrt(max(1, fi))
            val = torch.randn(full, generator=self.generator,
                              dtype=torch.float32, device=self.device)
            val = (val * scale).to(self.dtype)
        else:
            raise ValueError(init)
        self.params[name] = val

    def constant(self, name: str, value: torch.Tensor,
                 axes: Sequence[Optional[str]]) -> None:
        """A fixed parameter (Mamba's S4D `A_log`, mLSTM's forget bias):
        `value` rounded to the param dtype, as the reference stores it,
        and repeated over the builder's leading layer axis."""
        self._record(name, tuple(value.shape), axes)
        val = value.to(device=self.device, dtype=self.dtype)
        self.params[name] = val.expand(self.lead + tuple(val.shape)) \
            .contiguous()


def from_jax_params(tree, cfg, device) -> dict:
    """Convert a JAX `init_model` params tree (an `init_lm` tree, or the
    `{"encoder", "decoder"}` tree of an encoder-decoder model) whose leaves
    were turned into numpy arrays into the port's parameters: same nested
    layout, whatever its keys (the unstacked `dense_i` blocks, each stacked
    `blocks_i` with its leading group axis, MoE and MLA leaves), cast to
    the config's param dtype on `device`."""
    dtype = getattr(torch, cfg.param_dtype)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":  # numpy has no native bf16
            arr = arr.astype(np.float32)
        return torch.from_numpy(arr.copy()).to(device=device, dtype=dtype)

    return conv(tree)


def count_params(tree) -> int:
    """Elements of a parameter tree; a tree built on the `meta` device
    (`init_lm(cfg, device="meta")`) counts a full config without memory."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return tree.numel()
