"""Parameter construction — port of `repro/models/param.py`.

Parameters are nested dicts of tensors with the reference's tree layout
(stacked blocks carry a leading layer axis). `Builder` draws them from an
explicit `torch.Generator` with the reference Builder's scales: normal x
1/sqrt(fan_in) (fan_in = the per-layer shape's first dim unless given),
"ones"/"zeros" inits, explicit `scale` where set (embed: 1.0). The numbers
differ from JAX's for the same seed; parity tests instead convert a JAX
params tree with `from_jax_params`.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Builder", "from_jax_params", "count_params"]


class Builder:
    """Fills a nested dict of parameters. `lead` is a shape prefix (the
    stacked layer axis) added to every parameter of this builder."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device, lead: tuple = ()):
        self.generator = generator
        self.dtype = dtype
        self.device = device
        self.lead = tuple(lead)
        self.params: dict = {}

    def sub(self, name: str) -> "Builder":
        child = Builder(self.generator, self.dtype, self.device, self.lead)
        self.params[name] = child.params
        return child

    def stacked(self, name: str, n: int) -> "Builder":
        """A sub-builder whose parameters carry a leading axis of n layers."""
        child = Builder(self.generator, self.dtype, self.device,
                        self.lead + (n,))
        self.params[name] = child.params
        return child

    def add(self, name: str, shape: Sequence[int], init: str = "normal",
            scale: Optional[float] = None,
            fan_in: Optional[int] = None) -> None:
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


def from_jax_params(tree, cfg, device) -> dict:
    """Convert a JAX `init_model` params tree (an `init_lm` tree, or the
    `{"encoder", "decoder"}` tree of an encoder-decoder model) whose leaves
    were turned into numpy arrays into the port's parameters: same nested
    layout (the stacked `blocks_0` keeps its leading layer axis), cast to
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
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return tree.numel()
