"""Built-in attention backends of this port slice — port of
`repro/attention/backends.py`.

  fastmax-chunked — the plain chunked prefix scan (core.fastmax); exact
                    kv masking; decode through the plain moment step.
  fastmax-kernel  — the hand-written CUDA kernels (prefill + decode) on
                    the native moment carry; CPU tensors take the
                    kernels' plain versions inside the wrappers.

The decode-state protocol (`attention.state`) routes on these
capabilities. softmax, oracle, rowwise and hybrid backends are not ported
yet.
"""
from __future__ import annotations

from repro_torch.attention.registry import Backend, Capabilities, register

__all__ = []

register(Backend(
    name="fastmax-chunked",
    family="fastmax",
    caps=Capabilities(decode=True),
))

register(Backend(
    name="fastmax-kernel",
    family="fastmax",
    caps=Capabilities(decode=True, decode_kernel=True),
))
