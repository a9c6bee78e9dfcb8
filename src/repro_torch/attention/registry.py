"""Backend registry — port of `repro/attention/registry.py`.

Each backend declares the `Capabilities` the decode-state protocol
(`attention.state`) routes on, and `resolve` finds a spec's backend by
name. The reference's capability-driven fallback chain and platform
reroute are not ported: the kernel wrappers take CPU tensors to the plain
versions and CUDA tensors to the kernels (or raise), so no call is ever
rerouted to another backend.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from repro_torch.attention.spec import AttentionSpec

__all__ = ["Capabilities", "Backend", "register", "get_backend",
           "list_backends", "resolve"]


@dataclasses.dataclass(frozen=True)
class Capabilities:
    decode: bool = False          # has a streaming decode path
    decode_kernel: bool = False   # the decode step runs the CUDA decode
    #                               kernel on the native moment carry
    prefill_kernel: bool = False  # prefill runs a CUDA kernel (all but a
    #                               hybrid's resumed, offset, prefill)
    dropout: bool = False         # the paper's Fig. 2 factorized dropout


@dataclasses.dataclass(frozen=True)
class Backend:
    """A registered attention implementation. `fn(q, k, v, spec, *,
    causal, kv_mask, rng)` computes full-sequence attention (the
    `attention()` dispatcher's call)."""

    name: str
    family: str
    caps: Capabilities
    fn: Callable


_REGISTRY: Dict[str, Backend] = {}


def register(backend: Backend) -> Backend:
    if backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def _ensure_builtins() -> None:
    from repro_torch.attention import backends  # noqa: F401


def get_backend(name: str) -> Backend:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no attention backend {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def list_backends() -> List[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)


def resolve(spec: AttentionSpec) -> Backend:
    """The backend that runs this spec."""
    return get_backend(spec.backend_name)
