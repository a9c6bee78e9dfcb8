"""`AttentionSpec` — port of `repro/attention/spec.py` (a copy: the port
imports nothing of `repro`). A spec names a family, the polynomial order
`p`, and the impl schedule; `spec.backend_name` keys the registry."""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["AttentionSpec", "FAMILIES", "IMPLS", "HYBRID_IMPLS"]

FAMILIES = ("softmax", "fastmax", "hybrid")
IMPLS = ("oracle", "rowwise", "chunked", "kernel")
HYBRID_IMPLS = ("chunked", "kernel")


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Static, hashable configuration of one attention operator.

    family: "softmax" | "fastmax" | "hybrid"; p: fastmax order (1 or 2);
    impl: schedule within the family ("chunked" plain scan, "kernel" the
    CUDA kernels); chunk_size: scan chunk (None inherits the model's);
    normalize: paper Eqs. 5-6 q/k normalization; denom_eps: denominator
    guard; custom_grad: the paper's §2.5 memory-reduced backward on the
    chunked scan (the kernel backend always pairs its forward with the
    §2.5 backward kernel). The reference's dropout fields and the hybrid
    window join with their slices.
    """

    family: str = "fastmax"
    p: int = 2
    impl: str = "chunked"
    chunk_size: Optional[int] = None
    normalize: bool = True
    denom_eps: float = 1e-6
    custom_grad: bool = True

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown attention family {self.family!r}; "
                             f"expected one of {FAMILIES}")
        if self.family == "fastmax":
            if self.impl not in IMPLS:
                raise ValueError(f"unknown fastmax impl {self.impl!r}; "
                                 f"expected one of {IMPLS}")
            if self.p not in (1, 2):
                raise ValueError(f"fastmax p must be 1 or 2, got {self.p}")
        if self.family == "hybrid":
            if self.impl not in HYBRID_IMPLS:
                raise ValueError(f"unknown hybrid impl {self.impl!r}; "
                                 f"expected one of {HYBRID_IMPLS}")
            if self.p not in (1, 2):
                raise ValueError(f"hybrid p must be 1 or 2, got {self.p}")

    @property
    def backend_name(self) -> str:
        if self.family == "softmax":
            return "softmax"
        return f"{self.family}-{self.impl}"

    def __str__(self) -> str:
        if self.family == "softmax":
            return "softmax"
        if self.family == "hybrid":
            return f"hybrid{self.p}/{self.impl}"
        return f"fastmax{self.p}/{self.impl}"

    @classmethod
    def parse(cls, name: Optional[str], **overrides) -> "AttentionSpec":
        """Parse a CLI-style name: "softmax", "fastmax[1|2][-impl]",
        "hybrid[1|2][-impl]"; None gives the default spec."""
        if name is None:
            return cls(**overrides)
        base, _, impl = name.partition("-")
        kw = dict(overrides)
        if impl:
            kw.setdefault("impl", impl)
        if base == "softmax":
            if impl:
                raise ValueError(
                    f"softmax has no impl variants; got {name!r}")
            return cls(family="softmax", **{k: v for k, v in kw.items()
                                            if k != "impl"})
        if base in ("fastmax", "fastmax1", "fastmax2"):
            if base != "fastmax":
                kw.setdefault("p", int(base[-1]))
            return cls(family="fastmax", **kw)
        if base in ("hybrid", "hybrid1", "hybrid2"):
            if base != "hybrid":
                kw.setdefault("p", int(base[-1]))
            return cls(family="hybrid", **kw)
        raise ValueError(f"cannot parse attention operator name {name!r}")

    def resolved(self, default_chunk_size: int = 128) -> "AttentionSpec":
        """Fill inherited fields (chunk_size) for dispatch."""
        if self.chunk_size is not None:
            return self
        return dataclasses.replace(self, chunk_size=default_chunk_size)
