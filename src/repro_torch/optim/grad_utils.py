"""Global-norm clipping — port of `repro/optim/grad_utils.py` (the
error-feedback gradient compression is not ported yet)."""
from __future__ import annotations

import torch

__all__ = ["global_norm", "clip_by_global_norm", "leaves", "tree_map"]


def leaves(tree, prefix: str = ""):
    """(path, tensor) pairs of a nested dict, paths joined with "/"."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += leaves(v, f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a tensor on
    the leaves' device: no host round trip)."""
    return torch.sqrt(sum(x.float().square().sum() for _, x in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf by min(1, max_norm / (norm + 1e-9)), in float32
    and cast back. Returns (new tree, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm
