"""O(N^2) reference oracle for FAST / Fastmax attention (paper Eqs. 5-12).

Port of `repro/core/ref.py`. Materializes the full attention matrix; for
tests at small N only. q, k, v are `[..., N, D]` with matching leading
dims (callers broadcast kv heads for GQA).
"""
from __future__ import annotations

import torch

__all__ = ["normalize_qk", "poly_kernel", "fastmax_attention_ref",
           "fastmax_attention_matrix_ref"]


def normalize_qk(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Paper Eqs. 5-6: per-token statistical normalization over the head
    dim, with eps inside the square root of the variance."""
    xc = x - x.mean(dim=-1, keepdim=True)
    var = xc.square().mean(dim=-1, keepdim=True)
    return xc * torch.reciprocal(torch.sqrt(var + eps))


def poly_kernel(s: torch.Tensor, p: int) -> torch.Tensor:
    """Paper Eq. 8: f(x) = sum_{l=0..p} x^l / l! (truncated Taylor of exp)."""
    if p < 0:
        raise ValueError(f"p must be >= 0, got {p}")
    out = torch.ones_like(s)
    term = torch.ones_like(s)
    for ell in range(1, p + 1):
        term = term * s / float(ell)
        out = out + term
    return out


def fastmax_attention_matrix_ref(q, k, *, p: int = 2, causal: bool = False,
                                 normalize: bool = True,
                                 denom_eps: float = 0.0) -> torch.Tensor:
    """Full attention matrix A (paper Eq. 7/9)."""
    if normalize:
        q, k = normalize_qk(q), normalize_qk(k)
    fs = poly_kernel(torch.einsum("...nd,...md->...nm", q, k), p)
    if causal:
        n, m = fs.shape[-2], fs.shape[-1]
        tri = torch.ones(n, m, dtype=torch.bool, device=fs.device).tril()
        fs = torch.where(tri, fs, torch.zeros_like(fs))
    return fs / (fs.sum(dim=-1, keepdim=True) + denom_eps)


def fastmax_attention_ref(q, k, v, *, p: int = 2, causal: bool = False,
                          normalize: bool = True,
                          denom_eps: float = 0.0) -> torch.Tensor:
    """O = A V with A = Fastmax(Q K^T) (paper Eqs. 11-12)."""
    a = fastmax_attention_matrix_ref(q, k, p=p, causal=causal,
                                     normalize=normalize, denom_eps=denom_eps)
    return torch.einsum("...nm,...mj->...nj", a, v)
