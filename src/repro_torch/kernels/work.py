"""The kernels' work and the card's constants.

One function per kernel gives the (operations, bytes) of one launch at its
shapes: the operations the function needs (not what a kernel's schedule
happens to do) and the bytes it must move, each input read once and each
output written once. `bound_ms` turns them into the least time the card
could take. `chip_smoke.py` prints these bounds beside each kernel's time,
the kernel wrappers record them for every launch inside the dry run's
counting context (`launch/op_analysis.py`), and the dry run's roofline
(`launch/dryrun.py`) divides by the same constants.

The constants are an NVIDIA H100 80GB HBM3 (SXM) at 700 W, from its data
sheet: dense tensor-core and CUDA-core peaks, HBM3 rate and size, and one
direction of NVLink 4.
"""
from __future__ import annotations

__all__ = ["CARD", "H100_BYTES_PER_S", "H100_BF16_FLOPS", "H100_F32_FLOPS",
           "H100_TF32_FLOPS", "HBM_BYTES", "NVLINK_BYTES_PER_S",
           "BOUND_CHUNK", "feature_rows", "prefill_ops", "bwd_ops",
           "decode_ops", "band_pairs", "hybrid_ops", "noncausal_moment_ops",
           "noncausal_combine_ops", "state_elems", "prefill_work",
           "hybrid_work", "bwd_work", "decode_work", "noncausal_moments_work",
           "noncausal_combine_work", "bound_ms"]

CARD = "NVIDIA H100 80GB HBM3, 700 W, data sheet"
H100_BYTES_PER_S = 3.35e12   # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12     # dense tensor-core peak
H100_F32_FLOPS = 67e12       # CUDA-core float32 peak
H100_TF32_FLOPS = 495e12     # dense tensor-core TF32 peak
HBM_BYTES = 80e9             # device memory
NVLINK_BYTES_PER_S = 450e9   # NVLink 4, one direction
# the causal prefill's bound counts its exact in-chunk pairs at chunks of
# this many tokens, a fixed count (the function needs none of them: the
# feature-row combine covers every key), so no kernel's chunk moves it
BOUND_CHUNK = 64


def feature_rows(d: int, p: int) -> int:
    """Rows of the feature table: the constant, D linear, and at p=2 the
    D(D+1)/2 pairs a <= b."""
    return 1 + d + (d * (d + 1) // 2 if p >= 2 else 0)


def _causal_pairs(n: int) -> int:
    c = BOUND_CHUNK
    return (n // c) * c * (c + 1) // 2 + (n % c) * (n % c + 1) // 2


def prefill_ops(bh: int, g: int, n: int, d: int, dv: int, p: int = 2) -> int:
    """Operations the causal prefill needs over `bh` (b, kv-head) pairs of
    `g` query heads each: m2 and g2 are symmetric in (a, b), as is
    q_a q_b, so the degree-2 fold and combine need D(D+1)/2 rows, not D^2;
    plus the degree-0/1 terms and the causal intra-chunk block, counted at
    chunks of BOUND_CHUNK whatever chunk a kernel takes."""
    deg2 = (g + 1) * n * d * (d + 1) * (dv + 1) if p >= 2 else 0
    return bh * (deg2                                       # m2, g2
                 + 2 * (g + 1) * n * (d + 1) * (dv + 1)     # m1 g1 m0 g0
                 + g * _causal_pairs(n) * 2 * (d + dv))     # intra-chunk


def bwd_ops(bh: int, g: int, n: int, d: int, dv: int, p: int = 2) -> int:
    """Operations of the §2.5 backward over `bh` (b, kv-head) pairs of `g`
    query heads each: the six degree-2 passes on the symmetric half (g2
    and its cotangent ride along as one more column, as in the forward's
    count), the degree-0/1 terms of the same six passes, and six products
    per causal pair inside chunks of BOUND_CHUNK (scores, F.v, u.v, ds.k,
    ds^T.q, F^T.u)."""
    deg2 = (3 * g + 3) * n * d * (d + 1) * (dv + 1) if p >= 2 else 0
    return bh * (deg2
                 + 2 * (3 * g + 3) * n * (d + 1) * (dv + 1)
                 + g * _causal_pairs(n) * 2 * (3 * d + 3 * dv))


def decode_ops(bh: int, g: int, d: int, dv: int, p: int = 2) -> int:
    """Operations of one decode step: the token folded into the moments
    and `g` queries contracted with them, per (b, kv-head)."""
    deg2 = d * (d + 1) * (dv + 1) if p >= 2 else 0
    return bh * (g + 1) * (deg2 + 2 * (d + 1) * (dv + 1))


def band_pairs(n: int, w: int) -> int:
    """Pairs (i, j) with 0 <= i - j < w among n consecutive tokens."""
    m = min(n, w)
    return m * n - m * (m - 1) // 2


def hybrid_ops(bh: int, g: int, n: int, d: int, dv: int, w_eff: int,
               p: int = 2) -> int:
    """The prefill's operations (its in-chunk pairs at BOUND_CHUNK), plus
    2(D + Dv) per query head for each band pair before its query's chunk
    of BOUND_CHUNK (its score and its product with v; a band pair inside
    that chunk is one of the causal pairs already, weighed exp instead of
    f)."""
    c = BOUND_CHUNK
    far = band_pairs(n, w_eff) - (n // c) * band_pairs(c, w_eff) \
        - band_pairs(n % c, w_eff)
    return prefill_ops(bh, g, n, d, dv, p) + bh * g * far * 2 * (d + dv)


def noncausal_moment_ops(bh: int, m: int, d: int, dv: int,
                         p: int = 2) -> int:
    """Per (b, kv-head) and key: each feature row (the constant, the
    linear ones, the pairs a <= b) is one FMA per value column and one for
    the g column."""
    return bh * m * feature_rows(d, p) * 2 * (dv + 1)


def noncausal_combine_ops(bh: int, g: int, n: int, d: int, dv: int,
                          p: int = 2) -> int:
    """Per query: each feature row of its kv head's moments, one FMA per
    value column and one for the g column."""
    return bh * g * n * feature_rows(d, p) * 2 * (dv + 1)


def state_elems(b: int, hkv: int, d: int, dv: int, p: int = 2) -> int:
    """Elements of a moment carry (m0, m1, m2, g0, g1, g2); m2 and g2 only
    at p=2."""
    deg2 = d * d * dv + d * d if p >= 2 else 0
    return b * hkv * (dv + d * dv + 1 + d + deg2)


def prefill_work(b: int, hq: int, hkv: int, n: int, d: int, dv: int,
                 itemsize: int, p: int = 2) -> tuple:
    """(operations, bytes) of one causal prefill: q, k, v read and o
    written in their dtype, the float32 final carry written."""
    nbytes = itemsize * (b * hq * n * d + b * hkv * n * (d + dv)
                         + b * hq * n * dv) + 4 * state_elems(b, hkv, d, dv)
    return prefill_ops(b * hkv, hq // hkv, n, d, dv, p), nbytes


def hybrid_work(b: int, hq: int, hkv: int, n: int, d: int, dv: int,
                w_eff: int, itemsize: int, p: int = 2) -> tuple:
    """(operations, bytes) of one hybrid forward: the prefill's bytes."""
    _, nbytes = prefill_work(b, hq, hkv, n, d, dv, itemsize, p)
    return hybrid_ops(b * hkv, hq // hkv, n, d, dv, w_eff, p), nbytes


def bwd_work(b: int, hq: int, hkv: int, n: int, d: int, dv: int,
             itemsize: int, p: int = 2) -> tuple:
    """(operations, bytes) of one §2.5 backward: q, k, v read and dq, dk,
    dv written, do read (their dtype), the float32 carry read."""
    qkv = b * hq * n * d + b * hkv * n * (d + dv)
    nbytes = itemsize * (2 * qkv + b * hq * n * dv) \
        + 4 * state_elems(b, hkv, d, dv)
    return bwd_ops(b * hkv, hq // hkv, n, d, dv, p), nbytes


def decode_work(b: int, hq: int, hkv: int, d: int, dv: int, itemsize: int,
                p: int = 2) -> tuple:
    """(operations, bytes) of one decode step: the float32 state read and
    written once, the token's q, k, v read and o written."""
    nbytes = 2 * 4 * state_elems(b, hkv, d, dv) + itemsize * (
        b * hq * d + b * hkv * (d + dv) + b * hq * dv)
    return decode_ops(b * hkv, hq // hkv, d, dv, p), nbytes


def noncausal_moments_work(b: int, hkv: int, m: int, d: int, dv: int,
                           itemsize: int, p: int = 2) -> tuple:
    """(operations, bytes) of the noncausal moments: k, v read, the
    float32 moments written."""
    nbytes = itemsize * b * hkv * m * (d + dv) \
        + 4 * state_elems(b, hkv, d, dv)
    return noncausal_moment_ops(b * hkv, m, d, dv, p), nbytes


def noncausal_combine_work(b: int, hq: int, hkv: int, n: int, d: int,
                           dv: int, itemsize: int, p: int = 2) -> tuple:
    """(operations, bytes) of the noncausal combine: q read and o
    written, the feature rows of the float32 moments read (R rows of Dv
    m columns and one g column per (b, kv-head))."""
    nbytes = itemsize * b * hq * n * (d + dv) \
        + 4 * b * hkv * feature_rows(d, p) * (dv + 1)
    return noncausal_combine_ops(b * hkv, hq // hkv, n, d, dv, p), nbytes


def bound_ms(ops: float, nbytes: float, peak: float) -> tuple:
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over `peak`."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")
