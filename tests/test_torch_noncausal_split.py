"""CPU model of the noncausal kernel's tensor-core launches
(`csrc/fastmax_noncausal.cu`: `moments_kernel`, `combine_rows_kernel`).

Each launch is a product of two matrices per (batch, kv-head), run on the
tensor cores as m16n8k8 steps with TF32 operands. TF32 keeps 11 significant
bits, so every float32 operand x is split into hi = tf32(x) and
lo = tf32(x - hi) and a k8 step runs three passes, lo.hi + hi.lo + hi.hi,
accumulated in float32 ("3xTF32"). Here that scheme is modelled in plain
torch, following the kernel's tiling: stages of 32 keys (or moment rows),
the ragged edge of M zero-filled, feature rows past R zero, Dv padded to
the 64-column block, each k8 step's products exact and its sum rounded to
float32, each stage's sum added to the running one in float32; the g column
and the denominators summed on the CUDA cores in the kernel's order (each
stage's denominator partials in float32, added up in float64). The model is held against the Pallas kernel in interpret mode and
against the float64 plain version, at the card's limits. The CUDA kernel
itself is held against its plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core.ref import normalize_qk as jnormalize  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.fastmax import Moments  # noqa: E402
from repro_torch.kernels.fastmax_noncausal import (  # noqa: E402
    noncausal_combine_ref, noncausal_moments_ref)
from torch_threads import share_cores  # noqa: F401,E402

STAGE = 32         # keys (moments) / moment rows (combine) a stage
K_STEP = 8         # the k of m16n8k8
MOM_ROWS = 128     # feature rows a moments block
COLS = 64          # value columns a block
# the card's limits (chip_smoke.py): moments within 1e-4 of their scale; o
# within 1e-4 (float32) or 2^-7 |plain| + 2e-5 per element (bfloat16)
TOL_MOMENTS, TOL_O32 = 1e-4, 1e-4
TOL_BF16_REL, TOL_BF16_ABS = 2.0 ** -7, 2e-5
EPS = 1e-6


def tf32(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32`: round float32 to 10 stored mantissa bits, to
    nearest with ties away from zero: add 0x1000 to the magnitude's bits,
    then clear the low 13."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def _ceil(n, m):
    return -(-n // m) * m


def feature_table(d, p, rows):
    """The kernel's feature rows padded to `rows`: the factor columns
    (ia, ib) of each row in x padded with x[d] = 1, x[d + 1] = 0, its
    combine weight, and R."""
    ia, ib, w = [d], [d], [1.0]
    ia += list(range(d))
    ib += [d] * d
    w += [1.0] * d
    if p == 2:
        for a in range(d):
            for b in range(a, d):
                ia.append(a)
                ib.append(b)
                w.append(0.5 if a == b else 1.0)
    r = len(ia)
    pad = rows - r
    return (torch.tensor(ia + [d + 1] * pad), torch.tensor(ib + [d + 1] * pad),
            torch.tensor(w + [0.0] * pad), r)


def _features(x, ia, ib, live):
    """phi(x) in float32, x [BH, T, D]: x[ia] * x[ib], 0 where not live."""
    bh, t, _ = x.shape
    ones = live.to(torch.float32).expand(bh, t)[..., None]
    xp = torch.cat([x.float() * ones, ones, torch.zeros_like(ones)], -1)
    return xp[..., ia] * xp[..., ib]


def _mma_steps(part, a_ops, b_ops, sl):
    """One k8 step of every pass: the products exact, each pass's sum with
    the accumulator rounded to float32 once."""
    for a, b in zip(a_ops, b_ops):
        part = (part.double() + a[:, :, sl].double()
                @ b[:, sl].double()).float()
    return part


def _passes(a, b, passes):
    ah, al = split(a)
    bh_, bl = split(b)
    if passes == 1:
        return [ah], [bh_]
    return [ah, al, ah], [bl, bh_, bh_]


def moments_model(k, v, p, passes=3):
    """The moment launch on k [BH, M, D], v [BH, M, Dv] (float32 values, or
    bf16 values in either type). Returns (rows [BH, R_pad, Dv_pad], g
    [BH, R_pad], R): the feature rows' moments and g column, zero past R
    and past Dv."""
    bh, m, d = k.shape
    dv = v.shape[-1]
    ia, ib, _, r = feature_table(d, p, _ceil(1 + d + d * (d + 1) // 2,
                                             MOM_ROWS))
    mp, dvp = _ceil(m, STAGE), _ceil(dv, COLS)
    kp = torch.zeros(bh, mp, d)
    kp[:, :m] = k.float()
    vp = torch.zeros(bh, mp, dvp)
    vp[:, :m, :dv] = v.float()
    f = _features(kp, ia, ib, torch.arange(mp) < m)      # [BH, Mp, Rp]
    a_ops, b_ops = _passes(f.transpose(1, 2), vp, passes)
    acc = torch.zeros(bh, len(ia), dvp)
    for s in range(0, mp, STAGE):
        part = torch.zeros_like(acc)
        for t0 in range(s, s + STAGE, K_STEP):
            part = _mma_steps(part, a_ops, b_ops, slice(t0, t0 + K_STEP))
        acc = acc + part
    # g column: lane t of a quad sums keys t and t + 4 of every k8 step,
    # then the quad is summed (l0 + l1) + (l2 + l3), in float32
    lanes = torch.zeros(4, bh, len(ia))
    for t0 in range(0, mp, K_STEP):
        for t in range(4):
            lanes[t] = lanes[t] + f[:, t0 + t]
            lanes[t] = lanes[t] + f[:, t0 + t + 4]
    g = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    return acc, g, r


def unpack(rows, g, d, dv, p):
    """Feature rows -> the six moments in `compute_moments`' layout (pair
    rows written to both halves of m2 and g2)."""
    bh = rows.shape[0]
    m0, m1 = rows[:, 0, :dv], rows[:, 1:d + 1, :dv]
    g0, g1 = g[:, 0], g[:, 1:d + 1]
    m2 = torch.zeros(bh, d, d, dv)
    g2 = torch.zeros(bh, d, d)
    if p == 2:
        i = 1 + d
        for a in range(d):
            n = d - a
            m2[:, a, a:] = rows[:, i:i + n, :dv]
            m2[:, a:, a] = rows[:, i:i + n, :dv]
            g2[:, a, a:] = g[:, i:i + n]
            g2[:, a:, a] = g[:, i:i + n]
            i += n
    return m0, m1, m2, g0, g1, g2


def combine_model(q, mom, p, passes=3, den_fold64=True):
    """The combine's row launch: q [BH, GN, D] (float32 values, or bf16
    values) against the six float32 moments of `unpack`. Returns o
    [BH, GN, Dv] in float32 (before the cast to q's type). With
    `den_fold64=False` the denominators are one float32 running sum."""
    m0, m1, m2, g0, g1, g2 = mom
    bh, gn, d = q.shape
    dv = m0.shape[-1]
    ia, ib, w, r = feature_table(d, p, _ceil(1 + d + d * (d + 1) // 2,
                                             STAGE))
    rp, dvp = len(ia), _ceil(dv, COLS)
    rows = torch.zeros(bh, rp, dvp)
    gcol = torch.zeros(bh, rp)
    rows[:, 0, :dv], gcol[:, 0] = m0, g0
    rows[:, 1:d + 1, :dv], gcol[:, 1:d + 1] = m1, g1
    if p == 2:
        a, b = ia[1 + d:r], ib[1 + d:r]
        rows[:, 1 + d:r, :dv] = m2[:, a, b]
        gcol[:, 1 + d:r] = g2[:, a, b]
    f = w * _features(q, ia, ib, torch.ones(gn, dtype=torch.bool))
    a_ops, b_ops = _passes(f, rows, passes)
    acc = torch.zeros(bh, gn, dvp)
    lanes = torch.zeros(4, bh, gn, dtype=torch.float64)
    for s in range(0, rp, STAGE):
        part = torch.zeros_like(acc)
        dp = torch.zeros(4, bh, gn) if den_fold64 else lanes.float()
        for r0 in range(s, s + STAGE, K_STEP):
            part = _mma_steps(part, a_ops, b_ops, slice(r0, r0 + K_STEP))
            for t in range(4):   # den += f g, a float32 FMA
                for rr in (r0 + t, r0 + t + 4):
                    dp[t] = (dp[t].double() + f[:, :, rr].double()
                             * gcol[:, rr, None].double()).float()
        acc = acc + part
        if den_fold64:           # each stage's partial added in float64
            lanes += dp.double()
        else:
            lanes = dp.double()
    den = ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3]) + EPS).float()
    return (acc / den[..., None])[..., :dv]


def _inputs(seed, b, hkv, g, n, m, d, dv, p, dtype):
    """Pre-normalized q̂ (q̂/D at p = 1, as the card checks), k̂ and v as
    float32 tensors holding values of `dtype`."""
    rng = np.random.default_rng(seed)
    q = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hkv * g, n,
                                                           d)))))
    k = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hkv, m, d)))))
    v = rng.normal(size=(b, hkv, m, dv))
    if p == 1:
        q = q / d
    return tuple(torch.tensor(x, dtype=dtype).float() for x in (q, k, v))


def _kernel_model(q, k, v, p, dtype, passes=3):
    """Both launches as the kernel runs them: (moments, o in `dtype`)."""
    b, hq, n, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    rows, g, _ = moments_model(k.reshape(b * hkv, -1, d),
                               v.reshape(b * hkv, -1, dv), p, passes)
    mom = unpack(rows, g, d, dv, p)
    o = combine_model(q.reshape(b * hkv, -1, d), mom, p, passes)
    mom = Moments(*(t.reshape((b, hkv) + t.shape[1:]) for t in mom))
    return mom, o.reshape(b, hq, n, dv).to(dtype)


def _moment_err(a, ref):
    return max(((x.double() - y).abs().max() / max(1.0, y.abs().max()))
               .item() for x, y in zip(a, ref))


def _o_ok(o, ref):
    diff = (o.double() - ref.double()).abs()
    if o.dtype == torch.bfloat16:
        return bool((diff <= ref.double().abs() * TOL_BF16_REL
                     + TOL_BF16_ABS).all()), diff.max().item()
    return diff.max().item() <= TOL_O32, diff.max().item()


def test_tf32_rounding():
    """Ties go away from zero, the low 13 bits are cleared, and the split
    keeps 22 bits."""
    one = 1.0
    x = torch.tensor([one + 2 ** -11, one + 2 ** -12, one + 3 * 2 ** -11,
                      -(one + 2 ** -11), 0.0, 2.0 ** -100])
    want = torch.tensor([one + 2 ** -10, one, one + 2 ** -9, -(one + 2 ** -10),
                         0.0, 2.0 ** -100])
    assert torch.equal(tf32(x), want)
    y = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    assert not (tf32(y).view(torch.int32) & 0x1FFF).any()
    hi, lo = split(y)
    assert ((hi - y).abs() <= y.abs() * 2.0 ** -11).all()
    assert ((hi.double() + lo.double() - y.double()).abs()
            <= y.double().abs() * 2.0 ** -22).all()


def test_bf16_pair_features_split_exactly():
    """A bf16 value is its own TF32 hi; a product of two bf16 values (at
    most 16 significant bits) is exactly hi + lo: the moments of bf16 keys
    and values need two passes, each product exact."""
    gen = torch.Generator().manual_seed(1)
    a = torch.randn(1 << 16, generator=gen).to(torch.bfloat16).float()
    b = torch.randn(1 << 16, generator=gen).to(torch.bfloat16).float()
    assert torch.equal(tf32(a), a)
    f = a * b                       # exact in float32
    assert torch.equal(f.double(), a.double() * b.double())
    hi, lo = split(f)
    assert torch.equal(tf32(lo), lo)
    assert torch.equal(hi.double() + lo.double(), f.double())


# (M, Dv, G, N): a ragged key stage and Dv = 12 padded to its column
# block, at G*N = 17 (the smallest input of the row combine); then more
# stages, a full column block and G = 2
SHAPES = [(37, 12, 1, 17), (200, 64, 2, 40)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("p", [1, 2])
def test_split_model_matches_pallas_and_float64(p, dtype, shape):
    """The model of both launches at D = 64 against the Pallas kernel in
    interpret mode (o) and the float64 plain version (moments and o), at
    the card's limits; rows past R come out zero."""
    m, dv, g, n = shape
    d, b, hkv = 64, 1, 2
    q, k, v = _inputs(100 * p + m, b, hkv, g, n, m, d, dv, p, dtype)
    rows, _, r = moments_model(k.reshape(b * hkv, m, d),
                               v.reshape(b * hkv, m, dv), p)
    assert not rows[:, r:].any() and not rows[..., dv:].any()
    mom, o = _kernel_model(q, k, v, p, dtype)

    ref_mom = noncausal_moments_ref(k.double(), v.double(), p=p)
    assert _moment_err(mom, ref_mom) <= TOL_MOMENTS
    ref_o = noncausal_combine_ref(q.double(), ref_mom, p=p, denom_eps=EPS)
    ok, err = _o_ok(o, ref_o.to(dtype))
    assert ok, err

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jo = jops.fastmax(*(jnp.asarray(x.numpy(), jdt) for x in (q, k, v)),
                      p=p, causal=False, chunk_size=16, denom_eps=EPS,
                      interpret=True)
    pallas = torch.tensor(np.asarray(jo, np.float32)).to(dtype)
    ok, err = _o_ok(o, pallas)
    assert ok, err


def test_one_tf32_pass_is_not_enough():
    """A single TF32 pass (hi.hi) errs at least 10x more than the split,
    in the moments and in o, and breaks the limits the split keeps."""
    d, m, dv = 64, 200, 64
    q, k, v = _inputs(7, 1, 2, 1, 40, m, d, dv, 2, torch.float32)
    ref_mom = noncausal_moments_ref(k.double(), v.double(), p=2)
    ref_o = noncausal_combine_ref(q.double(), ref_mom, p=2, denom_eps=EPS)
    errs = {}
    for passes in (3, 1):
        mom, o = _kernel_model(q, k, v, 2, torch.float32, passes)
        errs[passes] = (_moment_err(mom, ref_mom),
                        (o.double() - ref_o).abs().max().item())
    assert errs[1][0] >= 10 * errs[3][0] and errs[1][0] > TOL_MOMENTS, errs
    assert errs[1][1] >= 10 * errs[3][1], errs


def test_denominator_partials_are_added_in_float64():
    """With one key (M = 1) a row's denominator f(s) falls to 1/2 from
    feature terms a hundred times larger. Summing each stage's partials in
    float32 and the stages in float64 keeps the model as close to float64
    as the plain float32 version; one float32 running sum errs several
    times more."""
    d = 64
    q, k, v = _inputs(11, 2, 2, 1, 40, 1, d, d, 2, torch.float32)
    ref_mom = noncausal_moments_ref(k.double(), v.double(), p=2)
    ref_o = noncausal_combine_ref(q.double(), ref_mom, p=2, denom_eps=EPS)
    plain = noncausal_combine_ref(q, noncausal_moments_ref(k, v, p=2), p=2,
                                  denom_eps=EPS)
    rows, g, _ = moments_model(k.reshape(4, 1, d), v.reshape(4, 1, d), 2)
    mom = unpack(rows, g, d, d, 2)
    err = {}
    for fold64 in (True, False):
        o = combine_model(q.reshape(4, -1, d), mom, 2, den_fold64=fold64)
        err[fold64] = (o.reshape(q.shape).double() - ref_o).abs().max().item()
    e_plain = (plain.double() - ref_o).abs().max().item()
    assert err[True] <= 2 * e_plain, (err, e_plain)
    assert err[False] >= 2 * err[True], (err, e_plain)
