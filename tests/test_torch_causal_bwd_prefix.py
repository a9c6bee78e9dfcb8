"""The backward kernel's four-launch design, modelled in plain torch
(float64) and held against the Pallas backward kernel (interpret mode).

`csrc/fastmax_causal_bwd.cu` computes the §2.5 backward on the feature
table of the prefill (the constant, D linear, then the pairs a <= b) in
four launches per segment of the tokens, the last segment first:
  A': the carry before each chunk of L tokens: from the last chunk down,
      the final carry (each pair row the mean of ab and ba) less each
      chunk's moments in turn;
  B': each chunk's queries against that carry plus the chunk's own keys:
      u = do / (den + eps), sden = -o.u, and dq through the Jacobian of
      the queries' features plus the in-chunk ds k;
  C:  the cotangent of the carry after each chunk, the features of the
      queries of every later chunk against [u | sden]; its total after
      chunk 0, expanded to the moment layout (m2[ab] = m2[ba] = Z[ab]/2),
      is dstate;
  D:  each chunk's keys against that cotangent (dv through the weighted
      features, dk through their Jacobian) plus the in-chunk f u and ds q.
Segments are seeded with the carry slot 0 and the cotangent total of the
segment after them. The model below follows that index math; the CUDA
kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core.fastmax import Moments, _causal_scan_cg_bwd  # noqa: E402
from repro.core.ref import normalize_qk as jnormalize  # noqa: E402
from repro.kernels.fastmax_causal import fastmax_causal_pallas  # noqa: E402
from repro.kernels.fastmax_causal_bwd import (  # noqa: E402
    fastmax_causal_bwd_pallas)
from repro_torch.kernels.fastmax_causal import (  # noqa: E402
    CHUNK, feature_rows)
from repro_torch.kernels.fastmax_causal_bwd import (  # noqa: E402
    bwd_workspace_bytes)
from torch_threads import share_cores  # noqa: F401,E402

TOL = 1e-10
F64 = torch.float64


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float64).copy())


def _rows(d, p):
    """The feature rows as (a, b): (-1, -1) the constant, (a, -1) the
    linear rows, then the pairs a <= b in row-major order."""
    rows = [(-1, -1)] + [(a, -1) for a in range(d)]
    if p >= 2:
        rows += [(a, b) for a in range(d) for b in range(a, d)]
    return rows


def _features(x, rows):
    """x [..., D] -> its feature rows [..., R]."""
    one = torch.ones_like(x[..., 0])
    return torch.stack([one if a < 0 else (x[..., a] if b < 0
                                           else x[..., a] * x[..., b])
                        for a, b in rows], dim=-1)


def _jacobian(x, rows):
    """x [..., D] -> d φ_r / d x_a [..., R, D]."""
    jac = torch.zeros(x.shape[:-1] + (len(rows), x.shape[-1]), dtype=F64)
    for r, (a, b) in enumerate(rows):
        if a < 0:
            continue
        if b < 0:
            jac[..., r, a] = 1.0
        else:
            jac[..., r, a] += x[..., b]
            jac[..., r, b] += x[..., a]
    return jac


def _weights(rows):
    """The combine's row weights: 1/2 on the diagonal pairs."""
    return torch.tensor([0.5 if a >= 0 and a == b else 1.0 for a, b in rows],
                        dtype=F64)


def _table(final, rows):
    """The final carry as a table [B, Hkv, R, Dv + 1]: m rows beside the g
    column, each pair the mean of ab and ba."""
    m0, m1, m2, g0, g1, g2 = final
    out = []
    for a, b in rows:
        if a < 0:
            m, g = m0, g0
        elif b < 0:
            m, g = m1[:, :, a], g1[:, :, a]
        else:
            m = (m2[:, :, a, b] + m2[:, :, b, a]) / 2
            g = (g2[:, :, a, b] + g2[:, :, b, a]) / 2
        out.append(torch.cat([m, g[..., None]], dim=-1))
    return torch.stack(out, dim=2)


def _poly(s, p):
    return 1 + s + (s * s / 2 if p >= 2 else 0)


def _chunks(n, chunk):
    return [slice(c, min(n, c + chunk)) for c in range(0, n, chunk)]


def _launch_a(k, v, seed, rows, chunk):
    """Carry slots: from the last chunk down, slot c = slot c+1 (the seed
    after the last chunk) minus chunk c's moments."""
    fk = _features(k, rows)
    va = torch.cat([v, torch.ones_like(v[..., :1])], -1)
    sl = _chunks(k.shape[2], chunk)
    slots, carry = [None] * len(sl), seed
    for c in reversed(range(len(sl))):
        carry = carry - torch.einsum("bhtr,bhtv->bhrv", fk[:, :, sl[c]],
                                     va[:, :, sl[c]])
        slots[c] = carry
    return slots


def _launch_b(qg, k, v, dog, slots, rows, p, chunk, eps):
    """Queries: dq, u and sden of every query row ([B, Hkv, G, n, ...])."""
    dv = v.shape[-1]
    wt = _weights(rows)
    dq = torch.zeros_like(qg)
    u = torch.zeros_like(dog)
    sden = torch.zeros(dog.shape[:-1], dtype=F64)
    for c, sl in enumerate(_chunks(k.shape[2], chunk)):
        qc, kc, vc, doc = qg[:, :, :, sl], k[:, :, sl], v[:, :, sl], \
            dog[:, :, :, sl]
        nd = torch.einsum("bhgir,bhrv->bhgiv", _features(qc, rows) * wt,
                          slots[c])
        s = torch.einsum("bhgia,bhja->bhgij", qc, kc)
        mask = torch.tril(torch.ones(s.shape[-2:], dtype=F64))
        f = _poly(s, p) * mask
        num = nd[..., :dv] + torch.einsum("bhgij,bhjv->bhgiv", f, vc)
        deni = 1 / (nd[..., dv] + f.sum(-1) + eps)
        uc = doc * deni[..., None]
        sc = -(num * deni[..., None] * uc).sum(-1)
        y = torch.einsum("bhrv,bhgiv->bhgir", slots[c],
                         torch.cat([uc, sc[..., None]], -1))
        dqc = torch.einsum("bhgir,bhgira->bhgia", y * wt,
                           _jacobian(qc, rows))
        fp = (1 + s) if p >= 2 else torch.ones_like(s)
        ds = fp * (torch.einsum("bhgiv,bhjv->bhgij", uc, vc)
                   + sc[..., None]) * mask
        dq[:, :, :, sl] = dqc + torch.einsum("bhgij,bhja->bhgia", ds, kc)
        u[:, :, :, sl], sden[:, :, :, sl] = uc, sc
    return dq, u, sden


def _launch_c(qg, u, sden, seed, rows, chunk):
    """Cotangent slots: slot c = seed + the queries' [u | sden] moments of
    chunks > c; returns them and the total after chunk 0."""
    fq = _features(qg, rows)
    ua = torch.cat([u, sden[..., None]], -1)
    sl = _chunks(qg.shape[3], chunk)
    slots, acc = [None] * len(sl), seed
    for c in reversed(range(len(sl))):
        slots[c] = acc
        acc = acc + torch.einsum("bhgtr,bhgtv->bhrv", fq[:, :, :, sl[c]],
                                 ua[:, :, :, sl[c]])
    return slots, acc


def _launch_d(qg, k, v, u, sden, zslots, rows, p, chunk):
    """Keys: dk and dv of every key row."""
    wt = _weights(rows)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for c, sl in enumerate(_chunks(k.shape[2], chunk)):
        qc, kc, vc = qg[:, :, :, sl], k[:, :, sl], v[:, :, sl]
        uc, sc = u[:, :, :, sl], sden[:, :, :, sl]
        z = zslots[c]
        dvc = torch.einsum("bhjr,bhrv->bhjv", _features(kc, rows) * wt,
                           z[..., :-1])
        y = torch.einsum("bhrv,bhjv->bhjr", z,
                         torch.cat([vc, torch.ones_like(vc[..., :1])], -1))
        dkc = torch.einsum("bhjr,bhjra->bhja", y * wt, _jacobian(kc, rows))
        s = torch.einsum("bhgia,bhja->bhgij", qc, kc)
        mask = torch.tril(torch.ones(s.shape[-2:], dtype=F64))
        f = _poly(s, p) * mask
        fp = (1 + s) if p >= 2 else torch.ones_like(s)
        ds = fp * (torch.einsum("bhgiv,bhjv->bhgij", uc, vc)
                   + sc[..., None]) * mask
        dv[:, :, sl] = dvc + torch.einsum("bhgij,bhgiv->bhjv", f, uc)
        dk[:, :, sl] = dkc + torch.einsum("bhgij,bhgia->bhja", ds, qc)
    return dk, dv


def _dstate(z, rows, d):
    """The cotangent total [B, Hkv, R, Dv + 1] in the moment layout."""
    b, hkv, _, w = z.shape
    dm2 = torch.zeros(b, hkv, d, d, w - 1, dtype=F64)
    dg2 = torch.zeros(b, hkv, d, d, dtype=F64)
    for r, (a, c) in enumerate(rows):
        if c >= 0:
            dm2[:, :, a, c] = dm2[:, :, c, a] = z[:, :, r, :-1] / 2
            dg2[:, :, a, c] = dg2[:, :, c, a] = z[:, :, r, -1] / 2
    return (z[:, :, 0, :-1], z[:, :, 1:d + 1, :-1], dm2, z[:, :, 0, -1],
            z[:, :, 1:d + 1, -1], dg2)


def four_launch_model(q, k, v, final, do, p, chunk, segment=None,
                      eps=1e-6):
    """Plain model of the kernel's call: launches A', B', C and D over
    segments of `segment` tokens (all N without), the last first, each
    seeded with the carry slot 0 and cotangent total of the segment after
    it. Returns (dq, dk, dv, dstate)."""
    b, hq, n, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    rows = _rows(d, p)
    assert len(rows) == feature_rows(d, p)
    qg = q.reshape(b, hkv, g, n, d)
    dog = do.reshape(b, hkv, g, n, -1)
    carry = _table(final, rows)
    zcarry = torch.zeros_like(carry)
    dq, dk, dv = torch.zeros_like(qg), torch.zeros_like(k), \
        torch.zeros_like(v)
    segment = segment or n
    for t in reversed(range(0, n, segment)):
        sl = slice(t, t + segment)
        qs, ks, vs = qg[:, :, :, sl], k[:, :, sl], v[:, :, sl]
        slots = _launch_a(ks, vs, carry, rows, chunk)
        dq[:, :, :, sl], u, sden = _launch_b(qs, ks, vs, dog[:, :, :, sl],
                                             slots, rows, p, chunk, eps)
        zslots, zcarry = _launch_c(qs, u, sden, zcarry, rows, chunk)
        dk[:, :, sl], dv[:, :, sl] = _launch_d(qs, ks, vs, u, sden, zslots,
                                               rows, p, chunk)
        carry = slots[0]
    return dq.reshape(b, hq, n, d), dk, dv, _dstate(zcarry, rows, d)


def _inputs(rng, b, g, hkv, n, d, dv):
    q = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hkv * g, n,
                                                            d)))))
    k = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hkv, n, d)))))
    v = rng.normal(size=(b, hkv, n, dv))
    do = rng.normal(size=(b, hkv * g, n, dv))
    return q, k, v, do


def _init(rng, b, hkv, d, dv, p):
    """A random moment tuple: m2 and g2 are NOT symmetric."""
    shapes = [(dv,), (d, dv), (d, d, dv), (), (d,), (d, d)]
    leaves = [rng.normal(size=(b, hkv) + s) for s in shapes]
    leaves[3] = np.abs(leaves[3]) + 5.0
    if p < 2:
        leaves[2] = np.zeros_like(leaves[2])
        leaves[5] = np.zeros_like(leaves[5])
    return leaves


def _assert_close(a, t):
    a = np.asarray(a)
    assert a.shape == tuple(t.shape)
    np.testing.assert_allclose(t.numpy(), a, rtol=TOL, atol=TOL)


# (N, L, init, segment): a multiple of L, ragged, below L, one token; a
# forward seeded from a forward's own (symmetric) carry; seeded from a
# random, non-symmetric init_state; in segments of one and two chunks
CASES = [(96, 32, None, None), (77, 32, None, None), (20, 64, None, None),
         (1, 64, "forward", None), (77, 32, "forward", None),
         (70, 32, "random", None), (96, 32, None, 32),
         (77, 16, "forward", 32), (70, 32, "random", 64)]


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("p", [1, 2])
def test_four_launch_model_matches_pallas(p, g, case):
    n, chunk, init, segment = case
    rng = np.random.default_rng(1000 * p + 100 * g + n + len(init or ""))
    b, hkv, d, dv = 2, 2, 8, 12
    q, k, v, do = _inputs(rng, b, g, hkv, n, d, dv)
    seed = None
    if init == "forward":
        q0, k0, v0, _ = _inputs(rng, b, g, hkv, 20, d, dv)
        _, seed = fastmax_causal_pallas(
            jnp.asarray(q0), jnp.asarray(k0), jnp.asarray(v0), p=p,
            chunk_size=16, return_state=True, interpret=True)
    elif init == "random":
        seed = tuple(map(jnp.asarray, _init(rng, b, hkv, d, dv, p)))
    _, final = fastmax_causal_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), p=p, chunk_size=16,
        return_state=True, interpret=True, init_state=seed)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = fastmax_causal_bwd_pallas(*jargs, final, jnp.asarray(do), p=p,
                                     chunk_size=16, interpret=True,
                                     return_dstate=True)
    got = four_launch_model(_t(q), _t(k), _t(v), [_t(x) for x in final],
                            _t(do), p, chunk, segment)
    wants = list(want[:3]) + list(want[3])
    if init == "random" and p >= 2:
        # the Pallas kernel contracts dq's m2 term with the carry's rows
        # (sum_b q_b m2[ab]) and its g2 term with its columns, which is the
        # derivative only for a symmetric carry; the output depends on the
        # symmetric half alone, and the JAX reference's autodiff backward
        # (the oracle) differentiates that, as the model does
        wants[0] = _causal_scan_cg_bwd(p, 16, 1e-6, False,
                                       (*jargs, Moments(*final)),
                                       jnp.asarray(do))[0]
    for a, t in zip(wants, list(got[:3]) + list(got[3])):
        _assert_close(a, t)


@pytest.mark.parametrize("d", [16, 32])
def test_four_launch_model_matches_pallas_wider_heads(d):
    """The pair rows' order and Jacobian at wider heads (D(D+1)/2 = 136 and
    528 pair rows), G = 2, two chunks."""
    rng = np.random.default_rng(d)
    b, g, hkv, n = 1, 2, 1, 50
    q, k, v, do = _inputs(rng, b, g, hkv, n, d, d)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, final = fastmax_causal_pallas(*jargs, p=2, chunk_size=16,
                                     return_state=True, interpret=True)
    want = fastmax_causal_bwd_pallas(*jargs, final, jnp.asarray(do), p=2,
                                     chunk_size=16, interpret=True,
                                     return_dstate=True)
    got = four_launch_model(_t(q), _t(k), _t(v), [_t(x) for x in final],
                            _t(do), 2, 32)
    for a, t in zip(list(want[:3]) + list(want[3]),
                    list(got[:3]) + list(got[3])):
        _assert_close(a, t)


def test_bwd_workspace_bytes():
    assert CHUNK == 128
    r = 8385
    # qwen3-1.7b's training shapes (B=4, Hq=16, Hkv=8, N=1024, D=Dv=128):
    # one segment of 8 chunks, a carry slot (float32 m, float64 g) and a
    # cotangent slot (float32) per chunk, u and sden per query row
    assert bwd_workspace_bytes(4, 16, 8, 1024, 128, 128, 2) == \
        8 * 32 * r * (520 + 516) + 4 * 64 * 1024 * 129 == 2_257_652_736
    # B=2 at N=4096: two segments of 3840 and 256 tokens, with the
    # cotangent carried between them
    assert bwd_workspace_bytes(2, 16, 8, 4096, 128, 128, 2) == \
        30 * 16 * r * (520 + 516) + 4 * 32 * 4096 * 129 + 4 * 16 * r * 129
    # granite's grouping (G=48 on one kv head): one slot set per kv head
    assert bwd_workspace_bytes(1, 48, 1, 512, 128, 128, 2) == \
        4 * r * (520 + 516) + 4 * 48 * 512 * 129
