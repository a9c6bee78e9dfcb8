"""The causal prefill kernel's two-launch design, modelled in plain torch
(float64) and held against the Pallas kernel (interpret mode).

`csrc/fastmax_causal.cu` computes the causal prefill as a prefix sum of
moments over one table of feature rows (the constant, D linear, then the
pairs a <= b), written at every chunk boundary of L keys (launch A), and
a combine of each chunk's queries with the carry before it plus that
chunk's own keys (launch B), over segments of the tokens each seeded with
the last one's state. The model below follows the kernel's index math:
the row order, the slots seeded from a symmetrized `init_state`, the pair
weight 1 and diagonal weight 1/2 of the combine, the exact intra-chunk
term, the expansion of the final table to the m-major state with each
pair's own half of init[ab] - init[ba], and that state seeding the next
segment. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core.ref import normalize_qk as jnormalize  # noqa: E402
from repro.kernels.fastmax_causal import fastmax_causal_pallas  # noqa: E402
from repro_torch.kernels.fastmax_causal import (  # noqa: E402
    CHUNK, feature_rows, segment_tokens, workspace_bytes)
from torch_threads import share_cores  # noqa: F401,E402

TOL = 1e-10


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float64).copy())


def _rows(d, p):
    """The kernel's feature rows as (a, b): (-1, -1) the constant, (a, -1)
    the linear rows, then the pairs a <= b in row-major order."""
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


def _seed(init, rows, b, hkv, dv):
    """The slot table [B, Hkv, R, Dv + 1] of init_state (zeros without):
    m rows beside the g column, each pair the mean of ab and ba."""
    if init is None:
        return torch.zeros(b, hkv, len(rows), dv + 1, dtype=torch.float64)
    m0, m1, m2, g0, g1, g2 = init
    out = []
    for a, c in rows:
        if a < 0:
            m, g = m0, g0
        elif c < 0:
            m, g = m1[:, :, a], g1[:, :, a]
        else:
            m = (m2[:, :, a, c] + m2[:, :, c, a]) / 2
            g = (g2[:, :, a, c] + g2[:, :, c, a]) / 2
        out.append(torch.cat([m, g[..., None]], dim=-1))
    return torch.stack(out, dim=2)


def two_launch_model(q, k, v, w, init, p, chunk, segment=None, eps=1e-6):
    """Plain model of the kernel's call: launches A and B over segments of
    `segment` tokens (all N without), each seeded with the last segment's
    state. Returns (o, state) as the kernel gives."""
    n = q.shape[2]
    segment = segment or n
    outs = []
    for t in range(0, n, segment):
        sl = slice(t, t + segment)
        o, init = _launch_pair(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                               w[:, :, sl], init, p, chunk, eps)
        outs.append(o)
    return torch.cat(outs, dim=2), init


def _launch_pair(q, k, v, w, init, p, chunk, eps):
    """Launches A and B on one segment, seeded with `init`."""
    b, hq, n, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    g = hq // hkv
    rows = _rows(d, p)
    assert len(rows) == feature_rows(d, p)
    nc = -(-n // chunk)
    # launch A: fold keys (features x w, against v beside a ones column)
    fk = _features(k, rows) * w[..., None]                 # [B,Hkv,N,R]
    va = torch.cat([v, torch.ones_like(v[..., :1])], -1)   # [B,Hkv,N,Dv+1]
    table = _seed(init, rows, b, hkv, dv)
    slots = []
    for c in range(nc):
        slots.append(table)   # the carry before chunk c
        sl = slice(c * chunk, min(n, (c + 1) * chunk))
        table = table + torch.einsum("bhtr,bhtv->bhrv", fk[:, :, sl],
                                     va[:, :, sl])
    # launch B: queries against slot c, then the chunk's keys exactly
    weight = torch.tensor([0.5 if a >= 0 and a == c else 1.0
                           for a, c in rows], dtype=torch.float64)
    qg = q.reshape(b, hkv, g, n, d)
    o = torch.empty(b, hkv, g, n, dv, dtype=torch.float64)
    for c in range(nc):
        sl = slice(c * chunk, min(n, (c + 1) * chunk))
        qc, kc, vc, wc = qg[:, :, :, sl], k[:, :, sl], v[:, :, sl], w[:, :, sl]
        nd = torch.einsum("bhgir,bhrv->bhgiv",
                          _features(qc, rows) * weight, slots[c])
        s = torch.einsum("bhgia,bhja->bhgij", qc, kc)
        f = 1 + s + (s * s / 2 if p >= 2 else 0)
        ln = s.shape[-1]
        f = f * torch.tril(torch.ones(ln, ln, dtype=torch.float64))
        f = f * wc[:, :, None, None, :]
        num = nd[..., :dv] + torch.einsum("bhgij,bhjv->bhgiv", f, vc)
        den = nd[..., dv] + f.sum(-1)
        o[:, :, :, sl] = num / (den + eps)[..., None]
    # the final table in the state layout
    m0, g0 = table[:, :, 0, :dv], table[:, :, 0, dv]
    m1, g1 = table[:, :, 1:d + 1, :dv], table[:, :, 1:d + 1, dv]
    m2 = torch.zeros(b, hkv, d, d, dv, dtype=torch.float64)
    g2 = torch.zeros(b, hkv, d, d, dtype=torch.float64)
    for r, (a, c) in enumerate(rows):
        if c < 0:
            continue
        hm = hg = 0.0
        if init is not None:
            hm = (init[2][:, :, a, c] - init[2][:, :, c, a]) / 2
            hg = (init[5][:, :, a, c] - init[5][:, :, c, a]) / 2
        m2[:, :, a, c] = table[:, :, r, :dv] + hm
        m2[:, :, c, a] = table[:, :, r, :dv] - hm
        g2[:, :, a, c] = table[:, :, r, dv] + hg
        g2[:, :, c, a] = table[:, :, r, dv] - hg
    return o.reshape(b, hq, n, dv), (m0, m1, m2, g0, g1, g2)


def _inputs(rng, b, g, hkv, n, d, dv):
    q = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hkv * g, n,
                                                            d)))))
    k = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hkv, n, d)))))
    v = rng.normal(size=(b, hkv, n, dv))
    return q, k, v


def _init(rng, b, hkv, d, dv, p):
    """A random moment tuple: m2 and g2 are NOT symmetric."""
    shapes = [(dv,), (d, dv), (d, d, dv), (), (d,), (d, d)]
    leaves = [rng.normal(size=(b, hkv) + s) for s in shapes]
    leaves[3] = np.abs(leaves[3]) + 5.0
    if p < 2:
        leaves[2] = np.zeros_like(leaves[2])
        leaves[5] = np.zeros_like(leaves[5])
    return leaves


# (N, L, seeded, segment): a multiple of L, ragged, below L, one token
# resumed from an init_state, and in segments of one and two chunks (the
# second seeded from a non-symmetric init_state)
CASES = [(96, 32, False, None), (77, 32, True, None), (20, 64, False, None),
         (1, 64, True, None), (96, 32, False, 32), (77, 32, True, 64)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("p", [1, 2])
def test_two_launch_model_matches_pallas(p, g, case, masked):
    n, chunk, seeded, segment = case
    rng = np.random.default_rng(1000 * p + 100 * g + n + masked)
    b, hkv, d, dv = 2, 2, 8, 12
    q, k, v = _inputs(rng, b, g, hkv, n, d, dv)
    mask = ((rng.random(size=(b, 1, n)) > 0.3).astype(np.float64) if masked
            else np.ones((b, 1, n)))
    init = _init(rng, b, hkv, d, dv, p) if seeded else None
    jo, jst = fastmax_causal_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        p=p, chunk_size=16, return_state=True, interpret=True,
        init_state=None if init is None else tuple(map(jnp.asarray, init)))
    w = _t(np.broadcast_to(mask, (b, hkv, n)))
    to, tst = two_launch_model(_t(q), _t(k), _t(v), w,
                               None if init is None else [_t(x) for x in init],
                               p, chunk, segment)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL,
                               atol=TOL)
    for a, t in zip(jst, tst):
        assert tuple(a.shape) == tuple(t.shape)
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("d", [16, 32])
def test_two_launch_model_matches_pallas_wider_heads(d):
    """The pair rows' order at wider heads (D(D+1)/2 = 136 and 528)."""
    rng = np.random.default_rng(d)
    b, g, hkv, n = 1, 2, 1, 70
    q, k, v = _inputs(rng, b, g, hkv, n, d, d)
    init = _init(rng, b, hkv, d, d, 2)
    jo, jst = fastmax_causal_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), p=2, chunk_size=32,
        return_state=True, interpret=True,
        init_state=tuple(map(jnp.asarray, init)))
    w = torch.ones(b, hkv, n, dtype=torch.float64)
    to, tst = two_launch_model(_t(q), _t(k), _t(v), w, [_t(x) for x in init],
                               2, 32)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL,
                               atol=TOL)
    for a, t in zip(jst, tst):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=TOL,
                                   atol=TOL)


def test_feature_rows():
    assert feature_rows(128, 2) == 8385
    assert feature_rows(64, 2) == 2145
    assert feature_rows(128, 1) == 129
    assert [len(_rows(d, p)) for d in (4, 8) for p in (1, 2)] == [
        feature_rows(d, p) for d in (4, 8) for p in (1, 2)]


def test_segment_tokens_and_workspace_bytes(monkeypatch):
    import repro_torch.kernels.fastmax_causal as fc

    slot = 32 * 8385 * (4 * 128 + 8)   # qwen3-1.7b: B=4 x 8 kv heads
    # qwen3's prefill (N=1024, D=Dv=128): one segment of 8 chunks of
    # L=128, m slots in float32 and g slots in float64, plus the g carry
    assert CHUNK == 128
    assert segment_tokens(32, 128, 128, 2) == 15 * 128
    assert workspace_bytes(32, 1024, 128, 128, 2) == \
        8 * slot + 8 * 32 * 8385 == 1_118_357_760
    # ragged: N=1000 takes ceil(1000/128) = 8 slots; N=1 one
    assert workspace_bytes(32, 1000, 128, 128, 2) == \
        workspace_bytes(32, 1024, 128, 128, 2)
    assert workspace_bytes(1, 1, 8, 8, 1) == 9 * (4 * 8 + 8) + 8 * 9
    # a long prompt: segments of 1920 tokens, so the workspace stops
    # growing with N (32k tokens would take 4.5 GB of slots in one)
    assert workspace_bytes(32, 32768, 128, 128, 2) == \
        15 * slot + 8 * 32 * 8385 <= fc._WORKSPACE_BUDGET + 8 * 32 * 8385
    # whisper-small's decoder prefill (B=4 x 12 heads, N=128, D=Dv=64)
    assert workspace_bytes(48, 128, 64, 64, 2) == \
        48 * 2145 * (4 * 64 + 8) + 8 * 48 * 2145
    # a budget below one slot still takes one chunk a segment
    monkeypatch.setattr(fc, "_WORKSPACE_BUDGET", 1)
    assert segment_tokens(32, 128, 128, 2) == CHUNK
    assert workspace_bytes(32, 1024, 128, 128, 2) == slot + 8 * 32 * 8385
