"""The §2.5 backward at MLA's widths (deepseek-v2, kimi-k2: D = qk_nope +
qk_rope = 128 + 64 = 192, Dv = 128), on the CPU.

The plain version of the CUDA backward (`fastmax_causal_bwd_ref`, the
kernel's counterpart off the card) against the reference's own jnp reverse
scan (`repro.core.fastmax._causal_scan_cg_bwd`) in float64: p = 1 and 2,
G = 1 and 2, N spanning chunk boundaries with a ragged tail, with dstate.
Beside it the wrapper's arithmetic at that width: the workspace and its
segments at MLA's train shape, the shared memory of each of the four
launches against the 227 KB a block may have on an H100, the column groups
the launches are instantiated with, and the refusal past the widths the
kernel takes. The CUDA kernel itself is held against its plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py `[bwd]`).
"""
import re
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core.fastmax import Moments as JMoments  # noqa: E402
from repro.core.fastmax import _causal_scan_cg_bwd  # noqa: E402
from repro.core.ref import normalize_qk as jnormalize  # noqa: E402
from repro_torch.kernels import fastmax_causal_bwd as fb  # noqa: E402
from repro_torch.kernels.fastmax_causal import (  # noqa: E402
    CHUNK, fastmax_causal_ref, feature_rows, segment_tokens)
from torch_threads import share_cores  # noqa: F401,E402

TOL = 1e-10
D, DV = 192, 128
CSRC = Path(fb.__file__).resolve().parent / "csrc"


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _inputs(seed, b, hq, hkv, n, p):
    rng = np.random.default_rng(seed)
    qs = 1.0 / D if p == 1 else 1.0   # p = 1: q̂/D keeps f = 1 + s >= 0
    q = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hq, n, D)))))
    k = np.asarray(jnormalize(jnp.asarray(rng.normal(size=(b, hkv, n, D)))))
    v = rng.normal(size=(b, hkv, n, DV))
    do = rng.normal(size=(b, hq, n, DV))
    return q * qs, k, v, do


@pytest.mark.parametrize("p, hq, n", [(2, 1, 40), (2, 2, 24), (1, 1, 40),
                                      (1, 2, 24)],
                         ids=["p2-G1-N40", "p2-G2-N24", "p1-G1-N40",
                              "p1-G2-N24"])
def test_plain_bwd_at_mla_width_matches_the_reference(p, hq, n):
    """dq, dk, dv and the six dstate moments at D = 192, Dv = 128 against
    the reference's reverse scan, float64, chunks of 16 (N = 40: two full
    chunks and a ragged tail; N = 24 at G = 2: one and a tail), both on
    one final carry (the port's float64 forward's)."""
    q, k, v, do = _inputs(10 * p + hq, 1, hq, 1, n, p)
    _, final = fastmax_causal_ref(_t(q), _t(k), _t(v), p=p, chunk_size=16)
    res = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
           JMoments(*(jnp.asarray(x.numpy()) for x in final)))
    want = _causal_scan_cg_bwd(p, 16, 1e-6, False, res, jnp.asarray(do),
                               return_dstate=True)
    got = fb.fastmax_causal_bwd_ref(_t(q), _t(k), _t(v), tuple(final),
                                    _t(do), p=p, chunk_size=16,
                                    return_dstate=True)
    assert tuple(got[0].shape) == (1, hq, n, D)
    assert tuple(got[2].shape) == (1, 1, n, DV)
    for a, b in zip(list(want[:3]) + list(want[3]),
                    list(got[:3]) + list(got[3])):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=TOL,
                                   atol=TOL)


def test_workspace_and_segments_at_mla_train_shape():
    """B = 2, 128 q on 128 kv heads, N = 1024, D = 192, Dv = 128, p = 2: a
    carry slot of 256 x 18,721 rows is 2.49 GB, over the 2 GB budget, so
    each segment is one chunk of 128 tokens: 8 segments, one carry slot and
    one cotangent slot, u and sden for every query row, and the cotangent
    table carried between segments."""
    bh, r = 2 * 128, feature_rows(D, 2)
    assert r == 1 + 192 + 192 * 193 // 2 == 18721
    assert segment_tokens(bh, D, DV, 2) == CHUNK
    assert -(-1024 // segment_tokens(bh, D, DV, 2)) == 8
    want = (bh * r * ((4 * DV + 8) + (4 * DV + 4))
            + 4 * 2 * 128 * 1024 * (DV + 1) + 4 * bh * r * (DV + 1))
    assert fb.bwd_workspace_bytes(2, 128, 128, 1024, D, DV, 2) == want
    assert want == 7_573_344_256


@pytest.mark.parametrize("d, dv", [(24, 16), (64, 64), (128, 128),
                                   (64, 128), (192, 128)])
@pytest.mark.parametrize("p", [1, 2])
def test_every_launch_fits_in_shared_memory(d, dv, p):
    """Static and dynamic shared memory of each launch within the 232,448
    bytes an H100 block may opt into."""
    smem = fb.launch_smem_bytes(d, dv, p)
    assert set(smem) == {"slots", "queries", "cot", "keys"}
    assert all(0 < x <= fb.SMEM_LIMIT for x in smem.values()), smem


def test_shared_memory_at_mla_width():
    """The numbers the kernel's header states: launch D 217,984 bytes and
    B' 208,384 at D = 192, Dv = 128; the keys' launch would take 241,536
    dynamic bytes (over the limit) with three column groups over Dv too
    and u held twice."""
    smem = fb.launch_smem_bytes(D, DV, 2)
    assert smem["keys"] == 217_984 and smem["queries"] == 208_384
    assert 4 * (2 * 64 * 193 + 132 * 64 + 32 * (193 + 2 * 192 + 129 + 144)
                + 32) == 241_536 > fb.SMEM_LIMIT


@pytest.mark.parametrize("d, dv, groups", [(24, 16, (1, 1)), (64, 64, (1, 1)),
                                           (128, 64, (2, 2)),
                                           (64, 128, (2, 2)),
                                           (128, 128, (2, 2)),
                                           (192, 128, (2, 3)),
                                           (132, 64, (2, 3))])
def test_column_groups(d, dv, groups):
    assert fb.column_groups(d, dv) == groups


def test_wrapper_constants_match_the_source():
    """The limits and tiles `launch_smem_bytes` and `check_widths` use are
    the CUDA source's."""
    src = (CSRC / "fastmax_causal_bwd.cu").read_text()
    tab = (CSRC / "feature_table.cuh").read_text()

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const(src, "kMaxD") == fb.MAX_D == D
    assert const(src, "kMaxDv") == fb.MAX_DV == DV
    assert (const(src, "kRT"), const(src, "kYS")) == (fb._RT, fb._YS)
    assert (const(tab, "kThreads"), const(tab, "kTile"), const(tab, "kCols"),
            const(tab, "kChunk"), const(tab, "kPS")) == (
        fb._THREADS, fb._TILE, fb._COLS, fb._STEP, fb._PS)
    assert "Width::k23 ? QUERIES(T, 2, 3, A)" in src
    assert "Width::k23 ? KEYS(T, 2, 3)" in src


@pytest.mark.parametrize("d, dv", [(196, 128), (192, 132), (190, 128)])
def test_wrapper_refuses_widths_past_the_kernel(d, dv):
    """D = 196 or Dv = 132 (past the limits) and D = 190 (not a multiple
    of 4) raise with the limits in the message, on any device: the width
    check comes before the device check."""
    q = torch.zeros(1, 1, 8, d)
    v = torch.zeros(1, 1, 8, dv)
    with pytest.raises(ValueError, match=r"D <= 192 and 4 <= Dv <= 128"):
        fb.fastmax_causal_bwd_cuda(q, q, v, [None] * 6, v, p=2)
    with pytest.raises(ValueError, match=rf"got D={d}, Dv={dv}"):
        fb.check_widths(d, dv)
    fb.check_widths(D, DV)


def test_one_layer_cut_trains():
    """deepseek-v2 cut to its first_k_dense layer (as chip_smoke.py's
    `[moe train]` runs it at full width) keeps an empty stacked block that
    the loss does not use: the train step gives it a zero gradient, as
    jax.grad does in the reference, and trains the dense layer."""
    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step, pick_optimizer
    from repro_torch.models import init_model
    from repro_torch.models.param import count_params

    cfg = get_smoke_config("deepseek-v2-236b", n_layers=1, remat="none",
                           attn=AttentionSpec.parse("fastmax2-kernel"))
    assert cfg.n_groups == 0
    params = init_model(cfg, seed=0, device="cpu")
    dense = params["dense_0"]["mixer"]["wq"].clone()
    batch = SyntheticLM(cfg.vocab_size, 48, seed=0).batch(0, 2)
    _, opt = pick_optimizer(cfg, count_params(params), lr=3e-3,
                            total_steps=4)
    state = opt[0](params)
    step = make_train_step(cfg, opt)
    losses = []
    for _ in range(3):
        params, state, m = step(params, state, batch)
        losses.append(m["loss"].item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert params["blocks_0"]["mixer"]["wq"].shape[0] == 0
    assert not torch.equal(params["dense_0"]["mixer"]["wq"], dense)
