"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a card; the decision is
taken inside the `cuda_device` fixture, never while the module imports.
This file imports no JAX, so it runs on the machine with the card:
  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import math

import pytest
import torch

from repro_torch.core.ref import normalize_qk
from repro_torch.kernels.fastmax_causal import (fastmax_causal_cuda,
                                                fastmax_causal_ref,
                                                workspace_bytes)
from repro_torch.kernels.fastmax_decode import fastmax_decode_cuda
from repro_torch.kernels.ref import fastmax_decode_ref


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never while the module imports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m cuda "
                    "tests/test_torch_cuda.py` on the machine with the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_as_close_as_plain(o, plain, exact, tol):
    """The kernel's output is as close to the float64 result as the plain
    float32 version's is (4x margin), or within `tol` of the output scale.
    At p=1 the denominators are sign-indefinite: rows whose denominator
    nearly cancels are ill-conditioned for any float32 summation order."""
    scale = max(1.0, exact.abs().max().item())
    err = (o.double() - exact).abs().max().item()
    err_plain = (plain.double() - exact).abs().max().item()
    assert err <= max(4 * err_plain, tol * scale), (err, err_plain, scale)


@pytest.mark.cuda
# N: one token, below the kernel's chunk L = 128, exactly L, ragged over
# several chunks; G = 1 (whisper-small), 2, 3 and 32
@pytest.mark.parametrize("n", [1, 37, 64, 128, 200, 1000])
@pytest.mark.parametrize("heads", [(12, 12), (4, 2), (6, 2), (32, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 2])
def test_prefill_kernel_matches_plain_on_card(cuda_device, p, dtype, heads,
                                              n):
    gen = torch.Generator(device=cuda_device).manual_seed(p)

    def rn(*s):
        return torch.randn(s, generator=gen, device=cuda_device)

    (hq, hkv), b, d, dv = heads, 2, 64, 64
    q, k = normalize_qk(rn(b, hq, n, d)), normalize_qk(rn(b, hkv, n, d))
    v = rn(b, hkv, n, dv)
    mask = (torch.rand(b, hkv, n, generator=gen, device=cuda_device) > 0.2
            ).float()
    _, init = fastmax_causal_ref(q[:, :, :30], k[:, :, :30], v[:, :, :30],
                                 p=p, chunk_size=32)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    o, st = fastmax_causal_cuda(q, k, v, mask, p=p, init_state=init)
    ro, rst = fastmax_causal_ref(q, k, v, mask, p=p, chunk_size=64,
                                 init_state=init)
    o64, _ = fastmax_causal_ref(q.double(), k.double(), v.double(), mask,
                                p=p, chunk_size=64,
                                init_state=[t.double() for t in init])
    torch.cuda.synchronize()
    _assert_as_close_as_plain(o, ro, o64, 1e-4 if dtype == torch.float32
                              else 3e-2)
    for a, r in zip(st, rst):
        scale = max(1.0, r.abs().max().item())
        torch.testing.assert_close(a / scale, r / scale, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(16))
def test_prefill_kernel_p1_unscaled_is_as_accurate_as_plain_on_card(
        cuda_device, seed):
    """p=1 on unscaled q̂ (|s| up to D), where rows whose denominator
    nearly cancels amplify its rounding: the kernel sums the denominator
    in float64, so on every seed it is as close to float64 as the plain
    float32 version (4x margin) or within 1e-4 of the output scale."""
    gen = torch.Generator(device=cuda_device).manual_seed(seed)

    def rn(*s):
        return torch.randn(s, generator=gen, device=cuda_device)

    b, hq, hkv, n, d = 2, 4, 2, 200, 64
    q, k = normalize_qk(rn(b, hq, n, d)), normalize_qk(rn(b, hkv, n, d))
    v = rn(b, hkv, n, d)
    mask = (torch.rand(b, hkv, n, generator=gen, device=cuda_device)
            > 0.2).float()
    _, init = fastmax_causal_ref(q[:, :, :30], k[:, :, :30], v[:, :, :30],
                                 p=1, chunk_size=32)
    o, _ = fastmax_causal_cuda(q, k, v, mask, p=1, init_state=init)
    ro, _ = fastmax_causal_ref(q, k, v, mask, p=1, chunk_size=64,
                               init_state=init)
    o64, _ = fastmax_causal_ref(q.double(), k.double(), v.double(), mask,
                                p=1, chunk_size=64,
                                init_state=[t.double() for t in init])
    torch.cuda.synchronize()
    _assert_as_close_as_plain(o, ro, o64, 1e-4)


def _qwen3_like(dev, seed, n=300):
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, hq, hkv, d = 2, 16, 8, 128
    q = normalize_qk(torch.randn(b, hq, n, d, generator=gen, device=dev))
    k = normalize_qk(torch.randn(b, hkv, n, d, generator=gen, device=dev))
    v = torch.randn(b, hkv, n, d, generator=gen, device=dev)
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


@pytest.mark.cuda
def test_prefill_kernel_is_deterministic_on_card(cuda_device):
    """Two calls on the same inputs give the same bits, o and state: every
    sum runs in a fixed order (no float atomics)."""
    q, k, v = _qwen3_like(cuda_device, 7)
    o1, s1 = fastmax_causal_cuda(q, k, v, p=2)
    o2, s2 = fastmax_causal_cuda(q, k, v, p=2)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_prefill_kernel_in_segments_on_card(cuda_device, monkeypatch):
    """With a workspace budget of one slot the call runs its two launches
    over segments of one chunk (N = 300: three), each seeded with the last
    one's carry (m in float32, the g column in float64): o and state as
    in one segment, up to rounding, and as the plain version's."""
    import repro_torch.kernels.fastmax_causal as fc

    q, k, v = (t.float() for t in _qwen3_like(cuda_device, 9))
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    mask = (torch.rand(k.shape[:3], generator=gen, device=cuda_device)
            > 0.2).float()
    _, init = fastmax_causal_ref(q[:, :, :40], k[:, :, :40], v[:, :, :40],
                                 p=2, chunk_size=64)
    whole = fc.prefill_call(q, k, v, mask, p=2, init_state=init)
    o1, st1 = whole.run()
    monkeypatch.setattr(fc, "_WORKSPACE_BUDGET", 1)
    call = fc.prefill_call(q, k, v, mask, p=2, init_state=init)
    assert call.segments == [(0, 128), (128, 128), (256, 44)]
    assert call.workspace_bytes < whole.workspace_bytes
    o, st = call.run()
    ro, rst = fastmax_causal_ref(q, k, v, mask, p=2, chunk_size=64,
                                 init_state=init)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, o1, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(o, ro, rtol=0, atol=1e-4)
    for a, a1, r in zip(st, st1, rst):
        scale = max(1.0, r.abs().max().item())
        torch.testing.assert_close(a / scale, a1 / scale, rtol=0, atol=1e-6)
        torch.testing.assert_close(a / scale, r / scale, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_prefill_long_prompt_workspace_is_bounded_on_card(cuda_device):
    """A 16k-token prompt at qwen3's widths (B=1, Hq=16, Hkv=8): its slots
    in one segment would take 4.5 GB; in segments the call's peak memory
    stays within the workspace budget plus its inputs' weights and its
    outputs, and o and the state agree with the plain version."""
    import repro_torch.kernels.fastmax_causal as fc

    gen = torch.Generator(device=cuda_device).manual_seed(16)
    b, hq, hkv, n, d = 1, 16, 8, 16384, 128
    q = normalize_qk(torch.randn(b, hq, n, d, generator=gen,
                                 device=cuda_device)).bfloat16()
    k = normalize_qk(torch.randn(b, hkv, n, d, generator=gen,
                                 device=cuda_device)).bfloat16()
    v = torch.randn(b, hkv, n, d, generator=gen,
                    device=cuda_device).bfloat16()
    seg = fc.segment_tokens(b * hkv, d, d, 2)
    assert seg < n
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    o, st = fastmax_causal_cuda(q, k, v, p=2)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    kept = o.numel() * o.element_size() + sum(t.numel() * 4 for t in st)
    weights = b * hkv * n * 4   # the float32 key weights (ones)
    assert peak <= fc._WORKSPACE_BUDGET + 8 * b * hkv * 8385 + kept \
        + weights, peak
    ro, rst = fastmax_causal_ref(q, k, v, p=2, chunk_size=512)
    torch.cuda.synchronize()
    scale = max(1.0, ro.float().abs().max().item())
    assert (o.float() - ro.float()).abs().max().item() <= 3e-2 * scale
    for a, r in zip(st, rst):
        scale = max(1.0, r.abs().max().item())
        torch.testing.assert_close(a / scale, r / scale, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_prefill_workspace_is_released_on_card(cuda_device):
    """The call's prefix-moment workspace is allocated per call and freed
    on return: only o and the state stay allocated."""
    q, k, v = _qwen3_like(cuda_device, 8)
    b, hkv, n, d = k.shape
    ws = workspace_bytes(b * hkv, n, d, d, 2)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    o, st = fastmax_causal_cuda(q, k, v, p=2)
    torch.cuda.synchronize()
    kept = o.numel() * o.element_size() + sum(t.numel() * 4 for t in st)
    assert torch.cuda.max_memory_allocated() - before >= ws + kept
    assert kept <= torch.cuda.memory_allocated() - before < kept + ws // 2
    del o, st
    assert torch.cuda.memory_allocated() == before


@pytest.mark.cuda
def test_resumed_prefill_launches_the_kernel_on_card(cuda_device):
    """On the kernel backend a prompt prefilled in two pieces (the second
    with `offset`) launches the prefill kernel for each piece, seeded with
    the carried moments, and ends in the whole prompt's state."""
    from repro_torch.attention import AttentionSpec
    from repro_torch.attention import state as TS
    from repro_torch.kernels import ops

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    b, hq, hkv, n, d, cut = 2, 8, 4, 300, 64, 130
    q = torch.randn(b, hq, n, d, generator=gen, device=cuda_device)
    k = torch.randn(b, hkv, n, d, generator=gen, device=cuda_device)
    v = torch.randn(b, hkv, n, d, generator=gen, device=cuda_device)
    spec = AttentionSpec.parse("fastmax2-kernel", chunk_size=64)
    kw = dict(batch=b, n_kv_heads=hkv, q_head_dim=d, v_head_dim=d,
              max_len=n, device=cuda_device)
    whole, parts = TS.init_state(spec, **kw), TS.init_state(spec, **kw)
    ops.reset_launch_counts()
    wo, _ = TS.prefill(q, k, v, spec, state=whole)
    o1, _ = TS.prefill(q[:, :, :cut], k[:, :, :cut], v[:, :, :cut], spec,
                       state=parts)
    o2, _ = TS.prefill(q[:, :, cut:], k[:, :, cut:], v[:, :, cut:], spec,
                       state=parts, offset=cut)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fastmax_causal"] == 3
    torch.testing.assert_close(torch.cat([o1, o2], dim=2), wo, rtol=0,
                               atol=1e-4)
    for a, w in zip(parts.moments, whole.moments):
        scale = max(1.0, w.abs().max().item())
        torch.testing.assert_close(a / scale, w / scale, rtol=0, atol=1e-5)


@pytest.mark.cuda
# G = 1 (whisper-small), 4 and 16
@pytest.mark.parametrize("heads", [(12, 12), (8, 2), (16, 1)])
@pytest.mark.parametrize("p", [1, 2])
def test_decode_kernel_matches_plain_on_card(cuda_device, p, heads):
    gen = torch.Generator(device=cuda_device).manual_seed(10 + p)

    def rn(*s):
        return torch.randn(s, generator=gen, device=cuda_device)

    (hq, hkv), b, d, dv = heads, 2, 64, 64
    _, st = fastmax_causal_ref(normalize_qk(rn(b, hq, 40, d)),
                               normalize_qk(rn(b, hkv, 40, d)),
                               rn(b, hkv, 40, dv), p=p, chunk_size=16)
    ref_state = tuple(x.clone() for x in st)
    state64 = tuple(x.double() for x in st)
    for _ in range(16):
        q, k, v = normalize_qk(rn(b, hq, 1, d)), normalize_qk(
            rn(b, hkv, 1, d)), rn(b, hkv, 1, dv)
        o = fastmax_decode_cuda(q, k, v, st, p=p)
        ro, ref_state = fastmax_decode_ref(q, k, v, ref_state, p=p)
        o64, state64 = fastmax_decode_ref(q.double(), k.double(), v.double(),
                                          state64, p=p)
        _assert_as_close_as_plain(o, ro, o64, 1e-4)
    torch.cuda.synchronize()
    for a, r in zip(st, ref_state):
        scale = max(1.0, r.abs().max().item())
        torch.testing.assert_close(a / scale, r / scale, rtol=0, atol=1e-5)


def _bwd_inputs(dev, gen, b, hq, hkv, n, d, dv, p, seeded, dtype):
    """Backward inputs in `dtype` and the forward's final carry on them.
    At p=1, f(s) = 1 + s is sign-indefinite at the model's scale (|s| up to
    D), so row denominators can nearly cancel and which float32 summation
    order lands closer to float64 is luck (two chunkings of the plain
    version differ by 100x there); q̂/D keeps |s| <= 1 and f >= 0."""
    def rn(*s):
        return torch.randn(s, generator=gen, device=dev)

    qs = 1.0 / d if p == 1 else 1.0
    q, k = normalize_qk(rn(b, hq, n, d)) * qs, normalize_qk(rn(b, hkv, n, d))
    v, do = rn(b, hkv, n, dv), rn(b, hq, n, dv)
    init = None
    if seeded:
        _, init = fastmax_causal_ref(normalize_qk(rn(b, hq, 40, d)) * qs,
                                     normalize_qk(rn(b, hkv, 40, d)),
                                     rn(b, hkv, 40, dv), p=p, chunk_size=16)
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    _, st = fastmax_causal_ref(q, k, v, p=p, chunk_size=64, init_state=init)
    return q, k, v, do, st


def _assert_bwd_close(a, plain, exact, first):
    """One backward output against its plain version, by rows (axis -2).
    Rows from `first` on: float32 within 1e-4 x max(1, max|plain|);
    bfloat16 per element within one bf16 rounding over that, 2^-7 |plain|
    + 1e-4 x max(1, max|plain|) (both accumulate in float32 and round
    once). Rows before `first`, the first chunk of an unseeded forward: the
    §2.5 backward rebuilds the carry before chunk 0 by subtraction, which
    leaves float32 rounding where the exact carry is zero, in any
    implementation; there the kernel is as close to float64 as the plain
    version is (4x margin), or within 1e-4 of the scale."""
    tail = plain[..., first:, :].float()
    lim = 1e-4 * max(1.0, tail.abs().max().item())
    if a.dtype == torch.bfloat16:
        lim = lim + tail.abs() * 2.0 ** -7
    diff = (a[..., first:, :].float() - tail).abs()
    assert bool((diff <= lim).all()), (diff.max().item(), first)
    if first:
        _assert_as_close_as_plain(a[..., :first, :], plain[..., :first, :],
                                  exact[..., :first, :], 1e-4)


def _check_bwd_on_card(dev, seed, heads, n, p, dtype, seeded, d=64, b=2):
    from repro_torch.kernels.fastmax_causal import CHUNK
    from repro_torch.kernels.fastmax_causal_bwd import (
        fastmax_causal_bwd_cuda, fastmax_causal_bwd_ref)

    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do, st = _bwd_inputs(dev, gen, b, *heads, n, d, d, p, seeded,
                                  dtype)
    c = CHUNK   # the kernel's chunk at any G and D
    before = [x.clone() for x in st]
    got = fastmax_causal_bwd_cuda(q, k, v, st, do, p=p,
                                  return_dstate=seeded)
    plain = fastmax_causal_bwd_ref(q, k, v, st, do, p=p, chunk_size=c,
                                   return_dstate=seeded)
    exact = fastmax_causal_bwd_ref(
        q.double(), k.double(), v.double(), [x.double() for x in st],
        do.double(), p=p, chunk_size=c, return_dstate=seeded)
    torch.cuda.synchronize()
    # a seeded forward's carry before chunk 0 is the seed: all rows tight
    first = 0 if seeded else c
    for a, r, e in zip(got[:3], plain[:3], exact[:3]):
        assert a.dtype == dtype
        _assert_bwd_close(a, r, e, first)
    if seeded:
        for a, r in zip(got[3], plain[3]):    # dstate: float32
            scale = max(1.0, r.abs().max().item())
            assert (a - r).abs().max().item() <= 1e-4 * scale
    for a, b in zip(st, before):       # the residual is never written
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n, seeded", [(256, False), (1000, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 2])
def test_bwd_kernel_matches_plain_on_card(cuda_device, p, dtype, n, seeded):
    """dq, dk, dv against the plain §2.5 scan over many chunks; ragged N on
    a forward seeded from an init_state, with the six dstate moments."""
    _check_bwd_on_card(cuda_device, 20 + p, (4, 2), n, p, dtype, seeded)


@pytest.mark.cuda
def test_bwd_kernel_odd_group_on_card(cuda_device):
    """G = 5: 640 query rows in each chunk of L = 128, ten blocks of 64."""
    _check_bwd_on_card(cuda_device, 7, (10, 2), 300, 2, torch.float32, True)


@pytest.mark.cuda
def test_bwd_kernel_granite_group_on_card(cuda_device):
    """G = 48 on one kv head at D = 128 (granite's grouping): 6144 query
    rows a chunk, any G."""
    _check_bwd_on_card(cuda_device, 9, (48, 1), 300, 2, torch.float32,
                       False, d=128, b=1)


@pytest.mark.cuda
def test_bwd_kernel_over_segments_on_card(cuda_device, monkeypatch):
    """A workspace budget below one slot: segments of one chunk, run last
    to first, each seeded with the carry and cotangent of the one after it
    (N = 300: three segments, the last ragged), with dstate."""
    import repro_torch.kernels.fastmax_causal as fc
    from repro_torch.kernels.fastmax_causal_bwd import bwd_call

    monkeypatch.setattr(fc, "_WORKSPACE_BUDGET", 1)
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    q, k, v, do, st = _bwd_inputs(cuda_device, gen, 2, 4, 2, 300, 64, 64, 2,
                                  True, torch.float32)
    assert len(bwd_call(q, k, v, st, do, p=2).segments) == 3
    _check_bwd_on_card(cuda_device, 10, (4, 2), 300, 2, torch.float32, True)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2])
def test_bwd_kernel_repeats_bit_for_bit_on_card(cuda_device, p):
    """Every sum runs in a fixed order: two calls give the same bits."""
    from repro_torch.kernels.fastmax_causal_bwd import fastmax_causal_bwd_cuda

    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v, do, st = _bwd_inputs(cuda_device, gen, 2, 4, 2, 300, 64, 64, p,
                                  True, torch.bfloat16)
    a = fastmax_causal_bwd_cuda(q, k, v, st, do, p=p, return_dstate=True)
    b = fastmax_causal_bwd_cuda(q, k, v, st, do, p=p, return_dstate=True)
    for x, y in zip(list(a[:3]) + list(a[3]), list(b[:3]) + list(b[3])):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 96])
def test_bwd_kernel_other_head_dims_on_card(cuda_device, d):
    """One Dv column block (D = 32: the kernel's g2 workspace must still be
    a copy, not the residual) and three (D = 96)."""
    _check_bwd_on_card(cuda_device, 8, (4, 2), 200, 2, torch.float32, True,
                       d=d)


@pytest.mark.cuda
def test_trainable_op_backward_twice_on_card(cuda_device):
    """Two backward calls through the kernels (retain_graph) give equal
    grads: the saved carry is left intact."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v, do, _ = _bwd_inputs(cuda_device, gen, 1, 8, 4, 300, 64, 64, 2,
                                 False, torch.float32)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    ops.reset_launch_counts()
    o = ops.fastmax(q, k, v, p=2)
    g1 = torch.autograd.grad(o, (q, k, v), do, retain_graph=True)
    g2 = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fastmax_causal_bwd"] == 2
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_train_step_launches_the_bwd_kernel_per_layer(cuda_device):
    import dataclasses

    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step, pick_optimizer
    from repro_torch.models import init_model

    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              attn=AttentionSpec.parse("fastmax2-kernel"))
    params = init_model(cfg, seed=0, device=cuda_device)
    _, opt = pick_optimizer(cfg, 1, lr=1e-3, total_steps=10)
    state = opt[0](params)
    step = make_train_step(cfg, opt)
    batch = SyntheticLM(cfg.vocab_size, 100, seed=0).batch(0, 2)
    ops.reset_launch_counts()
    params, state, m = step(params, state, batch)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"fastmax_causal": 2 * cfg.n_layers,
                                   "fastmax_causal_bwd": cfg.n_layers,
                                   "fastmax_decode": 0,
                                   "fastmax_noncausal_moments": 0,
                                   "fastmax_noncausal_combine": 0,
                                   "hybrid_causal": 0}
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["gnorm"])


@pytest.mark.cuda
def test_train_main_runs_smoke_steps_on_card(cuda_device):
    from repro_torch.launch import train

    _, losses = train.main(["--device", "cuda", "--smoke", "--attn",
                            "fastmax2-kernel", "--steps", "4", "--batch",
                            "2", "--seq", "64", "--log-every", "1"])
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)


def _check_noncausal_on_card(dev, seed, d, n, m, dtype, p=2, heads=(4, 2),
                             dv=None):
    """The noncausal kernel's two launches against their plain versions:
    the six moments within 1e-5 of their scale (float32 both ways, only
    the summation order differs), and o as close to float64 as the plain
    version is (float32; 4x margin or 1e-4 of the scale) or within one
    bf16 rounding of the plain o plus 2e-5 (bf16: both round once). At p=1
    the queries are q̂/D (|s| <= 1, f >= 0; see `_bwd_inputs`)."""
    from repro_torch.kernels.fastmax_noncausal import (
        noncausal_combine_cuda, noncausal_combine_ref, noncausal_moments_cuda,
        noncausal_moments_ref)

    gen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*s):
        return torch.randn(s, generator=gen, device=dev)

    (hq, hkv), b = heads, 2
    dv = d if dv is None else dv
    qs = 1.0 / d if p == 1 else 1.0
    q = (normalize_qk(rn(b, hq, n, d)) * qs).to(dtype)
    k = normalize_qk(rn(b, hkv, m, d)).to(dtype)
    v = rn(b, hkv, m, dv).to(dtype)
    mom = noncausal_moments_cuda(k, v, p=p)
    rmom = noncausal_moments_ref(k, v, p=p)
    o = noncausal_combine_cuda(q, mom, p=p)
    ro = noncausal_combine_ref(q, rmom, p=p)
    o64 = noncausal_combine_ref(q.double(), noncausal_moments_ref(
        k.double(), v.double(), p=p), p=p)
    torch.cuda.synchronize()
    for a, r in zip(mom, rmom):
        scale = max(1.0, r.abs().max().item())
        torch.testing.assert_close(a / scale, r / scale, rtol=0, atol=1e-5)
    assert o.dtype == dtype and o.shape == (b, hq, n, dv)
    if dtype == torch.float32:
        _assert_as_close_as_plain(o, ro, o64, 1e-4)
    else:
        diff = (o.float() - ro.float()).abs()
        assert bool((diff <= ro.float().abs() * 2.0 ** -7 + 2e-5).all()), \
            diff.max().item()
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 200])      # split and row combines
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_noncausal_kernel_matches_plain_on_card(cuda_device, d, dtype, n):
    # M = 333: the last key chunk of the moment kernel is ragged
    _check_noncausal_on_card(cuda_device, d + n, d, n, 333, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(4, 2), (12, 12), (32, 2)])
def test_noncausal_kernel_p1_and_groups_on_card(cuda_device, heads):
    """p=1 on q̂/D, and groups G = 2, 1, 16 (G*N = 16 is the split
    combine's widest case at N = 1)."""
    _check_noncausal_on_card(cuda_device, 7, 64, 1, 300, torch.float32, p=1,
                             heads=heads)
    _check_noncausal_on_card(cuda_device, 8, 64, 1, 300, torch.float32,
                             heads=heads)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 200])
def test_noncausal_kernel_is_deterministic_on_card(cuda_device, n):
    """Partials are summed in a fixed order: a repeated call gives the
    same bits."""
    from repro_torch.kernels.fastmax_noncausal import fastmax_noncausal_cuda

    q, k, v = _check_noncausal_on_card(cuda_device, 11, 64, n, 1500,
                                       torch.bfloat16, heads=(12, 12))
    a = fastmax_noncausal_cuda(q, k, v, p=2)
    b = fastmax_noncausal_cuda(q, k, v, p=2)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 7, 33, 1501])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noncausal_kernel_ragged_keys_on_card(cuda_device, dtype, m):
    """Key counts around the moment launch's stages of 32 (the last one
    zero-filled), at G*N = 17, the row combine's smallest input."""
    _check_noncausal_on_card(cuda_device, 50 + m, 64, 17, m, dtype,
                             heads=(2, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dv", [12, 20, 36])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noncausal_kernel_ragged_values_on_card(cuda_device, dtype, dv):
    """Value widths that are not a multiple of the tensor cores' n8 tile,
    at D = 64 and D = 128."""
    _check_noncausal_on_card(cuda_device, 60 + dv, 64, 200, 300, dtype, dv=dv)
    _check_noncausal_on_card(cuda_device, 70 + dv, 128, 100, 333, dtype,
                             dv=dv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noncausal_tensor_core_launches_repeat_bit_for_bit(cuda_device,
                                                           dtype):
    """The moment launch and the row combine (G*N > 16), called twice on
    the same inputs, give the same bits (no atomics; fixed sums)."""
    from repro_torch.kernels.fastmax_noncausal import (
        noncausal_combine_cuda, noncausal_moments_cuda)

    for d, dv, n, m in ((64, 64, 1500, 1500), (128, 36, 17, 333)):
        q, k, v = _check_noncausal_on_card(cuda_device, 80 + d, d, n, m,
                                           dtype, heads=(2, 2), dv=dv)
        mom = noncausal_moments_cuda(k, v, p=2)
        again = noncausal_moments_cuda(k, v, p=2)
        o = noncausal_combine_cuda(q, mom, p=2)
        o2 = noncausal_combine_cuda(q, again, p=2)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(mom, again))
        assert torch.equal(o, o2)


@pytest.mark.cuda
def test_noncausal_trainable_op_on_card(cuda_device):
    """`ops.fastmax(causal=False)`: the kernel forward, and grads from
    autograd of the plain moment path, against autograd of the plain
    path on the same tensors."""
    from repro_torch.core.fastmax import fastmax_noncausal
    from repro_torch.kernels import ops

    gen = torch.Generator(device=cuda_device).manual_seed(21)
    q = normalize_qk(torch.randn(2, 4, 50, 64, generator=gen,
                                 device=cuda_device)).requires_grad_(True)
    k = normalize_qk(torch.randn(2, 2, 90, 64, generator=gen,
                                 device=cuda_device)).requires_grad_(True)
    v = torch.randn(2, 2, 90, 64, generator=gen, device=cuda_device,
                    requires_grad=True)
    do = torch.randn(2, 4, 50, 64, generator=gen, device=cuda_device)
    ops.reset_launch_counts()
    o = ops.fastmax(q, k, v, p=2, causal=False, chunk_size=64)
    got = torch.autograd.grad(o, (q, k, v), do)
    counts = ops.launch_counts()
    assert (counts["fastmax_noncausal_moments"],
            counts["fastmax_noncausal_combine"]) == (1, 1)
    ro = fastmax_noncausal(q, k, v, p=2, chunk_size=512)
    want = torch.autograd.grad(ro, (q, k, v), do)
    torch.testing.assert_close(o, ro, rtol=0, atol=1e-4)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_whisper_smoke_kernel_path_on_card(cuda_device):
    """The whisper smoke config in float32: the kernel and plain paths give
    the same greedy tokens, and a generate() call launches exactly the
    kernels the path runs."""
    import dataclasses

    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_model
    from repro_torch.models.encdec import encode

    cfg = dataclasses.replace(get_smoke_config("whisper-small"),
                              attn=AttentionSpec.parse("fastmax2-kernel"))
    plain = dataclasses.replace(cfg,
                                attn=AttentionSpec.parse("fastmax2-chunked"))
    params = init_model(cfg, seed=0, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    frames = torch.randn(2, cfg.encoder_seq, cfg.d_model, generator=gen,
                         device=cuda_device)
    prompts = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen,
                            device=cuda_device)
    n_gen, L = 6, cfg.n_layers
    with torch.inference_mode():
        ops.reset_launch_counts()
        enc = encode(params, frames, cfg)
        assert ops.launch_counts()["fastmax_noncausal_moments"] == \
            cfg.encoder_layers
        enc_p = encode(params, frames, plain)
    torch.testing.assert_close(enc, enc_p, rtol=0, atol=1e-4)
    ops.reset_launch_counts()
    tk = generate(params, cfg, prompts, n_gen, enc_out=enc,
                  device=cuda_device)
    counts = ops.launch_counts()
    tp = generate(params, plain, prompts, n_gen, enc_out=enc,
                  device=cuda_device)
    assert torch.equal(tk, tp)
    assert counts == {"fastmax_causal": L, "fastmax_causal_bwd": 0,
                      "fastmax_decode": L * (n_gen - 1),
                      "fastmax_noncausal_moments": L * n_gen,
                      "fastmax_noncausal_combine": L * n_gen,
                      "hybrid_causal": 0}


def _hybrid_inputs(dev, seed, heads, n, d, dtype, p=2, cut=0):
    """Normalized q̂ (q̂/D at p=1, see `_bwd_inputs`), k̂, v on the card,
    and with `cut` a kv_mask [B, Hkv, N] taking the last `cut` keys of the
    second sequence off (trailing padding)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*s):
        return torch.randn(s, generator=gen, device=dev)

    (hq, hkv), b = heads, 2
    qs = 1.0 / d if p == 1 else 1.0
    q = (normalize_qk(rn(b, hq, n, d)) * qs).to(dtype)
    k = normalize_qk(rn(b, hkv, n, d)).to(dtype)
    v = rn(b, hkv, n, d).to(dtype)
    mask = None
    if cut:
        mask = torch.ones(b, hkv, n, device=dev)
        mask[1, :, n - cut:] = 0.0
    return q, k, v, mask


def _assert_hybrid_close(o, plain):
    """The hybrid kernel's o against its plain version: within 1e-4 of the
    scale (float32), or one bf16 rounding plus 2e-5 (bfloat16: both round
    once from float32)."""
    diff = (o.float() - plain.float()).abs()
    if o.dtype == torch.float32:
        scale = max(1.0, plain.abs().max().item())
        assert diff.max().item() <= 1e-4 * scale, diff.max().item()
    else:
        lim = plain.float().abs() * 2.0 ** -7 + 2e-5
        assert bool((diff <= lim).all()), diff.max().item()


@pytest.mark.cuda
# (heads, D, N, window, chunk_size): qwen3's group (G=2) with the band of
# 64 below the kernel's chunk L = 128, and of 200 above it (the first two
# chunks take no slot); G=1 with a band of 5; G=4 with a band of 100 and a
# ragged last chunk
@pytest.mark.parametrize("case", [((4, 2), 64, 300, 64, 512),
                                  ((4, 2), 64, 300, 200, 256),
                                  ((3, 3), 32, 150, 5, 16),
                                  ((8, 2), 32, 201, 100, 128)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 2])
def test_hybrid_kernel_matches_plain_on_card(cuda_device, p, dtype, case):
    """o (`_assert_hybrid_close`) and the emitted carry against the plain
    version, with trailing padding: every moment within 1e-5 of its scale
    (float32 both ways, only the summation order differs)."""
    from repro_torch.kernels.hybrid_causal import (hybrid_causal_cuda,
                                                   hybrid_causal_ref)

    heads, d, n, window, cs = case
    q, k, v, mask = _hybrid_inputs(cuda_device, n + window + p, heads, n, d,
                                   dtype, p=p, cut=n // 5)
    kw = dict(p=p, window=window, chunk_size=cs, return_state=True)
    o, st = hybrid_causal_cuda(q, k, v, mask, **kw)
    ro, rst = hybrid_causal_ref(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    _assert_hybrid_close(o, ro)
    for a, r in zip(st, rst):
        scale = max(1.0, r.abs().max().item())
        torch.testing.assert_close(a / scale, r / scale, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_hybrid_kernel_in_segments_on_card(cuda_device, monkeypatch):
    """With a workspace budget of one slot the hybrid call runs its two
    launches over segments of one chunk (N = 300: three); the band's keys
    before a segment's first chunk are read from the one before. o and
    state as in one segment, up to rounding, and as the plain version's. A
    band longer than the first segment raises."""
    import repro_torch.kernels.fastmax_causal as fc
    from repro_torch.kernels.hybrid_causal import (hybrid_causal_cuda,
                                                   hybrid_causal_ref)

    q, k, v = (t.float() for t in _qwen3_like(cuda_device, 19))
    mask = torch.ones(k.shape[:3], device=cuda_device)
    mask[1, :, -40:] = 0.0
    kw = dict(p=2, window=100, chunk_size=128, return_state=True)
    o1, st1 = hybrid_causal_cuda(q, k, v, mask, **kw)
    monkeypatch.setattr(fc, "_WORKSPACE_BUDGET", 1)
    assert fc.prefill_call(q, k, v, mask, p=2, band=100).segments == [
        (0, 128), (128, 128), (256, 44)]
    o, st = hybrid_causal_cuda(q, k, v, mask, **kw)
    ro, rst = hybrid_causal_ref(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, o1, rtol=1e-6, atol=1e-6)
    _assert_hybrid_close(o, ro)
    for a, a1, r in zip(st, st1, rst):
        scale = max(1.0, r.abs().max().item())
        torch.testing.assert_close(a / scale, a1 / scale, rtol=0, atol=1e-6)
        torch.testing.assert_close(a / scale, r / scale, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="first segment"):
        hybrid_causal_cuda(q, k, v, mask, p=2, window=200, chunk_size=256)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hybrid_kernel_band_past_two_chunks_on_card(cuda_device, dtype):
    """w_eff = 300 > 2L at qwen3's widths: the first three chunks take no
    slot, and their rows past L (band-only rows i < 300, and rows whose
    band starts after token 0) are summed pair by pair from token 0. o
    against the plain version, and in float32 as close to float64 as the
    plain version (4x margin) or within 1e-4; the carry as the prefill's
    checks."""
    from repro_torch.kernels.hybrid_causal import (hybrid_causal_cuda,
                                                   hybrid_causal_ref)

    q, k, v = (t.to(dtype) for t in _qwen3_like(cuda_device, 23, n=700))
    kw = dict(p=2, window=300, chunk_size=512, return_state=True)
    o, st = hybrid_causal_cuda(q, k, v, **kw)
    ro, rst = hybrid_causal_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_hybrid_close(o, ro)
    if dtype == torch.float32:
        o64, _ = hybrid_causal_ref(q.double(), k.double(), v.double(), **kw)
        _assert_as_close_as_plain(o, ro, o64, 1e-4)
    for a, r in zip(st, rst):
        scale = max(1.0, r.abs().max().item())
        torch.testing.assert_close(a / scale, r / scale, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2])
def test_hybrid_kernel_repeats_bit_for_bit_on_card(cuda_device, p):
    """Two hybrid calls on the same inputs give the same bits, o and
    state: the band's sums, like the prefill's, run in a fixed order."""
    from repro_torch.kernels.hybrid_causal import hybrid_causal_cuda

    q, k, v = _qwen3_like(cuda_device, 29)
    if p == 1:
        q = q / q.shape[-1]
    kw = dict(p=p, window=64, chunk_size=512, return_state=True)
    o1, s1 = hybrid_causal_cuda(q, k, v, **kw)
    o2, s2 = hybrid_causal_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_hybrid_op_routes_through_the_hybrid_kernel_on_card(cuda_device):
    """One `ops.hybrid` forward launches the hybrid kernel once and no
    fastmax kernel, and its plain backward launches none; its o and grads
    agree with the chunked hybrid backend's on the same tensors. A band of
    0 runs the fastmax pair only."""
    from repro_torch.core.hybrid import hybrid_causal_chunked
    from repro_torch.kernels import ops

    q, k, v, _ = _hybrid_inputs(cuda_device, 31, (4, 2), 200, 64,
                                torch.float32)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    do = torch.randn_like(q)
    ops.reset_launch_counts()
    o = ops.hybrid(q, k, v, window=64, chunk_size=128)
    got = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["hybrid_causal"] == 1
    assert sum(counts.values()) == 1
    ro = hybrid_causal_chunked(q, k, v, window=64, chunk_size=128)
    want = torch.autograd.grad(ro, (q, k, v), do)
    _assert_hybrid_close(o.detach(), ro.detach())
    # the same plain backward on both sides, seeded by carries that differ
    # by the kernel's rounding
    for a, b in zip(got, want):
        scale = max(1.0, b.abs().max().item())
        torch.testing.assert_close(a / scale, b / scale, rtol=0, atol=1e-4)

    ops.reset_launch_counts()
    o0 = ops.hybrid(q, k, v, window=0, chunk_size=128)
    torch.autograd.grad(o0, (q, k, v), do)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["hybrid_causal"] == 0
    assert (counts["fastmax_causal"], counts["fastmax_causal_bwd"]) == (1, 1)


@pytest.mark.cuda
def test_hybrid_generate_on_card_matches_cpu(cuda_device):
    """The float32 hybrid smoke model's greedy tokens on the card equal
    the CPU's from the same weights; hybrid serving launches the hybrid
    kernel once per layer (the prefill) and no other kernel (the
    reference decodes hybrid through its plain two-leg state)."""
    import dataclasses

    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_model

    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              attn=AttentionSpec.parse("hybrid2-kernel"))
    cpu = init_model(cfg, seed=0, device="cpu")

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(cuda_device)

    prompts = torch.randint(0, cfg.vocab_size, (2, 40),
                            generator=torch.Generator().manual_seed(6))
    want = generate(cpu, cfg, prompts, 6, device="cpu")
    ops.reset_launch_counts()
    got = generate(to_card(cpu), cfg, prompts.to(cuda_device), 6,
                   device=cuda_device)
    counts = ops.launch_counts()
    assert counts.pop("hybrid_causal") == cfg.n_layers
    assert not any(counts.values())
    assert torch.equal(got.cpu(), want)
