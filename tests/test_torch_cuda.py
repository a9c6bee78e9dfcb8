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
                                                fastmax_causal_ref)
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
# G = 1 (whisper-small), 2 and 32
@pytest.mark.parametrize("heads", [(12, 12), (4, 2), (32, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1, 2])
def test_prefill_kernel_matches_plain_on_card(cuda_device, p, dtype, heads):
    gen = torch.Generator(device=cuda_device).manual_seed(p)

    def rn(*s):
        return torch.randn(s, generator=gen, device=cuda_device)

    (hq, hkv), b, n, d, dv = heads, 2, 200, 64, 64
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


def _check_bwd_on_card(dev, seed, heads, n, p, dtype, seeded, d=64):
    from repro_torch.kernels.fastmax_causal_bwd import (
        fastmax_causal_bwd_cuda, fastmax_causal_bwd_ref, kernel_chunk)

    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do, st = _bwd_inputs(dev, gen, 2, *heads, n, d, d, p, seeded,
                                  dtype)
    c = kernel_chunk(heads[0] // heads[1], d)
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
    """G = 5: the forward's chunk 128 // 5 = 25 is odd; the backward rounds
    its own chunk down to an even one (any chunking is exact)."""
    _check_bwd_on_card(cuda_device, 7, (10, 2), 300, 2, torch.float32, True)


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
                                   "fastmax_noncausal_combine": 0}
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["gnorm"])


@pytest.mark.cuda
def test_train_main_runs_smoke_steps_on_card(cuda_device):
    from repro_torch.launch import train

    _, losses = train.main(["--device", "cuda", "--smoke", "--attn",
                            "fastmax2-kernel", "--steps", "4", "--batch",
                            "2", "--seq", "64", "--log-every", "1"])
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)


def _check_noncausal_on_card(dev, seed, d, n, m, dtype, p=2, heads=(4, 2)):
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
    qs = 1.0 / d if p == 1 else 1.0
    q = (normalize_qk(rn(b, hq, n, d)) * qs).to(dtype)
    k = normalize_qk(rn(b, hkv, m, d)).to(dtype)
    v = rn(b, hkv, m, d).to(dtype)
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
    assert o.dtype == dtype and o.shape == (b, hq, n, d)
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
                      "fastmax_noncausal_combine": L * n_gen}
