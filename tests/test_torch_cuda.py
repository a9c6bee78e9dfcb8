"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without a card; the decision is
taken inside the `cuda_device` fixture, never while the module imports.
This file imports no JAX, so it runs on the machine with the card:
  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
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
@pytest.mark.parametrize("heads", [(4, 2), (32, 1)])   # G = 2 and G = 32
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
@pytest.mark.parametrize("heads", [(8, 2), (16, 1)])   # G = 4 and G = 16
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
