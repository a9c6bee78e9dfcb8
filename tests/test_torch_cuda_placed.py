"""The hybrid kernel on a feature plan's shards, on the card.

A placed hybrid-kernel prefill in feature mode (kv heads that do not
divide "model", as granite-20b's one) runs the hybrid kernel on q and k
whole and the rank's Dv slice of v, and keeps the final moments in the
rank's block (`attention/state.py`). Every test here is marked `cuda` and
skips without a card; the decision is taken inside the `cuda_device`
fixture, never while the module imports. This file imports no JAX, so it
runs on the machine with the card:
  PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
      tests/test_torch_cuda_placed.py
"""
import pytest
import torch

from repro_torch.core.ref import normalize_qk
from torch_threads import share_cores  # noqa: F401,E402


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never while the module imports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m cuda "
                    "--noconftest tests/test_torch_cuda_placed.py` on the "
                    "machine with the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
# (Hq, Hkv): granite-20b's 48 query heads on one kv head, and a G = 2
# group; D = Dv = 128 split over "model" 2, rank 1's columns 64-127
@pytest.mark.parametrize("heads", [(48, 1), (4, 2)], ids=str)
def test_hybrid_kernel_on_a_feature_slice_with_its_state_on_card(
        cuda_device, heads):
    """`ops.hybrid_prefill_kernel` on v's Dv slice launches the hybrid
    kernel once and returns o's slice and the rank's block of the final
    moments: m0, m1, m2 the slice's columns, g0, g1, g2 whole. Each is
    held to the plain version on the same slice (o within 1e-4 of its
    scale, every moment within 1e-5 of its scale, as
    `tests/test_torch_cuda.py` holds the hybrid kernel) and to the kernel's
    call on the whole Dv: the same columns of o and the m-moments, the
    same g-moments."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.hybrid_causal import hybrid_causal_ref

    (hq, hkv), b, n, d, dv = heads, 2, 300, 128, 128
    gen = torch.Generator(device=cuda_device).manual_seed(35)

    def rn(*s):
        return torch.randn(s, generator=gen, device=cuda_device)

    q, k = normalize_qk(rn(b, hq, n, d)), normalize_qk(rn(b, hkv, n, d))
    v = rn(b, hkv, n, dv)
    mask = torch.ones(b, hkv, n, device=cuda_device)
    mask[0, :, :37] = 0.0
    cols = slice(dv // 2, dv)
    vs = v[..., cols].contiguous()
    kw = dict(p=2, window=64, chunk_size=512, kv_mask=mask)
    ops.reset_launch_counts()
    o, st = ops.hybrid_prefill_kernel(q, k, vs, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["hybrid_causal"] == 1
    ow, stw = ops.hybrid_prefill_kernel(q, k, v, **kw)
    ro, rst = hybrid_causal_ref(q, k, vs, mask, p=2, window=64,
                                chunk_size=512, return_state=True)
    torch.cuda.synchronize()

    def close(a, r, tol):
        scale = max(1.0, r.abs().max().item())
        assert (a - r).abs().max().item() <= tol * scale

    assert o.shape == (b, hq, n, dv // 2)
    close(o, ro, 1e-4)
    close(o, ow[..., cols], 1e-4)
    for i, (a, r, w) in enumerate(zip(st, rst, stw)):
        assert a.shape == r.shape
        close(a, r, 1e-5)
        close(a, w[..., cols] if i < 3 else w, 1e-5)
