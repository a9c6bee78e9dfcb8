"""Digests of the port's kernels' outputs on the card.

  python3 src/repro_torch/launch/kernel_digest.py [--src DIR]

Runs the causal prefill kernel (o and all six moments; float32 and
bfloat16 inputs, p = 1 and 2, with a kv_mask and an init_state, at
qwen3-1.7b's widths and at G = 1, D = 64), the §2.5 backward and the hybrid
kernel (float32 and bfloat16 at qwen3-1.7b's widths; dq, dk, dv and
dstate; o and the final moments) and the noncausal kernel's two launches
(the six moments and o, at whisper-small's widths) on inputs made from a
seeded generator, and prints one line per output tensor, its name and the
sha256 of its bytes, then one line of the digest of all of them.
Two trees whose kernels give the same bits print the same lines: run it
once with `--src` pointing at the other tree's `src` directory (its
`repro_torch` is imported instead of this one's) and compare the output.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import sys
from pathlib import Path


def _digest(t) -> str:
    import torch

    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the `src` directory whose repro_torch to import")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    from repro_torch.core.ref import normalize_qk
    from repro_torch.kernels.fastmax_causal import (fastmax_causal_cuda,
                                                    fastmax_causal_ref)
    from repro_torch.kernels.fastmax_causal_bwd import fastmax_causal_bwd_cuda
    from repro_torch.kernels.hybrid_causal import hybrid_causal_cuda
    from repro_torch.kernels.fastmax_noncausal import (
        noncausal_combine_cuda, noncausal_moments_cuda)

    if not torch.cuda.is_available():
        raise SystemExit("kernel_digest needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    lines = []

    def emit(name, tensors):
        for i, t in enumerate(tensors):
            lines.append(f"{name}[{i}] {_digest(t)}")

    with torch.inference_mode():
        # (tag, B, Hq, Hkv, D, N): qwen3's widths, and G = 1 at D = 64
        for tag, b, hq, hkv, d, n in (("qwen3", 2, 16, 8, 128, 1000),
                                      ("g1d64", 2, 12, 12, 64, 300)):
            for p in (1, 2):
                for dtype in (torch.float32, torch.bfloat16):
                    qs = 1.0 / d if p == 1 else 1.0
                    q = (normalize_qk(rn(b, hq, n, d)) * qs).to(dtype)
                    k = normalize_qk(rn(b, hkv, n, d)).to(dtype)
                    v = rn(b, hkv, n, d).to(dtype)
                    mask = (torch.rand(b, hkv, n, generator=gen, device=dev)
                            > 0.2).float()
                    _, init = fastmax_causal_ref(
                        normalize_qk(rn(b, hq, 100, d)) * qs,
                        normalize_qk(rn(b, hkv, 100, d)), rn(b, hkv, 100, d),
                        p=p, chunk_size=64)
                    o, st = fastmax_causal_cuda(q, k, v, mask, p=p,
                                                init_state=init)
                    emit(f"prefill {tag} p={p} {str(dtype)[6:]}", (o, *st))
        # the backward and the hybrid forward at qwen3's widths
        b, hq, hkv, d, n = 2, 16, 8, 128, 1000
        for dtype in (torch.float32, torch.bfloat16):
            q = normalize_qk(rn(b, hq, n, d)).to(dtype)
            k = normalize_qk(rn(b, hkv, n, d)).to(dtype)
            v = rn(b, hkv, n, d).to(dtype)
            do = rn(b, hq, n, d).to(dtype)
            _, st = fastmax_causal_cuda(q, k, v, p=2)
            *grads, dstate = fastmax_causal_bwd_cuda(q, k, v, st, do, p=2,
                                                     return_dstate=True)
            emit(f"bwd {str(dtype)[6:]}", (*grads, *dstate))
            o, st = hybrid_causal_cuda(q, k, v, p=2, window=64,
                                       chunk_size=512, return_state=True)
            emit(f"hybrid {str(dtype)[6:]}", (o, *st))
        # whisper-small's widths: M = 1500 keys, N = 1500 and 1 queries
        b, h, d, m = 4, 12, 64, 1500
        for p in (1, 2):
            for dtype in (torch.float32, torch.bfloat16):
                qs = 1.0 / d if p == 1 else 1.0
                k = normalize_qk(rn(b, h, m, d)).to(dtype)
                v = rn(b, h, m, d).to(dtype)
                mom = noncausal_moments_cuda(k, v, p=p)
                emit(f"noncausal moments p={p} {str(dtype)[6:]}", mom)
                for n in (m, 1):
                    q = (normalize_qk(rn(b, h, n, d)) * qs).to(dtype)
                    emit(f"noncausal combine N={n} p={p} {str(dtype)[6:]}",
                         (noncausal_combine_cuda(q, mom, p=p),))
    torch.cuda.synchronize()
    print("\n".join(lines))
    whole = hashlib.sha256("\n".join(lines).encode()).hexdigest()
    print(f"all {len(lines)} tensors {whole}")


if __name__ == "__main__":
    main()
