"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases, one line each (then a JSON line of kernel numbers, the card's name
and power limit, and the result line last):
  1. device   — needs CUDA; TF32 off for float32 products.
  2. build    — compiles the four CUDA kernel sources from
                src/repro_torch/kernels/csrc with nvcc (one process per
                source, in parallel).
  3. kernels  — each kernel against its plain PyTorch version, float32 and
                bfloat16 inputs, o and all six final moments, p=2: at
                qwen3's widths (B=2, Hq=16, Hkv=8, D=Dv=128) prefill
                N=1024, and N=1000 with a ragged kv_mask and an init_state,
                then 64 chained decode steps from that state; at whisper's
                decoder widths (B=4, Hq=Hkv=12, D=Dv=64) prefill N=128 and
                N=120 with mask and init_state, each followed by 31 chained
                decode steps; then the prefill kernel's edges: N=1 resumed
                from an init_state, N=37 (below its chunk L), G=1 at D=64
                over N=1000 with mask and init_state, p=1 on q̂/D, and
                N=4096 (B=2) in two segments of its two launches.
  4. small    — the smoke config in float32: kernel path and plain path give
                the same greedy tokens and close prefill logits.
  5. main     — full-width qwen3-1.7b, attn fastmax2-kernel, bfloat16,
                random weights from a seeded generator: generate() at batch
                4, prompt 1024, 32 new tokens (a warm-up call, then a timed
                call whose kernel launches are counted and whose prefill and
                decode are timed inside it), and the prefill's last logit
                row against the plain path.
  6. shapes   — both kernels at the main path's shapes (B=4, N=1024), in
                float32 and bfloat16: prefill o and all six moments, then
                one decode step's o and updated moments; then timed against
                their plain versions and their bounds. For the prefill also
                its two launches timed apart (prefix moments, combine), its
                chunk L, workspace bytes and one call's peak memory, and
                two calls compared bit for bit (o and state).
  7. bwd      — the §2.5 backward kernel against its plain version
                (D=Dv=128, Hq=16, Hkv=8), float32 and bfloat16: p=2 at B=2
                N=1024, at B=2 N=1000 on a forward seeded from an
                init_state with return_dstate (all six dstate moments), at
                B=4 N=1024 (the training path's shapes, then timed: the
                call, its four launches apart, one call's peak memory, two
                calls compared bit for bit), one p=1 case, G=48 (Hq=48,
                Hkv=1) and B=2 N=4096 in two segments; dq, dk, dv row by
                row past the kernel's first chunk, that chunk's rows
                against float64.
  8. train    — full-width qwen3-1.7b, attn fastmax2-kernel, bfloat16,
                remat="full", AdamW from pick_optimizer, B=4, N=1024,
                batches from SyntheticLM: one loss and grad on the kernel
                and the plain (fastmax2-chunked) path from the same weights
                (loss difference, worst per-leaf relative grad difference);
                then a warm-up step and 3 timed steps on one batch (CUDA
                events per step; counts reset before each step: exactly
                n_layers backward and 2 n_layers forward launches); loss
                falling; step ms, tokens/s, peak memory.
  9. smoke train — the smoke config in float32: kernel and plain path
                grads agree per leaf.
 10. nc kernels — the noncausal kernel's two launches (moments, combine)
                against their plain versions, float32 and bfloat16, o and
                all six moments: at whisper's widths (B=4, Hq=Hkv=12,
                D=Dv=64, M=1500 keys, N = 1500, 128 and 1 queries), at
                qwen3's (B=2, Hq=16, Hkv=8, D=Dv=128, N=M=1024), one p=1
                case on q̂/D, then ragged shapes of the tensor-core
                launches (M = 1, 7, 33, 1501 at G*N = 17; Dv = 12, 20, 36;
                D = 128), each launch called twice and compared bit for
                bit, float32 o there held against float64.
 11. whisper small — the whisper smoke config in float32: kernel and plain
                path give the same greedy tokens and close prefill logits.
 12. whisper    — full-width whisper-small, attn fastmax2-kernel, bfloat16,
                random weights from a seeded generator: encode() of B=4 x
                1500 frames (a warm-up, then timed on CUDA events), then
                generate(enc_out=) at prompt 128 and 32 new tokens (a
                warm-up call, then a timed call); launch counts of each
                exact, peak memory, and the prefill's last logit row
                against the plain path (absolute limit). Then the
                noncausal launches timed at this path's shapes against
                their plain versions and bounds (moments at M=1500;
                combine at N=1500, 128 and 1), with their TFLOP/s beside
                the dense TF32 rate, and two calls of each compared bit
                for bit.
 13. hybrid kernels — the hybrid kernel against its plain version, o and
                all six final moments: at qwen3's widths (B=4, Hq=16, Hkv=8,
                D=Dv=128, N=1024, window 64 at chunk 512) in float32 and
                bfloat16; with a seeded kv_mask; at D=Dv=64 with G=1; with
                bands past the kernel's chunk L = 128 (window 200 at chunk
                256, 300 at 512); B=2 N=4096 in two segments; p=1 on q̂/D.
                Then timed at qwen3's shapes in bfloat16 against its plain
                version and its bound, its two launches apart (prefix
                moments, band combine), and two calls compared bit for
                bit.
 14. hybrid train — full-width qwen3-1.7b, attn hybrid2-kernel, bfloat16,
                remat="full", AdamW, B=4, N=1024, one SyntheticLM batch: at
                layer 0's own inputs the kernel path's attention against
                the plain path's (o and grads, float32) and the largest
                band score ŝ beside float32's exp limit; the whole model
                in float32 from seeded weights, its loss on the kernel and
                plain (hybrid2-chunked) paths (TRAIN_LOSS_TOL; and, as a
                reading only, without the band and in bfloat16); then a
                warm-up and 3 timed steps (exactly
                2 n_layers hybrid launches per step and no other kernel);
                step ms, tokens/s, peak memory, falling loss.
 15. hybrid small — the smoke config in float32 with hybrid2-kernel: kernel
                and plain path grads agree per leaf.
 16. hybrid serve — full-width qwen3-1.7b, attn hybrid2-kernel, bfloat16:
                generate() at batch 4, prompt 1024, 32 new tokens (a
                warm-up, then a timed call: prefill and decode ms, exactly
                n_layers hybrid launches and no other kernel); the smoke
                config in float32 gives the same greedy tokens on the
                kernel and plain (hybrid2-chunked) paths.
Exits non-zero, printing no result line, when any phase fails.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12     # dense tensor-core peak
H100_F32_FLOPS = 67e12       # CUDA-core float32 peak
H100_TF32_FLOPS = 495e12     # dense tensor-core TF32 peak
# the causal prefill's bound counts its exact in-chunk pairs at chunks of
# this many tokens, a fixed count (the function needs none of them: the
# feature-row combine covers every key), so no kernel's chunk moves it
BOUND_CHUNK = 64

# kernel vs plain version on the card: both accumulate in float32 but sum
# in different orders and chunk lengths (the fold is associative), so only
# rounding differs. float32 outputs: absolute (|o| <~ 4). bfloat16 outputs
# are both rounded from float32, so per element they may differ by one
# rounding: 2^-7 |plain| (at least one bf16 ulp) plus a float32-sized floor.
TOL_O32 = 1e-4
TOL_BF16_REL, TOL_BF16_ABS = 2.0 ** -7, 2e-5
TOL_MOMENTS = 1e-4   # max |diff| / max(1, max |plain|), per moment
# backward kernel against its plain version (run at the kernel's chunk c),
# by rows (axis -2: query rows of dq, key rows of dk and dv):
# - rows past the first chunk, and every row of a seeded forward: float32
#   at most TOL_GRAD x max(1, max|plain|); bfloat16 per element one bf16
#   rounding over that float32 limit, 2^-7 |plain| + TOL_GRAD x max(1,
#   max|plain|) (both versions accumulate in float32 and round once at the
#   end, so before rounding they differ by the float32 amount). The dstate
#   moments are float32 and are held to the float32 limit.
# - the first chunk's rows of an unseeded forward: the §2.5 backward
#   rebuilds the carry before chunk 0 as final - sum of all chunks, which
#   leaves float32 rounding of the final carry where the exact carry is
#   zero, against small denominators. That error is of order 1e-2 of the
#   scale in ANY implementation (the plain version at chunk 64 and at 512
#   differ by that much), so there kernel and plain are both held against
#   float64: the kernel's max error at most GRAD_MARGIN x the plain
#   version's, or TOL_GRAD of the scale where that is larger
TOL_GRAD, GRAD_MARGIN = 1e-4, 4
# train phase, kernel vs plain path from one set of bf16 weights: the two
# attention paths round their bf16 outputs at different places (one bf16
# rounding is 2^-8 relative), and the difference is carried through 28
# layers, the tied unembedding and the softmax. The loss is a forward-only
# reading that a wrong attention output moves little at random init, so
# it is held to a few times the 2.9e-4 measured on an H100; the per-leaf
# grad check (2.3e-2 measured) is the kernel's check, where a layer that
# took a wrong formula differs at order 1
TRAIN_LOSS_TOL = 1e-3        # absolute, on a loss of ln(151936) ~ 12
TRAIN_GRAD_TOL = 0.1         # per leaf, |g_k - g_p| / |g_p| (Frobenius)
SMOKE_GRAD_TOL = 1e-4        # the same, float32 smoke model
# hybrid train phase: at the seeded weights the hybrid model's gradients
# are chaotic (the band's exact softmax on unscaled q̂·k̂, |ŝ| up to ~54, is
# near-argmax through 28 layers): on an H100 the plain path alone, its
# embedding table nudged by about one rounding, moved the worst leaf's
# gradient by 1.45 in bf16 and 0.72 in float32, so no per-leaf limit holds
# at full width. The kernel is held at layer 0's own inputs (o and grads,
# float32, the limits above), and the whole model in float32 on the kernel
# and plain paths from the same weights to TRAIN_LOSS_TOL in the loss
# (2.96e-5 measured); the bf16 model's loss gap is printed, not held
# whisper phase, the prefill's last logit row on the kernel and the plain
# (fastmax2-chunked) path from one set of bf16 weights and frames: the two
# paths round their bf16 attention outputs at different places through 12
# encoder and 12 decoder layers. Measured on an H100: 4.69e-2 and 4.30e-2
# (two draws of frames and prompts); the limit is about four times that
WHISPER_LOGIT_TOL = 0.2      # absolute, max over the last row's logits
# noncausal kernel, ragged shapes in float32 (as tests/test_torch_cuda.py
# holds it): o's max error to float64 at most this many times the plain
# version's, or TOL_O32 of the output scale. With one key (M = 1) a row's
# denominator f(s) falls to 1/2 from terms a hundred times larger: on an
# H100 the plain float32 version was 4.79e-5 from float64 there and the
# kernel 9.43e-5 from plain, so an absolute limit against plain would
# measure both versions' rounding
NC_F64_MARGIN = 4


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def sync_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of `fn` over `reps` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def o_err(o, ref):
    """(max abs error, within the limit?) of a kernel output against its
    plain version."""
    diff = (o.float() - ref.float()).abs()
    if o.dtype == torch.bfloat16:
        ok = bool((diff <= ref.float().abs() * TOL_BF16_REL
                   + TOL_BF16_ABS).all())
    else:
        ok = diff.max().item() <= TOL_O32
    return diff.max().item(), ok


def o_tol(dtype) -> str:
    if dtype == torch.bfloat16:
        return f"2^-7|plain| + {TOL_BF16_ABS:.0e} per element"
    return f"{TOL_O32:.0e} abs"


def moment_err(a, b) -> float:
    scale = max(1.0, b.abs().max().item())
    return (a.float() - b.float()).abs().max().item() / scale


def grad_err(a, plain, exact, first):
    """One backward output against its plain version and float64, by the
    rules above; `first` rows (axis -2) are the ill-conditioned first
    chunk (0: none). Returns (max |kernel - plain| past the first chunk,
    kernel and plain max errors against float64 in the first chunk,
    within the limits?)."""
    tail_k, tail_p = a[..., first:, :].float(), plain[..., first:, :].float()
    diff = (tail_k - tail_p).abs()
    lim = TOL_GRAD * max(1.0, tail_p.abs().max().item())
    if a.dtype == torch.bfloat16:
        ok = bool((diff <= tail_p.abs() * TOL_BF16_REL + lim).all())
    else:
        ok = diff.max().item() <= lim
    e_k = e_p = 0.0
    if first:
        head = exact[..., :first, :]
        e_k = (a[..., :first, :].double() - head).abs().max().item()
        e_p = (plain[..., :first, :].double() - head).abs().max().item()
        ok = ok and e_k <= max(GRAD_MARGIN * e_p,
                               TOL_GRAD * max(1.0, head.abs().max().item()))
    return diff.max().item(), e_k, e_p, ok


def loss_and_grads(params, batch, cfg):
    from repro_torch.models import model_loss
    from repro_torch.optim.grad_utils import leaves

    named = leaves(params)
    for _, x in named:
        x.requires_grad_(True)
    loss, _ = model_loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, [x for _, x in named])
    for _, x in named:
        x.requires_grad_(False)
    return loss.detach().float(), dict(zip([n for n, _ in named], grads))


def worst_leaf(gk, gp):
    """(leaf, |g_k - g_p| / |g_p|) of the leaf that differs most."""
    errs = {n: ((gk[n].float() - gp[n].float()).norm()
                / gp[n].float().norm().clamp_min(1e-30)).item() for n in gp}
    name = max(errs, key=errs.get)
    return name, errs[name]


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.ref import normalize_qk
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.fastmax_causal import (fastmax_causal_cuda,
                                                    fastmax_causal_ref,
                                                    prefill_call,
                                                    segment_tokens, CHUNK)
    from repro_torch.kernels.fastmax_causal_bwd import (
        bwd_call, fastmax_causal_bwd_cuda, fastmax_causal_bwd_ref)
    from repro_torch.kernels.fastmax_decode import fastmax_decode_cuda
    from repro_torch.kernels.ref import fastmax_decode_ref
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_decode_state, init_model
    from repro_torch.models.param import count_params
    from repro_torch.models.transformer import lm_prefill

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    phase("device", f"{torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build ----
    t0 = time.monotonic()
    build.build_all()
    phase("build", f"nvcc built {', '.join(build.SOURCES)} in "
          f"{time.monotonic() - t0:.1f}s")
    for name, out in build.PTXAS_REPORT.items():
        for line in out.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def decode_lockstep(b, hq, hkv, d, dv, dtype, kst, pst, steps):
        """`steps` decode steps of the kernel on `kst` (in place) and the
        plain version from `pst`: (max o error, all o within the limit,
        the plain state)."""
        eo, ok = 0.0, True
        for _ in range(steps):
            qs = normalize_qk(randn(b, hq, 1, d)).to(dtype)
            ks = normalize_qk(randn(b, hkv, 1, d)).to(dtype)
            vs = randn(b, hkv, 1, dv).to(dtype)
            od = fastmax_decode_cuda(qs, ks, vs, kst, p=2)
            rd, pst = fastmax_decode_ref(qs, ks, vs, pst, p=2)
            e, o_ok = o_err(od, rd)
            eo, ok = max(eo, e), ok and o_ok
        torch.cuda.synchronize()
        return eo, ok, pst

    # ---- 3. kernels against their plain versions ----
    # at qwen3-1.7b's widths (G=2, D=Dv=128) and at whisper-small's decoder
    # self-attention (G=1, D=Dv=64: B=4, a 128-token prompt, then the 31
    # decode steps of a 32-token generate()). Each case is (N, keys masked
    # off the second sequence, chained decode steps after the prefill); a
    # masked case also starts from an init_state
    wcfg = dataclasses.replace(get_config("whisper-small"),
                               attn=AttentionSpec.parse("fastmax2-kernel"))
    wh, wd = wcfg.n_heads, wcfg.head_dim
    widths = (("qwen3", 2, 16, 8, 128, ((1024, 0, 0), (1000, 137, 64))),
              ("whisper", 4, wh, wh, wd, ((128, 0, 31), (120, 37, 31))))
    p = 2
    with torch.inference_mode():
        for name, b, hq, hkv, d, cases in widths:
            dv = d
            for dtype in (torch.float32, torch.bfloat16):
                for n, cut, steps in cases:
                    q = normalize_qk(randn(b, hq, n, d)).to(dtype)
                    k = normalize_qk(randn(b, hkv, n, d)).to(dtype)
                    v = randn(b, hkv, n, dv).to(dtype)
                    mask, init = None, None
                    if cut:
                        lens = torch.tensor([n, n - cut] * (b // 2),
                                            device=dev)
                        mask = (torch.arange(n, device=dev)[None, None, :]
                                < lens[:, None, None]).float().expand(
                                    b, hkv, n)
                        _, init = fastmax_causal_ref(
                            normalize_qk(randn(b, hq, 200, d)),
                            normalize_qk(randn(b, hkv, 200, d)),
                            randn(b, hkv, 200, dv), p=p, chunk_size=512)
                    o, st = fastmax_causal_cuda(q, k, v, mask, p=p,
                                                init_state=init)
                    ro, rst = fastmax_causal_ref(q, k, v, mask, p=p,
                                                 chunk_size=512,
                                                 init_state=init)
                    torch.cuda.synchronize()
                    eo, o_ok = o_err(o, ro)
                    em = max(moment_err(a, r) for a, r in zip(st, rst))
                    tag = (f"{name} prefill {str(dtype)[6:]} B={b} Hq={hq} "
                           f"Hkv={hkv} D={d} N={n}"
                           + (" mask+init" if cut else ""))
                    print(f"  {tag}: o max abs err {eo:.3e} (tol "
                          f"{o_tol(dtype)}), moments max rel err {em:.3e} "
                          f"(tol {TOL_MOMENTS:.0e})")
                    if not (o_ok and em <= TOL_MOMENTS):
                        fail(f"{tag} kernel disagrees with its plain version")
                    if steps:
                        # chained decode steps from this state, in lockstep
                        kst = tuple(t.clone() for t in st)
                        eo_d, ok_d, pst = decode_lockstep(
                            b, hq, hkv, d, dv, dtype, kst,
                            tuple(t.clone() for t in rst), steps)
                        em_d = max(moment_err(a, r)
                                   for a, r in zip(kst, pst))
                        dtag = (f"{name} decode {str(dtype)[6:]} {steps} "
                                f"steps after N={n}"
                                + (" mask+init" if cut else ""))
                        print(f"  {dtag}: o max abs err {eo_d:.3e} (tol "
                              f"{o_tol(dtype)}), state max rel err "
                              f"{em_d:.3e} (tol {TOL_MOMENTS:.0e})")
                        if not (ok_d and em_d <= TOL_MOMENTS):
                            fail(f"{dtag}: kernel disagrees with its plain "
                                 f"version")
        # the prefill kernel's edges (its chunk L is 128): one token
        # resumed from an init_state, N below L, G=1 at D=64 over several
        # chunks with a ragged end, p=1 on q̂/D (f = 1 + s stays positive),
        # and a prompt long enough for two segments of the two launches
        edges = (("N=1 resumed", 2, 16, 8, 128, 1, 2, False, True),
                 ("N=37 < L", 2, 16, 8, 128, 37, 2, True, False),
                 ("G=1 D=64", 2, wh, wh, wd, 1000, 2, True, True),
                 ("p=1 q/D", 2, 16, 8, 128, 1000, 1, True, True),
                 ("N=4096", 2, 16, 8, 128, 4096, 2, True, True))
        for tag, b, hq, hkv, d, n, pe, masked, seeded in edges:
            qs = 1.0 / d if pe == 1 else 1.0
            for dtype in (torch.float32, torch.bfloat16):
                q = (normalize_qk(randn(b, hq, n, d)) * qs).to(dtype)
                k = normalize_qk(randn(b, hkv, n, d)).to(dtype)
                v = randn(b, hkv, n, d).to(dtype)
                mask = init = None
                if masked:
                    mask = (torch.rand(b, hkv, n, generator=gen, device=dev)
                            > 0.2).float()
                if seeded:
                    _, init = fastmax_causal_ref(
                        normalize_qk(randn(b, hq, 200, d)) * qs,
                        normalize_qk(randn(b, hkv, 200, d)),
                        randn(b, hkv, 200, d), p=pe, chunk_size=512)
                o, st = fastmax_causal_cuda(q, k, v, mask, p=pe,
                                            init_state=init)
                ro, rst = fastmax_causal_ref(q, k, v, mask, p=pe,
                                             chunk_size=512, init_state=init)
                torch.cuda.synchronize()
                eo, o_ok = o_err(o, ro)
                em = max(moment_err(a, r) for a, r in zip(st, rst))
                nseg = -(-n // segment_tokens(b * hkv, d, d, pe))
                etag = (f"prefill {tag} {str(dtype)[6:]} B={b} Hq={hq} "
                        f"Hkv={hkv} D={d} N={n} p={pe}"
                        + (" mask" if masked else "")
                        + (" init" if seeded else "")
                        + f", {nseg} segment(s)")
                print(f"  {etag}: o max abs err {eo:.3e} (tol "
                      f"{o_tol(dtype)}), moments max rel err {em:.3e} "
                      f"(tol {TOL_MOMENTS:.0e})")
                if not (o_ok and em <= TOL_MOMENTS):
                    fail(f"{etag} kernel disagrees with its plain version")
        phase("kernels", "prefill (f32, bf16; plain and mask+init) and "
              "chained decode steps agree with their plain versions at "
              "qwen3's and whisper's widths; the prefill's edges (N=1 "
              "resumed, N < L, G=1 D=64, p=1, N=4096 in 2 segments) too")

        # ---- 4. small model: kernel path vs plain path ----
        small = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                                    attn=AttentionSpec.parse("fastmax2-kernel"))
        small_plain = dataclasses.replace(
            small, attn=AttentionSpec.parse("fastmax2-chunked"))
        sp = init_model(small, seed=0, device=dev)
        prompts = torch.randint(0, small.vocab_size, (2, 40), generator=gen,
                                device=dev)
        tk = generate(sp, small, prompts, 8, device=dev)
        tp = generate(sp, small_plain, prompts, 8, device=dev)
        lk, _ = lm_prefill(sp, prompts, small,
                           init_decode_state(small, 2, 48, device=dev))
        lp, _ = lm_prefill(sp, prompts, small_plain,
                           init_decode_state(small, 2, 48, device=dev))
        dl = (lk - lp).abs().max().item()
        phase("small", f"smoke config f32: tokens equal={bool((tk == tp).all())}"
              f", prefill logits max diff {dl:.3e} (tol 1e-4)")
        if not (bool((tk == tp).all()) and dl <= 1e-4):
            fail("smoke model: kernel path disagrees with the plain path")

        # ---- 5. main path: full-width qwen3-1.7b, bf16 ----
        cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                                  attn=AttentionSpec.parse("fastmax2-kernel"))
        plain_cfg = dataclasses.replace(
            cfg, attn=AttentionSpec.parse("fastmax2-chunked"))
        B, P, G = 4, 1024, 32
        t0 = time.monotonic()
        params = init_model(cfg, seed=0, device=dev)
        n_params = count_params(params)
        prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                                device=dev)
        torch.cuda.synchronize()
        print(f"  weights: {n_params / 1e9:.3f} B params bf16 in "
              f"{time.monotonic() - t0:.1f}s")
        generate(params, cfg, prompts, G, device=dev)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        timings = {}
        t0 = time.monotonic()
        toks = generate(params, cfg, prompts, G, device=dev, timings=timings)
        torch.cuda.synchronize()
        total_s = time.monotonic() - t0
        launches = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {"fastmax_causal": cfg.n_layers, "fastmax_causal_bwd": 0,
                "fastmax_decode": cfg.n_layers * (G - 1),
                "fastmax_noncausal_moments": 0,
                "fastmax_noncausal_combine": 0, "hybrid_causal": 0}
        if launches != want:
            fail(f"launch counts {launches}, expected {want}")
        if tuple(toks.shape) != (B, G) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"bad tokens {tuple(toks.shape)}")
        prefill_ms = timings["prefill_ms"]
        decode_ms = timings["decode_ms"] / timings["decode_steps"]
        print(f"  first tokens: {toks[0, :8].tolist()} {toks[1, :8].tolist()}")

        st = init_decode_state(cfg, B, P, device=dev)
        lk, _ = lm_prefill(params, prompts, cfg, st)
        last_k = lk[:, -1].float()
        del lk
        lp, _ = lm_prefill(params, prompts, plain_cfg, st)
        last_p = lp[:, -1].float()
        del lp, st
        dlog = (last_k - last_p).abs().max().item()
        agree = (last_k.argmax(-1) == last_p.argmax(-1)).float().mean().item()
        if not (math.isfinite(dlog) and torch.isfinite(last_k).all()):
            fail("non-finite logits on the main path")
        phase("main", f"qwen3-1.7b fastmax2-kernel bf16 B={B} P={P} G={G}: "
              f"{total_s:.3f}s total, prefill {prefill_ms:.1f} ms, decode "
              f"{decode_ms:.2f} ms/token (CUDA events inside the call), "
              f"{B * G / total_s:.1f} tok/s, peak {peak_gb:.2f} GB, launches "
              f"{launches}, last-row logit max |kernel - plain| {dlog:.3e} "
              f"(argmax agree {agree:.2f})")

        # ---- 6. the kernels at the main path's shapes ----
        del params
        torch.cuda.empty_cache()
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        for dtype in (torch.float32, torch.bfloat16):
            q = normalize_qk(randn(B, hq, P, d)).to(dtype)
            k = normalize_qk(randn(B, hkv, P, d)).to(dtype)
            v = randn(B, hkv, P, d).to(dtype)
            fc_o, fc_st = fastmax_causal_cuda(q, k, v, p=2)
            rc_o, rc_st = fastmax_causal_ref(q, k, v, p=2, chunk_size=512)
            fc_err, fc_ok = o_err(fc_o, rc_o)
            fc_em = max(moment_err(a, r) for a, r in zip(fc_st, rc_st))
            del fc_st
            kst = tuple(t.clone() for t in rc_st)
            fd_err, fd_ok, pst = decode_lockstep(B, hq, hkv, d, d, dtype, kst,
                                                 rc_st, 1)
            fd_em = max(moment_err(a, r) for a, r in zip(kst, pst))
            print(f"  {str(dtype)[6:]} B={B} N={P}: prefill o max abs err "
                  f"{fc_err:.3e}, moments {fc_em:.3e}; decode o max abs err "
                  f"{fd_err:.3e}, updated moments {fd_em:.3e} (tol "
                  f"{o_tol(dtype)}; moments {TOL_MOMENTS:.0e})")
            if not (fc_ok and fd_ok and fc_em <= TOL_MOMENTS
                    and fd_em <= TOL_MOMENTS):
                fail(f"{dtype} at the main path's shapes: a kernel disagrees "
                     f"with its plain version")
            del kst, pst
        phase("shapes", "both kernels agree with their plain versions at "
              "B=4, N=1024 in f32 and bf16 (o and all six moments)")

        # timed in bf16, the main path's dtype (the last loop's inputs):
        # the call (both launches, with its allocations), then each launch
        # on its own on one call's buffers
        fc_ms = sync_ms(lambda: fastmax_causal_cuda(q, k, v, p=2), reps=5)
        fc_plain = sync_ms(lambda: fastmax_causal_ref(q, k, v, p=2,
                                                      chunk_size=512), reps=3)
        del rc_o
        call = prefill_call(q, k, v, p=2)
        call.run()
        fc_prefix_ms = sync_ms(call.prefix, reps=5)
        fc_combine_ms = sync_ms(call.combine, reps=5)
        ws_bytes, nseg = call.workspace_bytes, len(call.segments)
        del call
        # one call's peak memory above what was allocated before it, and
        # two calls' bits
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        o1, s1 = fastmax_causal_cuda(q, k, v, p=2)
        torch.cuda.synchronize()
        call_peak = torch.cuda.max_memory_allocated() - before
        o2, s2 = fastmax_causal_cuda(q, k, v, p=2)
        torch.cuda.synchronize()
        same_bits = bool(torch.equal(o1, o2)) and all(
            torch.equal(a, b) for a, b in zip(s1, s2))
        del o1, o2, s1, s2
        print(f"  prefill kernel at B={B} N={P} bf16: chunk L={CHUNK}, "
              f"{nseg} segment(s), workspace "
              f"{ws_bytes / 1e9:.3f} GB, one call's peak {call_peak / 1e9:.3f}"
              f" GB above what was allocated before it; prefix-moments launch "
              f"{fc_prefix_ms:.3f} ms, combine launch {fc_combine_ms:.3f} ms, "
              f"the call {fc_ms:.3f} ms; two calls bitwise equal (o and "
              f"state): {same_bits}")
        if not same_bits:
            fail("two prefill calls on the same inputs differ")
        if nseg != 1:
            fail(f"the prefill at the main path's shapes ran in {nseg} "
                 f"segments (the launch times above are one segment's)")
        gq = hq // hkv
        bh = B * hkv
        # operations the function needs, per (b, kv-head): m2 and g2 are
        # symmetric in (a, b), as is q_a q_b, so the degree-2 combine and
        # fold need D(D+1)/2 rows, not D^2; plus the degree-0/1 terms and
        # the causal intra-chunk block, counted at chunks of BOUND_CHUNK
        # whatever chunk a kernel takes
        c = BOUND_CHUNK
        pairs = (P // c) * c * (c + 1) // 2 + (P % c) * (P % c + 1) // 2
        fc_ops = bh * ((gq + 1) * P * d * (d + 1) * (d + 1)   # m2, g2
                       + 2 * (gq + 1) * P * (d + 1) * (d + 1)  # m1 g1 m0 g0
                       + gq * pairs * 2 * (d + d))            # intra-chunk
        fc_bytes = (q.numel() + k.numel() + v.numel()) * 2 + fc_o.numel() * 2 \
            + sum(t.numel() for t in rc_st) * 4
        fc_bound = max(fc_bytes / H100_BYTES_PER_S,
                       fc_ops / H100_BF16_FLOPS) * 1e3

        qs = normalize_qk(randn(B, hq, 1, d)).bfloat16()
        ks = normalize_qk(randn(B, hkv, 1, d)).bfloat16()
        vs = randn(B, hkv, 1, d).bfloat16()
        kst = tuple(t.clone() for t in rc_st)
        od = fastmax_decode_cuda(qs, ks, vs, kst, p=2)
        fd_ms = sync_ms(lambda: fastmax_decode_cuda(qs, ks, vs, kst, p=2),
                        reps=20)
        fd_plain = sync_ms(lambda: fastmax_decode_ref(qs, ks, vs, rc_st, p=2),
                           reps=5)
        state_bytes = sum(t.numel() for t in kst) * 4
        fd_bytes = 2 * state_bytes + (qs.numel() + ks.numel() + vs.numel()
                                      + od.numel()) * 2
        fd_ops = bh * (gq + 1) * (d * (d + 1) * (d + 1)
                                  + 2 * (d + 1) * (d + 1))
        fd_bound = max(fd_bytes / H100_BYTES_PER_S,
                       fd_ops / H100_F32_FLOPS) * 1e3
        print(f"  timing (shapes): prefill kernel {fc_ms:.3f} ms (plain "
              f"{fc_plain:.3f}, bound {fc_bound:.3f} bf16-peak / "
              f"{fc_ops / H100_F32_FLOPS * 1e3:.3f} f32-peak, "
              f"{fc_ops / fc_ms / 1e9:.2f} TFLOP/s); decode kernel "
              f"{fd_ms:.4f} ms (plain {fd_plain:.4f}, bound {fd_bound:.4f}, "
              f"{fd_bytes / fd_ms / 1e6:.0f} GB/s)")
        del rc_st, kst
        torch.cuda.empty_cache()

    # ---- 7. the backward kernel against its plain version (outside
    # inference mode: the plain version differentiates with autograd) ----
    cb = CHUNK   # the backward's chunk, as the prefill's

    def bwd_case(b, n, dtype, p, seeded, heads=(hq, hkv)):
        bhq, bhkv = heads
        # at p=1, f(s) = 1 + s is sign-indefinite at the model's scale
        # (|s| up to D): denominators can nearly cancel, and which
        # float32 summation order lands nearer float64 is luck; q̂/D
        # keeps |s| <= 1 and f >= 0
        qs = 1.0 / d if p == 1 else 1.0
        q = (normalize_qk(randn(b, bhq, n, d)) * qs).to(dtype)
        k = normalize_qk(randn(b, bhkv, n, d)).to(dtype)
        v = randn(b, bhkv, n, d).to(dtype)
        do = randn(b, bhq, n, d).to(dtype)
        init = None
        if seeded:
            _, init = fastmax_causal_ref(
                normalize_qk(randn(b, bhq, 200, d)) * qs,
                normalize_qk(randn(b, bhkv, 200, d)),
                randn(b, bhkv, 200, d), p=p, chunk_size=512)
        _, state = fastmax_causal_cuda(q, k, v, p=p, init_state=init)
        nseg = len(bwd_call(q, k, v, state, do, p=p).segments)
        got = fastmax_causal_bwd_cuda(q, k, v, state, do, p=p,
                                      return_dstate=seeded)
        ref = fastmax_causal_bwd_ref(q, k, v, state, do, p=p,
                                     chunk_size=cb, return_dstate=seeded)
        # float64, for the first chunk's rows of an unseeded forward only
        exact = None if seeded else fastmax_causal_bwd_ref(
            q.double(), k.double(), v.double(),
            [t.double() for t in state], do.double(), p=p, chunk_size=cb)
        torch.cuda.synchronize()

        def flat(r):
            return list(r[:3]) + (list(r[3]) if seeded else [])

        # a seeded forward's carry before chunk 0 is the seed, not a
        # near-zero rebuild: every row is held to the tight limit
        first = 0 if seeded else cb
        errs = [grad_err(a, r, e, first) for a, r, e in
                zip(flat(got), flat(ref), flat(exact) if exact else
                    [None] * len(flat(ref)))]
        del exact
        tag = (f"bwd p={p} {str(dtype)[6:]} B={b} N={n}"
               + (f" G={bhq // bhkv}" if heads != (hq, hkv) else "")
               + (f" {nseg} segments" if nseg > 1 else "")
               + (" seeded+dstate" if seeded else ""))
        names = ["dq", "dk", "dv"] + (["dm0", "dm1", "dm2", "dg0", "dg1",
                                       "dg2"] if seeded else [])
        tight = (f"{TOL_GRAD:.0e} of scale" if dtype == torch.float32 else
                 f"2^-7|plain| + {TOL_GRAD:.0e} of scale per element")
        msg = (f"  {tag}: max |kernel - plain| "
               + ("" if seeded else f"on rows >= {cb} ") + ", ".join(
                   f"{nm} {x[0]:.2e}" for nm, x in zip(names, errs))
               + f" (limit {tight}")
        if not seeded:
            msg += (f"); rows < {cb}, max error vs float64 kernel / plain: "
                    + ", ".join(f"{nm} {x[1]:.2e}/{x[2]:.2e}"
                                for nm, x in zip(names, errs))
                    + f" (limit {GRAD_MARGIN}x plain or {TOL_GRAD:.0e} of "
                    f"scale")
        print(msg + ")")
        if not all(x[3] for x in errs):
            fail(f"{tag}: the backward kernel disagrees with its plain "
                 f"version")
        whole = max((a.float() - r.float()).abs().max().item()
                    for a, r in zip(got[:3], ref[:3]))
        return whole, nseg, (q, k, v, state, do)

    for dtype in (torch.float32, torch.bfloat16):
        bwd_case(2, 1024, dtype, 2, False)
        bwd_case(2, 1000, dtype, 2, True)
    bwd_case(2, 1000, torch.float32, 1, True)
    # granite's grouping: 48 query heads on one kv head
    bwd_case(1, 512, torch.float32, 2, False, heads=(48, 1))
    # past one segment (3840 tokens at B=2): two, the last seeding the first
    _, nseg, _ = bwd_case(2, 4096, torch.float32, 2, True)
    if nseg != 2:
        fail(f"the backward at B=2 N=4096 ran in {nseg} segments, not 2")
    bwd_case(4, P, torch.float32, 2, False)
    fb_err, nseg, bargs = bwd_case(4, P, torch.bfloat16, 2, False)
    if nseg != 1:
        fail(f"the backward at the train path's shapes ran in {nseg} "
             f"segments (the launch times below are one segment's)")
    bq, bk, bv, bst, bdo = bargs
    # two calls' bits, and one call's peak memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    g1 = fastmax_causal_bwd_cuda(bq, bk, bv, bst, bdo, p=2,
                                 return_dstate=True)
    torch.cuda.synchronize()
    bwd_peak = torch.cuda.max_memory_allocated() - before
    g2 = fastmax_causal_bwd_cuda(bq, bk, bv, bst, bdo, p=2,
                                 return_dstate=True)
    torch.cuda.synchronize()
    bwd_same = all(torch.equal(a, b_) for a, b_ in
                   zip(list(g1[:3]) + list(g1[3]), list(g2[:3]) + list(g2[3])))
    del g1, g2
    if not bwd_same:
        fail("two backward calls on the same inputs differ")
    phase("bwd", "backward kernel agrees with its plain version (p=2 "
          "f32/bf16 at B=2 N=1024, B=2 N=1000 seeded with dstate, "
          "B=4 N=1024; p=1 seeded; G=48 at B=1 N=512; B=2 N=4096 in two "
          "segments, seeded with dstate); two calls equal bit for bit")
    fb_ms = sync_ms(lambda: fastmax_causal_bwd_cuda(bq, bk, bv, bst, bdo,
                                                    p=2), reps=3)
    fb_plain = sync_ms(lambda: fastmax_causal_bwd_ref(
        bq, bk, bv, bst, bdo, p=2, chunk_size=512), reps=2)
    call = bwd_call(bq, bk, bv, bst, bdo, p=2)
    call.run()
    fb_parts = {f: sync_ms(getattr(call, f), reps=3)
                for f in ("slots", "queries", "cot", "keys")}
    bws_bytes = call.workspace_bytes
    del call
    c = BOUND_CHUNK
    pairs_b = (P // c) * c * (c + 1) // 2 + (P % c) * (P % c + 1) // 2
    # per (b, kv-head): the six degree-2 passes on the symmetric half
    # (g2 and gg2 ride along as one more column, as in the forward's
    # count), the degree-0/1 terms of the same six passes, and six
    # products per causal pair inside chunks of BOUND_CHUNK (scores, F.v,
    # u.v, ds.k, ds^T.q, F^T.u)
    fb_ops = bh * ((3 * gq + 3) * P * d * (d + 1) * (d + 1)
                   + 2 * (3 * gq + 3) * P * (d + 1) * (d + 1)
                   + gq * pairs_b * 2 * (3 * d + 3 * d))
    # q, k, v read and dq, dk, dv written (bf16), do read, carry read
    fb_bytes = (2 * (bq.numel() + bk.numel() + bv.numel())
                + bdo.numel()) * 2 + sum(t.numel() for t in bst) * 4
    fb_bound = max(fb_bytes / H100_BYTES_PER_S,
                   fb_ops / H100_BF16_FLOPS) * 1e3
    print(f"  timing (bwd, bf16 B={B} N={P}): kernel {fb_ms:.3f} ms "
          f"(launches A' carry slots {fb_parts['slots']:.3f}, B' queries "
          f"{fb_parts['queries']:.3f}, C cotangent slots "
          f"{fb_parts['cot']:.3f}, D keys {fb_parts['keys']:.3f}; plain "
          f"{fb_plain:.3f}, bound {fb_bound:.3f} bf16-peak / "
          f"{fb_ops / H100_F32_FLOPS * 1e3:.3f} f32-peak, "
          f"{fb_ops / fb_ms / 1e9:.2f} TFLOP/s, chunk {cb}, 1 segment, "
          f"workspace {bws_bytes / 1e9:.3f} GB, one call's peak "
          f"{bwd_peak / 1e9:.3f} GB above what was allocated before it)")
    del bargs, bq, bk, bv, bst, bdo
    torch.cuda.empty_cache()

    # ---- 8. training path: full-width qwen3-1.7b, bf16 ----
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step, pick_optimizer

    tcfg = dataclasses.replace(cfg, remat="full")
    tplain = dataclasses.replace(plain_cfg, remat="full")
    params = init_model(tcfg, seed=0, device=dev)
    batch = SyntheticLM(tcfg.vocab_size, P, seed=0).batch(0, B)
    tbatch = {k_: torch.as_tensor(v_, device=dev) for k_, v_ in batch.items()}
    lk_, gk = loss_and_grads(params, tbatch, tcfg)
    lp_, gp = loss_and_grads(params, tbatch, tplain)
    dloss = abs(lk_.item() - lp_.item())
    leaf, gerr = worst_leaf(gk, gp)
    del gk, gp
    torch.cuda.empty_cache()
    print(f"  parity before any update: loss kernel {lk_.item():.5f} plain "
          f"{lp_.item():.5f} |diff| {dloss:.3e} (tol {TRAIN_LOSS_TOL}); "
          f"worst leaf {leaf} |g_k - g_p|/|g_p| {gerr:.3e} (tol "
          f"{TRAIN_GRAD_TOL})")
    if not (math.isfinite(lk_.item()) and dloss <= TRAIN_LOSS_TOL
            and gerr <= TRAIN_GRAD_TOL):
        fail("train: kernel and plain loss/grads disagree")

    n_steps = 3
    _, opt = pick_optimizer(tcfg, count_params(params), lr=3e-4,
                            total_steps=1 + n_steps)
    opt_state = opt[0](params)
    train_step = make_train_step(tcfg, opt)
    params, opt_state, m = train_step(params, opt_state, batch)   # warm-up
    losses = [m["loss"].item()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, train_launches = [], []
    want_t = {"fastmax_causal": 2 * tcfg.n_layers,
              "fastmax_causal_bwd": tcfg.n_layers, "fastmax_decode": 0,
              "fastmax_noncausal_moments": 0, "fastmax_noncausal_combine": 0,
              "hybrid_causal": 0}
    for _ in range(n_steps):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ops.reset_launch_counts()
        ev0.record()
        params, opt_state, m = train_step(params, opt_state, batch)
        ev1.record()
        ev1.synchronize()
        train_launches.append(ops.launch_counts())
        step_ms.append(ev0.elapsed_time(ev1))
        losses.append(m["loss"].item())
    peak_train = torch.cuda.max_memory_allocated() / 1e9
    if any(c != want_t for c in train_launches):
        fail(f"train launch counts {train_launches}, expected {want_t} "
             f"per step")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        fail(f"train: loss did not fall on a fixed batch: {losses}")
    med_ms = sorted(step_ms)[len(step_ms) // 2]
    phase("train", f"qwen3-1.7b fastmax2-kernel bf16 remat=full AdamW B={B} "
          f"N={P}: step ms {', '.join(f'{x:.1f}' for x in step_ms)} (CUDA "
          f"events), {B * P / (med_ms / 1e3):.1f} tokens/s at the median, "
          f"peak {peak_train:.2f} GB, loss {', '.join(f'{x:.4f}' for x in losses)}"
          f", launches per step {train_launches[-1]}")
    del params, opt_state, train_step, opt
    torch.cuda.empty_cache()

    # ---- 9. smoke config in float32: kernel and plain grads ----
    sparams = init_model(small, seed=0, device=dev)
    sb = SyntheticLM(small.vocab_size, 256, seed=1).batch(0, 2)
    sb = {k_: torch.as_tensor(v_, device=dev) for k_, v_ in sb.items()}
    slk, sgk = loss_and_grads(sparams, sb, small)
    slp, sgp = loss_and_grads(sparams, sb, small_plain)
    sleaf, serr = worst_leaf(sgk, sgp)
    phase("smoke train", f"smoke config f32 N=256: loss |kernel - plain| "
          f"{abs(slk.item() - slp.item()):.3e}, worst leaf {sleaf} "
          f"|g_k - g_p|/|g_p| {serr:.3e} (tol {SMOKE_GRAD_TOL:.0e})")
    if not serr <= SMOKE_GRAD_TOL:
        fail("smoke train: kernel and plain grads disagree")

    # ---- 10. the noncausal kernel against its plain version ----
    from repro_torch.kernels.fastmax_noncausal import (
        noncausal_combine_cuda, noncausal_combine_ref, noncausal_moments_cuda,
        noncausal_moments_ref)
    from repro_torch.models.encdec import encode

    def nc_case(b, hq, hkv, n, m, d, dtype, p=2, dv=None, ragged=False):
        """Both launches against their plain versions on one input: (o max
        abs error, the moments' max abs error, the inputs, the kernel's and
        the plain moments). `ragged`: also each launch twice, bit for bit,
        and float32 o held against float64 by NC_F64_MARGIN (below)."""
        # at p=1 the queries are q̂/D (|s| <= 1, f >= 0; see bwd_case)
        qs = 1.0 / d if p == 1 else 1.0
        dv = d if dv is None else dv
        q = (normalize_qk(randn(b, hq, n, d)) * qs).to(dtype)
        k = normalize_qk(randn(b, hkv, m, d)).to(dtype)
        v = randn(b, hkv, m, dv).to(dtype)
        mom = noncausal_moments_cuda(k, v, p=p)
        rmom = noncausal_moments_ref(k, v, p=p)
        o = noncausal_combine_cuda(q, mom, p=p)
        ro = noncausal_combine_ref(q, rmom, p=p)
        torch.cuda.synchronize()
        eo, o_ok = o_err(o, ro)
        em = max(moment_err(a, r) for a, r in zip(mom, rmom))
        em_abs = max((a - r).abs().max().item() for a, r in zip(mom, rmom))
        tag = (f"nc p={p} {str(dtype)[6:]} B={b} Hq={hq} Hkv={hkv} D={d} "
               f"Dv={dv} N={n} M={m}")
        extra = ""
        if ragged:
            same = (all(torch.equal(a, c) for a, c in
                        zip(mom, noncausal_moments_cuda(k, v, p=p)))
                    and torch.equal(o, noncausal_combine_cuda(q, mom, p=p)))
            extra = f", two calls equal bit for bit={same}"
            o_ok = o_ok and same
            if dtype == torch.float32:
                o64 = noncausal_combine_ref(q.double(), noncausal_moments_ref(
                    k.double(), v.double(), p=p), p=p)
                e_k = (o.double() - o64).abs().max().item()
                e_p = (ro.double() - o64).abs().max().item()
                o_ok = same and e_k <= max(
                    NC_F64_MARGIN * e_p,
                    TOL_O32 * max(1.0, o64.abs().max().item()))
                extra += (f"; to float64: kernel {e_k:.3e}, plain {e_p:.3e} "
                          f"(kernel <= {NC_F64_MARGIN} x plain or "
                          f"{TOL_O32:.0e} of scale)")
        print(f"  {tag}: o max abs err {eo:.3e} (tol {o_tol(dtype)}), "
              f"moments max rel err {em:.3e} (tol {TOL_MOMENTS:.0e}; max "
              f"abs err {em_abs:.3e}){extra}")
        if not (o_ok and em <= TOL_MOMENTS):
            fail(f"{tag}: the noncausal kernel disagrees with its plain "
                 f"version")
        return eo, em_abs, (q, k, v, mom, rmom)

    WM = wcfg.encoder_seq
    nc_err = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for n in (WM, 128, 1):
                nc_err[(dtype, n)] = nc_case(B, wh, wh, n, WM, wd,
                                             dtype)[:2]
            nc_case(2, hq, hkv, P, P, d, dtype)
        nc_case(B, wh, wh, WM, WM, wd, torch.float32, p=1)
        # ragged shapes of the tensor-core launches: keys M (stages of 32,
        # the last zero-filled), value widths Dv that are not a multiple of
        # the n8 tile, G*N = 17 (the row combine's smallest input), D = 128
        for dtype in (torch.float32, torch.bfloat16):
            for m in (1, 7, 33, 1501):
                nc_case(2, 2, 2, 17, m, wd, dtype, ragged=True)
            for dv in (12, 20, 36):
                nc_case(2, 4, 2, 200, 300, wd, dtype, dv=dv, ragged=True)
            nc_case(2, 4, 2, 300, 333, d, dtype, dv=36, ragged=True)
    torch.cuda.empty_cache()
    phase("nc kernels", "moments and combine agree with their plain versions "
          f"(f32, bf16; whisper widths N={WM}, 128, 1 against M={WM}; qwen3 "
          f"widths N=M={P}; p=1; ragged M=1, 7, 33, 1501, Dv=12, 20, 36, "
          f"G*N=17, D={d}, each launch twice bit for bit)")

    # ---- 11. whisper smoke config: kernel path vs plain path ----
    wsmall = dataclasses.replace(get_smoke_config("whisper-small"),
                                 attn=AttentionSpec.parse("fastmax2-kernel"))
    wsmall_plain = dataclasses.replace(
        wsmall, attn=AttentionSpec.parse("fastmax2-chunked"))
    with torch.inference_mode():
        wsp = init_model(wsmall, seed=0, device=dev)
        frames = randn(2, wsmall.encoder_seq, wsmall.d_model)
        prompts = torch.randint(0, wsmall.vocab_size, (2, 40), generator=gen,
                                device=dev)
        enc_k = encode(wsp, frames, wsmall)
        enc_p = encode(wsp, frames, wsmall_plain)
        tk = generate(wsp, wsmall, prompts, 8, enc_out=enc_k, device=dev)
        tp = generate(wsp, wsmall_plain, prompts, 8, enc_out=enc_p,
                      device=dev)
        lk, _ = lm_prefill(wsp["decoder"], prompts, wsmall,
                           init_decode_state(wsmall, 2, 48, device=dev),
                           enc_out=enc_k)
        lp, _ = lm_prefill(wsp["decoder"], prompts, wsmall_plain,
                           init_decode_state(wsmall, 2, 48, device=dev),
                           enc_out=enc_p)
    de = (enc_k - enc_p).abs().max().item()
    dl = (lk - lp).abs().max().item()
    same = bool((tk == tp).all())
    phase("whisper small", f"smoke config f32: tokens equal={same}, encoder "
          f"output max diff {de:.3e}, prefill logits max diff {dl:.3e} (tol "
          f"1e-4)")
    if not (same and de <= 1e-4 and dl <= 1e-4):
        fail("whisper smoke model: kernel path disagrees with the plain path")

    # ---- 12. whisper-small at full width, bf16 ----
    wplain = dataclasses.replace(
        wcfg, attn=AttentionSpec.parse("fastmax2-chunked"))
    WP, WG, WL = 128, 32, wcfg.n_layers
    with torch.inference_mode():
        t0 = time.monotonic()
        wparams = init_model(wcfg, seed=0, device=dev)
        frames = randn(B, WM, wcfg.d_model).to(wcfg.adtype())
        prompts = torch.randint(0, wcfg.vocab_size, (B, WP), generator=gen,
                                device=dev)
        torch.cuda.synchronize()
        print(f"  weights: {count_params(wparams) / 1e9:.3f} B params bf16 "
              f"in {time.monotonic() - t0:.1f}s")
        enc_out = encode(wparams, frames, wcfg)                  # warm-up
        generate(wparams, wcfg, prompts, WG, enc_out=enc_out, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        enc_out = encode(wparams, frames, wcfg)
        ev1.record()
        ev1.synchronize()
        encode_ms = ev0.elapsed_time(ev1)
        enc_launches = ops.launch_counts()
        ops.reset_launch_counts()
        wtimings = {}
        t0 = time.monotonic()
        wtoks = generate(wparams, wcfg, prompts, WG, enc_out=enc_out,
                         device=dev, timings=wtimings)
        torch.cuda.synchronize()
        wtotal_s = time.monotonic() - t0
        gen_launches = ops.launch_counts()
        wpeak_gb = torch.cuda.max_memory_allocated() / 1e9
        want_e = {"fastmax_causal": 0, "fastmax_causal_bwd": 0,
                  "fastmax_decode": 0,
                  "fastmax_noncausal_moments": wcfg.encoder_layers,
                  "fastmax_noncausal_combine": wcfg.encoder_layers,
                  "hybrid_causal": 0}
        want_g = {"fastmax_causal": WL, "fastmax_causal_bwd": 0,
                  "fastmax_decode": WL * (WG - 1),
                  "fastmax_noncausal_moments": WL * WG,
                  "fastmax_noncausal_combine": WL * WG, "hybrid_causal": 0}
        if enc_launches != want_e:
            fail(f"encode launch counts {enc_launches}, expected {want_e}")
        if gen_launches != want_g:
            fail(f"generate launch counts {gen_launches}, expected {want_g}")
        if not (tuple(enc_out.shape) == (B, WM, wcfg.d_model)
                and bool(torch.isfinite(enc_out).all())):
            fail("non-finite or misshapen encoder output")
        if tuple(wtoks.shape) != (B, WG) or not bool(
                ((wtoks >= 0) & (wtoks < wcfg.vocab_size)).all()):
            fail(f"bad whisper tokens {tuple(wtoks.shape)}")
        print(f"  first tokens: {wtoks[0, :8].tolist()} "
              f"{wtoks[1, :8].tolist()}")
        st = init_decode_state(wcfg, B, WP, device=dev)
        lk, _ = lm_prefill(wparams["decoder"], prompts, wcfg, st,
                           enc_out=enc_out)
        last_k = lk[:, -1].float()
        enc_plain = encode(wparams, frames, wplain)
        lp, _ = lm_prefill(wparams["decoder"], prompts, wplain, st,
                           enc_out=enc_plain)
        last_p = lp[:, -1].float()
        del lk, lp, st
    wdlog = (last_k - last_p).abs().max().item()
    wagree = (last_k.argmax(-1) == last_p.argmax(-1)).float().mean().item()
    wscale = last_p.abs().max().item()
    if not (math.isfinite(wdlog) and bool(torch.isfinite(last_k).all())):
        fail("non-finite logits on the whisper path")
    wprefill_ms = wtimings["prefill_ms"]
    wdecode_ms = wtimings["decode_ms"] / wtimings["decode_steps"]
    phase("whisper", f"whisper-small fastmax2-kernel bf16 B={B} frames={WM} "
          f"P={WP} G={WG}: encode {encode_ms:.1f} ms, generate "
          f"{wtotal_s:.3f}s total, prefill {wprefill_ms:.1f} ms, decode "
          f"{wdecode_ms:.2f} ms/token (CUDA events inside the call), "
          f"{B * WG / wtotal_s:.1f} tok/s, peak {wpeak_gb:.2f} GB; launches "
          f"per encode {enc_launches}, per generate {gen_launches}; last-row "
          f"logit max |kernel - plain| {wdlog:.3e} (tol "
          f"{WHISPER_LOGIT_TOL}; max |plain| {wscale:.3f}; argmax agree "
          f"{wagree:.2f})")
    if not wdlog <= WHISPER_LOGIT_TOL:
        fail("whisper: the kernel path's logits disagree with the plain "
             "path's")
    del wparams, enc_out, enc_plain
    torch.cuda.empty_cache()

    # the noncausal launches timed at the whisper path's shapes, bf16
    bhw = B * wh
    rows = 1 + wd + wd * (wd + 1) // 2       # feature rows, symmetric m2
    with torch.inference_mode():
        _, _, (q, k, v, mom, rmom) = nc_case(B, wh, wh, WM, WM, wd,
                                             torch.bfloat16)
        q1 = q[:, :, :1].contiguous()
        q128 = q[:, :, :WP].contiguous()
        nm_ms = sync_ms(lambda: noncausal_moments_cuda(k, v, p=2), reps=10)
        nm_plain = sync_ms(lambda: noncausal_moments_ref(k, v, p=2), reps=5)
        nc_ms = sync_ms(lambda: noncausal_combine_cuda(q, mom, p=2), reps=10)
        nc_plain = sync_ms(lambda: noncausal_combine_ref(q, rmom, p=2),
                           reps=5)
        n128_ms = sync_ms(lambda: noncausal_combine_cuda(q128, mom, p=2),
                          reps=20)
        n128_plain = sync_ms(lambda: noncausal_combine_ref(q128, rmom, p=2),
                             reps=10)
        n1_ms = sync_ms(lambda: noncausal_combine_cuda(q1, mom, p=2),
                        reps=50)
        n1_plain = sync_ms(lambda: noncausal_combine_ref(q1, rmom, p=2),
                           reps=20)
        nc_same = (all(torch.equal(a, c) for a, c in
                       zip(noncausal_moments_cuda(k, v, p=2),
                           noncausal_moments_cuda(k, v, p=2)))
                   and all(torch.equal(noncausal_combine_cuda(x, mom, p=2),
                                       noncausal_combine_cuda(x, mom, p=2))
                           for x in (q, q128, q1)))
    if not nc_same:
        fail("nc: two calls of a noncausal launch differ")
    # per (b, head): each feature row (the constant, the linear ones, the
    # pairs a <= b) is one FMA per value column and one for the g column;
    # bytes: k, v read and the moments written; q read, the feature rows
    # of the moments read and o written. The tensor cores run the value
    # columns' products in passes of the TF32 split: 2 for the moments of
    # bf16 keys and values, 3 for the combine
    nm_ops = bhw * WM * rows * 2 * (wd + 1)
    nm_bytes = (k.numel() + v.numel()) * 2 + sum(t.numel() for t in mom) * 4
    nm_tc = 2 * bhw * WM * rows * 2 * wd

    def combine_bound(n):
        ops_ = bhw * n * rows * 2 * (wd + 1)
        bytes_ = 2 * bhw * n * wd * 2 + bhw * rows * (wd + 1) * 4
        return ops_, bytes_, max(ops_ / H100_BF16_FLOPS,
                                 bytes_ / H100_BYTES_PER_S) * 1e3

    def rates(ops_, tc_ops, ms):
        return (f"{ops_ / ms / 1e9:.2f} TFLOP/s; {tc_ops / ms / 1e9:.1f} "
                f"TFLOP/s of TF32 products against the dense "
                f"{H100_TF32_FLOPS / 1e12:.0f}")

    nm_bound = max(nm_ops / H100_BF16_FLOPS,
                   nm_bytes / H100_BYTES_PER_S) * 1e3
    nc_ops, nc_bytes, nc_bound = combine_bound(WM)
    n128_ops, n128_bytes, n128_bound = combine_bound(WP)
    n1_ops, n1_bytes, n1_bound = combine_bound(1)
    print(f"  timing (nc, bf16 B={B} H={wh} D={wd} M={WM}; two calls of each "
          f"launch equal bit for bit): moments {nm_ms:.3f} ms (plain "
          f"{nm_plain:.3f}, bound {nm_bound:.4f}, "
          f"{rates(nm_ops, nm_tc, nm_ms)}); combine N={WM} {nc_ms:.3f} ms "
          f"(plain {nc_plain:.3f}, bound {nc_bound:.4f}, "
          f"{rates(nc_ops, 3 * nc_ops * wd / (wd + 1), nc_ms)}); combine "
          f"N={WP} {n128_ms:.4f} ms (plain {n128_plain:.4f}, bound "
          f"{n128_bound:.4f}, "
          f"{rates(n128_ops, 3 * n128_ops * wd / (wd + 1), n128_ms)}); "
          f"combine N=1 {n1_ms:.4f} ms (plain {n1_plain:.4f}, bound "
          f"{n1_bound:.4f}, {n1_bytes / n1_ms / 1e6:.0f} GB/s)")
    del q, k, v, q1, q128, mom, rmom
    torch.cuda.empty_cache()

    # ---- 13. the hybrid kernel against its plain version ----
    from repro_torch.kernels.hybrid_causal import (band_width,
                                                   hybrid_causal_cuda,
                                                   hybrid_causal_ref)

    # the hybrid spec's window at qwen3's chunk: 64 at 512
    HW, HC = AttentionSpec.parse("hybrid2-kernel").window, cfg.chunk_size

    def hy_case(b, hq_, hkv_, n, d_, dtype, window, chunk, p=2, cut=0):
        """The kernel and its plain version on one input: (o max abs
        error, the inputs, the kernel's segments). `cut` masks the last
        keys of every other sequence off."""
        qs = 1.0 / d_ if p == 1 else 1.0   # p=1: q̂/D (see bwd_case)
        q = (normalize_qk(randn(b, hq_, n, d_)) * qs).to(dtype)
        k = normalize_qk(randn(b, hkv_, n, d_)).to(dtype)
        v = randn(b, hkv_, n, d_).to(dtype)
        mask = None
        if cut:
            lens = torch.tensor([n, n - cut] * (b // 2), device=dev)
            mask = (torch.arange(n, device=dev)[None, None, :]
                    < lens[:, None, None]).float().expand(b, hkv_, n)
        kw = dict(p=p, window=window, chunk_size=chunk, return_state=True)
        o, st = hybrid_causal_cuda(q, k, v, mask, **kw)
        ro, rst = hybrid_causal_ref(q, k, v, mask, **kw)
        torch.cuda.synchronize()
        eo, o_ok = o_err(o, ro)
        em = max(moment_err(a, r) for a, r in zip(st, rst))
        nseg = -(-n // segment_tokens(b * hkv_, d_, d_, p))
        tag = (f"hybrid p={p} {str(dtype)[6:]} B={b} Hq={hq_} Hkv={hkv_} "
               f"D={d_} N={n} window {window} at chunk {chunk} (w_eff "
               f"{band_width(window, chunk, n)})" + (" mask" if cut else "")
               + f", {nseg} segment(s)")
        print(f"  {tag}: o max abs err {eo:.3e} (tol {o_tol(dtype)}), "
              f"moments max rel err {em:.3e} (tol {TOL_MOMENTS:.0e})")
        if not (o_ok and em <= TOL_MOMENTS):
            fail(f"{tag}: the hybrid kernel disagrees with its plain version")
        return eo, (q, k, v), nseg

    with torch.inference_mode():
        hy_err = {}
        for dtype in (torch.float32, torch.bfloat16):
            # the bf16 inputs at qwen3's shapes stay for the timing below
            hy_err[dtype], (q, k, v), _ = hy_case(B, hq, hkv, P, d, dtype,
                                                  HW, HC)
            hy_case(2, hq, hkv, 1000, d, dtype, HW, HC, cut=137)
            hy_case(B, wh, wh, 512, wd, dtype, HW, HC)
            # bands past the kernel's chunk L = 128: w_eff 200 (the first
            # two chunks take no slot) and 300 > 2L (three; band-only rows
            # past L, summed pair by pair from token 0)
            hy_case(2, hq, hkv, P, d, dtype, 200, 256)
            hy_case(2, hq, hkv, P, d, dtype, 300, 512)
            # two segments of the two launches (3840 tokens each at B=2):
            # the second's first band reaches back into the first
            _, _, nseg = hy_case(2, hq, hkv, 4096, d, dtype, HW, HC, cut=137)
            if nseg != 2:
                fail(f"the hybrid kernel at B=2 N=4096 ran in {nseg} "
                     f"segments, not 2")
        hy_case(2, hq, hkv, P, d, torch.float32, HW, HC, p=1)
        hy_ms = sync_ms(lambda: hybrid_causal_cuda(
            q, k, v, window=HW, chunk_size=HC, return_state=True), reps=5)
        hy_plain = sync_ms(lambda: hybrid_causal_ref(
            q, k, v, window=HW, chunk_size=HC, return_state=True), reps=3)
        # its two launches apart (launch A is the prefill's), and two
        # calls' bits
        w_eff = band_width(HW, HC, P)
        call = prefill_call(q, k, v, p=2, band=w_eff)
        call.run()
        hy_prefix_ms = sync_ms(call.prefix, reps=5)
        hy_combine_ms = sync_ms(call.combine, reps=5)
        hy_ws, hy_nseg = call.workspace_bytes, len(call.segments)
        del call
        o1, s1 = hybrid_causal_cuda(q, k, v, window=HW, chunk_size=HC,
                                    return_state=True)
        o2, s2 = hybrid_causal_cuda(q, k, v, window=HW, chunk_size=HC,
                                    return_state=True)
        torch.cuda.synchronize()
        hy_same = bool(torch.equal(o1, o2)) and all(
            torch.equal(a, b_) for a, b_ in zip(s1, s2))
        del o1, o2, s1, s2
    if not hy_same:
        fail("two hybrid calls on the same inputs differ")
    if hy_nseg != 1:
        fail(f"the hybrid kernel at the main path's shapes ran in {hy_nseg} "
             f"segments (the launch times above are one segment's)")
    # operations: the prefill's (its in-chunk pairs at BOUND_CHUNK), plus
    # 2(D + Dv) per query head for each band pair before its query's chunk
    # of BOUND_CHUNK (its score and its product with v; a band pair inside
    # that chunk is one of the causal pairs already, weighed exp instead
    # of f); bytes as the prefill's
    def band_pairs(n, w):
        """Pairs (i, j) with 0 <= i - j < w among n consecutive tokens."""
        m = min(n, w)
        return m * n - m * (m - 1) // 2

    far_band = band_pairs(P, w_eff) \
        - (P // BOUND_CHUNK) * band_pairs(BOUND_CHUNK, w_eff) \
        - band_pairs(P % BOUND_CHUNK, w_eff)
    hy_ops = fc_ops + bh * gq * far_band * 2 * (d + d)
    hy_bound = max(fc_bytes / H100_BYTES_PER_S,
                   hy_ops / H100_BF16_FLOPS) * 1e3
    del q, k, v
    torch.cuda.empty_cache()
    print(f"  timing (hybrid, bf16 B={B} N={P} w_eff={w_eff}): kernel "
          f"{hy_ms:.3f} ms (plain {hy_plain:.3f}, bound {hy_bound:.3f} "
          f"bf16-peak / {hy_ops / H100_F32_FLOPS * 1e3:.3f} f32-peak, "
          f"{hy_ops / hy_ms / 1e9:.2f} TFLOP/s); prefix-moments launch "
          f"{hy_prefix_ms:.3f} ms, band combine launch {hy_combine_ms:.3f} "
          f"ms, workspace {hy_ws / 1e9:.3f} GB; two calls bitwise equal (o "
          f"and state): {hy_same}")
    phase("hybrid kernels", "the hybrid kernel agrees with its plain version "
          "(f32, bf16; qwen3 widths, mask, D=64 G=1, bands of 200 and 300 "
          "past the kernel's chunk, B=2 N=4096 in two segments; p=1); two "
          "calls equal bit for bit")

    # ---- 14. hybrid training: full-width qwen3-1.7b, bf16 ----
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import _layer

    hcfg = dataclasses.replace(tcfg, attn=AttentionSpec.parse(
        "hybrid2-kernel"))
    hplain = dataclasses.replace(tcfg, attn=AttentionSpec.parse(
        "hybrid2-chunked"))
    params = init_model(hcfg, seed=0, device=dev)
    # (a) the attention op at layer 0's own inputs at these weights, in
    # float32: kernel path (ops.hybrid) against the plain path, o and
    # grads; and the largest band score there (exp overflows float32 above
    # ln(max float32))
    from repro_torch.core.hybrid import hybrid_causal_chunked

    with torch.no_grad():
        layer0 = _layer(params["blocks_0"], 0)
        x0 = params["embed"][tbatch["tokens"]].to(hcfg.adtype())
        h0 = L.apply_norm(layer0["norm1"], x0, norm_type=hcfg.norm_type,
                          eps=hcfg.norm_eps)
        pos = torch.arange(P, dtype=torch.int32, device=dev)
        q0, k0, v0 = (t.float() for t in L._project_qkv(
            layer0["mixer"], h0, hcfg, pos))
        q0, k0 = normalize_qk(q0), normalize_qk(k0)
        s0 = torch.einsum("bhgnd,bhmd->bhgnm",
                          q0.reshape(B, hkv, gq, P, d), k0)
        ii = torch.arange(P, device=dev)
        in_band = (ii[:, None] >= ii[None, :]) & (ii[:, None] - ii[None, :]
                                                  < w_eff)
        band_max = s0.masked_fill(~in_band, float("-inf")).max().item()
        del s0, x0, h0, layer0
    do0 = randn(B, hq, P, d)
    xk = [t.clone().requires_grad_(True) for t in (q0, k0, v0)]
    xp = [t.clone().requires_grad_(True) for t in (q0, k0, v0)]
    o0 = ops.hybrid(*xk, window=HW, chunk_size=HC)
    g0k = torch.autograd.grad(o0, xk, do0)
    r0 = hybrid_causal_chunked(*xp, window=HW, chunk_size=HC)
    g0p = torch.autograd.grad(r0, xp, do0)
    e_o0, o0_ok = o_err(o0.detach(), r0.detach())
    e_g0 = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
               for a, b in zip(g0k, g0p))
    del q0, k0, v0, xk, xp, o0, r0, g0k, g0p, do0
    exp_limit = math.log(torch.finfo(torch.float32).max)
    print(f"  layer 0 inputs (f32): o max abs err {e_o0:.3e} (tol "
          f"{TOL_O32:.0e}), dq/dk/dv max err {e_g0:.3e} of scale (tol "
          f"{TOL_GRAD:.0e}); largest band score {band_max:.2f} (float32 exp "
          f"overflows above {exp_limit:.2f})")
    if not (o0_ok and e_g0 <= TOL_GRAD):
        fail("hybrid train: the kernel path's attention disagrees with the "
             "plain path's at layer 0's inputs")
    # (b) the whole model in float32 from one set of seeded weights: the
    # loss on the kernel and plain paths (and, as a reading of what the
    # limit sees, on fastmax2-chunked: the same model without the band)
    from repro_torch.models import model_loss

    h32 = dataclasses.replace(hcfg, param_dtype="float32",
                              activ_dtype="float32")
    p32 = init_model(h32, seed=0, device=dev)
    with torch.no_grad():
        ops.reset_launch_counts()
        l32k = model_loss(p32, tbatch, h32)[0].item()
        l32_launches = ops.launch_counts()["hybrid_causal"]
        l32p = model_loss(p32, tbatch, dataclasses.replace(
            h32, attn=hplain.attn))[0].item()
        l32f = model_loss(p32, tbatch, dataclasses.replace(
            h32, attn=AttentionSpec.parse("fastmax2-chunked")))[0].item()
        # and the plain path at chunk 256 (the same band of 64, summed in
        # another order): how far float32 rounding alone moves this loss
        l32c = model_loss(p32, tbatch, dataclasses.replace(
            h32, attn=hplain.attn, chunk_size=256))[0].item()
        # the bf16 model's loss gap, printed only (see TRAIN_LOSS_TOL's
        # note above the hybrid phase)
        l16k = model_loss(params, tbatch, hcfg)[0].item()
        l16p = model_loss(params, tbatch, hplain)[0].item()
    del p32
    torch.cuda.empty_cache()
    d32 = abs(l32k - l32p)
    print(f"  parity before any update (f32 model): loss kernel {l32k:.6f} "
          f"plain {l32p:.6f} |diff| {d32:.3e} (tol {TRAIN_LOSS_TOL}), "
          f"{l32_launches} hybrid launches; plain at chunk 256 "
          f"{l32c:.6f}, |diff| {abs(l32c - l32p):.3e} (not held); without "
          f"the band (fastmax2-chunked) {l32f:.6f}, |diff| "
          f"{abs(l32f - l32p):.3e}; "
          f"bf16 model: loss kernel {l16k:.5f} plain {l16p:.5f} |diff| "
          f"{abs(l16k - l16p):.3e} (not held)")
    if not (math.isfinite(l32k) and math.isfinite(l16k)
            and d32 <= TRAIN_LOSS_TOL and l32_launches == hcfg.n_layers):
        fail("hybrid train: kernel and plain losses disagree (f32 model)")

    _, opt = pick_optimizer(hcfg, count_params(params), lr=3e-4,
                            total_steps=1 + n_steps)
    opt_state = opt[0](params)
    train_step = make_train_step(hcfg, opt)
    params, opt_state, m = train_step(params, opt_state, batch)   # warm-up
    hlosses = [m["loss"].item()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hstep_ms, hlaunches = [], []
    want_h = {k_: 0 for k_ in want_t}
    want_h["hybrid_causal"] = 2 * hcfg.n_layers
    for _ in range(n_steps):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ops.reset_launch_counts()
        ev0.record()
        params, opt_state, m = train_step(params, opt_state, batch)
        ev1.record()
        ev1.synchronize()
        hlaunches.append(ops.launch_counts())
        hstep_ms.append(ev0.elapsed_time(ev1))
        hlosses.append(m["loss"].item())
    hpeak = torch.cuda.max_memory_allocated() / 1e9
    if any(c != want_h for c in hlaunches):
        fail(f"hybrid train launch counts {hlaunches}, expected {want_h} "
             f"per step")
    if not (all(math.isfinite(x) for x in hlosses)
            and math.isfinite(m["gnorm"].item())
            and hlosses[-1] < hlosses[0]):
        fail(f"hybrid train: loss did not fall on a fixed batch: {hlosses}")
    hmed = sorted(hstep_ms)[len(hstep_ms) // 2]
    phase("hybrid train", f"qwen3-1.7b hybrid2-kernel (w_eff {w_eff}) bf16 "
          f"remat=full AdamW B={B} N={P}: step ms "
          f"{', '.join(f'{x:.1f}' for x in hstep_ms)} (CUDA events), "
          f"{B * P / (hmed / 1e3):.1f} tokens/s at the median, peak "
          f"{hpeak:.2f} GB, loss {', '.join(f'{x:.4f}' for x in hlosses)}, "
          f"launches per step {hlaunches[-1]}")
    del params, opt_state, train_step, opt
    torch.cuda.empty_cache()

    # ---- 15. hybrid smoke config in float32: kernel and plain grads ----
    hsmall = dataclasses.replace(small, attn=AttentionSpec.parse(
        "hybrid2-kernel"))
    hsmall_plain = dataclasses.replace(small, attn=AttentionSpec.parse(
        "hybrid2-chunked"))
    sparams = init_model(hsmall, seed=0, device=dev)
    slk, sgk = loss_and_grads(sparams, sb, hsmall)
    slp, sgp = loss_and_grads(sparams, sb, hsmall_plain)
    sleaf, serr = worst_leaf(sgk, sgp)
    phase("hybrid small", f"smoke config f32 N=256: loss |kernel - plain| "
          f"{abs(slk.item() - slp.item()):.3e}, worst leaf {sleaf} "
          f"|g_k - g_p|/|g_p| {serr:.3e} (tol {SMOKE_GRAD_TOL:.0e})")
    if not serr <= SMOKE_GRAD_TOL:
        fail("hybrid smoke train: kernel and plain grads disagree")
    del sparams

    # ---- 16. hybrid serving: full-width qwen3-1.7b, bf16 ----
    # a fresh prefill runs the hybrid kernel once per layer; the decode
    # steps run the plain two-leg step (as the reference)
    hs_cfg = dataclasses.replace(cfg, attn=AttentionSpec.parse(
        "hybrid2-kernel"))
    params = init_model(hs_cfg, seed=0, device=dev)
    hprompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                             device=dev)
    generate(params, hs_cfg, hprompts, G, device=dev)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    hs_timings = {}
    t0 = time.monotonic()
    htoks = generate(params, hs_cfg, hprompts, G, device=dev,
                     timings=hs_timings)
    torch.cuda.synchronize()
    hs_total = time.monotonic() - t0
    hs_launches = ops.launch_counts()
    hs_peak = torch.cuda.max_memory_allocated() / 1e9
    want_hs = {k_: 0 for k_ in hs_launches}
    want_hs["hybrid_causal"] = hs_cfg.n_layers
    if hs_launches != want_hs:
        fail(f"hybrid serve launch counts {hs_launches}, expected {want_hs}")
    if tuple(htoks.shape) != (B, G) or not bool(
            ((htoks >= 0) & (htoks < cfg.vocab_size)).all()):
        fail(f"hybrid serve: bad tokens {tuple(htoks.shape)}")
    del params
    torch.cuda.empty_cache()
    # the smoke config in float32: the same greedy tokens on the kernel
    # and the plain (hybrid2-chunked) path
    sparams = init_model(hsmall, seed=0, device=dev)
    sprompts = torch.randint(0, small.vocab_size, (2, 40), generator=gen,
                             device=dev)
    with torch.inference_mode():
        stk = generate(sparams, hsmall, sprompts, 8, device=dev)
        stp = generate(sparams, hsmall_plain, sprompts, 8, device=dev)
    hs_same = bool((stk == stp).all())
    hs_prefill = hs_timings["prefill_ms"]
    hs_decode = hs_timings["decode_ms"] / hs_timings["decode_steps"]
    phase("hybrid serve", f"qwen3-1.7b hybrid2-kernel bf16 B={B} P={P} "
          f"G={G}: {hs_total:.3f}s total, prefill {hs_prefill:.1f} ms, "
          f"decode {hs_decode:.2f} ms/token (CUDA events inside the call), "
          f"{B * G / hs_total:.1f} tok/s, peak {hs_peak:.2f} GB, launches "
          f"{hs_launches}; smoke config f32 greedy tokens kernel == plain: "
          f"{hs_same}")
    if not hs_same:
        fail("hybrid serve: the smoke model's greedy tokens differ between "
             "the kernel and plain paths")

    kernels = [
        {"name": "fastmax_causal_prefill", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fastmax_causal.cu",
         "replaces": "src/repro/kernels/fastmax_causal.py:189",
         "launches": launches["fastmax_causal"], "max_abs_err": fc_err,
         "ms": fc_ms, "plain_ms": fc_plain, "bound_ms": fc_bound,
         "bound_by": "operations" if fc_ops / H100_BF16_FLOPS
         >= fc_bytes / H100_BYTES_PER_S else "bytes",
         "library_ms": None, "prefix_ms": fc_prefix_ms,
         "combine_ms": fc_combine_ms, "chunk": CHUNK,
         "workspace_bytes": ws_bytes,
         "call_peak_bytes": call_peak},
        {"name": "fastmax_decode_step", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fastmax_decode.cu",
         "replaces": "src/repro/kernels/fastmax_decode.py:81",
         "launches": launches["fastmax_decode"], "max_abs_err": fd_err,
         "ms": fd_ms, "plain_ms": fd_plain, "bound_ms": fd_bound,
         "bound_by": "bytes" if fd_bytes / H100_BYTES_PER_S
         >= fd_ops / H100_F32_FLOPS else "operations",
         "library_ms": None},
        {"name": "fastmax_causal_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fastmax_causal_bwd.cu",
         "replaces": "src/repro/kernels/fastmax_causal_bwd.py:280",
         "launches": train_launches[-1]["fastmax_causal_bwd"],
         "max_abs_err": fb_err, "ms": fb_ms, "plain_ms": fb_plain,
         "bound_ms": fb_bound,
         "bound_by": "operations" if fb_ops / H100_BF16_FLOPS
         >= fb_bytes / H100_BYTES_PER_S else "bytes",
         "library_ms": None, "slots_ms": fb_parts["slots"],
         "queries_ms": fb_parts["queries"], "cot_ms": fb_parts["cot"],
         "keys_ms": fb_parts["keys"], "chunk": cb,
         "workspace_bytes": bws_bytes, "call_peak_bytes": bwd_peak},
        {"name": "fastmax_noncausal_moments", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fastmax_noncausal.cu",
         "replaces": "src/repro/kernels/fastmax_noncausal.py:160",
         "launches": enc_launches["fastmax_noncausal_moments"]
         + gen_launches["fastmax_noncausal_moments"],
         # the six moments' max |kernel - plain| (M=1500, bf16 inputs)
         "max_abs_err": nc_err[(torch.bfloat16, WM)][1], "ms": nm_ms,
         "plain_ms": nm_plain, "bound_ms": nm_bound,
         "bound_by": "operations" if nm_ops / H100_BF16_FLOPS
         >= nm_bytes / H100_BYTES_PER_S else "bytes",
         "library_ms": None},
        # timed at N=1500 (encoder); the *_n128 keys are the prefill's
        # cross-attention, the *_n1 keys the decode steps'
        {"name": "fastmax_noncausal_combine", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fastmax_noncausal.cu",
         "replaces": "src/repro/kernels/fastmax_noncausal.py:192",
         "launches": enc_launches["fastmax_noncausal_combine"]
         + gen_launches["fastmax_noncausal_combine"],
         "max_abs_err": max(nc_err[(torch.bfloat16, n)][0]
                            for n in (WM, 1)),
         "ms": nc_ms, "plain_ms": nc_plain, "bound_ms": nc_bound,
         "bound_by": "operations" if nc_ops / H100_BF16_FLOPS
         >= nc_bytes / H100_BYTES_PER_S else "bytes",
         "library_ms": None,
         "ms_n128": n128_ms, "plain_ms_n128": n128_plain,
         "bound_ms_n128": n128_bound,
         "bound_by_n128": "operations" if n128_ops / H100_BF16_FLOPS
         >= n128_bytes / H100_BYTES_PER_S else "bytes",
         "ms_n1": n1_ms, "plain_ms_n1": n1_plain, "bound_ms_n1": n1_bound,
         "bound_by_n1": "operations" if n1_ops / H100_BF16_FLOPS
         >= n1_bytes / H100_BYTES_PER_S else "bytes"},
        # timed at qwen3's training shapes; launches per train step (and
        # per hybrid generate(): launches_serve)
        {"name": "hybrid_causal", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fastmax_causal.cu",
         "replaces": "src/repro/kernels/hybrid_causal.py:182",
         "launches": hlaunches[-1]["hybrid_causal"],
         "max_abs_err": hy_err[torch.bfloat16], "ms": hy_ms,
         "plain_ms": hy_plain, "bound_ms": hy_bound,
         "bound_by": "operations" if hy_ops / H100_BF16_FLOPS
         >= fc_bytes / H100_BYTES_PER_S else "bytes",
         "library_ms": None, "prefix_ms": hy_prefix_ms,
         "combine_ms": hy_combine_ms, "chunk": CHUNK,
         "workspace_bytes": hy_ws,
         "launches_serve": hs_launches["hybrid_causal"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
