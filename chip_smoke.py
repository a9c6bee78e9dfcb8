"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases, one line each (then a JSON line of kernel numbers, the card's name
and power limit, and the result line last):
  1. device   — needs CUDA; TF32 off for float32 products.
  2. build    — compiles the four CUDA kernels from
                src/repro_torch/kernels/csrc with nvcc (one process per
                source, in parallel).
  3. kernels  — each kernel against its plain PyTorch version, float32 and
                bfloat16 inputs, o and all six final moments, p=2: at
                qwen3's widths (B=2, Hq=16, Hkv=8, D=Dv=128) prefill
                N=1024, and N=1000 with a ragged kv_mask and an init_state,
                then 64 chained decode steps from that state; at whisper's
                decoder widths (B=4, Hq=Hkv=12, D=Dv=64) prefill N=128 and
                N=120 with mask and init_state, each followed by 31 chained
                decode steps.
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
                their plain versions and their bounds.
  7. bwd      — the §2.5 backward kernel against its plain version
                (D=Dv=128, Hq=16, Hkv=8), float32 and bfloat16: p=2 at B=2
                N=1024, at B=2 N=1000 on a forward seeded from an
                init_state with return_dstate (all six dstate moments), at
                B=4 N=1024 (the training path's shapes, then timed), and
                one p=1 case; dq, dk, dv row by row past the kernel's
                first chunk, that chunk's rows against float64.
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
                qwen3's (B=2, Hq=16, Hkv=8, D=Dv=128, N=M=1024) and one p=1
                case on q̂/D.
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
                combine at N=1500 and N=1).
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
# whisper phase, the prefill's last logit row on the kernel and the plain
# (fastmax2-chunked) path from one set of bf16 weights and frames: the two
# paths round their bf16 attention outputs at different places through 12
# encoder and 12 decoder layers. Measured on an H100: 4.69e-2 and 4.30e-2
# (two draws of frames and prompts); the limit is about four times that
WHISPER_LOGIT_TOL = 0.2      # absolute, max over the last row's logits


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
                                                    pick_chunk)
    from repro_torch.kernels.fastmax_causal_bwd import (
        fastmax_causal_bwd_cuda, fastmax_causal_bwd_ref, kernel_chunk)
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
        phase("kernels", "prefill (f32, bf16; plain and mask+init) and "
              "chained decode steps agree with their plain versions at "
              "qwen3's and whisper's widths")

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
                "fastmax_noncausal_combine": 0}
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

        # timed in bf16, the main path's dtype (the last loop's inputs)
        fc_ms = sync_ms(lambda: fastmax_causal_cuda(q, k, v, p=2), reps=5)
        fc_plain = sync_ms(lambda: fastmax_causal_ref(q, k, v, p=2,
                                                      chunk_size=512), reps=3)
        del rc_o
        gq = hq // hkv
        c = pick_chunk(gq, d, build.load("fastmax_causal")
                       .fastmax_causal_smem_bytes)
        bh = B * hkv
        # operations the function needs, per (b, kv-head): m2 and g2 are
        # symmetric in (a, b), as is q_a q_b, so the degree-2 combine and
        # fold need D(D+1)/2 rows, not D^2; plus the degree-0/1 terms and
        # the causal intra-chunk block at the kernel's chunk c
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
    cb = kernel_chunk(gq, d)

    def bwd_case(b, n, dtype, p, seeded):
        # at p=1, f(s) = 1 + s is sign-indefinite at the model's scale
        # (|s| up to D): denominators can nearly cancel, and which
        # float32 summation order lands nearer float64 is luck; q̂/D
        # keeps |s| <= 1 and f >= 0
        qs = 1.0 / d if p == 1 else 1.0
        q = (normalize_qk(randn(b, hq, n, d)) * qs).to(dtype)
        k = normalize_qk(randn(b, hkv, n, d)).to(dtype)
        v = randn(b, hkv, n, d).to(dtype)
        do = randn(b, hq, n, d).to(dtype)
        init = None
        if seeded:
            _, init = fastmax_causal_ref(
                normalize_qk(randn(b, hq, 200, d)) * qs,
                normalize_qk(randn(b, hkv, 200, d)),
                randn(b, hkv, 200, d), p=p, chunk_size=512)
        _, state = fastmax_causal_cuda(q, k, v, p=p, init_state=init)
        got = fastmax_causal_bwd_cuda(q, k, v, state, do, p=p,
                                      return_dstate=seeded)
        ref = fastmax_causal_bwd_ref(q, k, v, state, do, p=p,
                                     chunk_size=cb, return_dstate=seeded)
        exact = fastmax_causal_bwd_ref(
            q.double(), k.double(), v.double(),
            [t.double() for t in state], do.double(), p=p, chunk_size=cb,
            return_dstate=seeded)
        torch.cuda.synchronize()

        def flat(r):
            return list(r[:3]) + (list(r[3]) if seeded else [])

        # a seeded forward's carry before chunk 0 is the seed, not a
        # near-zero rebuild: every row is held to the tight limit
        first = 0 if seeded else cb
        errs = [grad_err(a, r, e, first)
                for a, r, e in zip(flat(got), flat(ref), flat(exact))]
        del exact
        tag = (f"bwd p={p} {str(dtype)[6:]} B={b} N={n}"
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
        return whole, (q, k, v, state, do)

    for dtype in (torch.float32, torch.bfloat16):
        bwd_case(2, 1024, dtype, 2, False)
        bwd_case(2, 1000, dtype, 2, True)
    bwd_case(2, 1000, torch.float32, 1, True)
    bwd_case(4, P, torch.float32, 2, False)
    fb_err, bargs = bwd_case(4, P, torch.bfloat16, 2, False)
    phase("bwd", "backward kernel agrees with its plain version (p=2 "
          "f32/bf16 at B=2 N=1024, B=2 N=1000 seeded with dstate, "
          "B=4 N=1024; p=1 seeded)")
    bq, bk, bv, bst, bdo = bargs
    fb_ms = sync_ms(lambda: fastmax_causal_bwd_cuda(bq, bk, bv, bst, bdo,
                                                    p=2), reps=3)
    fb_plain = sync_ms(lambda: fastmax_causal_bwd_ref(
        bq, bk, bv, bst, bdo, p=2, chunk_size=512), reps=2)
    pairs_b = (P // cb) * cb * (cb + 1) // 2 \
        + (P % cb) * (P % cb + 1) // 2
    # per (b, kv-head): the six degree-2 passes on the symmetric half
    # (g2 and gg2 ride along as one more column, as in the forward's
    # count), the degree-0/1 terms of the same six passes, and six
    # products per causal pair inside the kernel's chunks (scores, F.v,
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
          f"(plain {fb_plain:.3f}, bound {fb_bound:.3f} bf16-peak / "
          f"{fb_ops / H100_F32_FLOPS * 1e3:.3f} f32-peak, "
          f"{fb_ops / fb_ms / 1e9:.2f} TFLOP/s, chunk {cb})")
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
              "fastmax_noncausal_moments": 0, "fastmax_noncausal_combine": 0}
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

    def nc_case(b, hq, hkv, n, m, d, dtype, p=2):
        """Both launches against their plain versions on one input: (o max
        abs error, the moments' max abs error, the inputs, the kernel's and
        the plain moments)."""
        # at p=1 the queries are q̂/D (|s| <= 1, f >= 0; see bwd_case)
        qs = 1.0 / d if p == 1 else 1.0
        q = (normalize_qk(randn(b, hq, n, d)) * qs).to(dtype)
        k = normalize_qk(randn(b, hkv, m, d)).to(dtype)
        v = randn(b, hkv, m, d).to(dtype)
        mom = noncausal_moments_cuda(k, v, p=p)
        rmom = noncausal_moments_ref(k, v, p=p)
        o = noncausal_combine_cuda(q, mom, p=p)
        ro = noncausal_combine_ref(q, rmom, p=p)
        torch.cuda.synchronize()
        eo, o_ok = o_err(o, ro)
        em = max(moment_err(a, r) for a, r in zip(mom, rmom))
        em_abs = max((a - r).abs().max().item() for a, r in zip(mom, rmom))
        tag = (f"nc p={p} {str(dtype)[6:]} B={b} Hq={hq} Hkv={hkv} D={d} "
               f"N={n} M={m}")
        print(f"  {tag}: o max abs err {eo:.3e} (tol {o_tol(dtype)}), "
              f"moments max rel err {em:.3e} (tol {TOL_MOMENTS:.0e}; max "
              f"abs err {em_abs:.3e})")
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
    torch.cuda.empty_cache()
    phase("nc kernels", "moments and combine agree with their plain versions "
          f"(f32, bf16; whisper widths N={WM}, 128, 1 against M={WM}; qwen3 "
          f"widths N=M={P}; p=1)")

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
                  "fastmax_noncausal_combine": wcfg.encoder_layers}
        want_g = {"fastmax_causal": WL, "fastmax_causal_bwd": 0,
                  "fastmax_decode": WL * (WG - 1),
                  "fastmax_noncausal_moments": WL * WG,
                  "fastmax_noncausal_combine": WL * WG}
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
        nm_ms = sync_ms(lambda: noncausal_moments_cuda(k, v, p=2), reps=10)
        nm_plain = sync_ms(lambda: noncausal_moments_ref(k, v, p=2), reps=5)
        nc_ms = sync_ms(lambda: noncausal_combine_cuda(q, mom, p=2), reps=10)
        nc_plain = sync_ms(lambda: noncausal_combine_ref(q, rmom, p=2),
                           reps=5)
        n1_ms = sync_ms(lambda: noncausal_combine_cuda(q1, mom, p=2),
                        reps=50)
        n1_plain = sync_ms(lambda: noncausal_combine_ref(q1, rmom, p=2),
                           reps=20)
    # per (b, head): each feature row (the constant, the linear ones, the
    # pairs a <= b) is one FMA per value column and one for the g column;
    # bytes: k, v read and the moments written; q read, the feature rows
    # of the moments read and o written
    nm_ops = bhw * WM * rows * 2 * (wd + 1)
    nm_bytes = (k.numel() + v.numel()) * 2 + sum(t.numel() for t in mom) * 4

    def combine_bound(n):
        ops_ = bhw * n * rows * 2 * (wd + 1)
        bytes_ = 2 * bhw * n * wd * 2 + bhw * rows * (wd + 1) * 4
        return ops_, bytes_, max(ops_ / H100_BF16_FLOPS,
                                 bytes_ / H100_BYTES_PER_S) * 1e3

    nm_bound = max(nm_ops / H100_BF16_FLOPS,
                   nm_bytes / H100_BYTES_PER_S) * 1e3
    nc_ops, nc_bytes, nc_bound = combine_bound(WM)
    n1_ops, n1_bytes, n1_bound = combine_bound(1)
    print(f"  timing (nc, bf16 B={B} H={wh} D={wd} M={WM}): moments "
          f"{nm_ms:.3f} ms (plain {nm_plain:.3f}, bound {nm_bound:.4f}, "
          f"{nm_ops / nm_ms / 1e9:.2f} TFLOP/s); combine N={WM} {nc_ms:.3f} "
          f"ms (plain {nc_plain:.3f}, bound {nc_bound:.4f}, "
          f"{nc_ops / nc_ms / 1e9:.2f} TFLOP/s); combine N=1 {n1_ms:.4f} ms "
          f"(plain {n1_plain:.4f}, bound {n1_bound:.4f}, "
          f"{n1_bytes / n1_ms / 1e6:.0f} GB/s)")
    del q, k, v, q1, mom, rmom
    torch.cuda.empty_cache()

    kernels = [
        {"name": "fastmax_causal_prefill", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fastmax_causal.cu",
         "replaces": "src/repro/kernels/fastmax_causal.py:189",
         "launches": launches["fastmax_causal"], "max_abs_err": fc_err,
         "ms": fc_ms, "plain_ms": fc_plain, "bound_ms": fc_bound,
         "bound_by": "operations" if fc_ops / H100_BF16_FLOPS
         >= fc_bytes / H100_BYTES_PER_S else "bytes",
         "library_ms": None},
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
         "library_ms": None},
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
        # timed at N=1500 (encoder); the *_n1 keys are the decode steps'
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
         "ms_n1": n1_ms, "plain_ms_n1": n1_plain, "bound_ms_n1": n1_bound,
         "bound_by_n1": "operations" if n1_ops / H100_BF16_FLOPS
         >= n1_bytes / H100_BYTES_PER_S else "bytes"},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
