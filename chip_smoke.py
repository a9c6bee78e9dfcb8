"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases, one line each (then a JSON line of kernel numbers, the card's name
and power limit, and the result line last):
  1. device   — needs CUDA; TF32 off for float32 products.
  2. build    — compiles both CUDA kernels from src/repro_torch/kernels/csrc
                with nvcc (one process per source, in parallel).
  3. kernels  — each kernel against its plain PyTorch version at the model's
                widths (B=2, Hq=16, Hkv=8, D=Dv=128, p=2): prefill N=1024,
                and N=1000 with a ragged kv_mask and an init_state, float32
                and bfloat16 inputs, o and all six final moments; then 64
                chained decode steps from that state.
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
    with torch.inference_mode():
        b, hq, hkv, d, dv, p = 2, 16, 8, 128, 128, 2
        for dtype in (torch.float32, torch.bfloat16):
            for n, ragged in ((1024, False), (1000, True)):
                q = normalize_qk(randn(b, hq, n, d)).to(dtype)
                k = normalize_qk(randn(b, hkv, n, d)).to(dtype)
                v = randn(b, hkv, n, dv).to(dtype)
                mask, init = None, None
                if ragged:
                    lens = torch.tensor([n, n - 137], device=dev)
                    mask = (torch.arange(n, device=dev)[None, None, :]
                            < lens[:, None, None]).float().expand(b, hkv, n)
                    _, init = fastmax_causal_ref(
                        normalize_qk(randn(b, hq, 200, d)),
                        normalize_qk(randn(b, hkv, 200, d)),
                        randn(b, hkv, 200, dv), p=p, chunk_size=512)
                o, st = fastmax_causal_cuda(q, k, v, mask, p=p,
                                            init_state=init)
                ro, rst = fastmax_causal_ref(q, k, v, mask, p=p,
                                             chunk_size=512, init_state=init)
                torch.cuda.synchronize()
                eo, o_ok = o_err(o, ro)
                em = max(moment_err(a, r) for a, r in zip(st, rst))
                tag = f"prefill {str(dtype)[6:]} N={n}" + (
                    " mask+init" if ragged else "")
                print(f"  {tag}: o max abs err {eo:.3e} (tol {o_tol(dtype)}"
                      f"), moments max rel err {em:.3e} (tol "
                      f"{TOL_MOMENTS:.0e})")
                if not (o_ok and em <= TOL_MOMENTS):
                    fail(f"{tag} kernel disagrees with its plain version")
                if ragged:
                    # 64 chained decode steps from this state, in lockstep
                    kst = tuple(t.clone() for t in st)
                    eo_d, ok_d, pst = decode_lockstep(
                        b, hq, hkv, d, dv, dtype, kst,
                        tuple(t.clone() for t in rst), 64)
                    em_d = max(moment_err(a, r) for a, r in zip(kst, pst))
                    print(f"  decode {str(dtype)[6:]} 64 steps: o max abs err "
                          f"{eo_d:.3e} (tol {o_tol(dtype)}), state max rel "
                          f"err {em_d:.3e} (tol {TOL_MOMENTS:.0e})")
                    if not (ok_d and em_d <= TOL_MOMENTS):
                        fail(f"decode {dtype}: kernel disagrees with its "
                             f"plain version")
        phase("kernels", "prefill (f32, bf16; plain and mask+init) and 64 "
              "decode steps agree with their plain versions")

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
        want = {"fastmax_causal": cfg.n_layers,
                "fastmax_decode": cfg.n_layers * (G - 1)}
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
        print(f"  timing: prefill kernel {fc_ms:.3f} ms (plain {fc_plain:.3f}"
              f", bound {fc_bound:.3f} bf16-peak / "
              f"{fc_ops / H100_F32_FLOPS * 1e3:.3f} f32-peak, "
              f"{fc_ops / fc_ms / 1e9:.2f} TFLOP/s); decode kernel "
              f"{fd_ms:.4f} ms (plain {fd_plain:.4f}, bound {fd_bound:.4f}, "
              f"{fd_bytes / fd_ms / 1e6:.0f} GB/s)")

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
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
