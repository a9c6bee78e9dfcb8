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
                N=4096 (B=2) in two segments of its two launches; then the
                prefill kernel as the engine phase calls it (B=1, qwen3's
                widths): a first chunk from zero moments, a full 512-token
                chunk and the ragged last chunk of an engine prompt (at its
                own length, no mask) each resumed from the carry of the 512
                tokens before it, and a 512-token chunk with a contiguous
                tail mask from that carry.
  4. small    — the smoke config in float32: kernel path and plain path give
                the same greedy tokens and close prefill logits.
  5. main     — full-width qwen3-1.7b, attn fastmax2-kernel, bfloat16,
                random weights from a seeded generator: generate() at batch
                4, prompt 1024, 32 new tokens (a warm-up call, then a timed
                call whose kernel launches are counted and whose prefill and
                decode are timed inside it), and the prefill's last logit
                row against the plain path.
  5b. engine  — the continuous-batching engine (serve.ServeEngine) on the
                same weights: 8 requests submitted at once into 4 slots
                (prompt lengths from default_rng(0).integers(256, 1025, 8),
                32 new tokens each, max_len 1056, chunks of 512): each
                request's tokens and first-token logit row against
                generate() on its prompt at batch 1 (ENGINE_LOGIT_TOL,
                which also holds generate()'s kernel path against its plain
                path on prompt 0); a
                timed run() with every launch counted (exactly n_layers
                prefill launches per tick with a prefill part and n_layers
                decode launches per tick with a decode part, nothing else),
                tok/s, TTFT, peak memory; a stepped run (ms per tick by its
                parts, launches per tick, slot restores with the save and
                the write-back timed by CUDA events); the same traffic
                on the plain softmax backend; and the float32 smoke model
                (2 slots, 5 requests, 8 new tokens) giving generate()'s
                tokens for every request.
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
                against float64. Then at MLA's widths (D=192, Dv=128;
                deepseek-v2 and kimi-k2): B=2 N=1024 on 8/8 heads in
                float32 and bfloat16, B=2 N=1000 seeded with dstate at
                p=2 and p=1, 16 q on 8 kv heads (G=2); and timed at the
                [moe train] path's own shape (B=2, 128/128 heads, N=1024,
                bf16: 8 segments of one chunk): the call, its four
                launches summed over the segments, plain, the bound, the
                workspace, one call's peak memory, two calls bit for bit.
  8. train    — full-width qwen3-1.7b, attn fastmax2-kernel, bfloat16,
                remat="full", AdamW from pick_optimizer, B=4, N=1024,
                batches from SyntheticLM: one loss and grad on the kernel
                and the plain (fastmax2-chunked) path from the same weights
                (loss difference, worst per-leaf relative grad difference);
                then a warm-up step and 3 timed steps on one batch (CUDA
                events per step; counts reset before each step: exactly
                n_layers backward and 2 n_layers forward launches); loss
                falling; step ms, tokens/s, peak memory. Then remat="dots"
                beside it from the same weights and batch: the loss equal
                and every leaf's grad within REMAT_RTOL/REMAT_ATOL before
                any update, that backward's launches as "full"'s, then a
                warm-up and 3 timed steps (launches per step, step ms,
                peak memory).
  8b. ckpt    — the same training cut to CKPT_LAYERS layers through
                launch/train.py's main (4 steps,
                a checkpoint every 2 updates under build/ckpt_smoke: label
                2 async, label 4 the final blocking save), then the state a
                kill during the final save leaves (label 4 removed, LATEST
                back at 2), then `--resume`: the resumed run's losses at
                steps 2-3 and its final parameters equal the first run's
                bit for bit, exactly 2 n_layers forward and n_layers
                backward launches per step in both runs; the checkpoint's
                GB, the blocking save's s, the async snapshot's ms on the
                loop's thread, the restore's s, and step ms with and
                without a write in flight. The checkpoints are removed at
                the end, pass or fail.
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
 17. sdpa     — torch's scaled_dot_product_attention in bf16 (softmax, the
                attention fastmax replaces) timed at qwen3's causal prefill
                (B=4, 16/8 heads, N=1024, D=128), one decode query against
                1056 keys, and whisper's noncausal N=M=1500 (12 heads,
                D=64); printed beside the fastmax kernels' times as a
                `softmax_sdpa` JSON line.
 18. api      — the attention API's oracle and rowwise backends (plain
                torch; the reference has no kernel for either) at whisper's
                widths (12 heads, G=1, Dv=64; noncausal N=M=256 at D=64,
                causal N=256 at D=32) in float32 against fastmax2-chunked
                and fastmax2-kernel (API_TOL of scale); then rowwise's
                dropout modes from a CUDA torch.Generator: two calls from
                one seed equal bit for bit, the keep share within
                KEEP_SIGMAS standard deviations of 1 - rate.
 19. moe      — MLA's shapes (deepseek-v2: Hkv = Hq = 128, D = 192,
                Dv = 128; B=2, N=1024): the prefill kernel against its
                plain version in float32 and bfloat16 (o and all six
                moments), 31 chained decode steps from its state against
                the plain version's, both timed against their plain
                versions and bounds (the prefill's segments, workspace,
                one call's peak memory, two calls bit for bit); then
                full-width deepseek-v2-236b with one cut, n_layers 60 -> 3
                (dense_0 and two MoE blocks), bf16 weights from a seeded
                generator, fastmax2-kernel: generate() at batch 2, prompt
                1024, 32 new tokens (a warm-up, then a timed call with
                exactly 3 prefill and 93 decode launches and nothing else;
                prefill ms, decode ms per token, tok/s, peak memory);
                prompt 0's last logit row on the kernel and plain paths at
                batch 1 in bf16 (a reading, with the share of router
                choices that differ) and with the weights widened to
                float32 (MLA_F32_LOGIT_TOL).
 19b. moe train — full-width deepseek-v2-236b with one cut, n_layers 60
                -> 1 (its first_k_dense layer: MLA, 128 heads at D=192,
                Dv=128, and the dense SwiGLU), bf16, AdamW, remat none,
                B=2, N=1024, one SyntheticLM batch: the loss and every
                leaf's grad on fastmax2-kernel and the plain
                fastmax2-chunked path before any update (TRAIN_LOSS_TOL,
                TRAIN_GRAD_TOL), then a warm-up and 3 timed steps on each
                path from the same weights (their losses within
                TRAIN_LOSS_TOL; exactly 1 forward and 1 backward launch
                per kernel step); step ms, tokens/s, peak memory, the
                backward kernel's share of the step.
 20. archs    — the six configs added with the MoE family (llama3-405b,
                qwen2.5-32b, granite-20b, chameleon-34b, deepseek-v2-236b,
                kimi-k2-1t-a32b) and the two of the SSM slice
                (jamba-v0.1-52b, xlstm-1.3b): each float32 smoke model's
                greedy tokens equal on the kernel and plain paths; the
                engine's tokens equal generate()'s on the two MoE smoke
                models and, on the staggered ragged traffic of
                tests/test_serve.py's SSM engine test (2 slots, prompts of
                33 and 17 tokens, 5 new tokens), on the two SSM ones; one
                loss and grad of the jamba smoke model on the kernel path
                (its attention layer through the forward and §2.5
                backward kernels) against the plain path, per leaf; then
                the decode kernel at granite-20b's widths (Hq = 48 on one
                kv head, B=4, D=Dv=128): a prefill N=1024 and 32 chained
                steps against the plain version in float32 and bfloat16,
                timed against its plain version and bound.
 21. ssm      — the prefill and decode kernels at jamba's attention shapes
                (G = 4: B=4, Hq=32, Hkv=8, N=1024, D=Dv=128) against their
                plain versions in float32 and bfloat16 (o and all six
                moments, 31 chained decode steps), timed against their
                plain versions and bounds, two calls of each bit for bit;
                then full-width jamba-v0.1-52b with one cut, n_layers 32 ->
                8 (one group of its pattern: 7 Mamba and 1 attention
                layer, 4 MoE and 4 MLP ffns), bf16 weights from a seeded
                generator, fastmax2-kernel: generate() at batch 4, prompt
                1024, 32 new tokens (a warm-up, then a timed call with
                exactly 1 prefill and 31 decode launches and nothing else;
                prefill ms, decode ms per token, tok/s, peak memory, the
                decode-state bytes of the Mamba and attention layers);
                prompt 0's last logit row on the kernel and plain paths at
                batch 1 in bf16 (a reading, with the share of router
                choices that differ) and with the weights widened to
                float32 (JAMBA_F32_LOGIT_TOL); then full-width xlstm-1.3b
                at all 48 layers in bf16: generate() at the same shape
                with no kernel launch (attention-free), and one sLSTM
                layer's sequential prefill and one mLSTM layer's timed on
                the host and on the card.
 22. autotune — the schedule autotuner (kernels/autotune.py): every
                candidate schedule of every gate key (the shapes above:
                qwen3's prefill, decode and hybrid, jamba's G = 4,
                MLA's, granite's G = 48 decode, whisper's noncausal combine
                at N = 1500, 128 and 1) against the plain version in float32
                and bfloat16 at its kernel's limits, two calls bit for bit,
                then timed (autotune.measure: the median of 5 samples of
                back-to-back calls, bf16); per key the default's ms, the
                winner's ms and schedule and their ratio, the winners
                written to build/autotune_cuda.json as measured entries with
                the card's name and power limit. With the autotuner off,
                launch/kernel_digest.py's digests equal the parent's
                (src/repro_torch/launch/kernel_digests.txt). The float32
                smoke model under REPRO_TORCH_AUTOTUNE=1 and a fresh cache
                (build/autotune_smoke.json) gives the plain path's tokens,
                and a second process hits that cache on every lookup.
                Full-width qwen3-1.7b generate() (bf16, B=4, prompt 1024, 32
                new tokens) with the autotuner off, on, on, off: prefill ms
                and decode ms per token as readings, and the tokens that
                differ from the off run's.
 23. shard    — the kernel plans (kernels/sharded.py) on two ranks of a
                gloo group sharing the card (launch/ranks.py spawns them
                after the parent's build; the two-rank phases 23-24e
                share two spawns, `spawn_together`, one for those on
                torch's own allocator and one for those on expandable
                segments, and each phase then checks and prints its
                ranks' results; a phase's seconds are its rank 0's): heads mode at qwen3's layer
                (B=4, 16/8 heads, N=1024, 4 kv heads a rank), feature mode
                at granite's MQA layer (48/1 heads, Dv = 64 a rank), each
                prefill (o, carry), 32 lockstep decode steps and the
                trainable forward and backward; seq mode (cp = 2) at N =
                2048, B = 2 (the ring) and B = 1 (the allgather), forward
                and backward; the hybrid kernel in heads and feature mode,
                forward; float32 and bfloat16, p = 2. Each rank checks its
                shards against one single-process kernel call on the
                whole inputs: o at the o limits, the carry at
                TOL_MOMENTS, grads by shard_grad_err (each shard's first
                chunk against float64); heads mode bit for bit where its
                segments match the single call's. Per rank: the kernels'
                ms, the exchange's ms and bytes per boundary, which ran.
 24. cp train — full-width qwen3-1.7b cut to 2 layers, float32 weights
                and activations, AdamW, B=2, N=2048, remat none: --cp 2
                on two ranks of the card against --cp 1 in one process:
                the loss and per-leaf grads of the seeded weights and 2
                steps' losses (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL), beside
                the same readings of the plain fastmax2-chunked path
                against --cp 1 (a control), exactly 2 prefill and 2 backward
                launches per rank per step, step ms, global tokens/s, peak
                memory per rank, the carry bytes per boundary per layer.
                The mixers without a seq plan, their sequence gathered
                over "seq" (placed.cp_enter / cp_exit), each against
                --cp 1 at TRAIN_LOSS_TOL and TRAIN_GRAD_TOL a leaf: (a)
                the same cut on hybrid2-kernel, 2 AdamW steps, the hybrid
                kernel once a layer a rank in each forward on N = 2048
                whole; (b) on softmax, the seeded weights' loss and
                grads; in the expandable spawn (c) jamba's first two
                layers (mamba:mlp, mamba:moe: 16 experts, top 2, d_ff
                14336), B=1, N=256, and (d) xlstm-1.3b as an mLSTM and
                an sLSTM layer, B=1, N=256, loss and grads; each with
                step (or grad fn) ms, peak GB per rank and at --cp 1,
                launches per rank and the bytes a rank sends a gather.
                Then (e) `torch.distributed.run --nproc-per-node 2 -m
                repro_torch.launch.train --cp 2` on the smoke model
                (fastmax2-kernel) and on smoke jamba, two steps each,
                loss printed. Two ranks share one card: no time here is
                a multi-card speedup.
 24b. placed ssm train / serve — after the placed qwen3 and deepseek-v2
                phases, the SSM mixers split over "model" on (data 1,
                model 2), two ranks: xlstm-1.3b cut to 2 layers (an
                mLSTM and an sLSTM) and jamba's Mamba block (2 x
                "mamba:mlp"), float32, one AdamW step against one
                process's (loss TRAIN_LOSS_TOL, grads and updated
                parameters TRAIN_GRAD_TOL a leaf, no launch, no whole SSM
                leaf gathered over "model"); jamba cut to 5 layers and
                the same xlstm-1.3b, float32, a prefill and 4 decode tokens against one process's generate() (tokens
                equal, exact launches, the SSM decode state at the bytes
                decode_state_shardings plans, half a rank). Step ms,
                prefill ms, decode ms per token, peaks, collectives by
                kind and the scans' operand shapes a rank printed.
 24c. placed kv serve — the softmax KV cache as the rank's block of
                kv_cache_spec on (data 1, model 2), two ranks, float32,
                B=4, a prompt of 1012 tokens and 16 decode tokens at
                max_len 2040: qwen3-1.7b cut to 4 layers (4 of 8 kv heads
                a rank) and granite-20b cut to 2 (1 kv head: rows 0-1019
                on rank 0, 1020-2039 on rank 1, the partial softmaxes
                combined over "model"; the decode crosses ranks at its
                ninth token), against one process's generate(): tokens
                equal, each rank's KV-cache bytes the planned ones (half
                one process's), no whole KV-cache leaf on a rank. Prefill
                ms, decode ms per token, collective bytes and host ms a
                decode step by kind, peaks printed.
 24d. placed hybrid serve — the moment decode states without a decode
                kernel and the hybrid window as the rank's block of
                decode_state_shardings on (data 1, model 2), two ranks,
                float32, hybrid2-kernel, B=4, a prompt of 1024 tokens and
                16 decode tokens: qwen3-1.7b cut to 4 layers (heads mode:
                4 of 8 kv heads a rank in the moments and the window, the
                hybrid kernel's prefill on them) and granite-20b cut to 2
                (1 kv head, feature mode: m0, m1, m2 Dv 64 a rank with g
                whole, the hybrid kernel's prefill on v's Dv slice; the
                window's 64 rows 32 a rank), against one process's
                generate(): tokens equal, each rank's moment and window
                bytes the planned ones (m2 half one process's), no whole
                leaf the plan splits, the hybrid kernel once a layer a
                rank in the prefill (launch counts set to 0 before it).
                The last-row logits' gap to one process, prefill ms,
                decode ms per token, collectives a decode step by kind,
                peaks printed.
 24e. placed whisper — whisper-small's two towers tensor-parallel over
                "model" on (data 1, model 2), two ranks, float32,
                fastmax2-kernel: 6 of 12 heads of every self- and
                cross-attention and 1536 of 3072 ff columns of every GELU
                MLP a rank (the vocab whole). Full-width serving (12 + 12
                layers, B=4, 1500 frames, prompt 128, 16 tokens) against
                one process's encode and generate(): tokens equal, each
                rank's launches one process's (encode and generate, the
                counts set to 0 before each), every attention call on 6
                heads and no whole attention or MLP leaf gathered
                (`mixer_spy`), the last-row logits within PWH_LOGIT_TOL;
                training cut to 2 + 2 layers, B=2, N=128, one AdamW step
                against one process's (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL a
                leaf, the same launches). Encode, prefill and decode ms,
                step ms, peaks, collective bytes and host ms by kind
                printed.
 25. dryrun   — the dry run (launch/dryrun.py) against the real step: full-
                width qwen3-1.7b, fastmax2-kernel, bf16, one device: the
                train step as the train phase runs it (B=4, N=1024, remat
                full, AdamW), a prefill (B=4, P=1024) and one decode step,
                each counted on meta (`run_cell(..., mesh=None)`) and then
                run for real on the card under the same count
                (launch/op_analysis.py) after reset_peak_memory_stats():
                the launches per kernel (28 + 56, 28, 28), each kernel's
                recorded operations and bytes, the matmul flops and the
                argument bytes equal exactly, the executed peak (arguments
                + temp) within DRYRUN_PEAK_TOL of max_memory_allocated(),
                the roofline time printed beside the step's time; then
                `python -m repro_torch.launch.dryrun --arch qwen3-1.7b
                --shape train_1M --cp 16 --attn fastmax2-kernel
                --assert-kernel-route` in a subprocess (the reference's
                dry-run gate cell, started with phase 8 and run on the
                host beside the phases after it) exits 0.
Exits non-zero, printing no result line, when any phase fails.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# the card's constants and each kernel's (operations, bytes), shared with
# the kernel wrappers' launch record and the dry run's roofline
from repro_torch.kernels.work import (  # noqa: E402
    H100_BF16_FLOPS, H100_BYTES_PER_S, H100_F32_FLOPS, H100_TF32_FLOPS,
    bound_ms, bwd_ops, decode_ops, feature_rows, hybrid_ops,
    noncausal_combine_work, noncausal_moments_work, prefill_ops)

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
# engine phase, full-width qwen3-1.7b in bf16: each request's first-token
# logit row from the engine's chunked prefill (chunks of 512 resumed from
# the slot's carry, the ragged last one padded and masked) against
# generate()'s whole-prompt prefill of the same prompt at batch 1. Both
# run the prefill kernel; they round their bf16 activations at different
# places. The limit is about four times the gap between generate()'s
# kernel and plain (fastmax2-chunked) paths on one of the prompts (the
# rule of WHISPER_LOGIT_TOL): measured on an H100, that gap was 1.016e-1
# on prompt 0 and the engine's largest gap to generate() 9.92e-2. The
# kernel-vs-plain gap itself is held to the same limit
ENGINE_LOGIT_TOL = 0.4       # absolute, max over the first-token row
ENGINE_SLOTS, ENGINE_REQUESTS, ENGINE_GEN = 4, 8, 32
ENGINE_PROMPTS = (256, 1025)  # prompt lengths: default_rng(0).integers
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


_PHASE_T = [time.monotonic()]


def phase(name: str, msg: str) -> None:
    """One phase's line, with the seconds since the previous one's."""
    now = time.monotonic()
    print(f"[{name}] {msg} ({now - _PHASE_T[0]:.1f}s)", flush=True)
    _PHASE_T[0] = now


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
    # allow_unused: a config cut to its first_k_dense layers keeps an empty
    # stacked block, which the loss does not use (its grads: zeros)
    grads = torch.autograd.grad(loss, [x for _, x in named],
                                allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, (_, x) in zip(grads, named)]
    for _, x in named:
        x.requires_grad_(False)
    return loss.detach().float(), dict(zip([n for n, _ in named], grads))


def worst_leaf(gk, gp):
    """(leaf, |g_k - g_p| / |g_p|) of the leaf that differs most."""
    errs = {n: ((gk[n].float() - gp[n].float()).norm()
                / gp[n].float().norm().clamp_min(1e-30)).item() for n in gp}
    name = max(errs, key=errs.get)
    return name, errs[name]


def engine_traffic(vocab, lo, hi, n, seed=0):
    """`n` prompts of lengths default_rng(seed).integers(lo, hi, n), their
    tokens drawn from the same generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(m)).astype(np.int32)
            for m in rng.integers(lo, hi, n)]


def engine_run(eng, prompts, gen, on_first=None):
    """Submit every prompt at once and run the engine to the end. Returns
    (tokens per request, FinishedRequest per request, seconds). With
    `on_first`, each request's first-token logit row is kept in it."""
    from repro_torch.serve import RequestStatus

    def first_row(rid, _tok):
        if rid not in on_first:
            on_first[rid] = eng.prefill_row.float().clone()

    torch.cuda.synchronize()
    t0 = time.monotonic()
    rids = [eng.submit(p, gen, callback=None if on_first is None
                       else first_row) for p in prompts]
    outs = eng.run()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    fins = {f.rid: f for f in eng.history if f.rid in rids}
    bad = [(r, str(fins[r].status)) for r in rids
           if fins[r].status is not RequestStatus.FINISHED]
    if bad:
        fail(f"engine: requests did not finish: {bad}")
    if on_first is not None:
        by_index = {i: on_first[r] for i, r in enumerate(rids)}
        on_first.clear()
        on_first.update(by_index)
    return [outs[r] for r in rids], [fins[r] for r in rids], dt


def engine_phase(params, cfg, plain_cfg, dev):
    """The continuous-batching engine at full width (see the docstring's
    phase 5b). Returns its numbers for the JSON lines."""
    import numpy as np

    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_decode_state, init_model
    from repro_torch.models.transformer import lm_prefill
    from repro_torch.serve import ServeEngine

    t_phase = time.monotonic()
    gen = ENGINE_GEN
    max_len = 1024 + gen
    prompts = engine_traffic(cfg.vocab_size, *ENGINE_PROMPTS,
                             ENGINE_REQUESTS)

    def prefill_row(c, prompt):
        st = init_decode_state(c, 1, len(prompt), device=dev)
        logits, _ = lm_prefill(params, torch.as_tensor(
            prompt[None], dtype=torch.int64, device=dev), c, st)
        return logits[0, -1].float()

    # generate() per prompt at batch 1: tokens and first-token rows
    ref_toks, ref_rows = [], []
    for pr in prompts:
        ref_toks.append(generate(params, cfg, torch.as_tensor(
            pr[None], dtype=torch.int64, device=dev), gen, max_len=max_len,
            device=dev)[0].cpu().numpy())
        ref_rows.append(prefill_row(cfg, pr))
    kp_gap = (ref_rows[0] - prefill_row(plain_cfg, prompts[0])).abs() \
        .max().item()
    if not kp_gap <= ENGINE_LOGIT_TOL:
        fail(f"engine: generate()'s first-token row on prompt 0 is "
             f"{kp_gap:.3e} off the plain path's (tol {ENGINE_LOGIT_TOL})")

    eng = ServeEngine(params, cfg, max_slots=ENGINE_SLOTS, max_len=max_len)
    # warm-up run, held against generate()
    rows = {}
    toks, _, _ = engine_run(eng, prompts, gen, on_first=rows)
    row_err = max((rows[i] - ref_rows[i]).abs().max().item()
                  for i in range(len(prompts)))
    same_prefix = [int(np.argmax(np.append(t != r, True)))
                   for t, r in zip(toks, ref_toks)]
    # the timed run(), every kernel launch counted
    ops.reset_launch_counts()
    st0 = eng.stats()
    torch.cuda.reset_peak_memory_stats()
    toks2, fins, dt = engine_run(eng, prompts, gen)
    launches = ops.launch_counts()
    st1 = eng.stats()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pre_ticks = st1["prefill_ticks"] - st0["prefill_ticks"]
    dec_ticks = st1["decode_ticks"] - st0["decode_ticks"]
    want = {k: 0 for k in launches}
    want["fastmax_causal"] = cfg.n_layers * pre_ticks
    want["fastmax_decode"] = cfg.n_layers * dec_ticks
    if launches != want:
        fail(f"engine launch counts {launches}, expected {want}")
    n_tok = sum(len(t) for t in toks2)
    ttft = sorted(f.ttft for f in fins)
    ttft_p50, ttft_p90 = ttft[len(ttft) // 2], ttft[int(0.9 * (len(ttft)
                                                                - 1))]
    # a stepped run: ms per tick by its parts, the launches of every tick,
    # and the slot saves and write-backs around decode parts on the
    # device's clock (CUDA events in stream order: no added waits)
    tick_ms = {"decode": [], "mixed": [], "prefill": []}
    copy_ev = {"save": [], "restore": []}

    def timed(name, fn):
        def run(*args):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args)
            e1.record()
            if args[0]:
                copy_ev[name].append((e0, e1))
            return out
        return run

    eng.slots.save = timed("save", eng.slots.save)
    eng.slots.restore = timed("restore", eng.slots.restore)
    for pr in prompts:
        eng.submit(pr, gen)
    restored0 = eng.stats()["restored_slots"]
    while eng.pending:
        c0, s0 = ops.launch_counts(), eng.stats()
        t0 = time.perf_counter()
        eng.step()
        ms = (time.perf_counter() - t0) * 1e3
        c1, s1 = ops.launch_counts(), eng.stats()
        has_pre = s1["prefill_ticks"] - s0["prefill_ticks"]
        has_dec = s1["decode_ticks"] - s0["decode_ticks"]
        got = {k: c1[k] - c0[k] for k in c1}
        want = {k: 0 for k in c1}
        want["fastmax_causal"] = cfg.n_layers * has_pre
        want["fastmax_decode"] = cfg.n_layers * has_dec
        if got != want:
            fail(f"engine tick launches {got}, expected {want}")
        if has_pre or has_dec:
            tick_ms["mixed" if has_pre and has_dec else
                    "prefill" if has_pre else "decode"].append(ms)
    restored = eng.stats()["restored_slots"] - restored0
    torch.cuda.synchronize()
    copy_ms = {k: sum(a.elapsed_time(b) for a, b in v)
               for k, v in copy_ev.items()}
    del eng.slots.save, eng.slots.restore
    slot_bytes = eng.slots.state_bytes_per_slot()
    del eng
    torch.cuda.empty_cache()

    # the same traffic on softmax (plain torch): the paper's baseline
    sm_cfg = dataclasses.replace(cfg, attn=AttentionSpec.parse("softmax"))
    sm = ServeEngine(params, sm_cfg, max_slots=ENGINE_SLOTS, max_len=max_len)
    engine_run(sm, prompts, gen)
    ops.reset_launch_counts()
    sm_toks, sm_fins, sm_dt = engine_run(sm, prompts, gen)
    if any(ops.launch_counts().values()):
        fail(f"softmax engine launched kernels: {ops.launch_counts()}")
    sm_ttft = sorted(f.ttft for f in sm_fins)[len(sm_fins) // 2]
    sm_bytes = sm.slots.state_bytes_per_slot()
    del sm
    torch.cuda.empty_cache()

    # the float32 smoke model (untied head: its greedy tokens follow the
    # hidden state, where the tied one echoes the last prompt token)
    small = dataclasses.replace(
        get_smoke_config("qwen3-1.7b", tie_embeddings=False),
        attn=AttentionSpec.parse("fastmax2-kernel"))
    sp = init_model(small, seed=0, device=dev)
    s_prompts = engine_traffic(small.vocab_size, 20, 61, 5)
    s_eng = ServeEngine(sp, small, max_slots=2, max_len=60 + 8)
    s_toks, _, _ = engine_run(s_eng, s_prompts, 8)
    s_same = all(np.array_equal(t, generate(
        sp, small, torch.as_tensor(pr[None], dtype=torch.int64, device=dev),
        8, max_len=68, device=dev)[0].cpu().numpy())
        for t, pr in zip(s_toks, s_prompts))

    def mean(xs):
        return sum(xs) / len(xs) if xs else float("nan")

    print(f"  traffic: {len(prompts)} requests, prompts "
          f"{[len(pr) for pr in prompts]}, {gen} new tokens each, "
          f"{ENGINE_SLOTS} slots, max_len {max_len}, chunk {cfg.chunk_size}")
    print(f"  first-token rows: max |engine - generate()| {row_err:.3e} "
          f"(tol {ENGINE_LOGIT_TOL}); generate() kernel vs plain on prompt "
          f"0: {kp_gap:.3e}; tokens equal to generate()'s before the first "
          f"difference: {same_prefix}; timed run's tokens equal the warm-up "
          f"run's: {all(np.array_equal(a, b) for a, b in zip(toks, toks2))}")
    print(f"  timed run(): {n_tok} tokens in {dt:.3f}s, {n_tok / dt:.1f} "
          f"tok/s, ticks {st1['ticks'] - st0['ticks']} (prefill part "
          f"{pre_ticks}, decode part {dec_ticks}), TTFT p50 "
          f"{ttft_p50 * 1e3:.1f} ms p90 {ttft_p90 * 1e3:.1f} ms, slot "
          f"{slot_bytes / 1e9:.3f} GB, peak {peak_gb:.2f} GB, launches "
          f"{launches}")
    print(f"  stepped run: ms per tick decode-only {mean(tick_ms['decode']):.2f}"
          f" (n={len(tick_ms['decode'])}), mixed {mean(tick_ms['mixed']):.2f}"
          f" (n={len(tick_ms['mixed'])}), prefill-only "
          f"{mean(tick_ms['prefill']):.2f} (n={len(tick_ms['prefill'])}); "
          f"slot restores {restored} in {len(copy_ev['save'])} decode "
          f"parts: saves {copy_ms['save']:.2f} ms, write-backs "
          f"{copy_ms['restore']:.2f} ms in all (CUDA events), "
          f"{(copy_ms['save'] + copy_ms['restore']) / max(restored, 1):.3f}"
          f" ms per restored slot; stepped run's ticks "
          f"{sum(map(sum, tick_ms.values())):.1f} ms in all")
    print(f"  softmax (plain torch), same traffic: {sum(map(len, sm_toks)) / sm_dt:.1f}"
          f" tok/s, TTFT p50 {sm_ttft * 1e3:.1f} ms, slot "
          f"{sm_bytes / 1e9:.3f} GB")
    phase("engine", f"{cfg.name} fastmax2-kernel bf16 ServeEngine: every "
          f"request FINISHED, {cfg.n_layers} prefill launches per prefill "
          f"part and {cfg.n_layers} decode launches per decode part and "
          f"nothing else; first-token rows within {ENGINE_LOGIT_TOL}: "
          f"{row_err <= ENGINE_LOGIT_TOL}; smoke config f32 engine tokens "
          f"== generate(): {s_same}; phase {time.monotonic() - t_phase:.1f}s")
    if not row_err <= ENGINE_LOGIT_TOL:
        fail("engine: a first-token logit row is off generate()'s")
    if not s_same:
        fail("engine: the smoke model's tokens differ from generate()'s")
    return {"launches": launches, "tok_s": n_tok / dt,
            "decode_tick_ms": mean(tick_ms["decode"]),
            "mixed_tick_ms": mean(tick_ms["mixed"]),
            "restore_ms": copy_ms["save"] + copy_ms["restore"]}


# train phase, remat="dots" beside remat="full" from the same weights and
# batch: the forward is the same computation, so the loss is held equal;
# each leaf's grad within the CPU test's limits
# (tests/test_torch_train.py::test_remat_full_and_none_give_the_same_grads):
# |g_dots - g_full| <= REMAT_ATOL + REMAT_RTOL |g_full| per element
REMAT_RTOL, REMAT_ATOL = 1e-6, 1e-7
# ckpt phase: qwen3-1.7b training through launch/train.py's main at full
# width, cut to CKPT_LAYERS layers (the phase's time is the checkpoints'
# writes and reads: ~24 GB each at all 28 layers, ~7 GB at 4), stopped at
# a checkpoint and resumed; the checkpoints (bf16 params, f32 m, v and
# master) live here and are removed at the end of the phase, pass or fail
CKPT_DIR = Path(__file__).resolve().parent / "build" / "ckpt_smoke"
CKPT_ARGV = ["--arch", "qwen3-1.7b", "--attn", "fastmax2-kernel",
             "--batch", "4", "--seq", "1024", "--steps", "4",
             "--log-every", "1"]
CKPT_LAYERS = 4
# api phase: the oracle and rowwise backends (plain torch) against the
# chunked and kernel backends in float32 with TF32 off, at this fraction
# of the output scale; dropout's keep share within this many standard
# deviations of 1 - rate
API_TOL, KEEP_SIGMAS = 1e-4, 4


def train_dots(tcfg, batch, dev, n_steps: int = 3) -> dict:
    """remat="dots" beside `tcfg`'s remat="full" from the seeded weights
    and `batch`: the loss and every leaf's grad before any update (and the
    launches of that backward), then a warm-up and `n_steps` timed AdamW
    steps (CUDA events, launches per step, peak memory, losses)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step, pick_optimizer
    from repro_torch.models import init_model
    from repro_torch.models.param import count_params

    dcfg = dataclasses.replace(tcfg, remat="dots")
    params = init_model(tcfg, seed=0, device=dev)
    tbatch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    loss_full, g_full = loss_and_grads(params, tbatch, tcfg)
    ops.reset_launch_counts()
    loss_dots, g_dots = loss_and_grads(params, tbatch, dcfg)
    torch.cuda.synchronize()
    grad_launches = ops.launch_counts()
    over, max_diff = -math.inf, 0.0
    for name, gf in g_full.items():
        diff = (g_dots[name].float() - gf.float()).abs()
        over = max(over, (diff - REMAT_RTOL * gf.float().abs()).max().item())
        max_diff = max(max_diff, diff.max().item())
    del g_full, g_dots
    _, opt = pick_optimizer(dcfg, count_params(params), lr=3e-4,
                            total_steps=1 + n_steps)
    opt_state = opt[0](params)
    train_step = make_train_step(dcfg, opt)
    params, opt_state, m = train_step(params, opt_state, batch)  # warm-up
    losses = [m["loss"].item()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, step_launches = [], []
    for _ in range(n_steps):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ops.reset_launch_counts()
        ev0.record()
        params, opt_state, m = train_step(params, opt_state, batch)
        ev1.record()
        ev1.synchronize()
        step_launches.append(ops.launch_counts())
        step_ms.append(ev0.elapsed_time(ev1))
        losses.append(m["loss"].item())
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, opt_state, train_step, opt
    torch.cuda.empty_cache()
    return {"loss_full": loss_full.item(), "loss_dots": loss_dots.item(),
            "grad_over": over, "grad_max_diff": max_diff,
            "grad_launches": grad_launches, "step_ms": step_ms,
            "step_launches": step_launches, "peak_gb": peak,
            "losses": losses}


def _ckpt_step_leaf(ckpt_dir: Path, label: int) -> int:
    """The optimizer `step` stored in checkpoint `label`."""
    import numpy as np

    d = ckpt_dir / f"step_{label:08d}"
    files = {m["path"]: m["file"] for m in json.loads(
        (d / "manifest.json").read_text())["leaves"]}
    return int(np.load(d / "arrays" / files["1/.step"]))


def ckpt_phase() -> tuple:
    """Full-width qwen3-1.7b cut to CKPT_LAYERS layers, training through
    `launch.train.main` (its config cut where `train.build` makes it): run A
    (4 steps, a checkpoint every 2 updates: label 2 async, label 4 the
    final blocking save), then the state a kill during the final save
    leaves (label 4 removed, LATEST back at label 2), then run B
    (`--resume`, steps 2-3). Fails unless run B's losses and final
    parameters equal run A's bit for bit and every step launched exactly
    2 n_layers forward and n_layers backward kernels."""
    import contextlib
    import io
    import re
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.optim.grad_utils import leaves

    n_layers = CKPT_LAYERS
    build = train.build

    def run(extra):
        buf = io.StringIO()
        ops.reset_launch_counts()
        train.build = lambda args: dataclasses.replace(build(args),
                                                       n_layers=n_layers)
        try:
            with contextlib.redirect_stdout(buf):
                params, losses = train.main(
                    CKPT_ARGV + ["--ckpt-dir", str(CKPT_DIR)] + extra)
        finally:
            train.build = build
            print(buf.getvalue(), end="", flush=True)
        torch.cuda.synchronize()
        return params, losses, ops.launch_counts(), buf.getvalue()

    def want(steps):
        return {"fastmax_causal": 2 * n_layers * steps,
                "fastmax_causal_bwd": n_layers * steps, "fastmax_decode": 0,
                "fastmax_noncausal_moments": 0,
                "fastmax_noncausal_combine": 0, "hybrid_causal": 0}

    def steps_of(out):
        return [(int(s), float(ms), bool(fl)) for s, ms, fl in re.findall(
            r"step +(\d+) loss \S+ gnorm \S+ (\d+)ms( \[save in flight\])?",
            out)]

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        params_a, losses_a, launches_a, out_a = run(["--ckpt-every", "2"])
        label2_step = _ckpt_step_leaf(CKPT_DIR, 2)
        ckpt_gb = sum(f.stat().st_size for f in
                      (CKPT_DIR / "step_00000004").rglob("*")) / 1e9
        shutil.rmtree(CKPT_DIR / "step_00000004")
        (CKPT_DIR / "LATEST").write_text("step_00000002")
        params_b, losses_b, launches_b, out_b = run(["--resume"])
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    same = [name for (name, a), (_, b) in zip(leaves(params_a),
                                               leaves(params_b))
            if torch.equal(a, b)]
    n_leaves = len(leaves(params_a))
    snap = re.search(r"checkpoint 2 \(async\): ([\d.]+) ms", out_a)
    final = re.search(r"checkpoint 4 \(blocking\): ([\d.]+) s \(after "
                      r"([\d.]+) s", out_a)
    restore = re.search(r"resumed from step 2 \(restore ([\d.]+) s\)",
                        out_b)
    res = {"losses_a": losses_a, "losses_b": losses_b,
           "launches_a": launches_a, "launches_b": launches_b,
           "label2_step": label2_step, "leaves_equal": len(same),
           "leaves": n_leaves, "steps_a": steps_of(out_a),
           "steps_b": steps_of(out_b),
           "snapshot_ms": float(snap.group(1)) if snap else None,
           "save_s": float(final.group(1)) if final else None,
           "ckpt_gb": ckpt_gb,
           "wait_s": float(final.group(2)) if final else None,
           "restore_s": float(restore.group(1)) if restore else None}
    del params_a, params_b
    torch.cuda.empty_cache()
    ok = (losses_b == losses_a[2:] and len(same) == n_leaves
          and launches_a == want(4) and launches_b == want(2)
          and label2_step == 2 and None not in (snap, final, restore))
    return res, ok


def api_phase(dev) -> tuple:
    """fastmax-oracle and fastmax-rowwise on the card at whisper's widths
    (12 heads, G = 1, Dv = 64): noncausal N = M = 256 at D = 64 and causal
    N = 256 at D = 32, float32, against fastmax2-chunked and
    fastmax2-kernel (API_TOL of the output scale); then each dropout mode
    on rowwise from a CUDA torch.Generator: two calls from one seed equal
    bit for bit, and the keep share of the masks drawn within KEEP_SIGMAS
    standard deviations of 1 - rate."""
    from repro_torch import attention as TA
    from repro_torch.core import fastmax as TF

    gen = torch.Generator(device=dev).manual_seed(22)
    errs, ok = {}, True
    for causal, n, d in ((False, 256, 64), (True, 256, 32)):
        q, k = (torch.randn(2, 12, n, d, generator=gen, device=dev)
                for _ in range(2))
        v = torch.randn(2, 12, n, 64, generator=gen, device=dev)
        outs = {name: TA.attention(q, k, v, TA.AttentionSpec.parse(name),
                                   causal=causal)
                for name in ("fastmax2-chunked", "fastmax2-kernel",
                             "fastmax2-oracle", "fastmax2-rowwise")}
        torch.cuda.synchronize()
        for name in ("fastmax2-oracle", "fastmax2-rowwise"):
            for against in ("fastmax2-chunked", "fastmax2-kernel"):
                ref = outs[against]
                e = (outs[name] - ref).abs().max().item()
                scale = max(1.0, ref.abs().max().item())
                errs[(causal, name, against)] = e
                ok = ok and e <= API_TOL * scale
    rate = 0.1
    q, k = (torch.randn(2, 12, 256, 64, generator=gen, device=dev)
            for _ in range(2))
    v = torch.randn(2, 12, 256, 64, generator=gen, device=dev)
    plain = TA.attention(q, k, v, TA.AttentionSpec.parse("fastmax2-rowwise"),
                         causal=False)
    real, drawn = TF.draw_keep, []

    def recording(*args):
        drawn.append(real(*args))
        return drawn[-1]

    dropout = {}
    TF.draw_keep = recording
    try:
        for mode in ("quadratic", "1d", "none"):
            spec = TA.AttentionSpec.parse("fastmax2-rowwise",
                                          dropout_rate=rate,
                                          dropout_mode=mode)
            drawn.clear()
            o1 = TA.attention(q, k, v, spec, causal=False,
                              rng=torch.Generator(device=dev).manual_seed(5))
            masks = list(drawn)
            o2 = TA.attention(q, k, v, spec, causal=False,
                              rng=torch.Generator(device=dev).manual_seed(5))
            n_el = sum(m_.numel() for m_ in masks)
            share = (sum(m_.sum().item() for m_ in masks) / n_el
                     if n_el else None)
            sigma = math.sqrt(rate * (1 - rate) / n_el) if n_el else None
            same = bool(torch.equal(o1, o2))
            moved = (o1 - plain).abs().max().item()
            dropout[mode] = {"draws": len(masks), "elements": n_el,
                             "keep_share": share, "sigma": sigma,
                             "bitwise": same, "moved": moved}
            ok = ok and same and (
                (mode == "none" and not masks and moved == 0.0)
                or (mode != "none" and masks and moved > 0.0
                    and abs(share - (1 - rate)) <= KEEP_SIGMAS * sigma))
    finally:
        TF.draw_keep = real
    return {"errs": errs, "dropout": dropout}, ok


# [moe] phase: full-width deepseek-v2-236b with one cut, n_layers 60 -> 3
# (the dense first block and two MoE blocks), at batch 2, prompt 1024, 32
# new tokens. MLA decompresses k and v per query head, so both kernels run
# at Hkv = Hq = 128, D = 192, Dv = 128 there
MOE_ARCH, MOE_LAYERS = "deepseek-v2-236b", 3
MOE_B, MOE_P, MOE_G = 2, 1024, 32
# the prefill's last logit row, kernel path against the plain
# (fastmax2-chunked) path on prompt 0 at batch 1, with the bf16 weights
# widened to float32 (the same function, 38 GB): float32 attention outputs
# differ by rounding only, and a router choice flips only on a near-tie of
# float32 probabilities. In bf16 the two paths round their attention
# outputs differently, which moves the router's inputs by ~2^-8: a top-6 of
# 160 choice then flips wherever two experts' probabilities are that
# close, and a flipped choice moves its token's row by a routed expert's
# share. So the bf16 gap is printed beside the share of (token, slot)
# choices that differ, and the float32 gap is held
MLA_F32_LOGIT_TOL = 1e-2     # absolute, max over the last row's logits
# [moe train] phase: full-width deepseek-v2-236b with one cut, n_layers 60
# -> 1: its first_k_dense layer (MLA, 128 heads at D = 192, Dv = 128, and
# the dense SwiGLU, d_ff 12288), 1.467 B params, trained at B=2, N=1024
# with AdamW. The 2-layer cut (one MoE layer more) is 5.519 B params: with
# the bf16 weights and grads, AdamW's float32 master, m and v (16 B a
# parameter) about 88 GB, more than the card holds. remat "none": one
# layer's activations fit, and each step then runs exactly one forward and
# one backward launch. The plain path runs its scan at chunks of
# MOE_TRAIN_PLAIN_CHUNK tokens (the same function): its §2.5 backward holds
# several m2-sized carries of 4.8 GB beside each chunk's features, and with
# AdamW's state at chunks of 128 it ran out of the card's memory
MOE_TRAIN_LAYERS, MOE_TRAIN_B, MOE_TRAIN_N, MOE_TRAIN_STEPS = 1, 2, 1024, 3
MOE_TRAIN_PLAIN_CHUNK = 64
# MLA's attention widths (qk_nope + qk_rope = 128 + 64; v 128) and heads;
# the backward's checks against float64 run at MLA_BWD_HEADS heads, its
# plain version at MLA's train shape at chunks of CHUNK_MLA tokens (the
# kernel's L; 512 would hold ~10 GB of features a chunk)
MLA_D, MLA_DV, MLA_HEADS, MLA_BWD_HEADS, CHUNK_MLA = 192, 128, 128, 8, 128
# [archs] phase: the decode kernel at granite-20b's widths (48 query heads
# on one kv head, G = 48: three groups of 16 queries per launch pair)
GRANITE_ARCH, GRANITE_B, GRANITE_N, GRANITE_STEPS = "granite-20b", 4, 1024, 32


def decode_chain(gen, b, hq, hkv, d, dv, dtype, kst, pst, steps):
    """`steps` chained decode steps on fresh seeded tokens: the kernel
    updates `kst` in place, the plain version steps from `pst`. Returns
    (max o error, every o within its limit, the plain state)."""
    from repro_torch.core.ref import normalize_qk
    from repro_torch.kernels.fastmax_decode import fastmax_decode_cuda
    from repro_torch.kernels.ref import fastmax_decode_ref

    dev = kst[0].device
    eo, ok = 0.0, True
    for _ in range(steps):
        qs, ks = (normalize_qk(torch.randn(b, h, 1, d, generator=gen,
                                           device=dev)).to(dtype)
                  for h in (hq, hkv))
        vs = torch.randn(b, hkv, 1, dv, generator=gen, device=dev).to(dtype)
        od = fastmax_decode_cuda(qs, ks, vs, kst, p=2)
        rd, pst = fastmax_decode_ref(qs, ks, vs, pst, p=2)
        e, o_ok = o_err(od, rd)
        eo, ok = max(eo, e), ok and o_ok
    torch.cuda.synchronize()
    return eo, ok, pst


def kernel_pair_check(tag, gen, b, hq, hkv, n, d, dv, steps, dtypes):
    """The prefill kernel at [B, Hq|Hkv, N, D|Dv] against its plain
    version (o and all six moments), then `steps` chained decode steps
    from its state against the plain version's (o, and the moments after
    them). Fails the run on a disagreement. Returns the bf16 (or last)
    inputs and the plain state for timing."""
    from repro_torch.core.ref import normalize_qk
    from repro_torch.kernels.fastmax_causal import (fastmax_causal_cuda,
                                                    fastmax_causal_ref)

    dev = torch.device("cuda")
    out = None
    for dtype in dtypes:
        q = normalize_qk(torch.randn(b, hq, n, d, generator=gen,
                                     device=dev)).to(dtype)
        k = normalize_qk(torch.randn(b, hkv, n, d, generator=gen,
                                     device=dev)).to(dtype)
        v = torch.randn(b, hkv, n, dv, generator=gen, device=dev).to(dtype)
        o, st = fastmax_causal_cuda(q, k, v, p=2)
        ro, rst = fastmax_causal_ref(q, k, v, p=2, chunk_size=512)
        torch.cuda.synchronize()
        eo, o_ok = o_err(o, ro)
        em = max(moment_err(a, r) for a, r in zip(st, rst))
        del o, ro
        eo_d, ok_d, pst = decode_chain(gen, b, hq, hkv, d, dv, dtype, st,
                                       tuple(t.clone() for t in rst), steps)
        em_d = max(moment_err(a, r) for a, r in zip(st, pst))
        del st, pst
        dt = str(dtype)[6:]
        print(f"  {tag} {dt} B={b} Hq={hq} Hkv={hkv} D={d} Dv={dv} N={n}: "
              f"prefill o max abs err {eo:.3e}, moments {em:.3e}; {steps} "
              f"chained decode steps o max abs err {eo_d:.3e}, moments "
              f"after them {em_d:.3e} (tol {o_tol(dtype)}; moments "
              f"{TOL_MOMENTS:.0e})")
        if not (o_ok and ok_d and em <= TOL_MOMENTS and em_d <= TOL_MOMENTS):
            fail(f"{tag} {dt}: a kernel disagrees with its plain version")
        out = (q, k, v, rst)
    return out


def time_decode(gen, q_heads, state, dtype, reps=10):
    """The decode kernel and its plain version timed on `state` (the
    kernel's updates it in place; the plain version leaves it), with the
    bound of one step: the f32 state read and written once against the
    step's operations at the f32 peak. Two calls from copies of one state
    must agree bit for bit (o and the state). Returns a dict of numbers."""
    from repro_torch.core.ref import normalize_qk
    from repro_torch.kernels.fastmax_decode import fastmax_decode_cuda
    from repro_torch.kernels.ref import fastmax_decode_ref

    b, hkv, d, _, dv = state[2].shape
    dev = state[0].device
    qs = normalize_qk(torch.randn(b, q_heads, 1, d, generator=gen,
                                  device=dev)).to(dtype)
    ks = normalize_qk(torch.randn(b, hkv, 1, d, generator=gen,
                                  device=dev)).to(dtype)
    vs = torch.randn(b, hkv, 1, dv, generator=gen, device=dev).to(dtype)
    runs = []
    for _ in range(2):
        kst = tuple(t.clone() for t in state)
        runs.append((fastmax_decode_cuda(qs, ks, vs, kst, p=2), kst))
    (o1, s1), (o2, s2) = runs
    if not (torch.equal(o1, o2) and all(torch.equal(x, y)
                                        for x, y in zip(s1, s2))):
        fail(f"decode kernel at G={q_heads // hkv}: two calls differ")
    del runs, o1, o2, s1, s2
    kst = tuple(t.clone() for t in state)
    ms = sync_ms(lambda: fastmax_decode_cuda(qs, ks, vs, kst, p=2),
                 reps=reps)
    plain = sync_ms(lambda: fastmax_decode_ref(qs, ks, vs, state, p=2),
                    reps=3)
    el = torch.tensor([], dtype=dtype).element_size()
    nbytes = 2 * sum(t.numel() for t in kst) * 4 + el * (
        qs.numel() + ks.numel() + vs.numel() + b * q_heads * dv)
    ops_n = decode_ops(b * hkv, q_heads // hkv, d, dv)
    bms, by = bound_ms(ops_n, nbytes, H100_F32_FLOPS)
    del kst
    return {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "bytes": nbytes}


def time_prefill(tag, q, k, v, rst, reps=2) -> dict:
    """The prefill kernel at q [B, Hq, N, D], k, v [B, Hkv, N, D|Dv] timed
    against its plain version and its bound (bf16 inputs read and o
    written once, the f32 state `rst` written once, the operations at the
    bf16 peak); its segments, workspace and one call's peak memory; two
    calls compared bit for bit. Returns a dict of numbers."""
    from repro_torch.kernels.fastmax_causal import (fastmax_causal_cuda,
                                                    fastmax_causal_ref,
                                                    prefill_call)

    b, hq, n, d = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    ms = sync_ms(lambda: fastmax_causal_cuda(q, k, v, p=2), reps=reps)
    plain = sync_ms(lambda: fastmax_causal_ref(q, k, v, p=2,
                                               chunk_size=512),
                    reps=1, warmup=0)
    call = prefill_call(q, k, v, p=2)
    nseg, ws = len(call.segments), call.workspace_bytes
    del call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    o1, s1 = fastmax_causal_cuda(q, k, v, p=2)
    torch.cuda.synchronize()
    call_peak = torch.cuda.max_memory_allocated() - before
    o2, s2 = fastmax_causal_cuda(q, k, v, p=2)
    same = bool(torch.equal(o1, o2)) and all(
        torch.equal(a, b_) for a, b_ in zip(s1, s2))
    del o1, o2, s1, s2
    if not same:
        fail(f"{tag}: two prefill calls on the same inputs differ")
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + b * hq * n * dv) \
        + 4 * sum(t.numel() for t in rst)
    bms, by = bound_ms(prefill_ops(b * hkv, hq // hkv, n, d, dv), nbytes,
                       H100_BF16_FLOPS)
    print(f"  {tag} prefill kernel bf16 B={b} Hq={hq} Hkv={hkv} N={n}: "
          f"{nseg} segment(s) of its two launches, workspace "
          f"{ws / 1e9:.3f} GB, one call's peak {call_peak / 1e9:.3f} GB "
          f"above what was allocated before it; {ms:.3f} ms (plain "
          f"{plain:.2f}, bound {bms:.3f} by {by}); two calls bitwise equal")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "segments": nseg, "workspace_bytes": ws,
            "call_peak_bytes": call_peak}


def bwd_case(gen, b, n, dtype, p, seeded, heads, d, dv=None):
    """The backward kernel against its plain version (at the kernel's
    chunk) on fresh seeded inputs, q̂ [B, Hq, N, D], k̂ [B, Hkv, N, D], v
    [B, Hkv, N, Dv]; `seeded`: the forward starts from an init_state and
    dstate is compared too. Rows past the first chunk against plain, that
    chunk against float64 (the rules of TOL_GRAD); fails the run on a
    disagreement. Returns (max |kernel - plain| over dq, dk, dv, the
    kernel's segments, the inputs)."""
    from repro_torch.core.ref import normalize_qk
    from repro_torch.kernels.fastmax_causal import (CHUNK,
                                                    fastmax_causal_cuda,
                                                    fastmax_causal_ref)
    from repro_torch.kernels.fastmax_causal_bwd import (
        bwd_call, fastmax_causal_bwd_cuda, fastmax_causal_bwd_ref)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    bhq, bhkv = heads
    dv = dv or d
    cb = CHUNK   # the backward's chunk, as the prefill's
    # at p=1, f(s) = 1 + s is sign-indefinite at the model's scale
    # (|s| up to D): denominators can nearly cancel, and which
    # float32 summation order lands nearer float64 is luck; q̂/D
    # keeps |s| <= 1 and f >= 0
    qs = 1.0 / d if p == 1 else 1.0
    q = (normalize_qk(randn(b, bhq, n, d)) * qs).to(dtype)
    k = normalize_qk(randn(b, bhkv, n, d)).to(dtype)
    v = randn(b, bhkv, n, dv).to(dtype)
    do = randn(b, bhq, n, dv).to(dtype)
    init = None
    if seeded:
        _, init = fastmax_causal_ref(
            normalize_qk(randn(b, bhq, 200, d)) * qs,
            normalize_qk(randn(b, bhkv, 200, d)),
            randn(b, bhkv, 200, dv), p=p, chunk_size=512)
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
           + (f" D={d} Dv={dv} Hq={bhq} Hkv={bhkv}" if dv != d else "")
           + (f" G={bhq // bhkv}" if bhq != 2 * bhkv else "")
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


def bwd_mla(gen, dev) -> dict:
    """[bwd] at MLA's widths (deepseek-v2: D = 192, Dv = 128, one query
    head per kv head): the kernel against its plain version by
    `bwd_case`'s rules at MLA_BWD_HEADS heads (the float64 reference at
    128 heads would hold ~10 GB of m2 alone), then timed at the train
    path's own shape (B=2, 128/128 heads, N=1024, bf16): the call, its
    four launches apart (summed over its segments), plain, the bound, the
    workspace, one call's peak memory, two calls bit for bit."""
    from repro_torch.core.ref import normalize_qk
    from repro_torch.kernels.fastmax_causal import fastmax_causal_cuda
    from repro_torch.kernels.fastmax_causal_bwd import (
        bwd_call, fastmax_causal_bwd_cuda, fastmax_causal_bwd_ref)

    d, dv, h, b, n = MLA_D, MLA_DV, MLA_BWD_HEADS, MOE_B, MOE_P
    for dtype in (torch.float32, torch.bfloat16):
        bwd_case(gen, b, n, dtype, 2, False, (h, h), d, dv)
    bwd_case(gen, b, 1000, torch.float32, 2, True, (h, h), d, dv)
    bwd_case(gen, b, 1000, torch.float32, 1, True, (h, h), d, dv)
    bwd_case(gen, b, n, torch.float32, 2, False, (2 * h, h), d, dv)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    hq = MLA_HEADS
    q = normalize_qk(rn(b, hq, n, d)).bfloat16()
    k = normalize_qk(rn(b, hq, n, d)).bfloat16()
    v = rn(b, hq, n, dv).bfloat16()
    do = rn(b, hq, n, dv).bfloat16()
    _, st = fastmax_causal_cuda(q, k, v, p=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    g1 = fastmax_causal_bwd_cuda(q, k, v, st, do, p=2)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    g2 = fastmax_causal_bwd_cuda(q, k, v, st, do, p=2)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(g1, g2))
    del g2
    if not same:
        fail("two backward calls at MLA's train shape differ")
    ms = sync_ms(lambda: fastmax_causal_bwd_cuda(q, k, v, st, do, p=2),
                 reps=2)
    t0 = time.monotonic()
    ref = fastmax_causal_bwd_ref(q, k, v, st, do, p=2, chunk_size=CHUNK_MLA)
    torch.cuda.synchronize()
    plain = (time.monotonic() - t0) * 1e3
    # kernel against plain at this shape too, by rows past the first chunk
    err = max((x[..., CHUNK_MLA:, :].float() - r[..., CHUNK_MLA:, :].float())
              .abs().max().item() for x, r in zip(g1, ref))
    del ref, g1
    torch.cuda.empty_cache()
    call = bwd_call(q, k, v, st, do, p=2)
    nseg = len(call.segments)
    call.run()
    parts = {f: sync_ms(lambda f=f: [getattr(call, f)(i) for i in
                                     reversed(range(nseg))], reps=2)
             for f in ("slots", "queries", "cot", "keys")}
    ws = call.workspace_bytes
    del call
    ops_n = bwd_ops(b * hq, 1, n, d, dv)
    nbytes = (2 * (q.numel() + k.numel() + v.numel()) + do.numel()) * 2 \
        + sum(t.numel() for t in st) * 4
    bms, by = bound_ms(ops_n, nbytes, H100_BF16_FLOPS)
    print(f"  timing (bwd MLA, bf16 B={b} Hq=Hkv={hq} N={n} D={d} Dv={dv}):"
          f" kernel {ms:.3f} ms (launches summed over its {nseg} segments: "
          f"A' carry slots {parts['slots']:.3f}, B' queries "
          f"{parts['queries']:.3f}, C cotangent slots {parts['cot']:.3f}, D "
          f"keys {parts['keys']:.3f}; plain {plain:.1f} at chunk "
          f"{CHUNK_MLA}, one call; bound {bms:.3f} by {by} "
          f"({ops_n:.3e} operations; {ops_n / H100_F32_FLOPS * 1e3:.3f} ms "
          f"at the f32 peak), {ops_n / ms / 1e9:.2f} TFLOP/s; workspace "
          f"{ws / 1e9:.3f} GB, one call's peak {peak / 1e9:.3f} GB above "
          f"what was allocated before it; max |kernel - plain| past the "
          f"first chunk {err:.3e}; two calls bitwise equal)")
    del q, k, v, do, st
    torch.cuda.empty_cache()
    return {"ms_mla": ms, "plain_ms_mla": plain, "bound_ms_mla": bms,
            "bound_by_mla": by, "segments_mla": nseg,
            "workspace_bytes_mla": ws, "call_peak_bytes_mla": peak,
            "max_abs_err_mla": err,
            **{f"{f}_ms_mla": t for f, t in parts.items()}}


def moe_train_phase(dev, bwd_ms: float) -> dict:
    """[moe train]: full-width deepseek-v2-236b cut to MOE_TRAIN_LAYERS
    layer (its first_k_dense layer: MLA at D = 192, Dv = 128, and the
    dense SwiGLU), bf16, AdamW, B x N of one SyntheticLM batch, on
    fastmax2-kernel and on plain fastmax2-chunked from the same weights:
    the loss and every leaf's grad before any update, then a warm-up and
    MOE_TRAIN_STEPS timed steps on each path (CUDA events; the kernel
    path's launches counted per step: exactly MOE_TRAIN_LAYERS forward and
    MOE_TRAIN_LAYERS backward). `bwd_ms`: the backward kernel's ms at this
    shape ([bwd]), for its share of the step."""
    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step, pick_optimizer
    from repro_torch.models import init_model
    from repro_torch.models.param import count_params

    full = get_config(MOE_ARCH)
    cfg = get_config(MOE_ARCH, n_layers=MOE_TRAIN_LAYERS, remat="none",
                     attn=AttentionSpec.parse("fastmax2-kernel"))
    plain_cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
        AttentionSpec.parse("fastmax2-chunked"),
        chunk_size=MOE_TRAIN_PLAIN_CHUNK))
    b, n, steps = MOE_TRAIN_B, MOE_TRAIN_N, MOE_TRAIN_STEPS
    print(f"  card memory allocated before the phase: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    t0 = time.monotonic()
    params0 = init_model(cfg, seed=0, device=dev)
    n_params = count_params(params0)
    batch = SyntheticLM(cfg.vocab_size, n, seed=0).batch(0, b)
    tbatch = {k_: torch.as_tensor(v_, device=dev) for k_, v_ in batch.items()}
    torch.cuda.synchronize()
    print(f"  {MOE_ARCH}: n_layers {full.n_layers} -> {cfg.n_layers} (its "
          f"first_k_dense layer: MLA {cfg.n_heads} heads, D = "
          f"{cfg.qk_nope_dim + cfg.qk_rope_dim}, Dv = {cfg.head_dim}, "
          f"kv_lora {cfg.kv_lora_rank}; dense SwiGLU d_ff {cfg.d_ff}; "
          f"d_model {cfg.d_model}; vocab {cfg.vocab_size} untied), "
          f"{n_params / 1e9:.3f} B params bf16 in "
          f"{time.monotonic() - t0:.1f}s")
    lk, gk = loss_and_grads(params0, tbatch, cfg)
    lp, gp = loss_and_grads(params0, tbatch, plain_cfg)
    dloss = abs(lk.item() - lp.item())
    leaf, gerr = worst_leaf(gk, gp)
    # each path below trains its own copy of the weights, drawn again from
    # the seed (the same bits), so that no third copy takes card memory
    del gk, gp, params0
    torch.cuda.empty_cache()
    print(f"  parity before any update: loss kernel {lk.item():.5f} plain "
          f"{lp.item():.5f} |diff| {dloss:.3e} (tol {TRAIN_LOSS_TOL}); "
          f"worst leaf {leaf} |g_k - g_p|/|g_p| {gerr:.3e} (tol "
          f"{TRAIN_GRAD_TOL})")
    ok = (math.isfinite(lk.item()) and dloss <= TRAIN_LOSS_TOL
          and gerr <= TRAIN_GRAD_TOL)
    want = {"fastmax_causal": cfg.n_layers, "fastmax_causal_bwd":
            cfg.n_layers, "fastmax_decode": 0,
            "fastmax_noncausal_moments": 0, "fastmax_noncausal_combine": 0,
            "hybrid_causal": 0}
    runs = {}
    for tag, c in (("kernel", cfg), ("plain", plain_cfg)):
        params = init_model(cfg, seed=0, device=dev)
        _, opt = pick_optimizer(c, n_params, lr=3e-4, total_steps=1 + steps)
        opt_state = opt[0](params)
        train_step = make_train_step(c, opt)
        params, opt_state, m = train_step(params, opt_state, batch)
        losses = [m["loss"].item()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_ms, counts = [], []
        for _ in range(steps):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ops.reset_launch_counts()
            ev0.record()
            params, opt_state, m = train_step(params, opt_state, batch)
            ev1.record()
            ev1.synchronize()
            counts.append(ops.launch_counts())
            step_ms.append(ev0.elapsed_time(ev1))
            losses.append(m["loss"].item())
        runs[tag] = {"step_ms": step_ms, "losses": losses, "launches": counts,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"  {tag} path: step ms "
              f"{', '.join(f'{x:.1f}' for x in step_ms)}, peak "
              f"{runs[tag]['peak_gb']:.2f} GB, launches {counts[-1]}",
              flush=True)
        del params, opt_state, train_step, opt
        torch.cuda.empty_cache()
    rk, rp = runs["kernel"], runs["plain"]
    med = {t: sorted(r["step_ms"])[len(r["step_ms"]) // 2]
           for t, r in runs.items()}
    gap = max(abs(x - y) for x, y in zip(rk["losses"], rp["losses"]))
    ok = ok and all(c == want for c in rk["launches"]) and all(
        math.isfinite(x) for x in rk["losses"]) and gap <= TRAIN_LOSS_TOL
    phase("moe train", f"{MOE_ARCH} (n_layers {full.n_layers} -> "
          f"{cfg.n_layers}) bf16 AdamW B={b} N={n}: step ms kernel "
          f"{', '.join(f'{x:.1f}' for x in rk['step_ms'])}, plain "
          f"{', '.join(f'{x:.1f}' for x in rp['step_ms'])} (CUDA events); "
          f"tokens/s at the median {b * n / (med['kernel'] / 1e3):.1f} / "
          f"{b * n / (med['plain'] / 1e3):.1f}; peak {rk['peak_gb']:.2f} / "
          f"{rp['peak_gb']:.2f} GB; the backward kernel ({bwd_ms:.1f} ms at "
          f"this shape in [bwd]) {bwd_ms / med['kernel']:.1%} of the kernel "
          f"path's median step; loss kernel "
          f"{', '.join(f'{x:.5f}' for x in rk['losses'])}, plain "
          f"{', '.join(f'{x:.5f}' for x in rp['losses'])} (max |diff| "
          f"{gap:.3e}, tol {TRAIN_LOSS_TOL}); launches per step "
          f"{rk['launches'][-1]}")
    if not ok:
        fail(f"[moe train]: kernel and plain paths disagree, or the kernel "
             f"path launched {rk['launches']} (expected {want} per step)")
    return {"step_ms": rk["step_ms"], "plain_step_ms": rp["step_ms"],
            "peak_gb": rk["peak_gb"], "plain_peak_gb": rp["peak_gb"],
            "losses": rk["losses"], "plain_losses": rp["losses"],
            "loss_diff": dloss, "worst_leaf": leaf, "grad_err": gerr,
            "launches": rk["launches"][-1], "params": n_params,
            "bwd_share": bwd_ms / med["kernel"]}


def route_flips(routes_a, routes_b, e: int) -> float:
    """Share of (token, slot) router choices of one run that the other did
    not make, over every MoE call of the two runs in order."""
    diff = total = 0
    for a, b in zip(routes_a, routes_b):
        t, k = a.shape
        oa = torch.zeros(t, e, device=a.device).scatter_(1, a, 1.0)
        ob = torch.zeros(t, e, device=b.device).scatter_(1, b, 1.0)
        diff += t * k - int((oa * ob).sum().item())
        total += t * k
    return diff / max(total, 1)


def moe_phase(dev) -> dict:
    """[moe]: the prefill and decode kernels at MLA's shapes against their
    plain versions and timed against their bounds; then full-width
    deepseek-v2-236b (depth cut to MOE_LAYERS) on fastmax2-kernel in bf16:
    generate() with exactly MOE_LAYERS prefill and MOE_LAYERS (G - 1)
    decode launches and nothing else, its times, tok/s and peak memory;
    the last logit row of prompt 0 against the plain path in bf16 (a
    reading, with the router flips) and in float32 weights (held)."""
    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.models.layers import _kv_dims
    from repro_torch.models.param import count_params

    full = get_config(MOE_ARCH)
    cfg = get_config(MOE_ARCH, n_layers=MOE_LAYERS,
                     attn=AttentionSpec.parse("fastmax2-kernel"))
    hq, dv = cfg.n_heads, cfg.head_dim
    hkv, d = _kv_dims(cfg)
    B, P, G = MOE_B, MOE_P, MOE_G
    gen = torch.Generator(device=dev).manual_seed(23)
    out = {}
    print(f"  card memory allocated before the phase: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    with torch.inference_mode():
        # ---- both kernels at MLA's shapes against their plain versions ----
        q, k, v, rst = kernel_pair_check(
            "MLA", gen, B, hq, hkv, P, d, dv, G - 1,
            (torch.float32, torch.bfloat16))
        pf = time_prefill("MLA", q, k, v, rst)
        fd = time_decode(gen, hq, rst, torch.bfloat16)
        print(f"  MLA decode kernel bf16 B={B}: {fd['ms']:.4f} ms (plain "
              f"{fd['plain_ms']:.4f}, bound {fd['bound_ms']:.4f} by "
              f"{fd['bound_by']}: {fd['bytes'] / 1e9:.3f} GB, "
              f"{fd['bytes'] / fd['ms'] / 1e6:.0f} GB/s)")
        out.update({f"prefill_{k}_mla": v for k, v in pf.items()})
        out.update(decode_ms_mla=fd["ms"], decode_plain_ms_mla=fd["plain_ms"],
                   decode_bound_ms_mla=fd["bound_ms"],
                   decode_bound_by_mla=fd["bound_by"])
        del q, k, v, rst
        torch.cuda.empty_cache()

        # ---- full-width deepseek-v2, depth cut, bf16 ----
        print(f"  {MOE_ARCH}: n_layers {full.n_layers} -> {cfg.n_layers} "
              f"(dense_0 + {cfg.n_groups} MoE blocks), every width as "
              f"published: d_model {cfg.d_model}, {hq} heads, MLA "
              f"{cfg.kv_lora_rank}/{cfg.qk_nope_dim}/{cfg.qk_rope_dim} v "
              f"{dv}, {cfg.n_experts} experts of {cfg.d_ff_expert} top-"
              f"{cfg.moe_top_k} + {cfg.n_shared_experts} shared, dense d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab_size}")
        t0 = time.monotonic()
        params = init_model(cfg, seed=0, device=dev)
        prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                                device=dev)
        torch.cuda.synchronize()
        n_params = count_params(params)
        print(f"  weights: {n_params / 1e9:.3f} B params bf16 "
              f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) in "
              f"{time.monotonic() - t0:.1f}s")
        sv = serve_timed("moe", params, cfg, prompts, G, dev,
                         fastmax_causal=cfg.n_layers,
                         fastmax_decode=cfg.n_layers * (G - 1))
        gaps = logit_gaps("moe", params, cfg, prompts[:1], dev)
        del params
        torch.cuda.empty_cache()
    launches, total_s, peak_gb = sv["launches"], sv["total_s"], sv["peak_gb"]
    prefill_ms, decode_ms = sv["prefill_ms"], sv["decode_ms"]
    d16, d32 = gaps["logit_gap_bf16"], gaps["logit_gap_f32"]
    flips16, flips32 = gaps["route_flips_bf16"], gaps["route_flips_f32"]
    agree16 = gaps["argmax_agree_bf16"]
    phase("moe", f"{MOE_ARCH} (n_layers {full.n_layers} -> {cfg.n_layers}) "
          f"fastmax2-kernel bf16 B={B} P={P} G={G}: {total_s:.3f}s total, "
          f"prefill {prefill_ms:.1f} ms, decode {decode_ms:.2f} ms/token "
          f"(CUDA events inside the call), {B * G / total_s:.1f} tok/s, peak "
          f"{peak_gb:.2f} GB, launches {launches}; prompt 0's last logit "
          f"row |kernel - plain|: bf16 {d16:.3e} (argmax agree {agree16}, "
          f"router choices differing {flips16:.4f}), float32 weights "
          f"{d32:.3e} (tol {MLA_F32_LOGIT_TOL:.0e}; choices differing "
          f"{flips32:.4f})")
    if not d32 <= MLA_F32_LOGIT_TOL:
        fail(f"[moe] float32 last-row logits differ by {d32:.3e}")
    out.update(launches_mla=launches, prefill_ms=prefill_ms,
               decode_ms=decode_ms, tok_s=sv["tok_s"], peak_gb=peak_gb,
               params=n_params, **gaps)
    return out


def serve_timed(tag, params, cfg, prompts, n_gen, dev, **want) -> dict:
    """generate() of `n_gen` tokens: a warm-up call, then a timed one
    (CUDA events inside it, the host clock around it) whose kernel
    launches must be exactly `want` (every kernel not named: none).
    Returns its numbers and tokens."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate

    b = prompts.shape[0]
    generate(params, cfg, prompts, n_gen, device=dev)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    timings = {}
    t0 = time.monotonic()
    toks = generate(params, cfg, prompts, n_gen, device=dev, timings=timings)
    torch.cuda.synchronize()
    total_s = time.monotonic() - t0
    launches = ops.launch_counts()
    expect = {name: 0 for name in launches}
    expect.update(want)
    if launches != expect:
        fail(f"[{tag}] launch counts {launches}, expected {expect}")
    if tuple(toks.shape) != (b, n_gen) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"[{tag}] bad tokens {tuple(toks.shape)}")
    print(f"  {cfg.name} first tokens: {toks[0, :8].tolist()} "
          f"{toks[1, :8].tolist()}")
    return {"launches": launches, "total_s": total_s,
            "prefill_ms": timings["prefill_ms"],
            "decode_ms": timings["decode_ms"] / timings["decode_steps"],
            "tok_s": b * n_gen / total_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def logit_gaps(tag, params, cfg, prompt, dev) -> dict:
    """The last logit row of `prompt` [1, P] on the kernel path against the
    plain (fastmax2-chunked) path, in the model's bf16 weights (a reading,
    with the share of MoE router choices that differ) and with `params`
    widened to float32 in place (the caller frees them after)."""
    from repro_torch.attention import AttentionSpec
    from repro_torch.models import init_decode_state
    from repro_torch.models import moe as MOE
    from repro_torch.models.transformer import lm_prefill

    routes = []
    real_route = MOE._route

    def recording(xf, router, k_):
        r = real_route(xf, router, k_)
        routes.append(r[2].clone())
        return r

    def last_rows(c):
        """(kernel row, plain row, router flip share) at batch 1."""
        rows, runs = [], []
        for cc in (c, dataclasses.replace(
                c, attn=AttentionSpec.parse("fastmax2-chunked"))):
            routes.clear()
            st = init_decode_state(cc, 1, prompt.shape[1], device=dev)
            lg, _ = lm_prefill(params, prompt, cc, st)
            rows.append(lg[0, -1].float())
            runs.append(list(routes))
            del lg, st
            torch.cuda.empty_cache()
        return rows[0], rows[1], route_flips(*runs, max(cfg.n_experts, 1))

    MOE._route = recording
    try:
        lk, lp, flips16 = last_rows(cfg)
        d16 = (lk - lp).abs().max().item()
        agree16 = bool(lk.argmax() == lp.argmax())
        if not bool(torch.isfinite(lk).all()):
            fail(f"[{tag}] non-finite logits on the kernel path")
        # the same weights widened to float32, leaf by leaf
        for key in list(params):
            params[key] = _widen(params[key])
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    activ_dtype="float32")
        lk, lp, flips32 = last_rows(cfg32)
        d32 = (lk - lp).abs().max().item()
    finally:
        MOE._route = real_route
    return {"logit_gap_bf16": d16, "argmax_agree_bf16": agree16,
            "route_flips_bf16": flips16, "logit_gap_f32": d32,
            "route_flips_f32": flips32}


def _widen(tree):
    """`tree`'s float leaves in float32, each replaced in its dict as it is
    widened (so one leaf's two copies live at a time)."""
    if isinstance(tree, dict):
        for key in list(tree):
            tree[key] = _widen(tree[key])
        return tree
    return tree.float()


def archs_phase(dev) -> dict:
    """[archs]: the six attention-only configs added beside qwen3 and
    whisper, each smoke model in float32 giving the same greedy tokens on
    the kernel and plain paths; the engine on the deepseek-v2 and kimi-k2
    smoke models giving generate()'s tokens; then the decode kernel at
    granite-20b's widths (G = 48) after a prefill, chained against its
    plain version, and timed against its bound."""
    import numpy as np

    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_model
    from repro_torch.models.layers import _kv_dims
    from repro_torch.serve import ServeEngine

    gen = torch.Generator(device=dev).manual_seed(24)
    same = {}
    for arch in ("llama3-405b", "qwen2.5-32b", "granite-20b",
                 "chameleon-34b", "deepseek-v2-236b", "kimi-k2-1t-a32b"):
        small = get_smoke_config(
            arch, attn=AttentionSpec.parse("fastmax2-kernel"))
        plain = dataclasses.replace(
            small, attn=AttentionSpec.parse("fastmax2-chunked"))
        sp = init_model(small, seed=0, device=dev)
        prompts = torch.randint(0, small.vocab_size, (2, 40), generator=gen,
                                device=dev)
        tk = generate(sp, small, prompts, 8, device=dev)
        tp = generate(sp, plain, prompts, 8, device=dev)
        same[arch] = bool(torch.equal(tk, tp))
        if small.n_experts:
            rng = np.random.default_rng(3)
            reqs = [rng.integers(0, small.vocab_size, n)
                    for n in (40, 17, 33, 9, 26)]
            eng = ServeEngine(sp, small, max_slots=2, max_len=64)
            rids = [eng.submit(r, 6) for r in reqs]
            outs = eng.run()
            same[f"{arch} engine"] = all(
                outs[rid].tolist() == generate(
                    sp, small, torch.as_tensor(r, device=dev)[None], 6,
                    max_len=64, device=dev)[0].tolist()
                for rid, r in zip(rids, reqs))
    # the SSM slice's two smoke models: tokens on both paths, and the
    # engine on tests/test_serve.py's staggered ragged traffic (2 slots,
    # prompts of 33 and 17 tokens, the second submitted two ticks later)
    for arch in (SSM_ARCH, XLSTM_ARCH):
        small = get_smoke_config(
            arch, attn=AttentionSpec.parse("fastmax2-kernel"))
        plain = dataclasses.replace(
            small, attn=AttentionSpec.parse("fastmax2-chunked"))
        sp = init_model(small, seed=0, device=dev)
        prompts = torch.randint(0, small.vocab_size, (2, 40), generator=gen,
                                device=dev)
        same[arch] = bool(torch.equal(generate(sp, small, prompts, 8,
                                               device=dev),
                                      generate(sp, plain, prompts, 8,
                                               device=dev)))
        rng = np.random.default_rng(2)
        reqs = [rng.integers(0, small.vocab_size, n) for n in (33, 17)]
        eng = ServeEngine(sp, small, max_slots=2, max_len=64)
        rids, outs = [eng.submit(reqs[0], 5)], {}
        for _ in range(2):
            outs.update({f.rid: f.tokens for f in eng.step()})
        rids.append(eng.submit(reqs[1], 5))
        outs.update(eng.run())
        same[f"{arch} engine"] = all(
            list(outs[rid]) == generate(
                sp, small, torch.as_tensor(r, device=dev)[None], 5,
                max_len=64, device=dev)[0].tolist()
            for rid, r in zip(rids, reqs))
    print("  smoke f32 tokens kernel == plain (and engine == generate()): "
          + ", ".join(f"{a} {v}" for a, v in same.items()))
    if not all(same.values()):
        fail("[archs] a smoke model's kernel path or engine disagrees")

    # jamba's smoke model: one loss and grad on the kernel path (its
    # attention layer through the forward and §2.5 backward kernels)
    # against the plain path, per leaf, at SMOKE_GRAD_TOL. The worst leaf
    # is the attention's wq or wk (the float32 §2.5 backward's first
    # chunk, ill-conditioned in any implementation): on an H100 5.37e-5
    # on this batch, every run the same; 6.20e-5 and 9.71e-5 on the
    # batches of seeds 2 and 3
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops

    small = get_smoke_config(SSM_ARCH,
                             attn=AttentionSpec.parse("fastmax2-kernel"))
    sp = init_model(small, seed=0, device=dev)
    sb = SyntheticLM(small.vocab_size, 256, seed=1).batch(0, 2)
    sb = {k_: torch.as_tensor(v_, device=dev) for k_, v_ in sb.items()}
    ops.reset_launch_counts()
    jlk, jgk = loss_and_grads(sp, sb, small)
    jl_launches = ops.launch_counts()
    jlp, jgp = loss_and_grads(sp, sb, dataclasses.replace(
        small, attn=AttentionSpec.parse("fastmax2-chunked")))
    jleaf, jerr = worst_leaf(jgk, jgp)
    print(f"  {SSM_ARCH} smoke f32 N=256 grads: loss |kernel - plain| "
          f"{abs(jlk.item() - jlp.item()):.3e}, worst leaf {jleaf} "
          f"|g_k - g_p|/|g_p| {jerr:.3e} (tol {SMOKE_GRAD_TOL:.0e}); "
          f"kernel launches {jl_launches}")
    if not (jerr <= SMOKE_GRAD_TOL and jl_launches["fastmax_causal_bwd"]
            and jl_launches["fastmax_causal"]):
        fail("[archs] jamba smoke grads: kernel and plain disagree, or the "
             "kernels did not run")

    gcfg = get_config(GRANITE_ARCH)
    hq, (hkv, d), dv = gcfg.n_heads, _kv_dims(gcfg), gcfg.head_dim
    with torch.inference_mode():
        *_, rst = kernel_pair_check(
            "granite", gen, GRANITE_B, hq, hkv, GRANITE_N, d, dv,
            GRANITE_STEPS, (torch.float32, torch.bfloat16))
        fd = time_decode(gen, hq, rst, torch.bfloat16, reps=20)
        del rst
    torch.cuda.empty_cache()
    phase("archs", f"eight smoke models' tokens equal on both paths, engines "
          f"equal generate(), jamba smoke grads worst leaf {jerr:.2e}; "
          f"decode kernel at G={hq // hkv} (B="
          f"{GRANITE_B}, D=Dv={d}) {fd['ms']:.4f} ms (plain "
          f"{fd['plain_ms']:.4f}, bound {fd['bound_ms']:.4f} by "
          f"{fd['bound_by']})")
    return {"decode_ms_g48": fd["ms"], "decode_plain_ms_g48": fd["plain_ms"],
            "decode_bound_ms_g48": fd["bound_ms"],
            "decode_bound_by_g48": fd["bound_by"]}


# [ssm] phase: full-width jamba-v0.1-52b with one cut, n_layers 32 -> 8
# (one group of its pattern: 7 Mamba layers and 1 attention layer, 4 MoE
# and 4 MLP ffns), and full-width, full-depth xlstm-1.3b, each at batch 4,
# prompt 1024, 32 new tokens. Jamba's attention layer has 32 query heads
# on 8 kv heads: both kernels at G = 4, D = Dv = 128
SSM_ARCH, SSM_LAYERS = "jamba-v0.1-52b", 8
XLSTM_ARCH = "xlstm-1.3b"
SSM_B, SSM_P, SSM_G = 4, 1024, 32
# jamba's last logit row, kernel path against the plain path on prompt 0
# at batch 1 with the bf16 weights widened to float32 (53 GB), by the rule
# of MLA_F32_LOGIT_TOL: about four times the gap measured on an H100,
# 1.001e-5 (no router choice differing; in bf16 3.125e-2 with 0.27 % of
# the top-2 choices differing, a reading)
JAMBA_F32_LOGIT_TOL = 4e-5   # absolute, max over the last row's logits


def _state_bytes_by_mixer(cfg, batch: int, max_len: int) -> dict:
    """Decode-state bytes of each mixer kind, from a `meta` build."""
    from repro_torch.attention.state import state_leaves
    from repro_torch.models import init_decode_state

    st = init_decode_state(cfg, batch, max_len, device="meta")
    out = {}
    for i, kind in enumerate(cfg.pattern):
        mixer = kind.split(":")[0]
        out[mixer] = out.get(mixer, 0) + sum(
            t.numel() * t.element_size()
            for t in state_leaves(st[f"blocks_{i}"]))
    return out


def _host_bound_ms(fn) -> tuple:
    """(ms until `fn` returns on the host, ms until the card has run what
    it queued): equal when the host, not the card, sets the pace."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    t1 = time.monotonic()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3, (time.monotonic() - t0) * 1e3


def _jamba_layer_ms(params, cfg, b, n, gen, dev) -> dict:
    """Device ms of one call of each kind of jamba layer part at a
    prefill of [b, n] tokens (bf16 activations from `gen`): a Mamba
    mixer's stateful prefill, the attention mixer's (the prefill kernel
    and its projections), a routed MoE ffn at full capacity, an MLP."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba as M
    from repro_torch.models import moe as MOE

    kinds = [k.split(":") for k in cfg.pattern]
    first = {}
    for i, (mixer, ffn) in enumerate(kinds):
        first.setdefault(mixer, i)
        first.setdefault(ffn, i)
    layer = {key: {k: v[0] for k, v in params[f"blocks_{i}"][part].items()}
             for key, i, part in (("mamba", first["mamba"], "mixer"),
                                  ("attn", first["attn"], "mixer"),
                                  ("moe", first["moe"], "ffn"),
                                  ("mlp", first["mlp"], "ffn"))}
    x = torch.randn(b, n, cfg.d_model, generator=gen,
                    device=dev).to(cfg.adtype())
    mst = M.init_mamba_state(cfg, b, cfg.adtype(), device=dev)
    ast_ = L.init_attn_state(cfg, b, n, cfg.adtype(), device=dev)
    calls = {
        "Mamba mixer": lambda: M.mamba_prefill(layer["mamba"], x, cfg, mst),
        "attention mixer": lambda: L.attention_prefill(layer["attn"], x,
                                                       ast_, cfg),
        "MoE ffn": lambda: MOE.apply_moe(layer["moe"], x, cfg,
                                         full_capacity=True),
        "MLP ffn": lambda: L.apply_mlp(layer["mlp"], x, act=cfg.mlp_act)}
    out = {k: sync_ms(fn, reps=2) for k, fn in calls.items()}
    counts = {m: sum(1 for k in kinds if m in k) for m in
              ("mamba", "attn", "moe", "mlp")}
    out["sum over the 8 layers"] = (
        counts["mamba"] * out["Mamba mixer"]
        + counts["attn"] * out["attention mixer"]
        + counts["moe"] * out["MoE ffn"] + counts["mlp"] * out["MLP ffn"])
    del x, mst, ast_
    torch.cuda.empty_cache()
    return out


def ssm_phase(dev) -> dict:
    """[ssm]: the prefill and decode kernels at jamba's attention shapes
    (G = 4) against their plain versions, timed against their bounds, two
    calls of each bit for bit; then full-width jamba-v0.1-52b (depth cut
    to SSM_LAYERS) on fastmax2-kernel in bf16: generate() with exactly one
    prefill and G - 1 decode launches and nothing else, its times, tok/s,
    peak memory and decode-state bytes by mixer, prompt 0's last logit row
    against the plain path (bf16 a reading with the router flips; float32
    weights held to JAMBA_F32_LOGIT_TOL); then full-width, full-depth
    xlstm-1.3b: generate() with no kernel launch, and one sLSTM layer's
    sequential prefill timed on the host and the card."""
    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.models import xlstm as X
    from repro_torch.models.param import count_params

    full = get_config(SSM_ARCH)
    cfg = get_config(SSM_ARCH, n_layers=SSM_LAYERS,
                     attn=AttentionSpec.parse("fastmax2-kernel"))
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, P, G = SSM_B, SSM_P, SSM_G
    gen = torch.Generator(device=dev).manual_seed(25)
    out = {}
    print(f"  card memory allocated before the phase: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    with torch.inference_mode():
        # ---- both kernels at jamba's attention shapes (G = 4) ----
        q, k, v, rst = kernel_pair_check(
            "jamba", gen, B, hq, hkv, P, d, d, G - 1,
            (torch.float32, torch.bfloat16))
        pf = time_prefill("jamba", q, k, v, rst)
        fd = time_decode(gen, hq, rst, torch.bfloat16, reps=20)
        print(f"  jamba decode kernel bf16 B={B} G={hq // hkv}: "
              f"{fd['ms']:.4f} ms (plain {fd['plain_ms']:.4f}, bound "
              f"{fd['bound_ms']:.4f} by {fd['bound_by']}: "
              f"{fd['bytes'] / 1e9:.3f} GB, "
              f"{fd['bytes'] / fd['ms'] / 1e6:.0f} GB/s); two calls "
              f"bitwise equal")
        out.update({f"prefill_{k_}_g4": v_ for k_, v_ in pf.items()})
        out.update({f"decode_{k_}_g4": fd[k_] for k_ in
                    ("ms", "plain_ms", "bound_ms", "bound_by")})
        del q, k, v, rst
        torch.cuda.empty_cache()

        # ---- full-width jamba, depth cut, bf16 ----
        print(f"  {SSM_ARCH}: n_layers {full.n_layers} -> {cfg.n_layers} "
              f"(one group: {cfg.pattern}), every width as published: "
              f"d_model {cfg.d_model}, {hq} heads on {hkv} kv heads of "
              f"{d}, Mamba d_inner {cfg.mamba_expand * cfg.d_model} "
              f"d_state {cfg.mamba_d_state} d_conv {cfg.mamba_d_conv}, "
              f"{cfg.n_experts} experts of {cfg.d_ff_expert} top-"
              f"{cfg.moe_top_k}, MLP d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}, untied, no rope")
        t0 = time.monotonic()
        params = init_model(cfg, seed=0, device=dev)
        prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                                device=dev)
        torch.cuda.synchronize()
        n_params = count_params(params)
        print(f"  weights: {n_params / 1e9:.3f} B params bf16 "
              f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) in "
              f"{time.monotonic() - t0:.1f}s")
        sb = _state_bytes_by_mixer(cfg, B, P + G)
        sv = serve_timed("ssm", params, cfg, prompts, G, dev,
                         fastmax_causal=1, fastmax_decode=G - 1)
        layer_ms = _jamba_layer_ms(params, cfg, B, P, gen, dev)
        print("  jamba prefill by layer at B=4 P=1024 (one call each, CUDA "
              "events): " + ", ".join(f"{k} {v:.2f} ms"
                                      for k, v in layer_ms.items()))
        gaps = logit_gaps("ssm", params, cfg, prompts[:1], dev)
        del params
        torch.cuda.empty_cache()
    phase("ssm", f"{SSM_ARCH} (n_layers {full.n_layers} -> {cfg.n_layers})"
          f" fastmax2-kernel bf16 B={B} P={P} G={G}: {sv['total_s']:.3f}s "
          f"total, prefill {sv['prefill_ms']:.1f} ms, decode "
          f"{sv['decode_ms']:.2f} ms/token (CUDA events inside the call), "
          f"{sv['tok_s']:.1f} tok/s, peak {sv['peak_gb']:.2f} GB, decode "
          f"state {sb.get('mamba', 0) / 1e6:.1f} MB Mamba + "
          f"{sb.get('attn', 0) / 1e6:.1f} MB attention, launches "
          f"{sv['launches']}; prompt 0's last logit row |kernel - plain|: "
          f"bf16 {gaps['logit_gap_bf16']:.3e} (argmax agree "
          f"{gaps['argmax_agree_bf16']}, router choices differing "
          f"{gaps['route_flips_bf16']:.4f}), float32 weights "
          f"{gaps['logit_gap_f32']:.3e} (tol {JAMBA_F32_LOGIT_TOL:.0e}; "
          f"choices differing {gaps['route_flips_f32']:.4f})")
    if not gaps["logit_gap_f32"] <= JAMBA_F32_LOGIT_TOL:
        fail(f"[ssm] float32 last-row logits differ by "
             f"{gaps['logit_gap_f32']:.3e}")
    out.update(jamba={"params": n_params, "state_bytes": sb,
                      "prefill_layer_ms": layer_ms,
                      **{k_: sv[k_] for k_ in ("prefill_ms", "decode_ms",
                                               "tok_s", "peak_gb")},
                      **gaps},
               launches_jamba=sv["launches"])

    # ---- full-width xlstm-1.3b, full depth, bf16: no attention ----
    xcfg = get_config(XLSTM_ARCH)
    with torch.inference_mode():
        t0 = time.monotonic()
        params = init_model(xcfg, seed=0, device=dev)
        prompts = torch.randint(0, xcfg.vocab_size, (B, P), generator=gen,
                                device=dev)
        torch.cuda.synchronize()
        n_params = count_params(params)
        print(f"  {XLSTM_ARCH}: {xcfg.n_layers} layers ({xcfg.pattern[0]} x7 "
              f"+ {xcfg.pattern[-1]}), d_model {xcfg.d_model}, "
              f"{xcfg.n_heads} heads, vocab {xcfg.vocab_size}, tied; "
              f"{n_params / 1e9:.3f} B params bf16 "
              f"({torch.cuda.memory_allocated() / 1e9:.2f} GB) in "
              f"{time.monotonic() - t0:.1f}s")
        xb = _state_bytes_by_mixer(xcfg, B, P + G)
        xv = serve_timed("ssm", params, xcfg, prompts, G, dev)
        # one sLSTM layer's prefill (a loop over the 1024 tokens) and one
        # mLSTM layer's (8 chunks of 128), on the host and on the card
        xin = torch.randn(B, P, xcfg.d_model, generator=gen,
                          device=dev).to(torch.bfloat16)
        last = f"blocks_{len(xcfg.pattern) - 1}"           # the sLSTM
        sl = {k_: v_[0] for k_, v_ in params[last]["mixer"].items()}
        ml = {k_: v_[0] for k_, v_ in params["blocks_0"]["mixer"].items()}
        host = {}
        for name, fn in (
                ("slstm", lambda: X.apply_slstm_stateful(
                    sl, xin, xcfg, X.init_slstm_state(
                        xcfg, B, torch.bfloat16, device=dev))),
                ("mlstm", lambda: X.apply_mlstm_stateful(
                    ml, xin, xcfg, X.init_mlstm_state(xcfg, B,
                                                      device=dev)))):
            fn()
            host[name] = _host_bound_ms(fn)
        del params, xin, sl, ml
        torch.cuda.empty_cache()
    phase("ssm", f"{XLSTM_ARCH} (all {xcfg.n_layers} layers) bf16 B={B} "
          f"P={P} G={G}: {xv['total_s']:.3f}s total, prefill "
          f"{xv['prefill_ms']:.1f} ms, decode {xv['decode_ms']:.2f} "
          f"ms/token, {xv['tok_s']:.1f} tok/s, peak {xv['peak_gb']:.2f} GB, "
          f"decode state {xb.get('mlstm', 0) / 1e9:.3f} GB mLSTM + "
          f"{xb.get('slstm', 0) / 1e6:.2f} MB sLSTM, launches "
          f"{xv['launches']} (none: attention-free); one layer's prefill "
          f"on the host / on the card: sLSTM {host['slstm'][0]:.1f} / "
          f"{host['slstm'][1]:.1f} ms, mLSTM {host['mlstm'][0]:.1f} / "
          f"{host['mlstm'][1]:.1f} ms")
    out.update(xlstm={"params": n_params, "state_bytes": xb,
                      **{k_: xv[k_] for k_ in ("prefill_ms", "decode_ms",
                                               "tok_s", "peak_gb")},
                      "slstm_layer_host_ms": host["slstm"][0],
                      "slstm_layer_ms": host["slstm"][1],
                      "mlstm_layer_host_ms": host["mlstm"][0],
                      "mlstm_layer_ms": host["mlstm"][1]})
    return out


# [autotune]: the schedule autotuner's caches under build/ (ignored by
# git), and whisper's encoder length, the noncausal gate keys' key count
AUTOTUNE_CACHE = Path(__file__).resolve().parent / "build" / \
    "autotune_cuda.json"
AUTOTUNE_SMOKE_CACHE = Path(__file__).resolve().parent / "build" / \
    "autotune_smoke.json"
AUTOTUNE_KEYS_M = 1500


@contextlib.contextmanager
def autotune_env(mode: str, cache=None):
    """REPRO_TORCH_AUTOTUNE = `mode` (and its cache file, or none) inside
    the block; the caller's values are restored after."""
    names = ("REPRO_TORCH_AUTOTUNE", "REPRO_TORCH_AUTOTUNE_CACHE")
    saved = {n: os.environ.get(n) for n in names}
    os.environ[names[0]] = mode
    if cache is None:
        os.environ.pop(names[1], None)
    else:
        os.environ[names[1]] = str(cache)
    try:
        yield
    finally:
        for n, val in saved.items():
            if val is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = val


def tune_case(key, dtype, dev):
    """(run, check) at an autotune key's shape (batch 1, `bh` kv heads) in
    `dtype`, inputs from a seeded generator: run(schedule) is the kernel's
    outputs under a schedule, check(outputs) their max error to the plain
    version and whether it is within the kernel's limit (o: TOL_O32 or the
    bf16 rule; moments TOL_MOMENTS of scale)."""
    from repro_torch.core.ref import normalize_qk
    from repro_torch.kernels.fastmax_causal import (fastmax_causal_cuda,
                                                    fastmax_causal_ref)
    from repro_torch.kernels.fastmax_decode import fastmax_decode_cuda
    from repro_torch.kernels.fastmax_noncausal import (
        noncausal_combine_cuda, noncausal_combine_ref, noncausal_moments_cuda,
        noncausal_moments_ref)
    from repro_torch.kernels.hybrid_causal import (hybrid_causal_cuda,
                                                   hybrid_causal_ref)
    from repro_torch.kernels.ref import fastmax_decode_ref

    gen = torch.Generator(device=dev).manual_seed(7)
    hkv, d, dv = key.bh, key.d, key.dv
    hq = key.g * hkv

    def rn(*s):
        return torch.randn(s, generator=gen, device=dev)

    def qkv(n, m):
        return (normalize_qk(rn(1, hq, n, d)).to(dtype),
                normalize_qk(rn(1, hkv, m, d)).to(dtype),
                rn(1, hkv, m, dv).to(dtype))

    def o_and_moments(ro, rst):
        def check(outs):
            eo, ok = o_err(outs[0], ro)
            em = max(moment_err(a, r) for a, r in zip(outs[1:], rst))
            return max(eo, em), ok and em <= TOL_MOMENTS
        return check

    if key.kernel == "noncausal":
        q, k, v = qkv(key.n, AUTOTUNE_KEYS_M)
        mom = noncausal_moments_cuda(k, v, p=2)
        ro = noncausal_combine_ref(q, noncausal_moments_ref(k, v, p=2), p=2)
        return ((lambda s: (noncausal_combine_cuda(q, mom, p=2,
                                                   schedule=s),)),
                lambda outs: o_err(outs[0], ro))
    if key.kernel == "decode":
        q0, k0, v0 = qkv(128, 128)
        _, st = fastmax_causal_ref(q0, k0, v0, p=2, chunk_size=512)
        q, k, v = qkv(1, 1)
        ro, rst = fastmax_decode_ref(q, k, v, tuple(t.clone() for t in st),
                                     p=2)

        def run(s):
            kst = tuple(t.clone() for t in st)
            return (fastmax_decode_cuda(q, k, v, kst, p=2, schedule=s),
                    *kst)
        return run, o_and_moments(ro, rst)
    q, k, v = qkv(key.n, key.n)
    if key.kernel == "causal_fwd":
        ro, rst = fastmax_causal_ref(q, k, v, p=2, chunk_size=512)

        def run(s):
            o, st = fastmax_causal_cuda(q, k, v, p=2, schedule=s)
            return (o, *st)
        return run, o_and_moments(ro, rst)
    kw = dict(p=2, window=64, chunk_size=512, return_state=True)
    ro, rst = hybrid_causal_ref(q, k, v, **kw)

    def run(s):
        o, st = hybrid_causal_cuda(q, k, v, **kw, schedule=s)
        return (o, *st)
    return run, o_and_moments(ro, rst)


def knobs(s) -> str:
    """A schedule's knobs that its kernel has, e.g. `rows=512 group=16`."""
    return " ".join(f"{f}={x}" for f, x in s._asdict().items()
                    if x is not None)


def smoke_tokens(dev):
    """The float32 qwen3 smoke model on fastmax2-kernel, seeded weights and
    prompts: (greedy tokens of generate(), params, config, prompts)."""
    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_model

    small = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                                attn=AttentionSpec.parse("fastmax2-kernel"))
    sp = init_model(small, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    prompts = torch.randint(0, small.vocab_size, (2, 40), generator=g,
                            device=dev)
    with torch.inference_mode():
        return generate(sp, small, prompts, 8, device=dev), sp, small, prompts


def autotune_child() -> None:
    """The second process of [autotune]'s smoke run (the caller sets
    REPRO_TORCH_AUTOTUNE and its cache): prints one JSON line, the smoke
    model's tokens and the autotuner's provenance records."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import autotune as at

    torch.backends.cuda.matmul.allow_tf32 = False
    at.clear_lookups()
    toks = smoke_tokens(torch.device("cuda"))[0]
    print(json.dumps({"tokens": toks.tolist(),
                      "lookups": at.snapshot_lookups()}))


def autotune_candidates(dev, smi: str) -> list:
    """[autotune] (1): every candidate of every gate key against the plain
    version in float32 and bfloat16 and bit for bit, then timed in bf16;
    the winners written to AUTOTUNE_CACHE. Returns one record per key."""
    from repro_torch.kernels import autotune as at

    rows = []
    entries = dict(at.load_cache(str(AUTOTUNE_CACHE)))
    for key in at.gate_keys("cuda"):
        cands = at.candidate_schedules(key.kernel, key)
        worst = {}
        for dtype in (torch.float32, torch.bfloat16):
            run, check = tune_case(key, dtype, dev)
            for s in cands:
                a, b = run(s), run(s)
                torch.cuda.synchronize()
                err, ok = check(a)
                same = all(torch.equal(x, y) for x, y in zip(a, b))
                if not (ok and same):
                    fail(f"autotune: {at.key_str(key)} {knobs(s)} "
                         f"{str(dtype)[6:]}: max err {err:.3e} within its "
                         f"limit {ok}, two calls bitwise {same}")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
                del a, b
            del run, check
            torch.cuda.empty_cache()
        ms = [at.measure(key, s) * 1e3 for s in cands]
        win = min(range(len(cands)), key=ms.__getitem__)
        entries[at.key_str(key)] = {
            "schedule": dict(cands[win]._asdict()), "source": "measured",
            "score": ms[win] / 1e3, "card": smi}
        rows.append({
            "key": at.key_str(key), "default": knobs(cands[0]),
            "default_ms": ms[0], "winner": knobs(cands[win]),
            "winner_ms": ms[win], "ratio": ms[0] / ms[win],
            "candidates": {knobs(s): t for s, t in zip(cands, ms)},
            "max_err_f32": worst[torch.float32],
            "max_err_bf16": worst[torch.bfloat16]})
        print(f"  {at.key_str(key)}: {len(cands)} candidate(s) within the "
              f"limits and bit for bit (max err f32 "
              f"{worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e})"
              f"; default {knobs(cands[0])} {ms[0]:.4f} ms, winner "
              f"{knobs(cands[win])} {ms[win]:.4f} ms (default / winner "
              f"{ms[0] / ms[win]:.3f}); "
              + ", ".join(f"{knobs(s)} {t:.4f}" for s, t in zip(cands, ms)),
              flush=True)
        torch.cuda.empty_cache()
    at.save_cache(str(AUTOTUNE_CACHE), entries)
    return rows


def autotune_digests() -> int:
    """[autotune] (2): with the autotuner off, kernel_digest's lines equal
    the parent's (`kernel_digests.txt`). Returns the count of lines."""
    from repro_torch.launch import kernel_digest

    with autotune_env("0"):
        lines = kernel_digest.digest_lines()
    bad = kernel_digest.compare(lines)
    print(f"  kernel digests, autotuner off: {len(lines) - len(bad)} of "
          f"{len(lines)} lines equal {kernel_digest.EXPECTED.name}")
    if bad:
        for got, want in bad[:5]:
            print(f"  DIFFERS: {got} != {want}")
        fail(f"autotune: {len(bad)} kernel digest(s) differ from the "
             f"parent's with the autotuner off")
    return len(lines)


def autotune_smoke(dev) -> dict:
    """[autotune] (3): the tuned smoke model in this process (fresh cache:
    every key measured and written) against the plain path's tokens, then
    a second process that hits the cache on every lookup."""
    from repro_torch.attention import AttentionSpec
    from repro_torch.kernels import autotune as at
    from repro_torch.launch.serve import generate

    AUTOTUNE_SMOKE_CACHE.unlink(missing_ok=True)
    with autotune_env("1", AUTOTUNE_SMOKE_CACHE):
        at.clear_lookups()
        tk, sp, small, prompts = smoke_tokens(dev)
        recs = at.snapshot_lookups()
    plain = dataclasses.replace(small,
                                attn=AttentionSpec.parse("fastmax2-chunked"))
    with torch.inference_mode():
        tp = generate(sp, plain, prompts, 8, device=dev)
    del sp
    env = {**os.environ, "REPRO_TORCH_AUTOTUNE": "1",
           "REPRO_TORCH_AUTOTUNE_CACHE": str(AUTOTUNE_SMOKE_CACHE)}
    child = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke."
         "autotune_child()"], cwd=Path(__file__).resolve().parent, env=env,
        capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        fail(f"autotune: the second process failed:\n{child.stdout[-2000:]}"
             f"\n{child.stderr[-4000:]}")
    second = json.loads(child.stdout.strip().splitlines()[-1])
    # each key was a miss, measured and persisted, at its first lookup (its
    # later lookups read the entry back: the records show the last)
    written = at.load_cache(str(AUTOTUNE_SMOKE_CACHE))
    first_ok = bool(recs) and len(written) == len(recs) and all(
        written.get(r["key"], {}).get("source") == "measured" for r in recs)
    hits = sum(r["cache"] == "hit" for r in second["lookups"])
    same = bool((tk == tp).all()) and second["tokens"] == tk.tolist()
    print(f"  smoke model f32, REPRO_TORCH_AUTOTUNE=1, fresh cache: "
          f"{len(recs)} keys, each measured and written {first_ok} ("
          + "; ".join(f"{r['key']} {knobs(at.Schedule(**r['schedule']))}"
                      for r in recs)
          + f"); tokens == plain path's and == the second process's "
          f"{same}; second process: {hits} of {len(second['lookups'])} "
          f"lookups hit the cache")
    if not (first_ok and same and hits == len(second["lookups"])
            == len(recs)):
        fail("autotune: the tuned smoke model's tokens differ, or the second "
             "process missed the cache")
    return {"keys": len(recs), "second_hits": hits}


def autotune_qwen3(dev, cfg=None, shape=(4, 1024, 32)) -> list:
    """[autotune] (4): qwen3-1.7b generate() with the autotuner off, on,
    on, off after a warm-up: prefill and decode ms per token (readings),
    the on runs' lookups (hits of AUTOTUNE_CACHE) and the tokens that
    differ from the first off run's."""
    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_config
    from repro_torch.kernels import autotune as at
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_model

    cfg = cfg or dataclasses.replace(
        get_config("qwen3-1.7b"), attn=AttentionSpec.parse("fastmax2-kernel"))
    B, P, G = shape
    params = init_model(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=dev)
    runs = []
    with torch.inference_mode():
        with autotune_env("0"):
            generate(params, cfg, prompts, G, device=dev)   # warm-up
        for mode in ("0", "1", "1", "0"):
            with autotune_env(mode, AUTOTUNE_CACHE):
                at.clear_lookups()
                timings = {}
                toks = generate(params, cfg, prompts, G, device=dev,
                                timings=timings)
                torch.cuda.synchronize()
                recs = at.snapshot_lookups()
            runs.append({"mode": "on" if mode == "1" else "off",
                         "prefill_ms": timings["prefill_ms"],
                         "decode_ms": timings["decode_ms"]
                         / timings["decode_steps"],
                         "tokens": toks, "lookups": recs})
    del params
    torch.cuda.empty_cache()
    ref_toks = runs[0]["tokens"]
    for r in runs:
        r["tokens_differ"] = int((r.pop("tokens") != ref_toks).sum().item())
        recs = r.pop("lookups")
        r["hits"] = sum(x["cache"] == "hit" for x in recs)
        r["schedules"] = {x["kernel"]: knobs(at.Schedule(**x["schedule"]))
                          for x in recs}
    if any(r["mode"] == "on" and r["hits"] != len(r["schedules"])
           for r in runs):
        fail(f"autotune: a tuned qwen3 run missed the cache: {runs}")
    print(f"  qwen3-1.7b bf16 B={B} P={P} G={G} generate(), autotuner off / "
          f"on / on / off (readings): " + "; ".join(
              f"{r['mode']} prefill {r['prefill_ms']:.1f} ms, decode "
              f"{r['decode_ms']:.3f} ms/token, {r['tokens_differ']} of "
              f"{B * G} tokens differ from the first off run"
              + (f", schedules {r['schedules']}" if r["mode"] == "on" else "")
              for r in runs))
    return runs


def autotune_phase(dev, smi: str) -> dict:
    """[autotune]: (1) `autotune_candidates`, (2) `autotune_digests`,
    (3) `autotune_smoke`, (4) `autotune_qwen3` at full width."""
    t0 = time.monotonic()
    out = {"keys": autotune_candidates(dev, smi),
           "digests_equal": autotune_digests(),
           "smoke": autotune_smoke(dev),
           "qwen3": autotune_qwen3(dev)}
    out["seconds"] = time.monotonic() - t0
    phase("autotune", f"{len(out['keys'])} gate keys, every candidate within "
          f"its kernel's limits and bit for bit (default / winner ms: "
          + ", ".join(f"{k['key'].split('|')[0]} {k['ratio']:.3f}"
                      for k in out["keys"])
          + f"); {out['digests_equal']} digests with the autotuner off equal "
          f"the parent's; tuned smoke tokens == plain, second process "
          f"{out['smoke']['second_hits']} hits; phase {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# [shard] and [cp train]: the kernel plans on two ranks of the one card
# ---------------------------------------------------------------------------

RANKS_DIR = Path(__file__).resolve().parent / "build" / "ranks"
# results of two-rank phases that shared a spawn (`spawn_together`), by
# rank function, until the phase takes them (`two_ranks`)
_KEPT: dict = {}
SHARD_STEPS = 32            # lockstep decode steps after each prefill
# (name, (B, Hq, Hkv, N, D, Dv), mesh axes, mode, what runs): qwen3's
# layer, granite's MQA layer, qwen3's layer at N = 2048 under cp = 2 at
# B = 2 (the auto pick is the ring: 2 x 136.3 MB > 256 MiB) and B = 1
# (allgather: 2 x 68.2 MB), and the hybrid kernel at qwen3's layer
SHARD_CASES = (
    ("heads", (4, 16, 8, 1024, 128, 128), ("data", "model"), "heads",
     ("serve", "train")),
    ("feature", (4, 48, 1, 1024, 128, 128), ("data", "model"), "feature",
     ("serve", "train")),
    ("seq B=2", (2, 16, 8, 2048, 128, 128), ("data", "seq"), "seq",
     ("train",)),
    ("seq B=1", (1, 16, 8, 2048, 128, 128), ("data", "seq"), "seq",
     ("train",)),
    ("hybrid heads", (4, 16, 8, 1024, 128, 128), ("data", "model"), "heads",
     ("hybrid",)),
    ("hybrid feature", (4, 16, 8, 1024, 128, 128), ("data", "model"),
     "feature", ("hybrid",)),
)
HYBRID_WINDOW = 64
CP_ARCH, CP_LAYERS, CP_B, CP_N, CP_STEPS = "qwen3-1.7b", 2, 2, 2048, 2


def ranks_in_turn(rank, world, calls):
    """A spawned rank that calls each (fn, args) of `calls` in turn:
    [(fn's result, its seconds)]. Before each call it frees what the last
    one left on the card and resets the peak (the first call makes the
    CUDA context: `_moe_rank_setup` sets the allocator first); after it,
    it undoes the call's patch of `make_grad_fn` (`record_first_grads`)."""
    import gc

    from repro_torch.launch import steps as ST

    out = []
    for fn, args in calls:
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        make_grad_fn = ST.make_grad_fn
        t0 = time.monotonic()
        try:
            out.append((fn(rank, world, *args), time.monotonic() - t0))
        finally:
            ST.make_grad_fn = make_grad_fn
    return out


def spawn_together(name: str, calls, timeout: float) -> None:
    """Run several two-rank phases' rank functions (`calls`: (fn, args)
    pairs) in turn in one spawn of two ranks, and keep each one's results
    for its phase: a spawn costs ≈ 8 s of the script's time limit."""
    from repro_torch.launch.ranks import run_ranks

    ranks = run_ranks(ranks_in_turn, 2, args=(calls,),
                      workdir=RANKS_DIR / name, timeout=timeout, threads=0)
    for i, (fn, _) in enumerate(calls):
        _KEPT[fn.__name__] = ([r[i][0] for r in ranks], ranks[0][i][1])


def two_ranks(fn, args=(), *, timeout: float) -> tuple:
    """(the two ranks' results of `fn`, seconds): those `spawn_together`
    kept (the seconds rank 0's call took), else from a spawn of `fn`
    alone (the spawn's seconds), as when a phase is run by itself."""
    from repro_torch.launch.ranks import run_ranks

    if fn.__name__ in _KEPT:
        return _KEPT.pop(fn.__name__)
    t0 = time.monotonic()
    ranks = run_ranks(fn, 2, args=args, workdir=RANKS_DIR / fn.__name__,
                      timeout=timeout, threads=0)
    return ranks, time.monotonic() - t0


def _rank_setup():
    """A spawned rank: the card (both ranks share it), TF32 off, the port
    importable. Returns the device."""
    src = str(Path(__file__).resolve().parent / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def shard_grad_err(k, s, plain, exact, firsts, partials=False):
    """A sharded backward output `k` on the rank's rows against the single
    kernel call's `s`, the plain versions' `plain` on the same shards and
    float64 `exact`. Rows past each shard's first chunk (`firsts`, a slice
    of the rows axis -2): the TOL_GRAD rule against `s`. Where `k` is a
    sum of bf16-rounded parts (`partials`: feature mode's dq, dk over the
    ranks' Dv columns; seq mode's dk, dv, the local kernel's plus the
    moment fold's), which may cancel, those rows may instead be as close
    to float64 as `s` is (GRAD_MARGIN x its error). The first chunk's rows
    rebuild the carry before them by subtraction (the reference's
    carry_before = carry_after - delta): there `k` is held against float64
    within GRAD_MARGIN x the larger error of `s` and `plain` on those
    rows. Returns (tail max |k - s|, first-chunk errors of k, s and
    plain, ok)."""
    rows = torch.ones(k.shape[-2], dtype=torch.bool, device=k.device)
    rows[firsts] = False

    def err(a, sel):
        return (a[..., sel, :].double() - exact[..., sel, :]).abs().max(
        ).item()

    tk, ts = k[..., rows, :].float(), s[..., rows, :].float()
    diff = (tk - ts).abs()
    lim = TOL_GRAD * max(1.0, ts.abs().max().item())
    ok = (bool((diff <= ts.abs() * TOL_BF16_REL + lim).all())
          if k.dtype == torch.bfloat16 else diff.max().item() <= lim)
    if not ok and partials and k.dtype == torch.bfloat16:
        ok = err(k, rows) <= GRAD_MARGIN * err(s, rows)
    e_k, e_s, e_p = err(k, firsts), err(s, firsts), err(plain, firsts)
    head = exact[..., firsts, :]
    ok = ok and e_k <= max(GRAD_MARGIN * max(e_s, e_p),
                           TOL_GRAD * max(1.0, head.abs().max().item()))
    return diff.max().item(), e_k, e_s, e_p, ok


def _shard_case(case, mesh, dev):
    """One [shard] case on this rank, float32 then bfloat16: the gathered
    kernel results checked on the rank's shards against one
    single-process kernel call on the whole inputs (every rank makes the
    same call, so each checks its own shard). Returns its readings."""
    from repro_torch.core.fastmax import (compute_moments_chunked,
                                          fastmax_causal_chunked)
    from repro_torch.core.hybrid import hybrid_causal_chunked
    from repro_torch.core.ref import normalize_qk
    from repro_torch.kernels import ops
    from repro_torch.kernels import sharded as S
    from repro_torch.kernels.fastmax_causal import CHUNK, segment_tokens
    from repro_torch.sharding.rules import _batch_entry, mesh_axes

    name, (b, hq, hkv, n, d, dv), _, mode, what = case
    gen = torch.Generator(device=dev).manual_seed(27)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    sizes = mesh_axes(mesh)
    if mode == "feature" and hkv % 2 == 0:
        # qwen3's heads would take heads mode: force the feature plan
        plan = S.ShardPlan(mesh, _batch_entry(sizes, b)[0], "feature", 2)
    else:
        plan = S.plan_kernel_sharding(mesh, batch=b, hq=hq, hkv=hkv, dv=dv,
                                      seq_len=n if mode == "seq" else None)
    assert plan.mode == mode, (name, plan)
    sp = S.plan_specs(plan)

    def loc(key, t):
        return S.shard_local(t, sp[key], mesh)

    rank_n = n // plan.cp
    # each shard's first chunk of the kernel (the rank's first rows)
    firsts = slice(0, min(CHUNK, rank_n))
    q0 = normalize_qk(randn(b, hq, n, d))
    k0 = normalize_qk(randn(b, hkv, n, d))
    v0, do0 = randn(b, hkv, n, dv), randn(b, hq, n, dv)
    steps = [(normalize_qk(randn(b, hq, 1, d)),
              normalize_qk(randn(b, hkv, 1, d)), randn(b, hkv, 1, dv))
             for _ in range(SHARD_STEPS)]
    kw = dict(p=2, denom_eps=1e-6)
    out = {"case": name, "mode": mode, "ok": True, "dtypes": {}}
    same_segments = (segment_tokens(b * hkv, d, dv, 2) >= n
                     and segment_tokens(b * hkv // plan.tp, d, dv, 2) >= n)
    for dtype in (torch.float32, torch.bfloat16):
        r = {}
        q, k, v, do = (t.to(dtype) for t in (q0, k0, v0, do0))
        bitwise = []
        if "serve" in what:
            ok_, st_ = S.fastmax_prefill_sharded(
                loc("q", q), loc("k", k), loc("v", v), chunk_size=CHUNK,
                plan=plan, **kw)
            os_, sts = ops.fastmax_prefill_kernel(q, k, v, **kw)
            eo, o_ok = o_err(ok_, loc("o", os_))
            em = max(moment_err(a, loc_m) for a, loc_m in zip(
                st_, (S.shard_local(t, s, mesh)
                      for t, s in zip(sts, sp["moments"]))))
            bitwise.append(torch.equal(ok_, loc("o", os_)))
            ed, d_ok = 0.0, True
            kst, sst = tuple(st_), tuple(sts)
            for qs, ks, vs in steps:
                qs, ks, vs = (t.to(dtype) for t in (qs, ks, vs))
                o1, kst = S.fastmax_decode_sharded(
                    loc("q", qs), loc("k", ks), loc("v", vs), kst, plan=plan,
                    **kw)
                s1 = ops.fastmax_decode(qs, ks, vs, sst, **kw)
                e, ok1 = o_err(o1, loc("o", s1))
                ed, d_ok = max(ed, e), d_ok and ok1
                bitwise.append(torch.equal(o1, loc("o", s1)))
            emd = max(moment_err(a, S.shard_local(t, s, mesh))
                      for a, t, s in zip(kst, sst, sp["moments"]))
            r["prefill_ms"] = sync_ms(lambda: S.fastmax_prefill_sharded(
                loc("q", q), loc("k", k), loc("v", v), chunk_size=CHUNK,
                plan=plan, **kw), reps=3)
            r.update(prefill_o_err=eo, carry_err=em, decode_o_err=ed,
                     decode_state_err=emd)
            r["ok_serve"] = o_ok and d_ok and em <= TOL_MOMENTS \
                and emd <= TOL_MOMENTS
        if "hybrid" in what:
            hk = dict(p=2, window=HYBRID_WINDOW, chunk_size=512,
                      denom_eps=1e-6)
            with torch.no_grad():
                ok_ = S.hybrid_sharded(loc("q", q), loc("k", k), loc("v", v),
                                       plan=plan, **hk)
                os_ = ops.hybrid(q, k, v, **hk)
                op_ = hybrid_causal_chunked(q, k, v, p=2,
                                            window=HYBRID_WINDOW,
                                            chunk_size=512)
            eo, o_ok = o_err(ok_, loc("o", os_))
            ep, p_ok = o_err(ok_, loc("o", op_))
            bitwise.append(torch.equal(ok_, loc("o", os_)))
            with torch.no_grad():
                r["hybrid_ms"] = sync_ms(lambda: S.hybrid_sharded(
                    loc("q", q), loc("k", k), loc("v", v), plan=plan, **hk),
                    reps=3)
            r.update(hybrid_o_err=eo, hybrid_o_err_plain=ep)
            r["ok_hybrid"] = o_ok and p_ok
        if "train" in what:
            def sharded(qq, kk, vv, dd, plain=False):
                a, b_, c = (loc(n_, t).requires_grad_(True)
                            for n_, t in (("q", qq), ("k", kk), ("v", vv)))
                o = S.fastmax_sharded(a, b_, c, causal=True,
                                      chunk_size=CHUNK, plan=plan,
                                      plain=plain, **kw)
                o.backward(loc("o", dd))
                return [o.detach(), a.grad, b_.grad, c.grad]

            def single(qq, kk, vv, dd, kernel=True):
                a, b_, c = (t.clone().requires_grad_(True)
                            for t in (qq, kk, vv))
                if kernel:
                    o = ops.fastmax(a, b_, c, causal=True, **kw)
                else:
                    o = fastmax_causal_chunked(a, b_, c, p=2,
                                               chunk_size=CHUNK,
                                               custom_grad=True)
                o.backward(dd)
                return [loc(n_, t) for n_, t in zip(
                    ("o", "q", "k", "v"), (o.detach(), a.grad, b_.grad,
                                           c.grad))]

            kg = sharded(q, k, v, do)
            sg = single(q, k, v, do)
            wide = [t.double() for t in (q, k, v, do)]
            # float64: the single-process plain call, cut to the shard
            eg = single(*wide, kernel=False)
            # the plain versions at the input dtype: on the seq plan's
            # shards (each rebuilds its own carry, the first chunk's
            # conditioning there), else on the whole inputs
            pg = (sharded(q, k, v, do, plain=True) if mode == "seq"
                  else single(q, k, v, do, kernel=False))
            eo, o_ok = o_err(kg[0], sg[0])
            bitwise.append(torch.equal(kg[0], sg[0]))
            gerr, g_ok = {}, True
            for gname, a, s_, p_, e_ in zip(("dq", "dk", "dv"), kg[1:],
                                            sg[1:], pg[1:], eg[1:]):
                tail, e_k, e_s, e_p, ok1 = shard_grad_err(
                    a, s_, p_, e_, firsts,
                    partials=(mode, gname) in (("feature", "dq"),
                                               ("feature", "dk"),
                                               ("seq", "dk"), ("seq", "dv")))
                gerr[gname] = (tail, e_k, e_s, e_p)
                g_ok = g_ok and ok1
                bitwise.append(torch.equal(a, s_))
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            sharded(q, k, v, do)
            t1.record()
            t1.synchronize()
            r.update(train_o_err=eo, grad_errs=gerr,
                     fwd_bwd_ms=t0.elapsed_time(t1))
            r["ok_train"] = o_ok and g_ok
            if mode == "seq":
                with torch.no_grad():
                    mom = compute_moments_chunked(loc("k", k), loc("v", v),
                                                  p=2, chunk_size=CHUNK)
                impl = S._seq_impl(loc("q", q), loc("k", k), loc("v", v), 2,
                                   plan)
                r["exchange"] = impl
                r["exchange_ms"] = sync_ms(
                    lambda: S._cp_prefix_sum(tuple(mom), mesh, impl),
                    reps=3)
                r["carry_bytes"] = S.cp_carry_bytes(b=b, hkv=hkv, d=d,
                                                    dv=dv, p=2)
        r["bitwise"] = all(bitwise)
        r["same_segments"] = same_segments
        if mode == "heads" and same_segments and not r["bitwise"]:
            r["ok_bitwise"] = False
        r["ok"] = all(v_ for k_, v_ in r.items() if k_.startswith("ok_"))
        out["ok"] = out["ok"] and r["ok"]
        out["dtypes"][str(dtype)[6:]] = r
    torch.cuda.synchronize()
    return out


def shard_rank(rank, world, cases):
    """A [shard] rank: every case on its (data 1, model 2) or (data 1,
    seq 2) mesh over the gloo group."""
    del world
    dev = _rank_setup()
    from repro_torch.launch.mesh import make_test_mesh

    meshes = {}
    out = []
    for case in cases:
        axes = case[2]
        if axes not in meshes:
            meshes[axes] = make_test_mesh((1, 2), axes)
        out.append(_shard_case(case, meshes[axes], dev))
    out.append({"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "rank": rank})
    return out


def shard_phase() -> dict:
    """[shard]: two ranks on the one card over gloo, the kernel plans'
    gathered results against one single-process kernel call."""
    ranks, secs = two_ranks(shard_rank, (SHARD_CASES,), timeout=600)
    ok = True
    for rank, res in enumerate(ranks):
        for c in res[:-1]:
            ok = ok and c["ok"]
            for dt, r in c["dtypes"].items():
                parts = [f"{k}={v:.3e}" if isinstance(v, float) else
                         f"{k}={v}" for k, v in r.items()
                         if k.endswith("_err") or k.endswith("_ms")
                         or k in ("exchange", "carry_bytes", "bitwise",
                                  "same_segments")]
                parts += [f"{g} tail {t:.3e} first {ek:.3e} (single "
                          f"{es:.3e}, plain {ep:.3e})" for g, (t, ek, es, ep)
                          in r.get("grad_errs", {}).items()]
                print(f"  rank {rank} {c['case']} {dt}: {'; '.join(parts)}"
                      f"; ok={r['ok']}")
    summary = {
        "cases": [{"case": c["case"], "mode": c["mode"], **{
            f"{dt}_{k}": v for dt, r in c["dtypes"].items()
            for k, v in r.items() if k.endswith("_ms") or k in (
                "exchange", "carry_bytes", "bitwise")}}
            for c in ranks[0][:-1]],
        "rank1_ms": [{f"{dt}_{k}": v for dt, r in c["dtypes"].items()
                      for k, v in r.items() if k.endswith("_ms")}
                     for c in ranks[1][:-1]],
        "peak_gb": [res[-1]["peak_gb"] for res in ranks],
        "seconds": secs, "ranks_on_one_card": 2}
    phase("shard", f"{len(SHARD_CASES)} cases on 2 gloo ranks sharing the "
          f"card, f32/bf16 p=2: every gathered result within its limit of "
          f"one single-process kernel call = {ok}; peak per rank "
          f"{', '.join(f'{x:.2f}' for x in summary['peak_gb'])} GB (times "
          f"are per rank on a shared card, not a multi-card speedup)")
    if not ok:
        fail("shard: a sharded kernel result disagrees with the "
             "single-process call")
    return summary


# [cp train]'s gathered mixers, each against --cp 1 in one process: (a)
# the hybrid (hybrid2-kernel, CP_STEPS AdamW steps) and (b) softmax (the
# seeded weights' loss and grads) at CP_ARCH's cut in cp_train_rank; (c)
# jamba's first two layers (a Mamba block with an MLP, one with the MoE:
# 16 experts, top 2, d_ff 14336) and (d) xlstm-1.3b as an mLSTM and an
# sLSTM layer, float32, the seeded weights' loss and grads, in
# cp_gathered_rank (the expandable spawn). (c) holds 14.96 GB of weights
# and as much of grads a rank; at N = 1024 the Mamba scan's saved chunk
# states (≈ 10 GB in the recompute of the MoE's block) and the experts'
# grads before they are stacked (15 GB) took the two ranks past the card's
# 80 GB, so N is cut to 256 (the widths stay)
CPG_JAMBA = ("mamba:mlp", "mamba:moe")
CPG_JAMBA_B, CPG_JAMBA_N = 1, 256
CPG_XLSTM_B, CPG_XLSTM_N = 1, 256


@contextlib.contextmanager
def cp_spy():
    """Inside, the gathers over "seq" (`placed.cp_enter` under a "seq"
    axis) and the token count of each hybrid kernel wrapper call
    (`ops.hybrid`) are recorded into the dict yielded."""
    from repro_torch.kernels import ops
    from repro_torch.sharding import placed as P

    seen = {"gathers": 0, "hybrid_tokens": []}
    enter, hybrid = P.cp_enter, ops.hybrid

    def counted_enter(x):
        seen["gathers"] += P.cp_size() > 1
        return enter(x)

    def counted_hybrid(q, *a, **kw):
        seen["hybrid_tokens"].append(q.shape[2])
        return hybrid(q, *a, **kw)

    P.cp_enter, ops.hybrid = counted_enter, counted_hybrid
    try:
        yield seen
    finally:
        P.cp_enter, ops.hybrid = enter, hybrid


def cp_leaf_errors(grads: dict, ref: dict, dev) -> dict:
    """{leaf: (Σ(g - r)², Σr², numel)} of the card's grads against the
    host's reference, one leaf on the card at a time."""
    out = {}
    for name, r in ref.items():
        r = r.to(dev)
        g = grads[name].float()
        out[name] = ((g - r.float()).square().sum().item(),
                     r.float().square().sum().item(), r.numel())
        del r
    return out


def cp_worst(errs: dict) -> tuple:
    """(leaf, |g - r| / |r|) of the leaf that differs most; the
    input-gate biases' grads (PSSM_VANISHING) floored at PSSM_GRAD_FLOOR
    of the largest leaf's RMS grad, as [placed ssm train] holds them."""
    floor2 = PSSM_GRAD_FLOOR ** 2 * max(r2 / n for _, r2, n in errs.values())
    e = {name: math.sqrt(d2 / max(r2, floor2 * n if name.endswith(
        PSSM_VANISHING) else 0.0, 1e-60)) for name, (d2, r2, n)
        in errs.items()}
    worst = max(e, key=e.get)
    return worst, e[worst]


def cp_gathered(rank, dev, mesh, cases) -> dict:
    """[cp train]'s gathered-mixer cases on this rank: for each (label,
    cfg, batches, n_steps), rank 0 alone takes --cp 1 (the seeded
    weights' loss and grads, the grads kept on the host, then n_steps
    AdamW steps), then both ranks --cp 2 on `mesh`; rank 0 holds each
    leaf against --cp 1. {label: readings}."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (make_grad_fn, make_train_step,
                                          pick_optimizer)
    from repro_torch.models import init_model
    from repro_torch.models.param import count_params
    from repro_torch.optim.grad_utils import leaves
    from repro_torch.sharding import placed as P

    def timed(fn):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        ops.reset_launch_counts()
        e0.record()
        res = fn()
        e1.record()
        e1.synchronize()
        return res, e0.elapsed_time(e1), ops.launch_counts()

    def run(cfg, batches, n_steps, mesh_):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_model(cfg, seed=0, device=dev)
        rows = batches
        if mesh_ is not None:
            params = P.Placement(cfg, mesh_).place(params)
            rows = [P.shard_batch(b, mesh_) for b in batches]
        P.reset_asked()
        with cp_spy() as seen:
            (loss, _, grads), ms, launches = timed(
                lambda: make_grad_fn(cfg, mesh=mesh_)(params, rows[0]))
            res = {"loss": loss.item(), "grad_ms": ms,
                   "grad_launches": launches, "gathers": seen["gathers"],
                   "gathered_bytes": P.asked["all-gather"],
                   "grad_hybrid_tokens": list(seen["hybrid_tokens"])}
            grads = dict(leaves(grads if mesh_ is None
                                else P.full(grads, mesh_)))
            if mesh_ is None:
                grads = {n: g.cpu() for n, g in grads.items()}
            losses, ms, launches, tokens = [], [], [], []
            if n_steps:
                _, opt = pick_optimizer(cfg, count_params(params), lr=3e-4,
                                        total_steps=n_steps)
                state = (opt[0](params) if mesh_ is None else
                         P.Placement(cfg, mesh_).init_opt_state(opt[0],
                                                                params))
                step = make_train_step(cfg, opt, mesh=mesh_)
                for i in range(n_steps):
                    del seen["hybrid_tokens"][:]
                    (params, state, m), t, c = timed(
                        lambda: step(params, state, rows[i]))
                    losses.append(m["loss"].item())
                    ms.append(t)
                    launches.append(c)
                    tokens.append(list(seen["hybrid_tokens"]))
                del state
        res.update(losses=losses, step_ms=ms, step_launches=launches,
                   step_hybrid_tokens=tokens,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del params
        return res, grads

    out = {}
    for label, cfg, batches, n_steps in cases:
        t0 = time.monotonic()
        one = ref = None
        if rank == 0:
            one, ref = run(cfg, batches, n_steps, None)
        dist.barrier()
        got, grads = run(cfg, batches, n_steps, mesh)
        if rank == 0:
            got["errs"] = cp_leaf_errors(grads, ref, dev)
            got["one"] = one
        del grads, ref
        torch.cuda.empty_cache()
        dist.barrier()
        got["seconds"] = time.monotonic() - t0
        out[label] = got
    return out


def cp_gathered_rank(rank, world):
    """A [cp train] rank of the expandable spawn: (c) jamba's first two
    layers and (d) xlstm-1.3b cut to an mLSTM and an sLSTM layer on
    (data 1, seq 2), the seeded weights' loss and grads against --cp 1."""
    dev = _moe_rank_setup()
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import make_test_mesh

    del world
    f32 = dict(param_dtype="float32", activ_dtype="float32")
    jamba = get_config("jamba-v0.1-52b", pattern=CPG_JAMBA,
                       n_layers=len(CPG_JAMBA), **f32)
    xlstm = get_config("xlstm-1.3b", pattern=PSSM_XLSTM,
                       n_layers=len(PSSM_XLSTM), **f32)
    cases = []
    for label, cfg, b, n in (("jamba-v0.1-52b", jamba, CPG_JAMBA_B,
                              CPG_JAMBA_N),
                             ("xlstm-1.3b", xlstm, CPG_XLSTM_B,
                              CPG_XLSTM_N)):
        cases.append((label, cfg, [SyntheticLM(cfg.vocab_size, n, seed=0)
                                   .batch(0, b)], 0))
    return cp_gathered(rank, dev, make_test_mesh((1, 2), ("data", "seq")),
                       cases)


def cp_case_summary(label, r0, r1, cfg, b, n, want: dict) -> tuple:
    """(readings, ok) of one gathered-mixer case of [cp train] from its
    two ranks' results: every loss within TRAIN_LOSS_TOL of --cp 1, the
    worst leaf within TRAIN_GRAD_TOL, launches a rank `want` in the grad
    fn and each step, every hybrid kernel call on the whole sequence."""
    one = r0["one"]
    leaf, gerr = cp_worst(r0["errs"])
    diffs = [abs(r0["loss"] - one["loss"])] + [
        abs(a - c) for a, c in zip(r0["losses"], one["losses"])]
    hyb = want.get("hybrid_causal", 0)
    tokens_ok = all(r["grad_hybrid_tokens"] == [n] * hyb
                    and all(t == [n] * hyb for t in r["step_hybrid_tokens"])
                    for r in (r0, r1))
    launches_ok = all(c == want for r in (r0, r1) for c in
                      [r["grad_launches"]] + r["step_launches"])
    ok = (max(diffs) <= TRAIN_LOSS_TOL and gerr <= TRAIN_GRAD_TOL
          and len(r0["losses"]) == len(one["losses"])
          and all(math.isfinite(x) for x in [r0["loss"]] + r0["losses"])
          and launches_ok and tokens_ok and r0["gathers"] > 0)
    # bytes each rank sends in one gather: its token shard [b, n/2, d]
    shard = b * (n // 2) * cfg.d_model * 4
    out = {"arch": cfg.name, "attn": str(cfg.attn), "n_layers": cfg.n_layers,
           "pattern": list(cfg.pattern), "batch": b, "seq": n,
           "dtype": "float32", "remat": cfg.remat,
           "steps": len(r0["losses"]), "loss_diffs": diffs,
           "worst_leaf": leaf, "worst_grad_err": gerr,
           "grad_ms_ranks": [r0["grad_ms"], r1["grad_ms"]],
           "grad_ms_cp1": one["grad_ms"],
           "step_ms_ranks": [r0["step_ms"], r1["step_ms"]],
           "step_ms_cp1": one["step_ms"],
           "peak_gb_ranks": [r0["peak_gb"], r1["peak_gb"]],
           "peak_gb_cp1": one["peak_gb"],
           "launches_per_rank_grad_fn": r0["grad_launches"],
           "launches_per_rank_step": r0["step_launches"][-1:] or None,
           "launches_ok": launches_ok, "hybrid_tokens_ok": tokens_ok,
           "gathers_per_grad_fn": r0["gathers"],
           "gathered_bytes_per_grad_fn": r0["gathered_bytes"],
           "gathered_bytes_per_gather": (r0["gathered_bytes"]
                                         / max(r0["gathers"], 1)),
           "gathered_bytes_per_gather_planned": shard,
           "seconds": [r0["seconds"], r1["seconds"]],
           "ranks_on_one_card": 2}
    ok = ok and out["gathered_bytes_per_gather"] == shard
    what = (f"cut to {cfg.n_layers} layers, {cfg.attn}"
            if cfg.pattern == ("attn:mlp",) else
            f"cut to {'+'.join(cfg.pattern)}")
    phase("cp train", f"({label}) {cfg.name} {what}, float32, B={b} "
          f"N={n}, remat {cfg.remat}: --cp 2 "
          f"on 2 ranks of the card against --cp 1: loss |diff| "
          f"{', '.join(f'{d:.3e}' for d in diffs)} (tol {TRAIN_LOSS_TOL}); "
          f"worst leaf {leaf} {gerr:.3e} (tol {TRAIN_GRAD_TOL}); grad fn ms "
          f"per rank {r0['grad_ms']:.1f} / {r1['grad_ms']:.1f} against "
          f"{one['grad_ms']:.1f}"
          + (f"; step ms per rank {r0['step_ms']} / {r1['step_ms']} against "
             f"{one['step_ms']}" if r0["step_ms"] else "")
          + f"; peak GB per rank {r0['peak_gb']:.2f}, {r1['peak_gb']:.2f} "
          f"({one['peak_gb']:.2f} at --cp 1); launches per rank "
          f"{r0['grad_launches']} a grad fn"
          + (f", {r0['step_launches'][-1]} a step" if r0["step_launches"]
             else "")
          + f"; {r0['gathers']} gathers over 'seq' a grad fn, "
          f"{out['gathered_bytes_per_gather'] / 1e6:.2f} MB sent a rank a "
          f"gather (planned {shard / 1e6:.2f}); hybrid calls on N = "
          f"{sorted(set(r0['grad_hybrid_tokens'])) or 'none'} "
          f"(two ranks share the card: not a multi-card speedup)")
    return out, ok


def cp_gathered_phase() -> dict:
    """[cp train] (c) and (d): jamba's Mamba and MoE layers and xlstm's
    mLSTM and sLSTM on (data 1, seq 2), their sequence gathered."""
    from repro_torch.configs import get_config

    _free_parent()
    (r0, r1), secs = two_ranks(cp_gathered_rank, timeout=900)
    zero = {"fastmax_causal": 0, "fastmax_causal_bwd": 0,
            "fastmax_decode": 0, "fastmax_noncausal_moments": 0,
            "fastmax_noncausal_combine": 0, "hybrid_causal": 0}
    out, ok = {"seconds_c_d": secs}, True
    for tag, label, pattern, b, n in (
            ("c", "jamba-v0.1-52b", CPG_JAMBA, CPG_JAMBA_B, CPG_JAMBA_N),
            ("d", "xlstm-1.3b", PSSM_XLSTM, CPG_XLSTM_B, CPG_XLSTM_N)):
        cfg = get_config(label, pattern=pattern, n_layers=len(pattern))
        out[label], good = cp_case_summary(tag, r0[label], r1[label], cfg,
                                           b, n, zero)
        ok = ok and good
    if not ok:
        fail(f"cp train: a gathered SSM or MoE mixer's --cp 2 disagrees "
             f"with --cp 1: {out}")
    return out


def cp_train_rank(rank, world, n_steps):
    """A [cp train] rank: rank 0 first takes the --cp 1 references alone
    (one loss and grad, then n_steps AdamW steps, on the kernel path and
    on the plain fastmax2-chunked path), then both ranks the same under
    --cp 2 on the kernel path; rank 0 compares."""
    dev = _rank_setup()
    import torch.distributed as dist

    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.kernels import sharded as S
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import (make_grad_fn, make_train_step,
                                          pick_optimizer)
    from repro_torch.models import init_model
    from repro_torch.models.param import count_params
    from repro_torch.optim.grad_utils import leaves
    from repro_torch.sharding import placed as P

    del world
    # float32: after an AdamW update a bf16 model's losses move apart by
    # more than TRAIN_LOSS_TOL between any two paths that sum in other
    # orders (the first update is about lr x sign(grad), and bf16 weights
    # round it), so the comparison is made where the update is resolved
    cfg = get_config(CP_ARCH, n_layers=CP_LAYERS, remat="none",
                     param_dtype="float32", activ_dtype="float32",
                     attn=AttentionSpec.parse("fastmax2-kernel"))
    data = SyntheticLM(cfg.vocab_size, CP_N, seed=0)
    batches = [data.batch(i, CP_B) for i in range(n_steps)]
    mesh = make_test_mesh((1, 2), ("data", "seq"))

    def run(mesh_, cfg=cfg):
        params = init_model(cfg, seed=0, device=dev)
        _, opt = pick_optimizer(cfg, count_params(params), lr=3e-4,
                                total_steps=n_steps)
        rows = batches
        if mesh_ is None:
            state = opt[0](params)
        else:
            # the placed step over "data" (of size 1 here) and "seq"
            placement = P.Placement(cfg, mesh_)
            params = placement.place(params)
            state = placement.init_opt_state(opt[0], params)
            rows = [P.shard_batch(b, mesh_) for b in batches]
        loss, _, grads = make_grad_fn(cfg, mesh=mesh_)(params, rows[0])
        grads = dict(leaves(grads if mesh_ is None
                            else P.full(grads, mesh_)))
        step = make_train_step(cfg, opt, mesh=mesh_)
        losses, ms, launches = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(n_steps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            ops.reset_launch_counts()
            e0.record()
            params, state, m = step(params, state, rows[i])
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
            launches.append(ops.launch_counts())
            losses.append(m["loss"].item())
        peak = torch.cuda.max_memory_allocated() / 1e9
        del params, state
        return loss.item(), grads, losses, ms, launches, peak

    ref = plain = None
    if rank == 0:
        ref = run(None)
        # the control: a second single-process path that sums in other
        # orders, read against --cp 1 as --cp 2 is
        plain = run(None, dataclasses.replace(
            cfg, attn=AttentionSpec.parse("fastmax2-chunked")))
        plain = (plain[0], worst_leaf(plain[1], ref[1]), plain[2])
    dist.barrier()
    torch.cuda.empty_cache()
    loss, grads, losses, ms, launches, peak = run(mesh)
    want = {"fastmax_causal": CP_LAYERS, "fastmax_causal_bwd": CP_LAYERS,
            "fastmax_decode": 0, "fastmax_noncausal_moments": 0,
            "fastmax_noncausal_combine": 0, "hybrid_causal": 0}
    out = {"rank": rank, "step_ms": ms, "peak_gb": peak,
           "launches": launches[-1],
           "launches_ok": all(c == want for c in launches)}
    if rank == 0:
        leaf, gerr = worst_leaf(grads, ref[1])
        out.update(
            loss_cp2=loss, loss_cp1=ref[0], losses_cp2=losses,
            losses_cp1=ref[2], step_ms_cp1=ref[3], peak_gb_cp1=ref[5],
            loss_plain=plain[0], losses_plain=plain[2],
            worst_leaf=leaf, worst_grad_err=gerr,
            worst_leaf_plain=plain[1][0], worst_grad_err_plain=plain[1][1],
            carry_bytes=S.cp_carry_bytes(b=CP_B, hkv=cfg.n_kv_heads,
                                         d=cfg.head_dim, dv=cfg.head_dim,
                                         p=2))
    del grads, ref, plain
    torch.cuda.empty_cache()
    # (a) the hybrid, (b) softmax: their sequence gathered over "seq"
    out["gathered"] = cp_gathered(rank, dev, mesh, [
        ("hybrid2-kernel", dataclasses.replace(
            cfg, attn=AttentionSpec.parse("hybrid2-kernel")), batches,
         n_steps),
        ("softmax", dataclasses.replace(
            cfg, attn=AttentionSpec.parse("softmax")), batches[:1], 0)])
    return out


def cp_train_phase() -> dict:
    """[cp train]: full-width qwen3 cut to CP_LAYERS layers, --cp 2 on
    two ranks of the card against --cp 1, then the CLI under torchrun."""
    (r0, r1), secs = two_ranks(cp_train_rank, (CP_STEPS,), timeout=600)
    # every loss (the seeded weights' grad fn's, then each step's) within
    # TRAIN_LOSS_TOL of --cp 1, the grads within TRAIN_GRAD_TOL per leaf;
    # the plain path's readings against --cp 1 are printed beside them
    dloss = abs(r0["loss_cp2"] - r0["loss_cp1"])
    steps_diff = [abs(a - b) for a, b in zip(r0["losses_cp2"],
                                            r0["losses_cp1"])]
    control = [abs(r0["loss_plain"] - r0["loss_cp1"])] + [
        abs(a - b) for a, b in zip(r0["losses_plain"], r0["losses_cp1"])]
    ok = (max([dloss] + steps_diff) <= TRAIN_LOSS_TOL
          and r0["worst_grad_err"] <= TRAIN_GRAD_TOL
          and len(steps_diff) == CP_STEPS
          and r0["launches_ok"] and r1["launches_ok"]
          and all(math.isfinite(x) for x in r0["losses_cp2"]))
    med = [sorted(r["step_ms"])[len(r["step_ms"]) // 2] for r in (r0, r1)]
    med_cp1 = sorted(r0["step_ms_cp1"])[len(r0["step_ms_cp1"]) // 2]
    out = {"arch": CP_ARCH, "n_layers": CP_LAYERS, "batch": CP_B,
           "seq": CP_N, "steps": CP_STEPS, "dtype": "float32",
           "loss_diff": dloss, "step_loss_diff": steps_diff,
           "plain_loss_diffs": control,
           "losses_plain": r0["losses_plain"],
           "worst_leaf": r0["worst_leaf"],
           "worst_grad_err": r0["worst_grad_err"],
           "worst_leaf_plain": r0["worst_leaf_plain"],
           "worst_grad_err_plain": r0["worst_grad_err_plain"],
           "losses_cp2": r0["losses_cp2"], "losses_cp1": r0["losses_cp1"],
           "step_ms_ranks": [r0["step_ms"], r1["step_ms"]],
           "step_ms_cp1": r0["step_ms_cp1"],
           "tokens_per_s_cp2": CP_B * CP_N / (max(med) / 1e3),
           "tokens_per_s_cp1": CP_B * CP_N / (med_cp1 / 1e3),
           "peak_gb_ranks": [r0["peak_gb"], r1["peak_gb"]],
           "peak_gb_cp1": r0["peak_gb_cp1"],
           "launches_per_rank_step": r0["launches"],
           "carry_bytes_per_boundary_per_layer": r0["carry_bytes"],
           "seconds": secs, "ranks_on_one_card": 2}
    phase("cp train", f"{CP_ARCH} cut to {CP_LAYERS} layers, float32, "
          f"AdamW B={CP_B} N={CP_N}: --cp 2 on 2 ranks of the card against "
          f"--cp 1: loss |diff| at the seeded weights {dloss:.3e}, at each "
          f"step {', '.join(f'{d:.3e}' for d in steps_diff)} (tol "
          f"{TRAIN_LOSS_TOL}); worst leaf {r0['worst_leaf']} "
          f"{r0['worst_grad_err']:.3e} (tol {TRAIN_GRAD_TOL}); the plain "
          f"path against --cp 1 (control, not held): loss |diff| "
          f"{', '.join(f'{d:.3e}' for d in control)}, worst leaf "
          f"{r0['worst_leaf_plain']} {r0['worst_grad_err_plain']:.3e}; "
          f"step ms "
          f"per rank {r0['step_ms']} / {r1['step_ms']} against "
          f"{r0['step_ms_cp1']} at --cp 1; {out['tokens_per_s_cp2']:.0f} global tokens/s "
          f"against {out['tokens_per_s_cp1']:.0f}; peak GB per rank "
          f"{r0['peak_gb']:.2f}, {r1['peak_gb']:.2f} ({r0['peak_gb_cp1']:.2f}"
          f" at --cp 1); launches per rank per step {r0['launches']}; "
          f"carry {r0['carry_bytes'] / 1e6:.1f} MB per boundary per layer "
          f"(two ranks share the card: not a multi-card speedup)")
    if not ok:
        fail(f"cp train: --cp 2 disagrees with --cp 1, or its launches per "
             f"step are not one prefill and one backward per layer: {out}")
    # (a) the hybrid kernel once a layer a rank in each forward, on the
    # whole gathered sequence; (b) softmax, no launch
    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_config

    zero = {k: 0 for k in r0["launches"]}
    out["gathered"] = {}
    for tag, attn in (("a", "hybrid2-kernel"), ("b", "softmax")):
        want = dict(zero, hybrid_causal=CP_LAYERS if tag == "a" else 0)
        cfg = get_config(CP_ARCH, n_layers=CP_LAYERS, remat="none",
                         attn=AttentionSpec.parse(attn))
        out["gathered"][attn], good = cp_case_summary(
            tag, r0["gathered"][attn], r1["gathered"][attn], cfg, CP_B,
            CP_N, want)
        if not good:
            fail(f"cp train: gathered {attn} --cp 2 disagrees with --cp 1, "
                 f"or its launches or hybrid calls are not one a layer on "
                 f"the whole sequence: {out['gathered'][attn]}")
    # (e) the CLI, as a user starts it: the kernel path and jamba's mixers
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    out["cli_seconds"] = {}
    for model in (["--attn", "fastmax2-kernel"],
                  ["--arch", "jamba-v0.1-52b"]):
        t0 = time.monotonic()
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
               "--cp", "2", "--smoke", *model, "--steps", "2", "--batch",
               "2", "--seq", "256", "--log-every", "1"]
        cli = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             timeout=300)
        lines = [ln for ln in cli.stdout.splitlines() if ln.startswith(
            ("context parallelism", "arch", "step", "final"))]
        for ln in lines:
            print(f"  torchrun: {ln}")
        if cli.returncode != 0 or not any(ln.startswith("final loss")
                                          for ln in lines):
            print(cli.stdout[-4000:], cli.stderr[-4000:])
            fail(f"cp train: torchrun --nproc-per-node 2 ... --cp 2 "
                 f"{' '.join(model)} failed")
        secs = time.monotonic() - t0
        out["cli_seconds"][" ".join(model)] = secs
        phase("cp train", f"torchrun --nproc-per-node 2 -m "
              f"repro_torch.launch.train --cp 2 --smoke {' '.join(model)}: "
              f"2 steps, loss printed ({secs:.1f} s)")
    return out


# placed phases: full-width qwen3 cut to PLACED_LAYERS layers, float32,
# on two gloo ranks of the card: (data 2, model 1) is FSDP, (data 1,
# model 2) tensor parallelism (8 kv heads over 2: the heads plan) with the
# residual split over "model" along the sequence between blocks
PLACED_ARCH, PLACED_LAYERS, PLACED_B, PLACED_N, PLACED_STEPS = (
    "qwen3-1.7b", 2, 2, 2048, 1)
PLACED_MESHES = ((2, 1), (1, 2))
PLACED_PROMPT, PLACED_GEN = 1024, 17      # a prefill and 16 decode tokens


def record_first_grads(first: dict, take=None) -> None:
    """Make `launch.steps.make_train_step` record its grad fn's first
    call's loss and grads in `first` (until it is cleared); `take(grads)`,
    if given, is recorded in place of the grads (so that the step's grads
    are not held past the clip)."""
    from repro_torch.launch import steps as ST

    make_grad_fn = ST.make_grad_fn

    def recording(*a, **kw):
        fn = make_grad_fn(*a, **kw)

        def grad_fn(params, b):
            loss, metrics, grads = fn(params, b)
            if not first:
                first.update(loss=loss.item(),
                             grads=grads if take is None else take(grads))
            return loss, metrics, grads
        return grad_fn

    ST.make_grad_fn = recording


def placed_cfg():
    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_config

    return get_config(PLACED_ARCH, n_layers=PLACED_LAYERS,
                      param_dtype="float32", activ_dtype="float32",
                      attn=AttentionSpec.parse("fastmax2-kernel"))


def leaf_sums(local, ref) -> dict:
    """{leaf: (|local - ref's slice|², |ref's slice|², split)} of a tree
    of placed shards against the whole tree `ref` on the host: the
    slices by each leaf's spec, `split` whether a mesh axis of size > 1
    cuts it (the ranks' sums then add up to the whole leaf's)."""
    from repro_torch.kernels.sharded import shard_local
    from repro_torch.optim.grad_utils import leaves
    from repro_torch.sharding import placed as P

    out = {}
    for name, x in leaves(local):
        spec, mesh = P.spec_of(x), P.active().mesh
        want = ref[name] if spec is None else shard_local(ref[name], spec,
                                                          mesh)
        got = x.detach().float().cpu()
        split = any(P.active().sizes[a] > 1 for a in P.split_axes(spec))
        out[name] = (float((got - want).square().sum()),
                     float(want.square().sum()), split)
    return out


def placed_train_rank(rank, world, n_steps):
    """A [placed train] rank: each rank in turn first takes one process's
    AdamW steps alone (the reference, kept on the host), then both the
    placed step
    on each mesh of PLACED_MESHES: the first step's grads and the final
    parameters are held to the reference's slices on each rank (no
    gather), the last step counted (`OpCount`, and the bytes autograd
    saves: `SavedBytes`)."""
    dev = _rank_setup()
    import contextlib

    import torch.distributed as dist

    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.op_analysis import OpCount, SavedBytes, \
        tree_bytes
    from repro_torch.models import init_model
    from repro_torch.models.param import count_params
    from repro_torch.optim.grad_utils import leaves
    from repro_torch.sharding import placed as P

    del world
    cfg = placed_cfg()
    raw = SyntheticLM(cfg.vocab_size, PLACED_N, seed=0).batch(0, PLACED_B)
    batch = {k: torch.as_tensor(raw[k], dtype=torch.int32, device=dev)
             for k in ("tokens", "targets")}
    # the train step's grad fn, recording its first call's loss and grads
    first = {}
    record_first_grads(first)

    def run(shape, ref=None):
        mesh = None if shape is None else make_test_mesh(
            shape, ("data", "model"))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        first.clear()
        params = init_model(cfg, seed=0, device=dev)
        _, opt = ST.pick_optimizer(cfg, count_params(params), lr=3e-4,
                                   total_steps=n_steps)
        b = batch
        if mesh is None:
            state = opt[0](params)
        else:
            placement = P.Placement(cfg, mesh)
            params = placement.place(params)
            state = placement.init_opt_state(opt[0], params)
            b = P.shard_batch(batch, mesh)
        step = ST.make_train_step(cfg, opt, mesh=mesh)
        arg_bytes = tree_bytes((params, state, b))
        P.reset_asked()
        losses, ms, launches, count, saved = [], [], [], None, None
        for i in range(n_steps):
            # the placed step's last step is counted (`OpCount`, whose
            # Python mode lengthens it): [dryrun] holds it to meta; every
            # run's last step counts the bytes autograd saves
            last = i == n_steps - 1
            counted = mesh is not None and last
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            ops.reset_launch_counts()
            with OpCount("cuda") if counted else contextlib.nullcontext() \
                    as c, SavedBytes() if last \
                    else contextlib.nullcontext() as sv:
                e0.record()
                params, state, m = step(params, state, b)
                e1.record()
            e1.synchronize()
            if last:
                saved = {"total": sv.total, "block_inputs": sv.block_inputs}
            ms.append(e0.elapsed_time(e1))
            launches.append({k: v for k, v in ops.launch_counts().items()
                             if v})
            losses.append(m["loss"].item())
            if counted:
                count = {"launches": c.launches(),
                         "kernel_work": c.kernel_work(),
                         "matmul_flops": c.result()["matmul_flops"],
                         "argument_bytes": arg_bytes,
                         "block_input_bytes": sv.block_inputs}
        out = dict(loss=first["loss"], losses=losses, ms=ms,
                   launches=launches, count=count, arg_bytes=arg_bytes,
                   saved=saved,
                   peak=torch.cuda.max_memory_allocated() / 1e9,
                   coll={k: (P.asked[k] / n_steps, P.asked_ms[k] / n_steps)
                         for k in P.asked})
        if mesh is None:
            out.update(grads={n: x.detach().float().cpu()
                              for n, x in leaves(first["grads"])},
                       final={n: x.detach().float().cpu()
                              for n, x in leaves(params)})
        else:
            with placement.active():
                out.update(grads=leaf_sums(first["grads"], ref["grads"]),
                           final=leaf_sums(params, ref["final"]))
        first.clear()
        del params, state, b
        return out

    ref = None
    for r in range(2):          # one process at a time holds the card
        if rank == r:
            ref = run(None)
        dist.barrier()
    want = {"fastmax_causal": 2 * PLACED_LAYERS,
            "fastmax_causal_bwd": PLACED_LAYERS}
    out = {"rank": rank, "meshes": {}, "step_ms_one": ref["ms"],
           "peak_gb_one": ref["peak"], "argument_bytes_one": ref["arg_bytes"],
           "saved_one": ref["saved"],
           "launches_one": ref["launches"][-1], "loss_one": ref["loss"],
           "losses_one": ref["losses"]}
    for shape in PLACED_MESHES:
        r = run(shape, ref)
        out["meshes"]["x".join(map(str, shape))] = {
            "step_ms": r["ms"], "peak_gb": r["peak"],
            "argument_bytes": r["arg_bytes"], "collectives": r["coll"],
            "saved": r["saved"],
            "launches": r["launches"][-1],
            "launches_ok": all(c == want for c in r["launches"]),
            "count": r["count"], "loss": r["loss"], "losses": r["losses"],
            "grad_sums": r["grads"], "param_sums": r["final"]}
        del r
        dist.barrier()
    return out


def worst_sums(ranks, key) -> tuple:
    """(leaf, relative Frobenius error) of the leaf that differs most, its
    squared sums added over the ranks where a mesh axis splits it."""
    errs = {}
    for name, (d2, r2, split) in ranks[0][key].items():
        if split:
            d2 = sum(r[key][name][0] for r in ranks)
            r2 = sum(r[key][name][1] for r in ranks)
        errs[name] = math.sqrt(d2 / max(r2, 1e-60))
    name = max(errs, key=errs.get)
    return name, errs[name]


def placed_train_phase() -> dict:
    """[placed train]: the placed step on two ranks of the card, on an
    FSDP mesh and a tensor-parallel one, against one process's step."""
    ranks, secs = two_ranks(placed_train_rank, (PLACED_STEPS,), timeout=900)
    r0 = ranks[0]
    ok = True
    out = {"arch": PLACED_ARCH, "n_layers": PLACED_LAYERS,
           "batch": PLACED_B, "seq": PLACED_N, "steps": PLACED_STEPS,
           "dtype": "float32", "seconds": secs,
           "step_ms_one": r0["step_ms_one"], "peak_gb_one": r0["peak_gb_one"],
           "argument_bytes_one": r0["argument_bytes_one"],
           "launches_one": r0["launches_one"], "saved_one": r0["saved_one"],
           "meshes": {}}
    cfg = placed_cfg()
    # the residual a checkpoint keeps: every layer's input, float32
    whole = PLACED_LAYERS * PLACED_B * PLACED_N * cfg.d_model * 4
    for key in r0["meshes"]:
        m0 = r0["meshes"][key]
        rows = [r["meshes"][key] for r in ranks]
        gleaf, gerr = worst_sums(rows, "grad_sums")
        pleaf, perr = worst_sums(rows, "param_sums")
        diffs = [abs(m0["loss"] - r0["loss_one"])] + [
            abs(a - b) for a, b in zip(m0["losses"], r0["losses_one"])]
        m0.update(worst_grad_leaf=gleaf, worst_grad_err=gerr,
                  worst_param_leaf=pleaf, worst_param_err=perr,
                  losses_one=r0["losses_one"])
        # a rank's rows (1/data of them), its 1/model of the sequence
        data, model = map(int, key.split("x"))
        want_res = whole // data // (model if PLACED_N % model == 0 else 1)
        good = (max(diffs) <= TRAIN_LOSS_TOL
                and gerr <= TRAIN_GRAD_TOL and perr <= TRAIN_GRAD_TOL
                and len(m0["losses"]) == PLACED_STEPS
                and all(r["launches_ok"] for r in rows)
                and all(r["saved"]["block_inputs"] == want_res
                        for r in rows)
                and r0["saved_one"]["block_inputs"] == whole
                and all(math.isfinite(x) for x in m0["losses"]))
        ok = ok and good
        out["meshes"][key] = {
            "loss_diffs": diffs, "losses": m0["losses"],
            "losses_one": m0["losses_one"],
            "worst_grad_leaf": gleaf, "worst_grad_err": gerr,
            "worst_param_leaf": pleaf, "worst_param_err": perr,
            "step_ms_ranks": [r["step_ms"] for r in rows],
            "peak_gb_ranks": [r["peak_gb"] for r in rows],
            "argument_bytes_ranks": [r["argument_bytes"] for r in rows],
            "collectives_ranks": [r["collectives"] for r in rows],
            "launches_per_rank_step": [r["launches"] for r in rows],
            "count_ranks": [r["count"] for r in rows],
            "saved_ranks": [r["saved"] for r in rows],
            "block_input_bytes_want": want_res}
        coll = ", ".join(f"{k} {b / 1e6:.1f} MB {t:.1f} ms"
                         for k, (b, t) in sorted(rows[0]["collectives"]
                                                  .items()))
        saved = [(round(r["saved"]["total"] / 1e6, 1),
                  round(r["saved"]["block_inputs"] / 1e6, 1)) for r in rows]
        phase("placed train", f"{PLACED_ARCH} cut to {PLACED_LAYERS} "
              f"layers, float32, AdamW B={PLACED_B} N={PLACED_N}, mesh "
              f"(data, model) = ({key.replace('x', ', ')}) on 2 ranks of "
              f"the card against one process: loss |diff| "
              f"{', '.join(f'{d:.3e}' for d in diffs)} (tol "
              f"{TRAIN_LOSS_TOL}); worst grad {m0['worst_grad_leaf']} "
              f"{m0['worst_grad_err']:.3e}, worst updated parameter "
              f"{m0['worst_param_leaf']} {m0['worst_param_err']:.3e} (tol "
              f"{TRAIN_GRAD_TOL}); argument bytes per rank "
              f"{[r['argument_bytes'] for r in rows]} (one process "
              f"{r0['argument_bytes_one']}); peak GB per rank "
              f"{[round(r['peak_gb'], 3) for r in rows]} (one process "
              f"{r0['peak_gb_one']:.3f}); step ms per rank (the last "
              f"under the count) {[r['step_ms'] for r in rows]} (one process "
              f"{r0['step_ms_one']}); rank 0's collectives per step: "
              f"{coll}; launches per rank per step "
              f"{[r['launches'] for r in rows]}; MB autograd saved in the "
              f"last step per rank (all, of them the blocks' inputs) "
              f"{saved} (want {want_res / 1e6:.1f}; one process "
              f"{r0['saved_one']['total'] / 1e6:.1f}, "
              f"{r0['saved_one']['block_inputs'] / 1e6:.1f} of "
              f"{whole / 1e6:.1f})")
    if not ok:
        fail(f"placed train: the placed step disagrees with one process, "
             f"its launches per step are not two prefills and one "
             f"backward per layer, or a rank's checkpointed residual is "
             f"not its rows' 1/model of the sequence: {out}")
    return out


def placed_serve_rank(rank, world):
    """A [placed serve] rank: rank 0 first takes one process's generate()
    alone, then both ranks prefill and decode on the (data 1, model 2)
    mesh with the placed steps."""
    dev = _rank_setup()
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import init_decode_state, init_model
    from repro_torch.sharding import placed as P
    from repro_torch.sharding.rules import use_mesh

    del world
    cfg = placed_cfg()
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (PLACED_B, PLACED_PROMPT),
                            generator=gen).to(dev)
    params = init_model(cfg, seed=0, device=dev)
    ref = launches_one = None
    if rank == 0:
        ops.reset_launch_counts()
        ref = generate(params, cfg, prompts, PLACED_GEN).cpu()
        launches_one = {k: v for k, v in ops.launch_counts().items() if v}
    dist.barrier()
    mesh = make_test_mesh((1, 2), ("data", "model"))
    placed = P.Placement(cfg, mesh).place(params)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with use_mesh(mesh):
        state = init_decode_state(cfg, PLACED_B, PLACED_PROMPT + PLACED_GEN,
                                  device=dev)
    m2 = state["blocks_0"].moments[2]
    prefill = make_prefill_step(cfg, mesh=mesh)
    step = make_serve_step(cfg, mesh=mesh)
    positions = PLACED_PROMPT + torch.arange(PLACED_GEN - 1, device=dev)
    ops.reset_launch_counts()
    P.reset_asked()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    tok, state = prefill(placed, state, prompts)
    ev[1].record()
    toks = [tok]
    for i in range(PLACED_GEN - 1):
        tok, state = step(placed, state, tok, positions[i])
        toks.append(tok)
    ev[2].record()
    ev[2].synchronize()
    out = torch.stack(toks, 1).cpu()
    return {"rank": rank, "launches": {k: v for k, v in
                                       ops.launch_counts().items() if v},
            "launches_one": launches_one,
            "equal": None if ref is None else bool(torch.equal(out, ref)),
            "tokens": out.tolist(),
            "prefill_ms": ev[0].elapsed_time(ev[1]),
            "decode_ms_per_token": ev[1].elapsed_time(ev[2])
            / (PLACED_GEN - 1),
            "moments_m2_shape": list(m2.shape),
            "collectives": {k: (P.asked[k], P.asked_ms[k])
                            for k in P.asked},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def placed_serve_phase() -> dict:
    """[placed serve]: prefill and decode on (data 1, model 2), the decode
    kernel on each rank's kv heads, against one process's generate()."""
    (r0, r1), secs = two_ranks(placed_serve_rank, timeout=600)
    want = {"fastmax_causal": PLACED_LAYERS,
            "fastmax_decode": (PLACED_GEN - 1) * PLACED_LAYERS}
    ok = (r0["equal"] and r1["tokens"] == r0["tokens"]
          and r0["launches"] == r1["launches"] == want
          and r0["launches_one"] == want)
    coll = r0["collectives"]
    out = {"arch": PLACED_ARCH, "n_layers": PLACED_LAYERS,
           "batch": PLACED_B, "prompt": PLACED_PROMPT, "gen": PLACED_GEN,
           "tokens_equal": r0["equal"],
           "launches_ranks": [r0["launches"], r1["launches"]],
           "launches_one": r0["launches_one"],
           "prefill_ms_ranks": [r0["prefill_ms"], r1["prefill_ms"]],
           "decode_ms_per_token_ranks": [r0["decode_ms_per_token"],
                                         r1["decode_ms_per_token"]],
           "moments_m2_shape": r0["moments_m2_shape"],
           "collectives_ranks": [r0["collectives"], r1["collectives"]],
           "peak_gb_ranks": [r0["peak_gb"], r1["peak_gb"]],
           "seconds": secs}
    phase("placed serve", f"{PLACED_ARCH} cut to {PLACED_LAYERS} layers, "
          f"float32, (data 1, model 2) on 2 ranks of the card: B="
          f"{PLACED_B} prompt {PLACED_PROMPT}, a prefill and "
          f"{PLACED_GEN - 1} decode tokens; greedy tokens equal one "
          f"process's generate(): {r0['equal']}; launches per rank "
          f"{r0['launches']} (one process {r0['launches_one']}); each "
          f"rank's m2 moments {r0['moments_m2_shape']} (4 of 8 kv heads); "
          f"prefill ms {out['prefill_ms_ranks']}, decode ms/token "
          f"{out['decode_ms_per_token_ranks']}; peak GB "
          f"{out['peak_gb_ranks']}; rank 0's collectives MB "
          f"{ {k: round(v[0] / 1e6, 2) for k, v in coll.items()} }")
    if not ok:
        fail(f"placed serve: tokens differ from generate(), or the launches "
             f"per rank are not one prefill per layer and one decode per "
             f"layer and token: {out}")
    return out


def placed_meta_counts() -> dict:
    """The placed train step of [placed train] counted on meta as rank 0
    of a fake two-rank world, per mesh: launches, kernel work, matmul
    flops, argument bytes, the checkpointed residual's bytes."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.op_analysis import OpCount, SavedBytes, \
        tree_bytes

    out = {}
    cfg = placed_cfg()
    with D.fake_world(2):
        for shape in PLACED_MESHES:
            mesh = make_test_mesh(shape, ("data", "model"))
            fn, args, _ = D.cell_step(cfg, ShapeSpec(PLACED_N, PLACED_B,
                                                     "train"),
                                      device="meta", mesh=mesh)
            with OpCount("meta") as c, SavedBytes() as sv:
                fn(*args)
            out["x".join(map(str, shape))] = {
                "launches": c.launches(), "kernel_work": c.kernel_work(),
                "matmul_flops": c.result()["matmul_flops"],
                "argument_bytes": tree_bytes(args),
                "block_input_bytes": sv.block_inputs}
    return out


# placed MoE phases: full-width deepseek-v2-236b cut to PMOE_LAYERS layers
# (its first_k_dense layer and one MoE layer of 160 experts, top-6, 2
# shared: 5.519 B params) on two gloo ranks of the card. (data 1, model 2)
# splits the experts (80 a rank), the FFNs, the vocab and MLA's heads (64
# a rank) over "model". The batch split, (data 2, model 1), is held on the
# CPU (tests/test_torch_placed_moe.py on (2, 2) and (4, 1)) and not here:
# its FSDP step staged ≈ 20 GB of gloo collectives through host memory,
# 80 s of the script's time limit (FSDP stays on the card in [placed
# train]). bf16 with Lion (the full config's optimizer: >= 100 B params),
# remat none, one step. Each rank holds the one-process step's slices of
# its shards on the host (bf16, as the leaves are)
PMOE_LAYERS, PMOE_B, PMOE_N, PMOE_STEPS = 2, 2, 1024, 1
PMOE_MESHES = ((1, 2),)
PMOE_PROMPT, PMOE_GEN = 1024, 17          # a prefill and 16 decode tokens


def _moe_rank_setup():
    """`_rank_setup` with the caching allocator's expandable segments (set
    before the rank's first CUDA call): the one-process step peaks at
    ≈ 63 GB of the card's 80 beside the other rank and the parent, and a
    fragmented cache of blocks would not leave room."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    return _rank_setup()


def _free_parent() -> None:
    """Drop the parent's unreachable tensors and cached blocks before the
    ranks take the card, and say what it still holds."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    print(f"  card memory the parent holds: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")


def placed_moe_cfg(dtype: str):
    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_config

    return get_config(MOE_ARCH, n_layers=PMOE_LAYERS, remat="none",
                      param_dtype=dtype, activ_dtype=dtype,
                      attn=AttentionSpec.parse("fastmax2-kernel"))


def shard_sums(local, ref: dict, sizes: dict, count: bool = False) -> dict:
    """{leaf: (|local - ref|², |ref|², split)} of a tree of placed shards
    against the same shards of the one-process run (`ref`, host tensors),
    `split` whether a mesh axis of `sizes` > 1 cuts the leaf; with
    `count`, the shard's elements too."""
    from repro_torch.optim.grad_utils import leaves
    from repro_torch.sharding import placed as P

    out = {}
    for name, x in leaves(local):
        want = ref[name].to(x.device).float()
        got = x.detach().float()
        out[name] = (float((got - want).square().sum()),
                     float(want.square().sum()),
                     any(sizes[a] > 1 for a in P.split_axes(P.spec_of(x))))
        if count:
            out[name] += (x.numel(),)
    return out


@contextlib.contextmanager
def mixer_spy(cfg, mlp: bool = False):
    """Inside, `placed.gather` and the attention entry points record into
    the dict yielded: "whole", the shapes of gathers over "model" that
    return a whole attention leaf (wq, w_uk, w_uv, wo; GQA's wk, wv; with
    `mlp`, the MLP's wi and wo too), and "heads", the (q, k, v) heads of
    every attention call."""
    from repro_torch import attention as A
    from repro_torch.sharding import placed as P

    d, hq, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    if cfg.use_mla:
        whole = {(d, hq, cfg.qk_nope_dim + cfg.qk_rope_dim),
                 (cfg.kv_lora_rank, hq, cfg.qk_nope_dim),
                 (cfg.kv_lora_rank, hq, hd), (hq, hd, d)}
    else:
        whole = {(d, hq, hd), (d, cfg.n_kv_heads, hd), (hq, hd, d)}
    if mlp:
        whole |= {(d, cfg.d_ff), (cfg.d_ff, d)}
    seen = {"whole": [], "heads": set()}
    gather = P.gather
    fns = {"attention": 0, "prefill": 0, "step": 1}    # where q sits
    saved = {name: getattr(A, name) for name in fns}

    def spy_gather(leaf, over, mesh, *, sum_over=()):
        out = gather(leaf, over, mesh, sum_over=sum_over)
        if ("model" in over and "model" in P.split_axes(P.spec_of(leaf))
                and tuple(out.shape) in whole):
            seen["whole"].append(tuple(out.shape))
        return out

    def spy(name):
        def call(*args, **kw):
            q, k, v = args[fns[name]:fns[name] + 3]
            seen["heads"].add((q.shape[1], k.shape[1], v.shape[1]))
            return saved[name](*args, **kw)
        return call

    P.gather = spy_gather
    for name in fns:
        setattr(A, name, spy(name))
    try:
        yield seen
    finally:
        P.gather = gather
        for name, fn in saved.items():
            setattr(A, name, fn)


def coll_lines(tag: str, rows: list, key: str) -> None:
    """Print each rank's collective bytes and host ms by kind."""
    for r, row in enumerate(rows):
        print(f"  {tag} rank {r} collectives: " + ", ".join(
            f"{k} {b / 1e9:.4f} GB {t:.1f} ms"
            for k, (b, t) in sorted(row[key].items())))


def placed_moe_train_rank(rank, world):
    """A [placed moe train] rank: for each mesh of PMOE_MESHES, each rank in
    turn takes one process's step alone and keeps its shards' slices of the
    grads and updated parameters on the host; then both take the placed
    step, held to those slices."""
    dev = _moe_rank_setup()
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.op_analysis import SavedBytes
    from repro_torch.models import init_model
    from repro_torch.models import moe as MOE
    from repro_torch.models.param import count_params
    from repro_torch.optim.grad_utils import leaves
    from repro_torch.sharding import placed as P

    del world
    cfg = placed_moe_cfg("bfloat16")
    n_full = count_params(init_model(get_config(MOE_ARCH), device="meta"))
    raw = SyntheticLM(cfg.vocab_size, PMOE_N, seed=0).batch(0, PMOE_B)
    batch = {k: torch.as_tensor(raw[k], dtype=torch.int32, device=dev)
             for k in ("tokens", "targets")}
    first: dict = {}
    take = [None]       # what the first step's grads are recorded as
    record_first_grads(first, lambda g: take[0](g))

    def run(mesh):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        first.clear()
        MOE.stats.clear()
        params = init_model(cfg, seed=0, device=dev)
        n_params = count_params(params)
        _, opt = ST.pick_optimizer(cfg, n_full, lr=3e-4,
                                   total_steps=PMOE_STEPS)
        b = batch
        if mesh is None:
            state = opt[0](params)
        else:
            placement = P.Placement(cfg, mesh)
            params = placement.place(params)
            state = placement.init_opt_state(opt[0], params)
            b = P.shard_batch(batch, mesh)
        step = ST.make_train_step(cfg, opt, mesh=mesh)
        P.reset_asked()
        losses, ms, launches = [], [], []
        for _ in range(PMOE_STEPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            ops.reset_launch_counts()
            with SavedBytes() as sv:
                e0.record()
                params, state, m = step(params, state, b)
                e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
            launches.append({k: v for k, v in ops.launch_counts().items()
                             if v})
            losses.append(m["loss"].item())
        out = dict(loss=first["loss"], losses=losses, ms=ms,
                   launches=launches, n_params=n_params,
                   optimizer="lion" if state.v is None else "adamw",
                   peak=torch.cuda.max_memory_allocated() / 1e9,
                   saved={"total": sv.total,
                          "block_inputs": sv.block_inputs},
                   stats=dict(MOE.stats),
                   coll={k: (P.asked[k], P.asked_ms[k]) for k in P.asked})
        return out, first.pop("grads"), params

    out = {"rank": rank, "meshes": {}}
    for shape in PMOE_MESHES:
        key = "x".join(map(str, shape))
        mesh = make_test_mesh(shape, ("data", "model"))
        placement = P.Placement(cfg, mesh)
        ref = None

        def slices(tree):
            """The rank's shards of a whole tree, on the host."""
            return {n: x.cpu() for n, x in leaves(placement.place(tree))}

        for r in range(2):      # one process at a time holds the card
            if rank == r:
                t0 = time.monotonic()
                take[0] = slices
                one, grads, params = run(None)
                ref = {"grads": grads, "final": slices(params)}
                del grads, params
                torch.cuda.empty_cache()
                out["one"] = {k: one[k] for k in (
                    "loss", "losses", "ms", "launches", "n_params",
                    "optimizer", "peak", "saved")}
                out["one"]["seconds"] = time.monotonic() - t0
            dist.barrier()
        t0 = time.monotonic()
        take[0] = lambda g: shard_sums(g, ref["grads"], placement.sizes)
        with mixer_spy(cfg) as seen:
            got, grad_sums, params = run(mesh)
        got["seconds"] = time.monotonic() - t0
        got["spy"] = {"whole": seen["whole"],
                      "heads": sorted(seen["heads"])}
        got.update(grad_sums=grad_sums,
                   param_sums=shard_sums(params, ref["final"],
                                         placement.sizes))
        del params, ref
        torch.cuda.empty_cache()
        out["meshes"][key] = got
        dist.barrier()
    return out


def placed_moe_train_phase() -> dict:
    """[placed moe train]: deepseek-v2's placed step on two ranks of the
    card, the batch split and then the experts split, against one
    process's step."""
    _free_parent()
    ranks, secs = two_ranks(placed_moe_train_rank, timeout=900)
    r0 = ranks[0]
    one = r0["one"]
    want = {"fastmax_causal": PMOE_LAYERS, "fastmax_causal_bwd": PMOE_LAYERS}
    ok = one["launches"][-1] == want and one["optimizer"] == "lion"
    out = {"arch": MOE_ARCH, "n_layers": PMOE_LAYERS, "batch": PMOE_B,
           "seq": PMOE_N, "steps": PMOE_STEPS, "dtype": "bfloat16",
           "optimizer": one["optimizer"], "params": one["n_params"],
           "step_ms_one": one["ms"], "peak_gb_one": one["peak"],
           "saved_one": one["saved"],
           "launches_one": one["launches"][-1], "seconds": secs,
           "seconds_one": one["seconds"], "meshes": {}}
    hq = placed_moe_cfg("bfloat16").n_heads
    for key in r0["meshes"]:
        m0 = r0["meshes"][key]
        rows = [r["meshes"][key] for r in ranks]
        gleaf, gerr = worst_sums(rows, "grad_sums")
        pleaf, perr = worst_sums(rows, "param_sums")
        diffs = [abs(m0["loss"] - one["loss"])] + [
            abs(a - b) for a, b in zip(m0["losses"], one["losses"])]
        dropped = sum(r["stats"].get("dropped", 0) for r in rows)
        differ = sum(r["stats"].get("differ", 0) for r in rows)
        pairs = sum(r["stats"].get("pairs", 0) for r in rows)
        # MLA on the rank's heads: Hq / model for q, k and v
        heads = [[hq // int(key.split("x")[1])] * 3]
        good = (max(diffs) <= TRAIN_LOSS_TOL and gerr <= TRAIN_GRAD_TOL
                and perr <= TRAIN_GRAD_TOL
                and all(r["launches"][-1] == want for r in rows)
                and all(not r["spy"]["whole"] and
                        [list(h) for h in r["spy"]["heads"]] == heads
                        for r in rows)
                and all(math.isfinite(x) for x in m0["losses"]))
        ok = ok and good
        out["meshes"][key] = {
            "loss_diffs": diffs, "losses": m0["losses"],
            "losses_one": one["losses"], "worst_grad_leaf": gleaf,
            "worst_grad_err": gerr, "worst_param_leaf": pleaf,
            "worst_param_err": perr, "pairs": pairs, "dropped": dropped,
            "differ_per_rank_capacity": differ,
            "step_ms_ranks": [r["ms"] for r in rows],
            "seconds_ranks": [r["seconds"] for r in rows],
            "peak_gb_ranks": [r["peak"] for r in rows],
            "collectives_ranks": [r["coll"] for r in rows],
            "saved_ranks": [r["saved"] for r in rows],
            "launches_ranks": [r["launches"][-1] for r in rows],
            "spy_ranks": [r["spy"] for r in rows]}
        coll = ", ".join(f"{k} {b / 1e9:.3f} GB {t / 1e3:.1f} s"
                         for k, (b, t) in sorted(rows[0]["coll"].items()))
        coll_lines(f"({key.replace('x', ', ')})", rows, "coll")
        saved = [(round(r["saved"]["total"] / 1e9, 3),
                  round(r["saved"]["block_inputs"] / 1e9, 3)) for r in rows]
        phase("placed moe train", f"{MOE_ARCH} cut to {PMOE_LAYERS} layers "
              f"({one['n_params'] / 1e9:.3f} B params), bf16, "
              f"{one['optimizer']}, B={PMOE_B} N={PMOE_N}, mesh (data, "
              f"model) = ({key.replace('x', ', ')}) on 2 ranks of the card "
              f"against one process: loss |diff| "
              f"{', '.join(f'{d:.3e}' for d in diffs)} (tol "
              f"{TRAIN_LOSS_TOL}); worst grad {gleaf} {gerr:.3e}, worst "
              f"updated parameter {pleaf} {perr:.3e} (tol {TRAIN_GRAD_TOL});"
              f" (token, slot) pairs {pairs} (summed over the ranks), "
              f"dropped past the global capacity {dropped}, kept or dropped "
              f"the other way by a per-rank capacity {differ}; peak GB per "
              f"rank {[round(r['peak'], 3) for r in rows]} (one process "
              f"{one['peak']:.3f}); step ms per rank "
              f"{[r['ms'] for r in rows]} (one process {one['ms']}); rank "
              f"0's collectives a step: {coll}; launches per rank per step "
              f"{[r['launches'][-1] for r in rows]}; GB autograd saved a "
              f"step per rank (all, of them the blocks' inputs) {saved} "
              f"(one process {one['saved']['total'] / 1e9:.3f}, "
              f"{one['saved']['block_inputs'] / 1e9:.3f}); whole MLA leaves "
              f"gathered over model per rank "
              f"{[len(r['spy']['whole']) for r in rows]}, attention (q, k, "
              f"v) heads per rank {[r['spy']['heads'] for r in rows]} (want "
              f"{heads})")
    if not ok:
        fail(f"placed moe train: the placed step disagrees with one "
             f"process, its launches are not one prefill and one backward "
             f"per layer, a whole MLA leaf was gathered over model, or the "
             f"attention did not run on the rank's heads: {out}")
    return out


def placed_moe_serve_rank(rank, world):
    """A [placed moe serve] rank: rank 0 first takes one process's
    generate() alone, then each rank in turn draws the weights and keeps
    its shards, and both prefill and decode on (data 1, model 2)."""
    dev = _moe_rank_setup()
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import init_decode_state, init_model
    from repro_torch.models import moe as MOE
    from repro_torch.sharding import placed as P
    from repro_torch.sharding.rules import use_mesh

    del world
    cfg = placed_moe_cfg("float32")
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (PMOE_B, PMOE_PROMPT),
                            generator=gen).to(dev)
    ref = launches_one = None
    t0 = time.monotonic()
    if rank == 0:
        params = init_model(cfg, seed=0, device=dev)
        ops.reset_launch_counts()
        ref = generate(params, cfg, prompts, PMOE_GEN).cpu()
        launches_one = {k: v for k, v in ops.launch_counts().items() if v}
        del params
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_test_mesh((1, 2), ("data", "model"))
    placement = P.Placement(cfg, mesh)
    placed = None
    for r in range(2):          # one whole copy of the weights at a time
        if rank == r:
            placed = placement.place(init_model(cfg, seed=0, device=dev))
            torch.cuda.empty_cache()
        dist.barrier()
    setup_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    with use_mesh(mesh):
        state = init_decode_state(cfg, PMOE_B, PMOE_PROMPT + PMOE_GEN,
                                  device=dev)
    prefill = make_prefill_step(cfg, mesh=mesh)
    step = make_serve_step(cfg, mesh=mesh)
    positions = PMOE_PROMPT + torch.arange(PMOE_GEN - 1, device=dev)
    m2 = state["blocks_0"].moments[2]
    ops.reset_launch_counts()
    P.reset_asked()
    MOE.stats.clear()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with mixer_spy(cfg) as seen:
        ev[0].record()
        tok, state = prefill(placed, state, prompts)
        ev[1].record()
        toks = [tok]
        for i in range(PMOE_GEN - 1):
            tok, state = step(placed, state, tok, positions[i])
            toks.append(tok)
        ev[2].record()
        ev[2].synchronize()
    out = torch.stack(toks, 1).cpu()
    return {"rank": rank, "launches": {k: v for k, v in
                                       ops.launch_counts().items() if v},
            "launches_one": launches_one,
            "equal": None if ref is None else bool(torch.equal(out, ref)),
            "tokens": out.tolist(), "stats": dict(MOE.stats),
            "spy": {"whole": seen["whole"], "heads": sorted(seen["heads"])},
            "moments_m2_shape": list(m2.shape),
            "setup_s": setup_s,
            "prefill_ms": ev[0].elapsed_time(ev[1]),
            "decode_ms_per_token": ev[1].elapsed_time(ev[2])
            / (PMOE_GEN - 1),
            "collectives": {k: (P.asked[k], P.asked_ms[k])
                            for k in P.asked},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def placed_moe_serve_phase() -> dict:
    """[placed moe serve]: float32 deepseek-v2 prefill and decode on (data
    1, model 2), 80 experts a rank, against one process's generate()."""
    _free_parent()
    (r0, r1), secs = two_ranks(placed_moe_serve_rank, timeout=600)
    want = {"fastmax_causal": PMOE_LAYERS,
            "fastmax_decode": (PMOE_GEN - 1) * PMOE_LAYERS}
    dropped = r0["stats"].get("dropped", 0) + r1["stats"].get("dropped", 0)
    # MLA's prefill and decode on the rank's 64 of 128 heads
    hq = placed_moe_cfg("float32").n_heads // 2
    spy_ok = all(not r["spy"]["whole"] and [
        list(h) for h in r["spy"]["heads"]] == [[hq] * 3] for r in (r0, r1))
    ok = (r0["equal"] and r1["tokens"] == r0["tokens"]
          and r0["launches"] == r1["launches"] == want
          and r0["launches_one"] == want and dropped == 0 and spy_ok)
    coll = r0["collectives"]
    out = {"arch": MOE_ARCH, "n_layers": PMOE_LAYERS, "batch": PMOE_B,
           "prompt": PMOE_PROMPT, "gen": PMOE_GEN, "dtype": "float32",
           "tokens_equal": r0["equal"], "dropped": dropped,
           "launches_ranks": [r0["launches"], r1["launches"]],
           "launches_one": r0["launches_one"],
           "prefill_ms_ranks": [r0["prefill_ms"], r1["prefill_ms"]],
           "decode_ms_per_token_ranks": [r0["decode_ms_per_token"],
                                         r1["decode_ms_per_token"]],
           "collectives_ranks": [r0["collectives"], r1["collectives"]],
           "peak_gb_ranks": [r0["peak_gb"], r1["peak_gb"]],
           "setup_s_ranks": [r0["setup_s"], r1["setup_s"]],
           "spy_ranks": [r0["spy"], r1["spy"]],
           "moments_m2_shape": r0["moments_m2_shape"],
           "seconds": secs}
    coll_lines("serve", [r0, r1], "collectives")
    phase("placed moe serve", f"{MOE_ARCH} cut to {PMOE_LAYERS} layers, "
          f"float32, (data 1, model 2) on 2 ranks of the card, 80 of 160 "
          f"experts and 64 of 128 MLA heads a rank: B={PMOE_B} prompt "
          f"{PMOE_PROMPT}, a prefill and "
          f"{PMOE_GEN - 1} decode tokens; greedy tokens equal one "
          f"process's generate(): {r0['equal']}; pairs dropped {dropped}; "
          f"launches per rank {r0['launches']} (one process "
          f"{r0['launches_one']}); whole MLA leaves gathered over model "
          f"per rank {[len(r['spy']['whole']) for r in (r0, r1)]}, "
          f"attention (q, k, v) heads per rank "
          f"{[r['spy']['heads'] for r in (r0, r1)]}, each rank's m2 "
          f"moments {r0['moments_m2_shape']}; prefill ms "
          f"{out['prefill_ms_ranks']}, "
          f"decode ms/token {out['decode_ms_per_token_ranks']}; peak GB "
          f"{out['peak_gb_ranks']}; rank 0's collectives GB "
          f"{ {k: round(v[0] / 1e9, 3) for k, v in coll.items()} } in s "
          f"{ {k: round(v[1] / 1e3, 1) for k, v in coll.items()} }")
    if not ok:
        fail(f"placed moe serve: tokens differ from generate(), a pair was "
             f"dropped, the launches per rank are not one prefill per "
             f"layer and one decode per layer and token, a whole MLA leaf "
             f"was gathered over model, or the attention did not run on "
             f"the rank's heads: {out}")
    return out


# placed SSM phases: the SSM mixers split over "model" on (data 1, model
# 2), two gloo ranks of the card. [placed ssm train]: xlstm-1.3b at full
# width cut to the pattern ("mlstm:none", "slstm:none") at 2 layers (one
# of each of its mixers, where its own group is 7 mLSTM and 1 sLSTM; 2 of
# its 4 heads a rank), then jamba's Mamba block at full width (d 4096,
# d_inner 8192: 4096 channels a rank, d_state 16, chunk 512) cut to the
# pattern ("mamba:mlp",) at 2 layers: jamba's least depth (8 layers,
# 13.3 B params, 11.3 B of them experts) cannot take AdamW's state on one
# card. float32 (in bf16 the one-process and placed steps of these
# models differ past the limits by rounding alone: xlstm's loss by
# 1.3e-3 at 21.2, the grads of mLSTM's bi, whose terms cancel, by 2.1,
# jamba's zero-initialized conv_b after AdamW's first step, ±lr by the
# grad's sign, by 0.11), AdamW, remat full, B=2, N=256 (sLSTM's loop
# over the tokens is the step's time), one step a
# config, against one process's step (each rank in turn takes it alone
# and keeps its shards' slices of the grads and updated parameters on
# the host).
# [placed ssm serve]: jamba cut to 5 layers (Mamba at 0-3, its attention
# layer 4 through the prefill and decode kernels in the heads plan, 4 of
# 8 kv heads a rank; experts at 1 and 3, 8 of 16 a rank), then
# xlstm-1.3b cut as for training, float32 as
# [placed moe serve], B=2, a prefill of PSSM_PROMPT tokens and
# PSSM_GEN - 1 decode tokens against one process's generate(); each rank
# draws the whole model on the card in turn and cuts its shards leaf by
# leaf, rank 0's into host memory until rank 1 has cut its own: one
# whole float32 model at a time on the card
PSSM_MESH = (1, 2)
PSSM_LAYERS, PSSM_MAMBA_LAYERS, PSSM_B, PSSM_N = 5, 2, 2, 256
PSSM_XLSTM = ("mlstm:none", "slstm:none")
PSSM_PROMPT, PSSM_GEN = 1024, 5
PSSM_LR = 3e-4


def placed_ssm_cfgs(kind: str) -> list:
    """[(label, config)] of the placed SSM phases, float32: xlstm-1.3b
    cut to PSSM_XLSTM and jamba's Mamba-block cut for training (`kind`
    "train"), jamba's first PSSM_LAYERS layers (its pattern cut there:
    its depth is otherwise whole groups of 8) and the same xlstm-1.3b for
    serving."""
    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_config

    kw = dict(param_dtype="float32", activ_dtype="float32",
              attn=AttentionSpec.parse("fastmax2-kernel"))
    xlstm = ("xlstm-1.3b", get_config("xlstm-1.3b", pattern=PSSM_XLSTM,
                                      n_layers=len(PSSM_XLSTM), **kw))
    if kind == "train":
        return [xlstm, ("jamba-v0.1-52b mamba:mlp", get_config(
            "jamba-v0.1-52b", pattern=("mamba:mlp",),
            n_layers=PSSM_MAMBA_LAYERS, **kw))]
    jamba = get_config("jamba-v0.1-52b").pattern[:PSSM_LAYERS]
    return [("jamba-v0.1-52b", get_config(
        "jamba-v0.1-52b", pattern=jamba, n_layers=PSSM_LAYERS, **kw)), xlstm]


@contextlib.contextmanager
def ssm_spy(cfg):
    """Inside, `placed.gather` and the SSM mixers' scans record into the
    dict yielded: "whole", the shapes of gathers over "model" that return
    a whole in_proj, x_proj, out_proj, up_proj, down_proj, w{z,i,f,o},
    wi or wf; "scans", each scan's operand shape a rank (Mamba's [B,
    chunk, d_inner, d_state] per chunk; mLSTM's q and v [B, heads, N,
    dk | dv]; sLSTM's recurrence width and its w's columns)."""
    from repro_torch.models import mamba as M
    from repro_torch.models import xlstm as X
    from repro_torch.sharding import placed as P

    d = cfg.d_model
    di, dt_rank, ds, _ = M._dims(cfg)
    xdi, nh, _ = X._dims(cfg)
    whole = {(d, 2 * di), (di, dt_rank + 2 * ds), (di, d), (d, 2 * xdi),
             (xdi, d), (xdi, nh), (d, d)}
    seen = {"whole": [], "scans": set()}
    saved = (P.gather, M._selective_scan, X._mlstm_chunk_scan,
             X._slstm_weights)
    gather, scan, chunk, weights = saved

    def spy_gather(leaf, over, mesh, *, sum_over=()):
        out = gather(leaf, over, mesh, sum_over=sum_over)
        if ("model" in over and "model" in P.split_axes(P.spec_of(leaf))
                and tuple(out.shape) in whole):
            seen["whole"].append(tuple(out.shape))
        return out

    def spy_scan(u, delta, a, *rest, **kw):
        cs = min(kw.get("chunk", 128), u.shape[1])
        seen["scans"].add(("mamba", u.shape[0], cs, u.shape[2], a.shape[1]))
        return scan(u, delta, a, *rest, **kw)

    def spy_chunk(q, k, v, *a, **kw):
        seen["scans"].add(("mlstm q", *q.shape))
        seen["scans"].add(("mlstm v", *v.shape))
        return chunk(q, k, v, *a, **kw)

    def spy_weights(params, cfg_, lay):
        w, r, bias = weights(params, cfg_, lay)
        seen["scans"].add(("slstm width, w cols", bias.shape[1],
                           w.shape[-1]))
        return w, r, bias

    P.gather, M._selective_scan = spy_gather, spy_scan
    X._mlstm_chunk_scan, X._slstm_weights = spy_chunk, spy_weights
    try:
        yield seen
    finally:
        (P.gather, M._selective_scan, X._mlstm_chunk_scan,
         X._slstm_weights) = saved


def placed_ssm_train_rank(rank, world):
    """A [placed ssm train] rank: for each config, each rank in turn takes
    one process's step alone and keeps its shards' slices of the grads
    and updated parameters on the host; then both take the placed step
    on (1, 2), held to those slices."""
    dev = _moe_rank_setup()
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_model
    from repro_torch.models.param import count_params
    from repro_torch.optim.grad_utils import leaves
    from repro_torch.sharding import placed as P

    del world
    first: dict = {}
    take = [None]
    record_first_grads(first, lambda g: take[0](g))
    mesh = make_test_mesh(PSSM_MESH, ("data", "model"))
    out = {"rank": rank, "configs": {}}
    for label, cfg in placed_ssm_cfgs("train"):
        n_full = count_params(init_model(get_config(label.split()[0]),
                                         device="meta"))
        raw = SyntheticLM(cfg.vocab_size, PSSM_N, seed=0).batch(0, PSSM_B)
        batch = {k: torch.as_tensor(raw[k], dtype=torch.int32, device=dev)
                 for k in ("tokens", "targets")}
        placement = P.Placement(cfg, mesh)

        def run(mesh_):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            first.clear()
            params = init_model(cfg, seed=0, device=dev)
            n_params = count_params(params)
            _, opt = ST.pick_optimizer(cfg, n_full, lr=PSSM_LR,
                                       total_steps=1)
            b = batch
            if mesh_ is None:
                state = opt[0](params)
            else:
                params = placement.place(params)
                state = placement.init_opt_state(opt[0], params)
                b = P.shard_batch(batch, mesh_)
            step = ST.make_train_step(cfg, opt, mesh=mesh_)
            P.reset_asked()
            ops.reset_launch_counts()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            params, state, m = step(params, state, b)
            e1.record()
            e1.synchronize()
            res = dict(loss=first["loss"], ms=e0.elapsed_time(e1),
                       launches={k: v for k, v in
                                 ops.launch_counts().items() if v},
                       n_params=n_params,
                       optimizer="lion" if state.v is None else "adamw",
                       peak=torch.cuda.max_memory_allocated() / 1e9,
                       coll={k: (P.asked[k], P.asked_ms[k])
                             for k in P.asked})
            return res, first.pop("grads"), params

        def slices(tree):
            """The rank's shards of a whole tree, on the host."""
            return {n: x.cpu() for n, x in leaves(placement.place(tree))}

        ref = None
        for r in range(2):      # one process at a time holds the card
            if rank == r:
                take[0] = slices
                one, grads, params = run(None)
                ref = {"grads": grads, "final": slices(params)}
                del grads, params
                torch.cuda.empty_cache()
                one_keep = one
            dist.barrier()
        take[0] = lambda g: shard_sums(g, ref["grads"], placement.sizes,
                                       count=True)
        with ssm_spy(cfg) as seen:
            got, grad_sums, params = run(mesh)
        got.update(grad_sums=grad_sums,
                   param_sums=shard_sums(params, ref["final"],
                                         placement.sizes, count=True),
                   whole=seen["whole"], scans=sorted(seen["scans"]),
                   one=one_keep)
        del params, ref
        torch.cuda.empty_cache()
        out["configs"][label] = got
        dist.barrier()
    out["slstm_choice"] = slstm_choice_readings(dev, mesh)
    return out


def slstm_choice_readings(dev, mesh) -> dict:
    """What decides how an sLSTM head that spans k ranks is computed
    (xlstm-1.3b at "model" = 16: 4 heads of 512, k = 4): host ms of one
    all-gather over "model" of a head's h slice [B, 128] (the exchange a
    split head's recurrence would make at every token) against the
    device ms of the recurrence over N tokens on a whole head (512 wide,
    as the placed step computes it) and on a quarter head (128 wide, its
    compute without the exchange), float32, B=PSSM_B, N=PSSM_N."""
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm as X
    from repro_torch.models.transformer import init_lm
    from repro_torch.sharding import placed as P

    group = mesh.get_group("model")
    h = torch.zeros(PSSM_B, 128, device=dev)
    for _ in range(4):
        P._collective("all-gather", h, group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 64
    for _ in range(reps):
        P._collective("all-gather", h, group)
    torch.cuda.synchronize()
    out = {"exchange_ms": (time.perf_counter() - t0) * 1e3 / reps,
           "tokens": PSSM_N}
    for name, width in (("scan_ms_head", 512), ("scan_ms_quarter", 128)):
        cfg = get_config("xlstm-1.3b", d_model=width, n_heads=1,
                         n_layers=8, param_dtype="float32",
                         activ_dtype="float32")
        params = init_lm(cfg, seed=0, device=dev)["blocks_7"]["mixer"]
        params = {k: v[0] for k, v in params.items()}
        x = torch.randn(PSSM_B, PSSM_N, width, device=dev)
        st = X.init_slstm_state(cfg, PSSM_B, torch.float32, device=dev)
        with torch.no_grad():
            X._slstm_scan(params, x[:, :8], cfg, st)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            X._slstm_scan(params, x, cfg, st)
            e1.record()
            e1.synchronize()
        out[name] = e0.elapsed_time(e1)
    return out


# [placed ssm train]: the input-gate biases' grads (mLSTM's and sLSTM's
# "bi") vanish in exact arithmetic (sLSTM's stabilizer m and mLSTM's
# max(|den|, 1) cancel a common scale of the input gate), so the ranks
# and one process hold rounding there, summed in two orders: as the CPU
# tests' float32-island limits do (tests/test_torch_ssm_archs.py), their
# grads are held against at least PSSM_GRAD_FLOOR of the largest leaf's
# RMS grad, and their updated parameters within 2·lr RMS of one
# process's (AdamW's first step moves an element by at most lr, here by
# the sign of that rounding). Every other leaf takes TRAIN_GRAD_TOL as
# [placed moe train] does
PSSM_GRAD_FLOOR = 1e-2
PSSM_VANISHING = "/mixer/bi"


def ssm_leaf_errors(rows, lr: float) -> dict:
    """{"grad": (leaf, err), "param": (leaf, err)}: the worst per-leaf
    relative errors of the grads and the updated parameters (squared sums
    added over the ranks where a mesh axis splits the leaf), the
    input-gate biases' (PSSM_VANISHING) floored as said above."""
    def sums(key):
        out = {}
        for name, (d2, r2, split, n) in rows[0][key].items():
            if split:
                d2, r2, n = (sum(r[key][name][i] for r in rows)
                             for i in (0, 1, 3))
            out[name] = (d2, r2, n)
        return out

    g, p = sums("grad_sums"), sums("param_sums")
    floor2 = PSSM_GRAD_FLOOR ** 2 * max(r2 / n for _, r2, n in g.values())
    gerr, perr = {}, {}
    for name, (d2, r2, n) in g.items():
        vanishing = name.endswith(PSSM_VANISHING)
        gerr[name] = math.sqrt(d2 / max(r2, floor2 * n if vanishing
                                        else 0.0, 1e-60))
        pd2, pr2, pn = p[name]
        perr[name] = (math.sqrt(pd2 / pn) / (2 * lr) if vanishing
                      else math.sqrt(pd2 / max(pr2, 1e-60)))
    gw, pw = max(gerr, key=gerr.get), max(perr, key=perr.get)
    return {"grad": (gw, gerr[gw]), "param": (pw, perr[pw])}


def placed_ssm_train_phase() -> dict:
    """[placed ssm train]: the SSM mixers' placed step on (data 1, model
    2), two ranks of the card, against one process's step."""
    _free_parent()
    ranks, secs = two_ranks(placed_ssm_train_rank, timeout=900)
    out, ok = {"seconds": secs, "configs": {}}, True
    for label in ranks[0]["configs"]:
        rows = [r["configs"][label] for r in ranks]
        g0, one = rows[0], rows[0]["one"]
        errs = ssm_leaf_errors(rows, PSSM_LR)
        (gleaf, gerr), (pleaf, perr) = errs["grad"], errs["param"]
        diff = abs(g0["loss"] - one["loss"])
        good = (diff <= TRAIN_LOSS_TOL and gerr <= TRAIN_GRAD_TOL
                and perr <= TRAIN_GRAD_TOL and math.isfinite(g0["loss"])
                and all(r["launches"] == {} for r in rows)
                and one["launches"] == {}
                and all(not r["whole"] for r in rows))
        ok = ok and good
        out["configs"][label] = {
            "params": one["n_params"], "optimizer": one["optimizer"],
            "loss": g0["loss"], "loss_one": one["loss"], "loss_diff": diff,
            "worst_grad_leaf": gleaf, "worst_grad_err": gerr,
            "worst_param_leaf": pleaf, "worst_param_err": perr,
            "step_ms_ranks": [r["ms"] for r in rows],
            "step_ms_one": [r["one"]["ms"] for r in rows],
            "peak_gb_ranks": [r["peak"] for r in rows],
            "peak_gb_one": [r["one"]["peak"] for r in rows],
            "collectives_ranks": [r["coll"] for r in rows],
            "launches_ranks": [r["launches"] for r in rows],
            "whole_ranks": [r["whole"] for r in rows],
            "scans_rank0": g0["scans"]}
        coll_lines(f"{label} (1, 2)", rows, "coll")
        phase("placed ssm train", f"{label} cut to "
              f"{one['n_params'] / 1e9:.3f} B params, float32, "
              f"{one['optimizer']}, B={PSSM_B} N={PSSM_N}, mesh (data, "
              f"model) = (1, 2) on 2 ranks of the card against one "
              f"process: loss |diff| {diff:.3e} (tol {TRAIN_LOSS_TOL}); "
              f"worst grad {gleaf} {gerr:.3e}, worst updated parameter "
              f"{pleaf} {perr:.3e} (tol {TRAIN_GRAD_TOL}; the input-gate "
              f"biases' grads floored at {PSSM_GRAD_FLOOR} of the largest "
              f"leaf's RMS, their parameters held within 2·lr RMS); step "
              f"ms per "
              f"rank {[r['ms'] for r in rows]} (one process "
              f"{[r['one']['ms'] for r in rows]}); peak GB per rank "
              f"{[round(r['peak'], 3) for r in rows]} (one process "
              f"{[round(r['one']['peak'], 3) for r in rows]}); launches "
              f"per rank {[r['launches'] for r in rows]}; whole leaves "
              f"gathered over model per rank "
              f"{[len(r['whole']) for r in rows]}; scans' operands a rank "
              f"{g0['scans']}")
    choice = [r["slstm_choice"] for r in ranks]
    out["slstm_choice_ranks"] = choice
    c0 = choice[0]
    phase("placed ssm train", f"sLSTM head across ranks: one all-gather "
          f"of a head's h slice [{PSSM_B}, 128] over model (gloo) "
          f"{[round(c['exchange_ms'], 4) for c in choice]} ms a rank, "
          f"x {c0['tokens']} tokens a layer and pass; the recurrence over "
          f"{c0['tokens']} tokens on a whole 512-wide head "
          f"{[round(c['scan_ms_head'], 2) for c in choice]} ms, on a "
          f"quarter head {[round(c['scan_ms_quarter'], 2) for c in choice]}"
          f" ms")
    if not ok:
        fail(f"placed ssm train: the placed step disagrees with one "
             f"process, a kernel was launched, or a whole SSM leaf was "
             f"gathered over model: {out}")
    return out


def place_leafwise(placement, tree, device) -> dict:
    """The rank's shards of a whole parameter tree, each cut (a copy) onto
    `device` and its whole leaf dropped from `tree` as it is cut: the
    whole model and the shards need not fit the card together."""
    from repro_torch.kernels.sharded import shard_local
    from repro_torch.sharding import placed as P

    def walk(t, specs):
        out = {}
        for k in list(t):
            v = t.pop(k)
            out[k] = (walk(v, specs[k]) if isinstance(v, dict) else
                      P.tag(shard_local(v.detach(), specs[k],
                                        placement.mesh).to(device,
                                                           copy=True),
                            specs[k]))
            del v
        return out

    return walk(tree, placement.specs)


def ssm_state_bytes(cfg, state) -> int:
    """Bytes of the SSM layers' leaves of a decode state."""
    from repro_torch.models.transformer import _block_keys
    from repro_torch.sharding.placed import SSM_MIXERS

    return sum(x.numel() * x.element_size()
               for key, kind, _ in _block_keys(cfg)
               if kind.split(":")[0] in SSM_MIXERS for x in state[key])


def planned_ssm_state_bytes(cfg, batch: int, max_len: int, mesh) -> int:
    """Rank 0's bytes of the SSM layers' decode state placed by the
    reference's `decode_state_shardings` on `mesh`."""
    from repro_torch.launch.dryrun import _local_numel, _pairs
    from repro_torch.models import decode_state_specs
    from repro_torch.models.transformer import _block_keys
    from repro_torch.sharding.placed import SSM_MIXERS
    from repro_torch.sharding.rules import decode_state_shardings

    whole = decode_state_specs(cfg, batch, max_len)
    specs = decode_state_shardings(whole, mesh, batch=batch)
    return sum(_local_numel(tuple(x.shape), s, mesh, p) * x.element_size()
               for key, kind, _ in _block_keys(cfg)
               if kind.split(":")[0] in SSM_MIXERS
               for p, x, s in _pairs(whole[key], specs[key]))


def placed_ssm_serve_rank(rank, world):
    """A [placed ssm serve] rank: per config, rank 0 first takes one
    process's generate() alone, then each rank in turn draws the weights
    and keeps its shards, and both prefill and decode on (1, 2)."""
    dev = _moe_rank_setup()
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import init_decode_state, init_model
    from repro_torch.optim.grad_utils import tree_map
    from repro_torch.sharding import placed as P
    from repro_torch.sharding.rules import use_mesh

    del world
    mesh = make_test_mesh(PSSM_MESH, ("data", "model"))
    out = {"rank": rank, "configs": {}}
    max_len = PSSM_PROMPT + PSSM_GEN
    for label, cfg in placed_ssm_cfgs("serve"):
        gen = torch.Generator().manual_seed(0)
        prompts = torch.randint(0, cfg.vocab_size, (PSSM_B, PSSM_PROMPT),
                                generator=gen).to(dev)
        ref = launches_one = None
        if rank == 0:
            params = init_model(cfg, seed=0, device=dev)
            ops.reset_launch_counts()
            ref = generate(params, cfg, prompts, PSSM_GEN).cpu()
            launches_one = {k: v for k, v in ops.launch_counts().items()
                            if v}
            del params
            torch.cuda.empty_cache()
        dist.barrier()
        t0 = time.monotonic()
        placement = P.Placement(cfg, mesh)
        placed = None
        # one whole copy of the weights at a time: rank 0 cuts its shards
        # into host memory while rank 1 draws and cuts on the card
        for r in range(2):
            if rank == r:
                placed = place_leafwise(placement, init_model(
                    cfg, seed=0, device=dev), "cpu" if r == 0 else dev)
                torch.cuda.empty_cache()
            dist.barrier()
        placed = tree_map(lambda x: P.tag(x.to(dev), P.spec_of(x)), placed)
        setup_s = time.monotonic() - t0
        torch.cuda.reset_peak_memory_stats()
        with use_mesh(mesh):
            state = init_decode_state(cfg, PSSM_B, max_len, device=dev)
        held = ssm_state_bytes(cfg, state)
        whole = ssm_state_bytes(cfg, init_decode_state(
            cfg, PSSM_B, max_len, device="meta"))
        planned = planned_ssm_state_bytes(cfg, PSSM_B, max_len, mesh)
        prefill = make_prefill_step(cfg, mesh=mesh)
        step = make_serve_step(cfg, mesh=mesh)
        positions = PSSM_PROMPT + torch.arange(PSSM_GEN - 1, device=dev)
        ops.reset_launch_counts()
        P.reset_asked()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with ssm_spy(cfg) as seen:
            ev[0].record()
            tok, state = prefill(placed, state, prompts)
            ev[1].record()
            toks = [tok]
            for i in range(PSSM_GEN - 1):
                tok, state = step(placed, state, tok, positions[i])
                toks.append(tok)
            ev[2].record()
            ev[2].synchronize()
        got = torch.stack(toks, 1).cpu()
        out["configs"][label] = {
            "launches": {k: v for k, v in ops.launch_counts().items()
                         if v},
            "launches_one": launches_one,
            "equal": None if ref is None else bool(torch.equal(got, ref)),
            "tokens": got.tolist(), "whole": seen["whole"],
            "scans": sorted(seen["scans"]),
            "state_bytes": held, "state_bytes_planned": planned,
            "state_bytes_one": whole, "setup_s": setup_s,
            "prefill_ms": ev[0].elapsed_time(ev[1]),
            "decode_ms_per_token": ev[1].elapsed_time(ev[2])
            / (PSSM_GEN - 1),
            "collectives": {k: (P.asked[k], P.asked_ms[k])
                            for k in P.asked},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del placed, state
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def placed_ssm_serve_phase() -> dict:
    """[placed ssm serve]: float32 jamba and xlstm-1.3b prefill and decode
    on (data 1, model 2) against one process's generate()."""
    _free_parent()
    (r0, r1), secs = two_ranks(placed_ssm_serve_rank, timeout=900)
    out, ok = {"seconds": secs, "configs": {}}, True
    for label, cfg in placed_ssm_cfgs("serve"):
        a, b = r0["configs"][label], r1["configs"][label]
        attn = sum(k.split(":")[0] == "attn" for k in cfg.pattern) \
            * cfg.n_groups
        want = ({} if not attn else
                {"fastmax_causal": attn,
                 "fastmax_decode": (PSSM_GEN - 1) * attn})
        good = (a["equal"] and b["tokens"] == a["tokens"]
                and a["launches"] == b["launches"] == want
                and a["launches_one"] == want
                and not a["whole"] and not b["whole"]
                and a["state_bytes"] == b["state_bytes"]
                == a["state_bytes_planned"]
                and 2 * a["state_bytes"] == a["state_bytes_one"])
        ok = ok and good
        out["configs"][label] = {
            "n_layers": cfg.n_layers, "batch": PSSM_B,
            "prompt": PSSM_PROMPT, "gen": PSSM_GEN, "dtype": "float32",
            "tokens_equal": a["equal"],
            "launches_ranks": [a["launches"], b["launches"]],
            "launches_one": a["launches_one"],
            "ssm_state_bytes_ranks": [a["state_bytes"], b["state_bytes"]],
            "ssm_state_bytes_planned": a["state_bytes_planned"],
            "ssm_state_bytes_one": a["state_bytes_one"],
            "prefill_ms_ranks": [a["prefill_ms"], b["prefill_ms"]],
            "decode_ms_per_token_ranks": [a["decode_ms_per_token"],
                                          b["decode_ms_per_token"]],
            "peak_gb_ranks": [a["peak_gb"], b["peak_gb"]],
            "setup_s_ranks": [a["setup_s"], b["setup_s"]],
            "collectives_ranks": [a["collectives"], b["collectives"]],
            "whole_ranks": [a["whole"], b["whole"]],
            "scans_rank0": a["scans"]}
        coll_lines(f"{label} serve", [a, b], "collectives")
        phase("placed ssm serve", f"{label} cut to {cfg.n_layers} layers, "
              f"float32, (data 1, model 2) on 2 ranks of the card: "
              f"B={PSSM_B} prompt {PSSM_PROMPT}, a prefill and "
              f"{PSSM_GEN - 1} decode tokens; greedy tokens equal one "
              f"process's generate(): {a['equal']}; launches per rank "
              f"{a['launches']}, {b['launches']} (one process "
              f"{a['launches_one']}); SSM decode-state bytes per rank "
              f"{[a['state_bytes'], b['state_bytes']]} (planned "
              f"{a['state_bytes_planned']}, one process "
              f"{a['state_bytes_one']}); whole leaves gathered over model "
              f"per rank {[len(a['whole']), len(b['whole'])]}; scans' "
              f"operands a rank {a['scans']}; prefill ms "
              f"{out['configs'][label]['prefill_ms_ranks']}, decode "
              f"ms/token {out['configs'][label]['decode_ms_per_token_ranks']}"
              f"; peak GB {out['configs'][label]['peak_gb_ranks']}")
    if not ok:
        fail(f"placed ssm serve: tokens differ from generate(), the "
             f"launches per rank are not one prefill per attention layer "
             f"and one decode per attention layer and token, a whole SSM "
             f"leaf was gathered over model, or the SSM decode state is "
             f"not the planned bytes: {out}")
    return out


# [placed kv serve]: the softmax KV cache as the rank's block of the
# reference's kv_cache_spec on (data 1, model 2), two ranks, float32,
# B=4, a prompt of PKV_PROMPT tokens and PKV_GEN - 1 decode tokens at
# max_len PKV_MAX_LEN (which "model" 2 divides: rank 0 holds rows
# 0-1019, rank 1 rows 1020-2039, so the decode crosses from rank 0's
# rows into rank 1's at its ninth token): qwen3-1.7b cut to 4 layers (8
# kv heads: heads mode, 4 a rank) and granite-20b cut to 2 (1 kv head:
# sequence mode, the partial softmaxes combined over "model"), each
# against one process's generate() on the same cut and backend
PKV_MESH = (1, 2)
PKV_CFGS = (("qwen3-1.7b", 4), ("granite-20b", 2))
PKV_B, PKV_PROMPT, PKV_GEN, PKV_MAX_LEN = 4, 1012, 17, 2040


def placed_kv_cfgs() -> list:
    """[(label, config)] of [placed kv serve]: float32, softmax."""
    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_config

    return [(arch, get_config(arch, n_layers=n, param_dtype="float32",
                              activ_dtype="float32",
                              attn=AttentionSpec.parse("softmax")))
            for arch, n in PKV_CFGS]


def kv_caches(node, spec=None):
    """(cache, its specs or None) of each KVCache in a decode state."""
    from repro_torch.attention.state import KVCache

    if isinstance(node, KVCache):
        yield node, spec
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from kv_caches(v, None if spec is None else spec[k])
    elif isinstance(node, tuple):
        for i, v in enumerate(node):
            yield from kv_caches(v, None if spec is None else spec[i])


def kv_cache_leaves(state) -> list:
    """The softmax KV caches' k, v and mask leaves of a decode state."""
    return [x for kv, _ in kv_caches(state) for x in (kv.k, kv.v, kv.mask)]


def planned_kv_bytes(cfg, batch: int, max_len: int, mesh) -> int:
    """Rank 0's bytes of the KV caches' k, v and mask placed by the
    reference's `decode_state_shardings` on `mesh`."""
    from repro_torch.launch.dryrun import _local_numel
    from repro_torch.models import decode_state_specs
    from repro_torch.sharding.rules import decode_state_shardings

    whole = decode_state_specs(cfg, batch, max_len)
    specs = decode_state_shardings(whole, mesh, batch=batch)
    return sum(_local_numel(tuple(x.shape), sp, mesh, "kv")
               * x.element_size()
               for kv, sps in kv_caches(whole, specs)
               for x, sp in ((kv.k, sps.k), (kv.v, sps.v),
                             (kv.mask, sps.mask)))


def placed_kv_serve_rank(rank, world):
    """A [placed kv serve] rank: per config, rank 0 first takes one
    process's generate() alone, then both prefill and decode on (1, 2)
    with the placed steps."""
    dev = _rank_setup()
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import init_decode_state, init_model
    from repro_torch.sharding import placed as P
    from repro_torch.sharding.rules import kv_cache_block, use_mesh

    del world
    mesh = make_test_mesh(PKV_MESH, ("data", "model"))
    out = {"rank": rank, "configs": {}}
    for label, cfg in placed_kv_cfgs():
        gen = torch.Generator().manual_seed(0)
        prompts = torch.randint(0, cfg.vocab_size, (PKV_B, PKV_PROMPT),
                                generator=gen).to(dev)
        params = init_model(cfg, seed=0, device=dev)
        ref = None
        if rank == 0:
            ref = generate(params, cfg, prompts, PKV_GEN,
                           max_len=PKV_MAX_LEN).cpu()
        dist.barrier()
        placed = P.Placement(cfg, mesh).place(params)
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with use_mesh(mesh):
            state = init_decode_state(cfg, PKV_B, PKV_MAX_LEN, device=dev)
        leaves = kv_cache_leaves(state)
        whole = kv_cache_leaves(init_decode_state(cfg, PKV_B, PKV_MAX_LEN,
                                                  device="meta"))
        held = sum(x.numel() * x.element_size() for x in leaves)
        prefill = make_prefill_step(cfg, mesh=mesh)
        step = make_serve_step(cfg, mesh=mesh)
        positions = PKV_PROMPT + torch.arange(PKV_GEN - 1, device=dev)
        P.reset_asked()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        tok, state = prefill(placed, state, prompts)
        ev[1].record()
        ev[1].synchronize()
        prefill_coll = {k: (P.asked[k], P.asked_ms[k]) for k in P.asked}
        P.reset_asked()
        toks = [tok]
        for i in range(PKV_GEN - 1):
            tok, state = step(placed, state, tok, positions[i])
            toks.append(tok)
        ev[2].record()
        ev[2].synchronize()
        got = torch.stack(toks, 1).cpu()
        n_dec = PKV_GEN - 1
        out["configs"][label] = {
            "equal": None if ref is None else bool(torch.equal(got, ref)),
            "tokens": got.tolist(),
            "mode": kv_cache_block(cfg.n_kv_heads, PKV_MAX_LEN,
                                   mesh).mode,
            "cache_shape": list(leaves[0].shape),
            "whole_shape": list(whole[0].shape),
            "whole_leaves": sum(tuple(a.shape) == tuple(b.shape)
                                for a, b in zip(leaves, whole)),
            "kv_bytes": held,
            "kv_bytes_planned": planned_kv_bytes(cfg, PKV_B, PKV_MAX_LEN,
                                                 mesh),
            "kv_bytes_one": sum(x.numel() * x.element_size()
                                for x in whole),
            "prefill_ms": ev[0].elapsed_time(ev[1]),
            "decode_ms_per_token": ev[1].elapsed_time(ev[2]) / n_dec,
            "prefill_collectives": prefill_coll,
            "decode_collectives_per_step": {
                k: (P.asked[k] / n_dec, P.asked_ms[k] / n_dec)
                for k in P.asked},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del placed, state
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def placed_kv_serve_phase(smi: str) -> dict:
    """[placed kv serve]: float32 softmax qwen3-1.7b (heads mode) and
    granite-20b (sequence mode) prefill and decode on (data 1, model 2),
    each rank's KV cache the planned block, against one process's
    generate()."""
    _free_parent()
    (r0, r1), secs = two_ranks(placed_kv_serve_rank, timeout=600)
    out, ok = {"seconds": secs, "card": smi,
               "configs": {}}, True
    for label, _ in placed_kv_cfgs():
        a, b = r0["configs"][label], r1["configs"][label]
        good = (a["equal"] and b["tokens"] == a["tokens"]
                and a["kv_bytes"] == b["kv_bytes"] == a["kv_bytes_planned"]
                and 2 * a["kv_bytes"] == a["kv_bytes_one"]
                and a["whole_leaves"] == b["whole_leaves"] == 0)
        ok = ok and good
        out["configs"][label] = {
            "batch": PKV_B, "prompt": PKV_PROMPT, "gen": PKV_GEN,
            "max_len": PKV_MAX_LEN, "dtype": "float32", "attn": "softmax",
            "tokens_equal": a["equal"], "mode": a["mode"],
            "cache_shape_rank": a["cache_shape"],
            "cache_shape_one": a["whole_shape"],
            "kv_bytes_ranks": [a["kv_bytes"], b["kv_bytes"]],
            "kv_bytes_planned": a["kv_bytes_planned"],
            "kv_bytes_one": a["kv_bytes_one"],
            "whole_leaves_ranks": [a["whole_leaves"], b["whole_leaves"]],
            "prefill_ms_ranks": [a["prefill_ms"], b["prefill_ms"]],
            "decode_ms_per_token_ranks": [a["decode_ms_per_token"],
                                          b["decode_ms_per_token"]],
            "prefill_collectives_ranks": [a["prefill_collectives"],
                                          b["prefill_collectives"]],
            "decode_collectives_per_step_ranks": [
                a["decode_collectives_per_step"],
                b["decode_collectives_per_step"]],
            "peak_gb_ranks": [a["peak_gb"], b["peak_gb"]]}
        coll_lines(f"{label} decode step", [a, b],
                   "decode_collectives_per_step")
        cut = dict(PKV_CFGS)[label]
        phase("placed kv serve", f"{label} cut to {cut} layers, float32, "
              f"softmax, (data 1, model 2) on 2 ranks of the card ({smi}): "
              f"B={PKV_B} prompt {PKV_PROMPT}, a prefill and {PKV_GEN - 1} "
              f"decode tokens at max_len {PKV_MAX_LEN}; greedy tokens equal "
              f"one process's generate(): {a['equal']}; {a['mode']} mode, "
              f"KV cache a rank "
              f"{a['cache_shape']} of {a['whole_shape']}, bytes per rank "
              f"{[a['kv_bytes'], b['kv_bytes']]} (planned "
              f"{a['kv_bytes_planned']}, one process {a['kv_bytes_one']}); "
              f"prefill ms {out['configs'][label]['prefill_ms_ranks']}, "
              f"decode ms/token "
              f"{out['configs'][label]['decode_ms_per_token_ranks']}; peak "
              f"GB {out['configs'][label]['peak_gb_ranks']}")
    if not ok:
        fail(f"placed kv serve: tokens differ from generate(), a rank's KV "
             f"cache is not the planned bytes (half one process's), or a "
             f"rank holds a whole KV-cache leaf: {out}")
    return out


# [placed hybrid serve]: the moment decode states without a decode kernel
# as the rank's block of the reference's decode_state_shardings on (data
# 1, model 2), two ranks, float32, hybrid2-kernel, B=4, a prompt of
# PHY_PROMPT tokens and PHY_GEN - 1 decode tokens: qwen3-1.7b cut to 4
# layers (8 kv heads: heads mode, the moments and the window 4 kv heads a
# rank, the hybrid kernel's prefill on them) and granite-20b cut to 2 (1
# kv head: feature mode, m0, m1, m2 Dv 64 a rank with the g moments
# whole, the hybrid kernel's prefill on v's Dv slice; the window's W = 64
# rows 32 a rank, the band's partials and the shift's boundary row in one
# all-gather a layer), each against one process's generate() on the same
# cut and backend
PHY_MESH = (1, 2)
PHY_CFGS = (("qwen3-1.7b", 4), ("granite-20b", 2))
PHY_B, PHY_PROMPT, PHY_GEN = 4, 1024, 17
PHY_MAX_LEN = PHY_PROMPT + PHY_GEN
MOMENT_NAMES = ("m0", "m1", "m2", "g0", "g1", "g2")
# the placed prefill's last logit row against one process's, by the rule
# of MLA_F32_LOGIT_TOL: about four times the gap measured on an H100
# (700 W), 1.631e-4 (qwen3) and 3.099e-5 (granite), the same in both
# runs of the phase (alone, and in the whole script)
PHY_LOGIT_TOL = {"qwen3-1.7b": 7e-4, "granite-20b": 1.3e-4}


def placed_hybrid_cfgs() -> list:
    """[(label, config)] of [placed hybrid serve]: float32,
    hybrid2-kernel."""
    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_config

    return [(arch, get_config(arch, n_layers=n, param_dtype="float32",
                              activ_dtype="float32",
                              attn=AttentionSpec.parse("hybrid2-kernel")))
            for arch, n in PHY_CFGS]


def moment_leaves(node, spec=None):
    """(name, leaf, its spec or None) of each moment and hybrid-window
    leaf (k, v, mask) of a decode state's AttnStates."""
    from repro_torch.attention.state import AttnState

    if isinstance(node, AttnState):
        yield from ((n, x, None if spec is None else s) for n, x, s in zip(
            MOMENT_NAMES, node.moments, spec.moments if spec else
            [None] * 6))
        if node.kv is not None:
            for n in ("k", "v", "mask"):
                yield (n, getattr(node.kv, n),
                       None if spec is None else getattr(spec.kv, n))
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from moment_leaves(v, None if spec is None else spec[k])


def planned_moment_bytes(cfg, batch: int, max_len: int, mesh) -> tuple:
    """({leaf name: rank 0's bytes placed by the reference's
    `decode_state_shardings` on `mesh`}, {leaf name: one process's}, the
    whole shapes of the leaves the placement splits over "model", in
    `moment_leaves`' order, None for the others)."""
    from repro_torch.launch.dryrun import _local_numel
    from repro_torch.models import decode_state_specs
    from repro_torch.sharding.rules import decode_state_shardings

    whole = decode_state_specs(cfg, batch, max_len)
    specs = decode_state_shardings(whole, mesh, batch=batch)
    planned, one, split = {}, {}, []
    for name, x, sp in moment_leaves(whole, specs):
        size = x.element_size()
        planned[name] = planned.get(name, 0) + _local_numel(
            tuple(x.shape), sp, mesh, name) * size
        one[name] = one.get(name, 0) + x.numel() * size
        split.append(tuple(x.shape) if "model" in sp else None)
    return planned, one, split


def placed_hybrid_kernel_check(cfg, mesh, dev) -> dict:
    """`kernels.sharded.hybrid_prefill_sharded` on the rank's shards at
    the phase's shape (B, the prompt, no mask; the config's heads and
    widths; the rank's kv heads in heads mode, v's Dv slice with q and k
    whole in feature mode) against the hybrid kernel's plain version on
    the same shards: o within o_tol, each of the six final moments
    within TOL_MOMENTS, each of the rank's block's shape."""
    from repro_torch.core.decode_state import init_fastmax_state
    from repro_torch.core.ref import normalize_qk
    from repro_torch.kernels import sharded as S
    from repro_torch.kernels.hybrid_causal import hybrid_causal_ref
    from repro_torch.sharding.rules import moments_block, use_mesh

    spec = cfg.attn_spec
    spec_r = spec.resolved()
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(35)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q = normalize_qk(rn(PHY_B, hq, PHY_PROMPT, d))
    k = normalize_qk(rn(PHY_B, hkv, PHY_PROMPT, d))
    v = rn(PHY_B, hkv, PHY_PROMPT, d)
    with use_mesh(mesh):
        blk = moments_block(hkv, d, mesh)
        plan = S.plan_kernel_sharding(mesh, batch=PHY_B, hq=hq, hkv=hkv,
                                      dv=d)
        if plan.mode == "heads":
            q, k, v = (S.model_slice(x, 1, plan) for x in (q, k, v))
        else:
            v = S.model_slice(v, -1, plan)
        kw = dict(p=spec.p, window=spec_r.window,
                  chunk_size=spec_r.chunk_size, denom_eps=spec.denom_eps)
        o, st = S.hybrid_prefill_sharded(q, k, v, **kw, plan=plan)
    ro, rst = hybrid_causal_ref(q, k, v, None, **kw, return_state=True)
    torch.cuda.synchronize()
    eo, o_ok = o_err(o, ro)
    em = [moment_err(a, r) for a, r in zip(st, rst)]
    shapes = [tuple(x.shape) for x in st]
    block = [tuple(x.shape) for x in init_fastmax_state(
        PHY_B, blk.heads, d, blk.dv, p=spec.p, device="meta")]
    shapes_ok = shapes == block == [tuple(x.shape) for x in rst]
    return {"plan": plan.mode, "q": list(q.shape), "v": list(v.shape),
            "o_err": eo, "o_ok": o_ok, "moment_errs": em,
            "moments_ok": max(em) <= TOL_MOMENTS,
            "shapes": [list(x) for x in shapes], "shapes_ok": shapes_ok}


def placed_hybrid_serve_rank(rank, world):
    """A [placed hybrid serve] rank: per config, rank 0 first takes one
    process's generate() and prefill logits alone, then both prefill
    (`lm_prefill` placed, the first token from its last row) and decode
    (the placed serve step) on (1, 2)."""
    dev = _rank_setup()
    import torch.distributed as dist

    from repro_torch.core.hybrid import effective_window
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import init_decode_state, init_model
    from repro_torch.models.transformer import lm_prefill
    from repro_torch.sharding import placed as P
    from repro_torch.sharding.rules import (kv_cache_block, moments_block,
                                            use_mesh)

    del world
    mesh = make_test_mesh(PHY_MESH, ("data", "model"))
    out = {"rank": rank, "configs": {}}
    for label, cfg in placed_hybrid_cfgs():
        gen = torch.Generator().manual_seed(0)
        prompts = torch.randint(0, cfg.vocab_size, (PHY_B, PHY_PROMPT),
                                generator=gen).to(dev)
        params = init_model(cfg, seed=0, device=dev)
        ref = ref_last = None
        if rank == 0:
            ref = generate(params, cfg, prompts, PHY_GEN,
                           max_len=PHY_MAX_LEN).cpu()
            with torch.no_grad():
                lg, _ = lm_prefill(params, prompts, cfg, init_decode_state(
                    cfg, PHY_B, PHY_MAX_LEN, device=dev))
            ref_last = lg[:, -1].cpu()
            del lg
        dist.barrier()
        placement = P.Placement(cfg, mesh)
        placed = placement.place(params)
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with use_mesh(mesh):
            state = init_decode_state(cfg, PHY_B, PHY_MAX_LEN, device=dev)
        planned, one, split = planned_moment_bytes(cfg, PHY_B, PHY_MAX_LEN,
                                                   mesh)
        held = {}
        whole_leaves = 0
        for (name, x, _), shp in zip(moment_leaves(state), split):
            held[name] = held.get(name, 0) + x.numel() * x.element_size()
            whole_leaves += int(shp is not None and tuple(x.shape) == shp)
        step = make_serve_step(cfg, mesh=mesh)
        positions = PHY_PROMPT + torch.arange(PHY_GEN - 1, device=dev)
        ops.reset_launch_counts()
        P.reset_asked()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        with torch.no_grad(), use_mesh(mesh), placement.active():
            lg, state = lm_prefill(placed, prompts, cfg, state)
            last = P.gather_vocab(lg[:, -1], cfg.vocab_size)
        tok = last.argmax(-1).to(torch.int32)
        ev[1].record()
        ev[1].synchronize()
        del lg
        prefill_launches = dict(ops.launch_counts())
        prefill_coll = {k: (P.asked[k], P.asked_ms[k]) for k in P.asked}
        P.reset_asked()
        toks = [tok]
        for i in range(PHY_GEN - 1):
            tok, state = step(placed, state, tok, positions[i])
            toks.append(tok)
        ev[2].record()
        ev[2].synchronize()
        got = torch.stack(toks, 1).cpu()
        n_dec = PHY_GEN - 1
        hkv, dv = cfg.n_kv_heads, cfg.head_dim
        spec = cfg.attn_spec
        w = next(x for n, x, _ in moment_leaves(state) if n == "k")
        out["configs"][label] = {
            "equal": None if ref is None else bool(torch.equal(got, ref)),
            "tokens": got.tolist(),
            "logit_gap": None if ref_last is None else float(
                (last.cpu() - ref_last).abs().max()),
            "moments_mode": moments_block(hkv, dv, mesh).mode,
            "window_mode": kv_cache_block(hkv, effective_window(
                spec.window, spec.resolved().chunk_size), mesh).mode,
            "m2_shape": list(next(x for n, x, _ in moment_leaves(state)
                                  if n == "m2").shape),
            "window_k_shape": list(w.shape),
            "held": held, "planned": planned, "one": one,
            "whole_leaves": whole_leaves,
            "hybrid_launches_prefill": prefill_launches["hybrid_causal"],
            "launches_prefill": prefill_launches,
            "launches_decode": {k: v - prefill_launches[k] for k, v in
                                ops.launch_counts().items()},
            "prefill_ms": ev[0].elapsed_time(ev[1]),
            "decode_ms_per_token": ev[1].elapsed_time(ev[2]) / n_dec,
            "prefill_collectives": prefill_coll,
            "decode_collectives_per_step": {
                k: (P.asked[k] / n_dec, P.asked_ms[k] / n_dec)
                for k in P.asked},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del placed, state
        torch.cuda.empty_cache()
        # after the counts are read: these launches are not the path's
        out["configs"][label]["kernel"] = placed_hybrid_kernel_check(
            cfg, mesh, dev)
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def placed_hybrid_serve_phase(smi: str) -> dict:
    """[placed hybrid serve]: float32 hybrid2-kernel qwen3-1.7b (heads
    mode) and granite-20b (feature mode, window rows) prefill and decode
    on (data 1, model 2), each rank's moments and window the planned
    block, against one process's generate()."""
    _free_parent()
    (r0, r1), secs = two_ranks(placed_hybrid_serve_rank, timeout=600)
    out, ok = {"seconds": secs, "card": smi, "configs": {}}, True
    for label, _ in placed_hybrid_cfgs():
        a, b = r0["configs"][label], r1["configs"][label]
        n_layers = dict(PHY_CFGS)[label]
        tol = PHY_LOGIT_TOL[label]
        kern = [r["kernel"] for r in (a, b)]
        kern_ok = all(c["o_ok"] and c["moments_ok"] and c["shapes_ok"]
                      and c["plan"] == a["moments_mode"] for c in kern)
        good = (a["equal"] and b["tokens"] == a["tokens"]
                and a["logit_gap"] <= tol and kern_ok
                and a["held"] == b["held"] == a["planned"]
                and 2 * a["held"]["m2"] == a["one"]["m2"]
                and a["whole_leaves"] == b["whole_leaves"] == 0
                and a["hybrid_launches_prefill"]
                == b["hybrid_launches_prefill"] == n_layers)
        ok = ok and good
        out["configs"][label] = {
            "batch": PHY_B, "prompt": PHY_PROMPT, "gen": PHY_GEN,
            "max_len": PHY_MAX_LEN, "dtype": "float32",
            "attn": "hybrid2-kernel", "layers": n_layers,
            "tokens_equal": a["equal"], "logit_gap": a["logit_gap"],
            "logit_tol": tol, "hybrid_sharded_vs_plain_ranks": kern,
            "moments_mode": a["moments_mode"],
            "window_mode": a["window_mode"],
            "m2_shape_rank": a["m2_shape"],
            "window_k_shape_rank": a["window_k_shape"],
            "state_bytes_ranks": [a["held"], b["held"]],
            "state_bytes_planned": a["planned"],
            "state_bytes_one": a["one"],
            "whole_leaves_ranks": [a["whole_leaves"], b["whole_leaves"]],
            "hybrid_launches_prefill_ranks": [
                a["hybrid_launches_prefill"], b["hybrid_launches_prefill"]],
            "launches_prefill_ranks": [a["launches_prefill"],
                                       b["launches_prefill"]],
            "launches_decode_ranks": [a["launches_decode"],
                                      b["launches_decode"]],
            "prefill_ms_ranks": [a["prefill_ms"], b["prefill_ms"]],
            "decode_ms_per_token_ranks": [a["decode_ms_per_token"],
                                          b["decode_ms_per_token"]],
            "prefill_collectives_ranks": [a["prefill_collectives"],
                                          b["prefill_collectives"]],
            "decode_collectives_per_step_ranks": [
                a["decode_collectives_per_step"],
                b["decode_collectives_per_step"]],
            "peak_gb_ranks": [a["peak_gb"], b["peak_gb"]]}
        coll_lines(f"{label} decode step", [a, b],
                   "decode_collectives_per_step")
        for r, c in enumerate(kern):
            print(f"  {label} rank {r}: hybrid_prefill_sharded ({c['plan']}"
                  f" plan, q {c['q']}, v {c['v']}) against its plain "
                  f"version on the rank's shards: o max abs err "
                  f"{c['o_err']:.3e} (tol {o_tol(torch.float32)}), moments "
                  f"m0..g2 max rel err "
                  f"{[float(f'{e:.3e}') for e in c['moment_errs']]} (tol "
                  f"{TOL_MOMENTS:.0e}), moments {c['shapes'][2]} (m2) the "
                  f"rank's block: {c['shapes_ok']}")
        mb = {k: sum(r["held"].values()) / 1e6 for k, r in (("a", a),
                                                             ("b", b))}
        phase("placed hybrid serve", f"{label} cut to {n_layers} layers, "
              f"float32, hybrid2-kernel, (data 1, model 2) on 2 ranks of "
              f"the card ({smi}): B={PHY_B} prompt {PHY_PROMPT}, a prefill "
              f"and {PHY_GEN - 1} decode tokens; greedy tokens equal one "
              f"process's generate(): {a['equal']}; last-row logits "
              f"{a['logit_gap']:.3e} from one process (tol {tol:.1e}); "
              f"the sharded hybrid kernel against its plain version on "
              f"each rank's shards: {kern_ok}; moments "
              f"{a['moments_mode']} (m2 a rank {a['m2_shape']}), window "
              f"{a['window_mode']} (k a rank {a['window_k_shape']}); "
              f"moments and window MB a rank {[mb['a'], mb['b']]} (planned "
              f"{sum(a['planned'].values()) / 1e6}, one process "
              f"{sum(a['one'].values()) / 1e6}); hybrid-kernel launches a "
              f"rank in the prefill "
              f"{[a['hybrid_launches_prefill'], b['hybrid_launches_prefill']]}"
              f"; prefill ms {out['configs'][label]['prefill_ms_ranks']}, "
              f"decode ms/token "
              f"{out['configs'][label]['decode_ms_per_token_ranks']}; peak "
              f"GB {out['configs'][label]['peak_gb_ranks']}")
    if not ok:
        fail(f"placed hybrid serve: tokens differ from generate(), the "
             f"last logit row is past its limit, the sharded hybrid "
             f"kernel disagrees with its plain version on a rank's shards "
             f"(o, a moment or a moment's shape), a "
             f"rank's moments or window are not the planned bytes (m2 half "
             f"one process's), a rank holds a whole leaf the plan splits, "
             f"or the hybrid kernel did not launch once a layer a rank in "
             f"the prefill: {out}")
    return out


# [placed whisper]: whisper-small's two towers tensor-parallel over
# "model" on (data 1, model 2), two ranks, float32, fastmax2-kernel: each
# rank holds 6 of the 12 heads of every self- and cross-attention and
# 1536 of the 3072 ff columns of every GELU MLP (vocab 51865 divides no
# "model": the embedding and the logits stay whole). Serving at full
# width, 12 + 12 layers, B=4, 1500 frames, a prompt of 128 tokens and 16
# generated; training cut to 2 + 2 layers, B=2, N=128, one AdamW step
PWH_ARCH, PWH_MESH = "whisper-small", (1, 2)
PWH_B, PWH_PROMPT, PWH_GEN = 4, 128, 16
PWH_TRAIN_LAYERS, PWH_TRAIN_B, PWH_TRAIN_N = 2, 2, 128
# the placed prefill's last logit row against one process's, by the rule
# of MLA_F32_LOGIT_TOL: about four times the gap measured on an H100
# (700 W), 4.888e-6 (max |logit| 4.775)
PWH_LOGIT_TOL = 2e-5


def placed_whisper_cfg(n_layers=None):
    """Full-width whisper-small in float32 on fastmax2-kernel, both towers
    cut to `n_layers` (None: uncut, 12 + 12)."""
    from repro_torch.attention import AttentionSpec
    from repro_torch.configs import get_config

    cut = {} if n_layers is None else dict(n_layers=n_layers,
                                           encoder_layers=n_layers)
    return get_config(PWH_ARCH, param_dtype="float32", activ_dtype="float32",
                      attn=AttentionSpec.parse("fastmax2-kernel"), **cut)


def _launches() -> dict:
    """The kernels launched since the counts were last set to 0."""
    from repro_torch.kernels import ops

    return {k: v for k, v in ops.launch_counts().items() if v}


def _asked() -> dict:
    """{kind: (bytes the rank sent, host ms)} of the placed step's
    collectives since `placed.reset_asked()`."""
    from repro_torch.sharding import placed as P

    return {k: (P.asked[k], P.asked_ms[k]) for k in P.asked}


def placed_whisper_serve(rank, mesh, dev) -> dict:
    """Rank 0 first takes one process's encode, generate() and prefill
    logits alone; then both ranks encode, prefill and decode placed on
    (1, 2) under `mixer_spy`, the launch counts and the collectives set
    to 0 before the encode and before the prefill."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import init_decode_state, init_model
    from repro_torch.models.encdec import encode
    from repro_torch.models.transformer import lm_prefill
    from repro_torch.sharding import placed as P
    from repro_torch.sharding.rules import use_mesh

    cfg = placed_whisper_cfg()
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (PWH_B, PWH_PROMPT),
                            generator=gen).to(dev)
    frames = torch.randn(PWH_B, cfg.encoder_seq, cfg.d_model,
                         generator=gen).to(dev)
    max_len = PWH_PROMPT + PWH_GEN
    params = init_model(cfg, seed=0, device=dev)
    one = {}
    if rank == 0:
        with torch.no_grad():
            ops.reset_launch_counts()
            enc = encode(params, frames, cfg)
            one["encode"] = _launches()
            ops.reset_launch_counts()
            one["tokens"] = generate(params, cfg, prompts, PWH_GEN,
                                     enc_out=enc, device=dev).cpu()
            one["generate"] = _launches()
            lg, _ = lm_prefill(params["decoder"], prompts, cfg,
                               init_decode_state(cfg, PWH_B, max_len,
                                                 device=dev), enc_out=enc)
            one["last"] = lg[:, -1].cpu()
            del enc, lg
    dist.barrier()
    placement = P.Placement(cfg, mesh)
    placed = placement.place(params)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with use_mesh(mesh):
        state = init_decode_state(cfg, PWH_B, max_len, device=dev)
    step = make_serve_step(cfg, mesh=mesh)
    positions = PWH_PROMPT + torch.arange(PWH_GEN - 1, device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    out = {}
    with mixer_spy(cfg, mlp=True) as seen:
        ops.reset_launch_counts()
        P.reset_asked()
        ev[0].record()
        with torch.no_grad(), use_mesh(mesh), placement.active():
            enc = encode(placed, frames, cfg)
        ev[1].record()
        ev[1].synchronize()
        out.update(launches_encode=_launches(), coll_encode=_asked())
        ops.reset_launch_counts()
        P.reset_asked()
        with torch.no_grad(), use_mesh(mesh), placement.active():
            lg, state = lm_prefill(placed["decoder"], prompts, cfg, state,
                                   enc_out=enc)
            last = P.gather_vocab(lg[:, -1], cfg.vocab_size)
        tok = last.argmax(-1).to(torch.int32)
        ev[2].record()
        ev[2].synchronize()
        del lg
        out["coll_prefill"] = _asked()
        P.reset_asked()
        toks = [tok]
        for i in range(PWH_GEN - 1):
            tok, state = step(placed, state, tok, positions[i], enc)
            toks.append(tok)
        ev[3].record()
        ev[3].synchronize()
    got = torch.stack(toks, 1).cpu()
    n_dec = PWH_GEN - 1
    out.update(
        launches_generate=_launches(),
        coll_decode_per_step={k: (b / n_dec, t / n_dec)
                              for k, (b, t) in _asked().items()},
        tokens=got.tolist(),
        equal=bool(torch.equal(got, one["tokens"])) if one else None,
        logit_gap=float((last.cpu() - one["last"]).abs().max())
        if one else None,
        logit_scale=float(one["last"].abs().max()) if one else None,
        launches_one={k: one[k] for k in ("encode", "generate")}
        if one else None,
        heads=sorted(seen["heads"]), whole=seen["whole"],
        enc_ok=tuple(enc.shape) == (PWH_B, cfg.encoder_seq, cfg.d_model)
        and bool(enc.isfinite().all()),
        encode_ms=ev[0].elapsed_time(ev[1]),
        prefill_ms=ev[1].elapsed_time(ev[2]),
        decode_ms_per_token=ev[2].elapsed_time(ev[3]) / n_dec,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del placed, state, enc
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def placed_whisper_train(rank, mesh, dev) -> dict:
    """Each rank in turn first takes one process's AdamW step alone (the
    reference, kept on the host), then both take the placed step on
    (1, 2) from the same weights and batch: the loss, and the first
    step's grads and the updated parameters held to the reference's
    slices on each rank (`leaf_sums`, no gather)."""
    import torch.distributed as dist

    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.models import init_model
    from repro_torch.models.param import count_params
    from repro_torch.optim.grad_utils import leaves
    from repro_torch.sharding import placed as P

    cfg = placed_whisper_cfg(PWH_TRAIN_LAYERS)
    raw = SyntheticLM(cfg.vocab_size, PWH_TRAIN_N, seed=0).batch(
        0, PWH_TRAIN_B)
    batch = {k: torch.as_tensor(raw[k], dtype=torch.int32, device=dev)
             for k in ("tokens", "targets")}
    batch["frames"] = torch.randn(
        PWH_TRAIN_B, cfg.encoder_seq, cfg.d_model,
        generator=torch.Generator().manual_seed(1)).to(dev)
    first = {}
    record_first_grads(first)

    def run(placement=None, ref=None):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_model(cfg, seed=0, device=dev)
        _, opt = ST.pick_optimizer(cfg, count_params(params), lr=3e-4,
                                   total_steps=1)
        b, m = batch, None
        if placement is None:
            state = opt[0](params)
        else:
            m = placement.mesh
            params = placement.place(params)
            state = placement.init_opt_state(opt[0], params)
            b = P.shard_batch(batch, m)
        step = ST.make_train_step(cfg, opt, mesh=m)
        ops.reset_launch_counts()
        P.reset_asked()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        params, state, metrics = step(params, state, b)
        ev[1].record()
        ev[1].synchronize()
        out = dict(loss=first["loss"], step_ms=ev[0].elapsed_time(ev[1]),
                   launches=_launches(), collectives=_asked(),
                   finite=math.isfinite(metrics["loss"].item()),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        if placement is None:
            out.update(grads={n: x.detach().float().cpu()
                              for n, x in leaves(first["grads"])},
                       final={n: x.detach().float().cpu()
                              for n, x in leaves(params)})
        else:
            with placement.active():
                out.update(grad_sums=leaf_sums(first["grads"], ref["grads"]),
                           param_sums=leaf_sums(params, ref["final"]))
        first.clear()
        del params, state
        return out

    ref = None
    for r in range(2):          # one process at a time holds the card
        if rank == r:
            ref = run()
        dist.barrier()
    got = run(P.Placement(cfg, mesh), ref)
    got.update({f"{k}_one": ref[k] for k in ("loss", "step_ms", "launches",
                                             "peak_gb")})
    return got


def placed_whisper_rank(rank, world):
    """A [placed whisper] rank: serving at full width, then training at
    2 + 2 layers, on (data 1, model 2)."""
    dev = _rank_setup()
    from repro_torch.launch.mesh import make_test_mesh

    del world
    mesh = make_test_mesh(PWH_MESH, ("data", "model"))
    return {"rank": rank, "serve": placed_whisper_serve(rank, mesh, dev),
            "train": placed_whisper_train(rank, mesh, dev)}


def placed_whisper_phase(smi: str) -> dict:
    """[placed whisper]: whisper-small's towers tensor-parallel over
    "model" on (data 1, model 2), float32, fastmax2-kernel: full-width
    serving against one process's encode and generate(), and one AdamW
    step of the 2 + 2-layer cut against one process's."""
    _free_parent()
    (r0, r1), secs = two_ranks(placed_whisper_rank, timeout=900)
    cfg = placed_whisper_cfg()
    h = cfg.n_heads // PWH_MESH[1]
    a, b = r0["serve"], r1["serve"]
    one = a["launches_one"]
    want_e = {"fastmax_noncausal_moments": cfg.encoder_layers,
              "fastmax_noncausal_combine": cfg.encoder_layers}
    want_g = {"fastmax_causal": cfg.n_layers,
              "fastmax_decode": cfg.n_layers * (PWH_GEN - 1),
              "fastmax_noncausal_moments": cfg.n_layers * PWH_GEN,
              "fastmax_noncausal_combine": cfg.n_layers * PWH_GEN}
    serve_ok = (a["equal"] and b["tokens"] == a["tokens"]
                and one == {"encode": want_e, "generate": want_g}
                and all(r["launches_encode"] == want_e
                        and r["launches_generate"] == want_g
                        and [tuple(x) for x in r["heads"]] == [(h, h, h)]
                        and not r["whole"]
                        and r["enc_ok"] for r in (a, b))
                and a["logit_gap"] <= PWH_LOGIT_TOL)
    ta, tb = r0["train"], r1["train"]
    gleaf, gerr = worst_sums([ta, tb], "grad_sums")
    pleaf, perr = worst_sums([ta, tb], "param_sums")
    loss_diff = abs(ta["loss"] - ta["loss_one"])
    train_ok = (loss_diff <= TRAIN_LOSS_TOL and gerr <= TRAIN_GRAD_TOL
                and perr <= TRAIN_GRAD_TOL and ta["finite"] and tb["finite"]
                and ta["launches"] == tb["launches"] == ta["launches_one"])
    out = {"arch": PWH_ARCH, "mesh": list(PWH_MESH), "dtype": "float32",
           "attn": "fastmax2-kernel", "card": smi, "seconds": secs,
           "heads_a_rank": h, "ff_a_rank": cfg.d_ff // PWH_MESH[1],
           "serve": {
               "layers": [cfg.encoder_layers, cfg.n_layers],
               "batch": PWH_B, "frames": cfg.encoder_seq,
               "prompt": PWH_PROMPT, "gen": PWH_GEN,
               "tokens_equal": a["equal"], "logit_gap": a["logit_gap"],
               "logit_scale": a["logit_scale"], "logit_tol": PWH_LOGIT_TOL,
               "launches_one": one,
               "launches_ranks": [{"encode": r["launches_encode"],
                                   "generate": r["launches_generate"]}
                                  for r in (a, b)],
               "attention_heads_ranks": [a["heads"], b["heads"]],
               "whole_leaves_ranks": [a["whole"], b["whole"]],
               **{f"{k}_ranks": [a[k], b[k]] for k in (
                   "encode_ms", "prefill_ms", "decode_ms_per_token",
                   "peak_gb", "coll_encode", "coll_prefill",
                   "coll_decode_per_step")}},
           "train": {
               "layers": [PWH_TRAIN_LAYERS, PWH_TRAIN_LAYERS],
               "batch": PWH_TRAIN_B, "seq": PWH_TRAIN_N,
               "loss": ta["loss"], "loss_one": ta["loss_one"],
               "loss_diff": loss_diff, "worst_grad_leaf": gleaf,
               "worst_grad_err": gerr, "worst_param_leaf": pleaf,
               "worst_param_err": perr,
               "launches_ranks": [ta["launches"], tb["launches"]],
               "launches_one": ta["launches_one"],
               "step_ms_ranks": [ta["step_ms"], tb["step_ms"]],
               "step_ms_one": ta["step_ms_one"],
               "peak_gb_ranks": [ta["peak_gb"], tb["peak_gb"]],
               "peak_gb_one": ta["peak_gb_one"],
               "collectives_ranks": [ta["collectives"],
                                     tb["collectives"]]}}
    sv, tr = out["serve"], out["train"]
    for part in ("encode", "prefill"):
        coll_lines(f"whisper {part}", [{"c": r[f"coll_{part}"]}
                                       for r in (a, b)], "c")
    coll_lines("whisper decode step", [a, b], "coll_decode_per_step")
    coll_lines("whisper train step", [ta, tb], "collectives")
    phase("placed whisper", f"{PWH_ARCH} serving, {cfg.encoder_layers} + "
          f"{cfg.n_layers} layers, float32, "
          f"fastmax2-kernel, (data 1, model 2) on 2 ranks of the card "
          f"({smi}): {h} of {cfg.n_heads} heads and {cfg.d_ff // 2} of "
          f"{cfg.d_ff} ff columns a rank; B={PWH_B}, {cfg.encoder_seq} "
          f"frames, prompt {PWH_PROMPT}, {PWH_GEN} tokens; greedy tokens "
          f"equal one process's: {a['equal']}; last-row logits "
          f"{a['logit_gap']:.3e} from one process (tol {PWH_LOGIT_TOL:.1e}; "
          f"max |one| {a['logit_scale']:.3f}); launches a rank (encode, "
          f"generate) {sv['launches_ranks']} (one process {one}); "
          f"attention (q, k, v) heads a rank {a['heads']}; whole leaves "
          f"gathered {sv['whole_leaves_ranks']}; encode ms "
          f"{sv['encode_ms_ranks']}, prefill ms {sv['prefill_ms_ranks']}, "
          f"decode ms/token {sv['decode_ms_per_token_ranks']}; peak GB "
          f"{sv['peak_gb_ranks']}")
    phase("placed whisper", f"{PWH_ARCH} training cut to "
          f"{PWH_TRAIN_LAYERS} + {PWH_TRAIN_LAYERS} layers, float32, AdamW "
          f"B={PWH_TRAIN_B} N={PWH_TRAIN_N}, one step on (1, 2) against "
          f"one process: loss |diff| {loss_diff:.3e} (tol "
          f"{TRAIN_LOSS_TOL}); worst grad {gleaf} {gerr:.3e}, worst "
          f"updated parameter {pleaf} {perr:.3e} (tol {TRAIN_GRAD_TOL}); "
          f"launches a rank {tr['launches_ranks']} (one process "
          f"{tr['launches_one']}); step ms {tr['step_ms_ranks']} (one "
          f"process {tr['step_ms_one']:.1f}); peak GB "
          f"{tr['peak_gb_ranks']} (one process {tr['peak_gb_one']:.3f}); "
          f"phase {secs:.1f} s")
    if not (serve_ok and train_ok):
        fail(f"placed whisper: tokens differ from one process's, the "
             f"last logit row is past its limit, a rank's launches are "
             f"not one process's, an attention call is not on {h} heads, "
             f"a rank gathered a whole attention or MLP leaf, or the "
             f"training step's loss, grads or parameters disagree with "
             f"one process's: {out}")
    return out


# dryrun phase: the executed peak the meta count predicts (arguments + the
# temp peak of live storages) against the card's max_memory_allocated() of
# the same step; the rest (launches, kernel work, matmul flops, argument
# bytes) must be equal
DRYRUN_PEAK_TOL = 0.10
DRYRUN_B, DRYRUN_N = 4, 1024
DRYRUN_DIR = Path(__file__).resolve().parent / "build" / "dryrun_gate"


def start_gate() -> subprocess.Popen:
    """Start the reference's dry-run gate cell (train_1M --cp 16) on meta
    in a process of its own, its output under DRYRUN_DIR. It needs no
    card (none is visible to it), so it runs beside the card's phases
    (from the training phase on: the host-bound serving phases before it
    would time its host work with theirs);
    `dryrun_phase` waits for it, and it is killed if the script exits
    first."""
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    with open(DRYRUN_DIR / "gate.out", "w") as out, \
            open(DRYRUN_DIR / "gate.err", "w") as err:
        gate = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "qwen3-1.7b", "--shape", "train_1M", "--cp", "16", "--attn",
             "fastmax2-kernel", "--assert-kernel-route", "--out",
             str(DRYRUN_DIR)], stdout=out, stderr=err, env=env)
    atexit.register(lambda: gate.poll() is None and gate.kill())
    return gate


def dryrun_phase(dev, gate, placed=None) -> dict:
    """The dry run's count of full-width qwen3-1.7b on one device against
    the same steps run on the card (phase 25), and the gate cell's result
    (`gate`, from `start_gate`); with `placed` ([placed train]'s result),
    the placed step's meta count on the two-rank world against each
    rank's count on the card."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.attention import AttentionSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.op_analysis import OpCount, tree_bytes
    from repro_torch.models import init_model

    t_phase = time.monotonic()
    extra = {"remat": "full"}
    cfg = get_config("qwen3-1.7b", attn=AttentionSpec.parse(
        "fastmax2-kernel"), **extra)
    n_l = cfg.n_layers
    want = {"train": {"fastmax_causal": 2 * n_l, "fastmax_causal_bwd": n_l},
            "prefill": {"fastmax_causal": n_l},
            "decode": {"fastmax_decode": n_l}}
    torch.cuda.empty_cache()
    params = init_model(cfg, seed=0, device=dev)
    out = {}
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec(DRYRUN_N, DRYRUN_B, kind)
        meta = D.run_cell("qwen3-1.7b", shape, attn="fastmax2-kernel",
                          extra_cfg=extra, mesh=None)
        fn, args, parts = D.cell_step(cfg, shape, device=dev, params=params)
        arg_bytes = tree_bytes(args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        with OpCount("cuda") as count:
            ev0.record()
            fn(*args)
            ev1.record()
        ev1.synchronize()
        step_ms = ev0.elapsed_time(ev1)
        # the card's peak with only the step's arguments held before it
        peak = torch.cuda.max_memory_allocated() - (held - arg_bytes)
        counted = {k: v for k, v in ops.launch_counts().items() if v}
        real = count.result()
        pred = meta["executed"]["total"]
        roof = meta["roofline"]
        roof_ms = max(roof["compute_s"], roof["memory_s"],
                      roof["collective_s"]) * 1e3
        row = {"launches": count.launches(),
               "matmul_flops": real["matmul_flops"],
               "meta_matmul_flops": meta["ops"]["matmul_flops"],
               "argument_bytes": arg_bytes,
               "meta_argument_bytes": meta["executed"]["argument_bytes"],
               "peak_bytes": peak, "meta_peak_bytes": pred,
               "temp_peak_bytes": real["temp_peak_bytes"],
               "meta_temp_peak_bytes": meta["executed"]["temp_peak_bytes"],
               "held_before_bytes": held, "step_ms": step_ms,
               "roofline_ms": roof_ms, "dominant": roof["dominant"],
               "hbm_bytes": real["hbm_bytes"],
               "meta_hbm_bytes": meta["ops"]["hbm_bytes"]}
        out[kind] = row
        print(f"  {kind} B={DRYRUN_B} N={DRYRUN_N}: launches "
              f"{row['launches']} (meta {meta['launches']}), matmul flops "
              f"{real['matmul_flops']:.6e} (meta "
              f"{meta['ops']['matmul_flops']:.6e}), argument bytes "
              f"{arg_bytes} (meta {meta['executed']['argument_bytes']}), "
              f"peak {peak / 1e9:.4f} GB against max_memory_allocated "
              f"(meta {pred / 1e9:.4f} GB, {pred / peak - 1:+.2%}; temp "
              f"{real['temp_peak_bytes'] / 1e9:.4f} counted on the card, "
              f"{meta['executed']['temp_peak_bytes'] / 1e9:.4f} on meta); "
              f"step {step_ms:.1f} ms, roofline {roof_ms:.1f} ms "
              f"({roof['dominant']}); HBM bytes counted "
              f"{real['hbm_bytes']:.4e} (meta {meta['ops']['hbm_bytes']:.4e})")
        if not (count.launches() == meta["launches"] == want[kind]
                == counted):
            fail(f"dryrun {kind}: launches on the card {count.launches()} "
                 f"(launch_counts {counted}), on meta {meta['launches']}, "
                 f"expected {want[kind]}")
        if count.kernel_work() != meta["kernel_work"]:
            fail(f"dryrun {kind}: kernel work on the card "
                 f"{count.kernel_work()} != meta {meta['kernel_work']}")
        if real["matmul_flops"] != meta["ops"]["matmul_flops"]:
            fail(f"dryrun {kind}: matmul flops differ")
        if arg_bytes != meta["executed"]["argument_bytes"]:
            fail(f"dryrun {kind}: argument bytes differ")
        if abs(pred - peak) > DRYRUN_PEAK_TOL * peak:
            fail(f"dryrun {kind}: the counted peak {pred} is not within "
                 f"{DRYRUN_PEAK_TOL:.0%} of max_memory_allocated {peak}")
        del fn, args, parts, count
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    if placed is not None:
        meta = placed_meta_counts()
        out["placed"] = meta
        for key, want in meta.items():
            for r, got in enumerate(placed["meshes"][key]["count_ranks"]):
                if got != want:
                    fail(f"dryrun placed {key} rank {r}: the card's "
                         f"{got} != meta {want}")
            print(f"  placed (data, model) = ({key.replace('x', ', ')}): "
                  f"meta = each rank's card count: launches "
                  f"{want['launches']}, matmul flops "
                  f"{want['matmul_flops']:.6e}, argument bytes "
                  f"{want['argument_bytes']}, checkpointed residual bytes "
                  f"{want['block_input_bytes']}")
    # the reference's dry-run gate cell, started by start_gate()
    t0 = time.monotonic()
    try:
        rc = gate.wait(timeout=300)
    except subprocess.TimeoutExpired:
        gate.kill()
        rc = gate.wait()
    gate_s = time.monotonic() - t0
    said = (DRYRUN_DIR / "gate.out").read_text().strip()
    print("  gate: " + said.replace("\n", "\n  gate: "))
    if rc != 0:
        fail(f"dryrun gate (train_1M --cp 16) exited {rc}: "
             f"{(DRYRUN_DIR / 'gate.err').read_text()[-2000:]}")
    res = json.loads((DRYRUN_DIR / "qwen3-1.7b__train_1M__single__"
                      "fastmax2-kernel__cp16.json").read_text())
    out["gate"] = {"wait_seconds": gate_s, "cell_seconds": res["seconds"],
                   "launches": res["launches"],
                   "attn_routing": res["attn_routing"],
                   "cp_boundary": res["cp_boundary"],
                   "planned_gb": res["planned"]["total"] / 1e9,
                   "executed_gb": res["executed"]["total"] / 1e9}
    phase("dryrun", f"meta counts = the card's for train, prefill and "
          f"decode (launches, kernel work, matmul flops, argument bytes; "
          f"peaks within {DRYRUN_PEAK_TOL:.0%}); train_1M --cp 16 gate "
          f"exit 0 (cell {res['seconds']:.1f} s beside the card's phases, "
          f"{gate_s:.1f} s waited for); phase "
          f"{time.monotonic() - t_phase:.1f} s")
    return out


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
        # the prefill kernel at the engine phase's own shapes: batch 1,
        # chunks of qwen3's chunk_size, each seeded with the slot's carry.
        # A prompt's first chunk starts from zero moments (offset 0); a
        # later one from the carry of the tokens before it (here the plain
        # version's state after a 512-token chunk); the ragged last chunk
        # runs at its own length with no mask. Also a full chunk with a
        # contiguous tail mask (the reference pads a ragged chunk so).
        # Lengths from the engine's traffic; its own generator, so the
        # later phases draw the same data
        import numpy as np

        qcfg = get_config("qwen3-1.7b")
        ec, ehq, ehkv, ed = (qcfg.chunk_size, qcfg.n_heads,
                             qcfg.n_kv_heads, qcfg.head_dim)
        plens = np.random.default_rng(0).integers(*ENGINE_PROMPTS,
                                                  ENGINE_REQUESTS)
        n_short = int(next(n for n in plens if n < ec))
        n_tail = int(next(n for n in plens if n > ec and n % ec)) % ec
        eg = torch.Generator(device=dev).manual_seed(1)
        for dtype in (torch.float32, torch.bfloat16):
            def chunk(n):
                return (normalize_qk(torch.randn(1, ehq, n, ed, generator=eg,
                                                 device=dev)).to(dtype),
                        normalize_qk(torch.randn(1, ehkv, n, ed, generator=eg,
                                                 device=dev)).to(dtype),
                        torch.randn(1, ehkv, n, ed, generator=eg,
                                    device=dev).to(dtype))

            _, carry = fastmax_causal_ref(*chunk(ec), p=2, chunk_size=512)
            zero = tuple(torch.zeros_like(t) for t in carry)
            for tag, n, init, nvalid in (
                    ("first chunk from zero moments", n_short, zero, None),
                    ("resumed chunk", ec, carry, None),
                    ("resumed ragged last chunk", n_tail, carry, None),
                    (f"resumed chunk, tail mask {n_tail} valid", ec, carry,
                     n_tail)):
                q, k, v = chunk(n)
                mask = None if nvalid is None else (
                    torch.arange(n, device=dev) < nvalid).float().expand(
                        1, ehkv, n)
                o, st = fastmax_causal_cuda(q, k, v, mask, p=2,
                                            init_state=init)
                ro, rst = fastmax_causal_ref(q, k, v, mask, p=2,
                                             chunk_size=512, init_state=init)
                torch.cuda.synchronize()
                eo, o_ok = o_err(o, ro)
                em = max(moment_err(a, r) for a, r in zip(st, rst))
                etag = (f"prefill engine {tag} {str(dtype)[6:]} B=1 "
                        f"Hq={ehq} Hkv={ehkv} D={ed} N={n}")
                print(f"  {etag}: o max abs err {eo:.3e} (tol "
                      f"{o_tol(dtype)}), moments max rel err {em:.3e} "
                      f"(tol {TOL_MOMENTS:.0e})")
                if not (o_ok and em <= TOL_MOMENTS):
                    fail(f"{etag} kernel disagrees with its plain version")
        phase("kernels", "prefill (f32, bf16; plain and mask+init) and "
              "chained decode steps agree with their plain versions at "
              "qwen3's and whisper's widths; the prefill's edges (N=1 "
              "resumed, N < L, G=1 D=64, p=1, N=4096 in 2 segments) and "
              "the engine's batch-1 chunks (from zero moments, resumed "
              "from a carry, ragged, tail mask) too")

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

        # ---- 5b. the continuous-batching engine, full width ----
        eng_out = engine_phase(params, cfg, plain_cfg, dev)

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
        fc_ops = prefill_ops(bh, gq, P, d, d)
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
        fd_ops = decode_ops(bh, gq, d, d)
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

    def qwen_case(b, n, dtype, p, seeded, heads=(hq, hkv)):
        return bwd_case(gen, b, n, dtype, p, seeded, heads, d)

    for dtype in (torch.float32, torch.bfloat16):
        qwen_case(2, 1024, dtype, 2, False)
        qwen_case(2, 1000, dtype, 2, True)
    qwen_case(2, 1000, torch.float32, 1, True)
    # granite's grouping: 48 query heads on one kv head
    qwen_case(1, 512, torch.float32, 2, False, heads=(48, 1))
    # past one segment (3840 tokens at B=2): two, the last seeding the first
    _, nseg, _ = qwen_case(2, 4096, torch.float32, 2, True)
    if nseg != 2:
        fail(f"the backward at B=2 N=4096 ran in {nseg} segments, not 2")
    qwen_case(4, P, torch.float32, 2, False)
    fb_err, nseg, bargs = qwen_case(4, P, torch.bfloat16, 2, False)
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
    fb_ops = bwd_ops(bh, gq, P, d, d)
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
    mla_bwd = bwd_mla(gen, dev)

    # ---- 8. training path: full-width qwen3-1.7b, bf16 ----
    # the dry-run gate cell runs on the host beside the training steps,
    # which the card bounds (the serving phases before them are host-bound)
    gate = start_gate()
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
    dots = train_dots(tcfg, batch, dev, n_steps)
    med_dots = sorted(dots["step_ms"])[len(dots["step_ms"]) // 2]
    phase("train", f"remat=dots beside remat=full, same weights and batch: "
          f"loss {dots['loss_dots']:.6f} / {dots['loss_full']:.6f} (equal: "
          f"{dots['loss_dots'] == dots['loss_full']}); grads max |dots - "
          f"full| {dots['grad_max_diff']:.3e}, worst excess over "
          f"{REMAT_RTOL:.0e}|full| {dots['grad_over']:.3e} (tol "
          f"{REMAT_ATOL:.0e}); that backward's launches "
          f"{dots['grad_launches']}; step ms "
          f"{', '.join(f'{x:.1f}' for x in dots['step_ms'])} (full "
          f"{', '.join(f'{x:.1f}' for x in step_ms)}), "
          f"{B * P / (med_dots / 1e3):.1f} tokens/s at the median, peak "
          f"{dots['peak_gb']:.2f} GB (full {peak_train:.2f}), loss "
          f"{', '.join(f'{x:.4f}' for x in dots['losses'])} (same as full: "
          f"{dots['losses'] == losses})")
    if not (dots["loss_dots"] == dots["loss_full"]
            and dots["grad_over"] <= REMAT_ATOL
            and dots["grad_launches"] == want_t
            and all(c == want_t for c in dots["step_launches"])):
        fail(f"train: remat=dots disagrees with remat=full or launched "
             f"{dots['grad_launches']} / {dots['step_launches']}, expected "
             f"{want_t}")

    # ---- 8b. checkpoint, kill, resume: full-width qwen3-1.7b ----
    t0 = time.monotonic()
    ck, ck_ok = ckpt_phase()
    in_flight = [ms for _, ms, fl in ck["steps_a"] if fl]
    quiet = [ms for s_, ms, fl in ck["steps_a"] + ck["steps_b"]
             if not fl and s_ not in (0, 2)]
    phase("ckpt", f"qwen3-1.7b cut to {CKPT_LAYERS} layers "
          f"fastmax2-kernel bf16 B=4 N=1024 AdamW through launch.train: "
          f"run A losses "
          f"{', '.join(f'{x:.6f}' for x in ck['losses_a'])}; resumed run B "
          f"{', '.join(f'{x:.6f}' for x in ck['losses_b'])} (bitwise equal "
          f"to A's steps 2-3: {ck['losses_b'] == ck['losses_a'][2:]}); "
          f"params equal {ck['leaves_equal']}/{ck['leaves']} leaves; label "
          f"2 holds .step {ck['label2_step']}; checkpoint "
          f"{ck['ckpt_gb']:.3f} GB on disk, blocking save {ck['save_s']} s "
          f"(after "
          f"{ck['wait_s']} s waiting for the async write), async snapshot "
          f"{ck['snapshot_ms']} ms on the loop's thread, restore "
          f"{ck['restore_s']} s; step ms (host) with a save in flight "
          f"{in_flight}, without {quiet}; launches A {ck['launches_a']}, B "
          f"{ck['launches_b']}; {time.monotonic() - t0:.1f}s in all")
    if not ck_ok:
        fail("ckpt: the resumed run is not the unbroken run bit for bit, or "
             "a step launched other kernels than 2 n_layers forward and "
             "n_layers backward")

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
    rows = feature_rows(wd, 2)               # feature rows, symmetric m2
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
    # operations and bytes of each launch (kernels/work.py). The tensor
    # cores run the value columns' products in passes of the TF32 split: 2
    # for the moments of bf16 keys and values, 3 for the combine
    nm_ops, nm_bytes = noncausal_moments_work(B, wh, WM, wd, wd, 2)
    nm_tc = 2 * bhw * WM * rows * 2 * wd

    def combine_bound(n):
        ops_, bytes_ = noncausal_combine_work(B, wh, wh, n, wd, wd, 2)
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
    # operations: the prefill's plus the band pairs before each query's
    # chunk of BOUND_CHUNK (kernels/work.py); bytes as the prefill's
    hy_ops = hybrid_ops(bh, gq, P, d, d, w_eff)
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
    from repro_torch.models.transformer import _layers

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
        layer0 = _layers(params, hcfg)[0][3]
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

    # ---- the SDPA yardstick: torch's softmax attention, bf16 ----
    # softmax, not fastmax, so no kernel's library_ms: timed beside them
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sq = randn(B, cfg.n_heads, P, cfg.head_dim).bfloat16()
    skv = randn(B, cfg.n_kv_heads, P + G, cfg.head_dim).bfloat16()
    wq = randn(B, 12, WM, 64).bfloat16()
    sdpa_line = {"softmax_sdpa": {
        "prefill_causal_ms": sync_ms(lambda: sdpa(
            sq, skv[:, :, :P], skv[:, :, :P], is_causal=True,
            enable_gqa=True), 10),
        "decode_ms": sync_ms(lambda: sdpa(
            sq[:, :, :1], skv, skv, enable_gqa=True), 100),
        "whisper_noncausal_ms": sync_ms(lambda: sdpa(wq, wq, wq), 10),
        "shapes": {"prefill_causal": [B, cfg.n_heads, cfg.n_kv_heads, P,
                                      cfg.head_dim],
                   "decode": [B, cfg.n_heads, cfg.n_kv_heads, 1, P + G,
                              cfg.head_dim],
                   "whisper_noncausal": [B, 12, 12, WM, WM, 64]},
        "fastmax_ms": {"prefill": fc_ms, "decode": fd_ms,
                       "noncausal_moments_plus_combine": nm_ms + nc_ms}}}
    del sq, skv, wq
    phase("sdpa", f"scaled_dot_product_attention bf16: causal B={B} "
          f"N={P} {sdpa_line['softmax_sdpa']['prefill_causal_ms']:.3f} ms "
          f"(fastmax prefill kernel {fc_ms:.3f}); one query against "
          f"{P + G} keys {sdpa_line['softmax_sdpa']['decode_ms']:.4f} ms "
          f"(fastmax decode kernel {fd_ms:.4f}); whisper noncausal N=M={WM} "
          f"{sdpa_line['softmax_sdpa']['whisper_noncausal_ms']:.3f} ms "
          f"(fastmax moments + combine {nm_ms + nc_ms:.3f})")

    # ---- the attention API's oracle and rowwise backends ----
    api, api_ok = api_phase(dev)
    phase("api", "oracle / rowwise f32 at whisper's widths, max |diff| "
          "against chunked / kernel: " + "; ".join(
              f"{'causal D=32' if c else 'noncausal D=64'} {n[8:]} vs "
              f"{a[8:]} {e:.2e}" for (c, n, a), e in api["errs"].items())
          + f" (tol {API_TOL:.0e} of scale); dropout 0.1: " + "; ".join(
              f"{m}: {r['draws']} masks, keep {r['keep_share']} "
              f"(sigma {r['sigma']}), two calls bitwise {r['bitwise']}"
              for m, r in api["dropout"].items()))
    if not api_ok:
        fail("api: oracle or rowwise disagrees on the card, or a dropout "
             "mode is not seeded or keeps the wrong share")

    # ---- the MoE family: full-width deepseek-v2 (MLA), the new configs ----
    torch.cuda.empty_cache()
    moe = moe_phase(dev)
    moe_train = moe_train_phase(dev, mla_bwd["ms_mla"])
    arch = archs_phase(dev)

    # ---- the SSM slice: full-width jamba (G = 4) and xlstm-1.3b ----
    torch.cuda.empty_cache()
    ssm = ssm_phase(dev)

    # ---- the schedule autotuner: candidates, mode off, tuned models ----
    torch.cuda.empty_cache()
    tuned = autotune_phase(dev, smi)

    # ---- the kernel plans: two gloo ranks on the one card ----
    torch.cuda.empty_cache()
    # ---- two ranks on the card: the phases on torch's own allocator in
    # one spawn, those on expandable segments in another; each phase then
    # checks and prints its ranks' results ----
    _free_parent()
    spawn_together("plain_alloc", (
        (shard_rank, (SHARD_CASES,)), (cp_train_rank, (CP_STEPS,)),
        (placed_train_rank, (PLACED_STEPS,)), (placed_serve_rank, ()),
        (placed_kv_serve_rank, ()), (placed_hybrid_serve_rank, ()),
        (placed_whisper_rank, ())),
        timeout=3300)
    shard = shard_phase()
    cp_train = cp_train_phase()

    # ---- the placed step: FSDP and tensor parallelism, two ranks ----
    torch.cuda.empty_cache()
    placed_train = placed_train_phase()
    placed_serve = placed_serve_phase()

    # ---- expert parallelism: full-width deepseek-v2, two ranks ----
    torch.cuda.empty_cache()
    _free_parent()
    spawn_together("expandable", (
        (placed_moe_train_rank, ()), (placed_moe_serve_rank, ()),
        (placed_ssm_train_rank, ()), (placed_ssm_serve_rank, ()),
        (cp_gathered_rank, ())),
        timeout=3300)
    placed_moe_train = placed_moe_train_phase()
    placed_moe_serve = placed_moe_serve_phase()
    cp_train["gathered"].update(cp_gathered_phase())

    # ---- the SSM mixers split over "model": xlstm and jamba, two ranks ----
    torch.cuda.empty_cache()
    placed_ssm_train = placed_ssm_train_phase()
    placed_ssm_serve = placed_ssm_serve_phase()

    # ---- the softmax KV cache placed by kv_cache_spec, two ranks ----
    torch.cuda.empty_cache()
    placed_kv_serve = placed_kv_serve_phase(smi)

    # ---- the moment states and the hybrid window placed, two ranks ----
    torch.cuda.empty_cache()
    placed_hybrid_serve = placed_hybrid_serve_phase(smi)

    # ---- whisper's towers tensor-parallel over "model", two ranks ----
    torch.cuda.empty_cache()
    placed_whisper = placed_whisper_phase(smi)

    # ---- the dry run against the real step ----
    torch.cuda.empty_cache()
    dryrun = dryrun_phase(dev, gate, placed_train)

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
         "call_peak_bytes": call_peak,
         "launches_engine": eng_out["launches"]["fastmax_causal"],
         "launches_mla": moe["launches_mla"]["fastmax_causal"],
         **{k: moe[k] for k in moe if k.startswith("prefill_")
            and k.endswith("_mla")},
         "launches_jamba": ssm["launches_jamba"]["fastmax_causal"],
         **{k: ssm[k] for k in ssm if k.startswith("prefill_")
            and k.endswith("_g4")}},
        {"name": "fastmax_decode_step", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fastmax_decode.cu",
         "replaces": "src/repro/kernels/fastmax_decode.py:81",
         "launches": launches["fastmax_decode"], "max_abs_err": fd_err,
         "ms": fd_ms, "plain_ms": fd_plain, "bound_ms": fd_bound,
         "bound_by": "bytes" if fd_bytes / H100_BYTES_PER_S
         >= fd_ops / H100_F32_FLOPS else "operations",
         "library_ms": None,
         "launches_engine": eng_out["launches"]["fastmax_decode"],
         "launches_mla": moe["launches_mla"]["fastmax_decode"],
         **{k: moe[k] for k in moe if k.startswith("decode_")
            and k.endswith("_mla")},
         **arch,
         "launches_jamba": ssm["launches_jamba"]["fastmax_decode"],
         **{k: ssm[k] for k in ssm if k.startswith("decode_")
            and k.endswith("_g4")}},
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
         "workspace_bytes": bws_bytes, "call_peak_bytes": bwd_peak,
         "launches_mla": moe_train["launches"]["fastmax_causal_bwd"],
         **mla_bwd},
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
         "launches_serve": hs_launches["hybrid_causal"],
         # per rank per step of [cp train] (a): the gathered sequence
         "launches_cp_train_rank_step": cp_train["gathered"][
             "hybrid2-kernel"]["launches_per_rank_step"][0]["hybrid_causal"],
         # per rank, in each [placed hybrid serve] prefill
         "launches_placed_prefill_ranks": {
             label: c["hybrid_launches_prefill_ranks"] for label, c in
             placed_hybrid_serve["configs"].items()}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps(sdpa_line))
    print(json.dumps({"moe_deepseek_v2": {
        k: moe[k] for k in ("prefill_ms", "decode_ms", "tok_s", "peak_gb",
                            "logit_gap_bf16", "logit_gap_f32",
                            "route_flips_bf16", "route_flips_f32",
                            "params")}}))
    print(json.dumps({"moe_train_deepseek_v2": moe_train}))
    print(json.dumps({"ssm": {"jamba_8_layers": ssm["jamba"],
                              "xlstm_1_3b": ssm["xlstm"]}}))
    print(json.dumps({"autotune": tuned}))
    print(json.dumps({"shard": shard}))
    print(json.dumps({"cp_train": cp_train}))
    print(json.dumps({"placed_train": placed_train}))
    print(json.dumps({"placed_serve": placed_serve}))
    print(json.dumps({"placed_moe_train": placed_moe_train}))
    print(json.dumps({"placed_moe_serve": placed_moe_serve}))
    print(json.dumps({"placed_ssm_train": placed_ssm_train}))
    print(json.dumps({"placed_ssm_serve": placed_ssm_serve}))
    print(json.dumps({"placed_kv_serve": placed_kv_serve}))
    print(json.dumps({"placed_hybrid_serve": placed_hybrid_serve}))
    print(json.dumps({"placed_whisper": placed_whisper}))
    print(json.dumps({"dryrun": dryrun}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
