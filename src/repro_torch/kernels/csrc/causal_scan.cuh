// The chunked causal scan of the hybrid near/far-field kernel for Hopper
// (sm_90a), hybrid_causal.cu (w_eff > 0). The causal fastmax prefill,
// fastmax_causal.cu, no longer uses it.
//
// What it computes, per (batch, kv-head) bh with G grouped query heads,
// walking the sequence in chunks of C tokens with the moment carry of all
// previous chunks (m0, m1, m2, g0, g1, g2 as in core/fastmax.py):
//   inter:  num = m0 + q.m1 + 1/2 sum_ab q_a q_b m2[ab, :]
//           den = g0 + q.g1 + 1/2 q^T g2 q
//   intra:  s = q k^T (C x C), f = (1 + s [+ s^2/2]) * causal * w,
//           num += f v, den += sum f
//   band:   for every key j with 0 <= i - j < w_eff (query position i),
//           num += (exp(s) - f(s)) w_j v_j, den += (exp(s) - f(s)) w_j:
//           an in-chunk pair's weight becomes exp(s) w_j
//   o = num / (den + eps); then the chunk (weighted by w) is folded into
//   the carry. The final carry is the kernel's state output, m2 in the
//   m-major [D*D, Dv] layout the decode kernel reads.
// The band adds only the correction on top of f(s), so w_eff = 0 is the
// fastmax scan exactly, and the exponential is the reference's unshifted
// exp(s) (no max shift: |s| <= D after normalization, and exp overflows
// float32 above s ~ 88.7, in the reference as here).
//
// Design. The TPU kernels keep the whole carry in VMEM; here m2 alone is
// 8 MB per bh at D = Dv = 128, past the 227 KB of shared memory a block
// can use. So:
//   * one block per (Dv column block of 32, bh), 256 threads, looping over
//     the chunks in order; 4 x 32 = 128 blocks at qwen3's shapes;
//   * the running m2 carry lives in device memory: the block's own column
//     slice of the m2 state output, zeroed or seeded from init_state. Each
//     chunk streams it once in tiles of 32 rows: the tile is contracted
//     with the queries (the old carry) and then updated with the chunk and
//     written back — one read and one write of the carry per chunk;
//   * both m2 products are register-tiled: thread (ty, tx) owns query rows
//     4ty..4ty+3 (the chunk's G*C <= 128 query rows) and carry columns
//     4tx..4tx+3, and reads float4 fragments of the query products
//     q_a q_b (built per tile in shared memory from the transposed queries)
//     and of the carry tile: 16 FMAs per two shared-memory loads. The fold
//     gives thread (ty, tx) carry row ty of the tile and the same columns;
//   * the small carries (m0, m1 column slice, g0, g1, g2) live in shared
//     memory; the g-carry is recomputed by every column block (as the
//     Pallas kernel does per Dv block) and written out by block 0. The
//     denominator stays in registers (the 8 threads of a row group reduce
//     their partial q^T g2 q with warp shuffles);
//   * the band's in-chunk pairs take exp(s) in place of f(s) in the
//     intra-chunk block, pair by pair (adding f and exp - f as separate
//     sums would cancel in float32 in rows whose keys are all in the band
//     and score very negative); its earlier keys (the w_eff - 1 before the
//     chunk's first query, any number of chunks back), whose f(s) is in
//     the carry, are read again from device memory, C at a time, into the
//     chunk's own key, value and mask buffers once the chunk is folded,
//     and their (exp - f) correction is computed only inside the band.
//     Every column block computes all scores, so each holds the whole
//     denominator, band included.
// The chunk length C is chosen by the wrapper (G*C <= 128); it need not
// equal the model's chunk_size, since the moment fold is associative and
// the band is positional. Requires D % 4 == 0 and Dv % 4 == 0 (checked by
// the wrappers).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace causal_scan {

constexpr int kThreads = 256;
constexpr int kCols = 32;      // Dv column block
constexpr int kRT = 32;        // m2 rows per tile (= thread rows ty)
constexpr int kRows = 128;     // query rows per chunk (G * C <= kRows)

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__host__ __device__ inline int smem_floats(int C, int D) {
  int scratch = kRT * kCols + kRT * kRows + C * kRT;
  if (C * kRows > scratch) scratch = C * kRows;
  return kRows * D + C * kCols + kCols + D * kCols + D * D + scratch +
         C * (D + 1) + C + 4 + D;
}

// q [BH*G, N, D], k [BH, N, D], v [BH, N, Dv], w [BH, N] (f32).
// init_* (nullable, f32, same layout as the outputs).
// o [BH*G, N, Dv]; m0o [BH, Dv], m1o [BH, D, Dv], m2o [BH, D*D, Dv],
// g0o [BH], g1o [BH, D], g2o [BH, D, D] (f32). w_eff: band width (0: none).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
causal_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ w,
              const float* i0, const float* i1, const float* i2,
              const float* j0, const float* j1, const float* j2,
              T* __restrict__ o, float* m0o, float* m1o, float* m2o,
              float* g0o, float* g1o, float* g2o, int G, int N, int D,
              int Dv, int p, int C, int w_eff, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int GC = G * C;
  const int KS = D + 1;  // padded k row stride: conflict-free column reads
  // float4-read arrays first (every offset a multiple of 4 floats), then
  // the scalar ones
  float* sQT = smem;                   // [D, 128]   queries, transposed
  float* sV = sQT + kRows * D;         // [C, 32]
  float* sM0 = sV + C * kCols;         // [32]
  float* sM1 = sM0 + kCols;            // [D, 32]
  float* sG2 = sM1 + D * kCols;        // [D, D]
  float* scr = sG2 + D * D;            // scratch
  float* sMt = scr;                    // [RT, 32]   m2 tile
  float* sY = sMt + kRT * kCols;       // [RT, 128]  q_a q_b per query row
  float* sT = sY + kRT * kRows;        // [C, RT]    w k_a k_b per token
  float* sS = scr;                     // [C, 128]   scores, transposed
  int scratch = kRT * kCols + kRT * kRows + C * kRT;
  if (C * kRows > scratch) scratch = C * kRows;
  float* sK = scr + scratch;           // [C, KS]
  float* sW = sK + C * KS;             // [C]
  float* sG0 = sW + C;                 // [4]
  float* sG1 = sG0 + 4;                // [D]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 7, ty = tid >> 3;   // 8 column groups x 32 row groups
  const int bh = blockIdx.y;
  const int cbase = blockIdx.x * kCols;
  const int col = cbase + lane;            // per-lane column (small carries)
  const bool col_ok = col < Dv;
  const int cq = cbase + 4 * tx;           // this thread's 4 columns
  const bool cq_ok = cq < Dv;              // Dv % 4 == 0: all 4 or none
  const bool has_init = i0 != nullptr;
  const int DD = D * D;
  float* m2b = m2o + (size_t)bh * DD * Dv;

  // ---- seed the carry ----
  if (warp == 0)
    sM0[lane] = (has_init && col_ok) ? i0[(size_t)bh * Dv + col] : 0.f;
  for (int a = warp; a < D; a += kThreads / 32)
    sM1[a * kCols + lane] =
        (has_init && col_ok) ? i1[((size_t)bh * D + a) * Dv + col] : 0.f;
  if (tid == 0) sG0[0] = has_init ? j0[bh] : 0.f;
  for (int a = tid; a < D; a += kThreads)
    sG1[a] = has_init ? j1[(size_t)bh * D + a] : 0.f;
  for (int e = tid; e < DD; e += kThreads)
    sG2[e] = (has_init && p >= 2) ? j2[(size_t)bh * DD + e] : 0.f;
  if (col_ok) {
    const float* i2b = has_init ? i2 + (size_t)bh * DD * Dv : nullptr;
    for (int r = warp; r < DD; r += kThreads / 32)
      m2b[(size_t)r * Dv + col] =
          (has_init && p >= 2) ? i2b[(size_t)r * Dv + col] : 0.f;
  }
  __syncthreads();

  for (int c0 = 0; c0 < N; c0 += C) {
    const int len = min(C, N - c0);
    // ---- load the chunk (coalesced reads; queries stored transposed) ----
    for (int e = tid; e < kRows * D; e += kThreads) {
      const int r = e / D, a = e - r * D;
      const int g = r / C, i = r - g * C;
      sQT[a * kRows + r] =
          (r < GC && i < len)
              ? ld(q + (((size_t)bh * G + g) * N + c0 + i) * D + a) : 0.f;
    }
    for (int e = tid; e < C * D; e += kThreads) {
      const int t = e / D, a = e - t * D;
      sK[t * KS + a] =
          t < len ? ld(k + ((size_t)bh * N + c0 + t) * D + a) : 0.f;
    }
    for (int e = tid; e < C * kCols; e += kThreads) {
      const int t = e / kCols, c = e - t * kCols;
      const int cc = cbase + c;
      sV[e] = (t < len && cc < Dv)
                  ? ld(v + ((size_t)bh * N + c0 + t) * Dv + cc) : 0.f;
    }
    for (int t = tid; t < C; t += kThreads)
      sW[t] = t < len ? w[(size_t)bh * N + c0 + t] : 0.f;
    __syncthreads();

    // ---- inter-chunk small terms and the denominator (old carry) ----
    float acc[4][4], acc2[4][4], den[4], quad[4];
    {
      const float4 m0v = ld4(sM0 + 4 * tx);
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        acc[ri][0] = m0v.x; acc[ri][1] = m0v.y;
        acc[ri][2] = m0v.z; acc[ri][3] = m0v.w;
        den[ri] = sG0[0];
        quad[ri] = 0.f;
#pragma unroll
        for (int ci = 0; ci < 4; ++ci) acc2[ri][ci] = 0.f;
      }
    }
    for (int a = 0; a < D; ++a) {
      const float4 qv = ld4(sQT + a * kRows + 4 * ty);
      const float4 mv = ld4(sM1 + a * kCols + 4 * tx);
      const float g1a = sG1[a];
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float mc[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        den[ri] += qr[ri] * g1a;
#pragma unroll
        for (int ci = 0; ci < 4; ++ci) acc[ri][ci] += qr[ri] * mc[ci];
      }
    }
    if (p >= 2) {
      // q^T g2 q: U = Q g2 in slabs of 32 columns, then dotted with Q
      for (int s0 = 0; s0 < D; s0 += 32) {
        const int b0 = s0 + 4 * tx;
        if (b0 < D) {
          float u[4][4];
#pragma unroll
          for (int ri = 0; ri < 4; ++ri)
#pragma unroll
            for (int ci = 0; ci < 4; ++ci) u[ri][ci] = 0.f;
          for (int a = 0; a < D; ++a) {
            const float4 qv = ld4(sQT + a * kRows + 4 * ty);
            const float4 gv = ld4(sG2 + a * D + b0);
            const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
            const float gc[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
            for (int ri = 0; ri < 4; ++ri)
#pragma unroll
              for (int ci = 0; ci < 4; ++ci) u[ri][ci] += qr[ri] * gc[ci];
          }
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) {
            const float4 qb = ld4(sQT + (b0 + ci) * kRows + 4 * ty);
            quad[0] += u[0][ci] * qb.x;
            quad[1] += u[1][ci] * qb.y;
            quad[2] += u[2][ci] * qb.z;
            quad[3] += u[3][ci] * qb.w;
          }
        }
      }
      // the 8 threads of a row group (lanes differing in bits 0..2)
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        float x = quad[ri];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        den[ri] += 0.5f * x;
      }
    }

    // ---- m2: contract the old carry, then fold the chunk in, one tile
    //      of 32 rows at a time (one read + one write of the carry) ----
    if (p >= 2) {
      for (int t0 = 0; t0 < DD; t0 += kRT) {
        {
          const int rl = tid >> 3, c4 = 4 * (tid & 7);   // 32 x 8 float4
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (t0 + rl < DD && cbase + c4 < Dv)
            x = ld4(m2b + (size_t)(t0 + rl) * Dv + cbase + c4);
          *reinterpret_cast<float4*>(sMt + rl * kCols + c4) = x;
        }
        for (int e = tid; e < kRT * kRows; e += kThreads) {
          const int rl = e >> 7, r = e & (kRows - 1), ab = t0 + rl;
          const int a = ab / D, b = ab - a * D;
          sY[e] = ab < DD ? sQT[a * kRows + r] * sQT[b * kRows + r] : 0.f;
        }
        for (int e = tid; e < C * kRT; e += kThreads) {
          const int t = e / kRT, rl = e - t * kRT, ab = t0 + rl;
          const int a = ab / D, b = ab - a * D;
          sT[e] = ab < DD ? sK[t * KS + a] * sW[t] * sK[t * KS + b] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int rl = 0; rl < kRT; ++rl) {
          const float4 yv = ld4(sY + rl * kRows + 4 * ty);
          const float4 mv = ld4(sMt + rl * kCols + 4 * tx);
          const float yr[4] = {yv.x, yv.y, yv.z, yv.w};
          const float mc[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
          for (int ri = 0; ri < 4; ++ri)
#pragma unroll
            for (int ci = 0; ci < 4; ++ci) acc2[ri][ci] += yr[ri] * mc[ci];
        }
        if (t0 + ty < DD && cq_ok) {
          float4 x = ld4(sMt + ty * kCols + 4 * tx);
#pragma unroll 4
          for (int t = 0; t < len; ++t) {
            const float s = sT[t * kRT + ty];
            const float4 vv = ld4(sV + t * kCols + 4 * tx);
            x.x += s * vv.x; x.y += s * vv.y; x.z += s * vv.z; x.w += s * vv.w;
          }
          *reinterpret_cast<float4*>(m2b + (size_t)(t0 + ty) * Dv + cq) = x;
        }
        __syncthreads();
      }
    }

    // ---- intra-chunk: exact causal block (scores stored [t][row]), with
    //      the band's (exp - f) correction on the in-band pairs ----
    for (int e = tid; e < C * kRows; e += kThreads) {
      const int t = e >> 7, r = e & (kRows - 1), i = r % C;
      float s = 0.f;
      for (int a = 0; a < D; ++a) s += sQT[a * kRows + r] * sK[t * KS + a];
      float f = 1.f + s;
      if (p >= 2) f += 0.5f * s * s;
      // an in-band pair weighs exp(s) = f + (exp(s) - f) directly
      sS[e] = (r < GC && t <= i) ? (i - t < w_eff ? expf(s) : f) * sW[t]
                                 : 0.f;
    }
    __syncthreads();
    float dsum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < len; ++t) {
      const float4 sv = ld4(sS + t * kRows + 4 * ty);
      const float4 vv = ld4(sV + t * kCols + 4 * tx);
      const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
      const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        dsum[ri] += sr[ri];
#pragma unroll
        for (int ci = 0; ci < 4; ++ci) acc[ri][ci] += sr[ri] * vc[ci];
      }
    }

    // ---- fold the chunk into the small carries ----
    if (warp == 0) {
      float x = 0.f;
      for (int t = 0; t < len; ++t) x += sW[t] * sV[t * kCols + lane];
      sM0[lane] += x;
    }
    for (int a = warp; a < D; a += kThreads / 32) {
      float x = 0.f;
      for (int t = 0; t < len; ++t)
        x += sK[t * KS + a] * sW[t] * sV[t * kCols + lane];
      sM1[a * kCols + lane] += x;
    }
    if (tid == 0) {
      float x = 0.f;
      for (int t = 0; t < len; ++t) x += sW[t];
      sG0[0] += x;
    }
    for (int a = tid; a < D; a += kThreads) {
      float x = 0.f;
      for (int t = 0; t < len; ++t) x += sW[t] * sK[t * KS + a];
      sG1[a] += x;
    }
    if (p >= 2) {
      for (int e = tid; e < DD; e += kThreads) {
        const int a = e / D, b = e - a * D;
        float x = 0.f;
        for (int t = 0; t < len; ++t)
          x += sK[t * KS + a] * sW[t] * sK[t * KS + b];
        sG2[e] += x;
      }
    }

    // ---- near field before the chunk: keys c0 - w_eff + 1 .. c0 - 1 (none
    //      before token 0), C at a time, in the chunk's buffers, which the
    //      fold above has finished with ----
    for (int kb = max(0, c0 - w_eff + 1); kb < c0; kb += C) {
      const int tl = min(C, c0 - kb);
      __syncthreads();
      for (int e = tid; e < C * D; e += kThreads) {
        const int t = e / D, a = e - t * D;
        sK[t * KS + a] =
            t < tl ? ld(k + ((size_t)bh * N + kb + t) * D + a) : 0.f;
      }
      for (int e = tid; e < C * kCols; e += kThreads) {
        const int t = e / kCols, c = e - t * kCols;
        const int cc = cbase + c;
        sV[e] = (t < tl && cc < Dv)
                    ? ld(v + ((size_t)bh * N + kb + t) * Dv + cc) : 0.f;
      }
      for (int t = tid; t < C; t += kThreads)
        sW[t] = t < tl ? w[(size_t)bh * N + kb + t] : 0.f;
      __syncthreads();
      for (int e = tid; e < C * kRows; e += kThreads) {
        const int t = e >> 7, r = e & (kRows - 1), i = r % C;
        float x = 0.f;
        // distance of key kb + t from query c0 + i (always >= 1 here)
        if (r < GC && t < tl && c0 + i - (kb + t) < w_eff) {
          float s = 0.f;
          for (int a = 0; a < D; ++a) s += sQT[a * kRows + r] * sK[t * KS + a];
          float f = 1.f + s;
          if (p >= 2) f += 0.5f * s * s;
          x = (expf(s) - f) * sW[t];
        }
        sS[e] = x;
      }
      __syncthreads();
      for (int t = 0; t < tl; ++t) {
        const float4 sv = ld4(sS + t * kRows + 4 * ty);
        const float4 vv = ld4(sV + t * kCols + 4 * tx);
        const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int ri = 0; ri < 4; ++ri) {
          dsum[ri] += sr[ri];
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) acc[ri][ci] += sr[ri] * vc[ci];
        }
      }
    }

#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const int r = 4 * ty + ri;
      const int g = r / C, i = r - g * C;
      if (r < GC && i < len && cq_ok) {
        const float inv = 1.f / (den[ri] + dsum[ri] + eps);
        T* orow = o + (((size_t)bh * G + g) * N + c0 + i) * Dv + cq;
#pragma unroll
        for (int ci = 0; ci < 4; ++ci)
          st(orow + ci, (acc[ri][ci] + 0.5f * acc2[ri][ci]) * inv);
      }
    }
    __syncthreads();
  }

  // ---- emit the final small carries (m2 is already in place) ----
  if (warp == 0 && col_ok) m0o[(size_t)bh * Dv + col] = sM0[lane];
  if (col_ok)
    for (int a = warp; a < D; a += kThreads / 32)
      m1o[((size_t)bh * D + a) * Dv + col] = sM1[a * kCols + lane];
  if (blockIdx.x == 0) {
    if (tid == 0) g0o[bh] = sG0[0];
    for (int a = tid; a < D; a += kThreads) g1o[(size_t)bh * D + a] = sG1[a];
    for (int e = tid; e < DD; e += kThreads) g2o[(size_t)bh * DD + e] = sG2[e];
  }
}

// One launch of the scan; returns the CUDA error code (0 on success).
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* w,
           const void* i0, const void* i1, const void* i2, const void* j0,
           const void* j1, const void* j2, void* o, void* m0o, void* m1o,
           void* m2o, void* g0o, void* g1o, void* g2o, int bh, int G, int N,
           int D, int Dv, int p, int C, int w_eff, float eps, void* stream) {
  const size_t bytes = sizeof(float) * (size_t)smem_floats(C, D);
  cudaError_t err = cudaFuncSetAttribute(
      causal_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Dv + kCols - 1) / kCols, bh);
  causal_kernel<T><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)w,
      (const float*)i0, (const float*)i1, (const float*)i2, (const float*)j0,
      (const float*)j1, (const float*)j2, (T*)o, (float*)m0o, (float*)m1o,
      (float*)m2o, (float*)g0o, (float*)g1o, (float*)g2o, G, N, D, Dv, p, C,
      w_eff, eps);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32 q/k/v/o, 1 = bfloat16. Checks the shapes the kernel
// takes, then launches.
inline int dispatch(int dtype, const void* q, const void* k, const void* v,
                    const void* w, const void* i0, const void* i1,
                    const void* i2, const void* j0, const void* j1,
                    const void* j2, void* o, void* m0o, void* m1o, void* m2o,
                    void* g0o, void* g1o, void* g2o, int bh, int G, int N,
                    int D, int Dv, int p, int C, int w_eff, float eps,
                    void* stream) {
  if (G * C > kRows || C < 1 || D % 4 || Dv % 4 || w_eff < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, w, i0, i1, i2, j0, j1, j2, o, m0o, m1o,
                         m2o, g0o, g1o, g2o, bh, G, N, D, Dv, p, C, w_eff,
                         eps, stream);
  return launch<__nv_bfloat16>(q, k, v, w, i0, i1, i2, j0, j1, j2, o, m0o,
                               m1o, m2o, g0o, g1o, g2o, bh, G, N, D, Dv, p,
                               C, w_eff, eps, stream);
}

}  // namespace causal_scan
