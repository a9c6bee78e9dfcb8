// Noncausal (bidirectional) fastmax for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `fastmax_noncausal_pallas`
// (src/repro/kernels/fastmax_noncausal.py:113): its two pallas_calls,
// `_moment_kernel` (:160, the global moments) and `_combine_kernel` (:192,
// the queries against them), become the launches below.
//
// What it computes, per (batch, kv-head) bh with G grouped query heads, on
// pre-normalized q [N, D] per query head and k [M, D], v [M, Dv]:
//   moments over all M keys (N != M allowed: cross-attention)
//     m0 = sum v, m1 = sum k v^T, m2[a*D+b, :] = sum k_a k_b v,
//     g0 = M, g1 = sum k, g2 = sum k k^T               (m2, g2 at p = 2)
//   then for every query row
//     o = (m0 + q.m1 + 1/2 sum_ab q_a q_b m2[ab]) / (g0 + q.g1
//          + 1/2 q^T g2 q + eps).
// Both steps are products against one table of feature rows, in a fixed
// order: row 0 the constant 1 (m0, g0), rows 1..D the linear features x_a
// (m1, g1), then at p = 2 one row per pair a <= b, x_a x_b (m2 and g2 are
// symmetric, so D(D+1)/2 rows do the work of D^2; the moment launch writes
// rows a*D+b and b*D+a, the combine weights the pair by 1 and the diagonal
// by 1/2). R = 1 + D + D(D+1)/2 rows: 2145 at D = 64. Per bh each launch is
// a product of two matrices:
//   moments  C[R, Dv]   = phi(k)^T [R, M] . v [M, Dv]  (over the keys)
//   combine  O[G N, Dv] = (w phi(q)) [G N, R] . C [R, Dv]  (over the rows)
//
// What bounds it on an H100:
//   * the moments and the combine at N = 1500 (encoder self-attention): the
//     operations, 2 M R Dv per bh for each, 2e10 per launch at B = 4 and 12
//     heads. Both run on the tensor cores (`mma.sync` m16n8k8 with TF32
//     operands, 495 TFLOP/s dense on the data sheet; wgmma and TMA are later
//     work), in two or three passes of the split below: 4e10 or 6e10 tensor
//     operations, 0.08-0.12 ms at that rate. This version does not reach it:
//     the scalar work around the products (building and splitting the
//     features, rewriting B in fragment order) and the shared-memory reads
//     of B hold it back (PERF.md);
//   * the combine at N = 1 (decode's cross-attention): the bytes of the
//     moments, R * Dv * 4 bytes per bh (0.55 MB at D = Dv = 64), read once.
//
// The split (mma_tf32.cuh). TF32 keeps 11 significant bits, too few for the
// port's 1e-4 limits, so each float32 operand x is split into TF32
// hi = tf32(x) and lo = tf32(x - hi), and each k8 step runs the passes
// lo.hi, hi.lo and hi.hi, accumulated in float32 (3xTF32: the dropped lo.lo
// is 2^-22 of the product). On bfloat16 keys and values the moments take two
// passes, and every product is exact: a bf16 value is exact in TF32 (v's lo
// is 0) and a pair feature k_a k_b of two bf16 values has at most 16
// significant bits, so its hi + lo is exact. The combine always takes three
// (the moments are float32). The tensor cores do not round each addition to
// nearest, so each stage of 32 keys or moment rows is summed in fresh
// accumulators and then added to the running sum in float32 on the CUDA
// cores. The g column is summed on the CUDA cores in float32. So are the
// denominators, a stage at a time, the stages' partials added in float64:
// with few keys a row's denominator cancels from terms a hundred times
// larger, where a float32 running sum would err more than the plain
// version (and the p = 1 denominators are sign-indefinite).
//
// Design. The TPU kernel keeps an m-block of the moments resident in VMEM
// and walks the key chunks on a sequential grid axis; here m2 (1 MB per bh
// at D = Dv = 64, 8 MB at 128) cannot sit in one SM's 227 KB, and blocks
// run in parallel with nothing carried between them. So:
//   * moments (`moments_kernel`): one block of 8 warps per (128 feature rows
//     x 64 value columns, bh), two blocks an SM; warp w owns rows
//     16w..16w+15 and all 64 columns (eight m16n8 tiles; columns past Dv are
//     zeros and go through the products, so the unrolled loop has no
//     branch). Stages of 32 keys of k and v come in by cp.async into a
//     double buffer (the next stage loads while this one is multiplied; the
//     ragged edge of M is zero-filled, with no padded copy). Each stage is
//     widened to float32, k with a column of ones and one of zeros beside
//     it so that every feature row (the constant, a linear or a pair row,
//     or one past R) is x[ia] x[ib], and v is rewritten in B fragment order
//     (split on float32) once for the block's 8 warps. Each lane builds its
//     A fragments' features in registers from its two rows' factor columns
//     and runs four k8 steps; the same features are summed into the g
//     column, written by the first column block. Both halves of a pair row
//     are written.
//   * combine, many query rows (`combine_rows_kernel`, G*N > split): one block
//     of 4 warps per (64 query rows, bh); warp w owns 16 query rows. It walks
//     the moment rows in stages of 32 from L2 (every block of a bh reads the
//     same ones) by cp.async into a double buffer, split into B fragment
//     order once for the block; each lane builds its queries' weighted
//     features (row_weight x feature) in registers, and sums them against
//     the g column for the denominator, in a fixed order (each lane over
//     the rows in order, then the four lanes of a quad). With Dv > 64 it
//     loops over the column blocks and divides by the first one's
//     denominators.
//   * combine, few query rows (`combine_split_kernel` + `combine_sum_kernel`,
//     G*N <= split, every decode step's cross-attention; CUDA cores): one
//     block per head would read its moments on only B*Hkv of 132 SMs, so the
//     moment rows are split across blocks (float4 loads, coalesced across
//     the warp); each block writes partial numerators and denominators, and
//     the second launch sums them in a FIXED order (split 0, 1, ...) and
//     divides. `split` (at most kMaxQ = 16, the largest query tile) and
//     the split combine's `rows` per block are the caller's launch knobs.
// No float atomics: greedy tokens must not change from run to run. All
// launches use the caller's stream; each C entry returns cudaGetLastError()
// after its launches. Requires D % 4 == 0, Dv % 4 == 0, 4 <= D <= 255 and
// Dv <= 1024 (checked by the wrapper and here), and k, v, the moments and o
// aligned to 16 bytes (float32) or 8 (bfloat16), as any contiguous tensor
// of those widths is (checked here).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

#include "feature_table.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kMaxQ = 16;    // query rows per bh of the split combine
constexpr int kNT = kCols / 8;                      // n8 tiles of 64 columns
constexpr int kBS = kCols + 8;                      // staged row stride
// moments: 8 warps x 16 feature rows, stages of kKeys keys
constexpr int kMomRows = 16 * (kThreads / 32);
constexpr int kKeys = 32;
constexpr int kFrags = (kKeys / 8) * kNT * 32;      // B fragments a stage
// combine: 4 warps x 16 query rows, stages of kRowStage moment rows
constexpr int kCombThreads = 128;
constexpr int kQRows = 16 * (kCombThreads / 32);
constexpr int kRowStage = 32;
constexpr int kFragsC = (kRowStage / 8) * kNT * 32;

// Row `c` of the moments of bh: its m row (Dv floats) and its g entry.
__device__ __forceinline__ const float* m_row(int c, const float* m0,
                                              const float* m1,
                                              const float* m2, int bh, int D,
                                              int Dv) {
  const int a = code_a(c), b = code_b(c);
  if (a < 0) return m0 + (size_t)bh * Dv;
  if (b < 0) return m1 + ((size_t)bh * D + a) * Dv;
  return m2 + ((size_t)bh * D * D + a * D + b) * Dv;
}
__device__ __forceinline__ const float& g_val(int c, const float* g0,
                                              const float* g1,
                                              const float* g2, int bh,
                                              int D) {
  const int a = code_a(c), b = code_b(c);
  if (a < 0) return g0[bh];
  if (b < 0) return g1[(size_t)bh * D + a];
  return g2[(size_t)bh * D * D + a * D + b];
}

// The factor columns of row `c` in a vector x padded with x[D] = 1 and
// x[D + 1] = 0: the row's feature is x[ia] x[ib] (0 past the last row).
__device__ __forceinline__ void factor_cols(int c, int D, int& ia, int& ib) {
  if (c < 0) {
    ia = ib = D + 1;
    return;
  }
  const int a = code_a(c), b = code_b(c);
  ia = a < 0 ? D : a;
  ib = b < 0 ? D : b;
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// acc += part, then part = 0: a stage's sum folded in float32.
__device__ __forceinline__ void fold(float (&acc)[kNT][4],
                                     float (&part)[kNT][4]) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[j][i] += part[j][i];
      part[j][i] = 0.f;
    }
}

// The sum over the four lanes of a quad (lanes 4g..4g+3), the same bits on
// each.
template <typename F>
__device__ __forceinline__ F quad_sum(F x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// Moments. k [BH, M, D], v [BH, M, Dv]; m0 [BH, Dv], m1 [BH, D, Dv],
// m2 [BH, D*D, Dv], g0 [BH], g1 [BH, D], g2 [BH, D, D] (f32).
// grid (row tiles of 128 * column blocks, BH), kThreads threads.
// Shared memory: the stage's v in B fragment order, its k widened to f32
// [kKeys, D + 8], then the raw double buffers of k [kKeys, D] and v
// [kKeys, kBS].
// ---------------------------------------------------------------------------
template <typename T>
__host__ __device__ inline size_t moments_smem_bytes(int D) {
  const size_t frag = sizeof(T) == 2 ? sizeof(float2) : sizeof(float4);
  return frag * kFrags + sizeof(float) * kKeys * (D + 8) +
         sizeof(T) * 2 * kKeys * (D + kBS);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
moments_kernel(const T* __restrict__ k, const T* __restrict__ v,
               float* __restrict__ m0, float* __restrict__ m1,
               float* __restrict__ m2, float* __restrict__ g0,
               float* __restrict__ g1, float* __restrict__ g2, int M, int D,
               int Dv, int p) {
  constexpr bool exact = sizeof(T) == 2;   // bf16: v is exact in TF32
  extern __shared__ __align__(16) unsigned char sbytes[];
  float4* sB4 = reinterpret_cast<float4*>(sbytes);   // v hi/lo (f32)
  float2* sB2 = reinterpret_cast<float2*>(sbytes);   // v (bf16)
  float* sK = reinterpret_cast<float*>(
      sbytes + (exact ? sizeof(float2) : sizeof(float4)) * kFrags);
  const int KS = D + 8;  // padded: conflict-free feature reads
  T* rawK = reinterpret_cast<T*>(sK + kKeys * KS);   // [2][kKeys, D]
  T* rawV = rawK + 2 * kKeys * D;                     // [2][kKeys, kBS]
  const int R = n_rows(D, p);
  const int ncb = (Dv + kCols - 1) / kCols;
  const int tile = blockIdx.x / ncb, cb = blockIdx.x - tile * ncb;
  const int c0 = cb * kCols, ncols = min(kCols, Dv - c0);
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int wr = tile * kMomRows + (tid >> 5) * 16;  // the warp's first row
  const bool active = wr < R;
  const int code0 = row_code(wr + gq, D, R);       // row of a0, a2, c0, c1
  const int code1 = row_code(wr + gq + 8, D, R);   // row of a1, a3, c2, c3
  int ia0, ib0, ia1, ib1;
  factor_cols(code0, D, ia0, ib0);
  factor_cols(code1, D, ia1, ib1);
  const T* kb = k + (size_t)bh * M * D;
  const T* vb = v + (size_t)bh * M * Dv;
  const int nst = (M + kKeys - 1) / kKeys;

  // stage s into buffer s & 1; missing keys and columns are zero-filled
  auto issue = [&](int s) {
    const int t0 = s * kKeys, len = min(kKeys, M - t0);
    T* dk = rawK + (s & 1) * kKeys * D;
    for (int e = 4 * tid; e < kKeys * D; e += 4 * kThreads) {
      const bool ok = e < len * D;
      cp_async4(dk + e, ok ? kb + (size_t)t0 * D + e : kb, ok);
    }
    T* dv = rawV + (s & 1) * kKeys * kBS;
    for (int e = tid; e < kKeys * (kCols / 4); e += kThreads) {
      const int t = e / (kCols / 4), c = 4 * (e - t * (kCols / 4));
      const bool ok = t < len && c < ncols;
      cp_async4(dv + t * kBS + c,
                ok ? vb + (size_t)(t0 + t) * Dv + c0 + c : vb, ok);
    }
    cp_async_commit();
  };

  float acc[kNT][4], part[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = part[j][i] = 0.f;
  float gp0 = 0.f, gp1 = 0.f;   // g partials of rows code0, code1
  issue(0);
  for (int s = 0; s < nst; ++s) {
    cp_async_wait_all();
    __syncthreads();   // stage s landed; stage s - 1's products are done
    if (s + 1 < nst) issue(s + 1);
    const int len = min(kKeys, M - s * kKeys);
    const T* rk = rawK + (s & 1) * kKeys * D;
    for (int e = 4 * tid; e < kKeys * D; e += 4 * kThreads) {
      const int t = e / D;
      *reinterpret_cast<float4*>(sK + t * KS + (e - t * D)) = lds4(rk + e);
    }
    if (tid < kKeys) {
      sK[tid * KS + D] = tid < len ? 1.f : 0.f;
      sK[tid * KS + D + 1] = 0.f;
    }
    const T* rv = rawV + (s & 1) * kKeys * kBS;
    if (exact)
      b_fragments_exact<kNT>(sB2, rv, kBS, kKeys / 8, tid, kThreads);
    else
      b_fragments_split<kNT>(sB4, rv, kBS, kKeys / 8, tid, kThreads);
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int kk = 0; kk < kKeys / 8; ++kk) {
      const float* x0 = sK + (8 * kk + tq) * KS;   // key of a0, a1
      const float* x1 = x0 + 4 * KS;                // key of a2, a3
      const float f[4] = {x0[ia0] * x0[ib0], x0[ia1] * x0[ib1],
                          x1[ia0] * x1[ib0], x1[ia1] * x1[ib1]};
      gp0 += f[0];
      gp0 += f[2];
      gp1 += f[1];
      gp1 += f[3];
      uint32_t ah[4], al[4];
      split_a<sizeof(T) == 2>(f, ah, al);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int fi = (kk * kNT + j) * 32 + lane;
        if (exact) {
          const float2 b = sB2[fi];
          mma_tf32(part[j], al, __float_as_uint(b.x), __float_as_uint(b.y));
          mma_tf32(part[j], ah, __float_as_uint(b.x), __float_as_uint(b.y));
        } else {
          const float4 b = sB4[fi];
          mma_tf32(part[j], ah, __float_as_uint(b.z), __float_as_uint(b.w));
          mma_tf32(part[j], al, __float_as_uint(b.x), __float_as_uint(b.y));
          mma_tf32(part[j], ah, __float_as_uint(b.x), __float_as_uint(b.y));
        }
      }
    }
    fold(acc, part);
  }
  if (!active) return;

  // the tile: m rows (both halves of a pair), then the g column
  gp0 = quad_sum(gp0);
  gp1 = quad_sum(gp1);
  const State out{m0, m1, m2, g0, g1, g2};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = h ? code1 : code0;
    if (c < 0) continue;
    size_t mo, go;
    long mt, gt;
    state_offsets(c, bh, D, Dv, &mo, &go, &mt, &gt);
    float* mb = out.m(c) + c0;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col >= ncols) continue;
      st2(mb + mo + col, acc[j][2 * h], acc[j][2 * h + 1]);
      if (mt >= 0) st2(mb + mt + col, acc[j][2 * h], acc[j][2 * h + 1]);
    }
    if (cb == 0 && tq == 0) {
      const float gs = h ? gp1 : gp0;
      out.g(c)[go] = gs;
      if (gt >= 0) out.g(c)[gt] = gs;
    }
  }
}

// ---------------------------------------------------------------------------
// Combine, many query rows. q [BH*G, N, D]; o [BH*G, N, Dv].
// grid (ceil(G*N / kQRows), BH), kCombThreads threads. Shared memory: the
// stage's moment rows in B fragment order, the raw double buffer
// [kRowStage, kBS], its rows' records (factor columns ia | ib << 16, g),
// then the queries [kQRows, D + 4].
// ---------------------------------------------------------------------------
__host__ __device__ inline size_t rows_smem_bytes(int D) {
  return sizeof(float4) * kFragsC + sizeof(int2) * 2 * kRowStage +
         sizeof(float) * (2 * kRowStage * kBS + kQRows * (D + 4));
}

template <typename T>
__global__ void __launch_bounds__(kCombThreads)
combine_rows_kernel(const T* __restrict__ q, const float* __restrict__ m0,
                    const float* __restrict__ m1,
                    const float* __restrict__ m2,
                    const float* __restrict__ g0,
                    const float* __restrict__ g1,
                    const float* __restrict__ g2, T* __restrict__ o, int G,
                    int N, int D, int Dv, int p, float eps) {
  extern __shared__ __align__(16) unsigned char sbytes[];
  float4* sB = reinterpret_cast<float4*>(sbytes);            // hi/lo
  float* sRaw = reinterpret_cast<float*>(sB + kFragsC);  // [2][stage, kBS]
  int2* sRec = reinterpret_cast<int2*>(sRaw + 2 * kRowStage * kBS);
  float* sQ = reinterpret_cast<float*>(sRec + 2 * kRowStage);  // [, D + 4]
  const int QS = D + 4;
  const int R = n_rows(D, p);
  const int GN = G * N;
  const int bh = blockIdx.y;
  const int qr0 = blockIdx.x * kQRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const bool active = qr0 + 16 * warp < GN;

  const T* qb = q + (size_t)bh * GN * D;
  for (int e = tid; e < kQRows * D; e += kCombThreads) {
    const int r = e / D, a = e - r * D;
    sQ[r * QS + a] = qr0 + r < GN ? ld(qb + (size_t)(qr0 + r) * D + a) : 0.f;
  }
  if (tid < kQRows) {
    sQ[tid * QS + D] = 1.f;
    sQ[tid * QS + D + 1] = 0.f;
  }
  const float* q0 = sQ + (16 * warp + gq) * QS;   // query of a0, a2
  const float* q1 = q0 + 8 * QS;                  // query of a1, a3
  const int nst = (R + kRowStage - 1) / kRowStage;
  const int ncb = (Dv + kCols - 1) / kCols;
  double den0 = 0.0, den1 = 0.0;   // denominators of rows gq, gq + 8
  float dn0 = 1.f, dn1 = 1.f;

  for (int cb = 0; cb < ncb; ++cb) {
    const int c0 = cb * kCols, ncols = min(kCols, Dv - c0);
    // stage s into buffer s & 1: four threads load a row; the first of them
    // finds its code, writes the record (factor columns) and loads its g
    auto issue = [&](int s) {
      for (int i = tid >> 2; i < kRowStage; i += kCombThreads / 4) {
        const int slot = (s & 1) * kRowStage + i;
        int c = (tid & 3) == 0 ? row_code(s * kRowStage + i, D, R) : 0;
        c = __shfl_sync(0xffffffffu, c, lane & ~3);
        const float* src =
            c >= 0 ? m_row(c, m0, m1, m2, bh, D, Dv) + c0 : m0;
        float* dst = sRaw + slot * kBS;
        for (int u = 4 * (tid & 3); u < kCols; u += 16) {
          const bool ok = c >= 0 && u < ncols;
          cp_async4(dst + u, ok ? src + u : m0, ok);
        }
        if ((tid & 3) == 0) {
          int ia, ib;
          factor_cols(c, D, ia, ib);
          sRec[slot].x = ia | ib << 16;
          if (c >= 0)
            cp_async1(reinterpret_cast<float*>(&sRec[slot].y),
                      &g_val(c, g0, g1, g2, bh, D));
          else
            sRec[slot].y = 0;
        }
      }
      cp_async_commit();
    };

    float acc[kNT][4], part[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = part[j][i] = 0.f;
    __syncthreads();   // the queries are in; the last block's stages used
    issue(0);
    for (int s = 0; s < nst; ++s) {
      cp_async_wait_all();
      __syncthreads();   // stage s landed; stage s - 1's products are done
      if (s + 1 < nst) issue(s + 1);
      b_fragments_split<kNT>(sB, sRaw + (s & 1) * kRowStage * kBS, kBS,
                             kRowStage / 8, tid, kCombThreads);
      __syncthreads();
      if (!active) continue;
      const int2* rec = sRec + (s & 1) * kRowStage;
      float dp0 = 0.f, dp1 = 0.f;   // this stage's denominator partials
#pragma unroll
      for (int kk = 0; kk < kRowStage / 8; ++kk) {
        const int2 ra = rec[8 * kk + tq], rb = rec[8 * kk + tq + 4];
        const int aa = ra.x & 0xffff, ba = ra.x >> 16;
        const int ab = rb.x & 0xffff, bb = rb.x >> 16;
        // row_weight: 1/2 on the diagonal pairs (aa == ba < D)
        const float wa = aa == ba && aa < D ? 0.5f : 1.f;
        const float wb = ab == bb && ab < D ? 0.5f : 1.f;
        const float f[4] = {wa * (q0[aa] * q0[ba]), wa * (q1[aa] * q1[ba]),
                            wb * (q0[ab] * q0[bb]), wb * (q1[ab] * q1[bb])};
        const float ga = __int_as_float(ra.y), gb = __int_as_float(rb.y);
        dp0 += f[0] * ga;
        dp0 += f[2] * gb;
        dp1 += f[1] * ga;
        dp1 += f[3] * gb;
        uint32_t ah[4], al[4];
        split_a<sizeof(T) == 2>(f, ah, al);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float4 b = sB[(kk * kNT + j) * 32 + lane];
          mma_tf32(part[j], ah, __float_as_uint(b.z), __float_as_uint(b.w));
          mma_tf32(part[j], al, __float_as_uint(b.x), __float_as_uint(b.y));
          mma_tf32(part[j], ah, __float_as_uint(b.x), __float_as_uint(b.y));
        }
      }
      fold(acc, part);
      den0 += dp0;
      den1 += dp1;
    }
    if (cb == 0) {
      dn0 = (float)(quad_sum(den0) + eps);
      dn1 = (float)(quad_sum(den1) + eps);
    }
    if (!active) continue;
    const int qa = qr0 + 16 * warp + gq, qc = qa + 8;
    T* oa = o + ((size_t)bh * GN + qa) * Dv + c0;
    T* oc = oa + (size_t)8 * Dv;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col >= ncols) continue;
      if (qa < GN) st2(oa + col, acc[j][0] / dn0, acc[j][1] / dn0);
      if (qc < GN) st2(oc + col, acc[j][2] / dn1, acc[j][3] / dn1);
    }
  }
}

// ---------------------------------------------------------------------------
// Combine, few query rows (G*N <= split <= kMaxQ). Launch 1: grid (nsplit, BH), each
// block owns `rows` consecutive feature rows and all Dv columns; a thread
// owns 4 columns of every rpar-th row. part [BH, nsplit, QT, Dv + 1]: the
// partial numerators, then the partial denominator.
// ---------------------------------------------------------------------------
template <typename T, int QT>
__global__ void __launch_bounds__(kThreads)
combine_split_kernel(const T* __restrict__ q, const float* __restrict__ m0,
                     const float* __restrict__ m1,
                     const float* __restrict__ m2,
                     const float* __restrict__ g0,
                     const float* __restrict__ g1,
                     const float* __restrict__ g2, float* __restrict__ part,
                     int G, int N, int D, int Dv, int p, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int tpr = Dv / 4;                 // threads per row
  const int rpar = kThreads / tpr;        // rows in flight
  float* sRed = smem;                     // [rpar, QT, Dv]
  float* sDr = sRed + rpar * QT * Dv;     // [rpar, QT]
  float* sQ = sDr + rpar * QT;            // [QT, D]
  const int R = n_rows(D, p);
  const int GN = G * N;
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  for (int e = tid; e < QT * D; e += kThreads) {
    const int r = e / D, a = e - r * D;
    float x = 0.f;
    if (r < GN) {
      const int g = r / N, n = r - g * N;
      x = ld(q + (((size_t)bh * G + g) * N + n) * D + a);
    }
    sQ[e] = x;
  }
  __syncthreads();

  const int c4 = 4 * (tid % tpr);
  const int lane_row = tid / tpr;
  float acc[QT][4], dacc[QT];
#pragma unroll
  for (int g = 0; g < QT; ++g) {
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
    dacc[g] = 0.f;
  }
  if (lane_row < rpar) {
    const int r1 = min((split + 1) * rows, R);
    for (int r = split * rows + lane_row; r < r1; r += rpar) {
      const int c = row_code(r, D, R);
      const float4 m = ld4(m_row(c, m0, m1, m2, bh, D, Dv) + c4);
      const float w = row_weight(c);
      const float gv = c4 == 0 ? g_val(c, g0, g1, g2, bh, D) : 0.f;
#pragma unroll
      for (int g = 0; g < QT; ++g) {
        const float f = w * feature(c, sQ + g * D);
        acc[g][0] += f * m.x; acc[g][1] += f * m.y;
        acc[g][2] += f * m.z; acc[g][3] += f * m.w;
        dacc[g] += f * gv;
      }
    }
#pragma unroll
    for (int g = 0; g < QT; ++g) {
      *reinterpret_cast<float4*>(sRed + ((size_t)lane_row * QT + g) * Dv +
                                 c4) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      if (c4 == 0) sDr[lane_row * QT + g] = dacc[g];
    }
  }
  __syncthreads();
  float* pb = part + ((size_t)bh * nsplit + split) * QT * (Dv + 1);
  for (int e = tid; e < QT * (Dv + 1); e += kThreads) {
    const int g = e / (Dv + 1), j = e - g * (Dv + 1);
    float s = 0.f;
    if (j < Dv)
      for (int l = 0; l < rpar; ++l) s += sRed[((size_t)l * QT + g) * Dv + j];
    else
      for (int l = 0; l < rpar; ++l) s += sDr[l * QT + g];
    pb[e] = s;
  }
}

// Launch 2: grid (BH); sums the partials in split order and divides.
template <typename T, int QT>
__global__ void combine_sum_kernel(const float* __restrict__ part,
                                   T* __restrict__ o, int G, int N, int Dv,
                                   int nsplit, float eps) {
  const int bh = blockIdx.x;
  const int GN = G * N;
  const float* pb = part + (size_t)bh * nsplit * QT * (Dv + 1);
  for (int e = threadIdx.x; e < GN * Dv; e += blockDim.x) {
    const int r = e / Dv, j = e - r * Dv;
    float num = 0.f, den = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float* ps = pb + ((size_t)s * QT + r) * (Dv + 1);
      num += ps[j];
      den += ps[Dv];
    }
    const int g = r / N, n = r - g * N;
    st(o + (((size_t)bh * G + g) * N + n) * Dv + j, num / (den + eps));
  }
}

template <typename T>
int launch_moments(const void* k, const void* v, void* m0, void* m1,
                   void* m2, void* g0, void* g1, void* g2, int bh, int M,
                   int D, int Dv, int p, cudaStream_t s) {
  const int R = n_rows(D, p);
  const dim3 grid(((R + kMomRows - 1) / kMomRows) * ((Dv + kCols - 1) / kCols),
                  bh);
  const size_t sm = moments_smem_bytes<T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      moments_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm);
  if (err != cudaSuccess) return (int)err;
  moments_kernel<T><<<grid, kThreads, sm, s>>>(
      (const T*)k, (const T*)v, (float*)m0, (float*)m1, (float*)m2,
      (float*)g0, (float*)g1, (float*)g2, M, D, Dv, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const void* q, const void* const* mom, void* o, int bh,
                int G, int N, int D, int Dv, int p, float eps,
                cudaStream_t s) {
  const size_t sm = rows_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      combine_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((G * N + kQRows - 1) / kQRows, bh);
  combine_rows_kernel<T><<<grid, kCombThreads, sm, s>>>(
      (const T*)q, (const float*)mom[0], (const float*)mom[1],
      (const float*)mom[2], (const float*)mom[3], (const float*)mom[4],
      (const float*)mom[5], (T*)o, G, N, D, Dv, p, eps);
  return (int)cudaGetLastError();
}

template <typename T, int QT>
int launch_split_qt(const void* q, const void* const* mom, void* part,
                    void* o, int bh, int G, int N, int D, int Dv, int p,
                    int rows, float eps, cudaStream_t s) {
  const int R = n_rows(D, p);
  const int nsplit = (R + rows - 1) / rows;
  const int rpar = kThreads / (Dv / 4);
  const size_t sm = sizeof(float) * ((size_t)rpar * QT * Dv + rpar * QT +
                                     QT * D);
  cudaError_t err = cudaFuncSetAttribute(
      combine_split_kernel<T, QT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  if (err != cudaSuccess) return (int)err;
  combine_split_kernel<T, QT><<<dim3(nsplit, bh), kThreads, sm, s>>>(
      (const T*)q, (const float*)mom[0], (const float*)mom[1],
      (const float*)mom[2], (const float*)mom[3], (const float*)mom[4],
      (const float*)mom[5], (float*)part, G, N, D, Dv, p, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_sum_kernel<T, QT><<<bh, 128, 0, s>>>((const float*)part, (T*)o, G,
                                               N, Dv, nsplit, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_split(int qt, const void* q, const void* const* mom, void* part,
                 void* o, int bh, int G, int N, int D, int Dv, int p,
                 int rows, float eps, cudaStream_t s) {
  switch (qt) {
    case 1: return launch_split_qt<T, 1>(q, mom, part, o, bh, G, N, D, Dv, p, rows, eps, s);
    case 2: return launch_split_qt<T, 2>(q, mom, part, o, bh, G, N, D, Dv, p, rows, eps, s);
    case 4: return launch_split_qt<T, 4>(q, mom, part, o, bh, G, N, D, Dv, p, rows, eps, s);
    case 8: return launch_split_qt<T, 8>(q, mom, part, o, bh, G, N, D, Dv, p, rows, eps, s);
    case 16: return launch_split_qt<T, 16>(q, mom, part, o, bh, G, N, D, Dv, p, rows, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool dims_ok(int D, int Dv, int p) {
  return D >= 4 && D % 4 == 0 && D <= 255 && Dv >= 4 && Dv % 4 == 0 &&
         Dv <= 1024 && (p == 1 || p == 2);
}

// Every pointer aligned to `bytes` (four elements of the launch's type).
bool aligned(int bytes, std::initializer_list<const void*> ptrs) {
  for (const void* x : ptrs)
    if (reinterpret_cast<uintptr_t>(x) % bytes) return false;
  return true;
}

}  // namespace

extern "C" {

// Number of feature rows R (the split combine's `rows` cut them).
int fastmax_noncausal_rows(int D, int p) { return n_rows(D, p); }

// dtype: 0 = float32 k/v, 1 = bfloat16. Moments are f32, written whole
// (m2 and g2 only at p = 2).
int fastmax_noncausal_moments(int dtype, const void* k, const void* v,
                              void* m0, void* m1, void* m2, void* g0,
                              void* g1, void* g2, int bh, int M, int D,
                              int Dv, int p, void* stream) {
  if (!dims_ok(D, Dv, p) || M < 1) return (int)cudaErrorInvalidValue;
  if (!aligned(dtype == 0 ? 16 : 8, {k, v}) ||
      !aligned(16, {m0, m1, m2, g0, g1, g2}))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_moments<float>(k, v, m0, m1, m2, g0, g1, g2, bh, M, D, Dv,
                                 p, s);
  return launch_moments<__nv_bfloat16>(k, v, m0, m1, m2, g0, g1, g2, bh, M,
                                       D, Dv, p, s);
}

// dtype: 0 = float32 q/o, 1 = bfloat16. mom: the six f32 moment pointers
// (m0, m1, m2, g0, g1, g2). With G*N <= split (the caller's, 0..kMaxQ) the
// split path runs and needs `part`, f32 [bh, ceil(R / rows), QT, Dv + 1]
// with QT the power of two >= G*N; otherwise `part` and `rows` are unused.
int fastmax_noncausal_combine(int dtype, const void* q, void* m0, void* m1,
                              void* m2, void* g0, void* g1, void* g2,
                              void* part, void* o, int bh, int G, int N,
                              int D, int Dv, int p, int rows, int split,
                              float eps, void* stream) {
  if (!dims_ok(D, Dv, p) || G < 1 || N < 1 || split < 0 || split > kMaxQ)
    return (int)cudaErrorInvalidValue;
  if (!aligned(16, {m0, m1, m2, g0, g1, g2}) ||
      !aligned(dtype == 0 ? 8 : 4, {o}))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* mom[6] = {m0, m1, m2, g0, g1, g2};
  const int gn = G * N;
  if (gn <= split) {
    if (rows < 1 || Dv / 4 > kThreads) return (int)cudaErrorInvalidValue;
    int qt = 1;
    while (qt < gn) qt *= 2;
    if (dtype == 0)
      return launch_split<float>(qt, q, mom, part, o, bh, G, N, D, Dv, p,
                                 rows, eps, s);
    return launch_split<__nv_bfloat16>(qt, q, mom, part, o, bh, G, N, D, Dv,
                                       p, rows, eps, s);
  }
  if (dtype == 0)
    return launch_rows<float>(q, mom, o, bh, G, N, D, Dv, p, eps, s);
  return launch_rows<__nv_bfloat16>(q, mom, o, bh, G, N, D, Dv, p, eps, s);
}

}  // extern "C"
