// Noncausal (bidirectional) fastmax for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `fastmax_noncausal_pallas`
// (src/repro/kernels/fastmax_noncausal.py): its two pallas_calls,
// `_moment_kernel` (the global moments) and `_combine_kernel` (the queries
// against them), become the launches below.
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
// by 1/2). R = 1 + D + D(D+1)/2 rows: 2145 at D = 64.
//
// What bounds it on an H100:
//   * the moments and the combine at N = 1500 (encoder self-attention): the
//     operations, 2 * M * R * Dv per bh for each, ~2e10 per launch at B = 4
//     and 12 heads; this version runs them as float32 FMAs on the CUDA
//     cores (tensor cores, wgmma and TMA are later work);
//   * the combine at N = 1 (cross-attention in each decode step): the bytes
//     of the moments, R * Dv * 4 bytes per bh (0.55 MB at D = Dv = 64),
//     read once.
//
// Design. The TPU kernel keeps an m-block of the moments resident in VMEM
// and walks the key chunks on a sequential grid axis; here m2 (1 MB per bh
// at D = Dv = 64, 8 MB at 128) cannot sit in one SM's 227 KB, and blocks
// run in parallel with nothing carried between them. So:
//   * moments (`moments_kernel`): one block per (64 feature rows x 64 value
//     columns tile, bh). It streams all M keys through shared memory in
//     chunks of 32 and keeps its tile in registers (thread (ty, tx) owns
//     rows 4ty..4ty+3 and columns 4tx..4tx+3, float4 reads: 16 FMAs per two
//     shared-memory loads), then writes the tile once: no reduction across
//     blocks. The g column (the weights' sum) rides along in the feature
//     build, written by the first column block. The ragged edge of M is
//     masked in the kernel (the features of a missing key are 0), with no
//     padded copy.
//   * combine, many query rows (`combine_rows_kernel`, G*N > 16): one block
//     per (64 query rows, bh). It walks the moment rows in tiles of 32 from
//     L2 (every block of a bh reads the same ones), builds the queries'
//     features for those rows in shared memory and accumulates the 64 x 64
//     output tile in registers; with Dv > 64 it loops over the column
//     blocks, and the denominator is summed once per row, in the first.
//   * combine, few query rows (`combine_split_kernel` + `combine_sum_kernel`,
//     G*N <= 16, every decode step's cross-attention): one block per head
//     would read its moments on only B*Hkv of 132 SMs, so the moment rows
//     are split across blocks (float4 loads, coalesced across the warp);
//     each block writes partial numerators and denominators, and the second
//     launch sums them in a FIXED order (split 0, 1, ...) and divides. No
//     float atomics: greedy tokens must not change from run to run.
// All launches use the caller's stream; each C entry returns
// cudaGetLastError() after its launches. Requires D % 4 == 0, Dv % 4 == 0,
// D <= 255 (checked by the wrapper and here).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;    // feature rows (moments) / query rows (combine)
constexpr int kCols = 64;    // value columns per tile
constexpr int kChunk = 32;   // keys (moments) / feature rows (combine) a step
constexpr int kPS = 72;      // padded row stride of the combine's features
constexpr int kMaxQ = 16;    // query rows per bh of the split combine

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

__host__ __device__ inline int n_rows(int D, int p) {
  return 1 + D + (p >= 2 ? D * (D + 1) / 2 : 0);
}

// Feature row r as a code: (ia + 1) | (ib + 1) << 8, ia = -1 for the
// constant row, ib = -1 for a linear row; -1 past the last row.
__device__ inline int row_code(int r, int D, int R) {
  if (r >= R) return -1;
  if (r == 0) return 0;
  if (r <= D) return r;
  const int idx = r - 1 - D;
  // pairs a <= b in row-major order: row a starts at a*D - a(a-1)/2
  const float t = (float)(2 * D + 1);
  int a = (int)((t - sqrtf(t * t - 8.f * (float)idx)) * 0.5f);
  a = max(0, min(a, D - 1));
  while (a > 0 && a * D - a * (a - 1) / 2 > idx) --a;
  while (a + 1 < D && (a + 1) * D - (a + 1) * a / 2 <= idx) ++a;
  const int b = a + idx - (a * D - a * (a - 1) / 2);
  return (a + 1) | ((b + 1) << 8);
}

__device__ __forceinline__ int code_a(int c) { return (c & 255) - 1; }
__device__ __forceinline__ int code_b(int c) { return (c >> 8) - 1; }

// The feature of row `c` for the vector x (in shared memory).
__device__ __forceinline__ float feature(int c, const float* x) {
  const int a = code_a(c), b = code_b(c);
  float f = a < 0 ? 1.f : x[a];
  if (b >= 0) f *= x[b];
  return f;
}

// The combine's weight of row `c`: 1/2 on the diagonal pairs (a == b).
__device__ __forceinline__ float row_weight(int c) {
  const int b = code_b(c);
  return (b >= 0 && b == code_a(c)) ? 0.5f : 1.f;
}

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
__device__ __forceinline__ float g_val(int c, const float* g0,
                                       const float* g1, const float* g2,
                                       int bh, int D) {
  const int a = code_a(c), b = code_b(c);
  if (a < 0) return g0[bh];
  if (b < 0) return g1[(size_t)bh * D + a];
  return g2[(size_t)bh * D * D + a * D + b];
}

// ---------------------------------------------------------------------------
// Moments. k [BH, M, D], v [BH, M, Dv]; m0 [BH, Dv], m1 [BH, D, Dv],
// m2 [BH, D*D, Dv], g0 [BH], g1 [BH, D], g2 [BH, D, D] (f32).
// grid (row tiles * column blocks, BH).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const T* __restrict__ k, const T* __restrict__ v,
               float* __restrict__ m0, float* __restrict__ m1,
               float* __restrict__ m2, float* __restrict__ g0,
               float* __restrict__ g1, float* __restrict__ g2, int M, int D,
               int Dv, int p) {
  __shared__ __align__(16) float sT[kChunk * kTile];   // features x valid
  __shared__ __align__(16) float sV[kChunk * kCols];
  __shared__ float sG[(kThreads / kTile) * kTile];     // g partials
  __shared__ int sCode[kTile];
  extern __shared__ float sK[];                        // [kChunk, D + 1]
  const int KS = D + 1;  // padded: conflict-free reads of one key's entries
  const int R = n_rows(D, p);
  const int ncb = (Dv + kCols - 1) / kCols;
  const int tile = blockIdx.x / ncb, cb = blockIdx.x - tile * ncb;
  const int r0 = tile * kTile, c0 = cb * kCols;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int myrow = tid & (kTile - 1);   // the row this thread builds
  if (tid < kTile) sCode[tid] = row_code(r0 + tid, D, R);
  __syncthreads();
  const int mycode = sCode[myrow];

  float acc[4][4];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri)
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) acc[ri][ci] = 0.f;
  float gp = 0.f;
  const T* kb = k + (size_t)bh * M * D;
  const T* vb = v + (size_t)bh * M * Dv;

  for (int t0 = 0; t0 < M; t0 += kChunk) {
    const int len = min(kChunk, M - t0);
    for (int e = tid; e < kChunk * D; e += kThreads) {
      const int t = e / D, a = e - t * D;
      sK[t * KS + a] = t < len ? ld(kb + (size_t)(t0 + t) * D + a) : 0.f;
    }
    for (int e = tid; e < kChunk * kCols; e += kThreads) {
      const int t = e / kCols, c = e - t * kCols, cc = c0 + c;
      sV[e] = (t < len && cc < Dv) ? ld(vb + (size_t)(t0 + t) * Dv + cc)
                                   : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kChunk / (kThreads / kTile); ++i) {
      const int t = (tid / kTile) + (kThreads / kTile) * i;
      const float f = (t < len && mycode >= 0) ? feature(mycode, sK + t * KS)
                                                : 0.f;
      sT[t * kTile + myrow] = f;
      gp += f;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < len; ++t) {
      const float4 fv = ld4(sT + t * kTile + 4 * ty);
      const float4 vv = ld4(sV + t * kCols + 4 * tx);
      const float fr[4] = {fv.x, fv.y, fv.z, fv.w};
      const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int ri = 0; ri < 4; ++ri)
#pragma unroll
        for (int ci = 0; ci < 4; ++ci) acc[ri][ci] += fr[ri] * vc[ci];
    }
    __syncthreads();
  }

  // the tile: m rows (both halves of a pair), then the g column
  const int cq = c0 + 4 * tx;
  if (cq < Dv) {
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const int c = sCode[4 * ty + ri];
      if (c < 0) continue;
      const float4 x = make_float4(acc[ri][0], acc[ri][1], acc[ri][2],
                                   acc[ri][3]);
      const int a = code_a(c), b = code_b(c);
      float* dst;
      if (a < 0) dst = m0 + (size_t)bh * Dv;
      else if (b < 0) dst = m1 + ((size_t)bh * D + a) * Dv;
      else dst = m2 + ((size_t)bh * D * D + a * D + b) * Dv;
      *reinterpret_cast<float4*>(dst + cq) = x;
      if (b >= 0 && b != a)
        *reinterpret_cast<float4*>(
            m2 + ((size_t)bh * D * D + b * D + a) * Dv + cq) = x;
    }
  }
  if (cb == 0) {
    sG[tid] = gp;
    __syncthreads();
    if (tid < kTile && mycode >= 0) {
      float s = 0.f;
      for (int l = 0; l < kThreads / kTile; ++l) s += sG[l * kTile + tid];
      const int a = code_a(mycode), b = code_b(mycode);
      if (a < 0) {
        g0[bh] = s;
      } else if (b < 0) {
        g1[(size_t)bh * D + a] = s;
      } else {
        g2[(size_t)bh * D * D + a * D + b] = s;
        g2[(size_t)bh * D * D + b * D + a] = s;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Combine, many query rows. q [BH*G, N, D]; o [BH*G, N, Dv].
// grid (ceil(G*N / 64), BH).
// ---------------------------------------------------------------------------
__host__ __device__ inline int rows_smem_floats(int D) {
  return kChunk * kCols + kChunk * kPS + kTile * (D + 1) + kTile;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_rows_kernel(const T* __restrict__ q, const float* __restrict__ m0,
                    const float* __restrict__ m1,
                    const float* __restrict__ m2,
                    const float* __restrict__ g0,
                    const float* __restrict__ g1,
                    const float* __restrict__ g2, T* __restrict__ o, int G,
                    int N, int D, int Dv, int p, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* sM = smem;                   // [32, 64] moment tile
  float* sP = sM + kChunk * kCols;    // [32, kPS] query features
  float* sQ = sP + kChunk * kPS;      // [64, D + 1] queries
  float* sDen = sQ + kTile * (D + 1); // [64]
  float* sRed = sM;                   // [32, 64] den partials (after use)
  const int QS = D + 1;
  const int R = n_rows(D, p);
  const int GN = G * N;
  const int bh = blockIdx.y;
  const int qr0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rl = tid >> 3;            // the moment row this thread loads
  const int l8 = tid & 7;

  for (int e = tid; e < kTile * D; e += kThreads) {
    const int r = e / D, a = e - r * D, qr = qr0 + r;
    float x = 0.f;
    if (qr < GN) {
      const int g = qr / N, n = qr - g * N;
      x = ld(q + (((size_t)bh * G + g) * N + n) * D + a);
    }
    sQ[r * QS + a] = x;
  }
  __syncthreads();

  const int ncb = (Dv + kCols - 1) / kCols;
  for (int cb = 0; cb < ncb; ++cb) {
    const int c0 = cb * kCols;
    float acc[4][4];
#pragma unroll
    for (int ri = 0; ri < 4; ++ri)
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) acc[ri][ci] = 0.f;
    float dp[kTile / 8];
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) dp[i] = 0.f;

    for (int r0 = 0; r0 < R; r0 += kChunk) {
      const int c = row_code(r0 + rl, D, R);
      // moment tile: row rl, two float4 per thread
#pragma unroll
      for (int j = 0; j < kCols / 32; ++j) {
        const int cc = 4 * l8 + 32 * j;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c >= 0 && c0 + cc < Dv)
          x = ld4(m_row(c, m0, m1, m2, bh, D, Dv) + c0 + cc);
        *reinterpret_cast<float4*>(sM + rl * kCols + cc) = x;
      }
      // the queries' features of row rl (query l8 + 8 i), and the
      // denominator's partial sums in the first column block
      const float w = c >= 0 ? row_weight(c) : 0.f;
      const float gv = (cb == 0 && c >= 0) ? g_val(c, g0, g1, g2, bh, D)
                                           : 0.f;
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i) {
        const int n = l8 + 8 * i;
        const float f = c >= 0 ? w * feature(c, sQ + n * QS) : 0.f;
        sP[rl * kPS + n] = f;
        dp[i] += f * gv;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kChunk; ++r) {
        const float4 fv = ld4(sP + r * kPS + 4 * ty);
        const float4 mv = ld4(sM + r * kCols + 4 * tx);
        const float fr[4] = {fv.x, fv.y, fv.z, fv.w};
        const float mc[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
        for (int ri = 0; ri < 4; ++ri)
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) acc[ri][ci] += fr[ri] * mc[ci];
      }
      __syncthreads();
    }
    if (cb == 0) {
      // den per query row: the 32 row-lanes' partials in a fixed order
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i) sRed[rl * kTile + l8 + 8 * i] = dp[i];
      __syncthreads();
      if (tid < kTile) {
        float s = 0.f;
        for (int l = 0; l < kChunk; ++l) s += sRed[l * kTile + tid];
        sDen[tid] = s + eps;
      }
      __syncthreads();
    }
    const int cq = c0 + 4 * tx;
    if (cq < Dv) {
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const int r = 4 * ty + ri, qr = qr0 + r;
        if (qr >= GN) continue;
        const int g = qr / N, n = qr - g * N;
        T* orow = o + (((size_t)bh * G + g) * N + n) * Dv + cq;
        const float den = sDen[r];
#pragma unroll
        for (int ci = 0; ci < 4; ++ci) st(orow + ci, acc[ri][ci] / den);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Combine, few query rows (G*N <= kMaxQ). Launch 1: grid (nsplit, BH), each
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
  const dim3 grid(((R + kTile - 1) / kTile) * ((Dv + kCols - 1) / kCols), bh);
  const size_t sm = sizeof(float) * kChunk * (D + 1);
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
  const size_t sm = sizeof(float) * rows_smem_floats(D);
  cudaError_t err = cudaFuncSetAttribute(
      combine_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((G * N + kTile - 1) / kTile, bh);
  combine_rows_kernel<T><<<grid, kThreads, sm, s>>>(
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
         (p == 1 || p == 2);
}

}  // namespace

extern "C" {

// Number of feature rows R (the split combine's `rows` cut them).
int fastmax_noncausal_rows(int D, int p) { return n_rows(D, p); }

// Query rows per (batch, kv-head) up to which the combine is split.
int fastmax_noncausal_max_split_rows(void) { return kMaxQ; }

// dtype: 0 = float32 k/v, 1 = bfloat16. Moments are f32, written whole
// (m2 and g2 only at p = 2).
int fastmax_noncausal_moments(int dtype, const void* k, const void* v,
                              void* m0, void* m1, void* m2, void* g0,
                              void* g1, void* g2, int bh, int M, int D,
                              int Dv, int p, void* stream) {
  if (!dims_ok(D, Dv, p) || M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_moments<float>(k, v, m0, m1, m2, g0, g1, g2, bh, M, D, Dv,
                                 p, s);
  return launch_moments<__nv_bfloat16>(k, v, m0, m1, m2, g0, g1, g2, bh, M,
                                       D, Dv, p, s);
}

// dtype: 0 = float32 q/o, 1 = bfloat16. mom: the six f32 moment pointers
// (m0, m1, m2, g0, g1, g2). With G*N <= 16 the split path runs and needs
// `part`, f32 [bh, ceil(R / rows), QT, Dv + 1] with QT the power of two
// >= G*N; otherwise `part` and `rows` are unused.
int fastmax_noncausal_combine(int dtype, const void* q, void* m0, void* m1,
                              void* m2, void* g0, void* g1, void* g2,
                              void* part, void* o, int bh, int G, int N,
                              int D, int Dv, int p, int rows, float eps,
                              void* stream) {
  if (!dims_ok(D, Dv, p) || G < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* mom[6] = {m0, m1, m2, g0, g1, g2};
  const int gn = G * N;
  if (gn <= kMaxQ) {
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
