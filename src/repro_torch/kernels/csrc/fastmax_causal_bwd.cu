// Causal fastmax backward (paper §2.5) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `fastmax_causal_bwd_pallas`
// (src/repro/kernels/fastmax_causal_bwd.py, body `_causal_bwd_kernel`).
//
// What it computes, per (batch, kv-head) bh with G grouped query heads,
// from the residual (q, k, v, final moment carry) and the output cotangent
// do: the chunks are walked in REVERSE, and for each chunk
//   1. carry_before = carry_after - delta(chunk)    (moments are sums);
//   2. den = g0 + q.g1 + 1/2 q^T g2 q + sum_t f(q.k_t) w_t  (carry_before);
//   3. u = do / (den + eps); num is recomputed and sden = -sum_j o_j u_j;
//   4. dq: intra-chunk ds.k plus u.m1^T, sden (g1 + g2 q) and the m2 term
//      sum_b q_b sum_j u_j m2[ab, j];
//   5. dk, dv: intra-chunk terms plus the chain through this chunk's
//      moment delta against the carry-cotangent of the LATER chunks
//      (gm0, gm1, gm2, gg1, gg2 before step 6 touches them);
//   6. fold this chunk into the carry-cotangent:
//      gm0 += sum u, gm1 += q^T u, gm2 += 1/2 (q q)^T u,
//      gg0 += sum sden, gg1 += sden^T q, gg2 += 1/2 q^T (sden q).
// After chunk 0 the carry-cotangent is the cotangent of the scan's initial
// carry (the seed's gradient when the forward was seeded): the dstate
// outputs.
//
// What bounds it on an H100: arithmetic. Per bh the six degree-2 passes
// (subtract, combine, dq through m2, dv and dk through gm2, the gm2 fold)
// cost (3G + 3) * N * D^2 * Dv multiply-adds with the full D^2 rows, half
// that on the symmetric half the bound counts: 6.4e11 operations, 0.65 ms
// at the bf16 tensor-core peak for B=4, Hkv=8, G=2, N=1024, D=Dv=128, far
// above the bytes moved. This version runs them in f32 on the CUDA cores
// with all D^2 rows (tensor cores, wgmma and TMA are later work).
//
// Design.
//   * One block per (Dv column block of 32, bh), 256 threads, walking the
//     chunks backwards; 4 x 32 = 128 blocks at B=4, Hkv=8, Dv=128 (64 at
//     B=2, half the card). Every backward term is linear in the block's
//     (u, sden) columns, so each block owns its dv columns exactly and
//     emits dq, dk (and the g-parts of dstate) as per-block f32 partials;
//     the wrapper sums them over blocks in a fixed order (no atomics, so
//     grads repeat bit for bit from run to run).
//   * The carry and the carry-cotangent do not fit on chip (m2 and gm2
//     are 2 MB per block each at D = Dv = 128). Both live in device
//     memory: m2 is a workspace COPY of the forward's final carry (the
//     autograd residual is never written), gm2 is the zeroed dstate m2
//     output itself; g2 (a per-block copy) and gg2 (the per-block dstate
//     g2 partial) likewise. The small carries (m0, m1, g0, g1, gm0, gm1,
//     gg0, gg1) stay in shared memory.
//   * Ordering. u needs only den, which is Dv-independent and comes from
//     the g-carries, so u is known before m2 is touched and m2 and gm2 are
//     streamed ONCE per chunk, in tiles of 32 rows (a, b0..b0+31): each
//     tile is subtracted (carry_before) and written back, contracted with
//     q_a q_b (num) and with u (dq), while the OLD gm2 tile feeds dv and
//     dk and its folded value goes back to device memory — the fold of a
//     tile never precedes that tile's use. sden (which needs num) enters
//     only the intra-chunk and the small g terms, computed after the pass.
//   * The tile products are register-tiled as in the forward kernel:
//     thread (ty, tx) owns 4 query rows x 4 columns (num, dq) or 2 keys x
//     4 columns (dv, dk) and reads float4 / float2 fragments.
//   * Ragged N: tokens past N get weight 0 and rows past N are never
//     written; the chunk length C is the wrapper's (G*C <= 128, C even,
//     shared memory <= 227 KB); any chunking is exact, since the carry is
//     a plain sum.
//   * Inputs f32 or bf16, widened on load; all sums in f32.
// Requires D % 4 == 0, Dv % 4 == 0 and C even (checked here and by the
// wrapper).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;      // Dv column block
constexpr int kRT = 32;        // m2 rows per tile (b0 .. b0+31 of one a)
constexpr int kRows = 128;     // query rows per chunk (G * C <= kRows)
constexpr int kSS = kRows + 1; // row stride of the score block
// row strides of the per-tile staging: 4 tile rows are read at once by a
// warp; a stride that is a multiple of 32 floats would put them in one
// bank, +4 keeps float4 / float2 alignment
constexpr int kYS = kRows + 4;
__host__ __device__ inline int t_stride(int C) { return C + 4; }

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
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float lane8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

__host__ __device__ inline int scratch_floats(int C) {
  int pass = kRT * kYS + 4 * kRT * kCols + kRT * t_stride(C);
  int score = C * kSS;
  return pass > score ? pass : score;
}

__host__ __device__ inline int smem_floats(int C, int D) {
  return D * kRows + 2 * kRows * kCols + 2 * D * kCols + C * kCols +
         2 * kCols + scratch_floats(C) + kCols * C + C * (D + 1) + C +
         2 * D + 2 * kRows + 4;
}

// q [BH*G, N, D], k [BH, N, D], v [BH, N, Dv], do [BH*G, N, Dv] (T).
// m0 [BH, Dv], m1 [BH, D, Dv], g0 [BH], g1 [BH, D]: the final carry (f32,
// read only). m2w [BH, D*D, Dv]: workspace copy of the final m2 (p >= 2).
// g2w [nb, BH, D, D]: per-block workspace copies of the final g2.
// dqp [nb, BH*G, N, D], dkp [nb, BH, N, D] (f32, zeroed; accumulated).
// dv [BH, N, Dv] (T). gm2 [BH, D*D, Dv], gg2 [nb, BH, D, D] (zeroed; the
// dstate m2 / g2 partials). dsm0 [BH, Dv], dsm1 [BH, D, Dv],
// dsg0 [nb, BH], dsg1 [nb, BH, D] (written at the end).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
causal_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ m0, const float* __restrict__ m1,
                  const float* __restrict__ g0, const float* __restrict__ g1,
                  float* m2w, float* g2w, float* dqp, float* dkp,
                  T* __restrict__ dv, float* gm2, float* gg2, float* dsm0,
                  float* dsm1, float* dsg0, float* dsg1, int G, int N,
                  int D, int Dv, int p, int C, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int GC = G * C;
  const int KS = D + 1;
  const int TS = t_stride(C);
  // float4-read arrays first (offsets multiples of 4 floats), then the
  // float2 and scalar ones
  float* sQT = smem;                    // [D, 128]  queries, transposed
  float* sU = sQT + D * kRows;          // [128, 32] do, then u
  float* sUT = sU + kRows * kCols;      // [32, 128] u, transposed
  float* sM1 = sUT + kRows * kCols;     // [D, 32]   m1 carry slice
  float* sGM1 = sM1 + D * kCols;        // [D, 32]   gm1 slice
  float* sV = sGM1 + D * kCols;         // [C, 32]   v (raw)
  float* sM0 = sV + C * kCols;          // [32]
  float* sGM0 = sM0 + kCols;            // [32]
  float* scr = sGM0 + kCols;            // scratch (m2 pass / scores)
  float* sY = scr;                      // [RT, kYS] q_a q_b per query row
  float* sMt = sY + kRT * kYS;          // [RT, 32]  m2 tile (carry_before)
  float* sMtT = sMt + kRT * kCols;      // [32, RT]  same, transposed
  float* sGt = sMtT + kRT * kCols;      // [RT, 32]  old gm2 tile
  float* sGtT = sGt + kRT * kCols;      // [32, RT]  same, transposed
  float* sT = sGtT + kRT * kCols;       // [RT, TS]  w k_a k_b per token
  float* sS = scr;                      // [C, 129]  scores, then ds
  float* sVWT = scr + scratch_floats(C);  // [32, C] w v, transposed
  float* sK = sVWT + kCols * C;         // [C, KS]
  float* sW = sK + C * KS;              // [C]
  float* sG1 = sW + C;                  // [D]
  float* sGG1 = sG1 + D;                // [D]
  float* sDen = sGG1 + D;               // [128]
  float* sSden = sDen + kRows;          // [128]
  float* sScal = sSden + kRows;         // g0, gg0

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 7, ty = tid >> 3;
  const int blk = blockIdx.x;
  const int bh = blockIdx.y, BH = gridDim.y;
  const int cbase = blk * kCols;
  const int col = cbase + lane;
  const bool col_ok = col < Dv;
  const int c4 = 4 * tx;
  const bool cq_ok = cbase + c4 < Dv;     // Dv % 4 == 0: all 4 or none
  const int DD = D * D;
  const bool deg2 = p >= 2;
  float* m2b = deg2 ? m2w + (size_t)bh * DD * Dv : nullptr;
  float* gm2b = deg2 ? gm2 + (size_t)bh * DD * Dv : nullptr;
  float* g2b = g2w + ((size_t)blk * BH + bh) * DD;
  float* gg2b = gg2 + ((size_t)blk * BH + bh) * DD;
  float* dqb = dqp + (size_t)blk * BH * G * N * D;
  float* dkb = dkp + ((size_t)blk * BH + bh) * N * D;

  // ---- the final carry (small parts) and a zero carry-cotangent ----
  if (warp == 0) {
    sM0[lane] = col_ok ? m0[(size_t)bh * Dv + col] : 0.f;
    sGM0[lane] = 0.f;
  }
  for (int a = warp; a < D; a += kThreads / 32) {
    sM1[a * kCols + lane] = col_ok ? m1[((size_t)bh * D + a) * Dv + col] : 0.f;
    sGM1[a * kCols + lane] = 0.f;
  }
  for (int a = tid; a < D; a += kThreads) {
    sG1[a] = g1[(size_t)bh * D + a];
    sGG1[a] = 0.f;
  }
  if (tid == 0) {
    sScal[0] = g0[bh];
    sScal[1] = 0.f;
  }
  __syncthreads();

  const int nc = (N + C - 1) / C;
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * C;
    const int len = min(C, N - c0);
    // ---- load the chunk (queries transposed; do into sU) ----
    for (int e = tid; e < kRows * D; e += kThreads) {
      const int r = e / D, a = e - r * D;
      const int g = r / C, i = r - g * C;
      sQT[a * kRows + r] =
          (r < GC && i < len)
              ? ld(q + (((size_t)bh * G + g) * N + c0 + i) * D + a) : 0.f;
    }
    for (int e = tid; e < kRows * kCols; e += kThreads) {
      const int r = e / kCols, cc = e - r * kCols;
      const int g = r / C, i = r - g * C;
      sU[e] = (r < GC && i < len && cbase + cc < Dv)
                  ? ld(dout + (((size_t)bh * G + g) * N + c0 + i) * Dv +
                       cbase + cc)
                  : 0.f;
    }
    for (int e = tid; e < C * D; e += kThreads) {
      const int t = e / D, a = e - t * D;
      sK[t * KS + a] = t < len ? ld(k + ((size_t)bh * N + c0 + t) * D + a)
                               : 0.f;
    }
    for (int t = tid; t < C; t += kThreads) sW[t] = t < len ? 1.f : 0.f;
    for (int e = tid; e < C * kCols; e += kThreads) {
      const int t = e / kCols, cc = e - t * kCols;
      const float x = (t < len && cbase + cc < Dv)
                          ? ld(v + ((size_t)bh * N + c0 + t) * Dv + cbase + cc)
                          : 0.f;
      sV[e] = x;
      sVWT[cc * C + t] = x;   // w = 1 on real tokens, x = 0 on padding
    }
    __syncthreads();

    // ---- 1. carry_before = carry_after - delta (small carries, g2) ----
    if (warp == 0) {
      float x = 0.f;
      for (int t = 0; t < len; ++t) x += sW[t] * sV[t * kCols + lane];
      sM0[lane] -= x;
    }
    for (int a = warp; a < D; a += kThreads / 32) {
      float x = 0.f;
      for (int t = 0; t < len; ++t)
        x += sK[t * KS + a] * sW[t] * sV[t * kCols + lane];
      sM1[a * kCols + lane] -= x;
    }
    if (tid == 0) {
      float x = 0.f;
      for (int t = 0; t < len; ++t) x += sW[t];
      sScal[0] -= x;
    }
    for (int a = tid; a < D; a += kThreads) {
      float x = 0.f;
      for (int t = 0; t < len; ++t) x += sW[t] * sK[t * KS + a];
      sG1[a] -= x;
    }
    if (deg2) {
      for (int e = tid; e < DD; e += kThreads) {
        const int a = e / D, b = e - a * D;
        float x = 0.f;
        for (int t = 0; t < len; ++t)
          x += sK[t * KS + a] * sW[t] * sK[t * KS + b];
        g2b[e] -= x;
      }
    }
    __syncthreads();

    // ---- 2. den per query row (two threads per row) ----
    {
      const int r = tid >> 1, h = tid & 1;
      const int i = r % C;
      float part = 0.f;
      for (int a = h; a < D; a += 2) {
        const float qa = sQT[a * kRows + r];
        float x = sG1[a];
        if (deg2) {
          float y = 0.f;
          for (int b = 0; b < D; ++b) y += g2b[a * D + b] * sQT[b * kRows + r];
          x += 0.5f * y;
        }
        part += qa * x;
      }
      for (int t = h; t <= i && t < len; t += 2) {
        float s = 0.f;
        for (int a = 0; a < D; ++a) s += sQT[a * kRows + r] * sK[t * KS + a];
        float f = 1.f + s;
        if (deg2) f += 0.5f * s * s;
        part += f * sW[t];
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (h == 0) sDen[r] = sScal[0] + part;
    }
    __syncthreads();

    // ---- 3. u = do / (den + eps) ----
    for (int e = tid; e < kRows * kCols; e += kThreads) {
      const int r = e / kCols, cc = e - r * kCols;
      const int i = r % C;
      const float u = (r < GC && i < len) ? sU[e] / (sDen[r] + eps) : 0.f;
      sU[e] = u;
      sUT[cc * kRows + r] = u;
    }
    __syncthreads();

    // ---- 4. one pass over m2 and gm2 in tiles of 32 rows ----
    float acc2[4][4], dv2[2][4];
#pragma unroll
    for (int ri = 0; ri < 4; ++ri)
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) acc2[ri][ci] = 0.f;
#pragma unroll
    for (int ti = 0; ti < 2; ++ti)
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) dv2[ti][ci] = 0.f;
    const bool t_ok = 2 * ty < C;       // this thread's two keys exist
    if (deg2) {
      for (int a = 0; a < D; ++a) {
        float dqa[4] = {0.f, 0.f, 0.f, 0.f};
        float dka[2] = {0.f, 0.f};
        for (int b0 = 0; b0 < D; b0 += kRT) {
          const int nv = min(kRT, D - b0);
          const int rl = ty;            // this thread's tile row
          const bool row_ok = rl < nv && cq_ok;
          const size_t grow = (size_t)(a * D + b0 + rl) * Dv + cbase + c4;
          float4 mv = make_float4(0.f, 0.f, 0.f, 0.f), gv = mv;
          if (row_ok) {
            mv = ld4(m2b + grow);
            gv = ld4(gm2b + grow);
          }
          for (int e = tid; e < kRT * kRows; e += kThreads) {
            const int bl = e >> 7, r = e & (kRows - 1);
            sY[bl * kYS + r] = bl < nv
                        ? sQT[a * kRows + r] * sQT[(b0 + bl) * kRows + r] : 0.f;
          }
          for (int e = tid; e < kRT * C; e += kThreads) {
            const int bl = e / C, t = e - bl * C;
            sT[bl * TS + t] = bl < nv
                        ? sK[t * KS + a] * sW[t] * sK[t * KS + b0 + bl] : 0.f;
          }
          __syncthreads();
          // subtract this chunk from the m2 tile; fold the chunk into gm2
          // (written back) while the old gm2 tile stays for dv / dk
          if (row_ok) {
            // the chunk's delta first, then one subtraction from the
            // carry (one rounding of the large value per chunk, not per
            // token, as the plain version)
            float4 dm = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int t = 0; t < len; ++t) {
              const float s = sT[rl * TS + t];
              const float4 vv = ld4(sV + t * kCols + c4);
              dm.x += s * vv.x; dm.y += s * vv.y;
              dm.z += s * vv.z; dm.w += s * vv.w;
            }
            mv.x -= dm.x; mv.y -= dm.y; mv.z -= dm.z; mv.w -= dm.w;
            *reinterpret_cast<float4*>(m2b + grow) = mv;
            float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
            for (int r = 0; r < kRows; ++r) {
              const float y = sY[rl * kYS + r];
              const float4 uu = ld4(sU + r * kCols + c4);
              f.x += y * uu.x; f.y += y * uu.y; f.z += y * uu.z; f.w += y * uu.w;
            }
            *reinterpret_cast<float4*>(gm2b + grow) = make_float4(
                gv.x + 0.5f * f.x, gv.y + 0.5f * f.y, gv.z + 0.5f * f.z,
                gv.w + 0.5f * f.w);
          }
          *reinterpret_cast<float4*>(sMt + rl * kCols + c4) = mv;
          *reinterpret_cast<float4*>(sGt + rl * kCols + c4) = gv;
          sMtT[(c4 + 0) * kRT + rl] = mv.x; sMtT[(c4 + 1) * kRT + rl] = mv.y;
          sMtT[(c4 + 2) * kRT + rl] = mv.z; sMtT[(c4 + 3) * kRT + rl] = mv.w;
          sGtT[(c4 + 0) * kRT + rl] = gv.x; sGtT[(c4 + 1) * kRT + rl] = gv.y;
          sGtT[(c4 + 2) * kRT + rl] = gv.z; sGtT[(c4 + 3) * kRT + rl] = gv.w;
          __syncthreads();

          // num: acc2 += (q_a q_b) . m2 tile
#pragma unroll 4
          for (int bl = 0; bl < kRT; ++bl) {
            const float4 yv = ld4(sY + bl * kYS + 4 * ty);
            const float4 m = ld4(sMt + bl * kCols + c4);
            const float yr[4] = {yv.x, yv.y, yv.z, yv.w};
            const float mc[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
            for (int ri = 0; ri < 4; ++ri)
#pragma unroll
              for (int ci = 0; ci < 4; ++ci) acc2[ri][ci] += yr[ri] * mc[ci];
          }
          // dq column a: sum_b q_b sum_j u_j m2[ab, j]
          {
            float w[4][4];
#pragma unroll
            for (int ri = 0; ri < 4; ++ri)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) w[ri][kk] = 0.f;
#pragma unroll 4
            for (int j = 0; j < kCols; ++j) {
              const float4 uv = ld4(sUT + j * kRows + 4 * ty);
              const float4 m = ld4(sMtT + j * kRT + c4);
              const float ur[4] = {uv.x, uv.y, uv.z, uv.w};
              const float mc[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
              for (int ri = 0; ri < 4; ++ri)
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) w[ri][kk] += ur[ri] * mc[kk];
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int b = b0 + c4 + kk;
              if (b < D) {
                const float4 qb = ld4(sQT + b * kRows + 4 * ty);
                dqa[0] += w[0][kk] * qb.x; dqa[1] += w[1][kk] * qb.y;
                dqa[2] += w[2][kk] * qb.z; dqa[3] += w[3][kk] * qb.w;
              }
            }
          }
          if (t_ok) {
            // dv: w k_a k_b . old gm2 tile
#pragma unroll 4
            for (int bl = 0; bl < kRT; ++bl) {
              const float2 kk = ld2(sT + bl * TS + 2 * ty);
              const float4 gg = ld4(sGt + bl * kCols + c4);
              dv2[0][0] += kk.x * gg.x; dv2[0][1] += kk.x * gg.y;
              dv2[0][2] += kk.x * gg.z; dv2[0][3] += kk.x * gg.w;
              dv2[1][0] += kk.y * gg.x; dv2[1][1] += kk.y * gg.y;
              dv2[1][2] += kk.y * gg.z; dv2[1][3] += kk.y * gg.w;
            }
            // dk column a: 2 sum_b k_b sum_j w v_j gm2[ab, j]
            float qq[2][4];
#pragma unroll
            for (int ti = 0; ti < 2; ++ti)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) qq[ti][kk] = 0.f;
#pragma unroll 4
            for (int j = 0; j < kCols; ++j) {
              const float2 vw = ld2(sVWT + j * C + 2 * ty);
              const float4 gg = ld4(sGtT + j * kRT + c4);
              qq[0][0] += vw.x * gg.x; qq[0][1] += vw.x * gg.y;
              qq[0][2] += vw.x * gg.z; qq[0][3] += vw.x * gg.w;
              qq[1][0] += vw.y * gg.x; qq[1][1] += vw.y * gg.y;
              qq[1][2] += vw.y * gg.z; qq[1][3] += vw.y * gg.w;
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int b = b0 + c4 + kk;
              if (b < D) {
                dka[0] += qq[0][kk] * sK[(2 * ty) * KS + b];
                dka[1] += qq[1][kk] * sK[(2 * ty + 1) * KS + b];
              }
            }
          }
          __syncthreads();
        }
        // the 8 threads of a row group (lanes differing in bits 0..2)
#pragma unroll
        for (int ri = 0; ri < 4; ++ri) dqa[ri] = lane8_sum(dqa[ri]);
        dka[0] = lane8_sum(dka[0]);
        dka[1] = lane8_sum(dka[1]);
        if (tx == 0) {
#pragma unroll
          for (int ri = 0; ri < 4; ++ri) {
            const int r = 4 * ty + ri, g = r / C, i = r - g * C;
            if (r < GC && i < len)
              dqb[(((size_t)bh * G + g) * N + c0 + i) * D + a] += dqa[ri];
          }
#pragma unroll
          for (int ti = 0; ti < 2; ++ti) {
            const int t = 2 * ty + ti;
            if (t < len) dkb[(size_t)(c0 + t) * D + a] += 2.f * dka[ti];
          }
        }
      }
    }

    // ---- 5. scores, num, o and the block's partial sden ----
    for (int e = tid; e < C * kRows; e += kThreads) {
      const int t = e / kRows, r = e - t * kRows;
      float s = 0.f;
      for (int a = 0; a < D; ++a) s += sQT[a * kRows + r] * sK[t * KS + a];
      sS[t * kSS + r] = s;
    }
    __syncthreads();
    {
      float acc[4][4];
      const float4 m0v = ld4(sM0 + c4);
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        acc[ri][0] = m0v.x + 0.5f * acc2[ri][0];
        acc[ri][1] = m0v.y + 0.5f * acc2[ri][1];
        acc[ri][2] = m0v.z + 0.5f * acc2[ri][2];
        acc[ri][3] = m0v.w + 0.5f * acc2[ri][3];
      }
      for (int a = 0; a < D; ++a) {
        const float4 qv = ld4(sQT + a * kRows + 4 * ty);
        const float4 mv = ld4(sM1 + a * kCols + c4);
        const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
        const float mc[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
        for (int ri = 0; ri < 4; ++ri)
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) acc[ri][ci] += qr[ri] * mc[ci];
      }
      for (int t = 0; t < len; ++t) {
        const float4 vv = ld4(sV + t * kCols + c4);
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int ri = 0; ri < 4; ++ri) {
          const int r = 4 * ty + ri;
          if (t <= r % C) {
            const float s = sS[t * kSS + r];
            float f = 1.f + s;
            if (deg2) f += 0.5f * s * s;
            f *= sW[t];
#pragma unroll
            for (int ci = 0; ci < 4; ++ci) acc[ri][ci] += f * vc[ci];
          }
        }
      }
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const int r = 4 * ty + ri;
        const bool ok = r < GC && r % C < len;
        const float4 uu = ld4(sU + r * kCols + c4);
        float x = ok ? -(acc[ri][0] * uu.x + acc[ri][1] * uu.y +
                         acc[ri][2] * uu.z + acc[ri][3] * uu.w) /
                           (sDen[r] + eps)
                     : 0.f;
        x = lane8_sum(x);
        if (tx == 0) sSden[r] = x;
      }
    }
    __syncthreads();

    // ---- 6a. dv: intra F^T u, plus the chain through this chunk's delta
    //      (old gm0, gm1; the gm2 part dv2 came from the pass) ----
    if (t_ok && cq_ok) {
#pragma unroll
      for (int ti = 0; ti < 2; ++ti) {
        const int t = 2 * ty + ti;
        if (t < len) {
          const float w = sW[t];
          float x[4] = {dv2[ti][0], dv2[ti][1], dv2[ti][2], dv2[ti][3]};
          const float4 gm0v = ld4(sGM0 + c4);
          x[0] += w * gm0v.x; x[1] += w * gm0v.y;
          x[2] += w * gm0v.z; x[3] += w * gm0v.w;
          for (int a = 0; a < D; ++a) {
            const float ka = w * sK[t * KS + a];
            const float4 g = ld4(sGM1 + a * kCols + c4);
            x[0] += ka * g.x; x[1] += ka * g.y; x[2] += ka * g.z; x[3] += ka * g.w;
          }
          for (int r = 0; r < GC; ++r) {
            if (t > r % C) continue;
            const float s = sS[t * kSS + r];
            float f = 1.f + s;
            if (deg2) f += 0.5f * s * s;
            f *= w;
            const float4 uu = ld4(sU + r * kCols + c4);
            x[0] += f * uu.x; x[1] += f * uu.y; x[2] += f * uu.z; x[3] += f * uu.w;
          }
          T* row = dv + ((size_t)bh * N + c0 + t) * Dv + cbase + c4;
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) st(row + ci, x[ci]);
        }
      }
    }
    __syncthreads();

    // ---- 6b. scores -> ds = (u.v + sden) f'(s) mask ----
    for (int e = tid; e < C * kRows; e += kThreads) {
      const int t = e / kRows, r = e - t * kRows;
      const int i = r % C;
      float ds = 0.f;
      if (r < GC && i < len && t <= i) {
        float uv = 0.f;
        for (int cc = 0; cc < kCols; ++cc)
          uv += sU[r * kCols + cc] * sV[t * kCols + cc];
        const float fp = deg2 ? 1.f + sS[t * kSS + r] : 1.f;
        ds = (uv + sSden[r]) * fp * sW[t];
      }
      sS[t * kSS + r] = ds;
    }
    __syncthreads();

    // ---- 6c. dq and dk partials (small and intra terms) ----
    for (int e = tid; e < kRows * D; e += kThreads) {
      const int r = e / D, a = e - r * D;
      const int g = r / C, i = r - g * C;
      if (r >= GC || i >= len) continue;
      float x = 0.f;
      for (int t = 0; t <= i; ++t) x += sS[t * kSS + r] * sK[t * KS + a];
      for (int cc = 0; cc < kCols; ++cc)
        x += sU[r * kCols + cc] * sM1[a * kCols + cc];
      float gq = sG1[a];
      if (deg2)
        for (int b = 0; b < D; ++b) gq += g2b[a * D + b] * sQT[b * kRows + r];
      x += sSden[r] * gq;
      dqb[(((size_t)bh * G + g) * N + c0 + i) * D + a] += x;
    }
    for (int e = tid; e < C * D; e += kThreads) {
      const int t = e / D, a = e - t * D;
      if (t >= len) continue;
      float x = 0.f;
      for (int r = 0; r < GC; ++r) x += sS[t * kSS + r] * sQT[a * kRows + r];
      float y = sGG1[a];
      for (int cc = 0; cc < kCols; ++cc)
        y += sV[t * kCols + cc] * sGM1[a * kCols + cc];
      if (deg2) {
        float z = 0.f;
        for (int b = 0; b < D; ++b) z += gg2b[a * D + b] * sK[t * KS + b];
        y += 2.f * z;
      }
      x += sW[t] * y;
      dkb[(size_t)(c0 + t) * D + a] += x;
    }
    __syncthreads();

    // ---- 7. fold this chunk into the carry-cotangent ----
    if (warp == 0) {
      float x = 0.f;
      for (int r = 0; r < GC; ++r) x += sU[r * kCols + lane];
      sGM0[lane] += x;
    }
    for (int a = warp; a < D; a += kThreads / 32) {
      float x = 0.f;
      for (int r = 0; r < GC; ++r)
        x += sQT[a * kRows + r] * sU[r * kCols + lane];
      sGM1[a * kCols + lane] += x;
    }
    if (tid == 0) {
      float x = 0.f;
      for (int r = 0; r < GC; ++r) x += sSden[r];
      sScal[1] += x;
    }
    for (int a = tid; a < D; a += kThreads) {
      float x = 0.f;
      for (int r = 0; r < GC; ++r) x += sSden[r] * sQT[a * kRows + r];
      sGG1[a] += x;
    }
    if (deg2) {
      for (int e = tid; e < DD; e += kThreads) {
        const int a = e / D, b = e - a * D;
        float x = 0.f;
        for (int r = 0; r < GC; ++r)
          x += sQT[a * kRows + r] * sSden[r] * sQT[b * kRows + r];
        gg2b[e] += 0.5f * x;
      }
    }
    __syncthreads();
  }

  // ---- the cotangent of the initial carry (gm2, gg2 are in place) ----
  if (warp == 0 && col_ok) dsm0[(size_t)bh * Dv + col] = sGM0[lane];
  if (col_ok)
    for (int a = warp; a < D; a += kThreads / 32)
      dsm1[((size_t)bh * D + a) * Dv + col] = sGM1[a * kCols + lane];
  if (tid == 0) dsg0[(size_t)blk * BH + bh] = sScal[1];
  for (int a = tid; a < D; a += kThreads)
    dsg1[((size_t)blk * BH + bh) * D + a] = sGG1[a];
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* m0, const void* m1, const void* g0, const void* g1,
           void* m2w, void* g2w, void* dqp, void* dkp, void* dv, void* gm2,
           void* gg2, void* dsm0, void* dsm1, void* dsg0, void* dsg1, int bh,
           int G, int N, int D, int Dv, int p, int C, float eps,
           void* stream) {
  const size_t bytes = sizeof(float) * (size_t)smem_floats(C, D);
  cudaError_t err = cudaFuncSetAttribute(
      causal_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Dv + kCols - 1) / kCols, bh);
  causal_bwd_kernel<T><<<grid, kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)m0, (const float*)m1, (const float*)g0, (const float*)g1,
      (float*)m2w, (float*)g2w, (float*)dqp, (float*)dkp, (T*)dv,
      (float*)gm2, (float*)gg2, (float*)dsm0, (float*)dsm1, (float*)dsg0,
      (float*)dsg1, G, N, D, Dv, p, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes the kernel needs at (G, C, D); the wrapper picks C.
long fastmax_causal_bwd_smem_bytes(int G, int C, int D) {
  (void)G;
  return (long)sizeof(float) * smem_floats(C, D);
}

// dtype: 0 = float32 q/k/v/do/dv, 1 = bfloat16. Everything else is f32.
// m2w and gm2 may be null at p = 1.
int fastmax_causal_bwd(int dtype, const void* q, const void* k,
                       const void* v, const void* dout, const void* m0,
                       const void* m1, const void* g0, const void* g1,
                       void* m2w, void* g2w, void* dqp, void* dkp, void* dv,
                       void* gm2, void* gg2, void* dsm0, void* dsm1,
                       void* dsg0, void* dsg1, int bh, int G, int N, int D,
                       int Dv, int p, int C, float eps, void* stream) {
  if (G * C > kRows || C < 2 || C % 2 || D % 4 || Dv % 4 ||
      (p >= 2 && (m2w == nullptr || gm2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, dout, m0, m1, g0, g1, m2w, g2w, dqp, dkp,
                         dv, gm2, gg2, dsm0, dsm1, dsg0, dsg1, bh, G, N, D,
                         Dv, p, C, eps, stream);
  return launch<__nv_bfloat16>(q, k, v, dout, m0, m1, g0, g1, m2w, g2w, dqp,
                               dkp, dv, gm2, gg2, dsm0, dsm1, dsg0, dsg1, bh,
                               G, N, D, Dv, p, C, eps, stream);
}

}  // extern "C"
