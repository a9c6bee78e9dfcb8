// The feature table of the fastmax kernels for Hopper (sm_90a), shared by
// fastmax_causal.cu (the prefill), fastmax_causal_bwd.cu (the §2.5
// backward) and fastmax_noncausal.cu.
//
// f(q.k) = 1 + q.k + (q.k)^2 / 2 factorizes over one table of feature rows:
// row 0 the constant 1, rows 1..D the linear features x_a, then at p = 2 one
// row per pair a <= b, x_a x_b, in row-major order; R = 1 + D + D(D+1)/2
// rows, 8385 at D = 128. The moments of the keys are sums of φ(k) [v | w]
// over these rows (m2 and g2 are symmetric, so D(D+1)/2 rows do the work of
// D^2); a query contracts its features with them, each pair row weighted 1
// and each diagonal pair 1/2, so that sum_r weight_r φ_r(q) φ_r(k) = f(q.k).
//
// Beside the table, the two register-tiled products every kernel here is
// built from (256 threads, thread (ty, tx) = (tid >> 4, tid & 15)):
//   * `moment_tile`: a 64 x 64 tile of moment rows x value columns, thread
//     rows 4ty..4ty+3 and columns 4tx..4tx+3, += 32 tokens' features x
//     values: 16 FMAs per two float4 shared-memory loads;
//   * `tile_product`: a 64 x (64 NCG) output tile (query rows x value
//     columns), thread rows 4ty..4ty+3 and columns 64 j + 4tx..4tx+3 of
//     group j, += 32 table rows' weighted features x those rows' values.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

constexpr int kThreads = 256;
constexpr int kTile = 64;    // feature rows (moments) / query rows (combine)
constexpr int kCols = 64;    // value columns per tile
constexpr int kChunk = 32;   // tokens (moments) / table rows (combine) a step
constexpr int kPS = 72;      // padded row stride of the combine's features

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

// The same in f64, exact for f32 entries (the p = 1 denominator's terms).
__device__ __forceinline__ double feature64(int c, const float* x) {
  const int a = code_a(c), b = code_b(c);
  double f = a < 0 ? 1.0 : (double)x[a];
  if (b >= 0) f *= (double)x[b];
  return f;
}

// The combine's weight of row `c`: 1/2 on the diagonal pairs (a == b).
__device__ __forceinline__ float row_weight(int c) {
  const int b = code_b(c);
  return (b >= 0 && b == code_a(c)) ? 0.5f : 1.f;
}

// Offsets of row `c` of bh in the state layout: its m row (times Dv) and
// its g entry; `*mt`, `*gt` the transposed pair's (b*D+a), else -1.
__device__ __forceinline__ void state_offsets(int c, int bh, int D, int Dv,
                                              size_t* m, size_t* g,
                                              long* mt, long* gt) {
  const int a = code_a(c), b = code_b(c);
  *mt = *gt = -1;
  if (a < 0) {
    *m = (size_t)bh * Dv;
    *g = bh;
  } else if (b < 0) {
    *m = ((size_t)bh * D + a) * Dv;
    *g = (size_t)bh * D + a;
  } else {
    *m = ((size_t)bh * D * D + a * D + b) * Dv;
    *g = (size_t)bh * D * D + a * D + b;
    if (a != b) {
      *mt = (long)(((size_t)bh * D * D + b * D + a) * Dv);
      *gt = (long)((size_t)bh * D * D + b * D + a);
    }
  }
}

// The state arrays of one side (init or output), by feature row kind.
struct State {
  float *m0, *m1, *m2, *g0, *g1, *g2;
  __device__ __forceinline__ float* m(int c) const {
    return code_a(c) < 0 ? m0 : (code_b(c) < 0 ? m1 : m2);
  }
  __device__ __forceinline__ float* g(int c) const {
    return code_a(c) < 0 ? g0 : (code_b(c) < 0 ? g1 : g2);
  }
};

// acc += sum over the first `len` tokens t of sT[t, 4ty..] x sV[t, 4tx..]:
// sT [32, kTile] the tokens' features of the tile's rows, sV [32, kCols]
// their values.
__device__ __forceinline__ void moment_tile(float (&acc)[4][4],
                                            const float* sT, const float* sV,
                                            int len, int ty, int tx) {
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
}

// acc += sum over 32 rows r of sP[r, 4ty..] x sM[r, 64 j + 4tx..]: sP
// [32, kPS] the weighted features (or scores) of 64 output rows, sM
// [32, ms] the rows' values, ms >= 64 NCG and a multiple of 4.
template <int NCG>
__device__ __forceinline__ void tile_product(float (&acc)[4][4 * NCG],
                                             const float* sP,
                                             const float* sM, int ms, int ty,
                                             int tx) {
#pragma unroll 4
  for (int r = 0; r < kChunk; ++r) {
    const float4 fv = ld4(sP + r * kPS + 4 * ty);
    const float fr[4] = {fv.x, fv.y, fv.z, fv.w};
#pragma unroll
    for (int j = 0; j < NCG; ++j) {
      const float4 mv = ld4(sM + r * ms + kCols * j + 4 * tx);
      const float mc[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
      for (int ri = 0; ri < 4; ++ri)
#pragma unroll
        for (int ci = 0; ci < 4; ++ci)
          acc[ri][4 * j + ci] += fr[ri] * mc[ci];
    }
  }
}
