// Fastmax one-token decode step for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `fastmax_decode_pallas`
// (src/repro/kernels/fastmax_decode.py, body `_decode_kernel`).
//
// What it computes, per (batch, kv-head) bh with G grouped query heads:
//   fold the new token into the moments (rank-1 updates, IN PLACE):
//     m0 += v, m1 += k v^T, m2[a*D+b, :] += k_a k_b v, g0 += 1, g1 += k,
//     g2 += k k^T                                       (m2/g2 only at p=2)
//   then contract each query q_g with the UPDATED moments:
//     num = m0 + q.m1 + 1/2 sum_ab q_a q_b m2[ab, :]
//     den = g0 + q.g1 + 1/2 q^T g2 q,      o = num / (den + eps).
//
// What bounds it on an H100: device-memory bytes. m2 is D*D*Dv f32 per
// bh (8 MB at D = Dv = 128) and must be read and written once per token;
// everything else is small. The TPU kernel streams m2 through one core per
// head; here one block per head would leave most of the 132 SMs idle
// (B * Hkv = 32 blocks on the main path), so the m2 rows are split across
// blocks instead:
//   launch 1 (`decode_m2_kernel`, p = 2 only): grid (nsplit, B*Hkv). Each
//     block owns `rows` consecutive m2 rows and all Dv columns; a thread
//     owns 4 columns (float4 loads and stores, coalesced across the warp)
//     of every 8th row, applies the rank-1 update, writes the row back,
//     and accumulates the G partial numerators against the updated value.
//     The block sums its threads' partials in a fixed order into a scratch
//     buffer [B*Hkv, nsplit, G, Dv].
//   launch 2 (`decode_small_kernel`): grid (B*Hkv). Updates m0/m1/g0/g1/g2
//     in place, forms the small-moment terms and the denominator, sums the
//     m2 partials in a FIXED order (split 0, 1, ...), and divides. No float
//     atomics: greedy tokens must not change from run to run.
// Both launch on the caller's stream; the C entry returns
// cudaGetLastError() after the launches.
//
// Any G (the Pallas kernel takes any): a block holds at most kMaxG = 16
// queries' partials in registers, so the C entry runs the pair of launches
// once per group of at most `group` (1..16, the caller's) queries of each
// head, in order. Only the first group folds the token into the moments
// (`upd`); each later group reads the updated moments and contracts with
// them. At G <= group that is one pair. The m2 scratch is reused from
// group to group (the launches are ordered on the stream).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxG = 16;
constexpr int kThreads = 128;     // small-moment launch
constexpr int kM2Threads = 256;   // m2 launch

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// q [BH, Gq, D] (this group's GT queries start at query j0), k [BH, D],
// v [BH, Dv]; m2 [BH, D*D, Dv] f32 (updated in place when `upd`);
// part [BH, nsplit, GT, Dv] f32. Each thread owns 4 consecutive columns
// (float4 loads and stores) of every `rpar`-th row of the block's range;
// the per-thread partial numerators are then summed over the row lanes in
// shared memory in a fixed order.
template <typename T, int GT>
__global__ void __launch_bounds__(kM2Threads)
decode_m2_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ m2,
                 float* __restrict__ part, int D, int Dv, int rows, int Gq,
                 int j0, bool upd) {
  extern __shared__ __align__(16) float smem[];
  const int tpr = Dv / 4;                 // threads per row
  const int rpar = kM2Threads / tpr;      // rows in flight per block
  float* sq = smem;                       // [GT, D]
  float* sk = sq + GT * D;                // [D]
  float* sred = sk + D + ((GT * D + D) & 3 ? 4 - ((GT * D + D) & 3) : 0);
  //                                         [rpar, GT, Dv], 16 B aligned
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  for (int i = tid; i < GT * D; i += blockDim.x)
    sq[i] = ld(q + ((size_t)bh * Gq + j0) * D + i);
  for (int i = tid; i < D; i += blockDim.x)
    sk[i] = ld(k + (size_t)bh * D + i);
  __syncthreads();

  const int c4 = 4 * (tid % tpr);
  const int rl = tid / tpr;
  float acc[GT][4];
#pragma unroll
  for (int g = 0; g < GT; ++g)
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  if (rl < rpar) {
    const float v0 = ld(v + (size_t)bh * Dv + c4);
    const float v1 = ld(v + (size_t)bh * Dv + c4 + 1);
    const float v2 = ld(v + (size_t)bh * Dv + c4 + 2);
    const float v3 = ld(v + (size_t)bh * Dv + c4 + 3);
    float* mb = m2 + (size_t)bh * D * D * Dv + c4;
    const int r1 = min((split + 1) * rows, D * D);
#pragma unroll 2
    for (int r = split * rows + rl; r < r1; r += rpar) {
      const int a = r / D, b = r - a * D;
      const float kk = sk[a] * sk[b];
      float4* p = reinterpret_cast<float4*>(mb + (size_t)r * Dv);
      float4 m = *p;
      if (upd) {
        m.x += kk * v0; m.y += kk * v1; m.z += kk * v2; m.w += kk * v3;
        *p = m;
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float y = sq[g * D + a] * sq[g * D + b];
        acc[g][0] += y * m.x; acc[g][1] += y * m.y;
        acc[g][2] += y * m.z; acc[g][3] += y * m.w;
      }
    }
    for (int g = 0; g < GT; ++g)
      *reinterpret_cast<float4*>(sred + ((size_t)rl * GT + g) * Dv + c4) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();
  for (int e = tid; e < GT * Dv; e += blockDim.x) {
    float s = 0.f;
    for (int l = 0; l < rpar; ++l) s += sred[(size_t)l * GT * Dv + e];
    part[((size_t)bh * nsplit + split) * GT * Dv + e] = s;
  }
}

// Small moments in place (when `upd`) + final combine of this group's GT
// queries. m0 [BH, Dv], m1 [BH, D, Dv], g0 [BH], g1 [BH, D], g2 [BH, D, D]
// (f32); q [BH, Gq, D] and o [BH, Gq, Dv], the group's at query j0.
template <typename T, int GT>
__global__ void decode_small_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    float* __restrict__ m0,
                                    float* __restrict__ m1,
                                    float* __restrict__ g0,
                                    float* __restrict__ g1,
                                    float* __restrict__ g2,
                                    const float* __restrict__ part,
                                    T* __restrict__ o,
                                    int D, int Dv, int p, int nsplit,
                                    float eps, int Gq, int j0, bool upd) {
  extern __shared__ float smem[];
  float* sq = smem;                 // [G, D]
  float* sk = sq + GT * D;          // [D]
  float* sred = sk + D;             // [G, blockDim]
  float* sden = sred + GT * blockDim.x;  // [G]
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < GT * D; i += blockDim.x)
    sq[i] = ld(q + ((size_t)bh * Gq + j0) * D + i);
  for (int i = tid; i < D; i += blockDim.x)
    sk[i] = ld(k + (size_t)bh * D + i);
  __syncthreads();

  // denominator: g-moments updated first, then contracted (per-thread
  // partials, reduced below in a fixed order)
  const float g0n = upd ? g0[bh] + 1.f : g0[bh];
  float dpart[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) dpart[g] = 0.f;
  for (int a = tid; a < D; a += blockDim.x) {
    const float x = upd ? g1[(size_t)bh * D + a] + sk[a]
                        : g1[(size_t)bh * D + a];
    if (upd) g1[(size_t)bh * D + a] = x;
#pragma unroll
    for (int g = 0; g < GT; ++g)
      dpart[g] += sq[g * D + a] * x;
  }
  if (p >= 2) {
    float* g2b = g2 + (size_t)bh * D * D;
    for (int e = tid; e < D * D; e += blockDim.x) {
      const int a = e / D, b = e - a * D;
      const float x = upd ? g2b[e] + sk[a] * sk[b] : g2b[e];
      if (upd) g2b[e] = x;
#pragma unroll
      for (int g = 0; g < GT; ++g)
        dpart[g] += 0.5f * sq[g * D + a] * x * sq[g * D + b];
    }
  }
#pragma unroll
  for (int g = 0; g < GT; ++g) sred[g * blockDim.x + tid] = dpart[g];
  __syncthreads();
  if (tid < GT) {
    float s = 0.f;
    for (int t = 0; t < (int)blockDim.x; ++t) s += sred[tid * blockDim.x + t];
    sden[tid] = g0n + s;
  }
  __syncthreads();
  if (tid == 0 && upd) g0[bh] = g0n;

  for (int j = tid; j < Dv; j += blockDim.x) {
    const float vj = ld(v + (size_t)bh * Dv + j);
    const float m0n = upd ? m0[(size_t)bh * Dv + j] + vj
                          : m0[(size_t)bh * Dv + j];
    if (upd) m0[(size_t)bh * Dv + j] = m0n;
    float num[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) num[g] = m0n;
    float* m1b = m1 + (size_t)bh * D * Dv + j;
    for (int a = 0; a < D; ++a) {
      const float x = upd ? m1b[(size_t)a * Dv] + sk[a] * vj
                          : m1b[(size_t)a * Dv];
      if (upd) m1b[(size_t)a * Dv] = x;
#pragma unroll
      for (int g = 0; g < GT; ++g)
        num[g] += sq[g * D + a] * x;
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float s2 = 0.f;
      for (int s = 0; s < nsplit; ++s)
        s2 += part[(((size_t)bh * nsplit + s) * GT + g) * Dv + j];
      const float n = num[g] + 0.5f * s2;
      st(o + ((size_t)bh * Gq + j0 + g) * Dv + j, n / (sden[g] + eps));
    }
  }
}

template <typename T, int GT>
int launch(const void* q, const void* k, const void* v, void* m0, void* m1,
           void* m2, void* g0, void* g1, void* g2, void* part, void* o,
           int bh, int D, int Dv, int p, int rows, float eps, int Gq,
           int j0, bool upd, cudaStream_t s) {
  int nsplit = 0;
  if (p >= 2) {
    nsplit = (D * D + rows - 1) / rows;
    const int rpar = kM2Threads / (Dv / 4);
    const size_t sm =
        sizeof(float) * (GT * D + D + 4 + (size_t)rpar * GT * Dv);
    cudaError_t err = cudaFuncSetAttribute(
        decode_m2_kernel<T, GT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sm);
    if (err != cudaSuccess) return (int)err;
    decode_m2_kernel<T, GT><<<dim3(nsplit, bh), kM2Threads, sm, s>>>(
        (const T*)q, (const T*)k, (const T*)v, (float*)m2, (float*)part, D,
        Dv, rows, Gq, j0, upd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t sm2 = sizeof(float) * (GT * D + D + GT * kThreads + GT);
  decode_small_kernel<T, GT><<<bh, kThreads, sm2, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (float*)m0, (float*)m1,
      (float*)g0, (float*)g1, (float*)g2, (const float*)part, (T*)o, D, Dv,
      p, nsplit, eps, Gq, j0, upd);
  return (int)cudaGetLastError();
}

// One group of GT = min(group, G - j0) queries at query j0 of each head.
template <typename T>
int launch_group(int GT, const void* q, const void* k, const void* v,
                 void* m0, void* m1, void* m2, void* g0, void* g1, void* g2,
                 void* part, void* o, int bh, int D, int Dv, int p, int rows,
                 float eps, int Gq, int j0, cudaStream_t s) {
#define ARGS q, k, v, m0, m1, m2, g0, g1, g2, part, o, bh, D, Dv, p, rows, \
             eps, Gq, j0, j0 == 0, s
  switch (GT) {
    case 1: return launch<T, 1>(ARGS);
    case 2: return launch<T, 2>(ARGS);
    case 3: return launch<T, 3>(ARGS);
    case 4: return launch<T, 4>(ARGS);
    case 5: return launch<T, 5>(ARGS);
    case 6: return launch<T, 6>(ARGS);
    case 7: return launch<T, 7>(ARGS);
    case 8: return launch<T, 8>(ARGS);
    case 9: return launch<T, 9>(ARGS);
    case 10: return launch<T, 10>(ARGS);
    case 11: return launch<T, 11>(ARGS);
    case 12: return launch<T, 12>(ARGS);
    case 13: return launch<T, 13>(ARGS);
    case 14: return launch<T, 14>(ARGS);
    case 15: return launch<T, 15>(ARGS);
    case 16: return launch<T, 16>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

template <typename T>
int launch_any_g(int G, int group, const void* q, const void* k,
                 const void* v, void* m0, void* m1, void* m2, void* g0,
                 void* g1, void* g2, void* part, void* o, int bh, int D,
                 int Dv, int p, int rows, float eps, cudaStream_t s) {
  for (int j0 = 0; j0 < G; j0 += group) {
    const int err = launch_group<T>(G - j0 < group ? G - j0 : group, q, k, v,
                                    m0, m1, m2, g0, g1, g2, part, o, bh, D,
                                    Dv, p, rows, eps, G, j0, s);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 inputs/output, 1 = bfloat16. State is always f32.
// rows: m2 rows a block of the first launch owns (>= 1); group: queries
// of one head per launch pair (1..kMaxG); part holds
// [bh, ceil(D*D / rows), min(G, group), Dv] f32.
int fastmax_decode_step(int dtype, const void* q, const void* k,
                        const void* v, void* m0, void* m1, void* m2,
                        void* g0, void* g1, void* g2, void* part, void* o,
                        int bh, int G, int D, int Dv, int p, int rows,
                        int group, float eps, void* stream) {
  if (G < 1 || Dv % 4 || Dv / 4 > kM2Threads || rows < 1 || group < 1 ||
      group > kMaxG)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_any_g<float>(G, group, q, k, v, m0, m1, m2, g0, g1, g2,
                               part, o, bh, D, Dv, p, rows, eps, s);
  return launch_any_g<__nv_bfloat16>(G, group, q, k, v, m0, m1, m2, g0, g1,
                                     g2, part, o, bh, D, Dv, p, rows, eps, s);
}

}  // extern "C"
