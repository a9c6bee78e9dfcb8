// Tensor-core helpers for Hopper (sm_90a; the instructions exist from
// sm_80), used by fastmax_noncausal.cu: TF32 rounding and the hi/lo split of
// a float32, the warp-level product `mma.sync.aligned.m16n8k8` with TF32
// operands and float32 accumulators, and `cp.async` copies from global into
// shared memory.
//
// Fragments of one m16n8k8 product D[16, 8] += A[16, 8] B[8, 8], per lane
// (g = lane >> 2, t = lane & 3):
//   A (row-major):    a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                     a3 (g + 8, t + 4)
//   B (column-major): b0 (t, g), b1 (t + 4, g)
//   C, D:             c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                     c3 (g + 8, 2t + 1)
//
// The split. tf32(x) keeps 10 stored mantissa bits (11 significant), rounded
// to nearest with ties away from zero (as `cvt.rna.tf32.f32`). For a
// float32 x, hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact) give
// x = hi + lo + e with |e| <= 2^-22 |x|; a product x y is then
// hi_x hi_y + hi_x lo_y + lo_x hi_y up to about 2^-21 |x y| (the dropped
// lo_x lo_y is 2^-22 of it). Every TF32 x TF32 product is exact in the
// tensor core, so these three passes ("3xTF32") come close to float32
// accuracy where one pass keeps 11 bits. A value with at most 11 significant
// bits (a bfloat16, with 8) is its own hi and has lo = 0; a product of two
// bfloat16 values has at most 16 and is exactly hi + lo.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// x rounded to TF32 as float32 bits: the rounding of `cvt.rna.tf32.f32`
// (to nearest, ties away from zero; the low 13 bits cleared), done as two
// integer operations on the bits, which ran faster on an H100 than the
// conversion instruction. Adding 0x1000 to the magnitude's bits rounds it
// half up (a carry may move into the exponent, as it should); finite inputs
// only.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// d += a b on the tensor cores: A 16 x 8, B 8 x 8, TF32; D float32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four elements from global into shared memory (16 bytes of float32 or 8 of
// bfloat16; both ends aligned to that size), asynchronously; zeros when
// `valid` is false (nothing is read then; `src` must still be a valid
// address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 8 : 0));
}
// One float32, asynchronously (4 bytes, aligned).
__device__ __forceinline__ void cp_async1(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits for this thread's copies; a __syncthreads() after it shows them to
// the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float f32_of(float x) { return x; }
__device__ __forceinline__ float f32_of(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// An A fragment of float32 values (a0..a3 above) split into TF32 hi and lo.
// With kExact the values have at most 22 significant bits (a product of two
// bfloat16 values has 16), so x - hi is already a TF32 value and is not
// rounded again.
template <bool kExact>
__device__ __forceinline__ void split_a(const float (&f)[4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kExact) {
      hi[i] = tf32_bits(f[i]);
      lo[i] = __float_as_uint(f[i] - __uint_as_float(hi[i]));
    } else {
      split_tf32(f[i], hi[i], lo[i]);
    }
  }
}

// B operands in fragment order. A row-major tile src [8 ksteps rows, 8 NT
// columns] (row stride `stride`, in shared memory) is rewritten so that lane
// `lane` of the warp that runs k step kk on n-tile j finds its b0, b1 at
// entry (kk NT + j) 32 + lane: one conflict-free vector load where the
// row-major tile would take two scalar loads (four with lo).
// `b_fragments_split` stores {hi(b0), hi(b1), lo(b0), lo(b1)};
// `b_fragments_exact` stores {b0, b1}, for
// values that are exact in TF32 (lo = 0: bfloat16). Each thread of the
// block (tid of nthr) writes its share; a __syncthreads() follows.
template <int NT, typename T>
__device__ __forceinline__ void b_fragments_split(float4* dst, const T* src,
                                                  int stride, int ksteps,
                                                  int tid, int nthr) {
  for (int i = tid; i < ksteps * NT * 32; i += nthr) {
    const int lane = i & 31, f = i >> 5, j = f % NT, kk = f / NT;
    const int r = 8 * kk + (lane & 3), c = 8 * j + (lane >> 2);
    uint32_t h0, l0, h1, l1;
    split_tf32(f32_of(src[r * stride + c]), h0, l0);
    split_tf32(f32_of(src[(r + 4) * stride + c]), h1, l1);
    dst[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                         __uint_as_float(l0), __uint_as_float(l1));
  }
}
template <int NT, typename T>
__device__ __forceinline__ void b_fragments_exact(float2* dst, const T* src,
                                                  int stride, int ksteps,
                                                  int tid, int nthr) {
  for (int i = tid; i < ksteps * NT * 32; i += nthr) {
    const int lane = i & 31, f = i >> 5, j = f % NT, kk = f / NT;
    const int r = 8 * kk + (lane & 3), c = 8 * j + (lane >> 2);
    dst[i] = make_float2(f32_of(src[r * stride + c]),
                         f32_of(src[(r + 4) * stride + c]));
  }
}

// Four consecutive elements from shared memory as float32 (16-byte aligned
// for float32, 8 for bfloat16).
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
