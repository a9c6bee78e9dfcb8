// Causal fastmax prefill, and the hybrid near/far-field forward, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels `fastmax_causal_pallas`
// (src/repro/kernels/fastmax_causal.py, body `_causal_kernel`), in its
// prefill form (`return_state=True`, optional `init_state`, `kv_mask`), and
// `hybrid_causal_pallas` (src/repro/kernels/hybrid_causal.py, body
// `_hybrid_kernel`, with `kv_mask` and `return_state`; no init_state, as
// there).
//
// What it computes, per (batch, kv-head) bh with G grouped query heads, on
// pre-normalized q [N, D] per query head, k [N, D], v [N, Dv] and key
// weights w [N] (the kv_mask), for every query position i:
//   num_i = sum_{j <= i} f(q_i.k_j) w_j v_j,  den_i = sum_{j <= i} f w_j,
//   f(s) = 1 + s + s^2/2 (p = 2) or 1 + s (p = 1), o_i = num_i/(den_i+eps),
// plus the moments of tokens folded before the call (`init_state`), and
// the final carry (m0, m1, m2, g0, g1, g2 as in core/fastmax.py) as the
// state output, m2 in the m-major [D*D, Dv] layout the decode kernel reads.
// The hybrid (w_eff >= 1) weighs the pairs of its band, 0 <= i - j < w_eff,
// exp(s) instead of f(s): the reference's unshifted exp, no max shift and
// no clamp (it overflows float32 above s = 88.72 there as here). Its carry
// is the same moment carry: the band holds none.
//
// What bounds it on an H100: arithmetic. Factorized over feature rows, the
// function needs about 2(G+1) * N * R * (Dv+1) operations per bh (the
// moments and the queries' contraction, R = D(D+1)/2 + D + 1 rows since
// m2, g2 and q_a q_b are symmetric) plus the causal pairs inside chunks
// of 64 tokens (a fixed count, not this kernel's L): 2.14e11 at qwen3's
// shapes (B=4, Hq=16, Hkv=8, N=1024, D=Dv=128), 0.216 ms at the bf16
// tensor-core peak and 3.19 ms at the f32 CUDA-core peak, against
// ~0.07 ms for its bytes. The hybrid adds 2G(D + Dv) for each band pair
// that lies before its query's chunk of 64 (a band pair inside it is one
// of the causal pairs already): 2.15e11, 0.217 ms at w_eff = 64. This
// version runs both as f32 FMAs on the CUDA cores (tensor cores, wgmma
// and TMA are later work), so the f32 figure is its practical floor.
//
// Design: the moment scan is a prefix sum, so its sequential chunk loop
// splits into two launches that run in parallel across the card, the
// noncausal kernel's pair (fastmax_noncausal.cu) with a chunk boundary.
// Both work on one table of feature rows: row 0 the constant 1 (m0, g0),
// rows 1..D the linear features x_a (m1, g1), then at p = 2 one row per
// pair a <= b, x_a x_b (m2, g2); R = 1 + D + D(D+1)/2 rows, 8385 at
// D = 128. The g column (the key weights' sum) rides beside v.
//   * Launch A, `prefix_moments_kernel`: one block per (64 feature rows x
//     64 value columns tile, bh): 132 x 2 x 32 = 8448 blocks at qwen3's
//     shapes. It seeds its register tile from init_state (the pair rows
//     with the symmetric half, (init[ab] + init[ba]) / 2) and streams the
//     keys 32 at a time through shared memory, weighted by w (thread
//     (ty, tx) owns rows 4ty..4ty+3 and columns 4tx..4tx+3: 16 FMAs per two
//     float4 shared-memory loads). At every chunk boundary of L = 128 keys
//     it writes the tile, before folding that chunk, to slot c of a
//     workspace (m [n/L, BH, R, Dv] f32 and g [n/L, BH, R] f64): slot c is
//     the carry before chunk c. After the last key it writes the final
//     carry into the state outputs, rows a*D+b and b*D+a of m2 (each adding
//     back its own half of init[ab] - init[ba], so a non-symmetric
//     init_state comes out as the sequential scan emits it) and both halves
//     of g2, and the g column in f64 into `gout`.
//   * Launch B, `causal_combine_kernel`: one block per (64 query rows of
//     chunk c's G*len rows, c, bh). It walks slot c's R rows in tiles of
//     32 from L2, builds the queries' features (pair rows weighted 1, the
//     diagonal 1/2) and accumulates the 64 x 128 output tile in registers
//     (4 x 8 a thread; 64 x 64 at Dv <= 64), so the features are built
//     once for all of Dv = 128; then it adds the chunk's own keys exactly,
//     32 at a time: s = q.k, f(s) w_j where key j <= the query's position,
//     as the same tiled product against the chunk's v. A wider Dv loops
//     over column blocks; the denominator is summed in the first, in a
//     fixed order.
//   * The hybrid's launch B, `causal_combine_kernel<..., kBand = true>`
//     (launch A is the same): a chunk [t0, t0 + len) whose band reaches
//     past its start (t0 >= w_eff) takes slot c, weighs its own band pairs
//     exp(s) in the in-chunk term, pair by pair, and adds
//     (exp(s) - f(s)) w_j for the keys j in [t0 - w_eff + 1, t0) within
//     w_eff of the query: loaded 32 at a time from k, v, w by absolute
//     position (an earlier segment's keys alike), as many tiles as the
//     band needs. A chunk whose band reaches token 0 (t0 < w_eff: it holds
//     the rows i < w_eff, whose every key is in the band) takes no slot and
//     sums every key from token 0 pair by pair, exp in the band and f
//     outside it, so band-only rows never form sum f + sum (exp - f),
//     which cancels in float32 (the reference does; ROADMAP queue 3). The
//     denominator takes the same terms in A. The prefill's instantiation
//     (kBand = false) compiles to the code it had: its outputs are
//     bit-identical.
// Nothing is carried between blocks, the m2 work is on the D(D+1)/2
// symmetric rows only, and every sum runs in a fixed order (no float
// atomics): two calls give the same bits. The ragged edges (N not a
// multiple of L or 32, N < L, N = 1) are masked in the kernels, with no
// padded copy. Requires D % 4 == 0, Dv % 4 == 0, D <= 255 (checked by the
// wrapper and here).
//
// The denominator at p = 1 is summed in float64 (the accumulator type A):
// the g column's moments (from exact products of the f32 keys), the
// queries' features against them and the chunk's own scores. There
// f(s) = 1 + s is sign-indefinite and a row's denominator can cancel to
// near 0, where any f32 order leaves an error of eps * sum |terms| that
// 1 / den amplifies; in f64 the f32 numerator's own rounding is what
// remains. At p = 2, f(s) = (1 + s)^2 / 2 + 1/2 >= 1/2 cannot cancel, and
// A = float: there f64 is not needed, and its registers (111 a thread in
// the prefix launch against 63) would cost occupancy. The g slots and the
// g carry are f64 at either p.
//
// Segments: the wrapper bounds the workspace by running the two launches
// over segments [t_begin, t_begin + n) of the N tokens, each seeded with
// the last one's final carry (its state outputs, read and rewritten in
// place, every element by the thread that owns it, and `gin`/`gout`, the
// g column in f64, so the p = 1 denominator is not rounded between
// segments). The hybrid's slotless chunks (t0 < w_eff) lie in the first
// segment: the wrapper checks it.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "feature_table.cuh"

namespace {

constexpr int kL = 128;      // the chunk L: keys per workspace slot

// The band's weight: the reference's unshifted exp (no max shift, no
// clamp), in the accumulator type.
__device__ __forceinline__ float band_exp(float x) { return expf(x); }
__device__ __forceinline__ double band_exp(double x) { return exp(x); }

// ---------------------------------------------------------------------------
// Launch A, over tokens [t0, t0 + n) of N. k [BH, N, D], v [BH, N, Dv],
// w [BH, N] (f32); init (m0 null: a zero carry) and out in the state
// layout: m0 [BH, Dv], m1 [BH, D, Dv], m2 [BH, D*D, Dv], g0 [BH],
// g1 [BH, D], g2 [BH, D, D] (f32); init may be out (a segment's seed).
// gin (null: the g seed from init) and gout: the g column, [BH, R] f64.
// wsm [nc, BH, R, Dv] f32, wsg [nc, BH, R] f64, nc = ceil(n / L).
// A: the g column's accumulator. grid (row tiles * column blocks, BH).
// ---------------------------------------------------------------------------
template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
prefix_moments_kernel(const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ w, State init, State out,
                      const double* gin, double* gout,
                      float* __restrict__ wsm, double* __restrict__ wsg,
                      int N, int t_begin, int n, int D, int Dv, int p) {
  __shared__ __align__(16) float sT[kChunk * kTile];   // features x w
  __shared__ __align__(16) float sV[kChunk * kCols];
  __shared__ A sG[kThreads];                           // g partials
  __shared__ float sW[kChunk];
  __shared__ int sCode[kTile];
  extern __shared__ float sK[];                        // [kChunk, D + 1]
  const int KS = D + 1;  // padded: conflict-free reads of one key's entries
  const int R = n_rows(D, p);
  const int ncb = (Dv + kCols - 1) / kCols;
  const int tile = blockIdx.x / ncb, cb = blockIdx.x - tile * ncb;
  const int r0 = tile * kTile, c0 = cb * kCols;
  const int bh = blockIdx.y, BH = gridDim.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int myrow = tid & (kTile - 1);   // the row this thread builds
  const int cq = c0 + 4 * tx;            // this thread's 4 columns
  const bool has_init = init.m0 != nullptr;
  if (tid < kTile) sCode[tid] = row_code(r0 + tid, D, R);
  __syncthreads();
  const int mycode = sCode[myrow];

  // seed: the init carry, pair rows with the symmetric half
  float acc[4][4];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    const int c = sCode[4 * ty + ri];
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (has_init && c >= 0 && cq < Dv) {
      size_t mo, go;
      long mt, gt;
      state_offsets(c, bh, D, Dv, &mo, &go, &mt, &gt);
      x = ld4(init.m(c) + mo + cq);
      if (mt >= 0) {
        const float4 y = ld4(init.m2 + mt + cq);
        x = make_float4(0.5f * (x.x + y.x), 0.5f * (x.y + y.y),
                        0.5f * (x.z + y.z), 0.5f * (x.w + y.w));
      }
    }
    acc[ri][0] = x.x; acc[ri][1] = x.y; acc[ri][2] = x.z; acc[ri][3] = x.w;
  }
  constexpr bool kF64 = std::is_same<A, double>::value;
  A gseed = A(0);   // the g seed of row `tid` (tid < kTile, cb == 0)
  if (cb == 0 && tid < kTile && mycode >= 0) {
    if (gin != nullptr) {
      gseed = (A)gin[(size_t)bh * R + r0 + tid];
    } else if (has_init) {
      size_t mo, go;
      long mt, gt;
      state_offsets(mycode, bh, D, Dv, &mo, &go, &mt, &gt);
      gseed = (A)init.g(mycode)[go];
      if (gt >= 0) gseed = A(0.5) * (gseed + (A)init.g2[gt]);
    }
  }
  A gp = A(0);
  const T* kb = k + ((size_t)bh * N + t_begin) * D;
  const T* vb = v + ((size_t)bh * N + t_begin) * Dv;
  const float* wb = w + (size_t)bh * N + t_begin;

  // the g column of the tile (cb == 0 only): the 4 partials in order
  auto g_total = [&]() -> A {
    sG[tid] = gp;
    __syncthreads();
    A s = gseed;
    if (tid < kTile)
      for (int l = 0; l < kThreads / kTile; ++l) s += sG[l * kTile + tid];
    return s;
  };

  for (int t0 = 0; t0 < n; t0 += kChunk) {
    if (t0 % kL == 0) {
      // slot t0 / L: the carry before this chunk
      const size_t slot = (size_t)(t0 / kL) * BH + bh;
      if (cq < Dv) {
#pragma unroll
        for (int ri = 0; ri < 4; ++ri) {
          const int r = r0 + 4 * ty + ri;
          if (r < R)
            *reinterpret_cast<float4*>(wsm + (slot * R + r) * Dv + cq) =
                make_float4(acc[ri][0], acc[ri][1], acc[ri][2], acc[ri][3]);
        }
      }
      if (cb == 0) {
        const A s = g_total();
        if (tid < kTile && r0 + tid < R) wsg[slot * R + r0 + tid] = s;
      }
    }
    const int len = min(kChunk, n - t0);
    for (int e = tid; e < kChunk * D; e += kThreads) {
      const int t = e / D, a = e - t * D;
      sK[t * KS + a] = t < len ? ld(kb + (size_t)(t0 + t) * D + a) : 0.f;
    }
    for (int e = tid; e < kChunk * kCols; e += kThreads) {
      const int t = e / kCols, c = e - t * kCols, cc = c0 + c;
      sV[e] = (t < len && cc < Dv) ? ld(vb + (size_t)(t0 + t) * Dv + cc)
                                   : 0.f;
    }
    if (tid < kChunk) sW[tid] = tid < len ? wb[t0 + tid] : 0.f;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kChunk / (kThreads / kTile); ++i) {
      const int t = (tid / kTile) + (kThreads / kTile) * i;
      const bool on = t < len && mycode >= 0;
      const float f = on ? feature(mycode, sK + t * KS) * sW[t] : 0.f;
      sT[t * kTile + myrow] = f;
      if constexpr (kF64) {
        if (cb == 0 && on)
          gp += feature64(mycode, sK + t * KS) * (double)sW[t];
      } else {
        gp += f;
      }
    }
    __syncthreads();
    moment_tile(acc, sT, sV, len, ty, tx);
    __syncthreads();
  }

  // the final carry: m rows (both halves of a pair), then the g column
  if (cq < Dv) {
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const int c = sCode[4 * ty + ri];
      if (c < 0) continue;
      size_t mo, go;
      long mt, gt;
      state_offsets(c, bh, D, Dv, &mo, &go, &mt, &gt);
      float4 x = make_float4(acc[ri][0], acc[ri][1], acc[ri][2], acc[ri][3]);
      if (mt < 0) {
        *reinterpret_cast<float4*>(out.m(c) + mo + cq) = x;
        continue;
      }
      float4 hd = make_float4(0.f, 0.f, 0.f, 0.f);  // (init[ab]-init[ba])/2
      if (has_init) {
        const float4 ia = ld4(init.m2 + mo + cq), ib = ld4(init.m2 + mt + cq);
        hd = make_float4(0.5f * (ia.x - ib.x), 0.5f * (ia.y - ib.y),
                         0.5f * (ia.z - ib.z), 0.5f * (ia.w - ib.w));
      }
      *reinterpret_cast<float4*>(out.m2 + mo + cq) =
          make_float4(x.x + hd.x, x.y + hd.y, x.z + hd.z, x.w + hd.w);
      *reinterpret_cast<float4*>(out.m2 + mt + cq) =
          make_float4(x.x - hd.x, x.y - hd.y, x.z - hd.z, x.w - hd.w);
    }
  }
  if (cb == 0) {
    const double s = g_total();   // f64 from here: the carry and the state
    if (tid < kTile && mycode >= 0) {
      size_t mo, go;
      long mt, gt;
      state_offsets(mycode, bh, D, Dv, &mo, &go, &mt, &gt);
      if (gt < 0) {
        out.g(mycode)[go] = (float)s;
      } else {
        const double hd =
            has_init ? 0.5 * ((double)init.g2[go] - (double)init.g2[gt])
                     : 0.0;
        out.g2[go] = (float)(s + hd);
        out.g2[gt] = (float)(s - hd);
      }
      gout[(size_t)bh * R + r0 + tid] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch B, over tokens [t_begin, t_begin + n) of N. q [BH*G, N, D], k, v,
// w as launch A; o [BH*G, N, Dv]. grid (ceil(G*L / 64), nc, BH). A pass
// takes NCG groups of 64 value columns: thread (ty, tx) owns columns
// c0 + 64 j + 4tx..4tx+3 of group j. A: the denominator's accumulator.
// ---------------------------------------------------------------------------
__host__ __device__ inline int combine_smem_floats(int D, int ncg) {
  return kChunk * kCols * ncg + kChunk * kPS + kTile * (D + 1) + kTile +
         kChunk * (D + 1) + kChunk;
}

template <typename T, int NCG, typename A, bool kBand>
__global__ void __launch_bounds__(kThreads)
causal_combine_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ wsm,
                      const double* __restrict__ wsg, T* __restrict__ o,
                      int G, int N, int t_begin, int n, int D, int Dv, int p,
                      int w_eff, float eps) {
  constexpr int BC = kCols * NCG;     // block's columns per pass
  constexpr bool kF64 = std::is_same<A, double>::value;
  // the den partials reuse sM and sP (contiguous) once both are consumed
  static_assert(kChunk * (BC + kPS) * sizeof(float) >=
                kChunk * kTile * sizeof(A), "den partials overflow");
  extern __shared__ __align__(16) float smem[];
  float* sM = smem;                   // [32, BC] moment rows, then v rows
  float* sP = sM + kChunk * BC;       // [32, kPS] query features / f(s) w
  float* sQ = sP + kChunk * kPS;      // [64, D + 1] queries
  float* sDen = sQ + kTile * (D + 1); // [64]
  float* sK = sDen + kTile;           // [32, D + 1] the chunk's keys
  float* sW = sK + kChunk * (D + 1);  // [32]
  A* sRed = reinterpret_cast<A*>(sM);  // [32, 64] den partials
  __shared__ int sPos[kTile];         // query position in the chunk, or -1
  const int QS = D + 1;
  const int R = n_rows(D, p);
  const int c = blockIdx.y, bh = blockIdx.z, BH = gridDim.z;
  const int t0 = t_begin + c * kL, len = min(kL, n - c * kL), GL = G * len;
  const int qr0 = blockIdx.x * kTile;
  if (qr0 >= GL) return;              // the last chunk's spare blocks
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rl = tid >> 3;            // the moment row / key this thread loads
  const int l8 = tid & 7;
  const size_t slot = (size_t)c * BH + bh;
  const float* ms = wsm + slot * R * Dv;
  const double* gs = wsg + slot * R;
  const T* kb = k + ((size_t)bh * N + t0) * D;
  const T* vb = v + ((size_t)bh * N + t0) * Dv;
  const float* wb = w + (size_t)bh * N + t0;
  // the band's chunks that reach token 0 take no slot (see the header)
  const bool slot_on = !kBand || t0 >= w_eff;

  for (int e = tid; e < kTile * D; e += kThreads) {
    const int r = e / D, a = e - r * D, qr = qr0 + r;
    float x = 0.f;
    if (qr < GL) {
      const int g = qr / len, i = qr - g * len;
      x = ld(q + (((size_t)bh * G + g) * N + t0 + i) * D + a);
    }
    sQ[r * QS + a] = x;
  }
  if (tid < kTile) {
    const int qr = qr0 + tid;
    sPos[tid] = qr < GL ? qr % len : -1;
  }
  __syncthreads();

  const int ncb = (Dv + BC - 1) / BC;
  for (int cb = 0; cb < ncb; ++cb) {
    const int c0 = cb * BC;
    float acc[4][4 * NCG];
#pragma unroll
    for (int ri = 0; ri < 4; ++ri)
#pragma unroll
      for (int ci = 0; ci < 4 * NCG; ++ci) acc[ri][ci] = 0.f;
    A dp[kTile / 8];   // den partials (cb == 0)
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) dp[i] = A(0);

    // the 32 x BC tile product shared by every term
    auto accumulate = [&]() { tile_product<NCG>(acc, sP, sM, BC, ty, tx); };
    // keys [j0, j0 + jn) of kp, vp, wp (jn <= 32) into sK, sM (their v
    // columns of this pass) and sW
    auto load_keys = [&](const T* kp, const T* vp, const float* wp, int j0,
                         int jn) {
      for (int e = tid; e < kChunk * D; e += kThreads) {
        const int t = e / D, a = e - t * D;
        sK[t * QS + a] = t < jn ? ld(kp + (size_t)(j0 + t) * D + a) : 0.f;
      }
      for (int e = tid; e < kChunk * BC; e += kThreads) {
        const int t = e / BC, cc = c0 + e - t * BC;
        sM[e] = (t < jn && cc < Dv) ? ld(vp + (size_t)(j0 + t) * Dv + cc)
                                    : 0.f;
      }
      if (tid < kChunk) sW[tid] = tid < jn ? wp[j0 + tid] : 0.f;
    };
    // the scores (the den's terms) in A of key rl with queries l8 + 8 i
    auto scores = [&](A (&s)[kTile / 8]) {
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i) s[i] = A(0);
      for (int a = 0; a < D; ++a) {
        const A ka = sK[rl * QS + a];
#pragma unroll
        for (int i = 0; i < kTile / 8; ++i)
          s[i] += (A)sQ[(l8 + 8 * i) * QS + a] * ka;
      }
    };

    // inter: the carry before chunk c (slot c), feature row by row
    for (int r0 = 0; slot_on && r0 < R; r0 += kChunk) {
      const int r = r0 + rl;
      const int code = row_code(r, D, R);
#pragma unroll
      for (int j = 0; j < BC / 32; ++j) {
        const int cc = 4 * l8 + 32 * j;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (code >= 0 && c0 + cc < Dv) x = ld4(ms + (size_t)r * Dv + c0 + cc);
        *reinterpret_cast<float4*>(sM + rl * BC + cc) = x;
      }
      const float wr = code >= 0 ? row_weight(code) : 0.f;
      const A gv = (cb == 0 && code >= 0) ? (A)gs[r] : A(0);
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i) {
        const int qi = l8 + 8 * i;
        const float f = code >= 0 ? wr * feature(code, sQ + qi * QS) : 0.f;
        sP[rl * kPS + qi] = f;
        if constexpr (kF64) {
          if (cb == 0 && code >= 0)
            dp[i] += (double)wr * feature64(code, sQ + qi * QS) *
                     gv;
        } else {
          dp[i] += f * gv;
        }
      }
      __syncthreads();
      accumulate();
      __syncthreads();
    }

    // band: the keys before the chunk within w_eff of a query, by
    // absolute position (they may lie in an earlier segment): (exp - f)
    // on top of the slot's f, or, where the band reaches token 0 (no
    // slot), every key from token 0, exp in the band and f outside it
    if constexpr (kBand) {
      const T* kB = k + (size_t)bh * N * D;
      const T* vB = v + (size_t)bh * N * Dv;
      const float* wB = w + (size_t)bh * N;
      for (int j0 = slot_on ? t0 - w_eff + 1 : 0; j0 < t0; j0 += kChunk) {
        const int jn = min(kChunk, t0 - j0);
        load_keys(kB, vB, wB, j0, jn);
        __syncthreads();
        A s[kTile / 8];
        scores(s);
#pragma unroll
        for (int i = 0; i < kTile / 8; ++i) {
          const int qi = l8 + 8 * i;
          A f = A(0);
          if (rl < jn && sPos[qi] >= 0) {
            const bool in_band = t0 + sPos[qi] - (j0 + rl) < w_eff;
            A fs = A(1) + s[i];
            if (p >= 2) fs += A(0.5) * s[i] * s[i];
            if (in_band)
              f = slot_on ? band_exp(s[i]) - fs : band_exp(s[i]);
            else if (!slot_on)
              f = fs;
            f *= (A)sW[rl];
          }
          sP[rl * kPS + qi] = (float)f;
          if (cb == 0) dp[i] += f;
        }
        __syncthreads();
        accumulate();
        __syncthreads();
      }
    }

    // intra: the chunk's own keys j <= the query's position, exactly (in
    // the band weighed exp(s), pair by pair)
    for (int j0 = 0; j0 < len; j0 += kChunk) {
      const int jn = min(kChunk, len - j0);
      load_keys(kb, vb, wb, j0, jn);
      __syncthreads();
      const int j = j0 + rl;
      A s[kTile / 8];
      scores(s);
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i) {
        const int qi = l8 + 8 * i;
        A f = A(0);
        if (rl < jn && j <= sPos[qi]) {
          if (kBand && sPos[qi] - j < w_eff) {
            f = band_exp(s[i]);
          } else {
            f = A(1) + s[i];
            if (p >= 2) f += A(0.5) * s[i] * s[i];
          }
          f *= (A)sW[rl];
        }
        sP[rl * kPS + qi] = (float)f;
        if (cb == 0) dp[i] += f;
      }
      __syncthreads();
      accumulate();
      __syncthreads();
    }

    if (cb == 0) {
      // den per query row: the 32 row-lanes' partials in a fixed order
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i)
        sRed[rl * kTile + l8 + 8 * i] = dp[i];
      __syncthreads();
      if (tid < kTile) {
        A sum = A(0);
        for (int l = 0; l < kChunk; ++l) sum += sRed[l * kTile + tid];
        sDen[tid] = (float)(sum + (A)eps);
      }
      __syncthreads();
    }
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const int r = 4 * ty + ri, qr = qr0 + r;
      if (qr >= GL) continue;
      const int g = qr / len, i = qr - g * len;
      T* orow = o + (((size_t)bh * G + g) * N + t0 + i) * Dv;
      const float den = sDen[r];
#pragma unroll
      for (int j = 0; j < NCG; ++j) {
        const int cq = c0 + kCols * j + 4 * tx;
        if (cq < Dv)
#pragma unroll
          for (int ci = 0; ci < 4; ++ci)
            st(orow + cq + ci, acc[ri][4 * j + ci] / den);
      }
    }
    __syncthreads();   // sM, sP (and sRed in them) are reused next pass
  }
}

template <typename T, typename A>
int launch_prefix(const void* k, const void* v, const void* w,
                  const State& init, const State& out, const void* gin,
                  void* gout, void* wsm, void* wsg, int bh, int N,
                  int t_begin, int n, int D, int Dv, int p, cudaStream_t s) {
  const int R = n_rows(D, p);
  const dim3 grid(((R + kTile - 1) / kTile) * ((Dv + kCols - 1) / kCols), bh);
  const size_t sm = sizeof(float) * kChunk * (D + 1);
  cudaError_t err = cudaFuncSetAttribute(
      prefix_moments_kernel<T, A>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  if (err != cudaSuccess) return (int)err;
  prefix_moments_kernel<T, A><<<grid, kThreads, sm, s>>>(
      (const T*)k, (const T*)v, (const float*)w, init, out,
      (const double*)gin, (double*)gout, (float*)wsm, (double*)wsg, N,
      t_begin, n, D, Dv, p);
  return (int)cudaGetLastError();
}

template <typename T, int NCG, typename A, bool kBand>
int launch_combine(const void* q, const void* k, const void* v,
                   const void* w, const void* wsm, const void* wsg, void* o,
                   int bh, int G, int N, int t_begin, int n, int D, int Dv,
                   int p, int w_eff, float eps, cudaStream_t s) {
  const size_t sm = sizeof(float) * combine_smem_floats(D, NCG);
  cudaError_t err = cudaFuncSetAttribute(
      causal_combine_kernel<T, NCG, A, kBand>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  if (err != cudaSuccess) return (int)err;
  const int nc = (n + kL - 1) / kL;
  const dim3 grid((G * kL + kTile - 1) / kTile, nc, bh);
  causal_combine_kernel<T, NCG, A, kBand><<<grid, kThreads, sm, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)w,
      (const float*)wsm, (const double*)wsg, (T*)o, G, N, t_begin, n, D, Dv,
      p, w_eff, eps);
  return (int)cudaGetLastError();
}

// Launch B's instantiation by the column groups of a pass, ncg (the
// caller's: 1 or 2, checked by combine_dispatch).
template <typename T, typename A, bool kBand>
int combine_of(int ncg, const void* q, const void* k, const void* v,
               const void* w, const void* wsm, const void* wsg, void* o,
               int bh, int G, int N, int t_begin, int n, int D, int Dv, int p,
               int w_eff, float eps, cudaStream_t s) {
  if (ncg == 2)
    return launch_combine<T, 2, A, kBand>(q, k, v, w, wsm, wsg, o, bh, G, N,
                                          t_begin, n, D, Dv, p, w_eff, eps,
                                          s);
  return launch_combine<T, 1, A, kBand>(q, k, v, w, wsm, wsg, o, bh, G, N,
                                        t_begin, n, D, Dv, p, w_eff, eps, s);
}

bool dims_ok(int bh, int G, int N, int t_begin, int n, int D, int Dv,
             int p) {
  return bh >= 1 && G >= 1 && n >= 1 && t_begin >= 0 && t_begin <= N - n &&
         D >= 4 && D % 4 == 0 && D <= 255 && Dv >= 4 && Dv % 4 == 0 &&
         (p == 1 || p == 2) && (n + kL - 1) / kL <= 65535 && bh <= 65535;
}

State state_of(const void* m0, const void* m1, const void* m2,
               const void* g0, const void* g1, const void* g2) {
  return State{(float*)m0, (float*)m1, (float*)m2,
               (float*)g0, (float*)g1, (float*)g2};
}

// Launch B by dtype (0 = float32 q/k/v/o, 1 = bfloat16) and p: the
// denominator in f64 at p = 1 (see the header), f32 at p = 2. ncg: the
// column groups of a pass, 1, or 2 where Dv > 64 (a second group past Dv
// would only compute padding).
template <bool kBand>
int combine_dispatch(int dtype, const void* q, const void* k, const void* v,
                     const void* w, const void* wsm, const void* wsg, void* o,
                     int bh, int G, int N, int t_begin, int n, int D, int Dv,
                     int p, int w_eff, int ncg, float eps, void* stream) {
  if (!dims_ok(bh, G, N, t_begin, n, D, Dv, p) || ncg < 1 || ncg > 2 ||
      (ncg - 1) * kCols >= Dv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return p == 1 ? combine_of<float, double, kBand>(
                        ncg, q, k, v, w, wsm, wsg, o, bh, G, N, t_begin, n, D,
                        Dv, p, w_eff, eps, s)
                  : combine_of<float, float, kBand>(
                        ncg, q, k, v, w, wsm, wsg, o, bh, G, N, t_begin, n, D,
                        Dv, p, w_eff, eps, s);
  return p == 1 ? combine_of<__nv_bfloat16, double, kBand>(
                      ncg, q, k, v, w, wsm, wsg, o, bh, G, N, t_begin, n, D,
                      Dv, p, w_eff, eps, s)
                : combine_of<__nv_bfloat16, float, kBand>(
                      ncg, q, k, v, w, wsm, wsg, o, bh, G, N, t_begin, n, D,
                      Dv, p, w_eff, eps, s);
}

}  // namespace

extern "C" {

// Launch A alone, over tokens [t_begin, t_begin + n) of N. dtype: 0 =
// float32 k/v, 1 = bfloat16. w, init and the state outputs are f32; null
// init pointers give a zero carry, and init may be the outputs (the last
// segment's carry). gin (null: the g seed from init) and gout: the g
// column [bh, R] in f64. wsm: [ceil(n/L), bh, R, Dv] f32, wsg:
// [ceil(n/L), bh, R] f64. At p = 1 the m2 and g2 outputs are not written
// (the wrapper zeroes them).
int fastmax_causal_prefix(int dtype, const void* k, const void* v,
                          const void* w, const void* i0, const void* i1,
                          const void* i2, const void* j0, const void* j1,
                          const void* j2, void* m0o, void* m1o, void* m2o,
                          void* g0o, void* g1o, void* g2o, const void* gin,
                          void* gout, void* wsm, void* wsg, int bh, int N,
                          int t_begin, int n, int D, int Dv, int p,
                          void* stream) {
  if (!dims_ok(bh, 1, N, t_begin, n, D, Dv, p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const State init = state_of(i0, i1, i2, j0, j1, j2);
  const State out = state_of(m0o, m1o, m2o, g0o, g1o, g2o);
  // the g column in f64 at p = 1 (see the header), f32 at p = 2
  if (dtype == 0)
    return p == 1 ? launch_prefix<float, double>(k, v, w, init, out, gin,
                                                 gout, wsm, wsg, bh, N,
                                                 t_begin, n, D, Dv, p, s)
                  : launch_prefix<float, float>(k, v, w, init, out, gin,
                                                gout, wsm, wsg, bh, N,
                                                t_begin, n, D, Dv, p, s);
  return p == 1 ? launch_prefix<__nv_bfloat16, double>(
                      k, v, w, init, out, gin, gout, wsm, wsg, bh, N,
                      t_begin, n, D, Dv, p, s)
                : launch_prefix<__nv_bfloat16, float>(
                      k, v, w, init, out, gin, gout, wsm, wsg, bh, N,
                      t_begin, n, D, Dv, p, s);
}

// Launch B alone, on the workspace launch A wrote for the same tokens
// [t_begin, t_begin + n) of N. dtype as above (q, k, v and o); ncg the
// column groups of a pass (64 value columns each).
int fastmax_causal_combine(int dtype, const void* q, const void* k,
                           const void* v, const void* w, const void* wsm,
                           const void* wsg, void* o, int bh, int G, int N,
                           int t_begin, int n, int D, int Dv, int p, int ncg,
                           float eps, void* stream) {
  return combine_dispatch<false>(dtype, q, k, v, w, wsm, wsg, o, bh, G, N,
                                 t_begin, n, D, Dv, p, 0, ncg, eps, stream);
}

// The hybrid's launch B: launch B with the band of w_eff >= 1 tokens (the
// diagonal included). A chunk whose band reaches token 0 (t0 < w_eff)
// reads no slot and keys from token 0: the wrapper runs those chunks in
// the first segment.
int hybrid_causal_combine(int dtype, const void* q, const void* k,
                          const void* v, const void* w, const void* wsm,
                          const void* wsg, void* o, int bh, int G, int N,
                          int t_begin, int n, int D, int Dv, int p,
                          int w_eff, int ncg, float eps, void* stream) {
  if (w_eff < 1) return (int)cudaErrorInvalidValue;
  return combine_dispatch<true>(dtype, q, k, v, w, wsm, wsg, o, bh, G, N,
                                t_begin, n, D, Dv, p, w_eff, ncg, eps,
                                stream);
}

}  // extern "C"
