// Causal fastmax backward (paper §2.5) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `fastmax_causal_bwd_pallas`
// (src/repro/kernels/fastmax_causal_bwd.py, body `_causal_bwd_kernel`).
//
// What it computes, per (batch, kv-head) bh with G grouped query heads, from
// the residual (q, k, v, the forward's FINAL moment carry) and the output
// cotangent do, on the feature table of feature_table.cuh (R rows φ_r, the
// combine's weights wt_r: 1, 1/2 on the diagonal pairs), in chunks of L =
// 128 tokens:
//   M_c = the carry before chunk c (R x (Dv + 1): m rows beside the g
//         column), rebuilt reversibly as final - sum_{chunks >= c} delta_k
//         (core/fastmax.py's carry_before = carry_after - delta);
//   per query i of chunk c: num_i, den_i against M_c plus the chunk's own
//         keys exactly, u_i = do_i / (den_i + eps), sden_i = -o_i . u_i;
//   dq_i = J_φ(q_i)^T (wt . M_c [u_i; sden_i])
//          + sum_{j <= i in the chunk} f'(s_ij) (u_i.v_j + sden_i) k_j;
//   Z_c = sum over queries i of chunks > c of φ(q_i) [u_i | sden_i] (the
//         cotangent of the carry after chunk c);
//   per key j of chunk c:
//     dv_j = (wt . φ(k_j))^T Z_c[:, :Dv] + sum_{i >= j, all G heads}
//            f(s_ij) u_i,
//     dk_j = J_φ(k_j)^T (wt . Z_c [v_j; 1])
//            + sum_{i >= j} f'(s_ij) (u_i.v_j + sden_i) q_i;
//   and, with the cotangent of the initial carry asked for (dstate), Z
//   before chunk 0 plus chunk 0's queries, expanded to the moment layout
//   (m0, m1 its rows; m2[ab] = m2[ba] = Z[ab] / 2, likewise g2).
// J_φ(x)^T y for a table column y: y_a on linear row a; y_ab x_b to
// column a and y_ab x_a to column b on a pair row (wt 1), y_aa x_a on a
// diagonal pair (wt 1/2 times the derivative 2 x_a).
//
// What bounds it on an H100: arithmetic. Per bh, in units of N * R * (Dv+1)
// multiply-adds: the slots (1 unit), the queries' two passes over the
// slots (2G), the cotangent slots (G), the keys' pass over them (2 products,
// 2); (3G + 3) units in all, 6.4e11 operations with the in-chunk pairs at
// qwen3's shapes (B=4, Hq=16, Hkv=8, N=1024, D=Dv=128): 0.65 ms at the bf16
// tensor-core peak, 9.6 ms at the f32 CUDA-core peak, against ~0.1 ms for
// its bytes. This version runs it as f32 FMAs on the CUDA cores (tensor
// cores, wgmma and TMA are later work).
//
// Design: the TPU kernel walks the chunks in reverse on a sequential grid
// axis with the carry and its cotangent in VMEM; here both are prefix (or
// suffix) sums, so the walk splits into four launches that run in parallel
// across the card, on the prefill's design (fastmax_causal.cu), with
// nothing carried between blocks:
//   * A', `carry_slots_kernel`: one block per (64 table rows x 64 value
//     columns tile, bh). It seeds the tile from the final carry (pair rows
//     (final[ab] + final[ba]) / 2) and walks the chunks from the last down,
//     32 keys at a time: it sums chunk c's moments on their own, subtracts
//     them from the carry (one rounding of the large value per chunk, as
//     the plain version) and writes slot c, the carry before chunk c, to a
//     workspace, m [nc, BH, R, Dv] f32 and g [nc, BH, R] f64.
//   * B', `query_kernel`: one block per (64 query rows of chunk c's G*len
//     rows, c, bh). Pass 1 is the prefill's combine against slot c plus
//     the chunk's keys (den in f64 at p = 1, as there); from it u and sden,
//     kept in shared memory and written to an f32 workspace [B*Hq, N, Dv]
//     and [B*Hq, N]. Pass 2 walks slot c again, 64 rows a tile: the
//     tile times [u | sden]^T gives y (64 rows x 64 queries), which the
//     block scatters through J_φ(q) into its dq rows in shared memory
//     (thread (i, part) adds to query i's columns a with a % 4 == part
//     only, so no two threads add to one element). Then the chunk's keys'
//     ds = f'(s)(u.v + sden) and the tiled product ds^T k. The block owns
//     its dq rows whole: no partials.
//   * C, `cot_slots_kernel`: launch A''s loop over the queries (their
//     features against [u | sden]) from the last chunk down: slot c of a
//     second workspace is Z_c; after chunk 0 the total is dstate (expanded
//     to the moment layout) or the next segment's seed.
//   * D, `key_kernel`: one block per (64 keys of chunk c, c, bh). One walk
//     over Z_c's tiles gives both the dv product (the combine's tiled
//     product with the keys' weighted features) and y = tile [v | 1]^T,
//     scattered through J_φ(k) into dk rows in shared memory; then the
//     chunk's queries (all G heads), 32 at a time: f(s) u and ds q.
// Segments: the wrapper bounds each workspace by running the four launches
// over segments of the tokens, LAST to first: slot 0 of one segment's
// carry slots seeds the next (earlier) segment's launch A' in place, and
// launch C's total, kept in a table [BH, R, Dv + 1] f32, seeds its C.
// Every sum runs in a fixed order (no float atomics): two calls give the
// same bits. Ragged chunks (N not a multiple of L, N = 1) are masked in the
// kernels.
// Widths: B' and D hold their accumulators in column groups of 64, NCV
// over Dv (num and u in B', dv in D) and NCK over D (dq's and dk's
// products with the chunk's keys or queries): NCV = NCK = 1 or 2 up to
// D, Dv = 128, and NCV = 2, NCK = 3 above (MLA: D = 192, Dv = 128). At
// that width launch D's shared memory is the one that binds: u is kept
// once, at a padded stride that serves both its product and its dots
// (217,984 of the 232,448 bytes a block may have), and launch B' holds
// 208,384; A' and C take D only in their keys' rows. At D, Dv <= 128 the
// launches are the ones before MLA's width (the same sums in the same
// order, the same layout), so those outputs are the same bits.
// Requires D % 4 == 0, Dv % 4 == 0, 4 <= D <= 192, 4 <= Dv <= 128 (checked
// by the wrapper and here).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "feature_table.cuh"

namespace {

constexpr int kL = 128;      // the chunk L: tokens per slot
constexpr int kRT = 64;      // table rows a tile of the y products
constexpr int kYS = 68;      // padded row stride of y [kRT, 64]
constexpr int kMaxD = 192;   // D at most (MLA's 128 + 64)
constexpr int kMaxDv = 128;  // Dv at most
// blocks an SM holds of the two slot launches (A', C): the registers a
// thread may use are capped to fit them
constexpr int kMomentBlocks = 3;

// y[64 rows x 64 columns] = sT [64, ts] x sXT [kt, 64] over the first kt
// (a multiple of 4) columns of sT: thread (tr, tq) = (tid >> 4, tid & 15)
// rows 4tr..4tr+3 and columns 4tq..4tq+3 (16 FMAs per two float4 loads);
// written to sY [64, kYS].
__device__ __forceinline__ void rows_times(const float* sT, int ts, int kt,
                                           const float* sXT, float* sY,
                                           int tid) {
  const int tr = tid >> 4, tq = tid & 15;
  float y[4][4];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri)
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) y[ri][ci] = 0.f;
  const float* t0 = sT + (4 * tr) * ts;
  for (int cc = 0; cc < kt; cc += 4) {
    float ar[4][4];
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const float4 a = ld4(t0 + ri * ts + cc);
      ar[ri][0] = a.x; ar[ri][1] = a.y; ar[ri][2] = a.z; ar[ri][3] = a.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 x = ld4(sXT + (cc + kk) * kTile + 4 * tq);
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        y[ri][0] += ar[ri][kk] * x.x; y[ri][1] += ar[ri][kk] * x.y;
        y[ri][2] += ar[ri][kk] * x.z; y[ri][3] += ar[ri][kk] * x.w;
      }
    }
  }
#pragma unroll
  for (int ri = 0; ri < 4; ++ri)
    *reinterpret_cast<float4*>(sY + (4 * tr + ri) * kYS + 4 * tq) =
        make_float4(y[ri][0], y[ri][1], y[ri][2], y[ri][3]);
}

// sG [64, D + 1] += J_φ(x)^T y for the 64 table rows of sCode, with y in
// sY [64, kYS] and x the 64 vectors of sX [64, D + 1]: thread (i, part) =
// (tid & 63, tid >> 6) adds only to columns c of row i with c % 4 == part.
// Rows go 8 at a time. Most groups are pairs (a, b..) of one first index
// a: column a's eight terms are summed in a register and added once, and
// the columns b, all different, are read together and then written
// together, so the shared-memory round trips overlap. Other groups (the
// linear rows, a change of a) add row by row.
__device__ __forceinline__ void jacobian_scatter(float* sG, const float* sX,
                                                 const float* sY,
                                                 const int* sCode, int XS,
                                                 int tid) {
  constexpr int kU = 8;
  const int i = tid & (kTile - 1), part = tid >> 6;
  float* g = sG + i * XS;
  const float* x = sX + i * XS;
  for (int r0 = 0; r0 < kRT; r0 += kU) {
    int a[kU], b[kU];
    float y[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int c = sCode[r0 + u];   // 0: the constant row; < 0: none
      a[u] = c > 0 ? code_a(c) : -1;
      b[u] = c > 0 ? code_b(c) : -1;
      y[u] = sY[(r0 + u) * kYS + i];
    }
    bool run = b[0] >= 0;
#pragma unroll
    for (int u = 1; u < kU; ++u) run = run && a[u] == a[0] && b[u] >= 0;
    if (run) {
      const int a0 = a[0];
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) s += x[b[u]] * y[u];
      if ((a0 & 3) == part) g[a0] += s;
      const float xa = x[a0];
      float gb[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        gb[u] = (b[u] != a0 && (b[u] & 3) == part) ? g[b[u]] : 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (b[u] != a0 && (b[u] & 3) == part) g[b[u]] = gb[u] + xa * y[u];
    } else {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (a[u] < 0) continue;
        if (b[u] < 0) {
          if ((a[u] & 3) == part) g[a[u]] += y[u];
        } else {
          if ((a[u] & 3) == part) g[a[u]] += x[b[u]] * y[u];
          if (b[u] != a[u] && (b[u] & 3) == part) g[b[u]] += x[a[u]] * y[u];
        }
      }
    }
  }
}

// Row r of a slot table (m [R, Dv] f32 beside its g column gs, null: none)
// into x: the float4s at columns 4 l8 + 32 j < width, column Dv the g entry,
// the rest 0. Returns the row's code. Loaded a tile ahead, so that the
// loads are in flight while the block works on the tile before.
template <int J, typename G>
__device__ __forceinline__ int fetch_row(float4 (&x)[J], const float* ms,
                                         const G* gs, int r, int D, int R,
                                         int Dv, int width, int l8) {
  const int code = row_code(r, D, R);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int cc = 4 * l8 + 32 * j;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (code >= 0 && cc < width) {
      if (cc < Dv) v = ld4(ms + (size_t)r * Dv + cc);
      else if (cc == Dv && gs != nullptr) v.x = (float)gs[r];
    }
    x[j] = v;
  }
  return code;
}

template <int J>
__device__ __forceinline__ void store_row(const float4 (&x)[J], float* dst,
                                          int width, int l8) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int cc = 4 * l8 + 32 * j;
    if (cc < width) *reinterpret_cast<float4*>(dst + cc) = x[j];
  }
}

// ---------------------------------------------------------------------------
// Launch A', over tokens [t_begin, t_begin + n) of N. k [BH, N, D],
// v [BH, N, Dv]; fin the final carry in the state layout (f32; m2, g2 may
// be null at p = 1), read when `from_slot` is 0; with `from_slot` the seed
// is slot 0 of the workspace (the last segment's, read and rewritten in
// place). wsm [nc, BH, R, Dv] f32, wsg [nc, BH, R] f64. A: the g column's
// accumulator. grid (row tiles * column blocks, BH).
// ---------------------------------------------------------------------------
template <typename T, typename A>
__global__ void __launch_bounds__(kThreads, kMomentBlocks)
carry_slots_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   State fin, int from_slot, float* __restrict__ wsm,
                   double* __restrict__ wsg, int N, int t_begin, int n,
                   int D, int Dv, int p) {
  __shared__ __align__(16) float sT[kChunk * kTile];   // features
  __shared__ __align__(16) float sV[kChunk * kCols];
  __shared__ A sG[kThreads];                           // g partials
  __shared__ int sCode[kTile];
  extern __shared__ float sK[];                        // [kChunk, D + 1]
  constexpr bool kF64 = std::is_same<A, double>::value;
  const int KS = D + 1;
  const int R = n_rows(D, p);
  const int ncb = (Dv + kCols - 1) / kCols;
  const int tile = blockIdx.x / ncb, cb = blockIdx.x - tile * ncb;
  const int r0 = tile * kTile, c0 = cb * kCols;
  const int bh = blockIdx.y, BH = gridDim.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int myrow = tid & (kTile - 1);
  const int cq = c0 + 4 * tx;
  const int nc = (n + kL - 1) / kL;
  if (tid < kTile) sCode[tid] = row_code(r0 + tid, D, R);
  __syncthreads();
  const int mycode = sCode[myrow];

  // the carry, seeded with the one at the segment's end (pair rows with the
  // symmetric half); every chunk's delta is summed on its own and then
  // subtracted, one rounding of the large value per chunk, as the plain
  // version's carry_before = carry_after - delta
  float carry[4][4];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    const int c = sCode[4 * ty + ri], r = r0 + 4 * ty + ri;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c >= 0 && cq < Dv) {
      if (from_slot) {
        x = ld4(wsm + ((size_t)bh * R + r) * Dv + cq);
      } else {
        size_t mo, go;
        long mt, gt;
        state_offsets(c, bh, D, Dv, &mo, &go, &mt, &gt);
        x = ld4(fin.m(c) + mo + cq);
        if (mt >= 0) {
          const float4 y = ld4(fin.m2 + mt + cq);
          x = make_float4(0.5f * (x.x + y.x), 0.5f * (x.y + y.y),
                          0.5f * (x.z + y.z), 0.5f * (x.w + y.w));
        }
      }
    }
    carry[ri][0] = x.x; carry[ri][1] = x.y; carry[ri][2] = x.z;
    carry[ri][3] = x.w;
  }
  A gcarry = A(0);   // the g carry of row `tid` (tid < kTile, cb == 0)
  if (cb == 0 && tid < kTile && mycode >= 0) {
    if (from_slot) {
      gcarry = (A)wsg[(size_t)bh * R + r0 + tid];
    } else {
      size_t mo, go;
      long mt, gt;
      state_offsets(mycode, bh, D, Dv, &mo, &go, &mt, &gt);
      gcarry = (A)fin.g(mycode)[go];
      if (gt >= 0) gcarry = A(0.5) * (gcarry + (A)fin.g2[gt]);
    }
  }
  const T* kb = k + ((size_t)bh * N + t_begin) * D;
  const T* vb = v + ((size_t)bh * N + t_begin) * Dv;

  for (int c = nc - 1; c >= 0; --c) {
    float dl[4][4];   // chunk c's delta
#pragma unroll
    for (int ri = 0; ri < 4; ++ri)
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) dl[ri][ci] = 0.f;
    A gp = A(0);
    const int cl = min(kL, n - c * kL);
    for (int j0 = 0; j0 < cl; j0 += kChunk) {
      const int t0 = c * kL + j0, len = min(kChunk, cl - j0);
      // a warp a row, 32 consecutive entries a step
      for (int t = warp; t < kChunk; t += kThreads / 32) {
        const T* kr = kb + (size_t)(t0 + t) * D;
        const T* vr = vb + (size_t)(t0 + t) * Dv + c0;
        for (int a = lane; a < D; a += 32)
          sK[t * KS + a] = t < len ? ld(kr + a) : 0.f;
        for (int cc = lane; cc < kCols; cc += 32)
          sV[t * kCols + cc] = (t < len && c0 + cc < Dv) ? ld(vr + cc) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kChunk / (kThreads / kTile); ++i) {
        const int t = (tid / kTile) + (kThreads / kTile) * i;
        const bool on = t < len && mycode >= 0;
        const float f = on ? feature(mycode, sK + t * KS) : 0.f;
        sT[t * kTile + myrow] = f;
        if constexpr (kF64) {
          if (cb == 0 && on) gp += feature64(mycode, sK + t * KS);
        } else {
          gp += f;
        }
      }
      __syncthreads();
      moment_tile(dl, sT, sV, len, ty, tx);
      __syncthreads();
    }
    // slot c: the carry before chunk c
    const size_t slot = (size_t)c * BH + bh;
#pragma unroll
    for (int ri = 0; ri < 4; ++ri)
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) carry[ri][ci] -= dl[ri][ci];
    if (cq < Dv) {
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const int r = r0 + 4 * ty + ri;
        if (r < R)
          *reinterpret_cast<float4*>(wsm + (slot * R + r) * Dv + cq) =
              make_float4(carry[ri][0], carry[ri][1], carry[ri][2],
                          carry[ri][3]);
      }
    }
    if (cb == 0) {
      sG[tid] = gp;
      __syncthreads();
      if (tid < kTile && r0 + tid < R) {
        A s = A(0);
        for (int l = 0; l < kThreads / kTile; ++l) s += sG[l * kTile + tid];
        gcarry -= s;
        wsg[slot * R + r0 + tid] = (double)gcarry;
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// Launch B', over tokens [t_begin, t_begin + n) of N. q [BH*G, N, D], k, v
// as launch A', do [BH*G, N, Dv]; wsm, wsg the carry slots; dq [BH*G, N, D];
// uws [BH*G, N, Dv], sws [BH*G, N] (f32): u and sden. grid (ceil(G*L / 64),
// nc, BH). NCV column groups of 64 cover Dv (num, u), NCK cover D (dq's
// product with the chunk's keys). A: the denominator's accumulator.
// ---------------------------------------------------------------------------
__host__ __device__ inline int query_smem_floats(int D, int Dv, int ncv,
                                                 int nck) {
  const int QS = D + 1, BCV = kCols * ncv, BCK = kCols * nck;
  const int pass1 = kChunk * (BCV + kPS + QS);
  const int pass2 = kRT * (Dv + 4 + kYS);
  const int intra = kChunk * (QS + BCK + Dv + 1 + kPS);
  int x = pass1 > pass2 ? pass1 : pass2;
  x = x > intra ? x : intra;
  return 2 * kTile * QS + (Dv + 4) * kTile + kTile + x;
}

template <typename T, int NCV, int NCK, typename A>
__global__ void __launch_bounds__(kThreads)
query_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ wsm, const double* __restrict__ wsg,
             T* __restrict__ dq, float* __restrict__ uws,
             float* __restrict__ sws, int G, int N, int t_begin, int n,
             int D, int Dv, int p, float eps) {
  constexpr int BC = kCols * NCV, BCK = kCols * NCK;
  constexpr bool kF64 = std::is_same<A, double>::value;
  static_assert(kChunk * (BC + kPS) * sizeof(float) >=
                kChunk * kTile * sizeof(A), "den partials overflow");
  extern __shared__ __align__(16) float smem[];
  const int QS = D + 1, TS = Dv + 4;
  float* sQ = smem;                     // [64, D + 1] queries
  float* sDQ = sQ + kTile * QS;         // [64, D + 1] dq
  float* sUT = sDQ + kTile * QS;        // [Dv + 4, 64] u^T, then sden, 0
  float* sDen = sUT + TS * kTile;       // [64] den + eps
  float* sX = sDen + kTile;             // per phase:
  float* sM = sX;                       //  1: [32, BC] slot rows, then v
  float* sP = sM + kChunk * BC;         //     [32, kPS] features / f(s)
  float* sK = sP + kChunk * kPS;        //     [32, D + 1] the chunk's keys
  A* sRed = reinterpret_cast<A*>(sM);   //     [32, 64] den partials
  float* sMt = sX;                      //  2: [64, Dv + 4] slot rows | g
  float* sY = sMt + kRT * TS;           //     [64, kYS] y
  float* sKs = sX;                      //  3: [32, D + 1] keys (scores)
  float* sKB = sKs + kChunk * QS;       //     [32, BCK] keys (product)
  float* sVs = sKB + kChunk * BCK;      //     [32, Dv + 1] values
  float* sDS = sVs + kChunk * (Dv + 1); //     [32, kPS] ds
  __shared__ int sPos[kTile];           // query position in the chunk, or -1
  __shared__ int sCode[kRT];
  const int R = n_rows(D, p);
  const int c = blockIdx.y, bh = blockIdx.z, BH = gridDim.z;
  const int t0 = t_begin + c * kL, len = min(kL, n - c * kL), GL = G * len;
  const int qr0 = blockIdx.x * kTile;
  if (qr0 >= GL) return;                // the last chunk's spare blocks
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rl = tid >> 3, l8 = tid & 7;
  const size_t slot = (size_t)c * BH + bh;
  const float* ms = wsm + slot * R * Dv;
  const double* gs = wsg + slot * R;
  const T* kb = k + ((size_t)bh * N + t0) * D;
  const T* vb = v + ((size_t)bh * N + t0) * Dv;
  auto row_of = [&](int qr) -> size_t {   // q / do row of chunk row qr
    const int g = qr / len, i = qr - g * len;
    return ((size_t)bh * G + g) * N + t0 + i;
  };

  for (int e = tid; e < kTile * D; e += kThreads) {
    const int r = e / D, a = e - r * D, qr = qr0 + r;
    sQ[r * QS + a] = qr < GL ? ld(q + row_of(qr) * D + a) : 0.f;
    sDQ[r * QS + a] = 0.f;
  }
  if (tid < kTile) {
    const int qr = qr0 + tid;
    sPos[tid] = qr < GL ? qr % len : -1;
  }
  __syncthreads();

  // ---- pass 1: num and den, as the prefill's combine ----
  float acc[4][4 * NCV];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri)
#pragma unroll
    for (int ci = 0; ci < 4 * NCV; ++ci) acc[ri][ci] = 0.f;
  A dp[kTile / 8];
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i) dp[i] = A(0);
  float4 pm[BC / 32];   // the next tile's row, in flight
  int ncode = fetch_row(pm, ms, (const double*)nullptr, rl, D, R, Dv, BC, l8);
  A ng = ncode >= 0 ? (A)gs[rl] : A(0);
  for (int r0 = 0; r0 < R; r0 += kChunk) {
    const int code = ncode;
    const A gv = ng;
    store_row(pm, sM + rl * BC, BC, l8);
    const float wr = code >= 0 ? row_weight(code) : 0.f;
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const int qi = l8 + 8 * i;
      const float f = code >= 0 ? wr * feature(code, sQ + qi * QS) : 0.f;
      sP[rl * kPS + qi] = f;
      if constexpr (kF64) {
        if (code >= 0)
          dp[i] += (double)wr * feature64(code, sQ + qi * QS) * gv;
      } else {
        dp[i] += f * gv;
      }
    }
    __syncthreads();
    if (r0 + kChunk < R) {
      const int r = r0 + kChunk + rl;
      ncode = fetch_row(pm, ms, (const double*)nullptr, r, D, R, Dv, BC, l8);
      ng = ncode >= 0 ? (A)gs[r] : A(0);
    }
    tile_product<NCV>(acc, sP, sM, BC, ty, tx);
    __syncthreads();
  }
  for (int j0 = 0; j0 < len; j0 += kChunk) {
    const int jn = min(kChunk, len - j0);
    for (int e = tid; e < kChunk * D; e += kThreads) {
      const int t = e / D, a = e - t * D;
      sK[t * QS + a] = t < jn ? ld(kb + (size_t)(j0 + t) * D + a) : 0.f;
    }
    for (int e = tid; e < kChunk * BC; e += kThreads) {
      const int t = e / BC, cc = e - t * BC;
      sM[e] = (t < jn && cc < Dv) ? ld(vb + (size_t)(j0 + t) * Dv + cc) : 0.f;
    }
    __syncthreads();
    const int j = j0 + rl;
    A s[kTile / 8];
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) s[i] = A(0);
    for (int a = 0; a < D; ++a) {
      const A ka = sK[rl * QS + a];
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i)
        s[i] += (A)sQ[(l8 + 8 * i) * QS + a] * ka;
    }
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const int qi = l8 + 8 * i;
      A f = A(0);
      if (rl < jn && j <= sPos[qi]) {
        f = A(1) + s[i];
        if (p >= 2) f += A(0.5) * s[i] * s[i];
      }
      sP[rl * kPS + qi] = (float)f;
      dp[i] += f;
    }
    __syncthreads();
    tile_product<NCV>(acc, sP, sM, BC, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i) sRed[rl * kTile + l8 + 8 * i] = dp[i];
  __syncthreads();
  if (tid < kTile) {
    A sum = A(0);
    for (int l = 0; l < kChunk; ++l) sum += sRed[l * kTile + tid];
    sDen[tid] = (float)(sum + (A)eps);
  }
  __syncthreads();

  // ---- u = do / (den + eps), sden = -o.u (the 16 lanes of a row) ----
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    const int r = 4 * ty + ri, qr = qr0 + r;
    const bool ok = qr < GL;
    const size_t row = ok ? row_of(qr) : 0;
    const float deni = 1.f / sDen[r];
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < NCV; ++j) {
      const int cq = kCols * j + 4 * tx;
      if (cq >= Dv) continue;
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) {
        const float u = ok ? ld(dout + row * Dv + cq + ci) * deni : 0.f;
        part -= acc[ri][4 * j + ci] * deni * u;
        sUT[(cq + ci) * kTile + r] = u;
        if (ok) uws[row * Dv + cq + ci] = u;
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    part += __shfl_xor_sync(0xffffffffu, part, 4);
    part += __shfl_xor_sync(0xffffffffu, part, 8);
    if (tx == 0) {
      sUT[Dv * kTile + r] = ok ? part : 0.f;
      if (ok) sws[row] = part;
    }
  }
  for (int e = tid; e < 3 * kTile; e += kThreads)
    sUT[(Dv + 1) * kTile + e] = 0.f;
  __syncthreads();

  // ---- pass 2: dq through slot c, tile by tile ----
  // the next tile's rows rl and rl + 32, in flight
  float4 pt[2][(kMaxDv + 4 + 31) / 32];
  ncode = fetch_row(pt[0], ms, gs, rl, D, R, Dv, TS, l8);
  int ncode1 = fetch_row(pt[1], ms, gs, rl + kChunk, D, R, Dv, TS, l8);
  for (int r0 = 0; r0 < R; r0 += kRT) {
    if (l8 == 0) {
      sCode[rl] = ncode;
      sCode[rl + kChunk] = ncode1;
    }
    store_row(pt[0], sMt + rl * TS, TS, l8);
    store_row(pt[1], sMt + (rl + kChunk) * TS, TS, l8);
    __syncthreads();
    if (r0 + kRT < R) {
      const int r = r0 + kRT + rl;
      ncode = fetch_row(pt[0], ms, gs, r, D, R, Dv, TS, l8);
      ncode1 = fetch_row(pt[1], ms, gs, r + kChunk, D, R, Dv, TS, l8);
    }
    rows_times(sMt, TS, TS, sUT, sY, tid);
    __syncthreads();
    jacobian_scatter(sDQ, sQ, sY, sCode, QS, tid);
    __syncthreads();
  }

  // ---- the chunk's own keys: dq += ds k, ds = f'(s)(u.v + sden) ----
  float acc2[4][4 * NCK];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri)
#pragma unroll
    for (int ci = 0; ci < 4 * NCK; ++ci) acc2[ri][ci] = 0.f;
  const int VS = Dv + 1;
  for (int j0 = 0; j0 < len; j0 += kChunk) {
    const int jn = min(kChunk, len - j0);
    for (int e = tid; e < kChunk * BCK; e += kThreads) {
      const int t = e / BCK, a = e - t * BCK;
      const float x =
          (t < jn && a < D) ? ld(kb + (size_t)(j0 + t) * D + a) : 0.f;
      sKB[e] = x;
      if (a < D) sKs[t * QS + a] = x;
    }
    for (int t = tid >> 5; t < kChunk; t += kThreads / 32)
      for (int cc = tid & 31; cc < Dv; cc += 32)
        sVs[t * VS + cc] = t < jn ? ld(vb + (size_t)(j0 + t) * Dv + cc) : 0.f;
    __syncthreads();
    const int j = j0 + rl;
    float s[kTile / 8], uv[kTile / 8];
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) s[i] = uv[i] = 0.f;
    if (p >= 2) {
      for (int a = 0; a < D; ++a) {
        const float ka = sKs[rl * QS + a];
#pragma unroll
        for (int i = 0; i < kTile / 8; ++i)
          s[i] += sQ[(l8 + 8 * i) * QS + a] * ka;
      }
    }
    for (int cc = 0; cc < Dv; ++cc) {
      const float vc = sVs[rl * VS + cc];
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i)
        uv[i] += sUT[cc * kTile + l8 + 8 * i] * vc;
    }
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const int qi = l8 + 8 * i;
      float ds = 0.f;
      if (rl < jn && j <= sPos[qi]) {
        const float fp = p >= 2 ? 1.f + s[i] : 1.f;
        ds = fp * (uv[i] + sUT[Dv * kTile + qi]);
      }
      sDS[rl * kPS + qi] = ds;
    }
    __syncthreads();
    tile_product<NCK>(acc2, sDS, sKB, BCK, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int ri = 0; ri < 4; ++ri)
#pragma unroll
    for (int j = 0; j < NCK; ++j)
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) {
        const int a = kCols * j + 4 * tx + ci;
        if (a < D) sDQ[(4 * ty + ri) * QS + a] += acc2[ri][4 * j + ci];
      }
  __syncthreads();
  for (int e = tid; e < kTile * D; e += kThreads) {
    const int r = e / D, a = e - r * D, qr = qr0 + r;
    if (qr < GL) st(dq + row_of(qr) * D + a, sDQ[r * QS + a]);
  }
}

// ---------------------------------------------------------------------------
// Launch C, over tokens [t_begin, t_begin + n) of N. q [BH*G, N, D]; uws,
// sws as launch B' writes them. zcm [BH, R, Dv], zcg [BH, R] (f32, null for
// a single segment): the cotangent carried between segments, read when
// `seeded` and written after chunk 0. ds: the dstate outputs in the state
// layout (m0 null: not asked for), written after chunk 0. wzm [nc, BH, R,
// Dv], wzg [nc, BH, R] f32: Z_c. grid (row tiles * column blocks, BH).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, kMomentBlocks)
cot_slots_kernel(const T* __restrict__ q, const float* __restrict__ uws,
                 const float* __restrict__ sws, float* zcm, float* zcg,
                 int seeded, State ds, float* __restrict__ wzm,
                 float* __restrict__ wzg, int G, int N, int t_begin, int n,
                 int D, int Dv, int p) {
  __shared__ __align__(16) float sT[kChunk * kTile];   // features
  __shared__ __align__(16) float sV[kChunk * kCols];   // u
  __shared__ float sG[kThreads];                       // g partials
  __shared__ float sW[kChunk];                         // sden
  __shared__ int sCode[kTile];
  extern __shared__ float sK[];                        // [kChunk, D + 1]
  const int KS = D + 1;
  const int R = n_rows(D, p);
  const int ncb = (Dv + kCols - 1) / kCols;
  const int tile = blockIdx.x / ncb, cb = blockIdx.x - tile * ncb;
  const int r0 = tile * kTile, c0 = cb * kCols;
  const int bh = blockIdx.y, BH = gridDim.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int myrow = tid & (kTile - 1);
  const int cq = c0 + 4 * tx;
  const int nc = (n + kL - 1) / kL;
  if (tid < kTile) sCode[tid] = row_code(r0 + tid, D, R);
  __syncthreads();
  const int mycode = sCode[myrow];

  float acc[4][4];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    const int r = r0 + 4 * ty + ri;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (seeded && r < R && cq < Dv)
      x = ld4(zcm + ((size_t)bh * R + r) * Dv + cq);
    acc[ri][0] = x.x; acc[ri][1] = x.y; acc[ri][2] = x.z; acc[ri][3] = x.w;
  }
  const float gseed = (seeded && cb == 0 && tid < kTile && mycode >= 0)
                          ? zcg[(size_t)bh * R + r0 + tid] : 0.f;
  float gp = 0.f;
  auto g_total = [&]() -> float {   // cb == 0 only
    sG[tid] = gp;
    __syncthreads();
    float s = gseed;
    if (tid < kTile)
      for (int l = 0; l < kThreads / kTile; ++l) s += sG[l * kTile + tid];
    __syncthreads();
    return s;
  };

  for (int c = nc - 1; c >= 0; --c) {
    // slot c: the cotangent of the carry after chunk c
    const size_t slot = (size_t)c * BH + bh;
    if (cq < Dv) {
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const int r = r0 + 4 * ty + ri;
        if (r < R)
          *reinterpret_cast<float4*>(wzm + (slot * R + r) * Dv + cq) =
              make_float4(acc[ri][0], acc[ri][1], acc[ri][2], acc[ri][3]);
      }
    }
    if (cb == 0) {
      const float s = g_total();
      if (tid < kTile && r0 + tid < R) wzg[slot * R + r0 + tid] = s;
    }
    // fold chunk c's G*len query rows
    const int cl = min(kL, n - c * kL), GL = G * cl;
    const size_t row0 = (size_t)t_begin + c * kL;
    for (int j0 = 0; j0 < GL; j0 += kChunk) {
      const int len = min(kChunk, GL - j0);
      // a warp a query row, 32 consecutive entries a step
      for (int t = warp; t < kChunk; t += kThreads / 32) {
        size_t row = 0;
        if (t < len) {
          const int qr = j0 + t, g = qr / cl, i = qr - g * cl;
          row = ((size_t)bh * G + g) * N + row0 + i;
        }
        for (int a = lane; a < D; a += 32)
          sK[t * KS + a] = t < len ? ld(q + row * D + a) : 0.f;
        for (int cc = lane; cc < kCols; cc += 32)
          sV[t * kCols + cc] =
              (t < len && c0 + cc < Dv) ? uws[row * Dv + c0 + cc] : 0.f;
        if (lane == 0) sW[t] = t < len ? sws[row] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kChunk / (kThreads / kTile); ++i) {
        const int t = (tid / kTile) + (kThreads / kTile) * i;
        const float f = (t < len && mycode >= 0)
                            ? feature(mycode, sK + t * KS) : 0.f;
        sT[t * kTile + myrow] = f;
        gp += f * sW[t];
      }
      __syncthreads();
      moment_tile(acc, sT, sV, len, ty, tx);
      __syncthreads();
    }
  }

  // the total: the next segment's seed, and dstate
  const float gs = cb == 0 ? g_total() : 0.f;
  if (zcm != nullptr) {
    if (cq < Dv) {
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const int r = r0 + 4 * ty + ri;
        if (r < R)
          *reinterpret_cast<float4*>(zcm + ((size_t)bh * R + r) * Dv + cq) =
              make_float4(acc[ri][0], acc[ri][1], acc[ri][2], acc[ri][3]);
      }
    }
    if (cb == 0 && tid < kTile && mycode >= 0)
      zcg[(size_t)bh * R + r0 + tid] = gs;
  }
  if (ds.m0 == nullptr) return;
  if (cq < Dv) {
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const int c = sCode[4 * ty + ri];
      if (c < 0) continue;
      size_t mo, go;
      long mt, gt;
      state_offsets(c, bh, D, Dv, &mo, &go, &mt, &gt);
      const float h = code_b(c) >= 0 ? 0.5f : 1.f;   // m2[ab] = Z[ab] / 2
      const float4 x = make_float4(h * acc[ri][0], h * acc[ri][1],
                                   h * acc[ri][2], h * acc[ri][3]);
      *reinterpret_cast<float4*>(ds.m(c) + mo + cq) = x;
      if (mt >= 0) *reinterpret_cast<float4*>(ds.m2 + mt + cq) = x;
    }
  }
  if (cb == 0 && tid < kTile && mycode >= 0) {
    size_t mo, go;
    long mt, gt;
    state_offsets(mycode, bh, D, Dv, &mo, &go, &mt, &gt);
    const float x = code_b(mycode) >= 0 ? 0.5f * gs : gs;
    ds.g(mycode)[go] = x;
    if (gt >= 0) ds.g2[gt] = x;
  }
}

// ---------------------------------------------------------------------------
// Launch D, over tokens [t_begin, t_begin + n) of N. q, k, v as launch B';
// uws, sws as it writes them; wzm, wzg the cotangent slots; dk [BH, N, D],
// dv [BH, N, Dv]. grid (ceil(L / 64), nc, BH). NCV column groups of 64
// cover Dv (dv, u), NCK cover D (dk's product with the chunk's queries).
// ---------------------------------------------------------------------------
__host__ __device__ inline int key_smem_floats(int D, int Dv, int ncv,
                                               int nck) {
  const int QS = D + 1, BCV = kCols * ncv, BCK = kCols * nck;
  const int ZS = BCV > Dv + 4 ? BCV : Dv + 4;
  const int zpass = kRT * (ZS + kPS + kYS);
  // u: [32, BCV] and [32, Dv + 1], or once, [32, BCV + 4] (see key_kernel)
  const int us = nck > ncv ? BCV + 4 : BCV + Dv + 1;
  const int intra = kChunk * (QS + BCK + us + 2 * kPS) + kChunk;
  return 2 * kTile * QS + (Dv + 4) * kTile + (zpass > intra ? zpass : intra);
}

template <typename T, int NCV, int NCK>
__global__ void __launch_bounds__(kThreads)
key_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ uws,
           const float* __restrict__ sws, const float* __restrict__ wzm,
           const float* __restrict__ wzg, T* __restrict__ dk,
           T* __restrict__ dv, int G, int N, int t_begin, int n, int D,
           int Dv, int p) {
  constexpr int BC = kCols * NCV, BCK = kCols * NCK;
  // at D > 128 (NCK > NCV) u is kept once, for its product (64 NCV
  // columns) and its u.v dots, so that the block fits in shared memory:
  // the stride's 4 extra floats put the 4 rows a warp reads on other
  // banks. Below, u is kept twice (product; dots at the odd stride Dv + 1)
  constexpr bool kOneU = NCK > NCV;
  constexpr int US = kOneU ? BC + 4 : BC;
  extern __shared__ __align__(16) float smem[];
  const int QS = D + 1, TS = Dv + 4;
  const int ZS = BC > TS ? BC : TS;
  const int VS = kOneU ? US : Dv + 1;
  float* sKq = smem;                    // [64, D + 1] keys
  float* sDK = sKq + kTile * QS;        // [64, D + 1] dk
  float* sVT = sDK + kTile * QS;        // [Dv + 4, 64] v^T, then 1, 0
  float* sX = sVT + TS * kTile;         // per phase:
  float* sZ = sX;                       //  1: [64, ZS] slot rows | g
  float* sP = sZ + kRT * ZS;            //     [64, kPS] weighted features
  float* sY = sP + kRT * kPS;           //     [64, kYS] y
  float* sQs = sX;                      //  2: [32, D + 1] queries (scores)
  float* sQB = sQs + kChunk * QS;       //     [32, BCK] queries (product)
  float* sUB = sQB + kChunk * BCK;      //     [32, US] u (product)
  float* sUs = kOneU ? sUB : sUB + kChunk * US;   // [32, VS] u (dots)
  float* sF = sUs + kChunk * VS;        //     [32, kPS] f(s)
  float* sDS = sF + kChunk * kPS;       //     [32, kPS] ds
  float* sSd = sDS + kChunk * kPS;      //     [32] sden
  __shared__ int sPos[kTile];           // key position in the chunk, or -1
  __shared__ int sQpos[kChunk];         // query position, or -1
  __shared__ int sCode[kRT];
  const int R = n_rows(D, p);
  const int c = blockIdx.y, bh = blockIdx.z, BH = gridDim.z;
  const int t0 = t_begin + c * kL, len = min(kL, n - c * kL), GL = G * len;
  const int k0 = blockIdx.x * kTile;
  if (k0 >= len) return;                // the last chunk's spare blocks
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int rl = tid >> 3, l8 = tid & 7;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t slot = (size_t)c * BH + bh;
  const float* zs = wzm + slot * R * Dv;
  const float* zg = wzg + slot * R;

  for (int e = tid; e < kTile * D; e += kThreads) {
    const int r = e / D, a = e - r * D, j = k0 + r;
    sKq[r * QS + a] =
        j < len ? ld(k + ((size_t)bh * N + t0 + j) * D + a) : 0.f;
    sDK[r * QS + a] = 0.f;
  }
  for (int e = tid; e < TS * kTile; e += kThreads) {
    const int cc = e / kTile, r = e - cc * kTile, j = k0 + r;
    float x = 0.f;
    if (j < len) {
      if (cc < Dv) x = ld(v + ((size_t)bh * N + t0 + j) * Dv + cc);
      else if (cc == Dv) x = 1.f;
    }
    sVT[e] = x;
  }
  if (tid < kTile) sPos[tid] = k0 + tid < len ? k0 + tid : -1;
  __syncthreads();

  // ---- one walk over Z_c: dv's product and dk's scatter ----
  float acc[4][4 * NCV];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri)
#pragma unroll
    for (int ci = 0; ci < 4 * NCV; ++ci) acc[ri][ci] = 0.f;
  // the next tile's rows rl and rl + 32, in flight
  float4 pz[2][(kMaxDv + 4 + 31) / 32];
  int ncode[2] = {fetch_row(pz[0], zs, zg, rl, D, R, Dv, ZS, l8),
                  fetch_row(pz[1], zs, zg, rl + kChunk, D, R, Dv, ZS, l8)};
  for (int r0 = 0; r0 < R; r0 += kRT) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int code = ncode[h], row = rl + kChunk * h;
      if (l8 == 0) sCode[row] = code;
      store_row(pz[h], sZ + row * ZS, ZS, l8);
      const float wr = code >= 0 ? row_weight(code) : 0.f;
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i) {
        const int ki = l8 + 8 * i;
        sP[row * kPS + ki] =
            code >= 0 ? wr * feature(code, sKq + ki * QS) : 0.f;
      }
    }
    __syncthreads();
    if (r0 + kRT < R) {
      const int r = r0 + kRT + rl;
      ncode[0] = fetch_row(pz[0], zs, zg, r, D, R, Dv, ZS, l8);
      ncode[1] = fetch_row(pz[1], zs, zg, r + kChunk, D, R, Dv, ZS, l8);
    }
    tile_product<NCV>(acc, sP, sZ, ZS, ty, tx);
    tile_product<NCV>(acc, sP + kChunk * kPS, sZ + kChunk * ZS, ZS, ty, tx);
    rows_times(sZ, ZS, TS, sVT, sY, tid);
    __syncthreads();
    jacobian_scatter(sDK, sKq, sY, sCode, QS, tid);
    __syncthreads();
  }

  // ---- the chunk's queries i >= j (all G heads): f(s) u and ds q ----
  float acc2[4][4 * NCK];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri)
#pragma unroll
    for (int ci = 0; ci < 4 * NCK; ++ci) acc2[ri][ci] = 0.f;
  for (int q0 = 0; q0 < GL; q0 += kChunk) {
    const int qn = min(kChunk, GL - q0);
    // rows whose position is below the block's first key add nothing
    if ((q0 + qn - 1) / len == q0 / len && (q0 + qn - 1) % len < k0) continue;
    // a warp a query row, 32 consecutive entries a step
    for (int t = warp; t < kChunk; t += kThreads / 32) {
      size_t row = 0;
      int pos = -1;
      if (t < qn) {
        const int qr = q0 + t, g = qr / len;
        pos = qr - g * len;
        row = ((size_t)bh * G + g) * N + t0 + pos;
      }
      for (int a = lane; a < BCK; a += 32) {
        const float xq = (pos >= 0 && a < D) ? ld(q + row * D + a) : 0.f;
        const float xu = (pos >= 0 && a < Dv) ? uws[row * Dv + a] : 0.f;
        sQB[t * BCK + a] = xq;
        if (a < BC) sUB[t * US + a] = xu;
        if (a < D) sQs[t * QS + a] = xq;
        if (!kOneU && a < Dv) sUs[t * VS + a] = xu;
      }
      if (lane == 0) {
        sSd[t] = pos >= 0 ? sws[row] : 0.f;
        sQpos[t] = pos;
      }
    }
    __syncthreads();
    float s[kTile / 8], uv[kTile / 8];
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) s[i] = uv[i] = 0.f;
    for (int a = 0; a < D; ++a) {
      const float qa = sQs[rl * QS + a];
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i)
        s[i] += qa * sKq[(l8 + 8 * i) * QS + a];
    }
    for (int cc = 0; cc < Dv; ++cc) {
      const float ua = sUs[rl * VS + cc];
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i)
        uv[i] += ua * sVT[cc * kTile + l8 + 8 * i];
    }
    const int qpos = sQpos[rl];
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const int ki = l8 + 8 * i;
      float f = 0.f, ds = 0.f;
      if (qpos >= 0 && sPos[ki] >= 0 && sPos[ki] <= qpos) {
        f = 1.f + s[i];
        if (p >= 2) f += 0.5f * s[i] * s[i];
        const float fp = p >= 2 ? 1.f + s[i] : 1.f;
        ds = fp * (uv[i] + sSd[rl]);
      }
      sF[rl * kPS + ki] = f;
      sDS[rl * kPS + ki] = ds;
    }
    __syncthreads();
    tile_product<NCV>(acc, sF, sUB, US, ty, tx);
    tile_product<NCK>(acc2, sDS, sQB, BCK, ty, tx);
    __syncthreads();
  }

  // ---- dv from the registers; dk from sDK plus the intra term ----
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    const int r = 4 * ty + ri, j = k0 + r;
#pragma unroll
    for (int jj = 0; jj < NCK; ++jj)
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) {
        const int cc = kCols * jj + 4 * tx + ci;
        if (jj < NCV && j < len && cc < Dv)
          st(dv + ((size_t)bh * N + t0 + j) * Dv + cc, acc[ri][4 * jj + ci]);
        if (cc < D) sDK[r * QS + cc] += acc2[ri][4 * jj + ci];
      }
  }
  __syncthreads();
  for (int e = tid; e < kTile * D; e += kThreads) {
    const int r = e / D, a = e - r * D, j = k0 + r;
    if (j < len) st(dk + ((size_t)bh * N + t0 + j) * D + a, sDK[r * QS + a]);
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, typename A>
int launch_slots(const void* k, const void* v, const State& fin,
                 int from_slot, void* wsm, void* wsg, int bh, int N,
                 int t_begin, int n, int D, int Dv, int p, cudaStream_t s) {
  const int R = n_rows(D, p);
  const dim3 grid(((R + kTile - 1) / kTile) * ((Dv + kCols - 1) / kCols), bh);
  const size_t sm = sizeof(float) * kChunk * (D + 1);
  int err = set_smem(carry_slots_kernel<T, A>, sm);
  if (err) return err;
  carry_slots_kernel<T, A><<<grid, kThreads, sm, s>>>(
      (const T*)k, (const T*)v, fin, from_slot, (float*)wsm, (double*)wsg, N,
      t_begin, n, D, Dv, p);
  return (int)cudaGetLastError();
}

template <typename T, int NCV, int NCK, typename A>
int launch_queries(const void* q, const void* k, const void* v,
                   const void* dout, const void* wsm, const void* wsg,
                   void* dq, void* uws, void* sws, int bh, int G, int N,
                   int t_begin, int n, int D, int Dv, int p, float eps,
                   cudaStream_t s) {
  const size_t sm = sizeof(float) * query_smem_floats(D, Dv, NCV, NCK);
  int err = set_smem(query_kernel<T, NCV, NCK, A>, sm);
  if (err) return err;
  const dim3 grid((G * kL + kTile - 1) / kTile, (n + kL - 1) / kL, bh);
  query_kernel<T, NCV, NCK, A><<<grid, kThreads, sm, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)wsm, (const double*)wsg, (T*)dq, (float*)uws,
      (float*)sws, G, N, t_begin, n, D, Dv, p, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cot(const void* q, const void* uws, const void* sws, void* zcm,
               void* zcg, int seeded, const State& ds, void* wzm, void* wzg,
               int bh, int G, int N, int t_begin, int n, int D, int Dv,
               int p, cudaStream_t s) {
  const int R = n_rows(D, p);
  const dim3 grid(((R + kTile - 1) / kTile) * ((Dv + kCols - 1) / kCols), bh);
  const size_t sm = sizeof(float) * kChunk * (D + 1);
  int err = set_smem(cot_slots_kernel<T>, sm);
  if (err) return err;
  cot_slots_kernel<T><<<grid, kThreads, sm, s>>>(
      (const T*)q, (const float*)uws, (const float*)sws, (float*)zcm,
      (float*)zcg, seeded, ds, (float*)wzm, (float*)wzg, G, N, t_begin, n, D,
      Dv, p);
  return (int)cudaGetLastError();
}

template <typename T, int NCV, int NCK>
int launch_keys(const void* q, const void* k, const void* v, const void* uws,
                const void* sws, const void* wzm, const void* wzg, void* dk,
                void* dv, int bh, int G, int N, int t_begin, int n, int D,
                int Dv, int p, cudaStream_t s) {
  const size_t sm = sizeof(float) * key_smem_floats(D, Dv, NCV, NCK);
  int err = set_smem(key_kernel<T, NCV, NCK>, sm);
  if (err) return err;
  const dim3 grid((kL + kTile - 1) / kTile, (n + kL - 1) / kL, bh);
  key_kernel<T, NCV, NCK><<<grid, kThreads, sm, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)uws,
      (const float*)sws, (const float*)wzm, (const float*)wzg, (T*)dk,
      (T*)dv, G, N, t_begin, n, D, Dv, p);
  return (int)cudaGetLastError();
}

bool dims_ok(int bh, int G, int N, int t_begin, int n, int D, int Dv,
             int p) {
  return bh >= 1 && bh <= 65535 && G >= 1 && n >= 1 && t_begin >= 0 &&
         t_begin <= N - n && D >= 4 && D % 4 == 0 && D <= kMaxD && Dv >= 4 &&
         Dv % 4 == 0 && Dv <= kMaxDv && (p == 1 || p == 2) &&
         (n + kL - 1) / kL <= 65535 && (long)G * kL / kTile < (1L << 31);
}

State state_of(const void* m0, const void* m1, const void* m2,
               const void* g0, const void* g1, const void* g2) {
  return State{(float*)m0, (float*)m1, (float*)m2,
               (float*)g0, (float*)g1, (float*)g2};
}

// The column groups of launches B' and D: one (both widths at most 64),
// two (at most 128: one class for D and Dv, as before MLA), or at D > 128
// two over Dv and three over D (MLA's D = 192, Dv = 128).
enum class Width { k1, k2, k23 };
Width width_of(int D, int Dv) {
  if (D > 2 * kCols) return Width::k23;
  return (D > kCols || Dv > kCols) ? Width::k2 : Width::k1;
}

}  // namespace

extern "C" {

// Every entry: one launch over tokens [t_begin, t_begin + n) of N, on the
// caller's stream; dtype 0 = float32 q/k/v/do/dq/dk/dv, 1 = bfloat16;
// returns cudaGetLastError() after the launch.

// Launch A': the carry slots. f0..f5 the final carry (m2, g2 may be null
// at p = 1), read when from_slot is 0. wsm [ceil(n/L), bh, R, Dv] f32,
// wsg [ceil(n/L), bh, R] f64.
int fastmax_causal_bwd_slots(int dtype, const void* k, const void* v,
                             const void* f0, const void* f1, const void* f2,
                             const void* f3, const void* f4, const void* f5,
                             int from_slot, void* wsm, void* wsg, int bh,
                             int N, int t_begin, int n, int D, int Dv, int p,
                             void* stream) {
  if (!dims_ok(bh, 1, N, t_begin, n, D, Dv, p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const State fin = state_of(f0, f1, f2, f3, f4, f5);
  if (dtype == 0)
    return p == 1 ? launch_slots<float, double>(k, v, fin, from_slot, wsm,
                                                wsg, bh, N, t_begin, n, D,
                                                Dv, p, s)
                  : launch_slots<float, float>(k, v, fin, from_slot, wsm, wsg,
                                               bh, N, t_begin, n, D, Dv, p,
                                               s);
  return p == 1 ? launch_slots<__nv_bfloat16, double>(
                      k, v, fin, from_slot, wsm, wsg, bh, N, t_begin, n, D,
                      Dv, p, s)
                : launch_slots<__nv_bfloat16, float>(
                      k, v, fin, from_slot, wsm, wsg, bh, N, t_begin, n, D,
                      Dv, p, s);
}

// Launch B': the queries. dq [bh*G, N, D]; uws [bh*G, N, Dv] and
// sws [bh*G, N] f32 receive u and sden.
int fastmax_causal_bwd_queries(int dtype, const void* q, const void* k,
                               const void* v, const void* dout,
                               const void* wsm, const void* wsg, void* dq,
                               void* uws, void* sws, int bh, int G, int N,
                               int t_begin, int n, int D, int Dv, int p,
                               float eps, void* stream) {
  if (!dims_ok(bh, G, N, t_begin, n, D, Dv, p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QUERIES(T, NCV, NCK, A)                                              \
  launch_queries<T, NCV, NCK, A>(q, k, v, dout, wsm, wsg, dq, uws, sws, bh,  \
                                 G, N, t_begin, n, D, Dv, p, eps, s)
#define BY_WIDTH(T, A)                                                       \
  (w == Width::k23 ? QUERIES(T, 2, 3, A)                                     \
                   : w == Width::k2 ? QUERIES(T, 2, 2, A)                    \
                                    : QUERIES(T, 1, 1, A))
  const Width w = width_of(D, Dv);
  // the denominator in f64 at p = 1 (as the prefill's combine)
  if (dtype == 0)
    return p == 1 ? BY_WIDTH(float, double) : BY_WIDTH(float, float);
  return p == 1 ? BY_WIDTH(__nv_bfloat16, double)
                : BY_WIDTH(__nv_bfloat16, float);
#undef BY_WIDTH
#undef QUERIES
}

// Launch C: the cotangent slots. zcm [bh, R, Dv], zcg [bh, R] f32 (null:
// one segment), read when seeded, written after chunk 0; d0..d5 the dstate
// outputs (d0 null: none; m2, g2 not written at p = 1). wzm [ceil(n/L),
// bh, R, Dv], wzg [ceil(n/L), bh, R] f32.
int fastmax_causal_bwd_cot(int dtype, const void* q, const void* uws,
                           const void* sws, void* zcm, void* zcg, int seeded,
                           void* d0, void* d1, void* d2, void* d3, void* d4,
                           void* d5, void* wzm, void* wzg, int bh, int G,
                           int N, int t_begin, int n, int D, int Dv, int p,
                           void* stream) {
  if (!dims_ok(bh, G, N, t_begin, n, D, Dv, p) ||
      (seeded && zcm == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const State ds = state_of(d0, d1, d2, d3, d4, d5);
  if (dtype == 0)
    return launch_cot<float>(q, uws, sws, zcm, zcg, seeded, ds, wzm, wzg, bh,
                             G, N, t_begin, n, D, Dv, p, s);
  return launch_cot<__nv_bfloat16>(q, uws, sws, zcm, zcg, seeded, ds, wzm,
                                   wzg, bh, G, N, t_begin, n, D, Dv, p, s);
}

// Launch D: the keys. dk [bh, N, D], dv [bh, N, Dv].
int fastmax_causal_bwd_keys(int dtype, const void* q, const void* k,
                            const void* v, const void* uws, const void* sws,
                            const void* wzm, const void* wzg, void* dk,
                            void* dv, int bh, int G, int N, int t_begin,
                            int n, int D, int Dv, int p, void* stream) {
  if (!dims_ok(bh, G, N, t_begin, n, D, Dv, p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KEYS(T, NCV, NCK)                                                    \
  launch_keys<T, NCV, NCK>(q, k, v, uws, sws, wzm, wzg, dk, dv, bh, G, N,    \
                           t_begin, n, D, Dv, p, s)
#define BY_WIDTH(T)                                                          \
  (w == Width::k23 ? KEYS(T, 2, 3)                                           \
                   : w == Width::k2 ? KEYS(T, 2, 2) : KEYS(T, 1, 1))
  const Width w = width_of(D, Dv);
  return dtype == 0 ? BY_WIDTH(float) : BY_WIDTH(__nv_bfloat16);
#undef BY_WIDTH
#undef KEYS
}

}  // extern "C"
