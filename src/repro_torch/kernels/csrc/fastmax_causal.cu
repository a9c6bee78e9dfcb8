// Causal fastmax prefill for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `fastmax_causal_pallas`
// (src/repro/kernels/fastmax_causal.py, body `_causal_kernel`), in its
// prefill form (`return_state=True`, optional `init_state`, `kv_mask`).
//
// What it computes, per (batch, kv-head) bh with G grouped query heads,
// walking the sequence in chunks of C tokens with the moment carry of all
// previous chunks (m0, m1, m2, g0, g1, g2 as in core/fastmax.py):
//   inter:  num = m0 + q.m1 + 1/2 sum_ab q_a q_b m2[ab, :]
//           den = g0 + q.g1 + 1/2 q^T g2 q
//   intra:  s = q k^T (C x C), f = (1 + s [+ s^2/2]) * causal * w,
//           num += f v, den += sum f
//   o = num / (den + eps); then the chunk (weighted by w) is folded into
//   the carry. The final carry is the kernel's state output, m2 in the
//   m-major [D*D, Dv] layout the decode kernel reads.
//
// What bounds it on an H100: arithmetic. Per bh the m2 terms cost
// (2G + 2) * N * D^2 * Dv operations (combine + fold), far above the bytes
// it must move. This version runs them in f32 on the CUDA cores (tensor
// cores, wgmma and TMA are later work).
//
// Design: the chunked scan in causal_scan.cuh (shared with the hybrid
// kernel, hybrid_causal.cu), run with no band (w_eff = 0). One block per
// (Dv column block of 32, bh) walks the chunks in order; the m2 carry is
// streamed from device memory once per chunk in tiles of 32 rows, and both
// m2 products are register-tiled (4 x 4 outputs per thread, float4).
// The chunk length C is chosen by the wrapper (G*C <= 128); it need not
// equal the model's chunk_size, since the moment fold is associative.
// Requires D % 4 == 0 and Dv % 4 == 0 (checked by the wrapper).
#include "causal_scan.cuh"

extern "C" {

// Shared-memory bytes the kernel needs at (G, C, D); the wrapper picks C.
long fastmax_causal_smem_bytes(int G, int C, int D) {
  (void)G;
  return (long)sizeof(float) * causal_scan::smem_floats(C, D);
}

// dtype: 0 = float32 q/k/v/o, 1 = bfloat16. Mask, init and state are f32.
// Pass null init pointers for a zero carry.
int fastmax_causal_prefill(int dtype, const void* q, const void* k,
                           const void* v, const void* w, const void* i0,
                           const void* i1, const void* i2, const void* j0,
                           const void* j1, const void* j2, void* o,
                           void* m0o, void* m1o, void* m2o, void* g0o,
                           void* g1o, void* g2o, int bh, int G, int N, int D,
                           int Dv, int p, int C, float eps, void* stream) {
  return causal_scan::dispatch(dtype, q, k, v, w, i0, i1, i2, j0, j1, j2, o,
                               m0o, m1o, m2o, g0o, g1o, g2o, bh, G, N, D, Dv,
                               p, C, /*w_eff=*/0, eps, stream);
}

}  // extern "C"
