// Hybrid near/far-field causal attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `hybrid_causal_pallas`
// (src/repro/kernels/hybrid_causal.py, body `_hybrid_kernel`), with its
// final moment carry emitted (`return_state=True`; no init_state, as there).
//
// What it computes, per (batch, kv-head) bh with G grouped query heads, on
// pre-normalized q̂, k̂: for each query row i,
//   num_i = sum_{j<=i} w_j f(s_ij) v_j
//           + sum_{0 <= i-j < w_eff} w_j (exp(s_ij) - f(s_ij)) v_j
//   den_i = the same sums without v_j;   o_i = num_i / (den_i + eps)
// with f(s) = 1 + s [+ s^2/2] and s_ij = q̂_i . k̂_j in float32, and the
// final six-moment carry of the fastmax far field. The exponential is the
// reference's unshifted exp(s): no max shift, no clamp.
//
// What bounds it on an H100: arithmetic, as the causal prefill. Per bh the
// degree-2 combine and fold cost (G + 1) * N * D(D+1) * (Dv+1) operations
// on the symmetric half; the band's pairs inside a chunk are intra-chunk
// pairs already (weighed exp instead of f), and those reaching back past
// the chunk's start add 2 * G * (D + Dv) each (their scores and their
// products with v), at most 2 * G * N * w_eff * (D + Dv): 0.46 % more at
// qwen3's shapes (G = 2, N = 1024, D = Dv = 128, w_eff = C = 64, where
// 30,240 of the 63,520 band pairs per query head lie before their
// chunk). This version runs both in
// f32 on the CUDA cores (tensor cores, wgmma and TMA are later work).
//
// Design: the causal prefill's chunked scan (causal_scan.cuh) with the
// band. Its far field and intra-chunk terms are the prefill's, unchanged.
// The band needs no carry: its keys are read from device memory. In the
// chunk, the in-band pairs of the intra-chunk score block get the
// (exp - f) correction in place. Before the chunk, the band reaches the
// w_eff - 1 keys ahead of its first query, which may span several of the
// kernel's chunks (the kernel picks C <= 64 for itself, but w_eff follows
// the model's chunk, up to 512): they are loaded C at a time and scored
// only inside the band, with the ragged edge at token 0 masked. Every Dv
// column block scores every band pair, so each holds the whole
// denominator. Requires D % 4 == 0, Dv % 4 == 0 and G <= 128 (checked by
// the wrapper).
#include "causal_scan.cuh"

extern "C" {

// Shared-memory bytes the kernel needs at (G, C, D); the wrapper picks C.
long hybrid_causal_smem_bytes(int G, int C, int D) {
  (void)G;
  return (long)sizeof(float) * causal_scan::smem_floats(C, D);
}

// dtype: 0 = float32 q/k/v/o, 1 = bfloat16. Mask and state are f32.
// w_eff >= 1 is the band width in tokens, the diagonal included.
int hybrid_causal_forward(int dtype, const void* q, const void* k,
                          const void* v, const void* w, void* o, void* m0o,
                          void* m1o, void* m2o, void* g0o, void* g1o,
                          void* g2o, int bh, int G, int N, int D, int Dv,
                          int p, int C, int w_eff, float eps, void* stream) {
  return causal_scan::dispatch(dtype, q, k, v, w, nullptr, nullptr, nullptr,
                               nullptr, nullptr, nullptr, o, m0o, m1o, m2o,
                               g0o, g1o, g2o, bh, G, N, D, Dv, p, C, w_eff,
                               eps, stream);
}

}  // extern "C"
