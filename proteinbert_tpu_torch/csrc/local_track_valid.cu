// K1's prehaloed entry — the fused local track of one ProteinBERT block over
// one sequence shard whose halo rows are a neighbour shard's real rows, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel proteinbert_tpu/kernels/fused_block.py
// `_fused_kernel` as `_pallas_forward(..., prehaloed=True)` launches it
// (:741-758, pallas_call at :804; entry `fused_local_track_valid`,
// :1310-1321), the local track of the explicit sequence-parallel path. The
// device code is K1's (local_track.cuh, SEG = false) with TrackArgs::halo
// set: the row base points halo rows into each (L + 2*halo)-row input row,
// and the window zero-fills only rows outside [-halo, L + halo). The output
// is the (B, L, C) centre. Its bound and design are K1's.

#include "local_track.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x (B, L + 2*halo, C), bcast (B, C),
// conv and dense kernels, out (B, L, C)); biases and LN vectors are float32;
// the halo is the convs' reach, kCenter * wide_dilation rows. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int pbt_local_track_valid(int dtype, const void* x,
                                     const void* bcast, const void* nk,
                                     const void* nb, const void* wk,
                                     const void* wb, const void* s1,
                                     const void* b1, const void* dk,
                                     const void* db, const void* s2,
                                     const void* b2, void* out, int B, int L,
                                     int C, int wide_dilation,
                                     void* stream) {
  if (!pbt::track_geometry_ok(B, L, 1, wide_dilation))
    return cudaErrorInvalidValue;
  const int halo = pbt::kCenter * wide_dilation;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pbt::launch_track<float, false>(
        C,
        pbt::track_args<float>(x, nullptr, bcast, nk, nb, wk, wb, s1, b1, dk,
                               db, s2, b2, out, L, 1, wide_dilation, nullptr,
                               nullptr, nullptr, halo),
        B, s);
  if (dtype == 1)
    return pbt::launch_track<__nv_bfloat16, false>(
        C,
        pbt::track_args<__nv_bfloat16>(x, nullptr, bcast, nk, nb, wk, wb, s1,
                                       b1, dk, db, s2, b2, out, L, 1,
                                       wide_dilation, nullptr, nullptr,
                                       nullptr, halo),
        B, s);
  return cudaErrorInvalidValue;
}
