// K1 — the fused local track of one ProteinBERT block over dense rows, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel proteinbert_tpu/kernels/fused_block.py
// `_fused_kernel` (launched at :804 by `_pallas_forward`, entry
// `fused_local_track`). The device code, its bound and its design are in
// local_track.cuh (SEG = false): one block per (32-row tile, row) in bf16,
// 16 rows in float32; ONE launch per block layer.

#include "local_track.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, bcast (B, C), conv and dense
// kernels); biases and LN vectors are float32. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int pbt_local_track(int dtype, const void* x, const void* bcast,
                               const void* nk, const void* nb,
                               const void* wk, const void* wb,
                               const void* s1, const void* b1,
                               const void* dk, const void* db,
                               const void* s2, const void* b2, void* out,
                               int B, int L, int C, int wide_dilation,
                               void* stream) {
  if (!pbt::track_geometry_ok(B, L, 1, wide_dilation))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pbt::launch_track<float, false>(
        C,
        pbt::track_args<float>(x, nullptr, bcast, nk, nb, wk, wb, s1, b1, dk,
                               db, s2, b2, out, L, 1, wide_dilation),
        B, s);
  if (dtype == 1)
    return pbt::launch_track<__nv_bfloat16, false>(
        C,
        pbt::track_args<__nv_bfloat16>(x, nullptr, bcast, nk, nb, wk, wb, s1,
                                       b1, dk, db, s2, b2, out, L, 1,
                                       wide_dilation),
        B, s);
  return cudaErrorInvalidValue;
}
