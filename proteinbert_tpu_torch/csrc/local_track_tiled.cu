// #2 — the channel-tiled local track of one ProteinBERT block over dense
// rows, for Hopper (sm_90a), at 512 < C <= 2048 (C a multiple of 128).
//
// Replaces the TPU kernel proteinbert_tpu/kernels/fused_block.py
// `_fused_kernel_tiled` (launched at :881 by `_pallas_forward`, entry
// `fused_local_track`). It computes what K1 computes (local_track.cuh); the
// device code, its bound and its design are in local_track_tiled.cuh
// (SEG = false): in bfloat16 a conv pass and a finish pass on the tensor
// cores through wgmma, fed by TMA (hopper.cuh); in float32 the CUDA-core
// plan.
//
// What bounds it on the H100: operations, 2*B*L*C^2*19 FLOP, 0.330 ms at
// B=8, L=C=1024 in bf16.

#include "local_track_tiled.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, bcast (B, C), conv and dense kernels,
// out); biases and LN vectors are float32; h is a float32 (B, L, C) scratch.
// Requires 512 < C <= 2048, C % 128 == 0; in bfloat16, x, nk, wk and dk
// 16-byte aligned (TMA). Returns cudaGetLastError() after the second launch
// (0 = both launched), cudaErrorInvalidValue where a tensor map cannot be
// encoded.
extern "C" int pbt_local_track_tiled(int dtype, const void* x,
                                     const void* bcast, const void* nk,
                                     const void* nb, const void* wk,
                                     const void* wb, const void* s1,
                                     const void* b1, const void* dk,
                                     const void* db, const void* s2,
                                     const void* b2, void* h, void* out,
                                     int B, int L, int C, int wide_dilation,
                                     void* stream) {
  if (!pbt::tiled_geometry_ok(B, L, C, 1, wide_dilation))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scratch = static_cast<float*>(h);
  if (dtype == 0)
    return pbt::launch_tiled<float, false>(
        pbt::track_args<float>(x, nullptr, bcast, nk, nb, wk, wb, s1, b1, dk,
                               db, s2, b2, out, L, 1, wide_dilation),
        B, C, scratch, s);
  if (dtype == 1)
    return pbt::launch_tiled<__nv_bfloat16, false>(
        pbt::track_args<__nv_bfloat16>(x, nullptr, bcast, nk, nb, wk, wb, s1,
                                       b1, dk, db, s2, b2, out, L, 1,
                                       wide_dilation),
        B, C, scratch, s);
  return cudaErrorInvalidValue;
}
