// #4 — the channel-tiled segment-masked local track of one ProteinBERT block
// over PACKED rows, for Hopper (sm_90a), at 512 < C <= 2048 (C a multiple of
// 128): ProteinBERT-Large (C = 1024) trained on packed rows.
//
// Replaces the TPU kernel proteinbert_tpu/kernels/fused_block.py
// `_fused_segment_kernel_tiled` (fused_block.py:623-683, launched at :1220
// by `_pallas_segments_forward`, entry `fused_local_track_segments`), in
// bfloat16 and float32 (the JAX package has no float32 tiled plan and
// answers through XLA there; the port has no such route). It computes
// `local_track_segment_oh_reference` (fused_block.py:299-349) at the Pallas
// kernel's rounding points: #2's two passes (local_track_tiled.cuh with
// SEG = true) with #3's per-(row, tap) mask and the own-segment broadcast
// gathered in the wide conv's epilogue. In bfloat16 the conv pass runs on
// wgmma fed by TMA and the mask zeroes each masked row's A-fragment
// registers after ldmatrix; in float32 (the CUDA-core plan) the masked rows
// go through a staging tile.
//
// What bounds it on the H100: operations, as #2 — 2*B*L*C^2*19 FLOP, 326
// GFLOP at B=8, L=C=1024, 0.330 ms at 989 TFLOP/s bf16.

#include "local_track_tiled.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, bcast (B, S, C), conv and dense
// kernels, out); seg is int32 (B, L), 0 = pad, 1..S a segment, anything
// else pad; biases and LN vectors are float32; h is a float32 (B, L, C)
// scratch. Requires 512 < C <= 2048, C % 128 == 0; in bfloat16, x, nk, wk
// and dk 16-byte aligned (TMA). Returns cudaGetLastError() after the second
// launch (0 = both launched), cudaErrorInvalidValue where a tensor map
// cannot be encoded.
extern "C" int pbt_local_track_segments_tiled(
    int dtype, const void* x, const void* seg, const void* bcast,
    const void* nk, const void* nb, const void* wk, const void* wb,
    const void* s1, const void* b1, const void* dk, const void* db,
    const void* s2, const void* b2, void* h, void* out, int B, int L, int C,
    int S, int wide_dilation, void* stream) {
  if (!pbt::tiled_geometry_ok(B, L, C, S, wide_dilation) || seg == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scratch = static_cast<float*>(h);
  if (dtype == 0)
    return pbt::launch_tiled<float, true>(
        pbt::track_args<float>(x, seg, bcast, nk, nb, wk, wb, s1, b1, dk, db,
                               s2, b2, out, L, S, wide_dilation),
        B, C, scratch, s);
  if (dtype == 1)
    return pbt::launch_tiled<__nv_bfloat16, true>(
        pbt::track_args<__nv_bfloat16>(x, seg, bcast, nk, nb, wk, wb, s1, b1,
                                       dk, db, s2, b2, out, L, S,
                                       wide_dilation),
        B, C, scratch, s);
  return cudaErrorInvalidValue;
}
