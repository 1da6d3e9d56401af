// Kernel #3 — the segment-masked fused local track of one ProteinBERT block
// over PACKED rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel proteinbert_tpu/kernels/fused_block.py
// `_fused_segment_kernel` (fused_block.py:977-1019, launched at :1134 by
// `_pallas_segments_forward`, entry `fused_local_track_segments`), its
// floating-point leg. It computes `local_track_segment_oh_reference`
// (fused_block.py:299-349) at the Pallas kernel's rounding points: tap
// products, conv outputs and the own-segment broadcast gather in float32,
// the mask applied in the activation type (exact for 0/1), x1 rounded
// before the dense.
//
// What bounds it on the H100: operations, as K1 — 2*B*L*C^2*19 FLOP, 40.8
// GFLOP at B=8, L=512, C=512 (0.0413 ms at 989 TFLOP/s bf16); the gather
// adds 2*B*L*S*C (34 MFLOP at S=8).
//
// Design: K1's (local_track.cuh with SEG = true): the same (TL+40, C)
// window, weight double buffer and single launch per block layer. The
// TPU kernel masked each tap with the one-hot product sum_s oh[l]·oh[l+off];
// with integer ids that is seg[l+off] == seg[l] && 1 <= seg[l] <= S, tested
// per (row, tap) from the window's ids in shared memory while each A
// k-chunk is copied into a (TL, KC) staging tile, zeroed where masked — the
// product then sees exact zeros, the weight stream is untouched. The
// broadcast gather reads row seg[l]-1 of the (S, C) per-segment broadcast.

#include "local_track.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, bcast (B, S, C), conv and dense
// kernels); seg is int32 (B, L), 0 = pad, 1..S a segment, anything else
// pad; biases and LN vectors are float32. Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int pbt_local_track_segments(
    int dtype, const void* x, const void* seg, const void* bcast,
    const void* nk, const void* nb, const void* wk, const void* wb,
    const void* s1, const void* b1, const void* dk, const void* db,
    const void* s2, const void* b2, void* out, int B, int L, int C, int S,
    int wide_dilation, void* stream) {
  if (!pbt::track_geometry_ok(B, L, S, wide_dilation) || seg == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pbt::launch_track<float, true>(
        C,
        pbt::track_args<float>(x, seg, bcast, nk, nb, wk, wb, s1, b1, dk, db,
                               s2, b2, out, L, S, wide_dilation),
        B, s);
  if (dtype == 1)
    return pbt::launch_track<__nv_bfloat16, true>(
        C,
        pbt::track_args<__nv_bfloat16>(x, seg, bcast, nk, nb, wk, wb, s1, b1,
                                       dk, db, s2, b2, out, L, S,
                                       wide_dilation),
        B, s);
  return cudaErrorInvalidValue;
}
