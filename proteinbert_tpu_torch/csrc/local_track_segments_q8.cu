// Kernel #3's int8 leg — the segment-masked fused local track of one
// ProteinBERT block over PACKED rows with int8 conv and dense weights, for
// Hopper (sm_90a).
//
// Replaces the int8 leg of the TPU kernel proteinbert_tpu/kernels/
// fused_block.py `_fused_segment_kernel` (the `quantized` branch,
// fused_block.py:983-998; operands at :1086-1097; launched at :1134, entry
// `fused_local_track_segments` for C <= 512, :414-420). The TPU kernel held
// the int8 weights and their float32 scales ((taps, 1, C) for the convs,
// (1, C) for the dense) in VMEM and dequantized them per tile (q·scale in
// float32, cast to the activation type). Here the device code is #3's
// (local_track.cuh, SEG = true, Q8 = true): each (KC, C) weight tile is
// dequantized on its way from device memory into the same shared-memory
// tile the floating-point leg's cp.async fills (common.cuh `Q8Tile`), so
// the products, masks and rounding points are #3's and the output is bit
// for bit #3's on the dequantized weights.
//
// What bounds it on the H100: operations, as #3 — 2*B*L*C^2*19 FLOP, 40.8
// GFLOP at B=8, L=512, C=512 (0.0413 ms at 989 TFLOP/s bf16). The design
// needs no shared memory beyond #3's (212,608 bytes at C=512 in bf16, of
// 232,448): an int8 staging buffer would not fit. So the next step's int8
// tile waits in registers (64 bytes a thread at C=512) while this step's
// product runs, and is converted into the free half of the double buffer
// after it (`pipelined_steps_staged`): the weight stream overlaps the
// products as the floating-point leg's cp.async does.

#include "local_track.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, bcast (B, S, C), out); the conv
// kernels nq, wq are int8 (9, C, C) with float32 scales ns, ws (9, C), the
// dense dq int8 (C, C) with ds (C,); seg is int32 (B, L), 0 = pad, 1..S a
// segment, anything else pad; biases and LN vectors are float32. C is 128,
// 256 or 512. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int pbt_local_track_segments_q8(
    int dtype, const void* x, const void* seg, const void* bcast,
    const void* nq, const void* ns, const void* nb, const void* wq,
    const void* ws, const void* wb, const void* s1, const void* b1,
    const void* dq, const void* ds, const void* db, const void* s2,
    const void* b2, void* out, int B, int L, int C, int S, int wide_dilation,
    void* stream) {
  if (!pbt::track_geometry_ok(B, L, S, wide_dilation) || seg == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pbt::launch_track<float, true, true>(
        C,
        pbt::track_args<float, true>(x, seg, bcast, nq, nb, wq, wb, s1, b1,
                                     dq, db, s2, b2, out, L, S,
                                     wide_dilation, ns, ws, ds),
        B, s);
  if (dtype == 1)
    return pbt::launch_track<__nv_bfloat16, true, true>(
        C,
        pbt::track_args<__nv_bfloat16, true>(x, seg, bcast, nq, nb, wq, wb,
                                             s1, b1, dq, db, s2, b2, out, L,
                                             S, wide_dilation, ns, ws, ds),
        B, s);
  return cudaErrorInvalidValue;
}
