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
// float32, cast to the activation type).
//
// What bounds it on the H100: operations, as #3 — 2*B*L*C^2*19 FLOP, 40.8
// GFLOP at B=8, L=512, C=512 (0.0413 ms at 989 TFLOP/s bf16). The
// dequantize pass reads 19*C^2 int8 values and writes them as bf16 (15 MB
// at C=512, 0.004 ms at 3.35 TB/s); #3's passes then add their ~0.37 GB of
// L2 -> SM traffic.
//
// Design. bfloat16 (local_track_sm90.cuh `launch_track_sm90_q8`): a
// dequantize pass turns the int8 weights into per-call bf16 scratches, each
// value from_f(q * scale) — the value the floating-point leg loads from the
// dequantized weights — and #3's two passes run on them, so the output is
// bit for bit #3's on the dequantized weights and each weight is converted
// once a call (`track_tile` converts all 19*C^2 of them once per row tile,
// ~640 M conversions a bf16 call, on the warps that run the products). The
// scratches live for one call; no dequantized copy stays resident. float32
// keeps the CUDA-core plan (local_track.cuh, SEG = true, Q8 = true): each
// (KC, C) weight tile is dequantized on its way from device memory into the
// shared-memory tile the floating-point leg's cp.async fills (common.cuh
// `Q8Tile`), so the products, masks and rounding points are #3's.

#include "local_track_sm90.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, bcast (B, S, C), out); the conv
// kernels nq, wq are int8 (9, C, C) with float32 scales ns, ws (9, C), the
// dense dq int8 (C, C) with ds (C,); seg is int32 (B, L), 0 = pad, 1..S a
// segment, anything else pad; biases and LN vectors are float32. In
// bfloat16 the scratches nkd, wkd (9, C, C) and dkd (C, C) bfloat16 and h
// (B, L, C) float32 (unused, may be null, in float32); x, nq, wq, dq and
// their scales 16-byte aligned (TMA, 16-byte loads). C is 128, 256 or 512.
// Returns cudaGetLastError() after the last launch (0 = launched),
// cudaErrorInvalidValue where a tensor map cannot be encoded.
extern "C" int pbt_local_track_segments_q8(
    int dtype, const void* x, const void* seg, const void* bcast,
    const void* nq, const void* ns, const void* nb, const void* wq,
    const void* ws, const void* wb, const void* s1, const void* b1,
    const void* dq, const void* ds, const void* db, const void* s2,
    const void* b2, void* nkd, void* wkd, void* dkd, void* h, void* out,
    int B, int L, int C, int S, int wide_dilation, void* stream) {
  if (!pbt::track_geometry_ok(B, L, S, wide_dilation) || seg == nullptr ||
      C > 512)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pbt::launch_track<float, true, true>(
        C,
        pbt::track_args<float, true>(x, seg, bcast, nq, nb, wq, wb, s1, b1,
                                     dq, db, s2, b2, out, L, S,
                                     wide_dilation, ns, ws, ds),
        B, s);
  if (dtype == 1 && pbt::sm90_shape_ok(B, C) && h != nullptr &&
      nkd != nullptr && wkd != nullptr && dkd != nullptr)
    return pbt::launch_track_sm90_q8(
        pbt::track_args<pbt::bf16, true>(x, seg, bcast, nq, nb, wq, wb, s1,
                                         b1, dq, db, s2, b2, out, L, S,
                                         wide_dilation, ns, ws, ds),
        static_cast<pbt::bf16*>(nkd), static_cast<pbt::bf16*>(wkd),
        static_cast<pbt::bf16*>(dkd), B, C, static_cast<float*>(h), s);
  return cudaErrorInvalidValue;
}
