// K1 — the fused local track of one ProteinBERT block over dense rows, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel proteinbert_tpu/kernels/fused_block.py
// `_fused_kernel` (:526, launched at :804 by `_pallas_forward`, entry
// `fused_local_track`), at C in {128, 256, 384, 512}.
//
// What bounds it on the H100: operations, 2*B*L*C^2*(nt + wt + 1) FLOP —
// 40.8 GFLOP with 9-tap convs at B=8, L=C=512, 0.0413 ms at 989 TFLOP/s
// bf16 — against ~9 MB of activation and weight bytes. The design below
// adds L2 -> SM traffic:
// ~0.30 GB (conv pass) + ~0.07 GB (finish pass) a call at B=8, L=C=512.
//
// Design. bfloat16 runs the two passes of local_track_sm90.cuh (SEG =
// false, K1's sum order): a conv pass on wgmma fed by TMA, 128 rows x 128
// output channels a block, both convs' weights streamed once per block
// through an eight-stage ring (`track_tile` re-reads all 10 MB of them
// for every 32-row tile, 1.28 GB from L2 a call, on WMMA with a barrier a
// step), then a finish pass (LN1, the dense on wgmma, LN2), meeting in a
// float32 (B, L, C) scratch. float32 keeps the CUDA-core plan
// (local_track.cuh `track_tile`, SEG = false): one block per (16-row tile,
// row), ONE launch per block layer.

#include "local_track_sm90.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, bcast (B, C), conv and dense
// kernels, out); biases and LN vectors are float32; h is a float32
// (B, L, C) scratch in bfloat16 (unused, may be null, in float32). C is
// 128, 256, 384 or 512; in bfloat16, x, nk, wk and dk 16-byte aligned (TMA).
// Returns cudaGetLastError() after the last launch (0 = launched),
// cudaErrorInvalidValue where a tensor map cannot be encoded.
// narrow_taps, wide_taps (odd) and both dilations are the convs' geometry:
// in bf16 the preset conv pass at 9/9 taps, narrow dilation 1 and wide
// dilation <= 5, the general one elsewhere (`pbt::Taps`); float32 has one
// plan for every geometry.
extern "C" int pbt_local_track(int dtype, const void* x, const void* bcast,
                               const void* nk, const void* nb,
                               const void* wk, const void* wb,
                               const void* s1, const void* b1,
                               const void* dk, const void* db,
                               const void* s2, const void* b2, void* h,
                               void* out, int B, int L, int C,
                               int narrow_taps, int wide_taps,
                               int narrow_dilation, int wide_dilation,
                               void* stream) {
  const pbt::Taps taps{narrow_taps, wide_taps, narrow_dilation,
                       wide_dilation};
  if (!pbt::track_geometry_ok(B, L, 1, taps) || C > 512)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pbt::launch_track<float, false>(
        C,
        pbt::track_args<float>(x, nullptr, bcast, nk, nb, wk, wb, s1, b1, dk,
                               db, s2, b2, out, L, 1, taps),
        B, s);
  if (dtype == 1 && pbt::sm90_shape_ok(B, C) && h != nullptr)
    return pbt::launch_track_sm90<false, pbt::SumOrder::kK1>(
        pbt::track_args<pbt::bf16>(x, nullptr, bcast, nk, nb, wk, wb, s1, b1,
                                   dk, db, s2, b2, out, L, 1, taps),
        B, C, static_cast<float*>(h), s);
  return cudaErrorInvalidValue;
}
