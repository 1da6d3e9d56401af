// K1's prehaloed entry — the fused local track of one ProteinBERT block over
// one sequence shard whose halo rows are a neighbour shard's real rows, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel proteinbert_tpu/kernels/fused_block.py
// `_fused_kernel` as `_pallas_forward(..., prehaloed=True)` launches it
// (:741-758, pallas_call at :804; entry `fused_local_track_valid`,
// :1310-1321), the local track of the explicit sequence-parallel path. The
// device code is K1's with TrackArgs::halo set: the row base points halo
// rows into each (L + 2*halo)-row input row, and the window zero-fills only
// rows outside [-halo, L + halo). The output is the (B, L, C) centre.
//
// What bounds it on the H100: operations, as K1 — 2*B*L*C^2*(nt + wt + 1)
// FLOP, 81.6 GFLOP at the `long` preset's shard shape B=16, L=512
// (+2*20), C=512, 0.0825 ms at 989 TFLOP/s bf16. The design adds L2 -> SM
// traffic: ~0.60 GB (conv) + ~0.13 GB (finish) a call at that shape.
//
// Design: K1's. In bfloat16 the two passes of local_track_sm90.cuh (SEG =
// false, K1's sum order), whose conv pass reads x by TMA through a 3-D map
// over the (L + 2*halo)-row shard: its out-of-bounds zero fill is the
// padding beyond the halo rows, and each output's sums run in one order
// that depends on its window alone, so every shard's centre equals the
// whole row's track bit for bit. The float32 scratch and the finish pass
// stay (B, L, C). float32 keeps the CUDA-core plan (local_track.cuh
// `track_tile`).

#include "local_track_sm90.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x (B, L + 2*halo, C), bcast (B, C), conv
// and dense kernels, out (B, L, C)); biases and LN vectors are float32; h is
// a float32 (B, L, C) scratch in bfloat16 (unused, may be null, in float32);
// the halo is the convs' reach, max((nt-1)/2 * nd, (wt-1)/2 * wd) rows (the
// JAX `track_halo`). C is 128, 256, 384 or 512; in bfloat16, x, nk, wk and
// dk 16-byte aligned (TMA). Returns cudaGetLastError() after the last launch
// (0 = launched), cudaErrorInvalidValue where a tensor map cannot be
// encoded.
// narrow_taps, wide_taps (odd) and both dilations are the convs' geometry:
// in bf16 the preset conv pass at 9/9 taps, narrow dilation 1 and wide
// dilation <= 5, the general one elsewhere (`pbt::Taps`); float32 has one
// plan for every geometry.
extern "C" int pbt_local_track_valid(int dtype, const void* x,
                                     const void* bcast, const void* nk,
                                     const void* nb, const void* wk,
                                     const void* wb, const void* s1,
                                     const void* b1, const void* dk,
                                     const void* db, const void* s2,
                                     const void* b2, void* h, void* out,
                                     int B, int L, int C, int narrow_taps,
                                     int wide_taps, int narrow_dilation,
                                     int wide_dilation, void* stream) {
  const pbt::Taps taps{narrow_taps, wide_taps, narrow_dilation,
                       wide_dilation};
  if (!pbt::track_geometry_ok(B, L, 1, taps) || C > 512)
    return cudaErrorInvalidValue;
  const int halo = taps.halo();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pbt::launch_track<float, false>(
        C,
        pbt::track_args<float>(x, nullptr, bcast, nk, nb, wk, wb, s1, b1, dk,
                               db, s2, b2, out, L, 1, taps, nullptr,
                               nullptr, nullptr, halo),
        B, s);
  if (dtype == 1 && pbt::sm90_shape_ok(B, C) && h != nullptr)
    return pbt::launch_track_sm90<false, pbt::SumOrder::kK1>(
        pbt::track_args<pbt::bf16>(x, nullptr, bcast, nk, nb, wk, wb, s1, b1,
                                   dk, db, s2, b2, out, L, 1, taps,
                                   nullptr, nullptr, nullptr, halo),
        B, C, static_cast<float*>(h), s);
  return cudaErrorInvalidValue;
}
