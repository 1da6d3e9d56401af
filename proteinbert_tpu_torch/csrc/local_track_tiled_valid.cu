// #2's prehaloed entry — the channel-tiled local track of one ProteinBERT
// block over one sequence shard whose halo rows are a neighbour shard's real
// rows, for Hopper (sm_90a), at 512 < C <= 2048 (C a multiple of 128).
//
// Replaces the TPU kernel proteinbert_tpu/kernels/fused_block.py
// `_fused_kernel_tiled` as `_pallas_forward(..., prehaloed=True)` launches
// it (:741-758, pallas_call at :881; entry `fused_local_track_valid`,
// :1310-1321). The device code is #2's (local_track_tiled.cuh, SEG = false)
// with TrackArgs::halo set: the conv pass's window reads rows [-halo,
// L + halo) of the shard and zero-fills beyond them (in bfloat16 the TMA
// tensor map spans the (L + 2*halo)-row shard, so its out-of-bounds zero
// fill is that padding); the float32 scratch and the finish pass stay
// (B, L, C). Each output's sums run in one order that depends on its
// window alone, so every shard's centre equals the whole row's track bit
// for bit. Its bound and design are #2's.

#include "local_track_tiled.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x (B, L + 2*halo, C), bcast (B, C),
// conv and dense kernels, out (B, L, C)); biases and LN vectors are float32;
// h is a float32 (B, L, C) scratch; the halo is the convs' reach, (k-1)/2 *
// max(nd, wd) rows. In bfloat16, x, nk, wk and dk 16-byte aligned (TMA).
// Returns cudaGetLastError() after the second launch (0 = both launched),
// cudaErrorInvalidValue where a tensor map cannot be encoded.
// narrow_taps, wide_taps (odd) and both dilations are the convs' geometry:
// the preset instantiation at 9/9 taps, narrow dilation 1 and wide
// dilation <= 5, the general one elsewhere (`pbt::Taps`). Both convs take the
// same taps (JAX's tiled plan refuses unequal ones).
extern "C" int pbt_local_track_tiled_valid(
    int dtype, const void* x, const void* bcast, const void* nk,
    const void* nb, const void* wk, const void* wb, const void* s1,
    const void* b1, const void* dk, const void* db, const void* s2,
    const void* b2, void* h, void* out, int B, int L, int C, int narrow_taps,
    int wide_taps, int narrow_dilation, int wide_dilation, void* stream) {
  const pbt::Taps taps{narrow_taps, wide_taps, narrow_dilation,
                       wide_dilation};
  if (!pbt::tiled_geometry_ok(B, L, C, 1, taps)) return cudaErrorInvalidValue;
  const int halo = taps.halo();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scratch = static_cast<float*>(h);
  if (dtype == 0)
    return pbt::launch_tiled<float, false>(
        pbt::track_args<float>(x, nullptr, bcast, nk, nb, wk, wb, s1, b1, dk,
                               db, s2, b2, out, L, 1, taps, nullptr,
                               nullptr, nullptr, halo),
        B, C, scratch, s);
  if (dtype == 1)
    return pbt::launch_tiled<__nv_bfloat16, false>(
        pbt::track_args<__nv_bfloat16>(x, nullptr, bcast, nk, nb, wk, wb, s1,
                                       b1, dk, db, s2, b2, out, L, 1, taps,
                                       nullptr, nullptr,
                                       nullptr, halo),
        B, C, scratch, s);
  return cudaErrorInvalidValue;
}
