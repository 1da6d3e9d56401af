// Kernel #3 — the segment-masked fused local track of one ProteinBERT block
// over PACKED rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel proteinbert_tpu/kernels/fused_block.py
// `_fused_segment_kernel` (fused_block.py:977-1019, launched at :1134 by
// `_pallas_segments_forward`, entry `fused_local_track_segments`), its
// floating-point leg, at C in {128, 256, 512}. It computes
// `local_track_segment_oh_reference` (fused_block.py:299-349) at the Pallas
// kernel's rounding points: tap products, conv outputs and the own-segment
// broadcast gather in float32, the mask exact (+0.0 across segments), x1
// rounded before the dense, h summed in K1's order.
//
// What bounds it on the H100: operations, as K1 — 2*B*L*C^2*19 FLOP, 40.8
// GFLOP at B=8, L=512, C=512 (0.0413 ms at 989 TFLOP/s bf16); the gather
// adds 2*B*L*S*C (34 MFLOP at S=8). The design adds L2 -> SM traffic:
// ~0.30 GB (conv) + ~0.07 GB (finish) a call at that shape.
//
// Design. bfloat16 runs K1's two passes of local_track_sm90.cuh with SEG =
// true: the TPU kernel masked each tap with the one-hot product
// sum_s oh[l]·oh[l+off]; with integer ids that is seg[l+off] == seg[l] &&
// 1 <= seg[l] <= S, turned once per block into a keep bit per (fragment
// row, conv, tap) from the window's ids in shared memory; a masked row's A
// registers are zeroed after ldmatrix, so the product sees exact zeros with
// no staging tile and no extra barrier (`track_tile` stages each masked A
// chunk behind one more block barrier a step). The conv pass's epilogue
// gathers row seg[l]-1 of the (S, C) per-segment broadcast. float32 keeps
// the CUDA-core plan (local_track.cuh `track_tile`, SEG = true), which
// copies each A chunk into a staging tile zeroed where masked.

#include "local_track_sm90.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, bcast (B, S, C), conv and dense
// kernels, out); seg is int32 (B, L), 0 = pad, 1..S a segment, anything
// else pad; biases and LN vectors are float32; h is a float32 (B, L, C)
// scratch in bfloat16 (unused, may be null, in float32). C is 128, 256 or
// 512; in bfloat16, x, nk, wk and dk 16-byte aligned (TMA). Returns
// cudaGetLastError() after the last launch (0 = launched),
// cudaErrorInvalidValue where a tensor map cannot be encoded.
extern "C" int pbt_local_track_segments(
    int dtype, const void* x, const void* seg, const void* bcast,
    const void* nk, const void* nb, const void* wk, const void* wb,
    const void* s1, const void* b1, const void* dk, const void* db,
    const void* s2, const void* b2, void* h, void* out, int B, int L, int C,
    int S, int wide_dilation, void* stream) {
  if (!pbt::track_geometry_ok(B, L, S, wide_dilation) || seg == nullptr ||
      C > 512)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pbt::launch_track<float, true>(
        C,
        pbt::track_args<float>(x, seg, bcast, nk, nb, wk, wb, s1, b1, dk, db,
                               s2, b2, out, L, S, wide_dilation),
        B, s);
  if (dtype == 1 && pbt::sm90_shape_ok(B, C) && h != nullptr)
    return pbt::launch_track_sm90<true, pbt::SumOrder::kK1>(
        pbt::track_args<pbt::bf16>(x, seg, bcast, nk, nb, wk, wb, s1, b1, dk,
                                   db, s2, b2, out, L, S, wide_dilation),
        B, C, static_cast<float*>(h), s);
  return cudaErrorInvalidValue;
}
