// Kernel #6's int8 leg — the one-pass trunk of one ProteinBERT block with
// int8 weights in both tracks, for Hopper (sm_90a).
//
// Replaces the int8 leg of the TPU kernel proteinbert_tpu/kernels/
// one_pass.py `_onepass_kernel` (the `quantized` branch, one_pass.py:
// 236-241; operands at :319-341; launched at :380, entries
// `fused_onepass_segments`, :499-504, and `fused_onepass_dense`,
// :564-568). The TPU kernel held the six int8 weight sets (narrow, wide,
// dense; wq, wk, wv) and their float32 scales in VMEM and dequantized them
// per tile (q·scale in float32, cast to the activation type). In bfloat16
// (one_pass_sm90.cuh, Q8 = true) a dequantize pass turns the track's three
// weight sets and the attention's wk / wv into per-call bf16 scratches, each
// value the one the floating-point leg loads from the dequantized weights,
// and the floating-point leg's passes run on them; the query pass
// dequantizes each wq value it reads. In float32 (one_pass.cuh, Q8 = true)
// each weight tile is dequantized on its way into the shared-memory tile the
// floating-point leg's cp.async fills (common.cuh `Q8Tile`). Either way the
// output is bit for bit #6's on the dequantized weights; no dequantized copy
// stays resident.
//
// What bounds it on the H100: operations, as #6 — 3.42 GFLOP at 8 rows x
// L=512, C=128, G=512, H=4, k=64, v=128, S=8, 0.0035 ms at 989 TFLOP/s
// bf16. The dequantize passes read 19*C^2 + H*C*(64 + v) int8 values and
// write them as bf16 (1.1 MB at C=128, H=4, v=128).

#include "one_pass.cuh"
#include "one_pass_sm90.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, bcast (B, S, C), g (B, S, G), both
// outputs). The conv kernels nq, wq are int8 (9, C, C) with float32 scales
// ns, ws (9, C); the dense dq int8 (C, C) with ds (C,); the attention's
// aq (H, G, 64), ak (H, C, 64), av (H, C, G / H) int8 with float32 scales
// aqs (H, 64), aks (H, 64), avs (H, G / H). seg (B, L) int32 for packed rows
// (seg_masked = 1; null for dense rows, where S must be 1); real (B, L)
// int32, nonzero at positions the attention may see; biases and LN vectors
// float32. value_dim G / H is 64 or 128; C is 128 or 256, or 512 in
// bfloat16. Outputs: local (B, L, C), attn (B, S, G). In bfloat16 `scratch`
// is one buffer of `onepass_scratch`'s parts, the int8 leg's first (null in
// float32), and x, the int8 weights and their scales 16-byte aligned.
// Returns cudaGetLastError() after the last launch (0 = launched).
extern "C" int pbt_onepass_q8(
    int dtype, int seg_masked, const void* x, const void* seg,
    const void* real, const void* bcast, const void* g, const void* nq,
    const void* ns, const void* nb, const void* wq, const void* ws,
    const void* wb, const void* s1, const void* b1, const void* dq,
    const void* ds, const void* db, const void* s2, const void* b2,
    const void* aq, const void* aqs, const void* ak, const void* aks,
    const void* av, const void* avs, void* local, void* attn, void* scratch,
    int B, int L, int C, int G, int S, int H, int wide_dilation,
    int zero_empty, void* stream) {
  if (!pbt::onepass_geometry_ok(seg_masked, seg, B, L, G, S, H,
                                wide_dilation))
    return cudaErrorInvalidValue;
  const int VD = G / H;
  const void* seg_ptr = seg_masked ? seg : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pbt::launch_shape<float, true>(
        C, VD, seg_masked,
        pbt::track_args<float, true>(x, seg_ptr, bcast, nq, nb, wq, wb, s1,
                                     b1, dq, db, s2, b2, local, L, S,
                                     wide_dilation, ns, ws, ds),
        real, g, pbt::attn_weights<float, true>(aq, ak, av, aqs, aks, avs),
        attn, B, G, H, zero_empty, s);
  if (dtype == 1)
    return pbt::launch_onepass_bf16<true>(
        seg_masked,
        pbt::track_args<pbt::bf16, true>(x, seg_ptr, bcast, nq, nb, wq, wb,
                                         s1, b1, dq, db, s2, b2, local, L, S,
                                         wide_dilation, ns, ws, ds),
        real, g,
        pbt::attn_weights<pbt::bf16, true>(aq, ak, av, aqs, aks, avs), attn,
        scratch, B, C, G, H, zero_empty, s);
  return cudaErrorInvalidValue;
}
