// K2's int8 leg — global attention of one ProteinBERT block over a one-hot
// segment mask with int8 projection weights, for Hopper (sm_90a).
//
// Replaces the int8 leg of the TPU kernel proteinbert_tpu/kernels/
// attention.py `_attention_kernel` (the `quantized` branch, attention.py:
// 262-272; operands at :285-298; launched at :319, entries
// `fused_global_attention` and `fused_packed_attention`, :429-433 and
// :480-483). The TPU kernel held int8 wq, wk, wv and their (H, 1, ·) float32
// scales in VMEM and dequantized them per grid step (q·scale in float32,
// cast to the activation type). Here the device code is K2's
// (attention.cuh, Q8 = true): each wk / wv tile is dequantized on its way
// from device memory into the same shared-memory tile the floating-point
// leg's cp.async fills (common.cuh `load_rows_q8`), and the query
// projection dequantizes each wq value it reads. The tile is bit for bit
// the one the floating-point leg loads from the dequantized weights, so the
// two legs give the same output.
//
// What bounds it on the H100: operations, as K2 — 2*B*H*L*C*(k+v) FLOP
// for the K and V projections (attention.py:308), 4.3 GFLOP at B=8, L=512,
// C=G=512, H=8 (4.4 us at 989 TFLOP/s bf16). The int8 weights move a
// quarter of float32's bytes, but the convert-on-load is synchronous, so
// the weight tile's copy no longer overlaps the previous step's product.

#include "attention.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, g, out); wq, wk, wv int8 (H, G, 64),
// (H, C, 64), (H, C, G / H) with float32 scales sq (H, 64), sk (H, 64),
// sv (H, G / H); oh is float32 (B, L, S). Requires value_dim G / H in
// {64, 128}, C % 32 == 0, 1 <= S <= 16. Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int pbt_global_attention_q8(int dtype, const void* x,
                                       const void* oh, const void* g,
                                       const void* wq, const void* sq,
                                       const void* wk, const void* sk,
                                       const void* wv, const void* sv,
                                       void* out, int B, int L, int C, int G,
                                       int S, int H, int zero_empty,
                                       void* stream) {
  if (!pbt::attention_geometry_ok(B, L, C, S, H)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pbt::launch_attention_vd<float, true>(
        x, oh, g, pbt::attn_weights<float, true>(wq, wk, wv, sq, sk, sv), out,
        B, L, C, G, S, H, zero_empty, s);
  if (dtype == 1)
    return pbt::launch_attention_vd<__nv_bfloat16, true>(
        x, oh, g,
        pbt::attn_weights<__nv_bfloat16, true>(wq, wk, wv, sq, sk, sv), out,
        B, L, C, G, S, H, zero_empty, s);
  return cudaErrorInvalidValue;
}
