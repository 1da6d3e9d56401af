// K2's int8 leg — global attention of one ProteinBERT block over segment
// ids with int8 projection weights, for Hopper (sm_90a).
//
// Replaces the int8 leg of the TPU kernel proteinbert_tpu/kernels/
// attention.py `_attention_kernel` (the `quantized` branch, attention.py:
// 262-272; operands at :285-298; launched at :319, entries
// `fused_global_attention` and `fused_packed_attention`, :429-433 and
// :480-483). The TPU kernel held int8 wq, wk, wv and their (H, 1, ·) float32
// scales in VMEM and dequantized them per grid step (q·scale in float32,
// cast to the activation type). In bfloat16 (attention_sm90.cuh, Q8 =
// true) a dequantize pass turns wk and wv into bf16 scratches, each value
// the one the floating-point leg loads from the dequantized weights, and
// the floating-point leg's projection and softmax passes run on them; the
// query pass dequantizes each wq value it reads. In float32 (attention.cuh,
// Q8 = true) each wk / wv tile is dequantized on its way into the shared
// tile the floating-point leg's cp.async fills. Either way the int8 leg's
// output is bit for bit the floating-point leg's on the dequantized weights.
//
// What bounds it on the H100: operations, as K2 — 2*B*H*L*C*(k+v) FLOP
// for the K and V projections (attention.py:308), 4.3 GFLOP at B=8, L=512,
// C=G=512, H=8 (4.4 us at 989 TFLOP/s bf16). The dequantize pass moves
// H*C*(k+v) int8 values in and bf16 values out (0.4 us at the base width).

#include "attention_sm90.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, g, out); wq, wk, wv int8 (H, G, 64),
// (H, C, 64), (H, C, G / H) with float32 scales sq (H, 64), sk (H, 64),
// sv (H, G / H), each 16-byte aligned; ids is int32 (B, L) as for K2. In
// bfloat16 the scratches wkd (H, C, 64) and wvd (H, C, G / H) bfloat16, q,
// scores and v as for K2 (null in float32), and x 16-byte aligned (TMA).
// Requires value_dim G / H in {64, 128}, C % 32 == 0, 1 <= S <= 16.
// Returns cudaGetLastError() after the last launch (0 = launched).
extern "C" int pbt_global_attention_q8(
    int dtype, const void* x, const void* ids, const void* g, const void* wq,
    const void* sq, const void* wk, const void* sk, const void* wv,
    const void* sv, void* wkd, void* wvd, void* q, void* scores, void* v,
    void* out, int B, int L, int C, int G, int S, int H, int zero_empty,
    void* stream) {
  if (!pbt::attention_geometry_ok(B, L, C, S, H)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  const pbt::AttnScratch sc{
      static_cast<float*>(q), static_cast<float*>(scores),
      static_cast<pbt::bf16*>(v), static_cast<pbt::bf16*>(wkd),
      static_cast<pbt::bf16*>(wvd)};
  if (dtype == 0)
    return pbt::launch_k2<float, true>(
        x, id, g, pbt::attn_weights<float, true>(wq, wk, wv, sq, sk, sv), sc,
        out, B, L, C, G, S, H, zero_empty, s);
  if (dtype == 1)
    return pbt::launch_k2<pbt::bf16, true>(
        x, id, g, pbt::attn_weights<pbt::bf16, true>(wq, wk, wv, sq, sk, sv),
        sc, out, B, L, C, G, S, H, zero_empty, s);
  return cudaErrorInvalidValue;
}
