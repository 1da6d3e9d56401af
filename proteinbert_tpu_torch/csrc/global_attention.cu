// K2 — global attention of one ProteinBERT block over a one-hot segment
// mask, for Hopper (sm_90a).
//
// Replaces the TPU kernel proteinbert_tpu/kernels/attention.py
// `_attention_kernel` / `_attention_body` (launched at :319 by
// `_pallas_attention_forward`; entries `fused_global_attention`, S=1, and
// `fused_packed_attention`). The device code and its design are in
// attention.cuh: one block per (head, row), a K pass into (L, S) float32
// scores, the masked softmax, a V pass folded into the (S, v) sums. key_dim
// is 64; value_dim is 64 or 128, each its own instantiation.
//
// What bounds it on the H100: operations — the K and V projections,
// 2*B*H*L*C*(k+v) FLOP (attention.py:308), 4.3 GFLOP at B=8, L=512,
// C=G=512, H=8, k=v=64 (4.4 us at 989 TFLOP/s bf16; its bytes take ~1.7 us).

#include "attention.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, g, wq, wk, wv, out); oh is float32
// (B, L, S). Requires key_dim == 64, value_dim G / H in {64, 128},
// C % 32 == 0, 1 <= S <= 16. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int pbt_global_attention(int dtype, const void* x, const void* oh,
                                    const void* g, const void* wq,
                                    const void* wk, const void* wv,
                                    void* out, int B, int L, int C, int G,
                                    int S, int H, int zero_empty,
                                    void* stream) {
  if (!pbt::attention_geometry_ok(B, L, C, S, H)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pbt::launch_attention_vd<float, false>(
        x, oh, g, pbt::attn_weights<float, false>(wq, wk, wv), out, B, L, C,
        G, S, H, zero_empty, s);
  if (dtype == 1)
    return pbt::launch_attention_vd<__nv_bfloat16, false>(
        x, oh, g, pbt::attn_weights<__nv_bfloat16, false>(wq, wk, wv), out,
        B, L, C, G, S, H, zero_empty, s);
  return cudaErrorInvalidValue;
}
