// K2 — global attention of one ProteinBERT block over segment ids, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel proteinbert_tpu/kernels/attention.py
// `_attention_kernel` / `_attention_body` (launched at :319 by
// `_pallas_attention_forward`; entries `fused_global_attention`, S=1, and
// `fused_packed_attention`). In bfloat16 the device code and its design are
// in attention_sm90.cuh: a query pass, one projection GEMM for all heads on
// wgmma fed by TMA (hopper.cuh) whose epilogue writes the scores and V, and
// a softmax / weighted-sum pass. In float32, attention.cuh's CUDA-core plan:
// one block per (head, row), a K pass into (L, S) float32 scores, the masked
// softmax, a V pass folded into the (S, v) sums. key_dim is 64; value_dim
// is 64 or 128, each its own instantiation.
//
// What bounds it on the H100: operations — the K and V projections,
// 2*B*H*L*C*(k+v) FLOP (attention.py:308), 4.3 GFLOP at B=8, L=512,
// C=G=512, H=8, k=v=64 (4.4 us at 989 TFLOP/s bf16; its bytes take ~1.7 us),
// 34.4 GFLOP at B=8, L=C=G=1024, H=16 (35 us).

#include "attention_sm90.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, g, wq, wk, wv, out); ids is int32
// (B, L): s + 1 where position l belongs to segment s, anything else none.
// In bfloat16 the scratches q (B, S, H, 64) float32, scores (B, H, S, L)
// float32 and v (B, L, G) bfloat16 (null in float32), and x, wk, wv 16-byte
// aligned (TMA). Requires key_dim == 64, value_dim G / H in {64, 128},
// C % 32 == 0, 1 <= S <= 16; in float32 L * S scores fit shared memory.
// Returns cudaGetLastError() after the last launch (0 = launched),
// cudaErrorInvalidValue where a tensor map cannot be encoded.
extern "C" int pbt_global_attention(int dtype, const void* x, const void* ids,
                                    const void* g, const void* wq,
                                    const void* wk, const void* wv, void* q,
                                    void* scores, void* v, void* out, int B,
                                    int L, int C, int G, int S, int H,
                                    int zero_empty, void* stream) {
  if (!pbt::attention_geometry_ok(B, L, C, S, H)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  const pbt::AttnScratch sc{static_cast<float*>(q),
                            static_cast<float*>(scores),
                            static_cast<pbt::bf16*>(v), nullptr, nullptr};
  if (dtype == 0)
    return pbt::launch_k2<float, false>(
        x, id, g, pbt::attn_weights<float, false>(wq, wk, wv), sc, out, B, L,
        C, G, S, H, zero_empty, s);
  if (dtype == 1)
    return pbt::launch_k2<pbt::bf16, false>(
        x, id, g, pbt::attn_weights<pbt::bf16, false>(wq, wk, wv), sc, out,
        B, L, C, G, S, H, zero_empty, s);
  return cudaErrorInvalidValue;
}
