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

namespace pbt {

template <typename T, int VD>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ x, const float* __restrict__ oh,
                     const T* __restrict__ g, const T* __restrict__ wq,
                     const T* __restrict__ wk, const T* __restrict__ wv,
                     T* __restrict__ out, int L, int C, int G, int S,
                     int zero_empty) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  attention_head<T, VD>(x + size_t(b) * L * C, g + size_t(b) * S * G, wq,
                         wk, wv, out + size_t(b) * S * G, L, C, G, S, h,
                         zero_empty, OneHotMask{oh + size_t(b) * L * S, S},
                         smem);
}

template <typename T, int VD>
cudaError_t launch(const void* x, const void* oh, const void* g,
                   const void* wq, const void* wk, const void* wv, void* out,
                   int B, int L, int C, int G, int S, int H, int zero_empty,
                   cudaStream_t stream) {
  const size_t smem = AttnSmem<T, VD>::total(L, S);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<T, VD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(H, B);
  attention_kernel<T, VD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(oh),
      static_cast<const T*>(g), static_cast<const T*>(wq),
      static_cast<const T*>(wk), static_cast<const T*>(wv),
      static_cast<T*>(out), L, C, G, S, zero_empty);
  return cudaGetLastError();
}

// The value_dim instantiation G / H names.
template <typename T>
cudaError_t launch_vd(const void* x, const void* oh, const void* g,
                      const void* wq, const void* wk, const void* wv,
                      void* out, int B, int L, int C, int G, int S, int H,
                      int zero_empty, cudaStream_t stream) {
  if (G == H * 64)
    return launch<T, 64>(x, oh, g, wq, wk, wv, out, B, L, C, G, S, H,
                         zero_empty, stream);
  if (G == H * 128)
    return launch<T, 128>(x, oh, g, wq, wk, wv, out, B, L, C, G, S, H,
                          zero_empty, stream);
  return cudaErrorInvalidValue;
}

}  // namespace pbt

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
  if (B < 1 || L < 1 || H < 1 || C % pbt::kKc || S < 1 || S > pbt::kMaxS)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pbt::launch_vd<float>(x, oh, g, wq, wk, wv, out, B, L, C, G, S,
                                 H, zero_empty, s);
  if (dtype == 1)
    return pbt::launch_vd<__nv_bfloat16>(x, oh, g, wq, wk, wv, out, B, L,
                                         C, G, S, H, zero_empty, s);
  return cudaErrorInvalidValue;
}
