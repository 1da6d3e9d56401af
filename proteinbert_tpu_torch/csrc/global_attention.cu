// K2 — global attention of one ProteinBERT block over a one-hot segment
// mask, for Hopper (sm_90a).
//
// Replaces the TPU kernel proteinbert_tpu/kernels/attention.py
// `_attention_kernel` / `_attention_body` (launched at :319 by
// `_pallas_attention_forward`; entries `fused_global_attention`, S=1, and
// `fused_packed_attention`). Per batch row b and head h, with x (L, C),
// the mask oh (L, S) and global rows g (S, G):
//
//   q_h = tanh(g @ wq[h])                    (S, k)
//   K_h = tanh(x @ wk[h]),  V_h = gelu(x @ wv[h])   (L, k), (L, v)
//   scores[l, s] = K_h[l] . q_h[s] / sqrt(k)  (float32), -1e30 where oh == 0
//   w = softmax over l (float32), rounded to the activation type
//   out[s, h*v:(h+1)*v] = w[:, s]^T V_h      (float32 sum), zero for an
//                                              empty segment if zero_empty
//
// Rounding points follow `_attention_body` (attention.py:195-228): each
// projection accumulates in float32 and is rounded to the activation type
// before tanh/gelu (and again after); the mask value is -1e30, so an
// all-masked column gets the uniform softmax, not NaN.
//
// What bounds it on the H100: operations — the K and V projections,
// 2*B*H*L*C*(k+v) FLOP (attention.py:308), 4.3 GFLOP at B=8, L=512,
// C=G=512, H=8, k=v=64 (4.4 us at 989 TFLOP/s bf16; its bytes take ~1.7 us).
//
// Design: one block per (head, row) — the TPU ran one grid step per row with
// a static loop over heads. The block walks L in 64-row chunks twice:
//   pass 1 projects K (x chunk and wk[h] tiles stream through a cp.async
//          double buffer into tensor-core products) and keeps only the
//          (L, S) float32 scores in shared memory;
//   then one warp per segment takes the masked softmax over L in place;
//   pass 2 projects V chunk by chunk and folds it straight into the
//          (S, v) float32 sums.
// Splitting K from V costs no extra products and keeps shared memory at
// O(L*S) instead of O(L*v), so any bucket length fits one block.

#include "common.cuh"

namespace pbt {

constexpr int kD = 64;      // key_dim == value_dim
constexpr int kMaxS = 16;   // segments per row
constexpr int kRows = 64;   // L rows per chunk
constexpr int kKc = 32;     // C columns per k-step

template <typename T> struct AttnCfg;

template <> struct AttnCfg<__nv_bfloat16> {
  static constexpr int PAD = 16;
  using Mma = MmaBf16<kRows, kD, 4, 2>;
};

template <> struct AttnCfg<float> {
  static constexpr int PAD = 0;
  using Mma = MmaF32<kRows, kD, 32>;
};

template <typename T> struct AttnSmem {
  static constexpr int LDA = kKc + AttnCfg<T>::PAD;
  static constexpr int LDB = kD + AttnCfg<T>::PAD;
  static constexpr size_t a_tile = size_t(kRows) * LDA * sizeof(T);
  static constexpr size_t b_tile = size_t(kKc) * LDB * sizeof(T);
  static constexpr size_t tiles = 2 * (a_tile + b_tile);
  static constexpr size_t stage_bytes = size_t(kRows) * kD * sizeof(float);
  static constexpr size_t q = align128(size_t(kMaxS) * kD * sizeof(float));
  static constexpr size_t flags = align128(kMaxS * sizeof(int));
  static constexpr size_t region =
      align128(tiles > stage_bytes ? tiles : stage_bytes);
  static size_t total(int L, int S) {
    return q + flags + region + align128(size_t(L) * S * sizeof(float));
  }
};

// stage (kRows x kD) = x[l0 : l0+kRows] @ w (C x kD), rows >= L zero.
template <typename T, typename Mma>
__device__ __forceinline__ void project_chunk(Mma& mma, const T* xb, int L,
                                              int C, int l0, const T* w,
                                              unsigned char* region) {
  using Smem = AttnSmem<T>;
  T* a_buf = reinterpret_cast<T*>(region);
  T* b_buf = reinterpret_cast<T*>(region + 2 * Smem::a_tile);
  constexpr int A_TILE = kRows * Smem::LDA, B_TILE = kKc * Smem::LDB;
  mma.zero();
  pipelined_steps(
      C / kKc,
      [&](int s, int buf) {
        load_rows_async(a_buf + buf * A_TILE, Smem::LDA, xb + s * kKc, C, l0,
                        kRows, kKc, L);
        load_rows_async(b_buf + buf * B_TILE, Smem::LDB,
                        w + size_t(s) * kKc * kD, kD, 0, kKc, kD, kKc);
      },
      [&](int s, int buf) {
        mma.mma(a_buf + buf * A_TILE, Smem::LDA, b_buf + buf * B_TILE,
                Smem::LDB, kKc);
      });
  mma.store(reinterpret_cast<float*>(region), kD);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ x, const float* __restrict__ oh,
                     const T* __restrict__ g, const T* __restrict__ wq,
                     const T* __restrict__ wk, const T* __restrict__ wv,
                     T* __restrict__ out, int L, int C, int G, int S,
                     int zero_empty) {
  using Smem = AttnSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q = reinterpret_cast<float*>(smem);
  int* exists = reinterpret_cast<int*>(smem + Smem::q);
  unsigned char* region = smem + Smem::q + Smem::flags;
  float* stage = reinterpret_cast<float*>(region);  // after a projection
  float* sc = reinterpret_cast<float*>(region + Smem::region);  // (L, S)

  const int h = blockIdx.x, b = blockIdx.y;
  const T* xb = x + size_t(b) * L * C;
  const float* ohb = oh + size_t(b) * L * S;
  const T* gb = g + size_t(b) * S * G;
  const T* wkh = wk + size_t(h) * C * kD;
  const T* wvh = wv + size_t(h) * C * kD;
  const float inv_scale = 1.0f / sqrtf(float(kD));

  // q_h = tanh(g @ wq[h]), rounded at both ends.
  for (int i = threadIdx.x; i < S * kD; i += kThreads) {
    const int s = i / kD, j = i - s * kD;
    const T* wqh = wq + size_t(h) * G * kD + j;
    float acc = 0.f;
    for (int k = 0; k < G; ++k) acc = fmaf(to_f(gb[s * G + k]), to_f(wqh[k * kD]), acc);
    q[i] = round_to<T>(tanhf(round_to<T>(acc)));
  }
  __syncthreads();

  typename AttnCfg<T>::Mma mma;

  // Pass 1: masked float32 scores for every (l, s).
  for (int l0 = 0; l0 < L; l0 += kRows) {
    project_chunk<T>(mma, xb, L, C, l0, wkh, region);
    for (int i = threadIdx.x; i < kRows * kD; i += kThreads)
      stage[i] = round_to<T>(tanhf(round_to<T>(stage[i])));
    __syncthreads();
    const int rows = min(kRows, L - l0);
    for (int i = threadIdx.x; i < rows * S; i += kThreads) {
      const int m = i / S, s = i - m * S;
      const float* kr = stage + m * kD;
      const float* qs = q + s * kD;
      float dot = 0.f;
#pragma unroll 8
      for (int j = 0; j < kD; ++j) dot = fmaf(kr[j], qs[j], dot);
      const int l = l0 + m;
      sc[l * S + s] = ohb[l * S + s] > 0.f ? dot * inv_scale : -1e30f;
    }
    __syncthreads();
  }

  // Softmax over l for each segment (one warp per segment); the weights are
  // rounded to T before the weighted sum, as the TPU kernel casts them.
  {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int s = warp; s < S; s += kWarps) {
      float mx = -1e30f;  // every score is >= the mask value
      int any = 0;
      for (int l = lane; l < L; l += 32) {
        mx = fmaxf(mx, sc[l * S + s]);
        any |= ohb[l * S + s] > 0.f;
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int l = lane; l < L; l += 32) sum += expf(sc[l * S + s] - mx);
      sum = warp_sum(sum);
      for (int l = lane; l < L; l += 32)
        sc[l * S + s] = round_to<T>(expf(sc[l * S + s] - mx) / sum);
      any = __any_sync(0xffffffffu, any);
      if (lane == 0) exists[s] = any;
    }
  }
  __syncthreads();

  // Pass 2: out[s, j] = sum_l w[l, s] * V[l, j] in float32.
  constexpr int kPer = kMaxS * kD / kThreads;
  float acc[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc[r] = 0.f;
  for (int l0 = 0; l0 < L; l0 += kRows) {
    project_chunk<T>(mma, xb, L, C, l0, wvh, region);
    for (int i = threadIdx.x; i < kRows * kD; i += kThreads)
      stage[i] = round_to<T>(gelu_tanh(round_to<T>(stage[i])));
    __syncthreads();
    const int rows = min(kRows, L - l0);
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = threadIdx.x + r * kThreads;
      if (i < S * kD) {
        const int s = i / kD, j = i - s * kD;
        float a = acc[r];
        for (int m = 0; m < rows; ++m)
          a = fmaf(sc[(l0 + m) * S + s], stage[m * kD + j], a);
        acc[r] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + size_t(b) * S * G;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = threadIdx.x + r * kThreads;
    if (i < S * kD) {
      const int s = i / kD, j = i - s * kD;
      const float v = (zero_empty && !exists[s]) ? 0.f : acc[r];
      ob[s * G + h * kD + j] = from_f<T>(v);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* oh, const void* g,
                   const void* wq, const void* wk, const void* wv, void* out,
                   int B, int L, int C, int G, int S, int H, int zero_empty,
                   cudaStream_t stream) {
  const size_t smem = AttnSmem<T>::total(L, S);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(H, B);
  attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(oh),
      static_cast<const T*>(g), static_cast<const T*>(wq),
      static_cast<const T*>(wk), static_cast<const T*>(wv),
      static_cast<T*>(out), L, C, G, S, zero_empty);
  return cudaGetLastError();
}

}  // namespace pbt

// dtype: 0 = float32, 1 = bfloat16 (x, g, wq, wk, wv, out); oh is float32
// (B, L, S). Requires key_dim == value_dim == 64 (G == 64*H), C % 32 == 0,
// 1 <= S <= 16. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int pbt_global_attention(int dtype, const void* x, const void* oh,
                                    const void* g, const void* wq,
                                    const void* wk, const void* wv,
                                    void* out, int B, int L, int C, int G,
                                    int S, int H, int zero_empty,
                                    void* stream) {
  if (B < 1 || L < 1 || C % pbt::kKc || G != H * pbt::kD || S < 1 ||
      S > pbt::kMaxS)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pbt::launch<float>(x, oh, g, wq, wk, wv, out, B, L, C, G, S, H,
                              zero_empty, s);
  if (dtype == 1)
    return pbt::launch<__nv_bfloat16>(x, oh, g, wq, wk, wv, out, B, L, C, G,
                                      S, H, zero_empty, s);
  return cudaErrorInvalidValue;
}
