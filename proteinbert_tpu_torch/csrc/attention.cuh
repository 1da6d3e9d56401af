// Global attention of one ProteinBERT block for one (head, batch row) over a
// segment mask — the device code of K2 (global_attention.cu) and of the
// one-pass trunk #6 (one_pass.cu), float32 only: both run
// attention_sm90.cuh's passes in bf16 (#6 through one_pass_sm90.cuh). With
// x (L, C), a mask m(l, s) and global rows g (S, G):
//
//   q_h = tanh(g @ wq[h])                    (S, k)
//   K_h = tanh(x @ wk[h]),  V_h = gelu(x @ wv[h])   (L, k), (L, v)
//   scores[l, s] = K_h[l] . q_h[s] / sqrt(k)  (float32), -1e30 where !m(l, s)
//   w = softmax over l (float32), rounded to the activation type
//   out[s, h*v:(h+1)*v] = w[:, s]^T V_h      (float32 sum), zero for an
//                                              empty segment if zero_empty
//
// Rounding points follow `_attention_body` (attention.py:195-228): each
// projection accumulates in float32 and is rounded to the activation type
// before tanh/gelu (and again after); the mask value is -1e30, so an
// all-masked column gets the uniform softmax, not NaN.
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
// O(L*S) instead of O(L*v), so any bucket length fits one block. key_dim is
// 64; value_dim VD is 64 or 128.
//
// Q8 = true is the float32 int8 leg of K2 (global_attention_q8.cu) and of
// #6: wq, wk, wv arrive as int8 with float32 per-(head, column) scales;
// the wk / wv tiles are dequantized on their way into shared memory
// (common.cuh `Q8Tile`, loaded into registers during the previous step's
// product) and the query projection dequantizes each wq value it reads, so
// every product sees the floating-point leg's operands.
#pragma once

#include "common.cuh"

namespace pbt {

constexpr int kKD = 64;     // key_dim
constexpr int kMaxS = 16;   // segments per row
constexpr int kRows = 64;   // L rows per chunk
constexpr int kKc = 32;     // C columns per k-step

template <typename T, int N> struct AttnCfg;

template <int N> struct AttnCfg<__nv_bfloat16, N> {
  static constexpr int PAD = 16;
  using Mma = MmaBf16<kRows, N, 4, 2>;
};

template <int N> struct AttnCfg<float, N> {
  static constexpr int PAD = 0;
  using Mma = MmaF32<kRows, N, 32>;
};

template <typename T, int VD> struct AttnSmem {
  static constexpr int PAD = AttnCfg<T, VD>::PAD;
  static constexpr int LDA = kKc + PAD;
  static constexpr size_t a_tile = size_t(kRows) * LDA * sizeof(T);
  static constexpr size_t b_tile = size_t(kKc) * (VD + PAD) * sizeof(T);
  static constexpr size_t tiles = 2 * (a_tile + b_tile);
  static constexpr size_t stage_bytes = size_t(kRows) * VD * sizeof(float);
  static constexpr size_t q = align128(size_t(kMaxS) * kKD * sizeof(float));
  static constexpr size_t flags = align128(kMaxS * sizeof(int));
  static constexpr size_t region =
      align128(tiles > stage_bytes ? tiles : stage_bytes);
  static size_t total(int L, int S) {
    return q + flags + region + align128(size_t(L) * S * sizeof(float));
  }
};

// K2's mask: int32 (L,) segment ids, s + 1 where position l is in segment
// s (anything else: in none).
struct IdMask {
  const int* ids;
  __device__ __forceinline__ bool operator()(int l, int s) const {
    return ids[l] == s + 1;
  }
};

// #6's mask: segment ids narrowed to real tokens. seg null = dense rows
// (one segment, s == 0); real[l] != 0 at real positions.
struct SegmentMask {
  const int* seg;
  const int* real;
  __device__ __forceinline__ bool operator()(int l, int s) const {
    return real[l] != 0 && (seg == nullptr ? s == 0 : seg[l] == s + 1);
  }
};

// The projection weights of one launch: wq (H, G, kKD), wk (H, C, kKD),
// wv (H, C, VD) in the activation type, or on the int8 leg (Q8) int8 with
// float32 scales sq (H, kKD), sk (H, kKD), sv (H, VD), one per (head, output
// column); the scales are null on the floating-point leg.
template <typename T, bool Q8> struct AttnWeights {
  using W = WeightT<T, Q8>;
  const W* wq;
  const W* wk;
  const W* wv;
  const float* sq;
  const float* sk;
  const float* sv;
};

template <typename T, bool Q8>
AttnWeights<T, Q8> attn_weights(const void* wq, const void* wk,
                                const void* wv, const void* sq = nullptr,
                                const void* sk = nullptr,
                                const void* sv = nullptr) {
  using W = WeightT<T, Q8>;
  return AttnWeights<T, Q8>{
      static_cast<const W*>(wq),      static_cast<const W*>(wk),
      static_cast<const W*>(wv),      static_cast<const float*>(sq),
      static_cast<const float*>(sk), static_cast<const float*>(sv)};
}

// stage (kRows x N) = x[l0 : l0+kRows] @ w (C x N), rows >= L zero; on the
// int8 leg w is int8, dequantized with the N scales `wscale` as it loads.
template <typename T, int N, bool Q8, typename Mma>
__device__ __forceinline__ void project_chunk(Mma& mma, const T* xb, int L,
                                              int C, int l0,
                                              const WeightT<T, Q8>* w,
                                              const float* wscale,
                                              unsigned char* region,
                                              size_t a_tile) {
  constexpr int PAD = AttnCfg<T, N>::PAD;
  constexpr int LDA = kKc + PAD, LDB = N + PAD;
  constexpr int A_TILE = kRows * LDA, B_TILE = kKc * LDB;
  T* a_buf = reinterpret_cast<T*>(region);
  T* b_buf = reinterpret_cast<T*>(region + 2 * a_tile);
  const auto load_x = [&](int s, int buf) {
    load_rows_async(a_buf + buf * A_TILE, LDA, xb + s * kKc, C, l0, kRows,
                    kKc, 0, L);
  };
  const auto compute = [&](int s, int buf) {
    mma.mma(a_buf + buf * A_TILE, LDA, b_buf + buf * B_TILE, LDB, kKc);
  };
  mma.zero();
  if constexpr (Q8) {
    Q8Tile<kKc, N> tile;
    pipelined_steps_staged(
        C / kKc, load_x,
        [&](int s) {
          if (s == 0) tile.scales(wscale);
          tile.fetch(w + size_t(s) * kKc * N, N);
        },
        [&](int, int buf) { tile.store(b_buf + buf * B_TILE, LDB); },
        compute);
  } else {
    pipelined_steps(
        C / kKc,
        [&](int s, int buf) {
          load_x(s, buf);
          load_rows_async(b_buf + buf * B_TILE, LDB, w + size_t(s) * kKc * N,
                          N, 0, kKc, N, 0, kKc);
        },
        compute);
  }
  mma.store(reinterpret_cast<float*>(region), N);
  __syncthreads();
}

// out (S, G) columns h*VD .. (h+1)*VD of one batch row: xb (L, C), gb
// (S, G), the weights `w`.
template <typename T, int VD, bool Q8, typename Mask>
__device__ __forceinline__ void attention_head(
    const T* xb, const T* gb, const AttnWeights<T, Q8>& w, T* ob, int L,
    int C, int G, int S, int h, int zero_empty, Mask mask,
    unsigned char* smem) {
  using Smem = AttnSmem<T, VD>;
  float* q = reinterpret_cast<float*>(smem);
  int* exists = reinterpret_cast<int*>(smem + Smem::q);
  unsigned char* region = smem + Smem::q + Smem::flags;
  float* stage = reinterpret_cast<float*>(region);  // after a projection
  float* sc = reinterpret_cast<float*>(region + Smem::region);  // (L, S)

  const auto* wkh = w.wk + size_t(h) * C * kKD;
  const auto* wvh = w.wv + size_t(h) * C * VD;
  const float* skh = Q8 ? w.sk + size_t(h) * kKD : nullptr;
  const float* svh = Q8 ? w.sv + size_t(h) * VD : nullptr;
  const float inv_scale = 1.0f / sqrtf(float(kKD));

  __syncthreads();  // an earlier head of this block is done with smem
  // q_h = tanh(g @ wq[h]), rounded at both ends; wq read from device memory
  // (dequantized per value on the int8 leg).
  for (int i = threadIdx.x; i < S * kKD; i += kThreads) {
    const int s = i / kKD, j = i - s * kKD;
    const size_t wqh = size_t(h) * G * kKD + j;
    const size_t sqh = size_t(h) * kKD + j;
    float acc = 0.f;
    for (int k = 0; k < G; ++k)
      acc = fmaf(to_f(gb[s * G + k]),
                 weight_at<Q8, T>(w.wq, wqh + size_t(k) * kKD, w.sq, sqh),
                 acc);
    q[i] = round_to<T>(tanhf(round_to<T>(acc)));
  }
  __syncthreads();

  // Pass 1: masked float32 scores for every (l, s).
  {
    typename AttnCfg<T, kKD>::Mma mma;
    for (int l0 = 0; l0 < L; l0 += kRows) {
      project_chunk<T, kKD, Q8>(mma, xb, L, C, l0, wkh, skh, region,
                                Smem::a_tile);
      for (int i = threadIdx.x; i < kRows * kKD; i += kThreads)
        stage[i] = round_to<T>(tanhf(round_to<T>(stage[i])));
      __syncthreads();
      const int rows = min(kRows, L - l0);
      for (int i = threadIdx.x; i < rows * S; i += kThreads) {
        const int m = i / S, s = i - m * S;
        const float* kr = stage + m * kKD;
        const float* qs = q + s * kKD;
        float dot = 0.f;
#pragma unroll 8
        for (int j = 0; j < kKD; ++j) dot = fmaf(kr[j], qs[j], dot);
        const int l = l0 + m;
        sc[l * S + s] = mask(l, s) ? dot * inv_scale : -1e30f;
      }
      __syncthreads();
    }
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
        any |= mask(l, s);
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
  constexpr int kPer = kMaxS * VD / kThreads;
  float acc[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) acc[r] = 0.f;
  {
    typename AttnCfg<T, VD>::Mma mma;
    for (int l0 = 0; l0 < L; l0 += kRows) {
      project_chunk<T, VD, Q8>(mma, xb, L, C, l0, wvh, svh, region,
                               Smem::a_tile);
      for (int i = threadIdx.x; i < kRows * VD; i += kThreads)
        stage[i] = round_to<T>(gelu_tanh(round_to<T>(stage[i])));
      __syncthreads();
      const int rows = min(kRows, L - l0);
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = threadIdx.x + r * kThreads;
        if (i < S * VD) {
          const int s = i / VD, j = i - s * VD;
          float a = acc[r];
          for (int m = 0; m < rows; ++m)
            a = fmaf(sc[(l0 + m) * S + s], stage[m * VD + j], a);
          acc[r] = a;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = threadIdx.x + r * kThreads;
    if (i < S * VD) {
      const int s = i / VD, j = i - s * VD;
      const float v = (zero_empty && !exists[s]) ? 0.f : acc[r];
      ob[s * G + h * VD + j] = from_f<T>(v);
    }
  }
}

// K2 in float32: one block per (head, batch row).
template <typename T, int VD, bool Q8>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ x, const int* __restrict__ ids,
                     const T* __restrict__ g, AttnWeights<T, Q8> w,
                     T* __restrict__ out, int L, int C, int G, int S,
                     int zero_empty) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  attention_head<T, VD, Q8>(x + size_t(b) * L * C, g + size_t(b) * S * G, w,
                            out + size_t(b) * S * G, L, C, G, S, h,
                            zero_empty, IdMask{ids + size_t(b) * L}, smem);
}

template <typename T, int VD, bool Q8>
cudaError_t launch_attention(const void* x, const int* ids, const void* g,
                             const AttnWeights<T, Q8>& w, void* out, int B,
                             int L, int C, int G, int S, int H,
                             int zero_empty, cudaStream_t stream) {
  const size_t smem = AttnSmem<T, VD>::total(L, S);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<T, VD, Q8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(H, B);
  attention_kernel<T, VD, Q8><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), ids, static_cast<const T*>(g), w,
      static_cast<T*>(out), L, C, G, S,
      zero_empty);
  return cudaGetLastError();
}

// K2 at the value_dim instantiation G / H names (64 or 128).
template <typename T, bool Q8>
cudaError_t launch_attention_vd(const void* x, const int* ids, const void* g,
                                const AttnWeights<T, Q8>& w, void* out,
                                int B, int L, int C, int G, int S, int H,
                                int zero_empty, cudaStream_t stream) {
  if (G == H * 64)
    return launch_attention<T, 64, Q8>(x, ids, g, w, out, B, L, C, G, S, H,
                                       zero_empty, stream);
  if (G == H * 128)
    return launch_attention<T, 128, Q8>(x, ids, g, w, out, B, L, C, G, S, H,
                                        zero_empty, stream);
  return cudaErrorInvalidValue;
}

// Host-side checks of K2's entries.
inline bool attention_geometry_ok(int B, int L, int C, int S, int H) {
  return B >= 1 && L >= 1 && H >= 1 && C % kKc == 0 && S >= 1 && S <= kMaxS;
}

}  // namespace pbt
