// K1 — the fused local track of one ProteinBERT block, for Hopper (sm_90a).
//
// Replaces the TPU kernel proteinbert_tpu/kernels/fused_block.py
// `_fused_kernel` (launched at :804 by `_pallas_forward`, entry
// `fused_local_track`). Per position l of x (B, L, C):
//
//   h  = x + gelu(conv9,d=1(x) + nb) + gelu(conv9,d=D(x) + wb) + bcast
//   x1 = LN1(h)                      (cast to the activation type)
//   y  = LN2(x1 + gelu(x1 @ Wd + db))
//
// Each 'SAME' conv is 9 shifted (rows x C) @ (C x C) tap products over a
// window padded by the widest halo (20 rows for k=9, d=5). Products
// accumulate in float32; the conv outputs are NOT rounded to the activation
// type (fused_block.py:539-547); x1 is rounded before the dense
// (fused_block.py:517); LN statistics are float32 with the biased variance.
//
// What bounds it on the H100: operations. 2*B*L*C^2*19 FLOP (fused_block.py
// :779) — 40.8 GFLOP at B=8, L=512, C=512, 41 us at 989 TFLOP/s bf16 —
// against ~5.5 us of activation bytes. The weights (19*C^2, 10 MB in bf16 at
// C=512) are re-read by every block from L2, so the design's real limit is
// L2 -> SM weight traffic per row of output.
//
// Design: the TPU kernel held the whole (L+40, C) row and all weights in
// 13 MiB of VMEM; a Hopper block has 227 KB. So one block owns one
// (b, TL-row tile) and ALL C channels (the LNs reduce over C):
//   * its (TL + 40, C) input window stays in shared memory for all 18 taps;
//   * weight tiles (KC x C) stream from L2 through a cp.async double buffer,
//     overlapping the next tile's copy with this tile's product;
//   * one float32 (TL, C) buffer carries h between the convs and the tail;
//     the narrow/wide/dense products land in a staging buffer that aliases
//     the weight double buffer once its k-loop is done;
//   * x1 reuses the window's memory, so the whole layer is ONE launch.
// TL is 32 rows in bf16 (window 76 KB + h 64 KB + weights 66 KB) and 16 in
// float32, the largest tiles that fit at C=512; each tile re-reads the
// weights, so a larger TL would cut the L2 traffic, which is why the tiles
// are as large as shared memory allows.

#include "common.cuh"

namespace pbt {

constexpr int kTaps = 9;
constexpr int kCenter = (kTaps - 1) / 2;
constexpr int kHalo = 20;  // max over the two convs of (kTaps-1)/2 * dilation

template <typename T, int C> struct TrackCfg;

template <int C> struct TrackCfg<__nv_bfloat16, C> {
  static constexpr int TL = 32, KC = 32, PAD = 16;
  using Mma = MmaBf16<TL, C, 1, 8>;
};

template <int C> struct TrackCfg<float, C> {
  static constexpr int TL = 16, KC = 16, PAD = 0;
  using Mma = MmaF32<TL, C, 64>;
};

template <typename T, int C> struct TrackSmem {
  using Cfg = TrackCfg<T, C>;
  static constexpr int LDW = C + Cfg::PAD;
  static constexpr int WIN = Cfg::TL + 2 * kHalo;
  static constexpr size_t win = align128(size_t(WIN) * LDW * sizeof(T));
  static constexpr size_t h = align128(size_t(Cfg::TL) * C * sizeof(float));
  static constexpr size_t wtile = size_t(Cfg::KC) * LDW * sizeof(T);
  static constexpr size_t wbuf = align128(2 * wtile);
  static constexpr size_t total = win + h + wbuf;
  static_assert(wbuf >= size_t(Cfg::TL) * C * sizeof(float),
                "staging aliases the weight double buffer");
  static_assert(total <= 232448, "fits one block's shared memory");
};

// acc = sum over taps t and k-chunks of window[center + (t-4)*d] @ W[t]
// with W (taps, C, C) streaming through the double buffer. With taps == 1
// and dilation 0 this is a plain (TL x C) @ (C x C) product of `a`.
template <typename T, int C, typename Mma>
__device__ __forceinline__ void tap_products(Mma& mma, const T* a, int taps,
                                             int dilation, const T* w,
                                             T* wbuf) {
  using Cfg = TrackCfg<T, C>;
  constexpr int KC = Cfg::KC, LDW = C + Cfg::PAD, NK = C / KC;
  constexpr int TILE = KC * LDW;
  const int center = (taps - 1) / 2;
  mma.zero();
  pipelined_steps(
      taps * NK,
      [&](int s, int buf) {
        const int t = s / NK, kc = s - (s / NK) * NK;
        load_rows_async(wbuf + buf * TILE, LDW,
                        w + (size_t(t) * C + kc * KC) * C, C, 0, KC, C, KC);
      },
      [&](int s, int buf) {
        const int t = s / NK, kc = s - (s / NK) * NK;
        mma.mma(a + (t - center) * dilation * LDW + kc * KC, LDW,
                wbuf + buf * TILE, LDW, KC);
      });
}

// One warp per row: y = LN(h row) * scale + bias over C, float32 statistics.
template <typename F>
__device__ __forceinline__ void layer_norm_rows(const float* h, int rows,
                                                int C, const float* scale,
                                                const float* bias, F emit) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < rows; m += kWarps) {
    const float* row = h + m * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += row[c];
    const float mean = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / C + 1e-5f);
    for (int c = lane; c < C; c += 32)
      emit(m, c, (row[c] - mean) * rstd * scale[c] + bias[c]);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
    local_track_kernel(const T* __restrict__ x, const T* __restrict__ bcast,
                       const T* __restrict__ nk, const float* __restrict__ nb,
                       const T* __restrict__ wk, const float* __restrict__ wb,
                       const float* __restrict__ s1,
                       const float* __restrict__ b1,
                       const T* __restrict__ dk, const float* __restrict__ db,
                       const float* __restrict__ s2,
                       const float* __restrict__ b2, T* __restrict__ out,
                       int L, int wide_dilation) {
  using Cfg = TrackCfg<T, C>;
  using Smem = TrackSmem<T, C>;
  constexpr int TL = Cfg::TL, LDW = Smem::LDW;
  extern __shared__ __align__(128) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);
  float* h = reinterpret_cast<float*>(smem + Smem::win);
  T* wbuf = reinterpret_cast<T*>(smem + Smem::win + Smem::h);
  float* stage = reinterpret_cast<float*>(wbuf);  // after a k-loop only
  T* x1 = win;                                    // after both convs only

  const int b = blockIdx.y, l0 = blockIdx.x * TL;
  const T* xb = x + size_t(b) * L * C;
  const T* center = win + kHalo * LDW;  // window row of output row 0

  // Input rows l0-20 .. l0+TL+20, zeros outside [0, L) ('SAME' padding).
  load_rows_async(win, LDW, xb, C, l0 - kHalo, Smem::WIN, C, L);
  cp_async_commit();

  typename Cfg::Mma mma;

  // h = x + gelu(narrow + nb)
  tap_products<T, C>(mma, center, kTaps, 1, nk, wbuf);
  mma.store(h, C);
  __syncthreads();
  for (int i = threadIdx.x; i < TL * C; i += kThreads) {
    const int m = i / C, c = i - m * C;
    h[i] = to_f(center[m * LDW + c]) + gelu_tanh(h[i] + nb[c]);
  }
  __syncthreads();

  // h += gelu(wide + wb) + bcast
  tap_products<T, C>(mma, center, kTaps, wide_dilation, wk, wbuf);
  mma.store(stage, C);
  __syncthreads();
  for (int i = threadIdx.x; i < TL * C; i += kThreads) {
    const int c = i % C;
    h[i] = (h[i] + gelu_tanh(stage[i] + wb[c])) + to_f(bcast[b * C + c]);
  }
  __syncthreads();

  // x1 = LN1(h), rounded to T (fused_block.py:517)
  layer_norm_rows(h, TL, C, s1, b1, [&](int m, int c, float y) {
    x1[m * LDW + c] = from_f<T>(y);
  });
  __syncthreads();

  // h2 = x1 + gelu(x1 @ Wd + db)
  tap_products<T, C>(mma, x1, 1, 0, dk, wbuf);
  mma.store(stage, C);
  __syncthreads();
  for (int i = threadIdx.x; i < TL * C; i += kThreads) {
    const int m = i / C, c = i - m * C;
    h[i] = to_f(x1[m * LDW + c]) + gelu_tanh(stage[i] + db[c]);
  }
  __syncthreads();

  // y = LN2(h2) → out rows inside [0, L)
  T* ob = out + (size_t(b) * L + l0) * C;
  const int rows = min(TL, L - l0);
  layer_norm_rows(h, rows, C, s2, b2, [&](int m, int c, float y) {
    ob[m * C + c] = from_f<T>(y);
  });
}

template <typename T, int C>
cudaError_t launch(const void* x, const void* bcast, const void* nk,
                   const void* nb, const void* wk, const void* wb,
                   const void* s1, const void* b1, const void* dk,
                   const void* db, const void* s2, const void* b2, void* out,
                   int B, int L, int wide_dilation, cudaStream_t stream) {
  constexpr size_t smem = TrackSmem<T, C>::total;
  constexpr int TL = TrackCfg<T, C>::TL;
  cudaError_t e = cudaFuncSetAttribute(
      local_track_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((L + TL - 1) / TL, B);
  local_track_kernel<T, C><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bcast),
      static_cast<const T*>(nk), static_cast<const float*>(nb),
      static_cast<const T*>(wk), static_cast<const float*>(wb),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const T*>(dk), static_cast<const float*>(db),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<T*>(out), L, wide_dilation);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_c(int C, const void* x, const void* bcast, const void* nk,
                     const void* nb, const void* wk, const void* wb,
                     const void* s1, const void* b1, const void* dk,
                     const void* db, const void* s2, const void* b2,
                     void* out, int B, int L, int wide_dilation,
                     cudaStream_t stream) {
  switch (C) {
    case 128:
      return launch<T, 128>(x, bcast, nk, nb, wk, wb, s1, b1, dk, db, s2, b2,
                            out, B, L, wide_dilation, stream);
    case 256:
      return launch<T, 256>(x, bcast, nk, nb, wk, wb, s1, b1, dk, db, s2, b2,
                            out, B, L, wide_dilation, stream);
    case 512:
      return launch<T, 512>(x, bcast, nk, nb, wk, wb, s1, b1, dk, db, s2, b2,
                            out, B, L, wide_dilation, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace pbt

// dtype: 0 = float32, 1 = bfloat16 (x, bcast, conv and dense kernels);
// biases and LN vectors are float32. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int pbt_local_track(int dtype, const void* x, const void* bcast,
                               const void* nk, const void* nb,
                               const void* wk, const void* wb,
                               const void* s1, const void* b1,
                               const void* dk, const void* db,
                               const void* s2, const void* b2, void* out,
                               int B, int L, int C, int wide_dilation,
                               void* stream) {
  if (B < 1 || L < 1 || wide_dilation < 1 ||
      pbt::kCenter * wide_dilation > pbt::kHalo)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pbt::launch_c<float>(C, x, bcast, nk, nb, wk, wb, s1, b1, dk, db,
                                s2, b2, out, B, L, wide_dilation, s);
  if (dtype == 1)
    return pbt::launch_c<__nv_bfloat16>(C, x, bcast, nk, nb, wk, wb, s1, b1,
                                        dk, db, s2, b2, out, B, L,
                                        wide_dilation, s);
  return cudaErrorInvalidValue;
}
