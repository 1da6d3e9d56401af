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
// The mask is a segment id a position (`IdMask`, `SegmentMask`): position l
// lies in at most one segment, so of the L x S scores only one a position,
// against its own segment's q, survives the mask; the others are -1e30, and
// their softmax weights exactly 0 in a segment that holds a position. So the
// plan keeps one score a position, and any number of segments S costs
// nothing in shared memory.
//
// Design: one block per (head, row) — the TPU ran one grid step per row with
// a static loop over heads. The block first writes q_h of every segment to a
// float32 scratch in device memory (S, H, k) a row, then walks L in 64-row
// chunks:
//   pass 1 projects K (x chunk and wk[h] tiles stream through a cp.async
//          double buffer into CUDA-core products) and keeps only each
//          position's float32 score against its segment's q, (L) in shared
//          memory;
//   then one warp per segment takes the masked softmax over L in place, and
//          marks the segments that hold a position (a bit each);
//   pass 2 projects V chunk by chunk (a block of at most 128 value columns
//          at a time) and folds each row into its segment's float32 sum: a
//          thread a value column keeps the running sum of the segment it is
//          in, in l order, parked in the output while another segment's
//          rows pass. The masked rows a segment skips have weight exactly 0,
//          so each sum is the chain over all of L the TPU kernel forms.
// Splitting K from V keeps shared memory at O(L) instead of O(L*v): any
// bucket length up to 43776 fits one block. The head widths are run-time
// values (`head_dims_ok`: multiples of 8, key_dim up to 128, value_dim up to
// 256). A projection runs in blocks of at most 128 output columns, each
// the narrowest of 32, 64 and 128 that holds its columns (the rest
// zero-filled), so three instantiations serve every width and the widths
// of earlier builds (key_dim 64, value_dim 64 or 128) run the products,
// and give the bits, they gave. value_dim 256 takes two blocks, each a
// pass over x.
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

// The coverage of K2 (and of #6's attention) and the float32 plan's
// shared memory. kernels/attention.py `CUDA_CONSTANTS` states the same
// values under these names, and the port's tests hold the two together.
constexpr int kHeadStep = 8;   // head widths: multiples of this
constexpr int kMaxKD = 128;    // key_dim at most
constexpr int kMaxVD = 256;    // value_dim at most
constexpr int kMaxS = 65535;   // segments per row: a grid's z extent
constexpr int kRows = 64;      // L rows per chunk
constexpr int kKc = 32;        // C columns per k-step: C a multiple of it
constexpr int kMaxC = 2048;    // C at most
constexpr int kMaxCols = 128;  // projection columns per block at most
constexpr size_t kMaxSmem = 232448;  // a block's shared memory

// The head widths the kernels of K2 and #6 take: multiples of 8, key_dim
// up to 128 and value_dim up to 256.
__host__ __device__ constexpr bool head_dims_ok(int kd, int vd) {
  return kd % kHeadStep == 0 && kd >= kHeadStep && kd <= kMaxKD &&
         vd % kHeadStep == 0 && vd >= kHeadStep && vd <= kMaxVD;
}

// Shared memory of the float32 plan (attention_head): the projection
// region (a double buffer of x and weight tiles, then the (kRows, n)
// stage), a bit a segment (kMaxS bits) marking those that hold a position,
// then the (L) scores, one a position.
struct AttnSmem {
  static constexpr size_t a_tile = size_t(kRows) * kKc * sizeof(float);
  static constexpr size_t b_tile = size_t(kKc) * kMaxCols * sizeof(float);
  static constexpr size_t tiles = 2 * (a_tile + b_tile);
  static constexpr size_t stage_bytes =
      size_t(kRows) * kMaxCols * sizeof(float);
  static constexpr size_t region =
      align128(tiles > stage_bytes ? tiles : stage_bytes);
  static constexpr size_t flags =
      align128(size_t(kMaxS + 31) / 32 * sizeof(unsigned));
  static size_t total(int L) {
    return region + flags + align128(size_t(L) * sizeof(float));
  }
};

// K2's mask: int32 (L,) segment ids, s + 1 where position l is in segment
// s (anything else: in none). Gives position l's id, 0 for none.
struct IdMask {
  const int* ids;
  int S;
  __device__ __forceinline__ int operator()(int l) const {
    const int id = ids[l];
    return id >= 1 && id <= S ? id : 0;
  }
};

// #6's mask: segment ids narrowed to real tokens. seg null = dense rows
// (one segment, id 1); real[l] != 0 at real positions.
struct SegmentMask {
  const int* seg;
  const int* real;
  int S;
  __device__ __forceinline__ int operator()(int l) const {
    if (real[l] == 0) return 0;
    if (seg == nullptr) return 1;
    const int id = seg[l];
    return id >= 1 && id <= S ? id : 0;
  }
};

// The projection weights of one launch: wq (H, G, kd), wk (H, C, kd),
// wv (H, C, vd) in the activation type, or on the int8 leg (Q8) int8 with
// float32 scales sq (H, kd), sk (H, kd), sv (H, vd), one per (head, output
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

// Rows 0 .. kKc-1 of a (kKc, N) float32 weight tile from w (leading
// dimension ld): the first `cols` columns copied (cp.async), the rest zero.
template <int N>
__device__ __forceinline__ void load_cols_async(float* dst, const float* w,
                                                int ld, int cols) {
  constexpr int per_row = N / 4;
  for (int i = threadIdx.x; i < kKc * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * 4;
    float* d = dst + r * N + c;
    if (c < cols)
      cp_async16(d, w + size_t(r) * ld + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// stage (kRows x N) = x[l0 : l0+kRows] @ w[:, 0:cols] (C x ld, the block's
// first column at w), rows >= L and columns >= cols zero; on the int8 leg
// w is int8, dequantized with the block's scales `wscale` as it loads.
template <int N, bool Q8>
__device__ __forceinline__ void project_block(
    const float* xb, int L, int C, int l0, const WeightT<float, Q8>* w,
    int ld, int cols, const float* wscale, unsigned char* region) {
  constexpr int A_TILE = kRows * kKc, B_TILE = kKc * N;
  float* a_buf = reinterpret_cast<float*>(region);
  float* b_buf = reinterpret_cast<float*>(region + 2 * AttnSmem::a_tile);
  MmaF32<kRows, N, 32> mma;
  const auto load_x = [&](int s, int buf) {
    load_rows_async(a_buf + buf * A_TILE, kKc, xb + s * kKc, C, l0, kRows,
                    kKc, 0, L);
  };
  const auto compute = [&](int s, int buf) {
    mma.mma(a_buf + buf * A_TILE, kKc, b_buf + buf * B_TILE, N, kKc);
  };
  mma.zero();
  if constexpr (Q8) {
    Q8Tile<kKc, N> tile;
    tile.ncols = cols;
    pipelined_steps_staged(
        C / kKc, load_x,
        [&](int s) {
          if (s == 0) tile.scales(wscale);
          tile.fetch(w + size_t(s) * kKc * ld, ld);
        },
        [&](int, int buf) { tile.store(b_buf + buf * B_TILE, N); },
        compute);
  } else {
    pipelined_steps(
        C / kKc,
        [&](int s, int buf) {
          load_x(s, buf);
          load_cols_async<N>(b_buf + buf * B_TILE, w + size_t(s) * kKc * ld,
                             ld, cols);
        },
        compute);
  }
  mma.store(reinterpret_cast<float*>(region), N);
  __syncthreads();
}

// `project_block` at the narrowest of 32, 64 and 128 columns that holds
// `cols` (the widths of earlier builds, key_dim 64 and value_dim 64 or
// 128, run their old products); returns that width, the stage's row
// length.
template <bool Q8>
__device__ __forceinline__ int project(const float* xb, int L, int C, int l0,
                                       const WeightT<float, Q8>* w, int ld,
                                       int cols, const float* wscale,
                                       unsigned char* region) {
  if (cols <= 32) {
    project_block<32, Q8>(xb, L, C, l0, w, ld, cols, wscale, region);
    return 32;
  }
  if (cols <= 64) {
    project_block<64, Q8>(xb, L, C, l0, w, ld, cols, wscale, region);
    return 64;
  }
  project_block<kMaxCols, Q8>(xb, L, C, l0, w, ld, cols, wscale, region);
  return kMaxCols;
}

// out (S, G) columns h*vd .. (h+1)*vd of one batch row in float32: xb
// (L, C), gb (S, G), the weights `w`, head widths kd and vd; qb the row's
// (S, H, kd) part of the q scratch; seg_of(l) position l's segment id (1
// .. S, 0 for none).
template <bool Q8, typename Mask>
__device__ __forceinline__ void attention_head(
    const float* xb, const float* gb, const AttnWeights<float, Q8>& w,
    float* ob, float* qb, int L, int C, int G, int S, int H, int h, int kd,
    int vd, int zero_empty, Mask seg_of, unsigned char* smem) {
  unsigned char* region = smem;
  float* stage = reinterpret_cast<float*>(region);  // after a projection
  unsigned* exists = reinterpret_cast<unsigned*>(smem + AttnSmem::region);
  float* sc = reinterpret_cast<float*>(smem + AttnSmem::region +
                                       AttnSmem::flags);  // (L)

  const auto* wkh = w.wk + size_t(h) * C * kd;
  const auto* wvh = w.wv + size_t(h) * C * vd;
  const float* skh = Q8 ? w.sk + size_t(h) * kd : nullptr;
  const float* svh = Q8 ? w.sv + size_t(h) * vd : nullptr;
  const float inv_scale = 1.0f / sqrtf(float(kd));
  const auto q_of = [&](int s) { return qb + (size_t(s) * H + h) * kd; };

  __syncthreads();  // an earlier head of this block is done with smem
  // q_h = tanh(g @ wq[h]) of every segment into the scratch, rounded at
  // both ends; wq read from device memory (dequantized per value on the
  // int8 leg). The block reads back only what it wrote, after the barrier.
  for (int i = threadIdx.x; i < S * kd; i += kThreads) {
    const int s = i / kd, j = i - s * kd;
    const size_t wqh = size_t(h) * G * kd + j;
    const size_t sqh = size_t(h) * kd + j;
    float acc = 0.f;
    for (int k = 0; k < G; ++k)
      acc = fmaf(gb[s * G + k],
                 weight_at<Q8, float>(w.wq, wqh + size_t(k) * kd, w.sq, sqh),
                 acc);
    q_of(s)[j] = tanhf(acc);
  }
  for (int i = threadIdx.x; i < (S + 31) / 32; i += kThreads) exists[i] = 0u;
  __syncthreads();

  // Pass 1: each position's float32 score against its own segment's q
  // (-1e30 for a position in none): K for all kd <= kMaxCols columns in
  // one block.
  for (int l0 = 0; l0 < L; l0 += kRows) {
    const int n = project<Q8>(xb, L, C, l0, wkh, kd, kd, skh, region);
    for (int i = threadIdx.x; i < kRows * n; i += kThreads)
      stage[i] = tanhf(stage[i]);
    __syncthreads();
    const int rows = min(kRows, L - l0);
    for (int m = threadIdx.x; m < rows; m += kThreads) {
      const int id = seg_of(l0 + m);
      float v = -1e30f;
      if (id != 0) {
        const float* kr = stage + m * n;
        const float* qs = q_of(id - 1);
        float dot = 0.f;
        for (int j = 0; j < kd; ++j) dot = fmaf(kr[j], qs[j], dot);
        v = dot * inv_scale;
      }
      sc[l0 + m] = v;
    }
    __syncthreads();
  }

  // Softmax over l for each segment (one warp per segment), its weights in
  // place of its positions' scores; a bit marks each segment that holds a
  // position. The sums add exp(-1e30 - max) for the positions off the
  // segment, as the TPU kernel's masked row does: 0 where it holds one, 1
  // each where it holds none.
  {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int s = warp; s < S; s += kWarps) {
      float mx = -1e30f;  // every score is >= the mask value
      int any = 0;
      for (int l = lane; l < L; l += 32)
        if (seg_of(l) == s + 1) {
          mx = fmaxf(mx, sc[l]);
          any = 1;
        }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int l = lane; l < L; l += 32)
        sum += expf((seg_of(l) == s + 1 ? sc[l] : -1e30f) - mx);
      sum = warp_sum(sum);
      for (int l = lane; l < L; l += 32)
        if (seg_of(l) == s + 1) sc[l] = expf(sc[l] - mx) / sum;
      any = __any_sync(0xffffffffu, any);
      if (lane == 0 && any) atomicOr(&exists[s / 32], 1u << (s % 32));
    }
  }
  __syncthreads();
  // A segment with no position takes the uniform softmax: weight 1 / L at
  // every position (its masked row's exp(0) / L).
  const float uniform = 1.0f / float(L);

  // Pass 2, a block of at most kMaxCols value columns at a time: out[s, j]
  // = sum over the positions l of segment s of w[l] * V[l, j] in float32,
  // l in order. Thread j < cols owns column j of every segment: its
  // running sum `a` belongs to segment `cur` and is parked in the output
  // when a row of another segment comes (the output starts at 0, so an
  // empty segment stays +0.0). Without zero_empty `u` is the uniform
  // softmax's sum, written at the end over each empty segment.
  const int j = threadIdx.x;
  for (int c0 = 0; c0 < vd; c0 += kMaxCols) {
    const int cols = min(kMaxCols, vd - c0);
    float* oc = ob + h * vd + c0 + j;
    if (j < cols)
      for (int s = 0; s < S; ++s) oc[size_t(s) * G] = 0.f;
    float a = 0.f, u = 0.f;
    int cur = 0;
    for (int l0 = 0; l0 < L; l0 += kRows) {
      const int n = project<Q8>(xb, L, C, l0, wvh + c0, vd, cols,
                                Q8 ? svh + c0 : nullptr, region);
      for (int i = threadIdx.x; i < kRows * n; i += kThreads)
        stage[i] = gelu_tanh(stage[i]);
      __syncthreads();
      const int rows = min(kRows, L - l0);
      if (j < cols)
        for (int m = 0; m < rows; ++m) {
          const float v = stage[m * n + j];
          if (!zero_empty) u = fmaf(uniform, v, u);
          const int id = seg_of(l0 + m);
          if (id == 0) continue;
          if (id != cur) {
            if (cur != 0) oc[size_t(cur - 1) * G] = a;
            cur = id;
            a = oc[size_t(cur - 1) * G];
          }
          a = fmaf(sc[l0 + m], v, a);
        }
      __syncthreads();
    }
    if (j < cols) {
      if (cur != 0) oc[size_t(cur - 1) * G] = a;
      if (!zero_empty)
        for (int s = 0; s < S; ++s)
          if (!((exists[s / 32] >> (s % 32)) & 1u)) oc[size_t(s) * G] = u;
    }
  }
}

// K2 in float32: one block per (head, batch row); q is the (B, S, H, kd)
// float32 scratch.
template <bool Q8>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const float* __restrict__ x, const int* __restrict__ ids,
                     const float* __restrict__ g, AttnWeights<float, Q8> w,
                     float* __restrict__ q, float* __restrict__ out, int L,
                     int C, int G, int S, int kd, int vd, int zero_empty) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  attention_head<Q8>(x + size_t(b) * L * C, g + size_t(b) * S * G, w,
                     out + size_t(b) * S * G, q + size_t(b) * S * H * kd, L,
                     C, G, S, H, h, kd, vd, zero_empty,
                     IdMask{ids + size_t(b) * L, S}, smem);
}

template <bool Q8>
cudaError_t launch_attention(const void* x, const int* ids, const void* g,
                             const AttnWeights<float, Q8>& w, float* q,
                             void* out, int B, int L, int C, int G, int S,
                             int H, int kd, int zero_empty,
                             cudaStream_t stream) {
  const size_t smem = AttnSmem::total(L);
  if (smem > kMaxSmem || q == nullptr || B > 65535)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      attention_kernel<Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return e;
  dim3 grid(H, B);
  attention_kernel<Q8><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), ids, static_cast<const float*>(g), w, q,
      static_cast<float*>(out), L, C, G, S, kd, G / H, zero_empty);
  return cudaGetLastError();
}

// Host-side checks of K2's entries: the key width is the weights' (kd),
// the value width G / H; any S up to a grid's z extent.
inline bool attention_geometry_ok(int B, int L, int C, int G, int S, int H,
                                  int kd) {
  return B >= 1 && L >= 1 && H >= 1 && C % kKc == 0 && C <= kMaxC &&
         S >= 1 && S <= kMaxS && G % H == 0 && head_dims_ok(kd, G / H);
}

}  // namespace pbt
