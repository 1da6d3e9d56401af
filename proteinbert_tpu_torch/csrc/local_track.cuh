// The fused local track of one ProteinBERT block, one (row, TL-row tile) at
// a time (`track_tile`) — the CUDA-core plan, float32 only now. Its users:
// the float32 legs of K1 (local_track.cu), K1's prehaloed entry
// (local_track_valid.cu), #3 (local_track_segments.cu), #3's int8 leg
// (local_track_segments_q8.cu) and the one-pass trunk #6 (one_pass.cu,
// one_pass_q8.cu, through one_pass.cuh). Their bf16 legs run the wgmma +
// TMA passes of local_track_sm90.cuh instead (#6 through
// one_pass_sm90.cuh). This header also holds what every
// local-track entry shares (`TrackArgs`, the tap geometry, the host-side
// checks). Per position l of x (B, L, C):
//
//   h  = x + gelu(conv9,d=1(x) + nb) + gelu(conv9,d=D(x) + wb) + bcast
//   x1 = LN1(h)                      (cast to the activation type)
//   y  = LN2(x1 + gelu(x1 @ Wd + db))
//
// Each 'SAME' conv of k taps (k odd) at dilation d is k shifted (rows x C)
// @ (C x C) tap products, tap t reading rows l + (t - (k-1)/2)*d. Products
// accumulate in float32; the conv outputs are NOT rounded to the activation
// type (fused_block.py:539-547); x1 is rounded before the dense
// (fused_block.py:517); LN statistics are float32 with the biased variance.
//
// SEG = false (K1): bcast is one (C,) row per batch row. SEG = true (the
// segment-masked track of `_fused_segment_kernel`, fused_block.py:977-1019):
// seg (B, L) holds 0 at pad and 1..S for the packed proteins (an id above S
// counts as pad, as the JAX one-hot makes it). Tap t of row l contributes
// only when seg[l + (t-(k-1)/2)d] == seg[l] and seg[l] is in 1..S: the masked A
// rows are zeroed in a small staging tile before the product, so a
// cross-segment contribution is an exact +0.0 and never a difference.
// bcast is (B, S, C) and each position adds its own segment's row (exactly
// 0 at pad). Pad positions still go through both convs (bias only) and both
// LNs, as in the TPU kernel.
//
// What bounds it on the H100: operations, 2*B*L*C^2*(nt + wt + 1) FLOP —
// 40.8 GFLOP at B=8, L=512, C=512 with 9-tap convs, 41 us at 989 TFLOP/s
// bf16 — against ~5.5 us of activation bytes. The weights ((nt + wt +
// 1)*C^2, 10 MB in bf16 at C=512 with 9-tap convs) are
// re-read by every tile from L2, so the design's real limit is L2 -> SM
// weight traffic per row of output.
//
// Design (K1's and #3's bf16 legs run local_track_sm90.cuh instead): the
// TPU kernel held the whole (L+40, C) row and all weights in 13 MiB of VMEM;
// a Hopper block has 227 KB. So one block owns one (b, TL-row tile) and ALL
// C channels (the LNs reduce over C):
//   * it keeps its own TL rows of x in shared memory (the residual, then
//     x1), and no halo window: JAX's gates admit any odd taps and dilation,
//     with halos of hundreds of rows, more than any block holds at C=512.
//     Each step of a conv loads its tap's (TL, KC) operand rows from L2
//     into a double-buffered A tile beside the weight tile, zeros outside
//     [-H, L + H) and, on packed rows, zeros where the tap leaves the row's
//     segment (read from seg in L2; the tile keeps its own rows' ids). Its
//     shared memory does not depend on the taps or the halo;
//   * weight tiles (KC x C) stream from L2 through a cp.async double buffer,
//     overlapping the next step's copies with this step's product;
//   * one float32 (TL, C) buffer carries h between the convs and the tail;
//     the narrow/wide/dense products land in a staging buffer that aliases
//     the weight double buffer once its k-loop is done;
//   * x1 reuses the tile's own rows, so the whole layer is ONE launch.
// The steps run tap-major, then the k-chunks, the order of the window this
// tile replaced (a (TL + 40)-row window for the 9-tap presets), so its
// outputs are that window's bit for bit; at the presets' geometry it takes
// 0.90-0.98x the window's time at C=512 and up to 1.06x at C=128 (K1, #3,
// #6 and the int8 legs, NVIDIA H100 80GB HBM3 at 700 W). TL is 16 rows in
// float32.
//
// Q8 = true is the float32 int8 leg of #3 (local_track_segments_q8.cu) and
// of #6:
// the conv and dense weights arrive as int8 with float32 scales and each
// (KC, C) tile is dequantized on its way into the weight double buffer
// (common.cuh `Q8Tile`, `pipelined_steps_staged`), in place of the cp.async
// copy: step s+1's int8 tile loads into registers while step s's product
// runs, and is converted and stored after it. No shared memory is added
// (there is none to spare at C=512), and every product, mask and rounding
// point is the floating-point leg's.
#pragma once

#include "common.cuh"

namespace pbt {

// The preset geometry's taps and window halo (local_track_sm90.cuh's preset
// conv pass; every other plan takes any odd taps and dilations whose reach
// is at most kMaxHalo rows).
constexpr int kTaps = 9;
constexpr int kCenter = (kTaps - 1) / 2;
constexpr int kHalo = 20;  // max over the two convs of (kTaps-1)/2 * dilation
constexpr int kMaxHalo = 1048576;

// Both convs' taps (odd) and dilations.
struct Taps {
  int nt, wt, nd, wd;
  // Rows each side a conv reaches (the JAX `track_halo`).
  __host__ __device__ int halo() const {
    const int n = (nt - 1) / 2 * nd, w = (wt - 1) / 2 * wd;
    return n > w ? n : w;
  }
  // The bf16 preset conv pass's geometry: 9-tap convs, narrow dilation 1
  // and a wide reach inside its 20-row window.
  __host__ __device__ bool preset() const {
    return nt == kTaps && wt == kTaps && nd == 1 && wd >= 1 &&
           kCenter * wd <= kHalo;
  }
  // What every instantiation takes: odd taps, dilations >= 1, a reach of at
  // most kMaxHalo rows (64-bit arithmetic: no overflow on the way).
  bool ok() const {
    if (nt < 1 || wt < 1 || nt % 2 == 0 || wt % 2 == 0 || nd < 1 || wd < 1)
      return false;
    return (long long)(nt - 1) / 2 * nd <= kMaxHalo &&
           (long long)(wt - 1) / 2 * wd <= kMaxHalo;
  }
};

template <typename T, int C> struct TrackCfg;

template <int C> struct TrackCfg<__nv_bfloat16, C> {
  static constexpr int TL = 32, KC = 32, PAD = 16;
  using Mma = MmaBf16<TL, C, 1, 8>;
};

template <int C> struct TrackCfg<float, C> {
  static constexpr int TL = 16, KC = 16, PAD = 0;
  using Mma = MmaF32<TL, C, 64>;
};

// The tile's own rows, h, the weight and A double buffers, and on packed
// rows the tile's own ids.
template <typename T, int C, bool SEG> struct TrackSmem {
  using Cfg = TrackCfg<T, C>;
  static constexpr int LDW = C + Cfg::PAD;
  static constexpr int LDA = Cfg::KC + Cfg::PAD;
  static constexpr size_t win =
      align128(size_t(Cfg::TL) * LDW * sizeof(T));
  static constexpr size_t h = align128(size_t(Cfg::TL) * C * sizeof(float));
  static constexpr size_t wtile = size_t(Cfg::KC) * LDW * sizeof(T);
  static constexpr size_t wbuf = align128(2 * wtile);
  static constexpr size_t abuf =
      align128(2 * size_t(Cfg::TL) * LDA * sizeof(T));
  static constexpr size_t segw =
      SEG ? align128(size_t(Cfg::TL) * sizeof(int)) : 0;
  static constexpr size_t total = win + h + wbuf + abuf + segw;
  static_assert(wbuf >= size_t(Cfg::TL) * C * sizeof(float),
                "staging aliases the weight double buffer");
  static_assert(total <= 232448, "fits one block's shared memory");
};

// Operands of one local-track launch. seg is null for dense rows (S = 1).
// On the int8 leg (Q8) the conv and dense weights are int8 and nks, wks
// (taps, C) and dks (C,) hold their float32 scales; on the floating-point
// leg the weights are T and the scales null. halo > 0 is the PREHALOED
// entry (K1's and #2's `fused_local_track_valid`, sequence parallelism): x
// is (B, L + 2*halo, C), its first and last halo rows of each batch row are
// a neighbour shard's real rows, and out is the (B, L, C) centre; only rows
// beyond them are zeros. halo = taps.halo(); dense rows only (no SEG, no
// Q8).
template <typename T, bool Q8 = false> struct TrackArgs {
  using W = WeightT<T, Q8>;
  const T* x;
  const int* seg;
  const T* bcast;
  const W* nk;
  const float* nb;
  const W* wk;
  const float* wb;
  const float* s1;
  const float* b1;
  const W* dk;
  const float* db;
  const float* s2;
  const float* b2;
  T* out;
  int L, S;
  Taps taps;
  const float* nks;
  const float* wks;
  const float* dks;
  int halo;
};

// acc = a @ W: the tile's (TL, C) rows `a` (leading dimension C + PAD) times
// W (C, C), whose (KC, C) tiles stream through the double buffer (int8 on
// the Q8 leg, dequantized with the (C,) scales `wscale` on their way in).
template <typename T, int C, bool Q8, typename Mma>
__device__ __forceinline__ void dense_products(Mma& mma, const T* a,
                                               const WeightT<T, Q8>* w,
                                               const float* wscale,
                                               T* wbuf) {
  using Cfg = TrackCfg<T, C>;
  constexpr int KC = Cfg::KC, LDW = C + Cfg::PAD, NK = C / KC;
  constexpr int TILE = KC * LDW;
  const auto compute = [&](int s, int buf) {
    mma.mma(a + s * KC, LDW, wbuf + buf * TILE, LDW, KC);
  };
  mma.zero();
  if constexpr (Q8) {
    Q8Tile<KC, C> tile;
    pipelined_steps_staged(
        NK, [](int, int) {},
        [&](int s) {
          if (s == 0) tile.scales(wscale);
          tile.fetch(w + size_t(s) * KC * C, C);
        },
        [&](int, int buf) { tile.store(wbuf + buf * TILE, LDW); }, compute);
  } else {
    pipelined_steps(
        NK,
        [&](int s, int buf) {
          load_rows_async(wbuf + buf * TILE, LDW, w + size_t(s) * KC * C, C,
                          0, KC, C, 0, KC);
        },
        compute);
  }
}

// The tile's operand rows: x row base xb (centre row 0 of a batch
// row; a prehaloed row has H real rows before it), the tile's first row
// l0, and on packed rows sb (the batch row's ids in device memory), own
// (the tile's own rows' ids in shared memory) and S; sb is null for dense
// rows.
template <typename T> struct TapRows {
  const T* xb;
  int l0, L, H;
  const int* sb;
  const int* own;
  int S;
};

// dst rows m in [0, rows) <- x rows r.l0 + m + off, `cols` columns from
// column col0 (leading dimensions dst_ld and ld): zeros outside [-H, L + H)
// ('SAME' padding) and, on packed rows, where row m is pad or tap row l +
// off lies in another segment (or outside [0, L)), so a masked
// contribution is an exact +0.0. cols * sizeof(T) is a multiple of 16.
template <typename T>
__device__ __forceinline__ void load_tap_rows_async(T* dst, int dst_ld,
                                                    const TapRows<T>& r,
                                                    int col0, int ld,
                                                    int rows, int cols,
                                                    int off) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = cols / kVec;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int m = i / per_row, c = (i - m * per_row) * kVec;
    const int l = r.l0 + m + off;
    bool keep = l >= -r.H && l < r.L + r.H;
    if (r.sb != nullptr) {
      const int id = r.own[m];
      keep = id >= 1 && id <= r.S && l >= 0 && l < r.L && r.sb[l] == id;
    }
    T* d = dst + m * dst_ld + c;
    if (keep)
      cp_async16(d, r.xb + static_cast<ptrdiff_t>(l) * ld + col0 + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// acc = sum over taps t and k-chunks of (x rows shifted by (t - (taps-1)/2)
// * dilation) @ W[t], W (taps, C, C): step s = (tap t, k-chunk kc) loads
// tap t's (TL, KC) operand rows (`load_tap_rows_async`) into the
// double-buffered A tile `abuf` beside its weight tile (int8 on the Q8 leg,
// dequantized with the (taps, C) scales `wscale` on its way in), then
// multiplies them.
template <typename T, int C, bool Q8, typename Mma>
__device__ __forceinline__ void tap_rows_products(
    Mma& mma, const TapRows<T>& r, int taps, int dilation,
    const WeightT<T, Q8>* w, const float* wscale, T* wbuf, T* abuf) {
  using Cfg = TrackCfg<T, C>;
  constexpr int TL = Cfg::TL, KC = Cfg::KC, LDW = C + Cfg::PAD, NK = C / KC;
  constexpr int LDA = KC + Cfg::PAD;
  constexpr int TILE = KC * LDW, ATILE = TL * LDA;
  const int center = (taps - 1) / 2;
  const auto load_a = [&](int s, int buf) {
    const int t = s / NK, kc = s - t * NK;
    load_tap_rows_async(abuf + buf * ATILE, LDA, r, kc * KC, C, TL, KC,
                        (t - center) * dilation);
  };
  const auto compute = [&](int, int buf) {
    mma.mma(abuf + buf * ATILE, LDA, wbuf + buf * TILE, LDW, KC);
  };
  mma.zero();
  if constexpr (Q8) {
    Q8Tile<KC, C> tile;
    pipelined_steps_staged(
        taps * NK, load_a,
        [&](int s) {
          const int t = s / NK, kc = s - (s / NK) * NK;
          if (kc == 0) tile.scales(wscale + size_t(t) * C);
          tile.fetch(w + (size_t(t) * C + kc * KC) * C, C);
        },
        [&](int, int buf) { tile.store(wbuf + buf * TILE, LDW); }, compute);
  } else {
    pipelined_steps(
        taps * NK,
        [&](int s, int buf) {
          load_a(s, buf);
          const int t = s / NK, kc = s - (s / NK) * NK;
          load_rows_async(wbuf + buf * TILE, LDW,
                          w + (size_t(t) * C + kc * KC) * C, C, 0, KC, C, 0,
                          KC);
        },
        compute);
  }
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

// Rows l0 .. l0+TL-1 of batch row b: p.out[b, l] for l < L.
template <typename T, int C, bool SEG, bool Q8>
__device__ __forceinline__ void track_tile(const TrackArgs<T, Q8>& p, int b,
                                           int l0, unsigned char* smem) {
  using Cfg = TrackCfg<T, C>;
  using Smem = TrackSmem<T, C, SEG>;
  constexpr int TL = Cfg::TL, LDW = Smem::LDW;
  T* win = reinterpret_cast<T*>(smem);  // the tile's own x rows
  float* h = reinterpret_cast<float*>(smem + Smem::win);
  T* wbuf = reinterpret_cast<T*>(smem + Smem::win + Smem::h);
  T* abuf = reinterpret_cast<T*>(smem + Smem::win + Smem::h + Smem::wbuf);
  int* segw = reinterpret_cast<int*>(smem + Smem::win + Smem::h + Smem::wbuf +
                                     Smem::abuf);
  float* stage = reinterpret_cast<float*>(wbuf);  // after a k-loop only
  T* x1 = win;                                    // after both convs only

  const int L = p.L, H = p.halo;
  // Row 0 of batch row b's centre; a prehaloed row has H real rows before.
  const T* xb = p.x + (size_t(b) * (L + 2 * H) + H) * C;

  __syncthreads();  // the previous tile of this block is done with smem
  // Input rows l0 .. l0+TL, zeros outside [-H, L + H) ('SAME' padding;
  // H = 0 but for the prehaloed entry).
  load_rows_async(win, LDW, xb, C, l0, TL, C, -H, L + H);
  cp_async_commit();
  const int* segc = nullptr;
  const int* sb = SEG ? p.seg + size_t(b) * L : nullptr;
  if constexpr (SEG) {
    for (int r = threadIdx.x; r < TL; r += kThreads) {
      const int l = l0 + r;
      segw[r] = (l >= 0 && l < L) ? sb[l] : 0;  // rows past L are pad
    }
    segc = segw;
    __syncthreads();  // the first A tile reads them
  }
  const TapRows<T> trows{xb, l0, L, H, sb, segc, p.S};

  typename Cfg::Mma mma;

  // h = x + gelu(narrow + nb)
  tap_rows_products<T, C, Q8>(mma, trows, p.taps.nt, p.taps.nd, p.nk, p.nks,
                              wbuf, abuf);
  mma.store(h, C);
  __syncthreads();
  for (int i = threadIdx.x; i < TL * C; i += kThreads) {
    const int m = i / C, c = i - m * C;
    h[i] = to_f(win[m * LDW + c]) + gelu_tanh(h[i] + p.nb[c]);
  }
  __syncthreads();

  // h += gelu(wide + wb) + bcast (own segment's row; exactly 0 at pad)
  tap_rows_products<T, C, Q8>(mma, trows, p.taps.wt, p.taps.wd, p.wk, p.wks,
                              wbuf, abuf);
  mma.store(stage, C);
  __syncthreads();
  for (int i = threadIdx.x; i < TL * C; i += kThreads) {
    const int m = i / C, c = i - m * C;
    float bc;
    if constexpr (SEG) {
      const int id = segc[m];
      bc = (id >= 1 && id <= p.S)
               ? to_f(p.bcast[(size_t(b) * p.S + id - 1) * C + c])
               : 0.f;
    } else {
      bc = to_f(p.bcast[size_t(b) * C + c]);
    }
    h[i] = (h[i] + gelu_tanh(stage[i] + p.wb[c])) + bc;
  }
  __syncthreads();

  // x1 = LN1(h), rounded to T (fused_block.py:517)
  layer_norm_rows(h, TL, C, p.s1, p.b1, [&](int m, int c, float y) {
    x1[m * LDW + c] = from_f<T>(y);
  });
  __syncthreads();

  // h2 = x1 + gelu(x1 @ Wd + db)
  dense_products<T, C, Q8>(mma, x1, p.dk, p.dks, wbuf);
  mma.store(stage, C);
  __syncthreads();
  for (int i = threadIdx.x; i < TL * C; i += kThreads) {
    const int m = i / C, c = i - m * C;
    h[i] = to_f(x1[m * LDW + c]) + gelu_tanh(stage[i] + p.db[c]);
  }
  __syncthreads();

  // y = LN2(h2) → out rows inside [0, L)
  T* ob = p.out + (size_t(b) * L + l0) * C;
  const int rows = min(TL, L - l0);
  layer_norm_rows(h, rows, C, p.s2, p.b2, [&](int m, int c, float y) {
    ob[m * C + c] = from_f<T>(y);
  });
}

// One block per (TL-row tile, batch row): the whole layer in one launch.
template <typename T, int C, bool SEG, bool Q8>
__global__ void __launch_bounds__(kThreads, 1)
    local_track_kernel(TrackArgs<T, Q8> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  track_tile<T, C, SEG, Q8>(p, blockIdx.y, blockIdx.x * TrackCfg<T, C>::TL,
                            smem);
}

template <typename T, bool SEG, bool Q8, int C>
cudaError_t launch_track_tiles(const TrackArgs<T, Q8>& p, int B,
                               cudaStream_t stream) {
  constexpr size_t smem = TrackSmem<T, C, SEG>::total;
  constexpr int TL = TrackCfg<T, C>::TL;
  cudaError_t e = cudaFuncSetAttribute(
      local_track_kernel<T, C, SEG, Q8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((p.L + TL - 1) / TL, B);
  local_track_kernel<T, C, SEG, Q8><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool SEG, bool Q8 = false>
cudaError_t launch_track(int C, const TrackArgs<T, Q8>& p, int B,
                         cudaStream_t stream) {
  switch (C) {
    case 128:
      return launch_track_tiles<T, SEG, Q8, 128>(p, B, stream);
    case 256:
      return launch_track_tiles<T, SEG, Q8, 256>(p, B, stream);
    case 384:
      return launch_track_tiles<T, SEG, Q8, 384>(p, B, stream);
    case 512:
      return launch_track_tiles<T, SEG, Q8, 512>(p, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Host-side checks every entry shares.
inline bool track_geometry_ok(int B, int L, int S, const Taps& taps) {
  return B >= 1 && L >= 1 && S >= 1 && taps.ok();
}

// The scales nks, wks and dks are the int8 leg's (Q8); leave them null on
// the floating-point leg.
template <typename T, bool Q8 = false>
TrackArgs<T, Q8> track_args(const void* x, const void* seg,
                            const void* bcast, const void* nk,
                            const void* nb, const void* wk, const void* wb,
                            const void* s1, const void* b1, const void* dk,
                            const void* db, const void* s2, const void* b2,
                            void* out, int L, int S, const Taps& taps,
                            const void* nks = nullptr,
                            const void* wks = nullptr,
                            const void* dks = nullptr, int halo = 0) {
  using W = WeightT<T, Q8>;
  return TrackArgs<T, Q8>{
      static_cast<const T*>(x),      static_cast<const int*>(seg),
      static_cast<const T*>(bcast),  static_cast<const W*>(nk),
      static_cast<const float*>(nb), static_cast<const W*>(wk),
      static_cast<const float*>(wb), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const W*>(dk),
      static_cast<const float*>(db), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<T*>(out),
      L,                             S,
      taps,                          static_cast<const float*>(nks),
      static_cast<const float*>(wks), static_cast<const float*>(dks),
      halo};
}

}  // namespace pbt
