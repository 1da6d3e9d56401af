// The channel-tiled local track of one ProteinBERT block, for Hopper
// (sm_90a), at 512 < C <= 2048 (C a multiple of 128): the width of
// ProteinBERT-Large (C = 1024). The device code shared by #2
// (local_track_tiled.cu, dense rows) and #4 (local_track_segments_tiled.cu,
// packed rows). Per position l:
//
//   h  = (gelu(conv_k,nd(x) + nb) + gelu(conv_k,wd(x) + wb)) + x + bcast
//
// (both convs k taps, k odd: JAX's tiled plan takes equal taps only)
//   x1 = LN1(h)                      (rounded to the activation type)
//   y  = LN2(x1 + gelu(x1 @ Wd + db))
//
// with the rounding points of `_finish_row` (fused_block.py:514-523): the
// tap products and both conv outputs stay float32, x1 is rounded before the
// dense, LN statistics are float32 with the biased variance. The float32 sum
// is taken in the TPU tiled kernels' order (fused_block.py:604-618 and
// :662-681: the two GELU terms first, then x, then the broadcast), not in
// K1's.
//
// SEG = false (#2): bcast is one (C,) row per batch row. SEG = true (#4, the
// masks of `_fused_segment_kernel_tiled`): seg (B, L) holds 0 at pad and
// 1..S for the packed proteins (an id above S counts as pad). Tap t of row l
// contributes only when seg[l + (t-(k-1)/2)d] == seg[l] and seg[l] is in
// 1..S;
// rows outside [0, L) are pad. bcast is (B, S, C) and each position adds its
// own segment's row, exactly 0.0 at pad. Pad positions still run both convs
// (bias only) and both LNs, as the TPU kernel does.
//
// What bounds it on the H100: operations, 2*B*L*C^2*(2k + 1) FLOP — 326
// GFLOP at B=8, L=C=1024 with 9-tap convs, 0.330 ms at 989 TFLOP/s bf16 —
// against ~70 MB of activation
// and weight bytes (0.021 ms at 3.35 TB/s). The segment gather is an index,
// not FLOPs.
//
// Design. A Hopper block cannot carry scratch across blocks, and a (TL+40,
// C) window with a (TL, C) float32 h does not fit 227 KB at C = 1024, so the
// layer runs as TWO launches that meet in a float32 (B, L, C) scratch the
// wrapper allocates: a conv pass per (row tile, batch row, 128 output
// channels), then a finish pass per (row tile, batch row) over all C (the
// LNs reduce over C). Rows past L in a tile are computed on zero fill and
// never written, so any L works.
//
// bf16 runs the `wgmma` + TMA passes of local_track_sm90.cuh
// (`wgmma_conv_kernel`, `wgmma_finish_kernel`) with the tiled kernels' sum
// order; their design, bound and L2 traffic are stated there (at B=8,
// L=C=1024 the conv pass moves 2.4 GB from L2, the finish pass 0.26 GB).
// float32 keeps the CUDA-core plan below: the tensor cores have no exact
// float32 mode (TF32 keeps 10 mantissa bits), and the float32 gates and
// reference steps hold the kernels to 1e-4. Its conv pass
// (`tiled_conv_kernel`) is one block per (128 channels, 64 rows, batch
// row), 8-channel k-chunks of a (64+40, 8) window slice and the nine
// (8, 128) tap slices through a cp.async double buffer, the nine taps as
// nine shifted products (MmaF32); the narrow conv's GELU goes to the
// scratch and the wide conv's epilogue adds its GELU, x and the broadcast
// in place. Its segment mask copies each tap's (64, 8) operand rows into a
// staging tile, zeroed where masked (two tiles alternate, one barrier a
// tap); a block whose in-range window rows all hold one valid id runs the
// unmasked products (the choice depends on the ids alone, never on x). Its
// finish pass (`tiled_finish_kernel`), one block per (16 rows, batch row):
// LN1 into a (16, C) x1 tile, the dense in 256-column chunks with Wd
// through a cp.async double buffer, the residual back to the scratch rows,
// LN2. The float32 conv pass's window holds the preset geometry's 20-row
// halo (9-tap convs, narrow dilation 1, wide dilation <= 5); any other odd
// taps and dilation run its general instantiation (ANY), which keeps no
// window: each step loads one tap's (64, 8) operand rows from L2
// (local_track.cuh `load_tap_rows_async`, masked there on packed rows) and
// that tap's (8, 128) weight slice through the double buffer, in the
// preset's order (k-chunk, then tap), whatever the halo. At the preset
// geometry it gives the preset's bits, but takes 1.08-1.25x its time (nine
// times the pipeline steps; #2, #4 and #2 prehaloed at C=1024, NVIDIA H100
// 80GB HBM3 at 700 W), so the preset keeps its window.
#pragma once

#include <type_traits>

#include "local_track_sm90.cuh"

namespace pbt {

// float32: the CUDA-core plan's tiles.
template <typename T> struct TiledCfg;

template <> struct TiledCfg<float> {
  static constexpr int TL = 64, TC = 128, KC = 8, PAD = 0;
  static constexpr int FL = 16, FN = 256, FK = 16;
  using ConvMma = MmaF32<TL, TC, 32>;
  using DenseMma = MmaF32<FL, FN, 64>;
};

// ANY: the general pass's stage (one tap's operand rows and weights).
template <typename T, bool SEG, bool ANY = false> struct ConvSmem {
  using Cfg = TiledCfg<T>;
  static constexpr int LDA = Cfg::KC + Cfg::PAD;
  static constexpr int LDB = Cfg::TC + Cfg::PAD;
  static constexpr int HALO = ANY ? 0 : kHalo;  // window rows each side
  static constexpr int WIN = Cfg::TL + 2 * HALO;
  static constexpr int TAPS = ANY ? 1 : kTaps;   // taps a stage
  static constexpr int A_TILE = WIN * LDA;               // elements
  static constexpr int B_TILE = TAPS * Cfg::KC * LDB;    // elements
  static constexpr int M_TILE = Cfg::TL * LDA;           // one masked tap
  static constexpr size_t stage = align128((A_TILE + B_TILE) * sizeof(T));
  static constexpr size_t product = size_t(Cfg::TL) * Cfg::TC * sizeof(float);
  static constexpr size_t ring = 2 * stage > product ? 2 * stage : product;
  static constexpr size_t masked =
      SEG && !ANY ? align128(2 * size_t(M_TILE) * sizeof(T)) : 0;
  static constexpr size_t ids = SEG ? align128(size_t(WIN) * sizeof(int)) : 0;
  static constexpr size_t total = ring + masked + ids;
  static_assert(ring >= size_t(Cfg::TL) * Cfg::TC * sizeof(float),
                "the product tile aliases the double buffer");
  static_assert(total <= 232448, "fits one block's shared memory");
};

template <typename T> struct FinishSmem {
  using Cfg = TiledCfg<T>;
  static constexpr int LDW = Cfg::FN + Cfg::PAD;
  static constexpr int W_TILE = Cfg::FK * LDW;  // elements
  static constexpr size_t wbuf = align128(2 * size_t(W_TILE) * sizeof(T));
  static_assert(wbuf >= size_t(Cfg::FL) * Cfg::FN * sizeof(float),
                "the product tile aliases the weight double buffer");
  __host__ __device__ static size_t x1(int C) {
    return align128(size_t(Cfg::FL) * (C + Cfg::PAD) * sizeof(T));
  }
  __host__ __device__ static size_t total(int C) { return x1(C) + wbuf; }
};

// dst rows m in [0, TL) <- src rows m (leading dimension ld, KC columns),
// zeroed where tap offset `off` leaves row m's segment or row m is pad.
// segc points at the window's id of output row 0.
template <typename T, int TL, int KC>
__device__ __forceinline__ void mask_tap_rows(T* dst, const T* src, int ld,
                                              const int* segc, int off,
                                              int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int per_row = KC / kVec;
  for (int i = threadIdx.x; i < TL * per_row; i += kThreads) {
    const int m = i / per_row, c = (i - m * per_row) * kVec;
    const int id = segc[m];
    const bool keep = id >= 1 && id <= S && segc[m + off] == id;
    *reinterpret_cast<uint4*>(dst + m * ld + c) =
        keep ? *reinterpret_cast<const uint4*>(src + m * ld + c)
             : make_uint4(0u, 0u, 0u, 0u);
  }
}

// float32 pass 1: h[b, l0 : l0+TL, c0 : c0+TC] of the float32 scratch
// (ANY: the general instantiation).
template <typename T, bool SEG, bool ANY>
__global__ void __launch_bounds__(kThreads)
    tiled_conv_kernel(TrackArgs<T> p, int C, float* __restrict__ h) {
  using Cfg = TiledCfg<T>;
  using Smem = ConvSmem<T, SEG, ANY>;
  constexpr int TL = Cfg::TL, TC = Cfg::TC, KC = Cfg::KC;
  constexpr int LDA = Smem::LDA, LDB = Smem::LDB;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);  // after a k-loop only
  [[maybe_unused]] T* mbuf = reinterpret_cast<T*>(smem + Smem::ring);
  int* segw = reinterpret_cast<int*>(smem + Smem::ring + Smem::masked);
  const int* segc = segw + Smem::HALO;  // the id of output row 0

  const int c0 = blockIdx.x * TC, l0 = blockIdx.y * TL, b = blockIdx.z;
  const int L = p.L, H = p.halo;
  // Row 0 of batch row b's centre; a prehaloed row has H real rows before.
  const T* xb = p.x + (size_t(b) * (L + 2 * H) + H) * C;
  float* hb = h + size_t(b) * L * C;
  const int rows = min(TL, L - l0);

  // The window's ids (halo rows outside [0, L) are pad), and whether this
  // block needs the mask at all.
  [[maybe_unused]] bool masked = false;
  const int* sb = SEG ? p.seg + size_t(b) * L : nullptr;
  if constexpr (SEG) {
    for (int r = threadIdx.x; r < Smem::WIN; r += kThreads) {
      const int l = l0 - Smem::HALO + r;
      segw[r] = (l >= 0 && l < L) ? sb[l] : 0;
    }
    __syncthreads();
    if constexpr (!ANY) {
      const int id0 = segc[0];  // row l0 < L
      int mixed = id0 < 1 || id0 > p.S;
      for (int r = threadIdx.x; r < Smem::WIN; r += kThreads) {
        const int l = l0 - Smem::HALO + r;
        if (l >= 0 && l < L && segw[r] != id0) mixed = 1;
      }
      masked = __syncthreads_or(mixed) != 0;
    }
  }
  // The general instantiation's operand rows (its tap rows reach past the
  // block's own ids, so packed rows are always masked).
  [[maybe_unused]] const TapRows<T> trows{xb, l0, L, H, sb, segc, p.S};

  typename Cfg::ConvMma mma;
  for (int conv = 0; conv < 2; ++conv) {
    const T* w = conv == 0 ? p.nk : p.wk;
    const int dilation = conv == 0 ? (ANY ? p.taps.nd : 1) : p.taps.wd;
    mma.zero();
    if constexpr (ANY) {
      // Step s: k-chunk s / k, tap s % k (both convs k = nt = wt taps).
      const int taps = p.taps.nt, center = (taps - 1) / 2;
      pipelined_steps(
          C / KC * taps,
          [&](int s, int buf) {
            T* a = reinterpret_cast<T*>(smem + buf * Smem::stage);
            const int kc = s / taps, t = s - kc * taps;
            load_tap_rows_async(a, LDA, trows, kc * KC, C, TL, KC,
                                (t - center) * dilation);
            load_rows_async(a + Smem::A_TILE, LDB,
                            w + (size_t(t) * C + kc * KC) * C + c0, C, 0, KC,
                            TC, 0, KC);
          },
          [&](int, int buf) {
            const T* a = reinterpret_cast<const T*>(smem + buf * Smem::stage);
            mma.mma(a, LDA, a + Smem::A_TILE, LDB, KC);
          });
    } else {
      pipelined_steps(
          C / KC,
          [&](int s, int buf) {
            T* a = reinterpret_cast<T*>(smem + buf * Smem::stage);
            T* bt = a + Smem::A_TILE;
            // Input rows l0-20 .. l0+TL+20 of channels s*KC .., zeros outside
            // [-H, L + H) ('SAME' padding; H = 0 but for the prehaloed entry).
            load_rows_async(a, LDA, xb + s * KC, C, l0 - Smem::HALO, Smem::WIN,
                            KC, -H, L + H);
            for (int t = 0; t < kTaps; ++t)
              load_rows_async(bt + t * KC * LDB, LDB,
                              w + (size_t(t) * C + s * KC) * C + c0, C, 0, KC,
                              TC, 0, KC);
          },
          [&](int, int buf) {
            const T* a = reinterpret_cast<const T*>(smem + buf * Smem::stage);
            const T* bt = a + Smem::A_TILE;
#pragma unroll 1
            for (int t = 0; t < kTaps; ++t) {
              const int off = (t - kCenter) * dilation;
              const T* at = a + (kHalo + off) * LDA;
              if (SEG && masked) {
                // Two staging tiles alternate: tap t+2 rewrites this one only
                // after every warp passed tap t+1's barrier.
                T* mt = mbuf + (t & 1) * Smem::M_TILE;
                mask_tap_rows<T, TL, KC>(mt, at, LDA, segc, off, p.S);
                __syncthreads();
                mma.mma(mt, LDA, bt + t * KC * LDB, LDB, KC);
              } else {
                mma.mma(at, LDA, bt + t * KC * LDB, LDB, KC);
              }
            }
          });
    }
    mma.store(stage, TC);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * TC; i += kThreads) {
      const int m = i / TC, c = i - m * TC;
      const size_t o = size_t(l0 + m) * C + c0 + c;
      if (conv == 0) {
        hb[o] = gelu_tanh(stage[i] + p.nb[c0 + c]);
      } else {
        float bc;
        if constexpr (SEG) {
          const int id = segc[m];
          bc = (id >= 1 && id <= p.S)
                   ? to_f(p.bcast[(size_t(b) * p.S + id - 1) * C + c0 + c])
                   : 0.f;
        } else {
          bc = to_f(p.bcast[size_t(b) * C + c0 + c]);
        }
        hb[o] = ((hb[o] + gelu_tanh(stage[i] + p.wb[c0 + c])) + to_f(xb[o])) +
                bc;
      }
    }
    __syncthreads();
  }
}


// float32 pass 2: rows l0 .. l0+FL-1 of batch row b, LN1 → dense(+GELU,
// residual) → LN2, the scratch rows reused for the residual.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    tiled_finish_kernel(TrackArgs<T> p, int C, float* __restrict__ h) {
  using Cfg = TiledCfg<T>;
  using Smem = FinishSmem<T>;
  constexpr int FL = Cfg::FL, FN = Cfg::FN, FK = Cfg::FK, LDW = Smem::LDW;
  extern __shared__ __align__(128) unsigned char smem[];
  const int LDX = C + Cfg::PAD;
  T* x1 = reinterpret_cast<T*>(smem);
  T* wbuf = reinterpret_cast<T*>(smem + Smem::x1(C));
  float* stage = reinterpret_cast<float*>(wbuf);  // after a k-loop only

  const int l0 = blockIdx.x * FL, b = blockIdx.y;
  const int L = p.L;
  const int rows = min(FL, L - l0);
  float* hb = h + (size_t(b) * L + l0) * C;

  // x1 = LN1(h), rounded to T (fused_block.py:517); rows past L are zero.
  layer_norm_rows(hb, rows, C, p.s1, p.b1, [&](int m, int c, float y) {
    x1[m * LDX + c] = from_f<T>(y);
  });
  for (int i = threadIdx.x; i < (FL - rows) * C; i += kThreads) {
    const int m = rows + i / C, c = i % C;
    x1[m * LDX + c] = from_f<T>(0.f);
  }
  __syncthreads();

  // h2 = x1 + gelu(x1 @ Wd + db), FN output columns at a time.
  typename Cfg::DenseMma mma;
  for (int n0 = 0; n0 < C; n0 += FN) {
    mma.zero();
    pipelined_steps(
        C / FK,
        [&](int s, int buf) {
          load_rows_async(wbuf + buf * Smem::W_TILE, LDW,
                          p.dk + size_t(s) * FK * C + n0, C, 0, FK, FN, 0,
                          FK);
        },
        [&](int s, int buf) {
          mma.mma(x1 + s * FK, LDX, wbuf + buf * Smem::W_TILE, LDW, FK);
        });
    mma.store(stage, FN);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * FN; i += kThreads) {
      const int m = i / FN, c = i - m * FN;
      hb[size_t(m) * C + n0 + c] =
          to_f(x1[m * LDX + n0 + c]) + gelu_tanh(stage[i] + p.db[n0 + c]);
    }
    __syncthreads();
  }

  // y = LN2(h2) → out rows inside [0, L)
  T* ob = p.out + (size_t(b) * L + l0) * C;
  layer_norm_rows(hb, rows, C, p.s2, p.b2, [&](int m, int c, float y) {
    ob[size_t(m) * C + c] = from_f<T>(y);
  });
}

// The float32 conv pass, preset or general (ANY) instantiation.
template <typename T, bool SEG, bool ANY>
cudaError_t launch_tiled_conv(const TrackArgs<T>& p, int C, float* h,
                              dim3 grid, cudaStream_t stream) {
  const size_t smem = ConvSmem<T, SEG, ANY>::total;
  cudaError_t e = cudaFuncSetAttribute(
      tiled_conv_kernel<T, SEG, ANY>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  tiled_conv_kernel<T, SEG, ANY><<<grid, kThreads, smem, stream>>>(p, C, h);
  return cudaGetLastError();
}

// Both passes: wgmma + TMA in bf16, the CUDA-core plan in float32.
template <typename T, bool SEG>
cudaError_t launch_tiled(const TrackArgs<T>& p, int B, int C, float* h,
                         cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_track_sm90<SEG, SumOrder::kTiled>(p, B, C, h, stream);
  } else {
    using Cfg = TiledCfg<T>;
    const size_t finish_smem = FinishSmem<T>::total(C);
    if (finish_smem > 232448) return cudaErrorInvalidValue;
    const dim3 conv_grid(C / Cfg::TC, (p.L + Cfg::TL - 1) / Cfg::TL, B);
    cudaError_t e = p.taps.preset()
                        ? launch_tiled_conv<T, SEG, false>(p, C, h, conv_grid,
                                                           stream)
                        : launch_tiled_conv<T, SEG, true>(p, C, h, conv_grid,
                                                          stream);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(tiled_finish_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(finish_smem));
    if (e != cudaSuccess) return e;
    dim3 finish_grid((p.L + Cfg::FL - 1) / Cfg::FL, B);
    tiled_finish_kernel<T><<<finish_grid, kThreads, finish_smem, stream>>>(
        p, C, h);
    return cudaGetLastError();
  }
}

// Host-side checks both entries share: both convs take the same taps.
inline bool tiled_geometry_ok(int B, int L, int C, int S, const Taps& taps) {
  return track_geometry_ok(B, L, S, taps) && taps.nt == taps.wt &&
         C % 128 == 0 && C > 512 && C <= 2048 && B <= 65535;
}

}  // namespace pbt
