// The channel-tiled local track of one ProteinBERT block, for Hopper
// (sm_90a), at 512 < C <= 2048 (C a multiple of 128): the width of
// ProteinBERT-Large (C = 1024). The device code shared by #2
// (local_track_tiled.cu, dense rows) and #4 (local_track_segments_tiled.cu,
// packed rows), as local_track.cuh serves K1 and #3. Per position l:
//
//   h  = (gelu(conv9,d=1(x) + nb) + gelu(conv9,d=D(x) + wb)) + x + bcast
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
// contributes only when seg[l + (t-4)d] == seg[l] and seg[l] is in 1..S;
// rows outside [0, L) are pad. bcast is (B, S, C) and each position adds its
// own segment's row, exactly 0.0 at pad. Pad positions still run both convs
// (bias only) and both LNs, as the TPU kernel does.
//
// What bounds it on the H100: operations, 2*B*L*C^2*19 FLOP — 326 GFLOP at
// B=8, L=C=1024, 0.330 ms at 989 TFLOP/s bf16 — against ~70 MB of activation
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
// bf16 conv pass (`wgmma_conv_kernel`): an implicit GEMM over K = (64-channel
// chunk, tap) on the tensor cores through `wgmma`, both convs at once.
//   * A block is 384 threads: one producer warp (in a warpgroup that gives
//     its registers away with setmaxnreg) and two consumer warpgroups, each
//     owning 64 of the tile's 128 rows x 128 output channels as two
//     m64n128 float32 accumulators (narrow and wide conv, 128 registers).
//   * For each 64-channel chunk the producer TMA-loads the (128+40, 64)
//     window slice once (21 KB, three-stage ring) through a 3-D tensor map
//     over (C, L + 2H, B): its out-of-bounds zero fill is the 'SAME' padding
//     outside [-H, L + H), so the dense (H = 0) and prehaloed (H = 20)
//     entries run the same code. The chunk's 18 weight tiles (9 taps x 2
//     convs, each (64 in, 128 out), 16 KB) stream through an eight-stage
//     mbarrier ring, each as two 64-column TMA boxes with a 128-byte swizzle.
//   * A comes from registers: a tap's operand is the window shifted by
//     (t-4)*d rows, which is no legal start for a swizzled descriptor at
//     d = 5, so each warp ldmatrix-loads its 16 rows at the shifted row
//     address (the swizzle undone per row) and issues m64n128k16 with B
//     read MN-major (transpose bit) from the TMA tile, as the weights are
//     stored (tap, C_in, C_out). Each output's sum runs over (chunk, tap,
//     k-step) in one order that depends on its window alone, never on where
//     its tile starts: the prehaloed shards stay bit for bit the whole row.
//   * #4's mask lives in registers: each thread's two fragment rows get one
//     keep bit per (conv, tap), computed once from the window's ids in
//     shared memory; a masked row's A registers are zeroed after ldmatrix,
//     so a cross-segment term is an exact 0 product, with no staging tile
//     and no barrier per tap. The epilogue gathers row seg[l]-1 of the
//     (S, C) broadcast (the TPU kernel's one-hot product has one nonzero
//     term, so an index is the same function).
//   * The narrow conv's result stays in registers while the wide conv
//     accumulates; the epilogue writes ((gelu_n + gelu_w) + x) + bcast to h
//     once, with no read-back.
//   L2 -> SM traffic of the weight stream: every block reads both convs'
//   9 x C x 128 slice (4.7 MB at C = 1024) and a block covers 128 rows, so
//   B*L/128 x C/128 blocks read 2.4 GB a call at B=8, L=C=1024; the grid
//   walks row tiles and batch rows of one channel tile first, so the blocks
//   resident at once share ~2 channel tiles' weights (~10 MB) in L2 and HBM
//   reads each weight about once. A cluster of two row tiles multicasting
//   each weight tile would halve the L2 traffic, but measured 3.2x slower
//   on the H100 (PERF.md), so blocks stand alone. The consumers sit
//   at the 168 registers of a 384-thread block: anything added to their
//   loop spills and ptxas serialises the products.
// bf16 finish pass (`wgmma_finish_kernel`), one block per (64 rows, batch
// row) — 32 rows above C = 1024, so x1 fits — over all C:
//   * LN1 of the scratch rows into x1 (bf16) in shared memory, laid out in
//     64-channel chunks with the 128-byte swizzle, while the producer's
//     first Wd tiles are in flight;
//   * h2 = x1 + gelu(x1 @ Wd + db): x1's A fragments by ldmatrix, Wd
//     (C_in, C_out) as (64, 256) tiles through a three-stage TMA ring, each
//     consumer warpgroup one m64n128 accumulator over 128 of the 256
//     columns; h2 goes back into the scratch rows (LN1 has read them);
//   * LN2 of those rows to the output. The LN statistics stay float32 and
//     x1 is rounded before the dense. Each LN reads its row once, as
//     float4s held in registers. Wd's L2 -> SM traffic is 2 MB a 64-row
//     block, 256 MB a call at B=8, L=C=1024. LN and the dense are per
//     position, so this pass needs no segment ids.
// float32 keeps the CUDA-core plan: the tensor cores have no exact float32
// mode (TF32 keeps 10 mantissa bits), and the float32 gates and reference
// steps hold the kernels to 1e-4. Its conv pass (`tiled_conv_kernel`) is
// one block per (128 channels, 64 rows, batch row), 8-channel k-chunks of a
// (64+40, 8) window slice and the nine (8, 128) tap slices through a
// cp.async double buffer, the nine taps as nine shifted products
// (MmaF32); the narrow conv's GELU goes to the scratch and the wide conv's
// epilogue adds its GELU, x and the broadcast in place. Its segment mask
// copies each tap's (64, 8) operand rows into a staging tile, zeroed where
// masked (two tiles alternate, one barrier a tap); a block whose in-range
// window rows all hold one valid id runs the unmasked products (the choice
// depends on the ids alone, never on x). Its finish pass
// (`tiled_finish_kernel`), one block per (16 rows, batch row): LN1 into a
// (16, C) x1 tile, the dense in 256-column chunks with Wd through a
// cp.async double buffer, the residual back to the scratch rows, LN2.
#pragma once

#include <type_traits>

#include "hopper.cuh"
#include "local_track.cuh"

namespace pbt {

// float32: the CUDA-core plan's tiles.
template <typename T> struct TiledCfg;

template <> struct TiledCfg<float> {
  static constexpr int TL = 64, TC = 128, KC = 8, PAD = 0;
  static constexpr int FL = 16, FN = 256, FK = 16;
  using ConvMma = MmaF32<TL, TC, 32>;
  using DenseMma = MmaF32<FL, FN, 64>;
};

// The bf16 conv pass: tile, rings and shared-memory layout.
struct WgConv {
  static constexpr int TM = 128;  // output rows: two consumer warpgroups
  static constexpr int TN = 128;  // output channels
  static constexpr int KC = 64;   // input channels a chunk: one 128-byte row
  static constexpr int WIN = TM + 2 * kHalo;
  static constexpr int XSTAGES = 3, WSTAGES = 8;
  static constexpr int THREADS = 384;
  static constexpr int CONSUMER_WARPS = 8;
  static constexpr uint32_t ROW_BYTES = KC * 2;
  static constexpr uint32_t WIN_BYTES = WIN * ROW_BYTES;  // 21504
  static constexpr uint32_t BOX_BYTES = KC * 64 * 2;      // 64 x 64 box
  static constexpr uint32_t W_BYTES = 2 * BOX_BYTES;      // (64, 128) tile
  static constexpr uint32_t KSTEP_BYTES = 16 * ROW_BYTES; // 16 K rows
  static constexpr size_t win_off = 0;
  static constexpr size_t w_off = win_off + XSTAGES * WIN_BYTES;
  static constexpr size_t ids_off = w_off + WSTAGES * size_t(W_BYTES);
  static constexpr size_t bar_off = ids_off + align128(WIN * sizeof(int));
  static constexpr size_t total =
      bar_off + 2 * (XSTAGES + WSTAGES) * 8 + 1024;  // + alignment slack
  static_assert(WIN_BYTES % 1024 == 0 && W_BYTES % 1024 == 0,
                "swizzled tiles start on 1024-byte boundaries");
  static_assert(WIN <= 256, "one TMA box");
  static_assert(total <= 232448, "fits one block's shared memory");
};

// The bf16 finish pass: rows a block (64, or 32 above C = 1024 so x1 fits),
// the Wd ring of (64, 256) tiles, and shared-memory layout.
struct WgFinish {
  static constexpr int THREADS = 384;
  static constexpr int STAGES = 3;
  static constexpr int CONSUMER_WARPS = 8;
  static constexpr int KC = 64, NC = 256;  // k-chunk; n-chunk of both WGs
  static constexpr uint32_t ROW_BYTES = KC * 2;
  static constexpr uint32_t BOX_BYTES = KC * 64 * 2;  // 64 x 64 box
  static constexpr uint32_t W_BYTES = 4 * BOX_BYTES;  // (64, 256) tile
  static constexpr uint32_t KSTEP_BYTES = 16 * ROW_BYTES;
  __host__ __device__ static constexpr int rows(int C) {
    return C <= 1024 ? 64 : 32;
  }
  // x1 (rows, C) bf16 as C/64 chunks of (rows, 64), each row 128 bytes.
  __host__ __device__ static constexpr size_t x1_bytes(int C) {
    return size_t(rows(C)) * C * 2;
  }
  __host__ __device__ static constexpr size_t total(int C) {
    return x1_bytes(C) + STAGES * size_t(W_BYTES) + 2 * STAGES * 8 + 1024;
  }
};
static_assert(WgFinish::total(2048) <= 232448 &&
                  WgFinish::total(1024) <= 232448,
              "fits one block's shared memory");

template <typename T, bool SEG> struct ConvSmem {
  using Cfg = TiledCfg<T>;
  static constexpr int LDA = Cfg::KC + Cfg::PAD;
  static constexpr int LDB = Cfg::TC + Cfg::PAD;
  static constexpr int WIN = Cfg::TL + 2 * kHalo;
  static constexpr int A_TILE = WIN * LDA;               // elements
  static constexpr int B_TILE = kTaps * Cfg::KC * LDB;   // elements
  static constexpr int M_TILE = Cfg::TL * LDA;           // one masked tap
  static constexpr size_t stage = align128((A_TILE + B_TILE) * sizeof(T));
  static constexpr size_t ring = 2 * stage;
  static constexpr size_t masked =
      SEG ? align128(2 * size_t(M_TILE) * sizeof(T)) : 0;
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

// float32 pass 1: h[b, l0 : l0+TL, c0 : c0+TC] of the float32 scratch.
template <typename T, bool SEG>
__global__ void __launch_bounds__(kThreads)
    tiled_conv_kernel(TrackArgs<T> p, int C, float* __restrict__ h) {
  using Cfg = TiledCfg<T>;
  using Smem = ConvSmem<T, SEG>;
  constexpr int TL = Cfg::TL, TC = Cfg::TC, KC = Cfg::KC;
  constexpr int LDA = Smem::LDA, LDB = Smem::LDB;
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);  // after a k-loop only
  T* mbuf = reinterpret_cast<T*>(smem + Smem::ring);
  int* segw = reinterpret_cast<int*>(smem + Smem::ring + Smem::masked);
  const int* segc = segw + kHalo;  // the id of output row 0

  const int c0 = blockIdx.x * TC, l0 = blockIdx.y * TL, b = blockIdx.z;
  const int L = p.L, H = p.halo;
  // Row 0 of batch row b's centre; a prehaloed row has H real rows before.
  const T* xb = p.x + (size_t(b) * (L + 2 * H) + H) * C;
  float* hb = h + size_t(b) * L * C;
  const int rows = min(TL, L - l0);

  // The window's ids (halo rows outside [0, L) are pad), and whether this
  // block needs the mask at all.
  bool masked = false;
  if constexpr (SEG) {
    const int* sb = p.seg + size_t(b) * L;
    for (int r = threadIdx.x; r < Smem::WIN; r += kThreads) {
      const int l = l0 - kHalo + r;
      segw[r] = (l >= 0 && l < L) ? sb[l] : 0;
    }
    __syncthreads();
    const int id0 = segc[0];  // row l0 < L
    int mixed = id0 < 1 || id0 > p.S;
    for (int r = threadIdx.x; r < Smem::WIN; r += kThreads) {
      const int l = l0 - kHalo + r;
      if (l >= 0 && l < L && segw[r] != id0) mixed = 1;
    }
    masked = __syncthreads_or(mixed) != 0;
  }

  typename Cfg::ConvMma mma;
  for (int conv = 0; conv < 2; ++conv) {
    const T* w = conv == 0 ? p.nk : p.wk;
    const int dilation = conv == 0 ? 1 : p.wide_dilation;
    mma.zero();
    pipelined_steps(
        C / KC,
        [&](int s, int buf) {
          T* a = reinterpret_cast<T*>(smem + buf * Smem::stage);
          T* bt = a + Smem::A_TILE;
          // Input rows l0-20 .. l0+TL+20 of channels s*KC .., zeros outside
          // [-H, L + H) ('SAME' padding; H = 0 but for the prehaloed entry).
          load_rows_async(a, LDA, xb + s * KC, C, l0 - kHalo, Smem::WIN, KC,
                          -H, L + H);
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

// The nine taps of one conv on one window chunk: acc += sum over t of
// window[rows + (t-4)*d] @ W_t, each tap one commit group of four k-steps.
// `it` counts weight tiles over the whole k-loop (ring stage and parity).
template <bool SEG>
__device__ __forceinline__ void wg_conv_taps(float (&acc)[64], uint32_t win,
                                             int lrow, int lcol, int d,
                                             uint32_t keep, uint32_t w0,
                                             uint32_t bars_full,
                                             uint32_t bars_empty, int& it,
                                             int lane) {
  using K = WgConv;
  using namespace sm90;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const int st = it % K::WSTAGES;
    mbar_wait(bars_full + 8 * st, (it / K::WSTAGES) & 1);
    const int r = kHalo + (t - kCenter) * d + lrow;  // window row
    const uint32_t row = win + r * K::ROW_BYTES;
    uint32_t a[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // 16-byte chunk (2k + lcol) of row r, where the 128-byte swizzle put it
      ldmatrix_x4(row + ((((2 * k + lcol) ^ r) & 7) << 4), a[k]);
      if constexpr (SEG) {
        if (!((keep >> (2 * t)) & 1u)) a[k][0] = a[k][2] = 0u;
        if (!((keep >> (2 * t + 1)) & 1u)) a[k][1] = a[k][3] = 0u;
      }
    }
    wgmma_fence();
    const uint64_t desc =
        desc_sw128(w0 + st * K::W_BYTES, K::BOX_BYTES, 8 * K::ROW_BYTES);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_m64n128k16_rs(acc, a[k], desc + ((k * K::KSTEP_BYTES) >> 4));
    wgmma_commit();
    // The previous tap's products are done: release its weight tile.
    wgmma_wait<1>();
    if (it > 0 && lane == 0)
      mbar_arrive(bars_empty + 8 * ((it - 1) % K::WSTAGES));
    ++it;
  }
}

// bf16 pass 1: h[b, l0 : l0+128, c0 : c0+128] of the float32 scratch, on the
// tensor cores (the design note above). tx maps x as (C, L + 2H, B); tn and
// tw map the narrow and wide conv weights as (C_out, 9 * C_in).
template <bool SEG>
__global__ void __launch_bounds__(WgConv::THREADS, 1)
    wgmma_conv_kernel(TrackArgs<__nv_bfloat16> p, int C,
                      float* __restrict__ h,
                      const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tn,
                      const __grid_constant__ CUtensorMap tw) {
  using K = WgConv;
  using namespace sm90;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int* segw = reinterpret_cast<int*>(smem_raw + (base - raw) + K::ids_off);
  const int* segc = segw + kHalo;  // the id of output row 0
  const uint32_t win0 = base + K::win_off, w0 = base + K::w_off;
  const uint32_t full_x = base + K::bar_off;
  const uint32_t empty_x = full_x + 8 * K::XSTAGES;
  const uint32_t full_w = empty_x + 8 * K::XSTAGES;
  const uint32_t empty_w = full_w + 8 * K::WSTAGES;

  const int l0 = blockIdx.x * K::TM, b = blockIdx.y, c0 = blockIdx.z * K::TN;
  const int L = p.L, H = p.halo;
  const int chunks = C / K::KC;

  if (threadIdx.x == 0) {
    for (int i = 0; i < K::XSTAGES; ++i) {
      mbar_init(full_x + 8 * i, 1);
      mbar_init(empty_x + 8 * i, K::CONSUMER_WARPS);
    }
    for (int i = 0; i < K::WSTAGES; ++i) {
      mbar_init(full_w + 8 * i, 1);
      mbar_init(empty_w + 8 * i, K::CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  if constexpr (SEG) {
    // The window's ids; rows outside [0, L) are pad.
    const int* sb = p.seg + size_t(b) * L;
    for (int r = threadIdx.x; r < K::WIN; r += K::THREADS) {
      const int l = l0 - kHalo + r;
      segw[r] = (l >= 0 && l < L) ? sb[l] : 0;
    }
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the TMA loads in flight.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const int xrow = H + l0 - kHalo;  // map row of window row 0
      auto load_window = [&](int s) {
        const int st = s % K::XSTAGES;
        mbar_wait(empty_x + 8 * st, ((s / K::XSTAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full_x + 8 * st, K::WIN_BYTES);
        tma_load_3d(win0 + st * K::WIN_BYTES, &tx, full_x + 8 * st,
                    s * K::KC, xrow, b);
      };
      load_window(0);
      int it = 0;
      for (int s = 0; s < chunks; ++s) {
        if (s + 1 < chunks) load_window(s + 1);
        for (int conv = 0; conv < 2; ++conv) {
          const CUtensorMap* map = conv == 0 ? &tn : &tw;
          for (int t = 0; t < kTaps; ++t, ++it) {
            const int st = it % K::WSTAGES;
            mbar_wait(empty_w + 8 * st, ((it / K::WSTAGES) & 1) ^ 1);
            mbar_arrive_expect_tx(full_w + 8 * st, K::W_BYTES);
            const uint32_t dst = w0 + st * K::W_BYTES;
            const int krow = t * C + s * K::KC;
            tma_load_2d(dst, map, full_w + 8 * st, c0, krow);
            tma_load_2d(dst + K::BOX_BYTES, map, full_w + 8 * st, c0 + 64,
                        krow);
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroups: rows [64*wg, 64*wg + 64) of the tile.
  setmaxnreg_inc<232>();
  const int ct = threadIdx.x - 128;
  const int lane = ct % 32, warp = ct / 32;  // warp 0..7, 16 rows each
  const int g = lane / 4, q = lane % 4;
  const int rows0 = warp * 16;              // tile row of the warp's row 0
  const int lrow = rows0 + (lane & 15);     // the row this lane addresses
  const int lcol = lane >> 4;               // k 0-7 or 8-15 of a k-step
  const int wd = p.wide_dilation;

  // Keep bits of the two fragment rows (g, g+8): bit 2t + half for tap t.
  uint32_t keep[2] = {~0u, ~0u};
  if constexpr (SEG) {
#pragma unroll
    for (int conv = 0; conv < 2; ++conv) {
      const int d = conv == 0 ? 1 : wd;
      uint32_t bits = 0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = rows0 + g + 8 * half;
        const int id = segc[m];
        if (id < 1 || id > p.S) continue;
        for (int t = 0; t < kTaps; ++t)
          if (segc[m + (t - kCenter) * d] == id) bits |= 1u << (2 * t + half);
      }
      keep[conv] = bits;
    }
  }

  float acc_n[64], acc_w[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_n[i] = acc_w[i] = 0.f;
  int it = 0;
  for (int s = 0; s < chunks; ++s) {
    const int st = s % K::XSTAGES;
    mbar_wait(full_x + 8 * st, (s / K::XSTAGES) & 1);
    const uint32_t win = win0 + st * K::WIN_BYTES;
    wg_conv_taps<SEG>(acc_n, win, lrow, lcol, 1, keep[0], w0, full_w,
                      empty_w, it, lane);
    wg_conv_taps<SEG>(acc_w, win, lrow, lcol, wd, keep[1], w0, full_w,
                      empty_w, it, lane);
    // Every ldmatrix of this chunk has returned: release its window slice.
    if (lane == 0) mbar_arrive(empty_x + 8 * st);
  }
  wgmma_wait<0>();
  fence_regs(acc_n);
  fence_regs(acc_w);

  // Epilogue: h = ((gelu_n + gelu_w) + x) + bcast, each thread's fragment
  // (rows g, g+8; columns 8j + 2q, +1) straight from the accumulators.
  const __nv_bfloat16* xb = p.x + (size_t(b) * (L + 2 * H) + H) * C;
  float* hb = h + size_t(b) * L * C;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = rows0 + g + 8 * half;
    const int l = l0 + m;
    if (l >= L) continue;
    const __nv_bfloat16* bc;
    if constexpr (SEG) {
      const int id = segc[m];
      bc = (id >= 1 && id <= p.S) ? p.bcast + (size_t(b) * p.S + id - 1) * C
                                  : nullptr;
    } else {
      bc = p.bcast + size_t(b) * C;
    }
    const __nv_bfloat16* xr = xb + size_t(l) * C;
    float* hr = hb + size_t(l) * C;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j + 2 * q;
      const int i = 4 * j + 2 * half;
      const __nv_bfloat162 xv =
          *reinterpret_cast<const __nv_bfloat162*>(xr + c);
      const float bc0 = bc ? to_f(bc[c]) : 0.f;
      const float bc1 = bc ? to_f(bc[c + 1]) : 0.f;
      const float h0 = ((gelu_tanh(acc_n[i] + p.nb[c]) +
                         gelu_tanh(acc_w[i] + p.wb[c])) +
                        __low2float(xv)) +
                       bc0;
      const float h1 = ((gelu_tanh(acc_n[i + 1] + p.nb[c + 1]) +
                         gelu_tanh(acc_w[i + 1] + p.wb[c + 1])) +
                        __high2float(xv)) +
                       bc1;
      *reinterpret_cast<float2*>(hr + c) = make_float2(h0, h1);
    }
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

// One warp's LayerNorm of one float32 row over C (C % 128 == 0, C <= 2048;
// float32 statistics, the biased variance): the row is read once, as one
// float4 per lane per 128 columns held in registers, then emit(c, y[4]) for
// columns c .. c+3 of each lane's float4s.
template <typename F>
__device__ __forceinline__ void ln_row(const float* row, int C,
                                       const float* scale, const float* bias,
                                       int lane, F emit) {
  constexpr int kMax = 2048 / 128;
  const int n = C / 128;
  float4 v[kMax];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    if (i < n) {
      v[i] = *reinterpret_cast<const float4*>(row + 128 * i + 4 * lane);
      s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    }
  }
  const float mean = warp_sum(s) / C;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    if (i < n) {
      const float a = v[i].x - mean, b = v[i].y - mean, c = v[i].z - mean,
                  d = v[i].w - mean;
      var += (a * a + b * b) + (c * c + d * d);
    }
  }
  const float rstd = rsqrtf(warp_sum(var) / C + 1e-5f);
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    if (i < n) {
      const int c = 128 * i + 4 * lane;
      const float y[4] = {(v[i].x - mean) * rstd * scale[c] + bias[c],
                          (v[i].y - mean) * rstd * scale[c + 1] + bias[c + 1],
                          (v[i].z - mean) * rstd * scale[c + 2] + bias[c + 2],
                          (v[i].w - mean) * rstd * scale[c + 3] + bias[c + 3]};
      emit(c, y);
    }
  }
}

// Four bf16 of y as one 8-byte store at p.
__device__ __forceinline__ void store_bf16x4(void* p, const float (&y)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Byte offset of x1[m, c] in the finish pass's shared x1: chunk c/64 of
// (rows, 64), row m at 128 bytes a row, its 16-byte chunks swizzled as TMA's
// 128-byte swizzle would place them (conflict-free ldmatrix).
__device__ __forceinline__ uint32_t x1_offset(int m, int c, int rows) {
  return uint32_t(c >> 6) * rows * 128u + m * 128u +
         ((((c >> 3) ^ m) & 7) << 4) + (c & 7) * 2u;
}

// bf16 pass 2: rows l0 .. l0+fm-1 of batch row b. LN1 of the scratch rows
// into x1 (bf16, shared memory); h2 = x1 + gelu(x1 @ Wd + db) on the tensor
// cores, (64, 256) Wd tiles streaming by TMA through a three-stage ring, each
// consumer warpgroup 128 of the 256 columns, h2 back into the scratch rows;
// then LN2 to the output. td maps Wd as (C_out, C_in). With fm = 32 (C >
// 1024) the products still run m64, rows 32-63 zero.
__global__ void __launch_bounds__(WgFinish::THREADS, 1)
    wgmma_finish_kernel(TrackArgs<__nv_bfloat16> p, int C,
                        float* __restrict__ h,
                        const __grid_constant__ CUtensorMap td) {
  using K = WgFinish;
  using namespace sm90;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* x1 = smem_raw + (base - raw);
  const uint32_t w0 = base + K::x1_bytes(C);
  const uint32_t full = w0 + K::STAGES * K::W_BYTES;
  const uint32_t empty = full + 8 * K::STAGES;

  const int fm = K::rows(C);
  const int l0 = blockIdx.x * fm, b = blockIdx.y;
  const int L = p.L;
  const int rows = min(fm, L - l0);
  float* hb = h + (size_t(b) * L + l0) * C;
  const int kchunks = C / K::KC;
  const int rounds = (C + K::NC - 1) / K::NC;
  const int tiles = rounds * kchunks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Tile i of the ring: k-chunk i % kchunks of round i / kchunks, the
  // 256 columns of both consumer warpgroups (128 at a ragged last round).
  auto load_tile = [&](int i) {
    const int st = i % K::STAGES;
    const int n0 = (i / kchunks) * K::NC, k0 = (i % kchunks) * K::KC;
    const int boxes = min(4, (C - n0) / 64);
    mbar_wait(empty + 8 * st, ((i / K::STAGES) & 1) ^ 1);
    mbar_arrive_expect_tx(full + 8 * st, boxes * K::BOX_BYTES);
    for (int j = 0; j < boxes; ++j)
      tma_load_2d(w0 + st * K::W_BYTES + j * K::BOX_BYTES, &td, full + 8 * st,
                  n0 + 64 * j, k0);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < K::STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, K::CONSUMER_WARPS);
    }
    mbar_fence_init();
    for (int i = 0; i < min(K::STAGES, tiles); ++i) load_tile(i);
  }

  // x1 = LN1(h), rounded to bf16 (fused_block.py:517); rows past L are zero.
  for (int m = warp; m < fm; m += K::THREADS / 32) {
    if (m < rows) {
      ln_row(hb + size_t(m) * C, C, p.s1, p.b1, lane,
             [&](int c, const float(&y)[4]) {
               store_bf16x4(x1 + x1_offset(m, c, fm), y);
             });
    } else {
      const float zero[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 4 * lane; c < C; c += 128)
        store_bf16x4(x1 + x1_offset(m, c, fm), zero);
    }
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    if (threadIdx.x == 0)
      for (int i = K::STAGES; i < tiles; ++i) load_tile(i);
    return;
  }

  // Consumers: warpgroup wg takes columns [n0 + 128 wg, +128) of each
  // round; both hold the same rows (warp w % 4 its 16 of the 64).
  const int ct = threadIdx.x - 128;
  const int wg = ct / 128, wrow = (ct / 32) % 4 * 16;
  const int g = lane / 4, q = lane % 4;
  const int arow = wrow + (lane & 15), lcol = lane >> 4;
  const bool real_rows = wrow < fm;
  const uint32_t x1s = base;
  int it = 0;
  for (int r = 0; r < rounds; ++r) {
    const int n0 = r * K::NC + 128 * wg;
    const bool active = n0 < C;  // uniform over the warpgroup
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < kchunks; ++kc, ++it) {
      const int st = it % K::STAGES;
      mbar_wait(full + 8 * st, (it / K::STAGES) & 1);
      if (active) {
        uint32_t a[4][4];
        const uint32_t row = x1s + uint32_t(kc) * fm * 128u + arow * 128u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (real_rows) {
            ldmatrix_x4(row + ((((2 * k + lcol) ^ arow) & 7) << 4), a[k]);
          } else {
            a[k][0] = a[k][1] = a[k][2] = a[k][3] = 0u;
          }
        }
        wgmma_fence();
        const uint64_t desc =
            desc_sw128(w0 + st * K::W_BYTES + wg * 2 * K::BOX_BYTES,
                       K::BOX_BYTES, 8 * K::ROW_BYTES);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_m64n128k16_rs(acc, a[k], desc + ((k * K::KSTEP_BYTES) >> 4));
        wgmma_commit();
        wgmma_wait<0>();
      }
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
    if (!active) continue;
    fence_regs(acc);
    // h2 = x1 + gelu(acc + db) into the scratch rows (h is no longer read:
    // x1 holds LN1's output).
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = wrow + g + 8 * half;
      if (m >= rows) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = n0 + 8 * j + 2 * q;
        const int i = 4 * j + 2 * half;
        const __nv_bfloat162 xv =
            *reinterpret_cast<const __nv_bfloat162*>(x1 + x1_offset(m, c, fm));
        *reinterpret_cast<float2*>(hb + size_t(m) * C + c) = make_float2(
            __low2float(xv) + gelu_tanh(acc[i] + p.db[c]),
            __high2float(xv) + gelu_tanh(acc[i + 1] + p.db[c + 1]));
      }
    }
  }

  // y = LN2(h2) → out rows inside [0, L), once every consumer wrote its h2.
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  __nv_bfloat16* ob = p.out + (size_t(b) * L + l0) * C;
  for (int m = ct / 32; m < rows; m += K::CONSUMER_WARPS)
    ln_row(hb + size_t(m) * C, C, p.s2, p.b2, lane,
           [&](int c, const float(&y)[4]) {
             store_bf16x4(ob + size_t(m) * C + c, y);
           });
}

// The bf16 conv pass: tensor maps over x and both conv weights, then the
// launch. The maps fail to encode (cudaErrorInvalidValue) for an operand
// whose base is not 16-byte aligned.
template <bool SEG>
cudaError_t launch_wgmma_conv(const TrackArgs<__nv_bfloat16>& p, int B,
                              int C, float* h, cudaStream_t stream) {
  using K = WgConv;
  const uint64_t rows = uint64_t(p.L) + 2 * p.halo;
  const uint64_t row_bytes = uint64_t(C) * 2;
  const uint64_t x_dims[3] = {uint64_t(C), rows, uint64_t(B)};
  const uint64_t x_strides[2] = {row_bytes, rows * row_bytes};
  const uint32_t x_box[3] = {K::KC, K::WIN, 1};
  const uint64_t w_dims[2] = {uint64_t(C), uint64_t(kTaps) * C};
  const uint64_t w_strides[1] = {row_bytes};
  const uint32_t w_box[2] = {64, K::KC};
  CUtensorMap tx, tn, tw;
  if (!sm90::encode_bf16_map(&tx, p.x, 3, x_dims, x_strides, x_box) ||
      !sm90::encode_bf16_map(&tn, p.nk, 2, w_dims, w_strides, w_box) ||
      !sm90::encode_bf16_map(&tw, p.wk, 2, w_dims, w_strides, w_box))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_conv_kernel<SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(K::total));
  if (e != cudaSuccess) return e;
  // Row tiles and batch rows of one channel tile run side by side, so the
  // resident blocks share few channel tiles' weights in L2.
  dim3 grid((p.L + K::TM - 1) / K::TM, B, C / K::TN);
  wgmma_conv_kernel<SEG><<<grid, K::THREADS, K::total, stream>>>(p, C, h, tx,
                                                                 tn, tw);
  return cudaGetLastError();
}

// The bf16 finish pass: a tensor map over Wd, then the launch.
inline cudaError_t launch_wgmma_finish(const TrackArgs<__nv_bfloat16>& p,
                                       int B, int C, float* h,
                                       cudaStream_t stream) {
  using K = WgFinish;
  const uint64_t dims[2] = {uint64_t(C), uint64_t(C)};
  const uint64_t strides[1] = {uint64_t(C) * 2};
  const uint32_t box[2] = {64, K::KC};
  CUtensorMap td;
  if (!sm90::encode_bf16_map(&td, p.dk, 2, dims, strides, box))
    return cudaErrorInvalidValue;
  const size_t smem = K::total(C);
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return e;
  const int fm = K::rows(C);
  dim3 grid((p.L + fm - 1) / fm, B);
  wgmma_finish_kernel<<<grid, K::THREADS, smem, stream>>>(p, C, h, td);
  return cudaGetLastError();
}

// Both passes: wgmma + TMA in bf16, the CUDA-core plan in float32.
template <typename T, bool SEG>
cudaError_t launch_tiled(const TrackArgs<T>& p, int B, int C, float* h,
                         cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    cudaError_t e = launch_wgmma_conv<SEG>(p, B, C, h, stream);
    if (e != cudaSuccess) return e;
    return launch_wgmma_finish(p, B, C, h, stream);
  } else {
    using Cfg = TiledCfg<T>;
    const size_t conv_smem = ConvSmem<T, SEG>::total;
    const size_t finish_smem = FinishSmem<T>::total(C);
    if (finish_smem > 232448) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        tiled_conv_kernel<T, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(conv_smem));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(tiled_finish_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(finish_smem));
    if (e != cudaSuccess) return e;
    dim3 conv_grid(C / Cfg::TC, (p.L + Cfg::TL - 1) / Cfg::TL, B);
    tiled_conv_kernel<T, SEG><<<conv_grid, kThreads, conv_smem, stream>>>(
        p, C, h);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dim3 finish_grid((p.L + Cfg::FL - 1) / Cfg::FL, B);
    tiled_finish_kernel<T><<<finish_grid, kThreads, finish_smem, stream>>>(
        p, C, h);
    return cudaGetLastError();
  }
}

// Host-side checks both entries share.
inline bool tiled_geometry_ok(int B, int L, int C, int S, int wide_dilation) {
  return track_geometry_ok(B, L, S, wide_dilation) && C % 128 == 0 &&
         C > 512 && C <= 2048 && B <= 65535;
}

}  // namespace pbt
