// The bf16 local track of one ProteinBERT block for Hopper (sm_90a): a conv
// pass and a finish pass on the tensor cores through `wgmma`, fed by TMA
// (hopper.cuh), at every width the port runs (C a multiple of 128, C <=
// 2048). The device code of the bf16 legs of K1 (local_track.cu), its
// prehaloed entry (local_track_valid.cu), #3 (local_track_segments.cu) and
// its int8 leg (local_track_segments_q8.cu) at C in {128, 256, 512}, and of
// #2, #2's prehaloed entry and #4 at 512 < C <= 2048
// (local_track_tiled.cuh); #6's bf16 legs (one_pass_sm90.cuh) run the conv
// pass on 64-row tiles (`WgConvT<64>`) and the finish pass. They replace
// the TPU kernels
// proteinbert_tpu/kernels/fused_block.py `_fused_kernel` (:526, launched at
// :804; prehaloed through `_pallas_forward(prehaloed=True)`, :741-758),
// `_fused_segment_kernel` (:977, launched at :1134; int8 branch :983-998),
// `_fused_kernel_tiled` (:881) and `_fused_segment_kernel_tiled` (:1220).
// Per position l:
//
//   h  = x + gelu(conv9,d=1(x) + nb) + gelu(conv9,d=D(x) + wb) + bcast
//   x1 = LN1(h)                      (rounded to bf16)
//   y  = LN2(x1 + gelu(x1 @ Wd + db))
//
// with the rounding points of `_finish_row` (fused_block.py:514-523): the
// tap products and both conv outputs stay float32, x1 is rounded before the
// dense, LN statistics are float32 with the biased variance. The float32
// sum h is taken in the order of the TPU kernel each entry replaces
// (`SumOrder`): K1's and #3's ((x + gelu_n) + gelu_w) + bcast
// (fused_block.py:547, :1017), or the tiled kernels' ((gelu_n + gelu_w) +
// x) + bcast (:604-618, :662-681).
//
// SEG = true (#3, #4; the masks of `_fused_segment_kernel`): seg (B, L)
// holds 0 at pad and 1..S for the packed proteins (an id above S counts as
// pad). Tap t of row l contributes only when seg[l + (t-4)d] == seg[l] and
// seg[l] is in 1..S; rows outside [0, L) are pad. bcast is (B, S, C) and
// each position adds its own segment's row, exactly 0.0 at pad. Pad
// positions still run both convs (bias only) and both LNs, as the TPU
// kernels do.
//
// What bounds it on the H100: operations, 2*B*L*C^2*19 FLOP — 40.8 GFLOP
// at B=8, L=C=512 (0.0413 ms at 989 TFLOP/s bf16), 326 GFLOP at B=8,
// L=C=1024 (0.330 ms) — against 4-70 MB of activation and weight bytes
// (0.002-0.021 ms at 3.35 TB/s). The segment gather is an index, not FLOPs.
// What the design adds is L2 -> SM traffic: every conv block reads its
// 128 output channels' slice of both convs (9 x C x 128 x 2, 2.36 MB at
// C = 512) and every finish block all of Wd (0.5 MB at C = 512), so a call
// at B=8, L=C=512 moves ~0.30 GB (conv) + ~0.07 GB (finish) from L2, about
// 0.065 ms at the ~5.8 TB/s #2's conv pass reaches (PERF.md); at L=C=1024
// 2.4 GB + 0.26 GB.
//
// Design. A Hopper block cannot carry scratch across blocks, and the LNs
// reduce over all C, so the layer runs as TWO launches that meet in a
// float32 (B, L, C) scratch the wrapper allocates: a conv pass per (row
// tile, batch row, 128 output channels), then a finish pass per (row tile,
// batch row) over all C. Rows past L in a tile are computed on zero fill
// and never written, so any L works. The one C call of an entry encodes
// the tensor maps and launches both passes (the int8 leg: three), so the
// host pays one ctypes call a layer. The other plan at C <= 512,
// local_track.cuh's `track_tile` (one 256-thread block per 32-row tile
// streaming all 19*C^2 weights through a cp.async double buffer into WMMA,
// a block barrier per 32-channel step; #6 and the float32 legs run it),
// moves 1.28 GB from L2 a bf16 call at the base width and reaches 8% of
// the bound (PERF.md).
//
// Conv pass (`wgmma_conv_kernel`): an implicit GEMM over K = (64-channel
// chunk, tap) on the tensor cores, both convs at once.
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
//   * The segment mask lives in registers: each thread's two fragment rows
//     get one keep bit per (conv, tap), computed once from the window's ids
//     in shared memory; a masked row's A registers are zeroed after
//     ldmatrix, so a cross-segment term is an exact 0 product, with no
//     staging tile and no barrier per tap (`track_tile` copies masked
//     rows into a staging tile behind one more barrier a step). The
//     epilogue gathers row seg[l]-1 of the (S, C) broadcast (the TPU
//     kernel's one-hot product has one nonzero term, so an index is the
//     same function).
//   * The narrow conv's result stays in registers while the wide conv
//     accumulates; the epilogue writes h once, in its entry's order, with
//     no read-back.
//   The grid walks row tiles and batch rows of one channel tile first, so
//   the blocks resident at once share few channel tiles' weights in L2 and
//   HBM reads each weight about once. At B=8, L=C=512 the grid is 4 x 8 x
//   4 = 128 blocks, one wave on the 132 SMs. A cluster of two row tiles
//   multicasting each weight tile would halve the L2 traffic, but measured
//   3.2x slower on the H100 (PERF.md), so blocks stand alone. The consumers
//   sit at the 168 registers of a 384-thread block: anything added to their
//   loop spills and ptxas serialises the products.
// Finish pass (`wgmma_finish_kernel`), one block per (32 or 64 rows, batch
// row) over all C:
//   * LN1 of the scratch rows into x1 (bf16) in shared memory, laid out in
//     64-channel chunks with the 128-byte swizzle, while the producer's
//     first Wd tiles are in flight;
//   * h2 = x1 + gelu(x1 @ Wd + db): x1's A fragments by ldmatrix, Wd
//     (C_in, C_out) as (64, 256) tiles through a three-stage TMA ring,
//     each consumer warpgroup one m64n128 accumulator over 128 of the 256
//     columns; h2 goes back into the scratch rows (LN1 has read them);
//   * LN2 of those rows to the output. Each LN reads its row once, as
//     float4s held in registers; at C <= 512 a warp loads four rows before
//     it reduces any, so their L2 latencies overlap. LN and the dense are
//     per position, so this pass needs no segment ids.
// The int8 leg (#3-int8) runs a dequantize pass first
// (`dequant_track_kernel`): the int8 conv and dense weights with their
// float32 scales become per-call bf16 scratches, each value from_f(q *
// scale) as common.cuh `Q8Tile` converts it — the values the
// floating-point leg loads from the dequantized weights — then the
// floating-point leg's two passes run on them, so the int8 leg is bit for
// bit the floating-point leg. The pass converts each weight once a call
// (19*C^2 values; 10 MB of bf16 written at C = 512), where `track_tile`'s
// int8 leg converts every weight once per row tile; no dequantized copy
// stays resident.
// float32 keeps the CUDA-core plans (local_track.cuh `track_tile` at C <=
// 512, local_track_tiled.cuh's kernels above): the tensor cores have no
// exact float32 mode (TF32 keeps 10 mantissa bits), and the float32 gates
// and reference steps hold the kernels to 1e-4.
#pragma once

#include "hopper.cuh"
#include "local_track.cuh"

namespace pbt {

using bf16 = __nv_bfloat16;

// The order of h's float32 sum: K1's and #3's ((x + gelu_n) + gelu_w) +
// bcast (fused_block.py:547, :1017), or the tiled kernels' ((gelu_n +
// gelu_w) + x) + bcast (:604-618, :662-681).
enum class SumOrder { kK1, kTiled };

// The bf16 conv pass: tile, rings and shared-memory layout, at TM_ output
// rows a block: 128 (two consumer warpgroups, K1, #3, #2, #4) or 64 (one;
// #6 at C = 128 may take it, one_pass_sm90.cuh).
template <int TM_>
struct WgConvT {
  static constexpr int TM = TM_;  // output rows: one consumer WG each 64
  static constexpr int TN = 128;  // output channels
  static constexpr int KC = 64;   // input channels a chunk: one 128-byte row
  static constexpr int WIN = TM + 2 * kHalo;
  static constexpr int XSTAGES = 3, WSTAGES = 8;
  static constexpr int THREADS = 128 + 2 * TM;  // producer WG + consumers
  static constexpr int CONSUMER_WARPS = TM / 16;
  static constexpr uint32_t ROW_BYTES = KC * 2;
  static constexpr uint32_t WIN_BYTES = WIN * ROW_BYTES;  // 21504 at TM 128
  static constexpr uint32_t BOX_BYTES = KC * 64 * 2;      // 64 x 64 box
  static constexpr uint32_t W_BYTES = 2 * BOX_BYTES;      // (64, 128) tile
  static constexpr uint32_t KSTEP_BYTES = 16 * ROW_BYTES; // 16 K rows
  static constexpr size_t win_off = 0;
  static constexpr size_t w_off = win_off + XSTAGES * WIN_BYTES;
  static constexpr size_t ids_off = w_off + WSTAGES * size_t(W_BYTES);
  static constexpr size_t bar_off = ids_off + align128(WIN * sizeof(int));
  static constexpr size_t total =
      bar_off + 2 * (XSTAGES + WSTAGES) * 8 + 1024;  // + alignment slack
  static_assert(TM == 64 || TM == 128, "one or two consumer warpgroups");
  static_assert(WIN_BYTES % 1024 == 0 && W_BYTES % 1024 == 0,
                "swizzled tiles start on 1024-byte boundaries");
  static_assert(WIN <= 256, "one TMA box");
  static_assert(total <= 232448, "fits one block's shared memory");
};
using WgConv = WgConvT<128>;

// The bf16 finish pass: rows a block, the Wd ring of (64, 256) tiles, and
// shared-memory layout. 64 rows at 512 < C <= 1024; 32 above C = 1024, so
// x1 fits, and at C <= 512, so a base-width call (B=8, L=512) has 128
// blocks for the 132 SMs rather than 64 (the pass does little arithmetic,
// 2*B*L*C^2 FLOP: its time is the latency of its LNs and its Wd stream,
// which more blocks hide better).
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
    return C > 512 && C <= 1024 ? 64 : 32;
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
                  WgFinish::total(1024) <= 232448 &&
                  WgFinish::total(640) <= 232448 &&
                  WgFinish::total(512) <= 232448,
              "fits one block's shared memory");

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

// Pass 1: h[b, l0 : l0+128, c0 : c0+128] of the float32 scratch, on the
// tensor cores (the design note above), h summed in ORDER. tx maps x as (C,
// L + 2H, B); tn and tw map the narrow and wide conv weights as (C_out, 9 *
// C_in).
template <bool SEG, SumOrder ORDER, int TM = 128>
__global__ void __launch_bounds__(WgConvT<TM>::THREADS, 1)
    wgmma_conv_kernel(TrackArgs<__nv_bfloat16> p, int C,
                      float* __restrict__ h,
                      const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tn,
                      const __grid_constant__ CUtensorMap tw) {
  using K = WgConvT<TM>;
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
    // Producer warpgroup: one thread keeps the TMA loads in flight. (At 256
    // threads every thread has registers enough: no reallocation.)
    if constexpr (K::THREADS == 384) setmaxnreg_dec<40>();
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
  if constexpr (K::THREADS == 384) setmaxnreg_inc<232>();
  const int ct = threadIdx.x - 128;
  const int lane = ct % 32, warp = ct / 32;  // 16 rows a warp
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

  // Epilogue: h in ORDER, each thread's fragment (rows g, g+8; columns
  // 8j + 2q, +1) straight from the accumulators.
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
      const float gn0 = gelu_tanh(acc_n[i] + p.nb[c]);
      const float gn1 = gelu_tanh(acc_n[i + 1] + p.nb[c + 1]);
      const float gw0 = gelu_tanh(acc_w[i] + p.wb[c]);
      const float gw1 = gelu_tanh(acc_w[i + 1] + p.wb[c + 1]);
      float h0, h1;
      if constexpr (ORDER == SumOrder::kK1) {
        h0 = ((__low2float(xv) + gn0) + gw0) + bc0;
        h1 = ((__high2float(xv) + gn1) + gw1) + bc1;
      } else {
        h0 = ((gn0 + gw0) + __low2float(xv)) + bc0;
        h1 = ((gn1 + gw1) + __high2float(xv)) + bc1;
      }
      *reinterpret_cast<float2*>(hr + c) = make_float2(h0, h1);
    }
  }
}

// One warp's LayerNorm of float32 rows over C (C % 128 == 0, C <= 128 * N;
// float32 statistics, the biased variance): rows m0, m0 + step, ... of h
// (leading dimension C), up to R of them and those below mend. Each row is
// read once, as one float4 per lane per 128 columns held in registers, and
// all R rows' loads are issued before any row is reduced, so their L2
// latencies overlap; then emit(m, c, y[4]) for columns c .. c+3 of each
// lane's float4s. A row's arithmetic does not depend on R.
template <int N, int R, typename F>
__device__ __forceinline__ void ln_rows(const float* h, int m0, int step,
                                        int mend, int C, const float* scale,
                                        const float* bias, int lane, F emit) {
  const int n = C / 128;
  float4 v[R][N];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int m = m0 + r * step;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (m < mend && i < n)
        v[r][i] = *reinterpret_cast<const float4*>(h + size_t(m) * C +
                                                   128 * i + 4 * lane);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int m = m0 + r * step;
    if (m >= mend) break;  // uniform over the warp
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < n) s += (v[r][i].x + v[r][i].y) + (v[r][i].z + v[r][i].w);
    const float mean = warp_sum(s) / C;
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < n) {
        const float a = v[r][i].x - mean, b = v[r][i].y - mean,
                    c = v[r][i].z - mean, d = v[r][i].w - mean;
        var += (a * a + b * b) + (c * c + d * d);
      }
    }
    const float rstd = rsqrtf(warp_sum(var) / C + 1e-5f);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < n) {
        const int c = 128 * i + 4 * lane;
        const float4 x = v[r][i];
        const float y[4] = {(x.x - mean) * rstd * scale[c] + bias[c],
                            (x.y - mean) * rstd * scale[c + 1] + bias[c + 1],
                            (x.z - mean) * rstd * scale[c + 2] + bias[c + 2],
                            (x.w - mean) * rstd * scale[c + 3] + bias[c + 3]};
        emit(m, c, y);
      }
    }
  }
}

// The LayerNorm of rows m0, m0 + step, ... below mend by one warp: four rows
// at once at C <= 512 (16 float4s a lane), one at a time above (up to 16
// float4s a row).
template <typename F>
__device__ __forceinline__ void ln_warp_rows(const float* h, int m0, int step,
                                             int mend, int C,
                                             const float* scale,
                                             const float* bias, int lane,
                                             F emit) {
  if (C <= 512) {
    for (int m = m0; m < mend; m += 4 * step)
      ln_rows<4, 4>(h, m, step, mend, C, scale, bias, lane, emit);
  } else {
    for (int m = m0; m < mend; m += step)
      ln_rows<16, 1>(h, m, step, mend, C, scale, bias, lane, emit);
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

// Pass 2: rows l0 .. l0+fm-1 of batch row b. LN1 of the scratch rows
// into x1 (bf16, shared memory); h2 = x1 + gelu(x1 @ Wd + db) on the tensor
// cores, (64, 256) Wd tiles streaming by TMA through a three-stage ring,
// each consumer warpgroup 128 of the 256 columns, h2 back into the scratch
// rows; then LN2 to the output. td maps Wd as (C_out, C_in). With fm = 32
// (C <= 512, C > 1024) the products still run m64, rows 32-63 zero.
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
  constexpr int nwarps = K::THREADS / 32;
  ln_warp_rows(hb, warp, nwarps, rows, C, p.s1, p.b1, lane,
               [&](int m, int c, const float(&y)[4]) {
                 store_bf16x4(x1 + x1_offset(m, c, fm), y);
               });
  for (int m = rows + warp; m < fm; m += nwarps) {
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 4 * lane; c < C; c += 128)
      store_bf16x4(x1 + x1_offset(m, c, fm), zero);
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
  ln_warp_rows(hb, ct / 32, K::CONSUMER_WARPS, rows, C, p.s2, p.b2, lane,
               [&](int m, int c, const float(&y)[4]) {
                 store_bf16x4(ob + size_t(m) * C + c, y);
               });
}

// The conv pass: tensor maps over x and both conv weights, then the launch.
// The maps fail to encode (cudaErrorInvalidValue) for an operand whose base
// is not 16-byte aligned.
template <bool SEG, SumOrder ORDER, int TM = 128>
cudaError_t launch_wgmma_conv(const TrackArgs<__nv_bfloat16>& p, int B,
                              int C, float* h, cudaStream_t stream) {
  using K = WgConvT<TM>;
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
      wgmma_conv_kernel<SEG, ORDER, TM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(K::total));
  if (e != cudaSuccess) return e;
  // Row tiles and batch rows of one channel tile run side by side, so the
  // resident blocks share few channel tiles' weights in L2.
  dim3 grid((p.L + K::TM - 1) / K::TM, B, C / K::TN);
  wgmma_conv_kernel<SEG, ORDER, TM>
      <<<grid, K::THREADS, K::total, stream>>>(p, C, h, tx, tn, tw);
  return cudaGetLastError();
}

// The finish pass: a tensor map over Wd, then the launch.
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

// Both passes of one bf16 call, h summed in ORDER.
template <bool SEG, SumOrder ORDER>
cudaError_t launch_track_sm90(const TrackArgs<bf16>& p, int B, int C,
                              float* h, cudaStream_t stream) {
  cudaError_t e = launch_wgmma_conv<SEG, ORDER>(p, B, C, h, stream);
  if (e != cudaSuccess) return e;
  return launch_wgmma_finish(p, B, C, h, stream);
}

// The shapes the bf16 plan covers: C a multiple of 128 up to 2048 (the TMA
// boxes are 64 channels, the conv tiles 128 output channels, the LN rows at
// most 2048 columns), B within a grid's y dimension.
inline bool sm90_shape_ok(int B, int C) {
  return C >= 128 && C % 128 == 0 && C <= 2048 && B <= 65535;
}

// The int8 leg's dequantize pass: nq, wq (9, C, C) int8 with scales ns, ws
// (9, C) and dq (C, C) with ds (C,) — one scale per (tap, output column) —
// into bf16 nk, wk, dk of the same shapes, each value from_f(q * scale) as
// `Q8Tile` converts it (two at a time, each rounded to nearest even as
// from_f rounds it alone): the floating-point leg's operand on the
// dequantized weights. A 16-value group is one 16-byte load of q, four of
// scales (q and the scales 16-byte aligned) and two 16-byte stores, all in
// registers, with 32-bit index arithmetic (19*C^2 < 2^32 for C <= 2048).
// Each thread converts kDequantGroups groups a grid-width apart, their
// loads all issued before the first conversion, so the pass runs in one
// wave at memory speed.
constexpr int kDequantGroups = 2;

struct DequantGroup {
  int4 raw;
  float4 sc[4];
  bf16* out;
};

// Block `block` of `blocks` (kThreads threads each) of the pass.
__device__ __forceinline__ void dequant_track_block(
    const int8_t* __restrict__ nq, const float* __restrict__ ns,
    const int8_t* __restrict__ wq, const float* __restrict__ ws,
    const int8_t* __restrict__ dq, const float* __restrict__ ds,
    bf16* __restrict__ nk, bf16* __restrict__ wk, bf16* __restrict__ dk,
    uint32_t C, uint32_t block, uint32_t blocks) {
  const uint32_t conv = kTaps * C * C / 16;  // 16-value groups a conv
  const uint32_t total = 2 * conv + C * C / 16;
  const uint32_t stride = blocks * kThreads;
  DequantGroup g[kDequantGroups];
#pragma unroll
  for (int k = 0; k < kDequantGroups; ++k) {
    const uint32_t i = block * kThreads + threadIdx.x + k * stride;
    g[k].out = nullptr;
    if (i >= total) continue;
    const uint32_t m = i < conv ? 0 : (i < 2 * conv ? 1 : 2);
    const int8_t* q = m == 0 ? nq : (m == 1 ? wq : dq);
    const float* s = m == 0 ? ns : (m == 1 ? ws : ds);
    const uint32_t e = (i - m * conv) * 16;  // first element
    const uint32_t row = e / C;              // tap * C + input channel
    const float4* sc =
        reinterpret_cast<const float4*>(s + (row / C) * C + (e - row * C));
    g[k].raw = __ldg(reinterpret_cast<const int4*>(q + e));
#pragma unroll
    for (int w = 0; w < 4; ++w) g[k].sc[w] = __ldg(sc + w);
    g[k].out = (m == 0 ? nk : (m == 1 ? wk : dk)) + e;
  }
#pragma unroll
  for (int k = 0; k < kDequantGroups; ++k) {
    if (g[k].out == nullptr) continue;
    const uint32_t words[4] = {uint32_t(g[k].raw.x), uint32_t(g[k].raw.y),
                               uint32_t(g[k].raw.z), uint32_t(g[k].raw.w)};
    uint32_t packed[8];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float fs[4] = {g[k].sc[w].x, g[k].sc[w].y, g[k].sc[w].z,
                           g[k].sc[w].w};
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = static_cast<float>(static_cast<int8_t>(words[w] >> (8 * j))) *
               fs[j];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat162 b =
            __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        packed[2 * w + j] = *reinterpret_cast<const uint32_t*>(&b);
      }
    }
    uint4* d = reinterpret_cast<uint4*>(g[k].out);
    d[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
    d[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
  }
}

// The blocks a dequantize pass over C takes: one wave, kDequantGroups
// 16-value groups a thread.
inline uint32_t dequant_track_blocks(int C) {
  const uint32_t groups = uint32_t(2 * kTaps + 1) * C * C / 16;
  const uint32_t per_block = kThreads * kDequantGroups;
  return (groups + per_block - 1) / per_block;
}

__global__ void __launch_bounds__(kThreads)
    dequant_track_kernel(const int8_t* __restrict__ nq,
                         const float* __restrict__ ns,
                         const int8_t* __restrict__ wq,
                         const float* __restrict__ ws,
                         const int8_t* __restrict__ dq,
                         const float* __restrict__ ds, bf16* __restrict__ nk,
                         bf16* __restrict__ wk, bf16* __restrict__ dk,
                         uint32_t C) {
  dequant_track_block(nq, ns, wq, ws, dq, ds, nk, wk, dk, C, blockIdx.x,
                      gridDim.x);
}

// q's operands with the dequantized weights nk, wk, dk in place of its int8
// ones: what the floating-point leg's passes take.
inline TrackArgs<bf16> dequantized_args(const TrackArgs<bf16, true>& q,
                                        bf16* nk, bf16* wk, bf16* dk) {
  return TrackArgs<bf16>{q.x,  q.seg, q.bcast, nk,    q.nb,
                         wk,   q.wb,  q.s1,    q.b1,  dk,
                         q.db, q.s2,  q.b2,    q.out, q.L,
                         q.S,  q.wide_dilation, nullptr, nullptr, nullptr,
                         q.halo};
}

// #3's int8 leg in bf16: the dequantize pass into the scratches nk, wk, dk,
// then #3's two passes on them.
inline cudaError_t launch_track_sm90_q8(const TrackArgs<bf16, true>& q,
                                        bf16* nk, bf16* wk, bf16* dk, int B,
                                        int C, float* h,
                                        cudaStream_t stream) {
  dequant_track_kernel<<<dequant_track_blocks(C), kThreads, 0, stream>>>(
      q.nk, q.nks, q.wk, q.wks, q.dk, q.dks, nk, wk, dk, uint32_t(C));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_track_sm90<true, SumOrder::kK1>(
      dequantized_args(q, nk, wk, dk), B, C, h, stream);
}

}  // namespace pbt
