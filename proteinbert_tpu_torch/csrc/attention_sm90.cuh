// K2 in bfloat16 for Hopper (sm_90a): the global attention of one
// ProteinBERT block as a query pass, one projection GEMM for all heads on
// `wgmma` fed by TMA, and a softmax / weighted-sum pass. The device code of
// both K2 entries (global_attention.cu, global_attention_q8.cu) in bf16,
// and of #6's query (with its mask ids), projection and softmax passes
// (one_pass_sm90.cuh); float32 keeps attention.cuh's CUDA-core plan
// (`attention_head`), as #2 and #4 keep theirs, because the tensor cores
// have no exact float32 mode.
//
// It computes what attention.cuh's header states, at the same rounding
// points (`_attention_body`, attention.py:195-228): with ids (B, L) holding
// the segment of each position (s + 1, anything else none),
//
//   q_h = round(tanh(round(g @ wq[h])))                 (S, k)
//   K_h = round(tanh(round(x @ wk[h])))                 (L, k)
//   V_h = round(gelu(round(x @ wv[h])))                 (L, v)
//   scores[s, l] = K_h[l] . q_h[s] / sqrt(k)            (float32)
//   w[s, :] = round(softmax over l of scores, -1e30 where ids[l] != s + 1)
//   out[s, h*v:(h+1)*v] = w[s] @ V_h (float32), 0 for an empty s (zero_empty)
//
// A position lies in at most one segment, so of the S x L scores only
// scores[ids[l] - 1, l] survives the mask: the passes form that one score
// a position, (B, H, L), and nothing they hold but q grows with S, which
// takes any value up to a grid's z extent (the softmax pass's grid).
//
// What bounds it on the H100: operations. The K and V projections are one
// GEMM, x (B*L, C) @ [wk | wv] (C, H*(k+v)): 2*B*L*C*H*(k+v) FLOP, 34.4
// GFLOP at B=8, L=C=1024, H=16, k=v=64 (0.035 ms at 989 TFLOP/s bf16), 4.3
// GFLOP at the base width (B=8, L=C=512, H=8). Its bytes (x once, the
// weights, the scratches below) take ~0.01 ms.
//
// Design. The parent ran one 256-thread block per (head, row) that read its
// row's x from L2 twice per head (a K pass and a V pass) through 64 x 64
// WMMA tiles with two barriers per 32-column step: latency-bound, 1-3% of
// the bound. Here the work is split where its shape changes:
//   1. query pass (`attn_query_kernel`), one block per (head, row, four
//      segments): 256 threads = k/8 groups of 8 output columns x 2048/k
//      parts of G, each a float32 FMA chain over independent 16-byte
//      weight loads, the parts summed in a fixed order; q goes to a
//      float32 scratch (B, S, H, k).
//   2. projection pass (`wgmma_attn_kernel`), persistent (one block per SM
//      walking tiles of 256 rows (at most 128 columns a product; else 128)
//      of one batch row x one head). A producer warp keeps a ring of four
//      or five TMA stages full: the x tile (64 channels x the tile's rows,
//      a 3-D map over (C, L, B) whose zero fill covers rows past L) and the
//      head's key and value tiles (64 channels x 64 columns each, 3-D maps
//      over (k or v, C, H), zero past C and past k or v, read MN-major as
//      the weights are stored, no repack). Two consumer warpgroups, 128
//      rows or 64 each, run m64nNk16 over N = pad64(k) + pad64(v) columns
//      (64 to 256; at v = 256 the key and value columns are two tiles of
//      one row tile, `WgAttn::SPLIT`) with both operands read by
//      descriptor from the stage (A K-major, B through the transpose bit),
//      so no register the products
//      read is written while they run and one chunk's products stay in
//      flight while the next chunk's are issued. The
//      epilogue works on the accumulators in registers: the key columns
//      become tanh'd K and each row is dotted with its own segment's q,
//      read from the q scratch through L1 (four lanes share a row: a fixed
//      two-step shuffle sum), written as a float32 score a position (B, H,
//      L); a row in no segment gets none. The value columns become gelu'd
//      V, written as bf16
//      (B, L, H*v), which is exact since V is rounded to bf16 anyway.
//      Every x tile crosses L2 once per head (the parent: twice per head).
//      What bounds this pass is L2 -> SM traffic: at B=8, L=C=1024, H=16
//      the tiles move ~0.40 GB a call (256-row tiles; 0.54 GB at 128 rows,
//      11% slower on the H100, PERF.md).
//   3. softmax pass (`attn_softmax_kernel`), one 512-thread block per
//      (head, row, segment), so even the dense S=1 call has B*H blocks of
//      16 warps to hide L2 latency: the segment's max and sum over L (one
//      block reduction each), the bf16-rounded weights written over its
//      own positions' scores (no other block's), then out = sum over l of
//      w[l] * V[l] in float32: each thread walks one group of rows for one
//      pair of V columns (the loads of successive rows independent), the
//      groups summed in a fixed order. The rows off the segment have weight
//      exactly 0 where it holds a position and are skipped: V's rows of
//      the segment are read once, from L2. Dense rows (S = 1) have one
//      block a row, which reads every position, its loads free of the ids
//      (skipping there measured slower on the H100, PERF.md). The
//      rounding of the normalised weights is why this is not flash
//      attention: a segment's max and sum over all of L must be known
//      before any weight is rounded, so the scores wait in their scratch.
// The mask value stays -1e30: an all-masked segment gets the uniform
// softmax (not the NaN of -inf), and zero_empty then writes +0.0.
//
// The int8 leg (Q8) runs a dequantize pass first (`dequant_kv_kernel`):
// wk and wv, int8 with float32 per-(head, column) scales, become bf16
// scratches from_f(q * scale), the values the floating-point leg loads from
// the dequantized weights; then passes 2 and 3 are the floating-point leg's
// launches on those scratches, and the query pass reads wq through
// weight_at<Q8>. So the int8 leg is bit for bit the floating-point leg. The
// scratches live for one call (1 MB at the base width, 4 MB at Large); no
// dequantized copy stays resident.
#pragma once

#include "attention.cuh"
#include "hopper.cuh"

namespace pbt {

using bf16 = __nv_bfloat16;

// Head widths on the card: key_dim kd and value_dim vd multiples of 8, kd
// up to 128 and vd up to 256 (attention.cuh `head_dims_ok`). The
// projection pass is instantiated per padded pair (KP, VP): kd and vd
// rounded up to whole 64-column TMA boxes. A box past the weights' last
// column is zero-filled by TMA, so a padded key column is tanh(0) = 0
// against a q column the consumers zero too (the scores' sums gain exact
// zeros), and a padded value column is computed and never written: six
// instantiations serve every pair, and kd, vd are run-time values
// everywhere else.
__host__ __device__ constexpr int pad64(int n) { return (n + 63) / 64 * 64; }

// The projection pass at padded widths (KP, VP): tile, ring and
// shared-memory layout. Where KP + VP fits one product (N <= 256 columns)
// a tile computes K and V at once; else (VP = 256) each row tile is two
// tiles, one of K (N = KP) and one of V (N = VP), the x tile loaded for
// each.
template <int KP, int VP>
struct WgAttn {
  static constexpr bool SPLIT = KP + VP > 256;
  static constexpr int KINDS = SPLIT ? 2 : 1;
  static constexpr int N0 = SPLIT ? KP : KP + VP;  // kind 0: K (then V)
  static constexpr int N1 = SPLIT ? VP : 0;        // kind 1: V alone
  static constexpr int NMAX = N0 > N1 ? N0 : N1;
  // m64 row blocks a consumer warpgroup: two at N <= 128 (the accumulators
  // then fill 128 registers), one above (at most 128).
  static constexpr int MT = NMAX <= 128 ? 2 : 1;
  static constexpr int TM = 128 * MT;   // rows a tile: two consumer WGs
  static constexpr int KC = 64;         // channels a chunk: one 128-byte row
  static constexpr int THREADS = 384;
  static constexpr int CONSUMER_WARPS = 8;
  static constexpr uint32_t ROW_BYTES = KC * 2;
  static constexpr uint32_t X_BYTES = TM * ROW_BYTES;
  static constexpr uint32_t BOX_BYTES = KC * 64 * 2;        // 64 x 64 box
  static constexpr uint32_t KSTEP_BYTES = 16 * ROW_BYTES;   // 16 K rows
  // A kind's weight boxes, LBO apart: the key boxes, then the value boxes.
  static constexpr uint32_t W_BYTES = uint32_t(NMAX / 64) * BOX_BYTES;
  static constexpr uint32_t STAGE = X_BYTES + W_BYTES;
  static constexpr int STAGES =
      (232448 - 2048) / int(STAGE) < 5 ? (232448 - 2048) / int(STAGE) : 5;
  static constexpr size_t TOTAL =
      STAGES * size_t(STAGE) + 2 * STAGES * 8 + 1024;  // + alignment slack
  static_assert(KP % 64 == 0 && VP % 64 == 0 && KP <= 128 && VP <= 256,
                "whole boxes");
  static_assert(X_BYTES % 1024 == 0 && BOX_BYTES % 1024 == 0,
                "swizzled tiles start on 1024-byte boundaries");
  static_assert(STAGES >= 3 && TOTAL <= 232448,
                "a ring of three stages fits one block's shared memory");
  static_assert(TM <= 256, "one TMA box of x rows");
};

// Eight consecutive wq values of one row as the activation type rounds
// them (weight_at's values): one 16-byte load of bf16, or 8 bytes of int8
// times the columns' scales `sc`.
template <bool Q8>
__device__ __forceinline__ void load8(const WeightT<bf16, Q8>* p,
                                      const float (&sc)[8], float (&v)[8]) {
  if constexpr (Q8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = round_to<bf16>(static_cast<float>(q[e]) * sc[e]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(b2[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  }
}

// Pass 1: q[b, s, h, :] for four segments s0 .. s0+3 of batch row b, one
// 256-thread block (K2's query pass, and #6's, whose blocks also write its
// mask ids: one_pass_sm90.cuh). Thread t sums 8 of the kd columns (8 * (t %
// (kd/8)) ..) over one of 256 / (kd/8) (rounded down) contiguous parts of G
// (t / (kd/8)), the loads of successive k independent; the parts are then
// summed in a fixed order. q is (B, S, H, kd).
template <bool Q8>
__device__ __forceinline__ void attn_query_block(
    const bf16* __restrict__ g, const AttnWeights<bf16, Q8>& w,
    float* __restrict__ qbuf, int S, int G, int H, int kd) {
  const int groups = kd / 8, parts = kThreads / groups;
  const int h = blockIdx.x, b = blockIdx.y, s0 = blockIdx.z * 4;
  // Threads past groups * parts (kd / 8 not a power of two) sum nothing.
  const int jg = threadIdx.x % groups, part = threadIdx.x / groups;
  const bool active = part < parts;
  const int ns = min(4, S - s0);
  const int kper = (G + parts - 1) / parts;
  const bf16* gb = g + (size_t(b) * S + s0) * G;
  float sc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    sc[e] = Q8 ? w.sq[size_t(h) * kd + 8 * jg + e] : 1.f;
  float acc[4][8];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[u][e] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < kper; ++kk) {
    const int k = part * kper + kk;
    if (!active || k >= G) break;
    float wv[8];
    load8<Q8>(w.wq + (size_t(h) * G + k) * kd + 8 * jg, sc, wv);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // Branch-free: a segment past ns repeats the last one (discarded).
      const float gv = to_f(gb[size_t(min(u, ns - 1)) * G + k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[u][e] = fmaf(gv, wv[e], acc[u][e]);
    }
  }
  // (parts, 4, kd) partial sums: at most 256 * 32 floats.
  __shared__ float red[kThreads * 32];
  if (active)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        red[(part * 4 + u) * kd + 8 * jg + e] = acc[u][e];
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * kd; i += kThreads) {
    const int u = i / kd, j = i - u * kd;
    if (u < ns) {
      float v = red[u * kd + j];
      for (int p = 1; p < parts; ++p) v += red[(p * 4 + u) * kd + j];
      qbuf[((size_t(b) * S + s0 + u) * H + h) * kd + j] =
          round_to<bf16>(tanhf(round_to<bf16>(v)));
    }
  }
}

template <bool Q8>
__global__ void __launch_bounds__(kThreads)
    attn_query_kernel(const bf16* __restrict__ g, AttnWeights<bf16, Q8> w,
                      float* __restrict__ qbuf, int S, int G, int H, int kd) {
  attn_query_block<Q8>(g, w, qbuf, S, G, H, kd);
}

// One 64-channel chunk of a consumer warpgroup's products over N columns,
// both operands read by descriptor from the stage: A its MT blocks of 64
// rows of the x tile from `xa` (K-major), B the weight boxes at `ws`
// (MN-major).
template <int MT, int N>
__device__ __forceinline__ void attn_chunk(float (&acc)[MT][N / 2],
                                           uint32_t xa, uint32_t ws) {
  constexpr uint32_t ROW_BYTES = 128, BOX_BYTES = 64 * 64 * 2;
  using namespace sm90;
  wgmma_fence();
  const uint64_t db = desc_sw128(ws, BOX_BYTES, 8 * ROW_BYTES);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const uint64_t da = desc_sw128(xa + m * 64 * ROW_BYTES, 16, 8 * ROW_BYTES);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_ss<N>(acc[m], da + ((k * 32) >> 4),
                  db + ((k * 16 * ROW_BYTES) >> 4));
  }
  wgmma_commit();
}

// The epilogue of one m64 accumulator over N columns: rows r0 and r0 + 8
// of each warp's 16 (r0 already offset to the tile's row in L). With HAS_K
// the first KP columns are K: each row's score against its own segment's
// q goes to sb (ib the row's ids: s + 1 for segment s; qb the row's q
// scratch (S, H, kd) at head h, read as zeros past kd); a row in no
// segment 1 .. S gets none. With HAS_V the next (or, without HAS_K, the
// first) columns are V, written into vbuf for the value columns below vd
// (row r0's V; row r0 + 8 is 8 rows of G further).
template <int KP, int N, bool HAS_K, bool HAS_V>
__device__ __forceinline__ void attn_epilogue(float (&acc)[N / 2],
                                              const float* qb, const int* ib,
                                              float* sb, bf16* vbuf, int r0,
                                              int L, int S, int H, int G,
                                              int q, int kd, int vd) {
  const int r1 = r0 + 8;
  if constexpr (HAS_K) {
    const float inv_scale = 1.0f / sqrtf(float(kd));
    // K = round(tanh(round(acc))) in place over the key columns.
#pragma unroll
    for (int i = 0; i < KP / 2; ++i)
      acc[i] = round_to<bf16>(tanhf(round_to<bf16>(acc[i])));
    const int i0 = r0 < L ? __ldg(ib + r0) : 0;
    const int i1 = r1 < L ? __ldg(ib + r1) : 0;
    const int id0 = i0 >= 1 && i0 <= S ? i0 : 0;  // 0: no segment
    const int id1 = i1 >= 1 && i1 <= S ? i1 : 0;
    const float* q0 = qb + size_t(id0 ? id0 - 1 : 0) * H * kd + 2 * q;
    const float* q1 = qb + size_t(id1 ? id1 - 1 : 0) * H * kd + 2 * q;
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int j = 0; j < KP / 8; ++j) {
      // kd is a multiple of 8: columns 8j .. 8j+7 are all in it or all past.
      const bool in = 8 * j < kd;
      const float2 a = in ? __ldg(reinterpret_cast<const float2*>(q0 + 8 * j))
                          : make_float2(0.f, 0.f);
      const float2 c = in ? __ldg(reinterpret_cast<const float2*>(q1 + 8 * j))
                          : make_float2(0.f, 0.f);
      p0 = fmaf(acc[4 * j], a.x, p0);
      p0 = fmaf(acc[4 * j + 1], a.y, p0);
      p1 = fmaf(acc[4 * j + 2], c.x, p1);
      p1 = fmaf(acc[4 * j + 3], c.y, p1);
    }
    p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
    p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
    if (q == 0) {
      if (id0 != 0) sb[r0] = p0 * inv_scale;
      if (id1 != 0) sb[r1] = p1 * inv_scale;
    }
  }
  if constexpr (HAS_V) {
    // V = round(gelu(round(acc))) over the value columns, as bf16.
    constexpr int V8 = HAS_K ? KP / 8 : 0;  // the first value column / 8
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int l = half ? r1 : r0;
      if (l >= L) continue;
      bf16* vr = vbuf + size_t(l) * G;
#pragma unroll
      for (int jj = 0; jj < N / 8 - V8; ++jj) {
        const int c = 8 * jj + 2 * q;
        if (c >= vd) break;  // vd is a multiple of 8: jj is past it
        const int i = 4 * (V8 + jj) + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(vr + c) =
            __floats2bfloat162_rn(gelu_tanh(round_to<bf16>(acc[i])),
                                  gelu_tanh(round_to<bf16>(acc[i + 1])));
      }
    }
  }
}

// One tile's products and epilogue for the consumer warpgroups: chunk kc
// waits for its stage and issues its products; then the previous chunk's
// products are done, so the previous stage is released.
template <int KP, int VP, int N, bool HAS_K, bool HAS_V>
__device__ __forceinline__ void attn_consume(
    int& it, uint32_t base, int chunks, const float* qb, const int* ib,
    float* sb, bf16* vb, int row0, int L, int S, int H, int G, int kd,
    int vd) {
  using K = WgAttn<KP, VP>;
  using namespace sm90;
  const uint32_t full = base + K::STAGES * K::STAGE;
  const uint32_t empty = full + 8 * K::STAGES;
  const int ct = threadIdx.x - 128;
  const int lane = ct % 32, warp = ct / 32, wg = warp / 4;
  const int g = lane / 4, q = lane % 4;
  const int wrow = wg * 64 * K::MT;  // the warpgroup's first tile row
  float acc[K::MT][N / 2];
#pragma unroll
  for (int m = 0; m < K::MT; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.f;
  for (int kc = 0; kc < chunks; ++kc, ++it) {
    const int st = it % K::STAGES;
    mbar_wait(full + 8 * st, (it / K::STAGES) & 1);
    const uint32_t xs = base + st * K::STAGE;
    attn_chunk<K::MT, N>(acc, xs + wrow * K::ROW_BYTES, xs + K::X_BYTES);
    wgmma_wait<1>();
    if (kc > 0 && lane == 0)
      mbar_arrive(empty + 8 * ((it + K::STAGES - 1) % K::STAGES));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < K::MT; ++m) fence_regs(acc[m]);
  if (lane == 0) mbar_arrive(empty + 8 * ((it + K::STAGES - 1) % K::STAGES));
#pragma unroll
  for (int m = 0; m < K::MT; ++m)
    attn_epilogue<KP, N, HAS_K, HAS_V>(
        acc[m], qb, ib, sb, vb, row0 + wrow + 64 * m + (warp % 4) * 16 + g,
        L, S, H, G, q, kd, vd);
}

// Pass 2: scores (B, H, L), one a position against its own segment's q
// (ids (B, L)), and V (B, L, H*vd) for every tile of TM rows of one batch
// row and one head (and, split, one kind). tx maps x as (C, L, B); tk and
// tv map wk and wv as (kd, C, H) and (vd, C, H), read in boxes of 64
// columns zero-filled past kd and vd.
template <int KP, int VP>
__global__ void __launch_bounds__(WgAttn<KP, VP>::THREADS, 1)
    wgmma_attn_kernel(const float* __restrict__ qbuf,
                      const int* __restrict__ ids,
                      float* __restrict__ scores, bf16* __restrict__ vbuf,
                      int B, int L, int C, int S, int H, int kd, int vd,
                      const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv) {
  using K = WgAttn<KP, VP>;
  using namespace sm90;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + K::STAGES * K::STAGE;
  const uint32_t empty = full + 8 * K::STAGES;

  const int rts = (L + K::TM - 1) / K::TM;
  const int tiles = rts * B * H * K::KINDS;
  const int chunks = (C + K::KC - 1) / K::KC;

  if (threadIdx.x == 0) {
    for (int i = 0; i < K::STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, K::CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Tile t: kind t % KINDS of row tile (t / KINDS) % rts of batch row
  // (t / (KINDS rts)) % B, head t / (KINDS rts B): the blocks resident at
  // once share one or two heads' weights, and a row tile's two kinds run
  // side by side.
  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the TMA loads in flight, across
    // tiles, so the next tile's loads overlap this tile's epilogue.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int kind = t % K::KINDS, u = t / K::KINDS;
        const int rt = u % rts, b = (u / rts) % B, h = u / (rts * B);
        const int kboxes = kind == 0 ? KP / 64 : 0;
        const int vboxes = (kind == 1 || !K::SPLIT) ? VP / 64 : 0;
        for (int kc = 0; kc < chunks; ++kc, ++it) {
          const int st = it % K::STAGES;
          mbar_wait(empty + 8 * st, ((it / K::STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(full + 8 * st,
                                K::X_BYTES + (kboxes + vboxes) * K::BOX_BYTES);
          const uint32_t dst = base + st * K::STAGE;
          tma_load_3d(dst, &tx, full + 8 * st, kc * K::KC, rt * K::TM, b);
          for (int j = 0; j < kboxes; ++j)
            tma_load_3d(dst + K::X_BYTES + j * K::BOX_BYTES, &tk,
                        full + 8 * st, 64 * j, kc * K::KC, h);
          for (int j = 0; j < vboxes; ++j)
            tma_load_3d(dst + K::X_BYTES + (kboxes + j) * K::BOX_BYTES, &tv,
                        full + 8 * st, 64 * j, kc * K::KC, h);
        }
      }
    }
    return;
  }

  // Consumer warpgroups: warpgroup wg owns tile rows 64 MT wg .. 64 MT
  // (wg + 1) - 1; warp w % 4 rows 16 (w % 4) .. of each 64-row block.
  setmaxnreg_inc<232>();
  const int G = H * vd;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int kind = t % K::KINDS, u = t / K::KINDS;
    const int rt = u % rts, b = (u / rts) % B, h = u / (rts * B);
    const float* qb = qbuf + (size_t(b) * S * H + h) * kd;
    const int* ib = ids + size_t(b) * L;
    float* sb = scores + (size_t(b) * H + h) * L;
    bf16* vb = vbuf + size_t(b) * L * G + h * vd;
    if constexpr (K::SPLIT) {
      if (kind == 0)
        attn_consume<KP, VP, K::N0, true, false>(it, base, chunks, qb, ib, sb,
                                                 vb, rt * K::TM, L, S, H, G,
                                                 kd, vd);
      else
        attn_consume<KP, VP, K::N1, false, true>(it, base, chunks, qb, ib, sb,
                                                 vb, rt * K::TM, L, S, H, G,
                                                 kd, vd);
    } else {
      attn_consume<KP, VP, K::N0, true, true>(it, base, chunks, qb, ib, sb,
                                              vb, rt * K::TM, L, S, H, G, kd,
                                              vd);
    }
  }
}

// Pass 3's block: 512 threads, one segment of one (head, batch row).
constexpr int kSoftThreads = 512;
constexpr int kSoftWarps = kSoftThreads / 32;

// A block-wide reduction (op: max or sum) of one value a thread; every
// thread gets the result. `red` holds kSoftWarps floats.
template <typename Op>
__device__ __forceinline__ float block_reduce(float x, float* red, Op op) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = op(x, __shfl_xor_sync(0xffffffffu, x, o));
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < kSoftWarps; ++w) x = op(x, red[w]);
  __syncthreads();
  return x;
}

// Pass 3: out[b, s, h*vd : (h+1)*vd] for segment s of batch row b, one
// block each, its weights written over the scores (B, H, L). With S > 1
// the blocks of a row share its scores: each position belongs to one
// segment, so a block reads and writes only its own segment's. ALONE (S =
// 1, dense rows): the block is the row's only one and reads and writes
// every position, its loads free of the ids.
template <bool ALONE>
__global__ void __launch_bounds__(kSoftThreads)
    attn_softmax_kernel(const int* __restrict__ ids, float* scores,
                        const bf16* __restrict__ vbuf, bf16* __restrict__ out,
                        int L, int S, int H, int vd, int zero_empty) {
  const int pairs = vd / 2;                   // column pairs of V
  const int groups = kSoftThreads / pairs;    // row groups
  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int G = H * vd;
  // Plain (coherent) loads and stores.
  float* sr = scores + (size_t(b) * H + h) * L;
  const int* ib = ids + size_t(b) * L;
  __shared__ float red[kSoftWarps];
  // (groups, vd) partial sums: at most 2 * kSoftThreads floats.
  __shared__ float part[2 * kSoftThreads];
  const auto fmax_op = [](float a, float c) { return fmaxf(a, c); };
  // Position l's masked score: -1e30 off the segment.
  const auto masked = [&](int l) {
    const bool in = ib[l] == s + 1;
    const float v = ALONE || in ? sr[l] : 0.f;
    return in ? v : -1e30f;
  };

  // The segment's max over l of its masked scores (every score is >= the
  // mask value), whether it holds any position, then its sum of exp(score
  // - max).
  float mx = -1e30f, any = 0.f;
  for (int l = threadIdx.x; l < L; l += kSoftThreads) {
    mx = fmaxf(mx, masked(l));
    any = fmaxf(any, ib[l] == s + 1 ? 1.f : 0.f);
  }
  mx = block_reduce(mx, red, fmax_op);
  any = block_reduce(any, red, fmax_op);
  float sum = 0.f;
  for (int l = threadIdx.x; l < L; l += kSoftThreads)
    sum += expf(masked(l) - mx);
  sum = block_reduce(sum, red, [](float a, float c) { return a + c; });
  // The weights, rounded to bf16 as the TPU kernel casts them, in place of
  // the scores (the barrier makes them visible to the whole block); `off`
  // is the weight off the segment: exactly 0 where it holds a position,
  // the uniform softmax's where it holds none.
  const float off = round_to<bf16>(expf(-1e30f - mx) / sum);
  for (int l = threadIdx.x; l < L; l += kSoftThreads)
    if (ALONE || ib[l] == s + 1)
      sr[l] = round_to<bf16>(expf(masked(l) - mx) / sum);
  __syncthreads();

  // out[j] = sum over l of w[l] * V[l, j] in float32: thread (row group r,
  // column pair c) sums rows r, r + groups, ... in order, then the groups
  // are summed in order. Alone, every row with its weight. Else a row off
  // a segment that holds a position adds 0 * V, an exact no-op (no sum is
  // ever -0.0), so it is skipped, and an empty segment adds `off` * V over
  // every row, unless zero_empty writes it 0. Threads past groups * pairs
  // (pairs not a power of two) sum nothing.
  const int c = threadIdx.x % pairs, r = threadIdx.x / pairs;
  if (r < groups) {
    float a0 = 0.f, a1 = 0.f;
    const bf16* vb = vbuf + size_t(b) * L * G + h * vd + 2 * c;
    const auto row = [&](int l, float wgt) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vb + size_t(l) * G));
      a0 = fmaf(wgt, v.x, a0);
      a1 = fmaf(wgt, v.y, a1);
    };
    if constexpr (ALONE) {
#pragma unroll 4
      for (int l = r; l < L; l += groups) row(l, sr[l]);
    } else if (any != 0.f) {
#pragma unroll 4
      for (int l = r; l < L; l += groups) {
        if (ib[l] != s + 1) continue;
        row(l, sr[l]);
      }
    } else if (!zero_empty) {
#pragma unroll 4
      for (int l = r; l < L; l += groups) row(l, off);
    }
    part[r * vd + 2 * c] = a0;
    part[r * vd + 2 * c + 1] = a1;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < vd; j += kSoftThreads) {
    float a = part[j];
    for (int q = 1; q < groups; ++q) a += part[q * vd + j];
    const float v = (zero_empty && any == 0.f) ? 0.f : a;
    out[(size_t(b) * S + s) * G + h * vd + j] = from_f<bf16>(v);
  }
}

// The int8 leg's dequantize pass: wk (H, C, kd) and wv (H, C, vd) int8
// with scales sk (H, kd), sv (H, vd) into bf16 (H, C, kd) and (H, C, vd),
// each value from_f(q * scale) — the floating-point leg's operand on the
// dequantized weights. 8 values (one 8-byte load, one 16-byte store; kd
// and vd are multiples of 8) a thread and step; this is block `block` of
// `blocks` (kThreads threads each).
__device__ __forceinline__ void dequant_kv_block(
    const int8_t* __restrict__ wk, const float* __restrict__ sk,
    const int8_t* __restrict__ wv, const float* __restrict__ sv,
    bf16* __restrict__ ok, bf16* __restrict__ ov, int H, int C, int kd,
    int vd, uint32_t block, uint32_t blocks) {
  const size_t nk = size_t(H) * C * kd / 8;
  const size_t nv = size_t(H) * C * vd / 8;
  for (size_t i = size_t(block) * kThreads + threadIdx.x; i < nk + nv;
       i += size_t(blocks) * kThreads) {
    const bool key = i < nk;
    const int n = key ? kd : vd;
    const size_t e = (key ? i : i - nk) * 8;   // first element
    const size_t row = e / n;                  // h * C + c
    const int col = int(e - row * n);
    const float* sc = (key ? sk : sv) + (row / C) * n + col;
    const int2 raw = *reinterpret_cast<const int2*>((key ? wk : wv) + e);
    const int8_t* qv = reinterpret_cast<const int8_t*>(&raw);
    __align__(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = from_f<bf16>(static_cast<float>(qv[j]) * sc[j]);
    *reinterpret_cast<uint4*>((key ? ok : ov) + e) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// The blocks the pass takes for H heads of (C, kd + vd): one 8-value
// group a thread, at most 4096 blocks.
inline uint32_t dequant_kv_blocks(int H, int C, int kd, int vd) {
  const size_t n8 = size_t(H) * C * (kd + vd) / 8;
  const size_t want = (n8 + kThreads - 1) / kThreads;
  return uint32_t(want < 4096 ? want : 4096);
}

__global__ void __launch_bounds__(kThreads)
    dequant_kv_kernel(const int8_t* __restrict__ wk,
                      const float* __restrict__ sk,
                      const int8_t* __restrict__ wv,
                      const float* __restrict__ sv, bf16* __restrict__ ok,
                      bf16* __restrict__ ov, int H, int C, int kd, int vd) {
  dequant_kv_block(wk, sk, wv, sv, ok, ov, H, C, kd, vd, blockIdx.x,
                   gridDim.x);
}

// Scratch the wrapper allocates for one call, as parts of one buffer
// (attention.py `attention_scratch_layout`): q (B, S, H, kd) and scores
// (B, H, L) float32, V (B, L, H*vd) bf16, and on the int8 leg the
// dequantized wk (H, C, kd) and wv (H, C, vd) bf16 (null on the
// floating-point leg). float32 takes q alone (the rest null).
struct AttnScratch {
  float* q;
  float* scores;
  bf16* v;
  bf16* wk;
  bf16* wv;
};

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// Pass 2 over x (B, L, C) bf16 with bf16 wk (H, C, kd), wv (H, C, vd) at
// the padded widths (KP, VP) and the ids (B, L) of the positions'
// segments: the scores and V of every head into sc. The
// maps fail to encode (cudaErrorInvalidValue) for an x, wk or wv whose
// base is not 16-byte aligned.
template <int KP, int VP>
cudaError_t launch_attn_projection_p(const void* x, const int* ids,
                                     const void* wk, const void* wv,
                                     const AttnScratch& sc,
                                     int B, int L, int C, int S, int H,
                                     int kd, int vd, cudaStream_t stream) {
  using K = WgAttn<KP, VP>;
  const uint64_t x_dims[3] = {uint64_t(C), uint64_t(L), uint64_t(B)};
  const uint64_t x_strides[2] = {uint64_t(C) * 2, uint64_t(L) * C * 2};
  const uint32_t x_box[3] = {K::KC, K::TM, 1};
  const uint64_t k_dims[3] = {uint64_t(kd), uint64_t(C), uint64_t(H)};
  const uint64_t k_strides[2] = {uint64_t(kd) * 2, uint64_t(C) * kd * 2};
  const uint64_t v_dims[3] = {uint64_t(vd), uint64_t(C), uint64_t(H)};
  const uint64_t v_strides[2] = {uint64_t(vd) * 2, uint64_t(C) * vd * 2};
  const uint32_t w_box[3] = {64, K::KC, 1};
  CUtensorMap tx, tk, tv;
  if (!sm90::encode_bf16_map(&tx, x, 3, x_dims, x_strides, x_box) ||
      !sm90::encode_bf16_map(&tk, wk, 3, k_dims, k_strides, w_box) ||
      !sm90::encode_bf16_map(&tv, wv, 3, v_dims, v_strides, w_box))
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  const size_t smem = K::TOTAL;
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_attn_kernel<KP, VP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return e;
  const long tiles = long((L + K::TM - 1) / K::TM) * B * H * K::KINDS;
  const int grid = int(tiles < sms ? tiles : sms);
  wgmma_attn_kernel<KP, VP><<<grid, K::THREADS, smem, stream>>>(
      sc.q, ids, sc.scores, sc.v, B, L, C, S, H, kd, vd, tx, tk, tv);
  return cudaGetLastError();
}

// Pass 2 at the instantiation (KP, VP) that kd and vd round up to.
inline cudaError_t launch_attn_projection(const void* x, const int* ids,
                                          const void* wk, const void* wv,
                                          const AttnScratch& sc, int B,
                                          int L, int C, int S, int H, int kd,
                                          int vd, cudaStream_t stream) {
#define PBT_PROJ(KP, VP)                                                    \
  if (pad64(kd) == KP && pad64(vd) == VP)                                   \
    return launch_attn_projection_p<KP, VP>(x, ids, wk, wv, sc, B, L, C, S, \
                                            H, kd, vd, stream);
  PBT_PROJ(64, 64)
  PBT_PROJ(64, 128)
  PBT_PROJ(64, 256)
  PBT_PROJ(128, 64)
  PBT_PROJ(128, 128)
  PBT_PROJ(128, 256)
#undef PBT_PROJ
  return cudaErrorInvalidValue;
}

// Pass 3: out (B, S, H * vd) bf16 from the scores, V and ids.
inline cudaError_t launch_attn_softmax(const int* ids, const AttnScratch& sc,
                                       void* out, int B, int L, int S, int H,
                                       int vd, int zero_empty,
                                       cudaStream_t stream) {
  const auto kernel =
      S == 1 ? attn_softmax_kernel<true> : attn_softmax_kernel<false>;
  kernel<<<dim3(H, B, S), kSoftThreads, 0, stream>>>(
      ids, sc.scores, sc.v, static_cast<bf16*>(out), L, S, H, vd,
      zero_empty);
  return cudaGetLastError();
}

// All passes of one bf16 call, head widths kd and vd = G / H.
template <bool Q8>
cudaError_t launch_attention_sm90(const void* x, const int* ids,
                                  const void* g,
                                  const AttnWeights<bf16, Q8>& w,
                                  const AttnScratch& sc, void* out, int B,
                                  int L, int C, int G, int S, int H, int kd,
                                  int zero_empty, cudaStream_t stream) {
  const int vd = G / H;
  const void* wk = w.wk;
  const void* wv = w.wv;
  cudaError_t e;
  if constexpr (Q8) {
    dequant_kv_kernel<<<dequant_kv_blocks(H, C, kd, vd), kThreads, 0,
                        stream>>>(w.wk, w.sk, w.wv, w.sv, sc.wk, sc.wv, H, C,
                                  kd, vd);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    wk = sc.wk;
    wv = sc.wv;
  }
  // Refuse before any launch a base the projection's maps cannot read.
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wk) |
       reinterpret_cast<uintptr_t>(wv)) % 16)
    return cudaErrorInvalidValue;
  attn_query_kernel<Q8><<<dim3(H, B, (S + 3) / 4), kThreads, 0, stream>>>(
      static_cast<const bf16*>(g), w, sc.q, S, G, H, kd);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_attn_projection(x, ids, wk, wv, sc, B, L, C, S, H, kd, vd,
                             stream);
  if (e != cudaSuccess) return e;
  return launch_attn_softmax(ids, sc, out, B, L, S, H, vd, zero_empty,
                             stream);
}

// K2 in either activation type: the Hopper passes above in bf16, the
// CUDA-core plan (attention.cuh `launch_attention`) in float32.
template <typename T, bool Q8>
cudaError_t launch_k2(const void* x, const int* ids, const void* g,
                      const AttnWeights<T, Q8>& w, const AttnScratch& sc,
                      void* out, int B, int L, int C, int G, int S, int H,
                      int kd, int zero_empty, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (B > 65535) return cudaErrorInvalidValue;
    return launch_attention_sm90<Q8>(x, ids, g, w, sc, out, B, L, C, G, S, H,
                                     kd, zero_empty, stream);
  } else {
    return launch_attention<Q8>(x, ids, g, w, sc.q, out, B, L, C, G, S, H,
                                kd, zero_empty, stream);
  }
}

}  // namespace pbt
