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
//   q_h = round(tanh(round(g @ wq[h])))                 (S, 64)
//   K_h = round(tanh(round(x @ wk[h])))                 (L, 64)
//   V_h = round(gelu(round(x @ wv[h])))                 (L, v)
//   scores[s, l] = K_h[l] . q_h[s] / 8                  (float32)
//   w[s, :] = round(softmax over l of scores, -1e30 where ids[l] != s + 1)
//   out[s, h*v:(h+1)*v] = w[s] @ V_h (float32), 0 for an empty s (zero_empty)
//
// What bounds it on the H100: operations. The K and V projections are one
// GEMM, x (B*L, C) @ [wk | wv] (C, H*(64+v)): 2*B*L*C*H*(64+v) FLOP, 34.4
// GFLOP at B=8, L=C=1024, H=16, v=64 (0.035 ms at 989 TFLOP/s bf16), 4.3
// GFLOP at the base width (B=8, L=C=512, H=8). Its bytes (x once, the
// weights, the scratches below) take ~0.01 ms.
//
// Design. The parent ran one 256-thread block per (head, row) that read its
// row's x from L2 twice per head (a K pass and a V pass) through 64 x 64
// WMMA tiles with two barriers per 32-column step: latency-bound, 1-3% of
// the bound. Here the work is split where its shape changes:
//   1. query pass (`attn_query_kernel`), one block per (head, row, four
//      segments): 256 threads = 8 groups of 8 output columns x 32 parts of
//      G, each a float32 FMA chain over independent 16-byte weight loads,
//      the parts summed in a fixed order; q goes to a float32 scratch
//      (B, S, H, 64).
//   2. projection pass (`wgmma_attn_kernel`), persistent (one block per SM
//      walking tiles of 256 rows (v = 64; 128 at v = 128) of one batch row
//      x one head). A producer warp keeps a ring of four or five TMA stages
//      full: the x tile (64 channels x the tile's rows, a 3-D map over (C,
//      L, B) whose zero fill covers rows past L) and the head's key and
//      value tiles (64 channels x 64
//      columns each, 3-D maps over (64 or v, C, H), zero past C, read
//      MN-major as the weights are stored, no repack). Two consumer
//      warpgroups, 128 rows (v = 64) or 64 each, run m64n128k16 (v = 64)
//      or m64n192k16 (v = 128) with both operands read by descriptor from
//      the stage (A
//      K-major, B through the transpose bit), so no register the products
//      read is written while they run and one chunk's products stay in
//      flight while the next chunk's are issued. The
//      epilogue works on the accumulators in registers: the key columns
//      become tanh'd K and are dotted with every segment's q (four lanes
//      share a row: a fixed two-step shuffle sum), written as float32 scores
//      (B, H, S, L); the value columns become gelu'd V, written as bf16
//      (B, L, H*v), which is exact since V is rounded to bf16 anyway.
//      Every x tile crosses L2 once per head (the parent: twice per head).
//      What bounds this pass is L2 -> SM traffic: at B=8, L=C=1024, H=16
//      the tiles move ~0.40 GB a call (256-row tiles; 0.54 GB at 128 rows,
//      11% slower on the H100, PERF.md).
//   3. softmax pass (`attn_softmax_kernel`), one 512-thread block per
//      (head, row, segment), so even the dense S=1 call has B*H blocks of
//      16 warps to hide L2 latency: the segment's max and sum over L (one
//      block reduction each), the bf16-rounded weights written over its
//      scores, then out = sum over l of w[l] * V[l] in float32: each thread
//      walks one group of rows for one pair of V columns (the loads of
//      successive rows independent), the groups summed in a fixed order.
//      V is read once per segment, from L2. The
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

// The projection pass at value_dim VD: tile, ring and shared-memory layout.
template <int VD>
struct WgAttn {
  // m64 row blocks a consumer warpgroup: two at v = 64 (the accumulators
  // then fill 128 registers), one at v = 128 (96).
  static constexpr int MT = VD == 64 ? 2 : 1;
  static constexpr int TM = 128 * MT;   // rows a tile: two consumer WGs
  static constexpr int N = kKD + VD;    // columns: K, then V
  static constexpr int KC = 64;         // channels a chunk: one 128-byte row
  static constexpr int THREADS = 384;
  static constexpr int CONSUMERS = 256;
  static constexpr int CONSUMER_WARPS = 8;
  static constexpr uint32_t ROW_BYTES = KC * 2;
  static constexpr uint32_t X_BYTES = TM * ROW_BYTES;
  static constexpr uint32_t BOX_BYTES = KC * 64 * 2;        // 64 x 64 box
  static constexpr uint32_t KSTEP_BYTES = 16 * ROW_BYTES;   // 16 K rows
  // The key box, then VD / 64 value boxes, LBO apart.
  static constexpr uint32_t W_BYTES = uint32_t(1 + VD / 64) * BOX_BYTES;
  static constexpr uint32_t STAGE = X_BYTES + W_BYTES;
  static constexpr size_t Q_BYTES = size_t(kMaxS) * kKD * sizeof(float);
  static constexpr int STAGES =
      (232448 - 2048 - int(Q_BYTES)) / int(STAGE) < 5
          ? (232448 - 2048 - int(Q_BYTES)) / int(STAGE)
          : 5;
  static constexpr size_t TOTAL =
      STAGES * size_t(STAGE) + Q_BYTES + 2 * STAGES * 8 +
      1024;  // + alignment slack
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
// mask ids: one_pass_sm90.cuh). Thread t sums 8 of the 64 columns (8 * (t
// % 8) ..) over one of 32 parts of G (t / 8), the loads of successive k
// independent; the parts are then summed in a fixed order.
template <bool Q8>
__device__ __forceinline__ void attn_query_block(
    const bf16* __restrict__ g, const AttnWeights<bf16, Q8>& w,
    float* __restrict__ qbuf, int S, int G, int H) {
  constexpr int kParts = kThreads / 8;
  const int h = blockIdx.x, b = blockIdx.y, s0 = blockIdx.z * 4;
  const int jg = threadIdx.x % 8, part = threadIdx.x / 8;
  const int ns = min(4, S - s0);
  const int kper = G / kParts;  // G = H * v, a multiple of 64
  const bf16* gb = g + (size_t(b) * S + s0) * G;
  float sc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    sc[e] = Q8 ? w.sq[size_t(h) * kKD + 8 * jg + e] : 1.f;
  float acc[4][8];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[u][e] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < kper; ++kk) {
    const int k = part * kper + kk;
    float wv[8];
    load8<Q8>(w.wq + (size_t(h) * G + k) * kKD + 8 * jg, sc, wv);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // Branch-free: a segment past ns repeats the last one (discarded).
      const float gv = to_f(gb[size_t(min(u, ns - 1)) * G + k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[u][e] = fmaf(gv, wv[e], acc[u][e]);
    }
  }
  __shared__ float red[kParts][4][kKD];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int e = 0; e < 8; ++e) red[part][u][8 * jg + e] = acc[u][e];
  __syncthreads();
  const int u = threadIdx.x / kKD, j = threadIdx.x % kKD;
  if (u < ns) {
    float v = red[0][u][j];
    for (int p = 1; p < kParts; ++p) v += red[p][u][j];
    qbuf[((size_t(b) * S + s0 + u) * H + h) * kKD + j] =
        round_to<bf16>(tanhf(round_to<bf16>(v)));
  }
}

template <bool Q8>
__global__ void __launch_bounds__(kThreads)
    attn_query_kernel(const bf16* __restrict__ g, AttnWeights<bf16, Q8> w,
                      float* __restrict__ qbuf, int S, int G, int H) {
  attn_query_block<Q8>(g, w, qbuf, S, G, H);
}

// One 64-channel chunk of a consumer warpgroup's products, both operands
// read by descriptor from the stage: A its MT blocks of 64 rows of the x
// tile from `xa` (K-major), B the weight boxes at `ws` (MN-major).
template <int VD>
__device__ __forceinline__ void attn_chunk(
    float (&acc)[WgAttn<VD>::MT][WgAttn<VD>::N / 2], uint32_t xa,
    uint32_t ws) {
  using K = WgAttn<VD>;
  using namespace sm90;
  wgmma_fence();
  const uint64_t db = desc_sw128(ws, K::BOX_BYTES, 8 * K::ROW_BYTES);
#pragma unroll
  for (int m = 0; m < K::MT; ++m) {
    const uint64_t da =
        desc_sw128(xa + m * 64 * K::ROW_BYTES, 16, 8 * K::ROW_BYTES);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_ss<K::N>(acc[m], da + ((k * 32) >> 4),
                     db + ((k * K::KSTEP_BYTES) >> 4));
  }
  wgmma_commit();
}

// The epilogue of one m64 accumulator: rows r0 and r0 + 8 of each warp's
// 16 (r0 already offset to the tile's row in L); K scores into sb, V into
// vr0 (row r0's V; row r0 + 8 is 8 rows of G further).
template <int VD>
__device__ __forceinline__ void attn_epilogue(
    float (&acc)[WgAttn<VD>::N / 2], const float* qs, float* sb, bf16* vbuf,
    int r0, int L, int S, int G, int q) {
  const float inv_scale = 1.0f / sqrtf(float(kKD));
  const int r1 = r0 + 8;
  // K = round(tanh(round(acc))) in place over the key columns (j < 8).
#pragma unroll
  for (int i = 0; i < 32; ++i)
    acc[i] = round_to<bf16>(tanhf(round_to<bf16>(acc[i])));
  for (int s = 0; s < S; ++s) {
    const float* qr = qs + s * kKD;
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 qv = *reinterpret_cast<const float2*>(qr + 8 * j + 2 * q);
      p0 = fmaf(acc[4 * j], qv.x, p0);
      p0 = fmaf(acc[4 * j + 1], qv.y, p0);
      p1 = fmaf(acc[4 * j + 2], qv.x, p1);
      p1 = fmaf(acc[4 * j + 3], qv.y, p1);
    }
    p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
    p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
    if (q == (s & 3)) {
      if (r0 < L) sb[size_t(s) * L + r0] = p0 * inv_scale;
      if (r1 < L) sb[size_t(s) * L + r1] = p1 * inv_scale;
    }
  }
  // V = round(gelu(round(acc))) over the value columns, as bf16.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int l = half ? r1 : r0;
    if (l >= L) continue;
    bf16* vr = vbuf + size_t(l) * G;
#pragma unroll
    for (int jj = 0; jj < VD / 8; ++jj) {
      const int i = 4 * (8 + jj) + 2 * half;
      *reinterpret_cast<__nv_bfloat162*>(vr + 8 * jj + 2 * q) =
          __floats2bfloat162_rn(gelu_tanh(round_to<bf16>(acc[i])),
                                gelu_tanh(round_to<bf16>(acc[i + 1])));
    }
  }
}

// Pass 2: scores (B, H, S, L) and V (B, L, H*VD) for every tile of TM rows
// of one batch row and one head. tx maps x as (C, L, B); tk and tv map wk
// and wv as (64, C, H) and (VD, C, H).
template <int VD>
__global__ void __launch_bounds__(WgAttn<VD>::THREADS, 1)
    wgmma_attn_kernel(const float* __restrict__ qbuf,
                      float* __restrict__ scores, bf16* __restrict__ vbuf,
                      int B, int L, int C, int S, int H,
                      const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv) {
  using K = WgAttn<VD>;
  using namespace sm90;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* qs = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                       K::STAGES * size_t(K::STAGE));
  const uint32_t full = base + K::STAGES * K::STAGE + K::Q_BYTES;
  const uint32_t empty = full + 8 * K::STAGES;

  const int rts = (L + K::TM - 1) / K::TM;
  const int tiles = rts * B * H;
  const int chunks = (C + K::KC - 1) / K::KC;

  if (threadIdx.x == 0) {
    for (int i = 0; i < K::STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, K::CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Tile t: row tile t % rts of batch row (t / rts) % B, head t / (rts B):
  // the blocks resident at once share one or two heads' weights.
  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the TMA loads in flight, across
    // tiles, so the next tile's loads overlap this tile's epilogue.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int rt = t % rts, b = (t / rts) % B, h = t / (rts * B);
        for (int kc = 0; kc < chunks; ++kc, ++it) {
          const int st = it % K::STAGES;
          mbar_wait(empty + 8 * st, ((it / K::STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(full + 8 * st, K::STAGE);
          const uint32_t dst = base + st * K::STAGE;
          tma_load_3d(dst, &tx, full + 8 * st, kc * K::KC, rt * K::TM, b);
          tma_load_3d(dst + K::X_BYTES, &tk, full + 8 * st, 0, kc * K::KC,
                      h);
#pragma unroll
          for (int j = 0; j < VD / 64; ++j)
            tma_load_3d(dst + K::X_BYTES + (1 + j) * K::BOX_BYTES, &tv,
                        full + 8 * st, 64 * j, kc * K::KC, h);
        }
      }
    }
    return;
  }

  // Consumer warpgroups: warpgroup wg owns tile rows 64 MT wg .. 64 MT
  // (wg + 1) - 1; warp w % 4 rows 16 (w % 4) .. of each 64-row block.
  setmaxnreg_inc<232>();
  const int ct = threadIdx.x - 128;
  const int lane = ct % 32, warp = ct / 32, wg = warp / 4;
  const int g = lane / 4, q = lane % 4;
  const int G = H * VD;
  const int wrow = wg * 64 * K::MT;  // the warpgroup's first tile row
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int rt = t % rts, b = (t / rts) % B, h = t / (rts * B);
    // The previous tile's epilogue is done with qs: load this (b, h)'s q.
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    for (int i = ct; i < S * kKD; i += K::CONSUMERS)
      qs[i] = qbuf[((size_t(b) * S + i / kKD) * H + h) * kKD + i % kKD];

    float acc[K::MT][K::N / 2];
#pragma unroll
    for (int m = 0; m < K::MT; ++m)
#pragma unroll
      for (int i = 0; i < K::N / 2; ++i) acc[m][i] = 0.f;
    // Chunk kc: wait for its stage and issue its products; then the
    // previous chunk's products are done, so release the previous stage.
    for (int kc = 0; kc < chunks; ++kc, ++it) {
      const int st = it % K::STAGES;
      mbar_wait(full + 8 * st, (it / K::STAGES) & 1);
      const uint32_t xs = base + st * K::STAGE;
      attn_chunk<VD>(acc, xs + wrow * K::ROW_BYTES, xs + K::X_BYTES);
      wgmma_wait<1>();
      if (kc > 0 && lane == 0)
        mbar_arrive(empty + 8 * ((it + K::STAGES - 1) % K::STAGES));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < K::MT; ++m) fence_regs(acc[m]);
    if (lane == 0) mbar_arrive(empty + 8 * ((it + K::STAGES - 1) % K::STAGES));
    asm volatile("bar.sync 1, 256;\n" ::: "memory");  // qs is loaded

    float* sb = scores + (size_t(b) * H + h) * S * L;
    bf16* vb = vbuf + size_t(b) * L * G + h * VD;
#pragma unroll
    for (int m = 0; m < K::MT; ++m)
      attn_epilogue<VD>(acc[m], qs, sb, vb,
                        rt * K::TM + wrow + 64 * m + (warp % 4) * 16 + g, L,
                        S, G, q);
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

// Pass 3: out[b, s, h*VD : (h+1)*VD] for segment s of batch row b, one
// block each. The segment's row of the scores' scratch is overwritten by
// its weights.
template <int VD>
__global__ void __launch_bounds__(kSoftThreads)
    attn_softmax_kernel(const int* __restrict__ ids, float* scores,
                        const bf16* __restrict__ vbuf, bf16* __restrict__ out,
                        int L, int S, int H, int zero_empty) {
  constexpr int kPairs = VD / 2;                  // column pairs of V
  constexpr int kGroups = kSoftThreads / kPairs;  // row groups
  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int G = H * VD;
  // Read and written by this block only; plain (coherent) loads.
  float* sr = scores + ((size_t(b) * H + h) * S + s) * L;
  const int* ib = ids + size_t(b) * L;
  __shared__ float red[kSoftWarps];
  __shared__ float part[kGroups][VD];
  const auto fmax_op = [](float a, float c) { return fmaxf(a, c); };

  // The segment's max over l of its masked scores (-1e30 off the segment;
  // every score is >= that), whether it holds any position, then its sum
  // of exp(score - max).
  float mx = -1e30f, any = 0.f;
  for (int l = threadIdx.x; l < L; l += kSoftThreads) {
    const float v = sr[l];
    if (ib[l] == s + 1) {
      mx = fmaxf(mx, v);
      any = 1.f;
    }
  }
  mx = block_reduce(mx, red, fmax_op);
  any = block_reduce(any, red, fmax_op);
  float sum = 0.f;
  for (int l = threadIdx.x; l < L; l += kSoftThreads) {
    const float v = sr[l];
    sum += expf((ib[l] == s + 1 ? v : -1e30f) - mx);
  }
  sum = block_reduce(sum, red, [](float a, float c) { return a + c; });
  // The weights, rounded to bf16 as the TPU kernel casts them, in place of
  // the scores (the barrier makes them visible to the whole block).
  for (int l = threadIdx.x; l < L; l += kSoftThreads) {
    const float v = sr[l];
    sr[l] = round_to<bf16>(expf((ib[l] == s + 1 ? v : -1e30f) - mx) / sum);
  }
  __syncthreads();

  // out[j] = sum over l of w[l] * V[l, j] in float32: thread (row group r,
  // column pair c) sums rows r, r + kGroups, ... in order, then the groups
  // are summed in order.
  const int c = threadIdx.x % kPairs, r = threadIdx.x / kPairs;
  float a0 = 0.f, a1 = 0.f;
  const bf16* vb = vbuf + size_t(b) * L * G + h * VD + 2 * c;
#pragma unroll 4
  for (int l = r; l < L; l += kGroups) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(vb + size_t(l) * G));
    const float wgt = sr[l];
    a0 = fmaf(wgt, v.x, a0);
    a1 = fmaf(wgt, v.y, a1);
  }
  part[r][2 * c] = a0;
  part[r][2 * c + 1] = a1;
  __syncthreads();
  for (int j = threadIdx.x; j < VD; j += kSoftThreads) {
    float a = part[0][j];
    for (int q = 1; q < kGroups; ++q) a += part[q][j];
    const float v = (zero_empty && any == 0.f) ? 0.f : a;
    out[(size_t(b) * S + s) * G + h * VD + j] = from_f<bf16>(v);
  }
}

// The int8 leg's dequantize pass: wk (H, C, 64) and wv (H, C, vd) int8 with
// scales sk (H, 64), sv (H, vd) into bf16 (H, C, 64) and (H, C, vd), each
// value from_f(q * scale) — the floating-point leg's operand on the
// dequantized weights. 16 values (one 16-byte load) a thread and step;
// this is block `block` of `blocks` (kThreads threads each).
__device__ __forceinline__ void dequant_kv_block(
    const int8_t* __restrict__ wk, const float* __restrict__ sk,
    const int8_t* __restrict__ wv, const float* __restrict__ sv,
    bf16* __restrict__ ok, bf16* __restrict__ ov, int H, int C, int vd,
    uint32_t block, uint32_t blocks) {
  const size_t nk = size_t(H) * C * kKD / 16;
  const size_t nv = size_t(H) * C * vd / 16;
  for (size_t i = size_t(block) * kThreads + threadIdx.x; i < nk + nv;
       i += size_t(blocks) * kThreads) {
    const bool key = i < nk;
    const int n = key ? kKD : vd;
    const size_t e = (key ? i : i - nk) * 16;  // first element
    const size_t row = e / n;                  // h * C + c
    const int col = int(e - row * n);
    const float* sc = (key ? sk : sv) + (row / C) * n + col;
    const int4 raw = *reinterpret_cast<const int4*>((key ? wk : wv) + e);
    const int8_t* qv = reinterpret_cast<const int8_t*>(&raw);
    __align__(16) bf16 v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = from_f<bf16>(static_cast<float>(qv[j]) * sc[j]);
    uint4* d = reinterpret_cast<uint4*>((key ? ok : ov) + e);
    d[0] = reinterpret_cast<const uint4*>(v)[0];
    d[1] = reinterpret_cast<const uint4*>(v)[1];
  }
}

// The blocks the pass takes for H heads of (C, 64 + vd): one 16-value
// group a thread, at most 4096 blocks.
inline uint32_t dequant_kv_blocks(int H, int C, int vd) {
  const size_t n16 = size_t(H) * C * (kKD + vd) / 16;
  const size_t want = (n16 + kThreads - 1) / kThreads;
  return uint32_t(want < 4096 ? want : 4096);
}

__global__ void __launch_bounds__(kThreads)
    dequant_kv_kernel(const int8_t* __restrict__ wk,
                      const float* __restrict__ sk,
                      const int8_t* __restrict__ wv,
                      const float* __restrict__ sv, bf16* __restrict__ ok,
                      bf16* __restrict__ ov, int H, int C, int vd) {
  dequant_kv_block(wk, sk, wv, sv, ok, ov, H, C, vd, blockIdx.x, gridDim.x);
}

// Scratch the wrapper allocates for one bf16 call, as parts of one buffer
// (attention.py `attention_scratch_layout`): q (B, S, H, 64) and scores
// (B, H, S, L) float32, V (B, L, H*vd) bf16, and on the int8 leg the
// dequantized wk (H, C, 64) and wv (H, C, vd) bf16 (null on the
// floating-point leg).
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

// Pass 2 over x (B, L, C) bf16 with bf16 wk, wv: the scores and V of every
// head into sc. The maps fail to encode (cudaErrorInvalidValue) for an x,
// wk or wv whose base is not 16-byte aligned.
template <int VD>
cudaError_t launch_attn_projection(const void* x, const void* wk,
                                   const void* wv, const AttnScratch& sc,
                                   int B, int L, int C, int S, int H,
                                   cudaStream_t stream) {
  using K = WgAttn<VD>;
  const uint64_t x_dims[3] = {uint64_t(C), uint64_t(L), uint64_t(B)};
  const uint64_t x_strides[2] = {uint64_t(C) * 2, uint64_t(L) * C * 2};
  const uint32_t x_box[3] = {K::KC, K::TM, 1};
  const uint64_t k_dims[3] = {uint64_t(kKD), uint64_t(C), uint64_t(H)};
  const uint64_t k_strides[2] = {uint64_t(kKD) * 2, uint64_t(C) * kKD * 2};
  const uint64_t v_dims[3] = {uint64_t(VD), uint64_t(C), uint64_t(H)};
  const uint64_t v_strides[2] = {uint64_t(VD) * 2, uint64_t(C) * VD * 2};
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
      wgmma_attn_kernel<VD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return e;
  const long tiles = long((L + K::TM - 1) / K::TM) * B * H;
  const int grid = int(tiles < sms ? tiles : sms);
  wgmma_attn_kernel<VD><<<grid, K::THREADS, smem, stream>>>(
      sc.q, sc.scores, sc.v, B, L, C, S, H, tx, tk, tv);
  return cudaGetLastError();
}

// Pass 3: out (B, S, H * VD) bf16 from the scores, V and ids.
template <int VD>
cudaError_t launch_attn_softmax(const int* ids, const AttnScratch& sc,
                                void* out, int B, int L, int S, int H,
                                int zero_empty, cudaStream_t stream) {
  attn_softmax_kernel<VD><<<dim3(H, B, S), kSoftThreads, 0, stream>>>(
      ids, sc.scores, sc.v, static_cast<bf16*>(out), L, S, H, zero_empty);
  return cudaGetLastError();
}

// All passes of one bf16 call.
template <int VD, bool Q8>
cudaError_t launch_attention_sm90(const void* x, const int* ids,
                                  const void* g,
                                  const AttnWeights<bf16, Q8>& w,
                                  const AttnScratch& sc, void* out, int B,
                                  int L, int C, int G, int S, int H,
                                  int zero_empty, cudaStream_t stream) {
  const void* wk = w.wk;
  const void* wv = w.wv;
  cudaError_t e;
  if constexpr (Q8) {
    dequant_kv_kernel<<<dequant_kv_blocks(H, C, VD), kThreads, 0, stream>>>(
        w.wk, w.sk, w.wv, w.sv, sc.wk, sc.wv, H, C, VD);
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
      static_cast<const bf16*>(g), w, sc.q, S, G, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_attn_projection<VD>(x, wk, wv, sc, B, L, C, S, H, stream);
  if (e != cudaSuccess) return e;
  return launch_attn_softmax<VD>(ids, sc, out, B, L, S, H, zero_empty,
                                 stream);
}

// K2 in either activation type: the Hopper passes above in bf16, the
// CUDA-core plan (attention.cuh `launch_attention`) in float32.
template <typename T, bool Q8>
cudaError_t launch_k2(const void* x, const int* ids, const void* g,
                      const AttnWeights<T, Q8>& w, const AttnScratch& sc,
                      void* out, int B, int L, int C, int G, int S, int H,
                      int zero_empty, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (B > 65535) return cudaErrorInvalidValue;
    if (G == H * 64)
      return launch_attention_sm90<64, Q8>(x, ids, g, w, sc, out, B, L, C, G,
                                           S, H, zero_empty, stream);
    if (G == H * 128)
      return launch_attention_sm90<128, Q8>(x, ids, g, w, sc, out, B, L, C,
                                            G, S, H, zero_empty, stream);
    return cudaErrorInvalidValue;
  } else {
    return launch_attention_vd<T, Q8>(x, ids, g, w, out, B, L, C, G, S, H,
                                      zero_empty, stream);
  }
}

}  // namespace pbt
