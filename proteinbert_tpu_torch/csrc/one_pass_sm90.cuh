// Kernel #6 in bfloat16 for Hopper (sm_90a): the one-pass trunk of one
// ProteinBERT block as five passes on the caller's stream (six on the int8
// leg), all launched by ONE C call. The device code of #6's bf16 legs, both
// entries (one_pass.cu, one_pass_q8.cu); float32 keeps one_pass.cuh's
// cluster plan, because the tensor cores have no exact float32 mode.
//
// Replaces the TPU kernel proteinbert_tpu/kernels/one_pass.py
// `_onepass_kernel` (one_pass.py:225-288, launched at :380 by
// `_pallas_onepass_forward`; int8 branch :236-241). It computes
// `onepass_oh_reference` at the TPU kernel's rounding points: the local
// track in K1's order (local_track_sm90.cuh), its output rounded to bf16
// (`local`), then K2's attention over exactly that rounded output with the
// OLD global rows (attention_sm90.cuh: q, K and V rounded before and after
// tanh / gelu, float32 scores, bf16 softmax weights), masked by the segment
// ids narrowed to real tokens (one_pass.py:278-287: `local_val` feeds
// `_attention_body`).
//
// What bounds it on the H100: operations, as the TPU kernel counts them
// (`onepass_flops`, one_pass.py:362-366): at B=8, L=512, C=128, G=512, H=4,
// k=64, v=128, S=8 the track is 2.550 GFLOP and the attention 0.872: 3.42
// GFLOP, 0.0035 ms at 989 TFLOP/s bf16. Its bytes (x, local, the weights,
// the global rows, the ids) are ~3.4 MB, 0.001 ms at 3.35 TB/s.
//
// Design. The TPU kept a whole row, both weight sets and the local output
// in 13 MiB of VMEM and fed the attention from there. On Hopper the (B, L,
// C) local output (1 MB at the default width) stays in the 50 MB L2, and
// what costs is idle SMs, old WMMA / cp.async plans, launches the host pays
// for and an attention that waits for a whole row. So the call is passes,
// each shaped to fill the card, meeting in scratches one buffer holds
// (`OnepassScratch`; kernels/one_pass.py `onepass_scratch_layout`), all on
// the caller's stream:
//   0. int8 leg: `onepass_dequant_kernel` turns the track's three int8
//      weight sets and the attention's wk / wv into bf16 scratches in one
//      launch (the blocks of `dequant_track_kernel` and of
//      `dequant_kv_kernel` side by side) with the fp leg's rounding (round
//      to nearest even), so the int8 leg is its fp leg bit for bit; wq is
//      read through `load8<Q8>` in the query pass, as K2-int8 reads it.
//   1. query pass (`onepass_query_kernel`): K2's query block, q =
//      round(tanh(round(g @ wq[h]))) from the OLD global rows into a
//      float32 scratch; the same blocks write the softmax's mask ids:
//      seg[l] where real[l] != 0 and 1 <= seg[l] <= S (dense rows: 1 where
//      real[l] != 0), else 0. No host-side torch op builds them.
//   2. conv pass: local_track_sm90.cuh's `wgmma_conv_kernel` (SEG, K1's sum
//      order; `wgmma_conv_any_kernel` at any taps and dilations other than
//      the preset's) on 64-row tiles (one consumer warpgroup), h to a float32
//      scratch. At C <= 512 a 128-row tile gives B*L/128 blocks, 8 at the
//      L=128 bucket, on 132 SMs; the 64-row tile doubles them and measured
//      faster at every #6 shape (PERF.md, PR 10). Each output's sum runs in
//      one order whatever the tile's start.
//   3. finish pass: K1's `wgmma_finish_kernel` (LN1, the dense on wgmma,
//      LN2), the rounded bf16 `local` out.
//   4. projection pass: K2's `wgmma_attn_kernel` over exactly that bf16
//      `local` (the TPU kernel's rounding point): tanh'd K dotted with the
//      q of each position's own segment (the ids of pass 1) as one float32
//      score a position (B, H, L), gelu'd V as bf16 (B, L, H*v).
//   5. softmax pass: K2's `attn_softmax_kernel` over the ids of pass 1
//      (zero_empty: 1 for packed rows, 0 for dense), -1e30 masking. The
//      softmax weights are rounded to bf16, so a segment's max and sum over
//      all of L come first: no flash attention.
// A pass that fused 3 and 4 (LN1, dense, LN2, then each head's K / V
// projection over the local tile kept in shared memory) measured 2-19%
// slower than the two at every #6 shape on the H100 (PERF.md, PR 10): each
// pass is a chain of latencies, and the fused chain was longer than the
// two, so it was taken out.
#pragma once

#include <initializer_list>

#include "attention_sm90.cuh"
#include "local_track_sm90.cuh"

namespace pbt {

// ------------------------------------------------------------ scratch

// The scratches of one bf16 call, carved in this order from one buffer,
// each part rounded up to 256 bytes (kernels/one_pass.py
// `onepass_scratch_layout` lays out the same buffer): on the int8 leg the
// dequantized nk (nt, C, C), wk (wt, C, C), dk (C, C), attention wk (H, C,
// kd) and wv
// (H, C, v) bf16; then h (B, L, C) float32, q (B, S, H, kd) float32, ids
// (B, L) int32, scores (B, H, L) float32, V (B, L, H*v) bf16.
struct OnepassScratch {
  bf16* nk;
  bf16* wk;
  bf16* dk;
  bf16* awk;
  bf16* awv;
  float* h;
  float* q;
  int* ids;
  float* scores;
  bf16* v;
};

inline OnepassScratch onepass_scratch(void* base, bool q8, int B, int L,
                                      int C, int S, int H, int KD, int VD,
                                      const Taps& taps) {
  char* next = static_cast<char*>(base);
  auto take = [&](size_t bytes) {
    char* part = next;
    next += (bytes + 255) / 256 * 256;
    return part;
  };
  OnepassScratch s{};
  if (q8) {
    s.nk = reinterpret_cast<bf16*>(take(size_t(taps.nt) * C * C * 2));
    s.wk = reinterpret_cast<bf16*>(take(size_t(taps.wt) * C * C * 2));
    s.dk = reinterpret_cast<bf16*>(take(size_t(C) * C * 2));
    s.awk = reinterpret_cast<bf16*>(take(size_t(H) * C * KD * 2));
    s.awv = reinterpret_cast<bf16*>(take(size_t(H) * C * VD * 2));
  }
  s.h = reinterpret_cast<float*>(take(size_t(B) * L * C * 4));
  s.q = reinterpret_cast<float*>(take(size_t(B) * S * H * KD * 4));
  s.ids = reinterpret_cast<int*>(take(size_t(B) * L * 4));
  s.scores = reinterpret_cast<float*>(take(size_t(B) * H * L * 4));
  s.v = reinterpret_cast<bf16*>(take(size_t(B) * L * H * VD * 2));
  return s;
}

// ------------------------------------------------------------ pass 0

// The int8 leg's dequantize pass in one launch: the track's three weight
// sets on the first `track_blocks` blocks (local_track_sm90.cuh
// `dequant_track_block`), the attention's wk / wv on the rest
// (attention_sm90.cuh `dequant_kv_block`), each value the fp leg's bf16.
__global__ void __launch_bounds__(kThreads)
    onepass_dequant_kernel(TrackArgs<bf16, true> q,
                           AttnWeights<bf16, true> w, OnepassScratch sc,
                           int C, int H, int KD, int VD,
                           uint32_t track_blocks) {
  if (blockIdx.x < track_blocks)
    dequant_track_block(q.nk, q.nks, q.wk, q.wks, q.dk, q.dks, sc.nk, sc.wk,
                        sc.dk, uint32_t(C), uint32_t(q.taps.nt),
                        uint32_t(q.taps.wt), blockIdx.x, track_blocks);
  else
    dequant_kv_block(w.wk, w.sk, w.wv, w.sv, sc.awk, sc.awv, H, C, KD, VD,
                     blockIdx.x - track_blocks, gridDim.x - track_blocks);
}

// ------------------------------------------------------------ pass 1

// K2's query block (q for four segments of one (head, batch row)), then
// this block's share of row b's mask ids: the H * ceil(S/4) blocks of the
// row split its L positions.
template <bool Q8>
__global__ void __launch_bounds__(kThreads)
    onepass_query_kernel(const bf16* __restrict__ g, AttnWeights<bf16, Q8> w,
                         float* __restrict__ qbuf,
                         const int* __restrict__ seg,
                         const int* __restrict__ real, int* __restrict__ ids,
                         int L, int S, int G, int H, int KD) {
  attn_query_block<Q8>(g, w, qbuf, S, G, H, KD);
  const int b = blockIdx.y;
  const int part = blockIdx.x + H * blockIdx.z, parts = H * gridDim.z;
  const int* rb = real + size_t(b) * L;
  const int* sb = seg == nullptr ? nullptr : seg + size_t(b) * L;
  int* ib = ids + size_t(b) * L;
  for (int l = part * kThreads + threadIdx.x; l < L; l += parts * kThreads) {
    int id = 0;
    if (rb[l] != 0) {
      const int s = sb == nullptr ? 1 : sb[l];
      id = (s >= 1 && s <= S) ? s : 0;
    }
    ib[l] = id;
  }
}

// ------------------------------------------------------------ one call

inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16) return false;
  return true;
}

// Every pass of one bf16 call, in stream order, head widths KD and VD.
template <bool SEG, bool Q8>
cudaError_t launch_onepass_sm90(const TrackArgs<bf16, Q8>& p, const int* real,
                                const bf16* g,
                                const AttnWeights<bf16, Q8>& aw, void* attn,
                                const OnepassScratch& sc, int B, int C, int G,
                                int H, int KD, int zero_empty,
                                cudaStream_t stream) {
  // Refuse before any launch a base that TMA or the 16-byte loads cannot
  // read (the wrapper checks the strides too).
  if (!aligned16({p.x, p.nk, p.wk, p.dk, aw.wq, aw.wk, aw.wv, p.nks, p.wks,
                  p.dks, aw.sq, aw.sk, aw.sv}))
    return cudaErrorInvalidValue;
  const int L = p.L, S = p.S, VD = G / H;
  cudaError_t e;
  const void* wk = aw.wk;
  const void* wv = aw.wv;
  if constexpr (Q8) {
    if (!dequant_track_fits(C, p.taps)) return cudaErrorInvalidValue;
    const uint32_t track_blocks = dequant_track_blocks(C, p.taps);
    onepass_dequant_kernel<<<track_blocks + dequant_kv_blocks(H, C, KD, VD),
                             kThreads, 0, stream>>>(p, aw, sc, C, H, KD, VD,
                                                    track_blocks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    wk = sc.awk;
    wv = sc.awv;
  }
  const TrackArgs<bf16> tp = [&] {
    if constexpr (Q8)
      return dequantized_args(p, sc.nk, sc.wk, sc.dk);
    else
      return p;
  }();
  onepass_query_kernel<Q8><<<dim3(H, B, (S + 3) / 4), kThreads, 0, stream>>>(
      g, aw, sc.q, SEG ? p.seg : nullptr, real, sc.ids, L, S, G, H, KD);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_wgmma_conv<SEG, SumOrder::kK1, 64>(tp, B, C, sc.h, stream);
  if (e != cudaSuccess) return e;
  e = launch_wgmma_finish(tp, B, C, sc.h, stream);
  if (e != cudaSuccess) return e;
  const AttnScratch as{sc.q, sc.scores, sc.v, nullptr, nullptr};
  e = launch_attn_projection(tp.out, sc.ids, wk, wv, as, B, L, C, S, H, KD,
                             VD, stream);
  if (e != cudaSuccess) return e;
  return launch_attn_softmax(sc.ids, as, attn, B, L, S, H, VD, zero_empty,
                             stream);
}

// #6 in bf16, either leg: the scratch carved, then the instantiation for
// seg_masked (the head widths are run-time values, attention_sm90.cuh).
template <bool Q8>
cudaError_t launch_onepass_bf16(int seg_masked, const TrackArgs<bf16, Q8>& p,
                                const void* real, const void* g,
                                const AttnWeights<bf16, Q8>& aw, void* attn,
                                void* scratch, int B, int C, int G, int H,
                                int KD, int zero_empty, cudaStream_t stream) {
  if (scratch == nullptr || !sm90_shape_ok(B, C) || C > 512)
    return cudaErrorInvalidValue;
  const OnepassScratch sc =
      onepass_scratch(scratch, Q8, B, p.L, C, p.S, H, KD, G / H, p.taps);
  const int* r = static_cast<const int*>(real);
  const bf16* gg = static_cast<const bf16*>(g);
  return seg_masked
             ? launch_onepass_sm90<true, Q8>(p, r, gg, aw, attn, sc, B, C, G,
                                             H, KD, zero_empty, stream)
             : launch_onepass_sm90<false, Q8>(p, r, gg, aw, attn, sc, B, C, G,
                                              H, KD, zero_empty, stream);
}

}  // namespace pbt
