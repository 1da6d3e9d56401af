// Kernel #6 — the one-pass trunk of one ProteinBERT block in float32: the
// device code and launch shared by its floating-point leg (one_pass.cu) and
// its int8 leg (one_pass_q8.cu, Q8 = true). Its bf16 legs run the Hopper
// passes of one_pass_sm90.cuh (wgmma + TMA) instead; float32 keeps this
// plan because the tensor cores have no exact float32 mode, as #2, #4, K1,
// #3 and K2 keep theirs. Design below.
//
// Replaces the TPU kernel proteinbert_tpu/kernels/one_pass.py
// `_onepass_kernel` (one_pass.py:225-288, launched at :380 by
// `_pallas_onepass_forward`; entries `fused_onepass_segments`, packed rows,
// and `fused_onepass_dense`, S = 1), both its legs. It computes
// `onepass_oh_reference` (one_pass.py:197-222): the local track — dense
// (seg_masked = 0) or segment-masked — and then the attention over the
// ROUNDED local output with the OLD global rows, masked by the segment
// one-hot narrowed to real tokens. `real` narrows the attention only: an
// in-span <pad> still feeds the convs. zero_empty = 1 (packed rows) makes
// an empty segment an exact +0.0; dense rows keep the uniform softmax of an
// all-pad row. Masking uses -1e30.
//
// What bounds it on the H100: operations. At 8 rows x L=512, C=128, G=512,
// H=4, k=64, v=128, S=8 the track is 2.550 GFLOP and the attention
// 2*8*4*(512*128*192 + 8*512*64 + 512*8*192) = 0.872 GFLOP: 3.42 GFLOP,
// 0.051 ms at 67 TFLOP/s float32.
//
// Design: the TPU kernel kept a whole (L+40, C) row, both weight sets and
// the local output resident in VMEM and fed the attention straight from
// there. A Hopper block cannot hold the row (256 KB at C=128 float32,
// L=512), so each packed row gets a thread-block CLUSTER of 8 CTAs,
// guaranteed co-resident:
//   1. the CTAs split the row's TL-row tiles and run the local-track tile
//      code of K1 / #3's float32 legs (local_track.cuh `track_tile`),
//      writing the local output to device memory, where it stays in the
//      50 MB L2;
//   2. __threadfence + cluster barrier (release/acquire at cluster scope):
//      every tile of the row is written and visible to the whole cluster;
//   3. CTA r runs the attention of heads r, r+8, ... over the whole row
//      with K2's float32 device code (attention.cuh `attention_head`),
//      reading the local output back from L2, with no cross-CTA softmax
//      merge.
// So what a row carries across the barrier is its (L, C) local output in L2
// (and, per CTA, nothing else): one launch, no second kernel, no host sync.
// The int8 leg (Q8) takes the int8 weights of both tracks with their float32
// scales and dequantizes each weight tile on its way into shared memory
// (local_track.cuh and attention.cuh), as #3's and K2's int8 legs do.

#pragma once

#include <cooperative_groups.h>

#include "attention.cuh"
#include "local_track.cuh"

namespace pbt {

constexpr int kCluster = 8;  // CTAs per packed row (the portable maximum)

template <typename T, int C, int VD, bool SEG, bool Q8>
__global__ void __launch_bounds__(kThreads, 1)
    onepass_kernel(TrackArgs<T, Q8> p, const int* __restrict__ real,
                   const T* __restrict__ g, AttnWeights<T, Q8> aw,
                   T* __restrict__ attn, int G, int H, int zero_empty) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TL = TrackCfg<T, C>::TL;
  const int rank = blockIdx.x, csize = gridDim.x, b = blockIdx.y;
  const int L = p.L, S = p.S;

  for (int t = rank; t * TL < L; t += csize)
    track_tile<T, C, SEG, Q8>(p, b, t * TL, smem);

  __threadfence();
  cooperative_groups::this_cluster().sync();

  const SegmentMask mask{SEG ? p.seg + size_t(b) * L : nullptr,
                         real + size_t(b) * L};
  for (int h = rank; h < H; h += csize)
    attention_head<T, VD, Q8>(p.out + size_t(b) * L * C,
                              g + size_t(b) * S * G, aw,
                              attn + size_t(b) * S * G, L, C, G, S, h,
                              zero_empty, mask, smem);
}

template <typename T, int C, int VD, bool SEG, bool Q8>
cudaError_t launch_onepass(const TrackArgs<T, Q8>& p, const void* real,
                           const void* g, const AttnWeights<T, Q8>& aw,
                           void* attn, int B, int G, int H, int zero_empty,
                           cudaStream_t stream) {
  const size_t track = TrackSmem<T, C, SEG>::total;
  const size_t heads = AttnSmem<T, VD>::total(p.L, p.S);
  const size_t smem = track > heads ? track : heads;
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = onepass_kernel<T, C, VD, SEG, Q8>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p, static_cast<const int*>(real),
                         static_cast<const T*>(g), aw, static_cast<T*>(attn),
                         G, H, zero_empty);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int C, int VD, bool Q8>
cudaError_t launch_seg(int seg_masked, const TrackArgs<T, Q8>& p,
                       const void* real, const void* g,
                       const AttnWeights<T, Q8>& aw, void* attn, int B, int G,
                       int H, int zero_empty, cudaStream_t stream) {
  if (seg_masked)
    return launch_onepass<T, C, VD, true, Q8>(p, real, g, aw, attn, B, G, H,
                                              zero_empty, stream);
  return launch_onepass<T, C, VD, false, Q8>(p, real, g, aw, attn, B, G, H,
                                             zero_empty, stream);
}

template <typename T, bool Q8>
cudaError_t launch_shape(int C, int VD, int seg_masked,
                         const TrackArgs<T, Q8>& p, const void* real,
                         const void* g, const AttnWeights<T, Q8>& aw,
                         void* attn, int B, int G, int H, int zero_empty,
                         cudaStream_t stream) {
  if (C == 128 && VD == 64)
    return launch_seg<T, 128, 64>(seg_masked, p, real, g, aw, attn, B, G, H,
                                  zero_empty, stream);
  if (C == 128 && VD == 128)
    return launch_seg<T, 128, 128>(seg_masked, p, real, g, aw, attn, B, G, H,
                                   zero_empty, stream);
  if (C == 256 && VD == 64)
    return launch_seg<T, 256, 64>(seg_masked, p, real, g, aw, attn, B, G, H,
                                  zero_empty, stream);
  if (C == 256 && VD == 128)
    return launch_seg<T, 256, 128>(seg_masked, p, real, g, aw, attn, B, G, H,
                                   zero_empty, stream);
  return cudaErrorInvalidValue;
}

// Host-side checks of #6's entries.
inline bool onepass_geometry_ok(int seg_masked, const void* seg, int B,
                                int L, int G, int S, int H,
                                int wide_dilation) {
  return track_geometry_ok(B, L, S, wide_dilation) && S <= kMaxS && H >= 1 &&
         G % H == 0 && (seg_masked ? seg != nullptr : S == 1);
}

}  // namespace pbt
