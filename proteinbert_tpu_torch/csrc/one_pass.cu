// Kernel #6 — the one-pass trunk of one ProteinBERT block: the local track
// and the global attention in ONE launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel proteinbert_tpu/kernels/one_pass.py
// `_onepass_kernel` (one_pass.py:225-288, launched at :380 by
// `_pallas_onepass_forward`; entries `fused_onepass_segments`, packed rows,
// and `fused_onepass_dense`, S = 1), its floating-point leg. It computes
// `onepass_oh_reference` (one_pass.py:197-222): the local track — dense
// (seg_masked = 0) or segment-masked — and then the attention over the
// ROUNDED local output with the OLD global rows, masked by the segment
// one-hot narrowed to real tokens. `real` narrows the attention only: an
// in-span <pad> still feeds the convs. zero_empty = 1 (packed rows) makes
// an empty segment an exact +0.0; dense rows keep the uniform softmax of an
// all-pad row. Masking uses -1e30.
//
// What bounds it on the H100: operations. At 8 rows x L=512, C=128, G=512,
// H=4, k=64, v=128, S=8 in bf16 the track is 2.550 GFLOP and the attention
// 2*8*4*(512*128*192 + 8*512*64 + 512*8*192) = 0.872 GFLOP: 3.42 GFLOP,
// 0.0035 ms at 989 TFLOP/s.
//
// Design: the TPU kernel kept a whole (L+40, C) row, both weight sets and
// the local output resident in VMEM and fed the attention straight from
// there. A Hopper block cannot hold the row (128 KB at C=128 bf16, 256 KB
// at C=256, L=512), so each packed row gets a thread-block CLUSTER of 8
// CTAs, guaranteed co-resident:
//   1. the CTAs split the row's TL-row tiles and run the local-track tile
//      code of K1 / #3 (local_track.cuh), writing the rounded local output
//      to device memory, where it stays in the 50 MB L2;
//   2. __threadfence + cluster barrier (release/acquire at cluster scope):
//      every tile of the row is written and visible to the whole cluster;
//   3. CTA r runs the attention of heads r, r+8, ... over the whole row
//      with K2's device code (attention.cuh), reading the local output back
//      from L2 — the exact rounding points of the TPU kernel (weights
//      rounded before the weighted sum), with no cross-CTA softmax merge.
// So what a row carries across the barrier is its (L, C) local output in L2
// (and, per CTA, nothing else): one launch, no second kernel, no host sync.

#include <cooperative_groups.h>

#include <type_traits>

#include "attention.cuh"
#include "local_track.cuh"

namespace pbt {

constexpr int kCluster = 8;  // CTAs per packed row (the portable maximum)

template <typename T, int C, int VD, bool SEG>
__global__ void __launch_bounds__(kThreads, 1)
    onepass_kernel(TrackArgs<T> p, const int* __restrict__ real,
                   const T* __restrict__ g, const T* __restrict__ wq,
                   const T* __restrict__ wak, const T* __restrict__ wav,
                   T* __restrict__ attn, int G, int H, int zero_empty) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TL = TrackCfg<T, C>::TL;
  const int rank = blockIdx.x, csize = gridDim.x, b = blockIdx.y;
  const int L = p.L, S = p.S;

  for (int t = rank; t * TL < L; t += csize)
    track_tile<T, C, SEG>(p, b, t * TL, smem);

  __threadfence();
  cooperative_groups::this_cluster().sync();

  const SegmentMask mask{SEG ? p.seg + size_t(b) * L : nullptr,
                         real + size_t(b) * L};
  for (int h = rank; h < H; h += csize)
    attention_head<T, VD>(p.out + size_t(b) * L * C, g + size_t(b) * S * G,
                          wq, wak, wav, attn + size_t(b) * S * G, L, C, G, S,
                          h, zero_empty, mask, smem);
}

template <typename T, int C, int VD, bool SEG>
cudaError_t launch_onepass(const TrackArgs<T>& p, const void* real,
                           const void* g, const void* wq, const void* wak,
                           const void* wav, void* attn, int B, int G, int H,
                           int zero_empty, cudaStream_t stream) {
  const size_t track = TrackSmem<T, C, SEG>::total;
  const size_t heads = AttnSmem<T, VD>::total(p.L, p.S);
  const size_t smem = track > heads ? track : heads;
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = onepass_kernel<T, C, VD, SEG>;
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
                         static_cast<const T*>(g), static_cast<const T*>(wq),
                         static_cast<const T*>(wak),
                         static_cast<const T*>(wav), static_cast<T*>(attn), G,
                         H, zero_empty);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int C, int VD>
cudaError_t launch_seg(int seg_masked, const TrackArgs<T>& p,
                       const void* real, const void* g, const void* wq,
                       const void* wak, const void* wav, void* attn, int B,
                       int G, int H, int zero_empty, cudaStream_t stream) {
  if (seg_masked)
    return launch_onepass<T, C, VD, true>(p, real, g, wq, wak, wav, attn, B,
                                          G, H, zero_empty, stream);
  return launch_onepass<T, C, VD, false>(p, real, g, wq, wak, wav, attn, B,
                                         G, H, zero_empty, stream);
}

template <typename T>
cudaError_t launch_shape(int C, int VD, int seg_masked, const TrackArgs<T>& p,
                         const void* real, const void* g, const void* wq,
                         const void* wak, const void* wav, void* attn, int B,
                         int G, int H, int zero_empty, cudaStream_t stream) {
  if (C == 128 && VD == 64)
    return launch_seg<T, 128, 64>(seg_masked, p, real, g, wq, wak, wav, attn,
                                  B, G, H, zero_empty, stream);
  if (C == 128 && VD == 128)
    return launch_seg<T, 128, 128>(seg_masked, p, real, g, wq, wak, wav,
                                   attn, B, G, H, zero_empty, stream);
  if (C == 256 && VD == 64)
    return launch_seg<T, 256, 64>(seg_masked, p, real, g, wq, wak, wav, attn,
                                  B, G, H, zero_empty, stream);
  if (C == 256 && VD == 128)
    return launch_seg<T, 256, 128>(seg_masked, p, real, g, wq, wak, wav,
                                   attn, B, G, H, zero_empty, stream);
  // C = 512 in bf16 only: the one-pass rule never admits float32 there
  // (19*C^2 float32 weights alone are 19.9 MB against its 13 MiB).
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (C == 512 && VD == 64)
      return launch_seg<T, 512, 64>(seg_masked, p, real, g, wq, wak, wav,
                                    attn, B, G, H, zero_empty, stream);
    if (C == 512 && VD == 128)
      return launch_seg<T, 512, 128>(seg_masked, p, real, g, wq, wak, wav,
                                     attn, B, G, H, zero_empty, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace pbt

// dtype: 0 = float32, 1 = bfloat16 (x, bcast (B, S, C), g (B, S, G), conv,
// dense and attention weights, both outputs); seg (B, L) int32 for packed
// rows (seg_masked = 1; null for dense rows, where S must be 1); real
// (B, L) int32, nonzero at positions the attention may see; biases and LN
// vectors float32. key_dim is 64 and value_dim G / H is 64 or 128; C is 128
// or 256, or 512 in bfloat16. Outputs: local (B, L, C), attn (B, S, G). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int pbt_onepass(int dtype, int seg_masked, const void* x,
                           const void* seg, const void* real,
                           const void* bcast, const void* g, const void* nk,
                           const void* nb, const void* wk, const void* wb,
                           const void* s1, const void* b1, const void* dk,
                           const void* db, const void* s2, const void* b2,
                           const void* wq, const void* wak, const void* wav,
                           void* local, void* attn, int B, int L, int C,
                           int G, int S, int H, int wide_dilation,
                           int zero_empty, void* stream) {
  if (!pbt::track_geometry_ok(B, L, S, wide_dilation) || S > pbt::kMaxS ||
      H < 1 || G % H || (seg_masked ? seg == nullptr : S != 1))
    return cudaErrorInvalidValue;
  const int VD = G / H;
  const void* seg_ptr = seg_masked ? seg : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pbt::launch_shape<float>(
        C, VD, seg_masked,
        pbt::track_args<float>(x, seg_ptr, bcast, nk, nb, wk, wb, s1, b1, dk,
                               db, s2, b2, local, L, S, wide_dilation),
        real, g, wq, wak, wav, attn, B, G, H, zero_empty, s);
  if (dtype == 1)
    return pbt::launch_shape<__nv_bfloat16>(
        C, VD, seg_masked,
        pbt::track_args<__nv_bfloat16>(x, seg_ptr, bcast, nk, nb, wk, wb, s1,
                                       b1, dk, db, s2, b2, local, L, S,
                                       wide_dilation),
        real, g, wq, wak, wav, attn, B, G, H, zero_empty, s);
  return cudaErrorInvalidValue;
}
