// Kernel #6 — the one-pass trunk of one ProteinBERT block: the local track
// and the global attention in ONE C call, for Hopper (sm_90a).
//
// Replaces the TPU kernel proteinbert_tpu/kernels/one_pass.py
// `_onepass_kernel` (one_pass.py:225-288, launched at :380 by
// `_pallas_onepass_forward`), its floating-point leg. bfloat16 runs the
// passes of one_pass_sm90.cuh (query and mask ids, then the wgmma + TMA
// conv, finish and projection passes, softmax), float32 the 8-CTA cluster
// plan of one_pass.cuh; both files state the bound and the design.

#include "one_pass.cuh"
#include "one_pass_sm90.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, bcast (B, S, C), g (B, S, G), conv,
// dense and attention weights, both outputs); seg (B, L) int32 for packed
// rows (seg_masked = 1; null for dense rows, where S must be 1); real
// (B, L) int32, nonzero at positions the attention may see; biases and LN
// vectors float32. key_dim is 64 and value_dim G / H is 64 or 128; C is 128
// or 256, or 512 in bfloat16. Outputs: local (B, L, C), attn (B, S, G). In
// bfloat16 `scratch` is one buffer of `onepass_scratch`'s parts (null in
// float32), and x and every weight 16-byte aligned (TMA, 16-byte loads).
// Returns cudaGetLastError() after the last launch (0 = launched).
extern "C" int pbt_onepass(int dtype, int seg_masked, const void* x,
                           const void* seg, const void* real,
                           const void* bcast, const void* g, const void* nk,
                           const void* nb, const void* wk, const void* wb,
                           const void* s1, const void* b1, const void* dk,
                           const void* db, const void* s2, const void* b2,
                           const void* wq, const void* wak, const void* wav,
                           void* local, void* attn, void* scratch, int B,
                           int L, int C, int G, int S, int H,
                           int wide_dilation, int zero_empty,
                           void* stream) {
  if (!pbt::onepass_geometry_ok(seg_masked, seg, B, L, G, S, H,
                                wide_dilation))
    return cudaErrorInvalidValue;
  const int VD = G / H;
  const void* seg_ptr = seg_masked ? seg : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pbt::launch_shape<float, false>(
        C, VD, seg_masked,
        pbt::track_args<float>(x, seg_ptr, bcast, nk, nb, wk, wb, s1, b1, dk,
                               db, s2, b2, local, L, S, wide_dilation),
        real, g, pbt::attn_weights<float, false>(wq, wak, wav), attn, B, G,
        H, zero_empty, s);
  if (dtype == 1)
    return pbt::launch_onepass_bf16<false>(
        seg_masked,
        pbt::track_args<pbt::bf16>(x, seg_ptr, bcast, nk, nb, wk, wb, s1, b1,
                                   dk, db, s2, b2, local, L, S,
                                   wide_dilation),
        real, g, pbt::attn_weights<pbt::bf16, false>(wq, wak, wav), attn,
        scratch, B, C, G, H, zero_empty, s);
  return cudaErrorInvalidValue;
}
