// Shared device helpers of the port's kernels (sm_90a, built by nvcc into
// plain-C shared libraries; see proteinbert_tpu_torch/kernels/build.py).
//
// Two block-level matrix-product engines with one interface, so each kernel
// is written once for both activation types:
//   MmaBf16 — bf16 operands on the tensor cores through WMMA
//             (m16n16k16, float32 accumulation);
//   MmaF32  — float32 operands with FMA on the CUDA cores, so a float32
//             run is float32 end to end (no TF32).
// Both compute acc[BM x BN] += A[BM x K] @ B[K x BN] from shared memory
// (row-major, leading dimensions lda/ldb) with 256 threads, and store the
// float32 accumulator back to shared memory row-major.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace pbt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The element type of a weight operand: the activation type T on a kernel's
// floating-point leg; int8 on its int8 leg (Q8), where float32 scales, one
// per output column (and per tap of a conv), ride beside the weights.
template <typename T, bool Q8>
using WeightT = typename std::conditional<Q8, int8_t, T>::type;

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The value a float32 takes after a cast to T and back (JAX's .astype(dtype)
// at a rounding point of the TPU kernel).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// jax.nn.gelu's default (approximate=True): the tanh form.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return x * (0.5f * (1.0f + tanhf(k0 * (x + k1 * (x * x * x)))));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------------ cp.async

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue (without committing) the copy of `rows` rows x `cols` columns of T
// into shared `dst` (leading dimension dst_ld): dst row r <- src row
// (row0 + r) of a row-major source with `src_rows` rows and leading
// dimension src_ld; rows outside [lo, hi) become zeros (lo may be negative:
// a prehaloed source carries real rows before its row 0). cols*sizeof(T),
// dst_ld*sizeof(T) and src_ld*sizeof(T) are multiples of 16 bytes.
template <typename T>
__device__ __forceinline__ void load_rows_async(T* dst, int dst_ld,
                                                const T* src, int src_ld,
                                                int row0, int rows, int cols,
                                                int lo, int hi) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = cols / kVec;
  const int total = rows * per_row;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * kVec;
    T* d = dst + r * dst_ld + c;
    const int sr = row0 + r;
    if (sr >= lo && sr < hi) {
      cp_async16(d, src + static_cast<size_t>(sr) * src_ld + c);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The int8 leg's weight tile (ROWS x COLS of an int8 matrix), staged
// through registers so that no shared memory is added: fetch() issues a
// thread's 16-byte global loads and returns at once; store() converts them,
// each value from_f<T>(float(q) * scale[c]) — q·scale in float32, then the
// cast to the activation type, bit for bit the value the floating-point leg
// loads from the dequantized weights — and writes them to the shared tile.
// Thread i takes the 16 columns (i % (COLS / 16)) * 16 of rows i / (COLS /
// 16) + k * 256 / (COLS / 16). Where 256 is a multiple of COLS / 16 its
// columns, so its 16 scales, are fixed across a matrix's tiles and scales()
// loads them once into registers; otherwise (C = 384: 24 groups a row)
// each of its kPer groups keeps its own 16. `ncols` (default COLS) is how
// many columns the source holds, a multiple of 8: a group past it loads no
// bytes and stores zeros, a group it cuts loads 8 (the float32 attention's
// 32-column blocks over a head width that is not a multiple of 32). COLS
// is a multiple of 16, src_ld and ncols of 8, and dst_ld * sizeof(T) of 16
// bytes.
template <int ROWS, int COLS>
struct Q8Tile {
  static constexpr int kPerRow = COLS / 16;
  static constexpr int kTotal = ROWS * kPerRow;
  static constexpr int kPer = (kTotal + kThreads - 1) / kThreads;
  static constexpr bool kFixedCols = kThreads % kPerRow == 0;
  static constexpr int kSets = kFixedCols ? 1 : kPer;
  static_assert(COLS % 16 == 0, "16-column groups");
  int4 raw[kPer];
  float sc[kSets][16];
  int ncols = COLS;

  __device__ __forceinline__ static int col(int u) {
    return ((threadIdx.x + u * kThreads) % kPerRow) * 16;
  }

  // The scales of the thread's columns, from a matrix's per-column scales.
  __device__ __forceinline__ void scales(const float* scale) {
#pragma unroll
    for (int u = 0; u < kSets; ++u) {
      const int c = col(u);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        sc[u][j] = c + j < ncols ? scale[c + j] : 0.f;
    }
  }

  // A group past ncols loads nothing; one that ncols cuts (ncols a
  // multiple of 8), or whose rows are not 16-byte aligned (src_ld a
  // multiple of 8 only), loads 8 bytes at a time.
  __device__ __forceinline__ void fetch(const int8_t* src, int src_ld) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < kTotal) {
        const int8_t* p = src + static_cast<size_t>(i / kPerRow) * src_ld +
                          col(u);
        if (col(u) + 16 <= ncols && src_ld % 16 == 0) {
          raw[u] = __ldg(reinterpret_cast<const int4*>(p));
        } else {
          int2 lo = make_int2(0, 0), hi = make_int2(0, 0);
          if (col(u) < ncols) lo = __ldg(reinterpret_cast<const int2*>(p));
          if (col(u) + 8 < ncols)
            hi = __ldg(reinterpret_cast<const int2*>(p + 8));
          raw[u] = make_int4(lo.x, lo.y, hi.x, hi.y);
        }
      }
    }
  }

  template <typename T>
  __device__ __forceinline__ void store(T* dst, int dst_ld) const {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < kTotal) {
        const int8_t* q = reinterpret_cast<const int8_t*>(&raw[u]);
        const float* s = sc[kFixedCols ? 0 : u];
        __align__(16) T v[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          v[j] = from_f<T>(static_cast<float>(q[j]) * s[j]);
        uint4* d = reinterpret_cast<uint4*>(dst + (i / kPerRow) * dst_ld +
                                            col(u));
#pragma unroll
        for (int j = 0; j < int(16 * sizeof(T) / 16); ++j)
          d[j] = reinterpret_cast<const uint4*>(v)[j];
      }
    }
  }
};

// One weight value read straight from device memory, as the activation type
// rounds it: q·scale then the cast on the int8 leg.
template <bool Q8, typename T>
__device__ __forceinline__ float weight_at(const WeightT<T, Q8>* w, size_t i,
                                           const float* scale, size_t si) {
  if constexpr (Q8)
    return round_to<T>(static_cast<float>(w[i]) * scale[si]);
  else
    return to_f(w[i]);
}

// Double-buffered k-loop: load(s, buf) issues (uncommitted) the copies of
// step s into buffer buf; compute(s, buf) multiplies step s's operands out
// of that buffer. Copies of step s+1 are in flight while step s computes.
// Groups committed before the call (a resident operand) complete by the
// first compute.
template <typename LoadFn, typename ComputeFn>
__device__ __forceinline__ void pipelined_steps(int steps, LoadFn load,
                                                ComputeFn compute) {
  load(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load(s + 1, (s + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute(s, s & 1);
    __syncthreads();
  }
}

// pipelined_steps for an int8 leg, whose weight tiles go through registers
// (Q8Tile): besides load(s, buf)'s cp.async copies, fetch(s) issues step s's
// weight loads into registers and store(s, buf) converts them into buffer
// buf. Step s+1's weights are fetched before step s's product and stored
// after it, into the buffer step s-1 read (free since the barrier that
// ended step s-1), so their loads overlap the product as cp.async does on
// the floating-point leg. The products and their order are unchanged.
template <typename LoadFn, typename FetchFn, typename StoreFn,
          typename ComputeFn>
__device__ __forceinline__ void pipelined_steps_staged(int steps, LoadFn load,
                                                       FetchFn fetch,
                                                       StoreFn store,
                                                       ComputeFn compute) {
  load(0, 0);
  cp_async_commit();
  fetch(0);
  store(0, 0);
  for (int s = 0; s < steps; ++s) {
    const bool next = s + 1 < steps;
    if (next) {
      load(s + 1, (s + 1) & 1);
      cp_async_commit();
      fetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute(s, s & 1);
    if (next) store(s + 1, (s + 1) & 1);
    __syncthreads();
  }
}

// ------------------------------------------------------ matrix engines

// bf16 tensor cores: warps tile the block WARPS_M x WARPS_N; each warp owns
// (BM/WARPS_M) x (BN/WARPS_N) of 16x16 accumulator fragments. Operand
// pointers must be 32-byte aligned and leading dimensions multiples of 16
// elements (WMMA's load rules).
template <int BM, int BN, int WARPS_M, int WARPS_N>
struct MmaBf16 {
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int FM = WM / 16;
  static constexpr int FN = WN / 16;
  static_assert(WARPS_M * WARPS_N == kWarps, "8 warps");
  static_assert(FM * 16 == WM && FN * 16 == WN, "16x16 fragments");

  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      acc[FM][FN];
  int wm0, wn0;

  __device__ MmaBf16() {
    const int w = threadIdx.x / 32;
    wm0 = (w / WARPS_N) * WM;
    wn0 = (w % WARPS_N) * WN;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
  }

  __device__ __forceinline__ void mma(const __nv_bfloat16* A, int lda,
                                      const __nv_bfloat16* B, int ldb,
                                      int K) {
    using namespace nvcuda;
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], A + (wm0 + 16 * i) * lda + k, lda);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], B + k * ldb + wn0 + 16 * j, ldb);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* D, int ldd) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        nvcuda::wmma::store_matrix_sync(D + (wm0 + 16 * i) * ldd + wn0 + 16 * j,
                                        acc[i][j], ldd,
                                        nvcuda::wmma::mem_row_major);
  }
};

// float32 FMA: thread (tx, ty) of a TX-wide thread grid owns rows
// ty + TY*i and columns tx + TX*j. TX >= 32 keeps a warp on one row set, so
// A reads are broadcasts and B reads hit 32 distinct banks.
template <int BM, int BN, int TX>
struct MmaF32 {
  static constexpr int TY = kThreads / TX;
  static constexpr int RM = BM / TY;
  static constexpr int CN = BN / TX;
  static_assert(TX >= 32 && RM * TY == BM && CN * TX == BN, "thread grid");

  float acc[RM][CN];
  int tx, ty;

  __device__ MmaF32() {
    tx = threadIdx.x % TX;
    ty = threadIdx.x / TX;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void mma(const float* A, int lda,
                                      const float* B, int ldb, int K) {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[RM], b[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = A[(ty + TY * i) * lda + k];
#pragma unroll
      for (int j = 0; j < CN; ++j) b[j] = B[k * ldb + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* D, int ldd) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        D[(ty + TY * i) * ldd + tx + TX * j] = acc[i][j];
  }
};

}  // namespace pbt
