// Shared pieces of the f32 flash-attention kernels (flash_attention.cu,
// flash_attention_bwd.cu) for Hopper (sm_90a); the bf16 kernels' are in
// flash_wgmma.cuh.  The scalar staging and products below (load_tile,
// mm) are the f32 backward's; the f32 forward keeps its tiles in
// registers (flash_attention.cu).
//
// Layout: q/k/v/do are [L, H, D] row-major (the JAX package's layout;
// the train step folds batch into H); row statistics are [H, L] f32.
// A thread block stages tiles of one head into shared memory, each
// region 128-B aligned, rows padded by 16 B (input dtype) or 4 floats
// (f32).  The Python model of these regions is tpu_patterns_torch/
// longctx/tuning.py::smem_bytes; the *_smem_bytes entry points must
// agree with it.
//
// Products: C (f32, shared) = or += A . B over shared tiles, as scalar
// f32 FMAs: a tensor-core f32 product would be TF32, which keeps ~3
// digits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr size_t REGION_ALIGN = 128;

typedef __nv_bfloat16 bf16;

// row padding in elements: 16 bytes of the input dtype
template <typename T>
struct Pad {
  static constexpr int value = 16 / static_cast<int>(sizeof(T));
};

__host__ __device__ constexpr size_t region(size_t bytes) {
  return (bytes + REGION_ALIGN - 1) / REGION_ALIGN * REGION_ALIGN;
}

// Bump allocator over the block's dynamic shared memory.
struct Carve {
  unsigned char* p;
  __device__ explicit Carve(unsigned char* base) : p(base) {}
  template <typename U>
  __device__ U* take(size_t n) {
    U* r = reinterpret_cast<U*>(p);
    p += region(n * sizeof(U));
    return r;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

// rows [row0, row0 + rows) of head h of src [L, H, D] -> dst [rows][ld],
// 16 bytes per thread per step (D * sizeof(T) is a multiple of 16 and
// src is 16-B aligned: the wrapper checks both)
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* __restrict__ src, int row0,
                          int rows, int H, int h, int D) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int chunks = D / V;
  for (int i = threadIdx.x; i < rows * chunks; i += THREADS) {
    const int r = i / chunks, c = (i % chunks) * V;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(
            src + (static_cast<size_t>(row0 + r) * H + h) * D + c);
  }
}

// rows [row0, row0 + rows) of head h of a [H, L] f32 statistic
__device__ inline void load_row_stat(float* dst, const float* __restrict__ src,
                                     int row0, int rows, int L, int h) {
  for (int r = threadIdx.x; r < rows; r += THREADS)
    dst[r] = src[static_cast<size_t>(h) * L + row0 + r];
}

// A(i, k): A_T ? A[k * lda + i] : A[i * lda + k]   (M x K)
// B(k, j): B_T ? B[j * ldb + k] : B[k * ldb + j]   (K x N)
// C[i * ldc + j] (+)= sum_k A(i, k) B(k, j); M, N multiples of 4.
// Each 4 x 4 output tile belongs to one thread, so the sums are
// deterministic.  The caller syncs after.
template <bool A_T, bool B_T>
__device__ void mm_scalar(const float* A, int lda, const float* B, int ldb,
                          float* C, int ldc, int M, int N, int K,
                          bool accumulate) {
  const int tn = N / 4;
  const int tiles = (M / 4) * tn;
  for (int t = threadIdx.x; t < tiles; t += THREADS) {
    const int i0 = (t / tn) * 4, j0 = (t % tn) * 4;
    float c[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[i][j] = accumulate ? C[(i0 + i) * ldc + j0 + j] : 0.f;
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = A_T ? A[k * lda + i0 + i] : A[(i0 + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = B_T ? B[(j0 + j) * ldb + k] : B[k * ldb + j0 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(i0 + i) * ldc + j0 + j] = c[i][j];
  }
}

template <bool A_T, bool B_T>
__device__ __forceinline__ void mm(const float* A, int lda, const float* B,
                                   int ldb, float* C, int ldc, int M, int N,
                                   int K, bool accumulate) {
  mm_scalar<A_T, B_T>(A, lda, B, ldb, C, ldc, M, N, K, accumulate);
}

// Shared-memory bytes of each kernel, region by region in carve order
// (see the kernels and tuning.py::smem_bytes).  The forward
// (flash_attention.cu::flash_fwd_f32_kernel): q [bq][D + 4], k
// [bk][D + 4], v [bk][D], P^T [bk][bq + 4] and two [bk / 32][bq] row
// exchanges (max, sum: one row of each a warp that shares the rows),
// all f32.
__host__ __device__ constexpr size_t smem_fwd(int bq, int bk, int D) {
  return region(static_cast<size_t>(bq) * (D + 4) * 4) +
         region(static_cast<size_t>(bk) * (D + 4) * 4) +
         region(static_cast<size_t>(bk) * D * 4) +
         region(static_cast<size_t>(bk) * (bq + 4) * 4) +
         2 * region(static_cast<size_t>(bk / 32) * bq * 4);
}

inline size_t smem_dq(int ib, int bq, int bk, int D) {
  const size_t ldt = D + 16 / ib, lds = bk + 4, ldp = bk + 16 / ib,
               lda = D + 4;
  return 2 * region(bq * ldt * ib) + 2 * region(bk * ldt * ib) +
         2 * region(bq * lds * 4) + region(bq * ldp * ib) +
         region(bq * lda * 4) + 2 * region(bq * 4);
}

inline size_t smem_dkv(int ib, int bq, int bk, int D) {
  const size_t ldt = D + 16 / ib, lds = bk + 4, ldp = bk + 16 / ib,
               lda = D + 4;
  return 2 * region(bk * ldt * ib) + 2 * region(bq * ldt * ib) +
         2 * region(bq * lds * 4) + 2 * region(bq * ldp * ib) +
         2 * region(bk * lda * 4) + 2 * region(bq * 4);
}

// shapes the kernels take; anything else is refused before a launch
inline bool shapes_ok(int Lq, int Lk, int H, int D, int bq, int bk,
                      int stride) {
  return Lq > 0 && Lk > 0 && H > 0 && H <= 65535 && D > 0 && D % 16 == 0 &&
         bq > 0 && bk > 0 && bq % 16 == 0 && bk % 16 == 0 && Lq % bq == 0 &&
         Lk % bk == 0 && stride >= 1;
}

template <typename K>
inline int set_smem(K kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch reports its own
    return static_cast<int>(e);
  }
  return 0;
}

}  // namespace flash
