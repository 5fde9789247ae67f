// Shared pieces of the flash-attention kernels (flash_attention.cu,
// flash_attention_bwd.cu) for Hopper (sm_90a).
//
// Layout: q/k/v/do are [L, H, D] row-major (the JAX package's layout;
// the train step folds batch into H); row statistics are [H, L] f32.
// A thread block stages tiles of one head into shared memory, each
// region 128-B aligned, rows padded by 16 B (input dtype) or 4 floats
// (f32) so tensor-core fragment loads spread over the banks.  The
// Python model of these regions is tpu_patterns_torch/longctx/tuning.py
// ::smem_bytes; the *_smem_bytes entry points below must agree with it.
//
// Products: C (f32, shared) = or += A . B over shared tiles.  bf16
// inputs run them on the tensor cores through WMMA (16x16x16 bf16
// fragments, f32 accumulate: the products of bf16 values are exact and
// sum in f32, as the Pallas kernels' dots with
// preferred_element_type=f32).  f32 inputs run scalar f32 FMAs: a
// tensor-core f32 product would be TF32, which keeps ~3 digits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

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

__host__ __device__ inline size_t region(size_t bytes) {
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
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
// C[i * ldc + j] (+)= sum_k A(i, k) B(k, j); M, N, K multiples of 16.
// Each output tile belongs to one warp (tensor cores) or one thread
// (scalar), so the sums are deterministic.  The caller syncs after.
template <bool A_T, bool B_T>
__device__ void mm_tc(const bf16* A, int lda, const bf16* B, int ldb, float* C,
                      int ldc, int M, int N, int K, bool accumulate) {
  using namespace nvcuda;
  typedef typename std::conditional<A_T, wmma::col_major,
                                    wmma::row_major>::type LA;
  typedef typename std::conditional<B_T, wmma::col_major,
                                    wmma::row_major>::type LB;
  const int warp = threadIdx.x >> 5;
  const int tn = N / 16;
  const int tiles = (M / 16) * tn;
  for (int t = warp; t < tiles; t += WARPS) {
    const int i0 = (t / tn) * 16, j0 = (t % tn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (accumulate)
      wmma::load_matrix_sync(c, C + i0 * ldc + j0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
      wmma::load_matrix_sync(a, A_T ? A + k0 * lda + i0 : A + i0 * lda + k0,
                             lda);
      wmma::load_matrix_sync(b, B_T ? B + j0 * ldb + k0 : B + k0 * ldb + j0,
                             ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(C + i0 * ldc + j0, c, ldc, wmma::mem_row_major);
  }
}

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

template <bool A_T, bool B_T, typename T>
__device__ __forceinline__ void mm(const T* A, int lda, const T* B, int ldb,
                                   float* C, int ldc, int M, int N, int K,
                                   bool accumulate) {
  if constexpr (std::is_same<T, bf16>::value)
    mm_tc<A_T, B_T>(A, lda, B, ldb, C, ldc, M, N, K, accumulate);
  else
    mm_scalar<A_T, B_T>(A, lda, B, ldb, C, ldc, M, N, K, accumulate);
}

// Shared-memory bytes of each kernel, region by region in carve order
// (see the kernels and tuning.py::smem_bytes).
inline size_t smem_fwd(int ib, int bq, int bk, int D) {
  const size_t ldt = D + 16 / ib, lds = bk + 4, ldp = bk + 16 / ib,
               lda = D + 4;
  return region(bq * ldt * ib) + 2 * region(bk * ldt * ib) +
         region(bq * lds * 4) + region(bq * ldp * ib) + region(bq * lda * 4) +
         3 * region(bq * 4);
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
