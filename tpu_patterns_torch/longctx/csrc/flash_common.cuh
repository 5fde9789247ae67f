// Shared pieces of the f32 flash-attention kernels (flash_attention.cu's
// forward, flash_attention_bwd.cu's dq and dk/dv) for Hopper (sm_90a);
// the bf16 kernels' are in flash_wgmma.cuh.  All of them are
// register-tiled FFMA: a tensor-core f32 product would be TF32, which
// keeps ~3 digits.
//
// Layout: q/k/v/do are [L, H, D] row-major (the JAX package's layout;
// the train step folds batch into H); row statistics are [H, L] f32.
// A thread block stages rows of one head into shared memory by 16-byte
// cp.async, each region 128-B aligned, rows padded by 4 floats so that
// the 8 rows a quarter warp reads at once fall in 8 different 16-byte
// bank groups.  The Python model of these regions is
// tpu_patterns_torch/longctx/tuning.py::smem_bytes; the *_smem_bytes
// entry points must agree with it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr size_t REGION_ALIGN = 128;

typedef __nv_bfloat16 bf16;

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

// Phase marks for scripts/flash_f32_phases.py: nothing unless it builds
// a kernel source with its header, which defines them first.
#ifndef FLASH_MARK
#define FLASH_MARK_START
#define FLASH_MARK(n)
#endif

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           uint32_t src_size) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_size)
               : "memory");
}
// one float (a row statistic); src_size 0 stores a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          uint32_t src_size) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_size)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of head h of src [L, H, D] into dst [ROWS][LD]
// by 16-byte cp.async, a row per D / 4 threads; rows past L are
// zero-filled (a src_size of 0 reads nothing).
template <int D, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int row0, int L, int H, int h) {
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  constexpr int STEP = THREADS / CPR;  // rows a pass
  static_assert(ROWS % STEP == 0, "whole passes");
  const int r0 = threadIdx.x / CPR, ch = (threadIdx.x % CPR) * 4;
  float* d = dst + r0 * LD + ch;
  const float* s = src + (static_cast<size_t>(row0 + r0) * H + h) * D + ch;
  const size_t s_step = static_cast<size_t>(STEP) * H * D;
  if (row0 + ROWS <= L) {  // the whole tile lies inside: no test a row
#pragma unroll
    for (int n = 0; n < ROWS / STEP; ++n)
      cp_async16(d + n * STEP * LD, s + n * s_step, 16u);
    return;
  }
#pragma unroll
  for (int n = 0; n < ROWS / STEP; ++n) {
    const bool in = row0 + r0 + n * STEP < L;
    cp_async16(d + n * STEP * LD, in ? s + n * s_step : src, in ? 16u : 0u);
  }
}

// Rows [0, RT) of a thread's values to shared memory as RT / 4 float4s
template <int RT>
__device__ __forceinline__ void store_rows(float* dst, const float (&x)[RT]) {
#pragma unroll
  for (int i = 0; i < RT; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
}
template <int RT>
__device__ __forceinline__ void load_rows(float (&x)[RT], const float* src) {
#pragma unroll
  for (int i = 0; i < RT; i += 4) {
    const float4 f = *reinterpret_cast<const float4*>(src + i);
    x[i] = f.x;
    x[i + 1] = f.y;
    x[i + 2] = f.z;
    x[i + 3] = f.w;
  }
}

// Shared-memory bytes of each f32 kernel, region by region in carve
// order (see the kernels and tuning.py::smem_bytes), all f32.  The
// forward (flash_attention.cu::flash_fwd_f32_kernel): q [bq][D + 4], k
// [bk][D + 4], v [bk][D], P^T [bk][bq + 4] and two [bk / 32][bq] row
// exchanges (max, sum: one row of each a warp that shares the rows).
__host__ __device__ constexpr size_t smem_fwd(int bq, int bk, int D) {
  return region(static_cast<size_t>(bq) * (D + 4) * 4) +
         region(static_cast<size_t>(bk) * (D + 4) * 4) +
         region(static_cast<size_t>(bk) * D * 4) +
         region(static_cast<size_t>(bk) * (bq + 4) * 4) +
         2 * region(static_cast<size_t>(bk / 32) * bq * 4);
}
// dq (flash_attention_bwd.cu::flash_bwd_dq_f32_kernel; it owns bq rows
// and streams bk keys): q and do [bq][D + 4], k and v [bk][D + 4], dS^T
// [bk][bq + 4].
__host__ __device__ constexpr size_t smem_dq_f32(int bq, int bk, int D) {
  return 2 * region(static_cast<size_t>(bq) * (D + 4) * 4) +
         2 * region(static_cast<size_t>(bk) * (D + 4) * 4) +
         region(static_cast<size_t>(bk) * (bq + 4) * 4);
}
// dk/dv (flash_bwd_dkv_f32_kernel; it owns bk keys and streams bq rows):
// k and v [bk][D + 4], q and do [bq][D + 4], P and dS [bq][bk + 4], the
// rows' lse and delta [bq].
__host__ __device__ constexpr size_t smem_dkv_f32(int bq, int bk, int D) {
  return 2 * region(static_cast<size_t>(bk) * (D + 4) * 4) +
         2 * region(static_cast<size_t>(bq) * (D + 4) * 4) +
         2 * region(static_cast<size_t>(bq) * (bk + 4) * 4) +
         2 * region(static_cast<size_t>(bq) * 4);
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

// set_smem, and the whole carveout to shared memory, so that an f32
// kernel's MIN_BLOCKS blocks fit an SM
template <typename K>
inline int set_smem_f32(K kernel, size_t smem) {
  if (int e = set_smem(kernel, smem)) return e;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return 0;
}

}  // namespace flash
