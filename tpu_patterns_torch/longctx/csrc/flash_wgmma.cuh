// Pieces shared by the bf16 flash kernels on wgmma with TMA loads: the
// forward (flash_attention.cu::flash_fwd_wgmma_kernel) and the backward
// (flash_attention_bwd.cu::flash_bwd_wgmma_{dq,dkv}_kernel).  Their
// building blocks (TMA, mbarriers, wgmma) are in kernels/csrc/hopper.cuh.
#pragma once

#include <math.h>

#include "../../kernels/csrc/hopper.cuh"

namespace flash {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// A product's f32 result (64 x N, N / 2 registers a thread), rounded to
// bf16, as four registers per 16 columns: the register A operand of the
// next product.  Written only once the product that last read `a` is
// done, since a product reads its register operand while it runs.
template <int N>
__device__ __forceinline__ void pack_a(const float (&f)[N / 2],
                                       uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    a[j / 2][(j % 2) * 2] = pack_bf16(f[4 * j], f[4 * j + 1]);
    a[j / 2][(j % 2) * 2 + 1] = pack_bf16(f[4 * j + 2], f[4 * j + 3]);
  }
}

// The leading k-tiles of bk keys (n in all) with a key at or before
// query position q_last: the live tiles of rows up to q_last.
__device__ __forceinline__ int live_k_tiles(int causal, long long q_last,
                                            int k_off, int stride, int bk,
                                            int n) {
  if (!causal) return n;
  const long long t =
      q_last < k_off ? 0 : (q_last - k_off) / stride / bk + 1;
  return t < n ? static_cast<int>(t) : n;
}

// -inf in a consumer thread's scores of k-tile `it` (64 x BK; its rows
// at query positions qa and qb, its columns cq + 8j + e) where the key
// lies past Lk or, causal, after the row: key c of the tile is visible
// to a row while c <= its last visible column.  A full tile wholly at
// or below the diagonal for the warpgroup's rows (the first at position
// wq_first) is left as it is.
template <int BK>
__device__ __forceinline__ void mask_keys(float (&sc)[BK / 2], int it,
                                          int Lk, int causal, int k_off,
                                          int stride, long long wq_first,
                                          long long qa, long long qb,
                                          int cq) {
  const int col0 = it * BK, cols = min(BK, Lk - col0);
  const long long k_first = k_off + static_cast<long long>(col0) * stride;
  const long long k_last =
      k_off + static_cast<long long>(col0 + cols - 1) * stride;
  if (!((causal && wq_first < k_last) || cols < BK)) return;
  auto last_col = [&](long long q_pos) {
    if (!causal) return cols - 1;
    if (q_pos < k_first) return -1;
    const long long c = (q_pos - k_first) / stride;
    return static_cast<int>(c < cols - 1 ? c : cols - 1);
  };
  const int last_a = last_col(qa) - cq, last_b = last_col(qb) - cq;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (8 * j + e > last_a) sc[4 * j + e] = -INFINITY;
      if (8 * j + e > last_b) sc[4 * j + 2 + e] = -INFINITY;
    }
}

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// bf16 [L, H, D] at `base` as a 3-D tensor map of 128-byte swizzled
// boxes [rows, 1, 64]; rows past L read as zeros
inline int tile_map(CUtensorMap* map, const void* base, int L, int H, int D,
                    int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2};
  const cuuint32_t box[3] = {64, 1, static_cast<cuuint32_t>(rows)};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash
