// x + 1 over float32 for Hopper (sm_90a): K10.
//
// Replaces the inline Pallas kernel `kern` of tests/test_interop.py
// (:67-68, called at :72): o = x + 1.0 over a (4, 128) float32 block, the
// JAX package's proof that a kernel's output reaches C++ without a copy.
// In the port the kernel writes its output into memory the host C++ then
// reads in place: managed memory after a synchronize, or a device buffer
// staged into pinned host memory (tpu_patterns_torch/interop/calls.py).
//
// What bounds it on this card: bytes.  Each element is read once and
// written once (8 bytes) for one add, so its least time is 2 x 4 x n
// bytes over 3.35 TB/s: 0.08013 ms at 2^25 elements.  At the proof's
// (4, 128) block the launch latency bounds it.
//
// Design: a streaming tile (kernels/csrc/stream_tile.cuh, K5's), at one
// 16-byte vector a thread and 1024 threads a block: block k takes
// vectors k * 1024 + t, so a warp's loads are contiguous, the grid is
// sized from n (no SM count is read), the ragged tail of vectors is
// masked, and the last block also adds the n % 4 elements past the last
// whole vector.  K5's own tile, four vectors a thread at 256 threads,
// all loads before the first add, read 2.5% slower at 2^25 on an H100
// (scripts/torch_k10_tile_sweep.py): with one input stream, more blocks
// in flight beat more loads a thread.  When input or output is not
// 16-byte aligned (a view that starts inside a buffer) the scalar
// kernel takes the tensor, the same tile of single elements.  Loads and
// stores are ordinary ones (the streaming hint was no faster for K5).
// The add is __fadd_rn (IEEE round to nearest, never contracted), so
// the kernel equals x + 1.0 in torch bit for bit.  Input and output may
// be device or managed memory.

#include <cuda_runtime.h>

#include "../../kernels/csrc/stream_tile.cuh"

namespace add1 {

using Tile = stream_tile::Tile<1024, 1>;
constexpr int THREADS = Tile::THREADS;
constexpr int VECS = Tile::VECS;
constexpr long long TILE = Tile::TILE;

__global__ void __launch_bounds__(THREADS)
    add_one_vec_kernel(const float* __restrict__ x, float* __restrict__ o,
                       long long n) {
  const long long nv = n / 4;
  const long long v0 =
      static_cast<long long>(blockIdx.x) * (THREADS * VECS) + threadIdx.x;
  const float4* xv = reinterpret_cast<const float4*>(x);
  float4* ov = reinterpret_cast<float4*>(o);
  float4 a[VECS];
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const long long v = v0 + j * THREADS;
    if (v < nv) a[j] = xv[v];
  }
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const long long v = v0 + j * THREADS;
    if (v < nv) {
      float4 b;
      b.x = __fadd_rn(a[j].x, 1.0f);
      b.y = __fadd_rn(a[j].y, 1.0f);
      b.z = __fadd_rn(a[j].z, 1.0f);
      b.w = __fadd_rn(a[j].w, 1.0f);
      ov[v] = b;
    }
  }
  // the n % 4 elements past the last whole vector
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < n - nv * 4) {
    const long long i = nv * 4 + threadIdx.x;
    o[i] = __fadd_rn(x[i], 1.0f);
  }
}

__global__ void __launch_bounds__(THREADS)
    add_one_scalar_kernel(const float* __restrict__ x, float* __restrict__ o,
                          long long n) {
  constexpr int ELEMS = VECS * 4;
  const long long i0 =
      static_cast<long long>(blockIdx.x) * TILE + threadIdx.x;
  float a[ELEMS];
#pragma unroll
  for (int j = 0; j < ELEMS; ++j) {
    const long long i = i0 + j * THREADS;
    if (i < n) a[j] = x[i];
  }
#pragma unroll
  for (int j = 0; j < ELEMS; ++j) {
    const long long i = i0 + j * THREADS;
    if (i < n) o[i] = __fadd_rn(a[j], 1.0f);
  }
}

}  // namespace add1

extern "C" {

// The blocks K10 launches over n elements, vec 1 on the vector path and
// 0 on the scalar one (the smoke holds interop.kernel.tile_grid to
// it).
long long add_one_grid(long long n, int vec) {
  return add1::Tile::grid(n, vec != 0);
}

// out = x + 1 over n float32 elements, on `stream` of the current device.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// n < 1 or n past the grid's reach.  Does not synchronize.
int add_one(const void* x, void* out, long long n, void* stream) {
  if (n < 1 || n / add1::TILE >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = ((reinterpret_cast<unsigned long long>(x) |
                     reinterpret_cast<unsigned long long>(out)) &
                    15) == 0;
  const unsigned grid = static_cast<unsigned>(add1::Tile::grid(n, vec));
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    add1::add_one_vec_kernel<<<grid, add1::THREADS, 0, s>>>(xf, of, n);
  else
    add1::add_one_scalar_kernel<<<grid, add1::THREADS, 0, s>>>(xf, of, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
