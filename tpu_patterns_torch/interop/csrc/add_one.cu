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
// Design.  A grid-stride loop over 16-byte vectors (four elements) when
// input and output are both 16-byte aligned, then a scalar tail; a
// misaligned operand (a view that starts inside a buffer) takes the
// scalar loop for the whole tensor.  The grid is sized to fill the SMs
// (comm/csrc/grid_stride.cuh).  The add is __fadd_rn (IEEE round to
// nearest, never contracted), so the kernel equals x + 1.0 in torch bit
// for bit.  Input and output may be device or managed memory.

#include <cuda_runtime.h>

#include "../../comm/csrc/grid_stride.cuh"

namespace add1 {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__global__ void __launch_bounds__(THREADS)
    add_one_kernel(const float* x, float* o, long long n, int vec) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / 4;
    const float4* xv = reinterpret_cast<const float4*>(x);
    float4* ov = reinterpret_cast<float4*>(o);
    for (long long i = tid; i < nv; i += stride) {
      const float4 a = xv[i];
      float4 b;
      b.x = __fadd_rn(a.x, 1.0f);
      b.y = __fadd_rn(a.y, 1.0f);
      b.z = __fadd_rn(a.z, 1.0f);
      b.w = __fadd_rn(a.w, 1.0f);
      ov[i] = b;
    }
    done = nv * 4;
  }
  for (long long i = done + tid; i < n; i += stride)
    o[i] = __fadd_rn(x[i], 1.0f);
}

}  // namespace add1

extern "C" {

// out = x + 1 over n float32 elements, on `stream` of the current device.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// n < 1 or a device that cannot be queried.  Does not synchronize.
int add_one(const void* x, void* out, long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = ((reinterpret_cast<unsigned long long>(x) |
                    reinterpret_cast<unsigned long long>(out)) &
                   15) == 0;
  const int grid = grid_stride::blocks_for(vec ? n / 4 + 4 : n,
                                           add1::THREADS,
                                           add1::BLOCKS_PER_SM);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  add1::add_one_kernel<<<grid, add1::THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
