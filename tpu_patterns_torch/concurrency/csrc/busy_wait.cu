// The busy-wait kernel for Hopper (sm_90a): K6.
//
// Replaces tpu_patterns/concurrency/kernels.py::busy_wait_pallas, body
// _busy_wait_kernel (:49): 64 x tripcount dependent FMAs per float32
// element, x <- fma(x, 0.999999, 1e-6), the compute command `C` of the
// concurrency suite.
//
// What bounds it on this card: operations, 2 x 64 x tripcount flops per
// element over 67 TFLOP/s of f32 (0.0783 ms for 1024 elements at 40,000
// trips).  No kernel reaches that at the suite's 1024 elements: each
// element is one chain of 2,560,000 dependent FMAs, so the time is the
// chain's latency (~4 cycles an FMA, ~5.2 ms at 1.98 GHz), and the 32
// warps fill a few of the card's 528 schedulers.  That is the workload's
// purpose: a device busy for a time linear in tripcount.
//
// Design.  One thread per element, a grid over the elements; the chain
// (busy_wait.cuh) runs in registers, one load and one store each.

#include <cuda_runtime.h>

#include "busy_wait.cuh"

namespace busy {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    busy_wait_kernel(const float* __restrict__ x, float* __restrict__ y,
                     long long n, long long tripcount, float a, float b) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) y[i] = chain(x[i], tripcount, a, b);
}

}  // namespace busy

extern "C" {

// y[i] = the chain of x[i], for n float32 elements, on `stream`.  Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// negative size or tripcount or a grid past the card's limit.  Does not
// synchronize.
int busy_wait(const void* x, void* y, long long n, long long tripcount,
              float a, float b, void* stream) {
  const long long grid = (n + busy::THREADS - 1) / busy::THREADS;
  if (n < 1 || tripcount < 0 || grid > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  busy::busy_wait_kernel<<<static_cast<unsigned>(grid), busy::THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n, tripcount, a,
      b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
