// The busy-wait FMA chain, shared by K6 (busy_wait.cu) and the compute
// blocks of K7 (dma_compute.cu).
//
// One element's chain: tripcount x 64 dependent x <- fma(x, a, b), each
// rounded once to float32 (__fmaf_rn), as XLA contracts the reference's
// `x * _A + _B` (tpu_patterns/concurrency/kernels.py:35-37).  The
// intrinsic pins the rounding: no nvcc contraction flag can turn it into
// a multiply and an add rounded twice.  a and b arrive at run time, so
// nothing folds.
#pragma once

namespace busy {

constexpr int FMAS_PER_TRIP = 64;  // the MAD_64 ladder

__device__ __forceinline__ float chain(float x, long long tripcount, float a,
                                       float b) {
  for (long long t = 0; t < tripcount; ++t) {
#pragma unroll
    for (int i = 0; i < FMAS_PER_TRIP; ++i) x = __fmaf_rn(x, a, b);
  }
  return x;
}

}  // namespace busy
