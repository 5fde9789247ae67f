// The grid of a grid-stride kernel: one block per `threads` items, at
// most `blocks_per_sm` blocks on each SM of the current device (the SM
// count is read once per device).  The grid of the interop kernel
// (interop/csrc/add_one.cu).
#pragma once

#include <cuda_runtime.h>

namespace grid_stride {

constexpr int MAX_DEVICES = 64;

// Blocks for `items` work items, >= 1; -1 when the device cannot be
// queried.
inline int blocks_for(long long items, int threads, int blocks_per_sm) {
  static int sms[MAX_DEVICES] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return -1;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return -1;
  long long grid = (items + threads - 1) / threads;
  const long long cap = static_cast<long long>(sms[dev]) * blocks_per_sm;
  if (grid > cap) grid = cap;
  return static_cast<int>(grid < 1 ? 1 : grid);
}

}  // namespace grid_stride
