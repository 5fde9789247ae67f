// The one-sided ring put for Hopper (sm_90a): K9.
//
// Replaces tpu_patterns/comm/onesided.py::ring_put, body
// _ring_put_kernel (:53): each rank puts its (rows, 512) shard into the
// output buffer its +1 ring neighbour owns, an asynchronous remote copy
// fenced by a send and a receive semaphore.  It copies bytes, so it
// takes any dtype.
//
// What bounds it on this card: bytes.  Each byte is read once and
// written once, so one rank's put of the reference's 188.7 MB shard
// takes at least 2 x 188,743,680 B over 3.35 TB/s = 0.1127 ms when both
// ranks share the card (over NVLink, 450 GB/s each way, when they do
// not).
//
// Design.  A plain store kernel launched on the sending rank's device:
// a grid-stride loop of 16-byte vector loads and stores when both
// pointers are 16-byte aligned, a byte tail for what is left (dtypes
// narrower than 4 bytes leave a tail of a few bytes), and a byte loop
// for the whole put when either pointer is misaligned.  The destination
// may live on another card with peer access enabled; its stores then go
// over the link.  K8's bulk copies (bulk_copy.cuh) are not used: whether
// a bulk shared->global store may target a peer card's memory is not
// verified.  The semaphores become stream order: on one card the
// receiver's next use is queued behind the launch on the same stream;
// across cards the caller records an event after the launch that the
// receiver's stream waits on.

#include <cuda_runtime.h>

#include "grid_stride.cuh"

namespace ring {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__global__ void __launch_bounds__(THREADS)
    ring_put_kernel(const unsigned char* __restrict__ src,
                    unsigned char* __restrict__ dst, long long n_bytes,
                    int vec) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nv = n_bytes / 16;
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (long long i = tid; i < nv; i += stride) d[i] = s[i];
    done = nv * 16;
  }
  for (long long i = done + tid; i < n_bytes; i += stride) dst[i] = src[i];
}

}  // namespace ring

extern "C" {

// Copy n_bytes from src (on the current device) to dst (on it, or on a
// peer whose access the current device has enabled), on `stream`.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for n_bytes < 1.  Does not synchronize.
int ring_put(const void* src, void* dst, long long n_bytes, void* stream) {
  if (n_bytes < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = ((reinterpret_cast<unsigned long long>(src) |
                    reinterpret_cast<unsigned long long>(dst)) &
                   15) == 0;
  const int grid = grid_stride::blocks_for(
      vec ? n_bytes / 16 + 16 : n_bytes, ring::THREADS, ring::BLOCKS_PER_SM);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  ring::ring_put_kernel<<<grid, ring::THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src),
      static_cast<unsigned char*>(dst), n_bytes, vec);
  return static_cast<int>(cudaGetLastError());
}

// Let the current device read and write `peer`'s memory.  Returns 0 when
// access is enabled (already enabled counts), else the CUDA error.
int ring_put_enable_peer(int peer) {
  cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return static_cast<int>(e);
}

}  // extern "C"
