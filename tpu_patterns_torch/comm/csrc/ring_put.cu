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
// Design.  A plain store kernel launched on the sending rank's device,
// on the streaming copy of stream_copy.cuh: one block a STEP (16 KB)
// piece of the shard, the grid sized from the bytes (no grid-stride
// loop, no SM count), each thread's 16-byte loads all issued before its
// stores; the last block also takes the byte tail (dtypes narrower than
// 4 bytes leave a tail of a few bytes), and a source and destination
// that differ in alignment mod 16 go a byte at a time.  The destination
// may live on another card with peer access enabled; its stores then go
// over the link.  K8's bulk copies (bulk_copy.cuh) are not used: whether
// a bulk shared->global store may target a peer card's memory is not
// verified.  The semaphores become stream order: on one card the
// receiver's next use is queued behind the launch on the same stream;
// across cards the caller records an event after the launch that the
// receiver's stream waits on.

#include <cuda_runtime.h>

#include "stream_copy.cuh"

namespace ring {

// The n_bytes shard as one tile of `per` pieces.
__global__ void __launch_bounds__(stream_copy::THREADS)
    ring_put_kernel(const unsigned char* __restrict__ src,
                    unsigned char* __restrict__ dst, long long n_bytes,
                    unsigned per) {
  stream_copy::copy_piece(src, dst, n_bytes, per);
}

}  // namespace ring

extern "C" {

// The blocks K9 launches for an n_bytes shard: one a STEP piece, at
// least one; 0 for n_bytes < 1 or a grid out of reach (the smoke holds
// onesided.ring_put_pieces to it).
long long ring_put_grid(long long n_bytes) {
  return stream_copy::grid(1, n_bytes);
}

// Copy n_bytes from src (on the current device) to dst (on it, or on a
// peer whose access the current device has enabled), on `stream`.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for n_bytes < 1 or past the grid's reach.  Does not synchronize.
int ring_put(const void* src, void* dst, long long n_bytes, void* stream) {
  const long long grid = ring_put_grid(n_bytes);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  ring::ring_put_kernel<<<static_cast<unsigned>(grid), stream_copy::THREADS,
                          0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src),
      static_cast<unsigned char*>(dst), n_bytes,
      static_cast<unsigned>(grid));
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
