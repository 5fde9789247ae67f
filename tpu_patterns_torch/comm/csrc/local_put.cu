// One-sided local puts for Hopper (sm_90a): K8a-K8d.
//
// Replaces, in tpu_patterns/comm/onesided.py,
//   * local_put's _local_put_kernel (:88)            -> local_put_mono_kernel
//   * local_put_streamed's _copy_block_kernel (:108) -> local_put_streamed_kernel
//   * local_put_inplace's _inplace_put_kernel (:175) -> local_put_inplace_kernel
//   * local_put_multi's _multi_put_kernel (:229)     -> local_put_multi_kernel
// Each copies bytes, so it takes any dtype.
//
// What bounds them on this card: bytes.  A put reads each byte it moves
// once and writes it once and does no arithmetic, so its least time is
// 2 x the bytes moved over 3.35 TB/s (0.1127 ms for a 188.7 MB buffer;
// half that for the in-place put, which moves half the buffer).
//
// Design.  The Pallas kernels are asynchronous copies fenced by a
// semaphore wait.  Here each put is staged through shared memory by the
// bulk asynchronous copies of bulk_copy.cuh: the load completes on an
// mbarrier (the semaphore), the store in a bulk group (the closing
// wait); unaligned heads and tails go by plain byte stores.  A block's
// work is a list of segments (a Plan), and block b takes segments b,
// b + gridDim.x, ...  The four kernels differ only in the plan and the
// grid, as the four Pallas kernels differ only in their schedule:
//   * mono: one block, one segment, the whole buffer (one engine, one
//     fence); it runs on one SM of 132, so far under the bound by design;
//   * streamed: a tile of `block_rows` rows per segment, one stage per
//     tile, a grid of min(tiles, SMs) blocks walking the tiles;
//   * multi: `chunks` row slices, one block (and its own mbarriers) per
//     slice, all in flight together;
//   * inplace: `chunks` segments inside one buffer, each chunk's first
//     `half` rows to its last `half` rows (disjoint, so all in flight).
// A source and destination that differ in alignment mod 16 (a view with
// an odd offset, or an in-place shift that is not a multiple of 16
// bytes) are copied bytewise: right, and slow, for inputs the main path
// does not give.

#include "bulk_copy.cuh"

namespace put {

__global__ void __launch_bounds__(THREADS) local_put_mono_kernel(Plan p) {
  run(p, blockIdx.x, gridDim.x);
}
__global__ void __launch_bounds__(THREADS)
    local_put_streamed_kernel(Plan p) {
  run(p, blockIdx.x, gridDim.x);
}
__global__ void __launch_bounds__(THREADS) local_put_multi_kernel(Plan p) {
  run(p, blockIdx.x, gridDim.x);
}
__global__ void __launch_bounds__(THREADS)
    local_put_inplace_kernel(Plan p) {
  run(p, blockIdx.x, gridDim.x);
}

inline int launch(void (*kernel)(Plan), Plan p, long long grid,
                  void* stream) {
  if (p.n_seg < 1 || p.len < 1 || grid < 1 || grid > 0x7fffffffLL ||
      p.len > 0x7fffffffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  p.stage = stage_for(p.len);
  const size_t smem_bytes =
      static_cast<size_t>(BAR_BYTES + STAGES * p.stage);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(grid), THREADS, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace put

extern "C" {

// The largest stage in bytes: the wrapper clamps block_rows with it.
long long local_put_stage_bytes() { return put::STAGE_BYTES; }

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for an empty or oversized plan;
// none synchronizes.

// K8a: the whole buffer, n bytes, by one block.
int local_put_mono(const void* src, void* dst, long long n, void* stream) {
  put::Plan p{static_cast<const unsigned char*>(src),
              static_cast<unsigned char*>(dst), 1, n, n, 0};
  return put::launch(put::local_put_mono_kernel, p, 1, stream);
}

// K8b: n_tiles tiles of tile_bytes, over min(n_tiles, SMs) blocks.
int local_put_streamed(const void* src, void* dst, long long n_tiles,
                       long long tile_bytes, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  put::Plan p{static_cast<const unsigned char*>(src),
              static_cast<unsigned char*>(dst), n_tiles, tile_bytes,
              tile_bytes, 0};
  return put::launch(put::local_put_streamed_kernel, p,
                     n_tiles < sms ? n_tiles : sms, stream);
}

// K8c: n_chunks slices of chunk_bytes, one block each.
int local_put_multi(const void* src, void* dst, long long n_chunks,
                    long long chunk_bytes, void* stream) {
  put::Plan p{static_cast<const unsigned char*>(src),
              static_cast<unsigned char*>(dst), n_chunks, chunk_bytes,
              chunk_bytes, 0};
  return put::launch(put::local_put_multi_kernel, p, n_chunks, stream);
}

// K8d: in buf, for each of n_chunks chunks of chunk_bytes, its first
// half_bytes to `shift` bytes further on (its tail), one block each.
int local_put_inplace(void* buf, long long n_chunks, long long chunk_bytes,
                      long long half_bytes, long long shift, void* stream) {
  if (half_bytes > shift) return static_cast<int>(cudaErrorInvalidValue);
  unsigned char* b = static_cast<unsigned char*>(buf);
  put::Plan p{b, b + shift, n_chunks, chunk_bytes, half_bytes, 0};
  return put::launch(put::local_put_inplace_kernel, p, n_chunks, stream);
}

}  // extern "C"
