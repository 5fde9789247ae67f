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
// semaphore wait.  Here mono, multi and inplace are staged through
// shared memory by the bulk asynchronous copies of bulk_copy.cuh: the
// load completes on an mbarrier (the semaphore), the store in a bulk
// group (the closing wait); unaligned heads and tails go by plain byte
// stores.  A block's work is a list of segments (a Plan), and block b
// takes segments b, b + gridDim.x, ...  The streamed put instead streams
// its tiles through registers (stream_copy.cuh), its fence the end of
// the launch.  The four kernels differ in their plan and grid, as the
// four Pallas kernels differ only in their schedule:
//   * mono: one put of the whole buffer in one launch, whose end is the
//     one fence.  On a TPU that is one DMA engine; on this card the
//     engine of a device-to-device copy inside a kernel is the SMs, so
//     the put is spread over all of them: the buffer is cut into one
//     contiguous span per block, a multiple of 16 bytes long (so every
//     span starts 16-byte aligned when the buffer does), the last one
//     ragged and shorter by less than one stage (mono_span below; a
//     span of at least MONO_MIN_SPAN, so a small buffer takes fewer
//     blocks), and each block streams its span through its stage ring:
//     112 KB in flight per SM, over the ~25 KB that 3.35 TB/s times a
//     microsecond of latency needs;
//   * streamed: tiles of `block_rows` rows (the wrapper clamps a tile
//     to at most STAGE_BYTES: 48 rows of 2 KB, 1,920 tiles, at the full
//     buffer), each cut into stream_copy::STEP (16 KB) pieces, its last
//     ragged, one block a piece (11,520 at the full buffer;
//     stream_copy.cuh's copy_piece).  A block holds no shared memory, so
//     eight share an SM, and blocks go to SMs as SMs free up: no last
//     round runs on part of the card;
//   * multi: `chunks` row slices, all in flight together in one
//     launch.  A block a slice would use `chunks` SMs of 132 (8 at the
//     default), so each slice is cut by mono's rule into
//     max(1, SMs / chunks) spans (multi_span below): 16 blocks a slice,
//     128 in all, at 8 chunks on 132 SMs, each streaming its span
//     through its own stage ring and mbarriers;
//   * inplace: in each of `chunks` chunks of one buffer, its first
//     `half` rows copied to its last `half` rows.  Each chunk's half is
//     cut by multi's rule (multi_span of the half bytes): 16 spans a
//     chunk, 128 blocks in all, at 8 chunks on 132 SMs, through the same
//     ChunkPlan as multi with the destination `shift` bytes after the
//     source.  In place and still all in flight: a chunk's source (its
//     first half rows) and destination (its last half rows) are disjoint,
//     since half <= chunk_rows - half, and chunks are disjoint, so no
//     block reads what another writes.  Its bound is half the others':
//     it moves half the buffer (0.05634 ms at 188.7 MB).
// A source and destination that differ in alignment mod 16 (a view with
// an odd offset, or an in-place shift that is not a multiple of 16
// bytes) are copied bytewise: right, and slow, for inputs the main path
// does not give.

#include "bulk_copy.cuh"
#include "stream_copy.cuh"

namespace put {

__global__ void __launch_bounds__(THREADS) local_put_mono_kernel(Plan p) {
  run(p, blockIdx.x, gridDim.x);
}
__global__ void __launch_bounds__(stream_copy::THREADS)
    local_put_streamed_kernel(const unsigned char* __restrict__ src,
                              unsigned char* __restrict__ dst,
                              long long tile_bytes, unsigned per) {
  stream_copy::copy_piece(src, dst, tile_bytes, per);
}
__global__ void __launch_bounds__(THREADS)
    local_put_multi_kernel(ChunkPlan p) {
  run(p, blockIdx.x, gridDim.x);
}
__global__ void __launch_bounds__(THREADS)
    local_put_inplace_kernel(ChunkPlan p) {
  run(p, blockIdx.x, gridDim.x);
}

// Smallest mono span: below 132 of these the put takes fewer blocks.
constexpr long long MONO_MIN_SPAN = 16 * 1024;

// The mono span for n bytes over `sms` SMs: n over min(sms, ceil(n /
// MONO_MIN_SPAN)) blocks, rounded up to 16 bytes.  The put takes
// ceil(n / span) blocks; the last span is n - (blocks - 1) * span.
inline long long mono_span(long long n, long long sms) {
  long long blocks = (n + MONO_MIN_SPAN - 1) / MONO_MIN_SPAN;
  if (blocks > sms) blocks = sms;
  if (blocks < 1) blocks = 1;
  const long long span = (n + blocks - 1) / blocks;
  return (span + 15) & ~15LL;
}

// The multi span for chunks of `chunk` bytes: mono's span for one
// chunk over max(1, sms / chunks) blocks.  A chunk takes ceil(chunk /
// span) blocks, its last span chunk - (blocks - 1) * span bytes.
inline long long multi_span(long long chunk, long long chunks,
                            long long sms) {
  const long long share = chunks > 0 && sms / chunks > 1 ? sms / chunks : 1;
  return mono_span(chunk, share);
}

inline int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

template <class P>
inline int launch(void (*kernel)(P), P p, long long grid, void* stream) {
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

// The first `len` bytes of each of n_chunks chunks, chunks `chunk`
// bytes apart, from src to dst: each cut into multi spans, one block a
// span (K8c and K8d, each through its own kernel name).
inline int chunk_put(void (*kernel)(ChunkPlan), const unsigned char* src,
                     unsigned char* dst, long long n_chunks, long long chunk,
                     long long len, void* stream) {
  int sms = 0;
  if (int e = sm_count(&sms)) return e;
  if (n_chunks < 1 || len < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long span = multi_span(len, n_chunks, sms);
  const long long per = (len + span - 1) / span;
  ChunkPlan p{{src, dst, n_chunks * per, span, span, 0,
               len - (per - 1) * span},
              per, chunk};
  return launch(kernel, p, n_chunks * per, stream);
}

}  // namespace put

extern "C" {

// The largest stage in bytes: the wrapper clamps block_rows with it.
long long local_put_stage_bytes() { return put::STAGE_BYTES; }

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for an empty or oversized plan;
// none synchronizes.

// The mono span for n bytes over `sms` SMs (tests hold the wrapper's
// Python mirror, onesided.mono_spans, to it).
long long local_put_mono_span(long long n, long long sms) {
  return put::mono_span(n, sms);
}

// The multi span for n_chunks chunks of chunk_bytes over `sms` SMs (the
// smoke holds onesided.multi_spans to it).  With the half bytes of each
// chunk, it is the in-place put's span too (onesided.inplace_spans).
long long local_put_multi_span(long long chunk_bytes, long long n_chunks,
                               long long sms) {
  return put::multi_span(chunk_bytes, n_chunks, sms);
}

// K8a: the whole buffer, n bytes, one span per block over every SM.
int local_put_mono(const void* src, void* dst, long long n, void* stream) {
  int sms = 0;
  if (int e = put::sm_count(&sms)) return e;
  const long long span = put::mono_span(n, sms);
  const long long blocks = (n + span - 1) / span;
  put::Plan p{static_cast<const unsigned char*>(src),
              static_cast<unsigned char*>(dst), blocks, span, span, 0,
              n - (blocks - 1) * span};
  return put::launch(put::local_put_mono_kernel, p, blocks, stream);
}

// The blocks K8b launches for n_tiles tiles of tile_bytes: one a piece
// of a tile, or 0 for an empty plan or a grid out of reach (the smoke
// holds onesided.streamed_pieces to it).
long long local_put_streamed_grid(long long n_tiles, long long tile_bytes) {
  return stream_copy::grid(n_tiles, tile_bytes);
}

// K8b: n_tiles tiles of tile_bytes, one block a piece of a tile.
int local_put_streamed(const void* src, void* dst, long long n_tiles,
                       long long tile_bytes, void* stream) {
  const long long grid = local_put_streamed_grid(n_tiles, tile_bytes);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  put::local_put_streamed_kernel<<<static_cast<unsigned>(grid),
                                   stream_copy::THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src),
      static_cast<unsigned char*>(dst), tile_bytes,
      static_cast<unsigned>(stream_copy::pieces(tile_bytes)));
  return static_cast<int>(cudaGetLastError());
}

// K8c: n_chunks slices of chunk_bytes, each cut into multi spans, one
// block a span.
int local_put_multi(const void* src, void* dst, long long n_chunks,
                    long long chunk_bytes, void* stream) {
  if (chunk_bytes < 1) return static_cast<int>(cudaErrorInvalidValue);
  return put::chunk_put(put::local_put_multi_kernel,
                        static_cast<const unsigned char*>(src),
                        static_cast<unsigned char*>(dst), n_chunks,
                        chunk_bytes, chunk_bytes, stream);
}

// K8d: in buf, for each of n_chunks chunks of chunk_bytes, its first
// half_bytes to `shift` bytes further on (its tail), each half cut into
// multi spans, one block a span.
int local_put_inplace(void* buf, long long n_chunks, long long chunk_bytes,
                      long long half_bytes, long long shift, void* stream) {
  if (half_bytes > shift || shift + half_bytes > chunk_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned char* b = static_cast<unsigned char*>(buf);
  return put::chunk_put(put::local_put_inplace_kernel, b, b + shift,
                        n_chunks, chunk_bytes, half_bytes, stream);
}

}  // extern "C"
