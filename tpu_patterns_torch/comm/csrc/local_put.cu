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
// semaphore wait.  Hopper has no global->global copy inside a kernel,
// so each put is staged through shared memory by the bulk asynchronous
// copy (the TMA unit without a tensor map): cp.async.bulk global->shared
// completing on an mbarrier (the semaphore), then cp.async.bulk
// shared->global in a bulk group (the closing wait).  One thread of a
// block issues every copy; the block holds a ring of STAGES = 2 stages,
// so the load of piece k+1 is in flight while piece k is stored.
//
// A block's work is a list of segments (a Plan): segment g copies `len`
// bytes from src + g*stride to dst + g*stride, and block b takes
// segments b, b + gridDim.x, ...  Each segment is cut into pieces of at
// most one stage.  The four kernels differ only in the plan and the grid,
// as the four Pallas kernels differ only in their schedule:
//   * mono: one block, one segment, the whole buffer (one engine, one
//     fence); it runs on one SM of 132, so far under the bound by design;
//   * streamed: a tile of `block_rows` rows per segment, one stage per
//     tile, a grid of min(tiles, SMs) blocks walking the tiles;
//   * multi: `chunks` row slices, one block (and its own mbarriers) per
//     slice, all in flight together;
//   * inplace: `chunks` segments inside one buffer, each chunk's first
//     `half` rows to its last `half` rows (disjoint, so all in flight).
//
// Alignment.  Bulk copies need 16-byte addresses and sizes.  Each
// segment's unaligned head and tail (< 16 bytes each) are copied by the
// block's threads with plain byte loads and stores.  If the source and
// destination differ in alignment mod 16 (a view with an odd offset, or
// an in-place shift that is not a multiple of 16 bytes), no byte pairing
// allows bulk copies, and the threads copy the whole segment bytewise:
// right, and slow, for inputs the main path does not give.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace put {

constexpr int THREADS = 128;
constexpr int STAGES = 2;
// Largest stage: two of them and the barriers fit in the 227 KB
// (232,448 B) of shared memory a block may use.  A multiple of 16.
constexpr long long STAGE_BYTES = 112 * 1024;
constexpr long long BAR_BYTES = 128;  // the mbarriers, before the stages

struct Plan {
  const unsigned char* src;
  unsigned char* dst;
  long long n_seg, stride, len, stage;
};

// A segment's head (to 16-byte alignment), bulk body and tail.
struct Span {
  const unsigned char* s;
  unsigned char* d;
  long long head, body, tail;
};

__device__ __forceinline__ Span span_of(const Plan& p, long long g) {
  Span r;
  r.s = p.src + g * p.stride;
  r.d = p.dst + g * p.stride;
  long long head = (16 - (reinterpret_cast<uintptr_t>(r.s) & 15)) & 15;
  r.head = head < p.len ? head : p.len;
  r.body = (p.len - r.head) & ~15LL;
  r.tail = p.len - r.head - r.body;
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

extern __shared__ __align__(128) unsigned char smem[];

// Thread 0: every piece of the block's segments through the stage ring.
__device__ void stream_pieces(const Plan& p) {
  const long long mine =
      (p.n_seg - blockIdx.x + gridDim.x - 1) / gridDim.x;  // segments
  const long long per = (p.len + p.stage - 1) / p.stage;  // pieces each
  const long long total = mine * per;
  uint32_t bar[STAGES], buf[STAGES];
  for (int s = 0; s < STAGES; ++s) {
    bar[s] = smem_addr(smem + 8 * s);
    buf[s] = smem_addr(smem + BAR_BYTES + s * p.stage);
  }
  // piece k: bytes (0 for an empty last piece), source and destination
  auto piece = [&](long long k, const unsigned char** s, unsigned char** d) {
    const Span sp = span_of(p, blockIdx.x + (k / per) * gridDim.x);
    const long long off = (k % per) * p.stage;
    *s = sp.s + sp.head + off;
    *d = sp.d + sp.head + off;
    const long long n = sp.body - off;
    return static_cast<uint32_t>(n <= 0 ? 0 : (n < p.stage ? n : p.stage));
  };
  auto load = [&](long long k) {
    const int st = static_cast<int>(k % STAGES);
    const unsigned char* s;
    unsigned char* d;
    const uint32_t n = piece(k, &s, &d);
    if (n) {
      bar_expect(bar[st], n);
      bulk_load(buf[st], s, n, bar[st]);
    } else {
      bar_arrive(bar[st]);  // the phase still completes
    }
  };
  for (long long k = 0; k < total && k < STAGES; ++k) load(k);
  for (long long k = 0; k < total; ++k) {
    const int st = static_cast<int>(k % STAGES);
    bar_wait(bar[st], static_cast<uint32_t>((k / STAGES) & 1));
    const unsigned char* s;
    unsigned char* d;
    const uint32_t n = piece(k, &s, &d);
    if (n) bulk_store(d, buf[st], n);
    if (k + STAGES < total) {
      // the stage is loaded again only once its store has read it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      load(k + STAGES);
    }
  }
  // every store written before the block (and its shared memory) ends
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void run(const Plan& p) {
  const bool bulk = ((reinterpret_cast<uintptr_t>(p.src) -
                      reinterpret_cast<uintptr_t>(p.dst)) &
                     15) == 0;
  if (bulk && threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) bar_init(smem_addr(smem + 8 * s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  for (long long g = blockIdx.x; g < p.n_seg; g += gridDim.x) {
    const Span sp = span_of(p, g);
    if (!bulk) {
      for (long long j = threadIdx.x; j < p.len; j += blockDim.x)
        sp.d[j] = sp.s[j];
      continue;
    }
    if (threadIdx.x < sp.head) sp.d[threadIdx.x] = sp.s[threadIdx.x];
    const long long t0 = sp.head + sp.body;
    if (threadIdx.x < sp.tail) sp.d[t0 + threadIdx.x] = sp.s[t0 + threadIdx.x];
  }
  if (bulk && threadIdx.x == 0) stream_pieces(p);
}

__global__ void __launch_bounds__(THREADS) local_put_mono_kernel(Plan p) {
  run(p);
}
__global__ void __launch_bounds__(THREADS)
    local_put_streamed_kernel(Plan p) {
  run(p);
}
__global__ void __launch_bounds__(THREADS) local_put_multi_kernel(Plan p) {
  run(p);
}
__global__ void __launch_bounds__(THREADS)
    local_put_inplace_kernel(Plan p) {
  run(p);
}

// The stage for segments of `len` bytes: the segment rounded up to 16
// bytes, at most STAGE_BYTES.
inline long long stage_for(long long len) {
  const long long s = (len + 15) & ~15LL;
  return s < STAGE_BYTES ? s : STAGE_BYTES;
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
