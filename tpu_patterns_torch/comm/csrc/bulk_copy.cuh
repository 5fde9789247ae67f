// Bulk asynchronous copies staged through shared memory, for sm_90a.
//
// The device code of a put, shared by the one-sided put kernels
// (local_put.cu, K8a-K8d) and the copy blocks of the copy-and-compute
// kernel (concurrency/csrc/dma_compute.cu, K7).  Hopper has no
// global->global copy inside a kernel, so a copy goes through shared
// memory by the bulk asynchronous copy (the TMA unit without a tensor
// map): cp.async.bulk global->shared completing on an mbarrier, then
// cp.async.bulk shared->global in a bulk group.  One thread of a block
// issues every copy; the block holds a ring of STAGES = 2 stages, so the
// load of piece k+1 is in flight while piece k is stored.
//
// A copy is a Plan of segments: segment g copies `len` bytes from
// src + g*stride to dst + g*stride.  run(p, blk, nblk) is the work of
// block `blk` of the `nblk` blocks that share the plan: segments blk,
// blk + nblk, ...  Each segment is cut into pieces of at most one stage.
// Each segment's unaligned head and tail (< 16 bytes each) are copied by
// the block's threads with plain byte stores; a source and destination
// that differ in alignment mod 16 are copied bytewise whole.  The
// dynamic shared memory of the launch is BAR_BYTES + STAGES * p.stage.
#pragma once

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

// Thread 0 of block `blk` of `nblk`: every piece of its segments through
// the stage ring.
__device__ void stream_pieces(const Plan& p, long long blk, long long nblk) {
  const long long mine = (p.n_seg - blk + nblk - 1) / nblk;  // segments
  const long long per = (p.len + p.stage - 1) / p.stage;  // pieces each
  const long long total = mine * per;
  uint32_t bar[STAGES], buf[STAGES];
  for (int s = 0; s < STAGES; ++s) {
    bar[s] = smem_addr(smem + 8 * s);
    buf[s] = smem_addr(smem + BAR_BYTES + s * p.stage);
  }
  // piece k: bytes (0 for an empty last piece), source and destination
  auto piece = [&](long long k, const unsigned char** s, unsigned char** d) {
    const Span sp = span_of(p, blk + (k / per) * nblk);
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

// Every thread of block `blk` of the `nblk` blocks that share the plan.
__device__ __forceinline__ void run(const Plan& p, long long blk,
                                    long long nblk) {
  const bool bulk = ((reinterpret_cast<uintptr_t>(p.src) -
                      reinterpret_cast<uintptr_t>(p.dst)) &
                     15) == 0;
  if (bulk && threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) bar_init(smem_addr(smem + 8 * s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  for (long long g = blk; g < p.n_seg; g += nblk) {
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
  if (bulk && threadIdx.x == 0) stream_pieces(p, blk, nblk);
}

// The stage for segments of `len` bytes: the segment rounded up to 16
// bytes, at most STAGE_BYTES.
inline long long stage_for(long long len) {
  const long long s = (len + 15) & ~15LL;
  return s < STAGE_BYTES ? s : STAGE_BYTES;
}

}  // namespace put
