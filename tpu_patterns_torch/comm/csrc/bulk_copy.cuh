// Bulk asynchronous copies staged through shared memory, for sm_90a.
//
// The device code of a put, shared by the one-sided put kernels
// (local_put.cu, K8a, K8c and K8d) and the copy blocks of the
// copy-and-compute kernel (concurrency/csrc/dma_compute.cu, K7).  Hopper
// has no global->global copy inside a kernel, so a copy goes through shared
// memory by the bulk asynchronous copy (the TMA unit without a tensor
// map): cp.async.bulk global->shared completing on an mbarrier, then
// cp.async.bulk shared->global in a bulk group.  One thread of a block
// issues every copy; the block holds a ring of STAGES = 2 stages, so the
// load of piece k+1 is in flight while piece k is stored.
//
// A copy is a Plan of segments: segment g copies `len` bytes from
// src + g*stride to dst + g*stride; a nonzero `last` is the length of
// the last segment instead (a ragged tail, at most `len`).  A
// ChunkPlan's segments come in chunks of `per` instead, chunk c starting
// c*chunk bytes in: segment g is piece g % per of chunk g / per, and
// `last` is the length of every chunk's last piece.  run(p, blk,
// nblk) is the work of block `blk` of the `nblk` blocks that share the
// plan: segments blk, blk + nblk, ...  Each segment is cut into pieces
// of at most one stage.
// Each segment's unaligned head and tail (< 16 bytes each) are copied by
// the block's threads with plain byte stores; a source and destination
// that differ in alignment mod 16 are copied bytewise whole.  The
// dynamic shared memory of the launch is BAR_BYTES + STAGES * p.stage.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "../../kernels/csrc/hopper.cuh"

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
  long long last = 0;  // 0: the last segment is `len` bytes too
};

// A plan of `per` segments a chunk, chunks `chunk` bytes apart.
struct ChunkPlan : Plan {
  long long per = 1, chunk = 0;
};

// A segment's bytes, head (to 16-byte alignment), bulk body and tail.
struct Span {
  const unsigned char* s;
  unsigned char* d;
  long long n, head, body, tail;
};

__device__ __forceinline__ Span span_of(const Plan& p, long long g) {
  Span r;
  r.s = p.src + g * p.stride;
  r.d = p.dst + g * p.stride;
  r.n = (p.last && g == p.n_seg - 1) ? p.last : p.len;
  long long head = (16 - (reinterpret_cast<uintptr_t>(r.s) & 15)) & 15;
  r.head = head < r.n ? head : r.n;
  r.body = (r.n - r.head) & ~15LL;
  r.tail = r.n - r.head - r.body;
  return r;
}

__device__ __forceinline__ Span span_of(const ChunkPlan& p, long long g) {
  const long long i = g % p.per;  // the piece within its chunk
  Plan one = p;  // that piece as segment i of a one-chunk plan
  one.src += (g / p.per) * p.chunk;
  one.dst += (g / p.per) * p.chunk;
  one.n_seg = p.per;
  return span_of(one, i);
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
template <class P>
__device__ void stream_pieces(const P& p, long long blk, long long nblk) {
  const long long mine = (p.n_seg - blk + nblk - 1) / nblk;  // segments
  const long long per = (p.len + p.stage - 1) / p.stage;  // pieces each
  const long long total = mine * per;
  uint32_t bar[STAGES], buf[STAGES];
  for (int s = 0; s < STAGES; ++s) {
    bar[s] = hopper::smem_u32(smem + 8 * s);
    buf[s] = hopper::smem_u32(smem + BAR_BYTES + s * p.stage);
  }
  // piece k: bytes (0 for an empty last piece, or a piece past a ragged
  // last segment's body), source and destination
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
      hopper::bar_expect(bar[st], n);
      bulk_load(buf[st], s, n, bar[st]);
    } else {
      hopper::bar_arrive(bar[st]);  // the phase still completes
    }
  };
  for (long long k = 0; k < total && k < STAGES; ++k) load(k);
  for (long long k = 0; k < total; ++k) {
    const int st = static_cast<int>(k % STAGES);
    hopper::bar_wait(bar[st], static_cast<uint32_t>((k / STAGES) & 1));
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
template <class P>
__device__ __forceinline__ void run(const P& p, long long blk,
                                    long long nblk) {
  const bool bulk = ((reinterpret_cast<uintptr_t>(p.src) -
                      reinterpret_cast<uintptr_t>(p.dst)) &
                     15) == 0;
  if (bulk && threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s)
      hopper::bar_init(hopper::smem_u32(smem + 8 * s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  for (long long g = blk; g < p.n_seg; g += nblk) {
    const Span sp = span_of(p, g);
    if (!bulk) {
      for (long long j = threadIdx.x; j < sp.n; j += blockDim.x)
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
