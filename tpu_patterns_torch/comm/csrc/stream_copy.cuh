// A block's streaming copy for Hopper (sm_90a): the copy loop of the
// streamed put K8b (local_put.cu) and the ring put K9 (ring_put.cu).
//
// What bounds it on this card: bytes.  A copy reads each byte once and
// writes it once and does no arithmetic, so its least time is 2 x the
// bytes over 3.35 TB/s (0.1127 ms for the reference's 188.7 MB message).
//
// Design.  To run at the memory's rate the card needs some 25-40 KB of
// loads in flight on each SM (3.35 TB/s times a microsecond of latency,
// over 132 SMs).  Here they go straight to registers: each of a block's
// THREADS threads issues VECS 16-byte loads before its first store, then
// makes its VECS stores, and thread t takes vectors t + j * THREADS of
// the step, so a warp's loads are contiguous.  A block moves STEP =
// THREADS x VECS x 16 bytes (16 KB) a step.  No shared memory is used,
// so eight blocks share an SM (128 KB of loads in flight on it).  A
// copy is cut into tiles (K8b's row tiles; K9's whole shard is one) and
// each tile into STEP pieces, its last ragged, one block a piece
// (copy_piece): the grid is sized from the bytes, not from the SM count,
// so blocks go to SMs as SMs free up, with no last round on part of the
// card (a block that walked the six steps of a 96 KB tile read 3.8%
// slower, and VECS 8 read level with 4: PERF.md).  Loads and stores are
// plain ld.global / st.global: K9's store may target a peer card's
// memory, which a bulk shared->global copy is not verified to do, and
// the streaming hint (.cs) was no faster for K5's loads (PERF.md).  The
// bytes before the range's first 16-byte boundary and after its last
// whole vector (at most 15 each) go a byte a thread.  A source and
// destination that differ in alignment mod 16 (a view with an odd
// offset) are copied a byte a thread whole: right, and slow, for inputs
// the main path does not give.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stream_copy {

constexpr int THREADS = 256;
constexpr int VECS = 4;  // 16-byte loads a thread has in flight
constexpr long long STEP = THREADS * VECS * 16;  // bytes a block a step

// Bytes [lo, hi) of src to the same offsets of dst, by every thread of
// the block (blockDim.x == THREADS).
__device__ __forceinline__ void copy_range(
    const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
    long long lo, long long hi) {
  const int t = threadIdx.x;
  if (((reinterpret_cast<uintptr_t>(src) ^ reinterpret_cast<uintptr_t>(dst)) &
       15) != 0) {
    for (long long i = lo + t; i < hi; i += THREADS) dst[i] = src[i];
    return;
  }
  // head [lo, a), vectors [a, b), tail [b, hi)
  long long a =
      lo + ((16 - ((reinterpret_cast<uintptr_t>(src) + lo) & 15)) & 15);
  if (a > hi) a = hi;
  const long long nv = (hi - a) >> 4;
  const long long b = a + (nv << 4);
  if (t < a - lo) dst[lo + t] = src[lo + t];
  if (t < hi - b) dst[b + t] = src[b + t];
  const int4* s = reinterpret_cast<const int4*>(src + a);
  int4* d = reinterpret_cast<int4*>(dst + a);
  for (long long v = t; v < nv; v += THREADS * VECS) {
    int4 r[VECS];
#pragma unroll
    for (int j = 0; j < VECS; ++j)
      if (v + j * THREADS < nv) r[j] = s[v + j * THREADS];
#pragma unroll
    for (int j = 0; j < VECS; ++j)
      if (v + j * THREADS < nv) d[v + j * THREADS] = r[j];
  }
}

// The STEP pieces a tile of `bytes` is cut into.
inline long long pieces(long long bytes) {
  return (bytes + STEP - 1) / STEP;
}

// The blocks of a copy of n_tiles tiles of tile_bytes, one a piece; 0 for
// an empty copy or a grid out of reach.
inline long long grid(long long n_tiles, long long tile_bytes) {
  if (n_tiles < 1 || tile_bytes < 1) return 0;
  const long long per = pieces(tile_bytes);
  return n_tiles <= 0x7fffffffLL / per ? n_tiles * per : 0;
}

// Block blockIdx.x's piece of a copy in tiles of tile_bytes, `per` =
// pieces(tile_bytes) pieces a tile: piece blockIdx.x % per of tile
// blockIdx.x / per.
__device__ __forceinline__ void copy_piece(
    const unsigned char* __restrict__ src, unsigned char* __restrict__ dst,
    long long tile_bytes, unsigned per) {
  const long long tile = blockIdx.x / per;
  const long long lo =
      tile * tile_bytes + static_cast<long long>(blockIdx.x % per) * STEP;
  const long long end = (tile + 1) * tile_bytes;
  copy_range(src, dst, lo, end - lo < STEP ? end : lo + STEP);
}

}  // namespace stream_copy
