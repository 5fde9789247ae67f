// The streaming tile of the elementwise kernels K5 (miniapps/apps/
// allreduce/csrc/accumulate.cu, Tile<256, 4>) and K10 (interop/csrc/
// add_one.cu, Tile<1024, 1>).
//
// A block takes a fixed tile of TILE = THREADS x VECS x 4 elements.  On
// the vector path thread t of block k holds the 16-byte vectors
// k * THREADS * VECS + t + j * THREADS, j < VECS (a warp's loads are
// contiguous), issues all of its loads before its first use, and the
// last block also takes the n % 4 elements past the last whole vector;
// on the scalar path (an operand not 16-byte aligned) the same tile of
// single elements, element k * TILE + t + j * THREADS, j < VECS x 4.
// The grid is sized from n alone.  tpu_patterns_torch/kernels/tile.py
// mirrors it.
#pragma once

namespace stream_tile {

template <int THREADS_, int VECS_>
struct Tile {
  static constexpr int THREADS = THREADS_;
  static constexpr int VECS = VECS_;  // 16-byte vectors of a thread
  static constexpr long long TILE = THREADS * VECS * 4;  // elements

  // The blocks of a launch over n elements: a tile each, of whole
  // vectors on the vector path (at least one block, whose tail takes
  // n < 4) or of single elements on the scalar path.
  static long long grid(long long n, bool vec) {
    if (!vec) return (n + TILE - 1) / TILE;
    const long long nv = n / 4;
    return nv < 1 ? 1 : (nv + THREADS * VECS - 1) / (THREADS * VECS);
  }
};

}  // namespace stream_tile
