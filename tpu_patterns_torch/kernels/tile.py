"""The streaming tile of the elementwise kernels K5 (``accumulate``,
256 threads x 4 vectors) and K10 (``add_one``, 1024 threads x 1
vector), as ``csrc/stream_tile.cuh`` computes it: ``threads`` threads a
block, each with ``vecs`` 16-byte vectors of four elements, or
``vecs`` x 4 single elements on the scalar path.  chip_smoke.py holds
each kernel's C grid to :func:`tile_grid`; the CPU tests hold
:func:`tile_elements` to cover every element once, and
:func:`tile_plan`, the same plan for every block at once, to it."""

from __future__ import annotations

import numpy as np
import torch


def tile_grid(n: int, vector: bool, threads: int, vecs: int) -> int:
    """The blocks a launch over ``n`` elements takes: a tile of whole
    vectors each (at least one block) on the vector path, a tile of
    single elements each on the scalar path."""
    if not vector:
        return -(-n // (threads * vecs * 4))
    return max(1, -(-(n // 4) // (threads * vecs)))


def tile_elements(n: int, vector: bool, block: int, threads: int,
                  vecs: int) -> torch.Tensor:
    """The element indices block ``block`` of a launch over ``n``
    elements writes.  On the vector path thread t takes vectors
    block * threads * vecs + t + j * threads, j < vecs, masked at the
    last whole vector, and the last block also the n % 4 elements past
    it; on the scalar path elements block * tile + t + j * threads,
    j < vecs x 4, masked at n."""
    t = torch.arange(threads)
    if not vector:
        i = (block * threads * vecs * 4 + t
             + torch.arange(vecs * 4)[:, None] * threads)
        return i[i < n]
    v = block * threads * vecs + t + torch.arange(vecs)[:, None] * threads
    v = v[v < n // 4]
    i = (4 * v[:, None] + torch.arange(4)).ravel()
    if block == tile_grid(n, True, threads, vecs) - 1:
        i = torch.cat([i, torch.arange(n // 4 * 4, n)])
    return i


def tile_plan(n: int, vector: bool, threads: int, vecs: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """(block, element) int32 arrays over every block of a launch over
    ``n`` (< 2^31) elements: element ``element[i]`` is written by block
    ``block[i]``, by the same per-thread rule as :func:`tile_elements`,
    computed for the whole grid in one pass of numpy."""
    if n >= 2**31:
        raise ValueError(f"tile_plan takes n < 2^31, got {n}")
    grid = tile_grid(n, vector, threads, vecs)
    i32 = np.int32
    b = np.arange(grid, dtype=i32)[:, None, None]
    t = np.arange(threads, dtype=i32)[None, None, :]
    if not vector:
        j = np.arange(vecs * 4, dtype=i32)[None, :, None]
        i = b * i32(threads * vecs * 4) + t + j * i32(threads)
        return _masked(np.broadcast_to(b, i.shape), i, i < n)
    j = np.arange(vecs, dtype=i32)[None, :, None]
    v = b * i32(threads * vecs) + t + j * i32(threads)
    i = (i32(4) * v)[..., None] + np.arange(4, dtype=i32)
    blk, i = _masked(np.broadcast_to(b[..., None], i.shape), i,
                     np.broadcast_to((v < n // 4)[..., None], i.shape))
    tail = np.arange(n // 4 * 4, n, dtype=i32)
    return (np.concatenate([blk, np.full(tail.size, grid - 1, i32)]),
            np.concatenate([i, tail]))


def _masked(block: np.ndarray, i: np.ndarray, keep: np.ndarray):
    """(block, i) flattened where ``keep`` holds (a plain copy when it
    holds everywhere, the common whole-tile case)."""
    if keep.all():
        return block.ravel(), i.ravel()
    return block[keep], i[keep]
