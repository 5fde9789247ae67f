"""Tile sizes of the flash kernels: promoted defaults and the
shared-memory fit.

Counterpart of ``tpu_patterns/longctx/tuning.py``.  The reference fits
(block_q, block_k) into a 14 MB VMEM budget; here the budget is the
card's opt-in shared memory per block (232,448 B on an H100) and the
working set is that of the CUDA kernels' own shared-memory tiles
(``longctx/csrc/flash_common.cuh`` and ``flash_attention.cu``, whose
``*_smem_bytes`` functions compute the same numbers, region by region).
A (block_q, block_k) pair IS the kernels' tile: a q-tile of block_q rows
loops over k-tiles of block_k keys inside one thread block.

The bf16 forward (the wgmma kernel) takes tiles of 64 or 128 on either
side, 64 query rows per consumer warpgroup, and masks a ragged edge, so
its tile need not divide the lengths; the float32 forward and the
backward kernels take multiples of 16 that divide them.
"""

from __future__ import annotations

import json
import os

import torch

NEG_INF = -1e30

# Hand-picked default requested tile, clamped by :func:`_auto_block`;
# a promoted ``flash_tuned.json`` beside this file overrides it.
FLASH_TUNED_PATH = os.path.join(os.path.dirname(__file__),
                                "flash_tuned.json")
DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024

# An H100's opt-in shared memory per block (Hopper tuning guide): the
# budget for CPU tensors, which have no card to ask.
H100_SMEM_OPTIN = 232448
# The kernels' tiles are multiples of the 16 x 16 tensor-core fragment.
MIN_TILE = 16
# The bf16 forward's tile sides, largest first (64 rows per warpgroup).
FWD_BF16_SIDES = (128, 64)
_REGION_ALIGN = 128  # every shared-memory region starts 128-B aligned
_BARRIER_BYTES = 256  # the bf16 forward's mbarriers

_TUNED_CACHE: dict[tuple[str, float], tuple[int, int]] = {}


def load_tuned_blocks(path: str = FLASH_TUNED_PATH) -> tuple[int, int]:
    """(block_q, block_k) defaults: the promoted winners when a measured
    run wrote them to ``path``, the hand-picked squares otherwise."""
    try:
        key = (path, os.path.getmtime(path))
    except OSError:
        return (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)
    cached = _TUNED_CACHE.get(key)
    if cached is not None:
        return cached
    try:
        with open(path) as f:
            tuned = json.load(f)
        blocks = (int(tuned.get("block_q", DEFAULT_BLOCK_Q)),
                  int(tuned.get("block_k", DEFAULT_BLOCK_K)))
    except (OSError, ValueError):
        blocks = (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)
    _TUNED_CACHE[key] = blocks
    return blocks


def fwd_stages(d: int) -> int:
    """Depth of the bf16 forward's k/v ring: 128 KB of k and v tiles at
    block_k 128 for D 128 (2 stages) and D 64 (4)."""
    return 4 if d <= 64 else 2


def smem_bytes(kind: str, bq: int, bk: int, d: int, in_bytes: int) -> int:
    """Dynamic shared memory of one thread block of kernel ``kind``
    ("fwd", "dq" or "dkv") at tile (bq, bk), head_dim ``d`` and input
    element size ``in_bytes``.  The bf16 forward: 1024 B of slack to
    align its swizzled tiles, the q tile, :func:`fwd_stages` (k, v) tile
    pairs and 256 B of mbarriers.  The others: the regions the kernel
    carves, in order, each rounded up to 128 B; input-dtype rows are
    padded by 16 B and float32 rows by 4 floats (bank spread;
    tensor-core row strides)."""
    if kind == "fwd" and in_bytes == 2:
        return (1024 + bq * d * 2 + fwd_stages(d) * 2 * bk * d * 2
                + _BARRIER_BYTES)
    ldt = d + 16 // in_bytes  # staged q/k/v/do rows, input dtype
    lds = bk + 4  # float32 score rows
    ldp = bk + 16 // in_bytes  # probability / dS rows, input dtype
    lda = d + 4  # float32 accumulator rows
    ib = in_bytes
    regions = {
        # q, k, v, s, p, acc, m, l, alpha
        "fwd": [(bq * ldt, ib), (bk * ldt, ib), (bk * ldt, ib),
                (bq * lds, 4), (bq * ldp, ib), (bq * lda, 4),
                (bq, 4), (bq, 4), (bq, 4)],
        # q, do, k, v, s, dp, ds, dq, lse, delta
        "dq": [(bq * ldt, ib), (bq * ldt, ib), (bk * ldt, ib),
               (bk * ldt, ib), (bq * lds, 4), (bq * lds, 4),
               (bq * ldp, ib), (bq * lda, 4), (bq, 4), (bq, 4)],
        # k, v, q, do, s, dp, p, ds, dk, dv, lse, delta
        "dkv": [(bk * ldt, ib), (bk * ldt, ib), (bq * ldt, ib),
                (bq * ldt, ib), (bq * lds, 4), (bq * lds, 4),
                (bq * ldp, ib), (bq * ldp, ib), (bk * lda, 4),
                (bk * lda, 4), (bq, 4), (bq, 4)],
    }[kind]
    return sum(-(-n * size // _REGION_ALIGN) * _REGION_ALIGN
               for n, size in regions)


def smem_budget(device: torch.device | str) -> int:
    """Opt-in shared memory per block of ``device``'s card; the H100's
    for a CPU device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return H100_SMEM_OPTIN
    props = torch.cuda.get_device_properties(dev)
    return int(props.shared_memory_per_block_optin)


def _auto_block(lq: int, lk: int, d: int, in_bytes: int,
                kinds: tuple[str, ...], block_q: int, block_k: int,
                budget: int = H100_SMEM_OPTIN) -> tuple[int, int]:
    """Largest (block_q, block_k) pair <= the requested sizes (clamped to
    the sequence lengths, then halved, the larger side first) whose
    shared memory fits ``budget`` in every kernel of ``kinds``.  The
    bf16 forward alone (kinds ``("fwd",)``, ``in_bytes`` 2) takes each
    side from :data:`FWD_BF16_SIDES`: the largest <= the request (64 at
    least) that divides the length, else 64, whose ragged edge the
    kernel masks."""

    def est(bq: int, bk: int) -> int:
        return max(smem_bytes(k, bq, bk, d, in_bytes) for k in kinds)

    if kinds == ("fwd",) and in_bytes == 2:
        def side(req: int, n: int) -> int:
            return next(t for t in FWD_BF16_SIDES
                        if t == FWD_BF16_SIDES[-1]
                        or (t <= req and n % t == 0))

        bq, bk = side(block_q, lq), side(block_k, lk)
        while est(bq, bk) > budget and max(bq, bk) > FWD_BF16_SIDES[-1]:
            if bq >= bk:
                bq //= 2
            else:
                bk //= 2
        return bq, bk

    bq, bk = min(block_q, lq), min(block_k, lk)
    while est(bq, bk) > budget and max(bq, bk) > MIN_TILE:
        if bq >= bk:
            bq //= 2
        else:
            bk //= 2
    return bq, bk
