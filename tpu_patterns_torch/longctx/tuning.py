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

The bf16 kernels (wgmma) take tiles of 64 or 128 a side, 64 rows or
keys per consumer warpgroup, and mask a ragged edge, so their tile need
not divide the lengths: the forward either pair, the backward's dq
kernel (64 or 128 rows, 64 keys) and its dk/dv kernel (64 rows, 64 or
128 keys) each its own pair from the one request.  The float32 forward
(register-tiled FFMA) takes q-units of 64 rows where their grid fills
the card and of 32 elsewhere, by k-tiles of head_dim keys (64 or 128),
and masks a ragged edge too.  The float32 backward kernels take
multiples of 16 that divide the lengths, one pair for both.
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
# ... and its streaming multiprocessors
H100_SMS = 132
# The float32 kernels' tiles are multiples of 16 (flash_common.cuh).
MIN_TILE = 16
# The bf16 forward's tile sides, largest first (64 rows per warpgroup).
FWD_BF16_SIDES = (128, 64)
# The f32 forward's sides, largest first: rows of a q-unit (8 or 4 a
# thread) and keys of a k-tile, as many as the head_dim (a block has
# 2 x keys threads; flash_attention.cu's F32Fwd)
FWD_F32_Q_SIDES = (64, 32)
FWD_F32_K_SIDES = (128, 64)
# The bf16 backward's: the side a block owns (dq's rows, dk/dv's keys),
# largest first, and the side it streams (dq's keys, dk/dv's rows).
BWD_BF16_SIDES = (128, 64)
BWD_STREAM = 64
_REGION_ALIGN = 128  # every shared-memory region starts 128-B aligned
_BARRIER_BYTES = 256  # the bf16 kernels' mbarriers

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


def bwd_stages(d: int) -> int:
    """Depth of the bf16 backward's ring of streamed tiles: 64 KB of
    tiles (k and v for dq, q and do for dk/dv) at 64 a tile for D 128
    (2 stages) and D 64 (4)."""
    return 4 if d <= 64 else 2


def smem_bytes(kind: str, bq: int, bk: int, d: int, in_bytes: int) -> int:
    """Dynamic shared memory of one thread block of kernel ``kind``
    ("fwd", "dq" or "dkv") at tile (bq, bk), head_dim ``d`` and input
    element size ``in_bytes``.  The bf16 kernels: 1024 B of slack to
    align their swizzled tiles, the tiles a block loads once (the
    forward's q, dq's q and do, dk/dv's k and v), the ring's tiles
    (:func:`fwd_stages` (k, v) pairs; :func:`bwd_stages` (k, v) pairs
    for dq, (q, do) pairs with their rows' f32 lse and delta for dk/dv)
    and 256 B of mbarriers.  The float32 kernels: the regions the
    kernel carves, in order, each rounded up to 128 B.  The forward's
    (``flash_common.cuh::smem_fwd``): q and k rows padded by 4 floats,
    v unpadded, P^T [bk][bq + 4] and two [bk / 32][bq] row exchanges;
    the backward's rows are padded by 16 B (bank spread)."""
    if in_bytes == 2:
        tile = d * 2  # bytes of one bf16 row
        own, ring = {
            "fwd": (bq * tile, fwd_stages(d) * 2 * bk * tile),
            "dq": (2 * bq * tile, bwd_stages(d) * 2 * bk * tile),
            "dkv": (2 * bk * tile, bwd_stages(d) * 2 * bq * (tile + 4)),
        }[kind]
        return 1024 + own + ring + _BARRIER_BYTES
    ldt = d + 16 // in_bytes  # staged q/k/v/do rows, input dtype
    lds = bk + 4  # float32 score rows
    ldp = bk + 16 // in_bytes  # probability / dS rows, input dtype
    lda = d + 4  # float32 accumulator rows
    ib = in_bytes
    regions = {
        # q, k, v, P^T, row max and row sum of each warp sharing a row
        "fwd": [(bq * (d + 4), 4), (bk * (d + 4), 4), (bk * d, 4),
                (bk * (bq + 4), 4), (bk // 32 * bq, 4), (bk // 32 * bq, 4)],
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


def sm_count(device: torch.device | str) -> int:
    """Streaming multiprocessors of ``device``'s card; the H100's for a
    CPU device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return H100_SMS
    return int(torch.cuda.get_device_properties(dev).multi_processor_count)


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
                budget: int = H100_SMEM_OPTIN, heads: int = 1,
                sms: int = H100_SMS) -> tuple[int, int]:
    """Largest (block_q, block_k) pair <= the requested sizes (clamped to
    the sequence lengths, then halved, the larger side first) whose
    shared memory fits ``budget`` in every kernel of ``kinds``.  A bf16
    kernel (``in_bytes`` 2; kinds ``("fwd",)``, ``("dq",)`` or
    ``("dkv",)``, one at a time) takes each side it may choose from
    :data:`FWD_BF16_SIDES` (:data:`BWD_BF16_SIDES`): the largest <= the
    request (64 at least) that divides the length, else 64, whose ragged
    edge the kernel masks; the backward's streamed side is
    :data:`BWD_STREAM`.  The float32 forward (``in_bytes`` 4, kinds
    ``("fwd",)``; ``heads`` heads, a card of ``sms`` SMs) takes the
    largest of :data:`FWD_F32_Q_SIDES` <= the request whose grid (a
    block a pair of q-units, each head) holds a block for every SM, else
    32, and the largest of :data:`FWD_F32_K_SIDES` not above the
    head_dim (64 for a smaller one); every such pair fits the budget."""

    def est(bq: int, bk: int) -> int:
        return max(smem_bytes(k, bq, bk, d, in_bytes) for k in kinds)

    if in_bytes == 2 and ("dq" in kinds or "dkv" in kinds) and len(kinds) > 1:
        raise ValueError("the bfloat16 backward kernels take a tile pair "
                         "each: ask for ('dq',) and ('dkv',) apart")
    if in_bytes == 4 and kinds == ("fwd",):
        def fills(bq: int) -> bool:  # a block a pair of q-units, each head
            return heads * ((-(-lq // bq) + 1) // 2) >= sms

        return (next(t for t in FWD_F32_Q_SIDES if t == FWD_F32_Q_SIDES[-1]
                     or (t <= block_q and fills(t))),
                next(t for t in FWD_F32_K_SIDES
                     if t <= d or t == FWD_F32_K_SIDES[-1]))
    if in_bytes == 2 and kinds in (("fwd",), ("dq",), ("dkv",)):
        sides = FWD_BF16_SIDES if kinds == ("fwd",) else BWD_BF16_SIDES

        def side(req: int, n: int) -> int:
            return next(t for t in sides
                        if t == sides[-1] or (t <= req and n % t == 0))

        bq = BWD_STREAM if kinds == ("dkv",) else side(block_q, lq)
        bk = BWD_STREAM if kinds == ("dq",) else side(block_k, lk)
        while est(bq, bk) > budget and max(bq, bk) > sides[-1]:
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
