"""Tile sizes of the flash kernels: promoted defaults and the
shared-memory fit.

Counterpart of ``tpu_patterns/longctx/tuning.py``.  The reference fits
(block_q, block_k) into a 14 MB VMEM budget; here the budget is the
card's opt-in shared memory per block (232,448 B on an H100) and the
working set is that of the CUDA kernels' own shared-memory tiles
(``longctx/csrc/flash_common.cuh``, ``flash_attention.cu`` and
``flash_attention_bwd.cu``, whose ``*_smem_bytes`` functions compute
the same numbers, region by region).  A (block_q, block_k) pair IS the
kernels' tile: a q-tile of block_q rows against k-tiles of block_k keys
inside one thread block.

Every kernel masks a ragged edge, so its tile need not divide the
lengths, and each backward kernel takes its own pair from the one
request.  The bf16 kernels (wgmma) take tiles of 64 or 128 a side, 64
rows or keys per consumer warpgroup: the forward either pair, the
backward's dq kernel (64 or 128 rows, 64 keys) and its dk/dv kernel (64
rows, 64 or 128 keys).  The float32 kernels (register-tiled FFMA) take
units of 64 where their grid (a block a pair of units, each head) fills
the card and of 32 elsewhere: the forward q-units by k-tiles of
head_dim keys (64 or 128), the backward's dq q-units and dk/dv k-units
by tiles of the other side of head_dim beside 32, 64 beside 64.
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
# The bf16 forward's tile sides, largest first (64 rows per warpgroup).
FWD_BF16_SIDES = (128, 64)
# The f32 forward's sides, largest first: rows of a q-unit (8 or 4 a
# thread) and keys of a k-tile, as many as the head_dim (a block has
# 2 x keys threads; flash_attention.cu's F32Fwd)
FWD_F32_Q_SIDES = (64, 32)
FWD_F32_K_SIDES = (128, 64)
# The f32 backward's: the side a block owns (dq's rows, dk/dv's keys),
# largest first; it streams 64 beside 64 and the f32 forward's k side
# beside 32 (flash_attention_bwd.cu's F32Bwd)
BWD_F32_SIDES = (64, 32)
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
    kernel carves, in order, each rounded up to 128 B
    (``flash_common.cuh::smem_{fwd,dq_f32,dkv_f32}``), every [rows][D]
    tile but the forward's v padded by 4 floats: the forward's q, k, v,
    P^T [bk][bq + 4] and two [bk / 32][bq] row exchanges; dq's q, dO, k,
    v and dS^T [bk][bq + 4]; dk/dv's k, v, q, dO, P and dS [bq][bk + 4],
    and the rows' lse and delta."""
    if in_bytes == 2:
        tile = d * 2  # bytes of one bf16 row
        own, ring = {
            "fwd": (bq * tile, fwd_stages(d) * 2 * bk * tile),
            "dq": (2 * bq * tile, bwd_stages(d) * 2 * bk * tile),
            "dkv": (2 * bk * tile, bwd_stages(d) * 2 * bq * (tile + 4)),
        }[kind]
        return 1024 + own + ring + _BARRIER_BYTES
    row = d + 4  # floats of a padded [rows][D] row
    floats = {
        # q, k, v, P^T, row max and row sum of each warp sharing a row
        "fwd": [bq * row, bk * row, bk * d, bk * (bq + 4), bk // 32 * bq,
                bk // 32 * bq],
        # q, dO, k, v, dS^T
        "dq": [bq * row, bq * row, bk * row, bk * row, bk * (bq + 4)],
        # k, v, q, dO, P, dS, lse, delta
        "dkv": [bk * row, bk * row, bq * row, bq * row, bq * (bk + 4),
                bq * (bk + 4), bq, bq],
    }[kind]
    return sum(-(-n * 4 // _REGION_ALIGN) * _REGION_ALIGN for n in floats)


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
    """The tile (block_q, block_k) of one flash kernel (``kinds`` is
    ``("fwd",)``, ``("dq",)`` or ``("dkv",)``) for the request
    (block_q, block_k).  A bf16 kernel (``in_bytes`` 2) takes each side
    it may choose from :data:`FWD_BF16_SIDES` (:data:`BWD_BF16_SIDES`):
    the largest <= the request (64 at least) that divides the length,
    else 64, whose ragged edge the kernel masks; the backward's streamed
    side is :data:`BWD_STREAM`; the pair is halved, the larger side
    first, until its shared memory fits ``budget``.  A float32 kernel
    (``in_bytes`` 4; ``heads`` heads, a card of ``sms`` SMs) takes for
    the side a block owns (the forward's and dq's rows, dk/dv's keys)
    the largest of :data:`FWD_F32_Q_SIDES` (:data:`BWD_F32_SIDES`) <=
    the request whose grid (a block a pair of units, each head) holds a
    block for every SM, else 32; for the other side the largest of
    :data:`FWD_F32_K_SIDES` not above the head_dim (64 for a smaller
    one), and 64 beside the backward's 64.  Every such pair fits the
    budget."""
    if kinds not in (("fwd",), ("dq",), ("dkv",)):
        raise ValueError("the flash kernels take a tile pair each: ask "
                         "for ('fwd',), ('dq',) and ('dkv',) apart")
    kind = kinds[0]
    if in_bytes == 4:
        n, req = (lk, block_k) if kind == "dkv" else (lq, block_q)
        sides = FWD_F32_Q_SIDES if kind == "fwd" else BWD_F32_SIDES

        def fills(t: int) -> bool:  # a block a pair of units, each head
            return heads * ((-(-n // t) + 1) // 2) >= sms

        own = next(t for t in sides
                   if t == sides[-1] or (t <= req and fills(t)))
        other = next(t for t in FWD_F32_K_SIDES
                     if t <= d or t == FWD_F32_K_SIDES[-1])
        if kind != "fwd" and own == 64:
            other = 64
        return (other, own) if kind == "dkv" else (own, other)

    sides = FWD_BF16_SIDES if kind == "fwd" else BWD_BF16_SIDES

    def side(req: int, n: int) -> int:
        return next(t for t in sides
                    if t == sides[-1] or (t <= req and n % t == 0))

    bq = BWD_STREAM if kind == "dkv" else side(block_q, lq)
    bk = BWD_STREAM if kind == "dq" else side(block_k, lk)
    while (smem_bytes(kind, bq, bk, d, in_bytes) > budget
           and max(bq, bk) > sides[-1]):
        if bq >= bk:
            bq //= 2
        else:
            bk //= 2
    return bq, bk
