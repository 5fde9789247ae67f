"""The float32 flash forward's (K2, K3) plan on the CPU: its tile ladder,
its shared-memory model, its shape check and its block schedule
(``flash.fwd_schedule``, the Python mirror of
``flash_attention.cu::flash_fwd_f32_kernel``'s walk) against the JAX
package's causal pair table and a brute-force search for the tiles that
hold a visible (query, key) pair.  The kernel itself runs only on the
card (``chip_smoke.py`` phases 1, 4 and 19)."""

import numpy as np
import pytest
import torch

from tpu_patterns.longctx import flash as jflash
from tpu_patterns_torch.longctx import flash as tflash
from tpu_patterns_torch.longctx import tuning

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

SM_SMEM = 233472  # an H100 SM's shared memory; each block reserves 1 KB
# the kernel's tiles: q-units of 32 or 64 rows, k-tiles of head_dim keys
TILES = [(32, 64), (32, 128), (64, 64), (64, 128)]


def _region(nbytes):
    return -(-nbytes // 128) * 128


# the card's f32 callers and the q-unit rows each gets: longctx's K2
# (L4096 x 8 heads: 256 blocks of 64-row pairs, more than the 132 SMs;
# x 2 heads in each of ulysses_pallas's launches at sp 4: 64, so 32
# rows), its ring's 1024-token shard pairs (x 8 heads: 64, so 32 rows)
# and the flagship's f32 leg (batch 4 x 8 heads folded into 32)
CALLERS = [(4096, 4096, 8, 64), (4096, 4096, 2, 32), (1024, 1024, 8, 32),
           (4096, 4096, 32, 64)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("lq,lk,h,rows", CALLERS)
def test_f32_forward_tile_ladder(d, lq, lk, h, rows):
    """The f32 forward's ladder: the largest q side <= the request whose
    grid of unit pairs holds a block for every SM (else 32), and the
    largest k side not above the head_dim (64 or 128 keys); the pair
    fits the card's shared memory, and the wrapper's clamp (on meta
    tensors of the callers' shapes) agrees."""
    assert tuning.FWD_F32_Q_SIDES == (64, 32)
    assert tuning.FWD_F32_K_SIDES == (128, 64)
    for req, want in (((1024, 1024), rows), ((512, 512), rows),
                      ((64, 32), rows), ((48, 48), 32), ((16, 16), 32)):
        assert tuning._auto_block(lq, lk, d, 4, ("fwd",), *req,
                                  heads=h) == (want, d)
    for bq in tuning.FWD_F32_Q_SIDES:
        assert (tuning.smem_bytes("fwd", bq, d, d, 4)
                <= tuning.H100_SMEM_OPTIN)
    q = torch.empty((lq, h, d), device="meta")
    k = torch.empty((lk, h, d), device="meta")
    assert tflash._blocks(q, k, ("fwd",), 1024, 1024) == (rows, d)
    # a card of fewer SMs fills sooner; below head_dim 64 (the CPU tests'
    # widths, which no kernel takes) the k side is the smallest
    assert tuning._auto_block(lq, lk, d, 4, ("fwd",), 1024, 1024, heads=h,
                              sms=16) == (64, d)
    assert tuning._auto_block(lq, lk, 16, 4, ("fwd",), 1024, 1024,
                              heads=h)[1] == 64


@pytest.mark.parametrize("bq,d,want", [(32, 64, 52224), (32, 128, 169472),
                                       (64, 64, 69632), (64, 128, 203776)])
def test_f32_forward_smem_regions(bq, d, want):
    """smem_bytes("fwd", ..., 4) is the kernel's carve, region by region
    (q and k rows padded by 4 floats, v, P^T [bk][bq + 4], two [bk /
    32][bq] row exchanges, each 128-B aligned), and the design's blocks
    an SM fit: three at D 64, one at D 128."""
    bk = d
    regions = [bq * (d + 4) * 4, bk * (d + 4) * 4, bk * d * 4,
               bk * (bq + 4) * 4, bk // 32 * bq * 4, bk // 32 * bq * 4]
    got = tuning.smem_bytes("fwd", bq, bk, d, 4)
    assert got == sum(_region(n) for n in regions) == want
    blocks = 3 if d == 64 else 1
    assert blocks * (got + 1024) <= SM_SMEM


@pytest.mark.parametrize("dtype,d,tiles,ok", [
    (torch.float32, 128, (32, 128), True),
    (torch.float32, 64, (32, 64), True),
    (torch.float32, 128, (64, 128), True),
    (torch.float32, 64, (64, 64), True),
    (torch.float32, 128, (32, 64), False),
    (torch.float32, 64, (32, 128), False),
    (torch.float32, 128, (128, 128), False),
    (torch.float32, 128, (16, 128), False),
    (torch.float32, 96, (32, 96), False),
    (torch.float32, 16, (32, 64), False),
    (torch.float32, 256, (32, 256), False),
    (torch.bfloat16, 128, (128, 64), True),
    (torch.bfloat16, 128, (32, 64), False),
])
def test_launch_fwd_shape_check(dtype, d, tiles, ok):
    """``_launch_fwd``'s check: the f32 kernel takes D 64 or 128 and the
    tiles (32 or 64, D), naming what it takes; the bf16 kernel's rule
    stands."""
    if ok:
        tflash._check_fwd_shape("flash_block", dtype, d, *tiles)
        return
    with pytest.raises(ValueError, match="head_dim 64 or 128"):
        tflash._check_fwd_shape("flash_block", dtype, d, *tiles)


def test_f32_ragged_lengths_and_requests():
    """The f32 forward takes ragged lengths at the default request (its
    kernel masks the edge; on the CPU the plain version runs), while an
    explicit request that does not divide the lengths keeps the
    reference's error."""
    g = np.random.RandomState(3)
    q = torch.from_numpy(g.randn(100, 2, 64).astype(np.float32))
    k = torch.from_numpy(g.randn(200, 2, 64).astype(np.float32))
    o, m, l = tflash.flash_block(q, k, k, 0, 0, causal=True)
    assert o.shape == (100, 2, 64) and m.shape == l.shape == (2, 100)
    assert tflash.flash_attention(q, k, k, causal=True).shape == q.shape
    with pytest.raises(ValueError, match="divide"):
        tflash.flash_block(q, k, k, 0, 0, block_q=48, block_k=64)


def _rows(schedule):
    """(unit, tile, is_first, is_last) rows of a schedule, units in
    ascending order: the layout of the reference's pair table."""
    rows = []
    for unit, tiles in sorted(w for block in schedule for w in block):
        for pos, t in enumerate(tiles):
            rows.append((unit, t, int(pos == 0), int(pos == len(tiles) - 1)))
    return np.asarray(rows, np.int32).reshape(-1, 4).T


@pytest.mark.parametrize("bq,bk", TILES)
@pytest.mark.parametrize("nq,nk", [(4, 2), (8, 4), (3, 2), (7, 5), (1, 1),
                                   (128, 64), (32, 16)])
def test_schedule_matches_reference_pair_table(nq, nk, bq, bk):
    """At zero offsets the live (q-unit, k-tile) pairs are the reference's
    iq-major table at the same tile; block p takes units nq - 1 - p and
    p, the heavier first, so block 0 holds the heaviest unit."""
    sched = tflash.fwd_schedule(nq * bq, nk * bk, bq, bk)
    np.testing.assert_array_equal(
        _rows(sched), jflash._causal_pair_table(nq, nk, bq, bk))
    assert len(sched) == (nq + 1) // 2
    for p, block in enumerate(sched):
        assert [u for u, _ in block] == list(dict.fromkeys((nq - 1 - p, p)))
        assert len(block[0][1]) >= len(block[-1][1])


def _visible_tiles(lq, lk, bq, bk, causal, q_off, k_off, stride):
    """{q-unit: [k-tiles holding a visible pair, ascending]} by brute
    force."""
    qpos = q_off + np.arange(lq) * stride
    kpos = k_off + np.arange(lk) * stride
    vis = (qpos[:, None] >= kpos[None, :]) if causal else np.ones(
        (lq, lk), bool)
    nq, nk = -(-lq // bq), -(-lk // bk)
    return {iq: [ik for ik in range(nk)
                 if vis[iq * bq:(iq + 1) * bq, ik * bk:(ik + 1) * bk].any()]
            for iq in range(nq)}


@pytest.mark.parametrize("bq,bk", TILES)
@pytest.mark.parametrize("lq,lk,causal,q_off,k_off,stride", [
    (256, 256, True, 0, 0, 1),
    (64, 64, True, 16, 32, 1),
    (64, 64, True, 2, 5, 8),
    (64, 64, True, 0, 40, 1),  # rows 0-39 see no key
    (64, 192, False, 0, 0, 1),
    (100, 200, True, 0, 0, 1),
    (130, 130, True, 0, 0, 1),
    (40, 72, True, 0, 0, 1),
    (1024, 1024, True, 1024, 0, 1),  # a ring pair with no key masked
    (1024, 1024, True, 0, 1024, 1),  # a wholly masked ring pair
    (1024, 1024, True, 1, 0, 4),  # striped at stride 4
    (1024, 1024, True, 0, 3, 4),
    (320, 192, True, 0, 300, 3),
])
def test_schedule_matches_brute_force(lq, lk, causal, q_off, k_off, stride,
                                      bq, bk):
    """At shard offsets, position strides and ragged lengths every q-unit
    is walked by exactly one block, over exactly the k-tiles that hold a
    visible pair, in ascending order (the reference's summation order)."""
    sched = tflash.fwd_schedule(lq, lk, bq, bk, causal, q_off, k_off,
                                stride)
    walked = [w for block in sched for w in block]
    assert sorted(u for u, _ in walked) == list(range(-(-lq // bq)))
    assert dict(walked) == _visible_tiles(lq, lk, bq, bk, causal, q_off,
                                          k_off, stride)


@pytest.mark.parametrize("bq,bk", TILES[:2])
def test_diagonal_pair_is_balanced(bq, bk):
    """On the ring's 1024-token shard pair the heaviest block of the
    diagonal (causal, zero offsets) does at most 0.6 of the work of the
    heaviest block of the pair with no key masked, on a grid of as many
    blocks (16 a head either way)."""

    def heaviest(sched):
        return max(sum(len(t) for _, t in block) for block in sched)

    diag = tflash.fwd_schedule(1024, 1024, bq, bk, True, 0, 0, 1)
    full = tflash.fwd_schedule(1024, 1024, bq, bk, True, 1024, 0, 1)
    assert len(diag) == len(full) == 16
    assert heaviest(diag) <= 0.6 * heaviest(full)
    # and the whole causal sequence's blocks carry equal work
    seq = tflash.fwd_schedule(4096, 4096, bq, bk, True, 0, 0, 1)
    work = {sum(len(t) for _, t in block) for block in seq}
    assert max(work) - min(work) <= 1
