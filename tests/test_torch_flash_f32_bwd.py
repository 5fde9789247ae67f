"""The float32 flash backward's (K4: dq, dk/dv) plan on the CPU: its
tile ladder, its shared-memory model, its shape check and its block
schedule (``flash.bwd_f32_schedule``, the Python mirror of
``flash_attention_bwd.cu``'s ``flash_bwd_{dq,dkv}_f32_kernel`` walks)
against the JAX package's causal pair tables and a brute-force search
for the tiles that hold a visible (query, key) pair.  The kernels
themselves run only on the card (``chip_smoke.py`` phases 1, 4 and
19)."""

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

# the card's f32 backward callers and the units each kernel owns: flash
# --grad (L4096 x 8 heads: 32 pairs of 64-entry units a head, 256
# blocks, more than the 132 SMs), ulysses_pallas at sp 4 (x 2 heads a
# rank: 64, so 32-entry units), the ring's 1024-token shard pairs (x 8
# heads: 64, so 32) and the flagship's f32 leg (batch 4 x 8 heads
# folded into 32)
CALLERS = [(4096, 4096, 8, 64), (4096, 4096, 2, 32), (1024, 1024, 8, 32),
           (4096, 4096, 32, 64)]


def _region(nbytes):
    return -(-nbytes // 128) * 128


def _tiles(kind, own, d):
    """The kernel's (bq, bk): a 32-entry unit by tiles of head_dim, a
    64-entry unit by tiles of 64; dq owns rows, dk/dv keys."""
    other = 64 if own == 64 else d
    return (own, other) if kind == "dq" else (other, own)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("lq,lk,h,own", CALLERS)
def test_f32_backward_tile_ladder(d, lq, lk, h, own):
    """Each f32 backward kernel's ladder: the largest owned side <= the
    request whose grid of unit pairs holds a block for every SM (else
    32), by tiles of head_dim beside 32 and of 64 beside 64; the wrapper
    (on meta tensors of the callers' shapes) gives each kernel its pair,
    and both fit the card's shared memory."""
    assert tuning.BWD_F32_SIDES == (64, 32)
    q = torch.empty((lq, h, d), device="meta")
    k = torch.empty((lk, h, d), device="meta")
    want = {kind: _tiles(kind, own, d) for kind in ("dq", "dkv")}
    assert tflash._bwd_tiles(q, k, 1024, 1024) == want
    assert tflash._bwd_tiles(q, k, 512, 512) == want
    for kind in ("dq", "dkv"):
        for req, side in ((1024, own), (64, own), (48, 32), (16, 32)):
            assert tuning._auto_block(lq, lk, d, 4, (kind,), req, req,
                                      heads=h) == _tiles(kind, side, d)
        assert tuning.smem_bytes(kind, *want[kind], d, 4) <= (
            tuning.H100_SMEM_OPTIN)
        # a card of fewer SMs fills sooner
        assert tuning._auto_block(lq, lk, d, 4, (kind,), 1024, 1024,
                                  heads=h, sms=16) == _tiles(kind, 64, d)
        assert tflash._bwd_legal(torch.float32, d)[kind] == {
            _tiles(kind, s, d) for s in tuning.BWD_F32_SIDES}


def test_f32_backward_ladder_sizes_each_kernel_by_its_own_length():
    """dq sizes its units by Lq, dk/dv by Lk: a short query shard beside
    a long key sequence gives dq the small unit and dk/dv the large."""
    q = torch.empty((512, 16, 128), device="meta")
    k = torch.empty((4096, 16, 128), device="meta")
    assert tflash._bwd_tiles(q, k, 1024, 1024) == {"dq": (32, 128),
                                                   "dkv": (64, 64)}


@pytest.mark.parametrize("kind,tiles,d,want", [
    ("dq", (32, 128), 128, 187392), ("dq", (64, 64), 128, 152576),
    ("dq", (32, 64), 64, 61440), ("dq", (64, 64), 64, 87040),
    ("dkv", (128, 32), 128, 206848), ("dkv", (64, 64), 128, 170496),
    ("dkv", (64, 32), 64, 71168), ("dkv", (64, 64), 64, 104960),
])
def test_f32_backward_smem_regions(kind, tiles, d, want):
    """smem_bytes("dq"|"dkv", ..., 4) is the kernels' carve, region by
    region, each 128-B aligned ([rows][D] tiles padded by 4 floats): dq's
    q, dO, k, v and dS^T [bk][bq + 4]; dk/dv's k, v, q, dO, P and dS
    [bq][bk + 4] and the rows' lse and delta.  Every tile fits a block's
    232,448 B, and the design's blocks an SM fit: one at D 128, three
    (32-entry units) or two (64) at D 64."""
    bq, bk = tiles
    row = (d + 4) * 4
    regions = ([bq * row, bq * row, bk * row, bk * row, bk * (bq + 4) * 4]
               if kind == "dq" else
               [bk * row, bk * row, bq * row, bq * row, bq * (bk + 4) * 4,
                bq * (bk + 4) * 4, bq * 4, bq * 4])
    got = tuning.smem_bytes(kind, bq, bk, d, 4)
    assert got == sum(_region(n) for n in regions) == want
    assert got <= tuning.H100_SMEM_OPTIN
    own = bq if kind == "dq" else bk
    blocks = 1 if d == 128 else 3 if own == 32 else 2
    assert blocks * (got + 1024) <= SM_SMEM


def test_f32_backward_larger_tiles_do_not_fit():
    """Why the 64-entry unit streams 64 at D 128: by tiles of 128 it
    would pass the 227 KB a block may have."""
    assert tuning.smem_bytes("dq", 64, 128, 128, 4) > tuning.H100_SMEM_OPTIN
    assert tuning.smem_bytes("dkv", 128, 64, 128, 4) > tuning.H100_SMEM_OPTIN


def _cpu(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("dtype,d,tiles", [
    (torch.float32, 96, {"dq": (32, 96), "dkv": (96, 32)}),
    (torch.float32, 16, {"dq": (32, 64), "dkv": (64, 32)}),
    (torch.float32, 256, {"dq": (32, 256), "dkv": (256, 32)}),
    (torch.float32, 128, {"dq": (64, 128), "dkv": (128, 32)}),
    (torch.float32, 128, {"dq": (32, 128), "dkv": (128, 64)}),
    (torch.float32, 128, {"dq": (32, 64), "dkv": (128, 32)}),
    (torch.float32, 64, {"dq": (16, 64), "dkv": (64, 32)}),
    (torch.bfloat16, 128, {"dq": (32, 64), "dkv": (64, 64)}),
])
def test_launch_bwd_shape_check(dtype, d, tiles):
    """``_launch_bwd`` refuses a head_dim or tile its kernels do not take
    before it builds or launches anything: float32 head_dim 64 or 128
    and dq (32, D) or (64, 64), dk/dv (D, 32) or (64, 64)."""
    q = _cpu((64, 2, d), dtype)
    lse = _cpu((2, 64))
    with pytest.raises(ValueError, match="head_dim 64 or 128"):
        tflash._launch_bwd(q, q, q, q, lse, lse, 0, 0, True, 0.1, tiles, 1)


@pytest.mark.parametrize("d", [64, 128])
def test_launch_bwd_takes_the_ladders_tiles(d):
    """Every pair the ladder gives passes the shape check (the legal
    sets are the ladder's)."""
    legal = tflash._bwd_legal(torch.float32, d)
    for heads in (1, 64):
        q = torch.empty((4096, heads, d), device="meta")
        for kind, tiles in tflash._bwd_tiles(q, q, 1024, 1024).items():
            assert tiles in legal[kind]


def test_f32_backward_ragged_lengths_and_requests():
    """The f32 backward takes ragged lengths at the default request (its
    kernels mask the edge; on the CPU the plain version runs), an
    explicit request that does not divide the lengths keeps the
    reference's error, and dq of rows that see no key is exactly zero."""
    g = np.random.RandomState(5)
    q, do = (torch.from_numpy(g.randn(100, 2, 64).astype(np.float32))
             for _ in range(2))
    k = torch.from_numpy(g.randn(200, 2, 64).astype(np.float32))
    lse = torch.from_numpy(g.rand(2, 100).astype(np.float32))
    lse[:, :50] = 0.0  # rows that see no key carry lse 0 (_row_stats)
    delta = torch.from_numpy(g.randn(2, 100).astype(np.float32))
    dq, dk, dv = tflash.flash_block_bwd(q, k, k, do, lse, delta, 0, 50,
                                        causal=True)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert torch.equal(dq[:50], torch.zeros_like(dq[:50]))
    assert bool((dq[50:] != 0).any())
    with pytest.raises(ValueError, match="divide"):
        tflash.flash_block_bwd(q, k, k, do, lse, delta, block_q=48,
                               block_k=64)


def _rows(schedule):
    """(unit, tile, is_first, is_last) rows of a schedule, units in
    ascending order: the layout of the reference's pair tables."""
    rows = []
    for unit, tiles in sorted(w for block in schedule for w in block):
        for pos, t in enumerate(tiles):
            rows.append((unit, t, int(pos == 0), int(pos == len(tiles) - 1)))
    return np.asarray(rows, np.int32).reshape(-1, 4).T


# (bq, bk) of each kernel: both units, D 64 and 128
TILES = {"dq": [(32, 64), (32, 128), (64, 64)],
         "dkv": [(64, 32), (128, 32), (64, 64)]}


@pytest.mark.parametrize("kind,bq,bk", [(k, *t) for k, ts in TILES.items()
                                        for t in ts])
@pytest.mark.parametrize("nq,nk", [(4, 2), (8, 4), (3, 2), (7, 5), (1, 1),
                                   (2, 4), (32, 16)])
def test_schedule_matches_reference_pair_tables(kind, nq, nk, bq, bk):
    """At zero offsets the live (unit, tile) pairs are the reference's
    table at the same tile: iq-major for dq, jk-major for dk/dv.  Block
    p takes units n - 1 - p and p (dq) or p and n - 1 - p (dk/dv), the
    heavier first, so block 0 holds the heaviest unit."""
    sched = tflash.bwd_f32_schedule(kind, nq * bq, nk * bk, bq, bk)
    table = (jflash._causal_pair_table if kind == "dq"
             else jflash._causal_pair_table_kmajor)
    np.testing.assert_array_equal(_rows(sched), table(nq, nk, bq, bk))
    n = nq if kind == "dq" else nk
    assert len(sched) == (n + 1) // 2
    for p, block in enumerate(sched):
        units = (n - 1 - p, p) if kind == "dq" else (p, n - 1 - p)
        assert [u for u, _ in block] == list(dict.fromkeys(units))
        assert len(block[0][1]) >= len(block[-1][1])


def _visible_tiles(kind, lq, lk, bq, bk, causal, q_off, k_off, stride):
    """{unit: [tiles holding a visible pair, ascending]} by brute force."""
    qpos = q_off + np.arange(lq) * stride
    kpos = k_off + np.arange(lk) * stride
    vis = (qpos[:, None] >= kpos[None, :]) if causal else np.ones(
        (lq, lk), bool)
    nq, nk = -(-lq // bq), -(-lk // bk)
    out = {}
    for iq in range(nq):
        for ik in range(nk):
            if vis[iq * bq:(iq + 1) * bq, ik * bk:(ik + 1) * bk].any():
                unit, tile = (iq, ik) if kind == "dq" else (ik, iq)
                out.setdefault(unit, []).append(tile)
    units = nq if kind == "dq" else nk
    return {u: sorted(out.get(u, [])) for u in range(units)}


@pytest.mark.parametrize("kind,bq,bk", [(k, *t) for k, ts in TILES.items()
                                        for t in ts])
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
    (192, 320, True, 256, 0, 2),
])
def test_schedule_matches_brute_force(kind, lq, lk, causal, q_off, k_off,
                                      stride, bq, bk):
    """At shard offsets, position strides and ragged lengths every unit
    is walked by exactly one block, over exactly the tiles that hold a
    visible pair, in ascending order (the reference's summation order):
    each visible (query, key) pair is summed once."""
    sched = tflash.bwd_f32_schedule(kind, lq, lk, bq, bk, causal, q_off,
                                    k_off, stride)
    walked = [w for block in sched for w in block]
    n = -(-lq // bq) if kind == "dq" else -(-lk // bk)
    assert sorted(u for u, _ in walked) == list(range(n))
    assert dict(walked) == _visible_tiles(kind, lq, lk, bq, bk, causal,
                                          q_off, k_off, stride)


def _work(block):
    return sum(len(t) for _, t in block)


@pytest.mark.parametrize("kind,bq,bk", [(k, *t) for k, ts in TILES.items()
                                        for t in ts])
def test_diagonal_pair_is_balanced(kind, bq, bk):
    """On the ring's 1024-token shard pair the heaviest block of the
    diagonal (causal, zero offsets) does at most 0.6 of the work of the
    heaviest block of the pair with no key masked, on a grid of as many
    blocks; and a whole causal sequence's blocks carry equal work."""
    diag = tflash.bwd_f32_schedule(kind, 1024, 1024, bq, bk, True, 0, 0, 1)
    full = tflash.bwd_f32_schedule(kind, 1024, 1024, bq, bk, True, 1024, 0,
                                   1)
    assert len(diag) == len(full)
    assert max(map(_work, diag)) <= 0.6 * max(map(_work, full))
    seq = tflash.bwd_f32_schedule(kind, 4096, 4096, bq, bk, True, 0, 0, 1)
    work = {_work(block) for block in seq}
    assert max(work) - min(work) <= 1
