"""The plain-torch paged-attention kernel (K1) against the JAX package.

On the CPU ``paged_block`` runs ``paged_block_reference``, the plain
version the CUDA kernel is held against on the card. Here that plain
version, and ``serve/paged.py::paged_attend`` around it (an sp group of
one), meet the reference's Pallas kernel in interpret mode on the
adversarial cases of tests/test_paged_kernel.py (ragged mid-block pos0,
TRASH pages, inactive and all-TRASH rows, W=1 and W=4, int8, GQA), and
the port's own dense attention over the gathered page windows. Float32
tolerances are the reference's (rtol 2e-5, atol 2e-6); dead rows must be
exactly 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_patterns.serve import paged as jpaged
from tpu_patterns.serve import paged_kernel as jpk
from tpu_patterns_torch.convert import pool_from_numpy
from tpu_patterns_torch.models import decode as tdec
from tpu_patterns_torch.serve import paged as tpaged
from tpu_patterns_torch.serve import paged_kernel as tpk

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
B, BL, N_BLOCKS, N_PAGES, D = 3, 8, 10, 3, 8


def _case(*, w, int8, hkv, h=4, seed=0, inactive=None, all_trash=None):
    rng = np.random.RandomState(seed)
    shape = (N_BLOCKS, BL, hkv, D)
    if int8:
        pool = {
            "k": rng.randint(-127, 128, size=shape).astype(np.int8),
            "v": rng.randint(-127, 128, size=shape).astype(np.int8),
            "ks": rng.uniform(0.005, 0.02, size=shape[:3]).astype(np.float32),
            "vs": rng.uniform(0.005, 0.02, size=shape[:3]).astype(np.float32),
        }
    else:
        pool = {
            "k": rng.randn(*shape).astype(np.float32),
            "v": rng.randn(*shape).astype(np.float32),
        }
    q = rng.randn(B, w, h, D).astype(np.float32)
    # distinct physical blocks per row, trash in the unreached tail
    tables = (1 + rng.permutation(N_BLOCKS - 1)[: B * N_PAGES]).reshape(
        B, N_PAGES
    ).astype(np.int32)
    tables[0, 2] = jpk.TRASH_BLOCK  # row 0 never grew a third page
    if all_trash is not None:
        tables[all_trash] = jpk.TRASH_BLOCK
    pos0 = np.asarray([5, 11, 2], np.int32)  # ragged, mid-block
    active = np.ones(B, bool)
    if inactive is not None:
        active[inactive] = False
    return pool, q, tables, pos0, active


CASES = {
    "decode_w1": dict(w=1, int8=False, hkv=2),
    "verify_w4": dict(w=4, int8=False, hkv=2, seed=1),
    "int8_w1": dict(w=1, int8=True, hkv=2, seed=2),
    "int8_w4": dict(w=4, int8=True, hkv=2, seed=3),
    "mha_w1": dict(w=1, int8=False, hkv=4, seed=4),
    "gqa4_w4": dict(w=4, int8=False, hkv=1, seed=5),
    "inactive_row": dict(w=1, int8=False, hkv=2, inactive=1),
    "all_trash_row": dict(w=1, int8=False, hkv=2, all_trash=2),
    "int8_inactive_w4": dict(w=4, int8=True, hkv=2, seed=6, inactive=0),
}


def _torch_args(pool, q, tables, pos0, active):
    return (pool_from_numpy(pool), torch.from_numpy(q),
            torch.from_numpy(tables), torch.from_numpy(pos0),
            torch.from_numpy(active))


def _dead_rows(case):
    return [r for r in (case.get("inactive"), case.get("all_trash"))
            if r is not None]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_kernel_matches_pallas_interpret(name):
    case = CASES[name]
    pool, q, tables, pos0, active = _case(**case)
    jl = jpaged.PagedLayout(N_BLOCKS, BL, sp=1)
    jpool = {n: jnp.asarray(a) for n, a in pool.items()}
    jargs = (jnp.asarray(q), jnp.asarray(tables), jnp.asarray(pos0),
             jnp.asarray(active))
    tpool, tq, ttab, tpos, tact = _torch_args(pool, q, tables, pos0, active)

    # the raw unnormalized triple, then the normalized attention
    jo, jm, jlse = jpk.paged_block(
        jargs[0], jpool["k"], jpool["v"], *jargs[1:], block_len=BL, rank=0,
        k_scale=jpool.get("ks"), v_scale=jpool.get("vs"), interpret=True,
    )
    to, tm, tl = tpk.paged_block(
        tq, tpool["k"], tpool["v"], ttab, tpos, tact, block_len=BL,
        k_scale=tpool.get("ks"), v_scale=tpool.get("vs"),
    )
    for got, want in ((to, jo), (tm, jm), (tl, jlse)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)

    want = jpk.paged_attend(jpool, *jargs, jl, None, interpret=True)
    (got,) = tpaged.paged_attend([tpool], [tq], [ttab], [tpos], [tact],
                                 tpaged.PagedLayout(N_BLOCKS, BL))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    for r in _dead_rows(case):
        assert torch.all(torch.isfinite(got[r])) and torch.all(got[r] == 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_kernel_matches_dense_pool_attend(name):
    """The fused path against the port's own gather -> dense-attention
    path with the verify layer's mask (W=1 is the decode mask)."""
    case = CASES[name]
    pool, q, tables, pos0, active = _case(**case)
    tpool, tq, ttab, tpos, tact = _torch_args(pool, q, tables, pos0, active)
    layout = tpaged.PagedLayout(N_BLOCKS, BL)
    w = q.shape[1]
    posn = layout.page_positions(N_PAGES, "cpu")
    tvalid = (ttab > 0).repeat_interleave(BL, dim=1)
    pos = tpos[:, None] + torch.arange(w)[None, :]
    mask = ((posn[None, None, :] <= pos[:, :, None]) & tvalid[:, None, :]
            & tact[:, None, None])
    win = tpaged._windows(tpool, ttab, layout)
    want = tdec._distributed_attention(tq, win["k"], win["v"], mask,
                                       k_scale=win.get("ks"),
                                       v_scale=win.get("vs"))
    (got,) = tpaged.paged_attend([tpool], [tq], [ttab], [tpos], [tact],
                                 layout)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    for r in _dead_rows(case):
        assert torch.all(got[r] == 0)


def test_kernel_counter_counts_only_launches():
    """CPU tensors take the plain version: the launch counter is for the
    CUDA kernel alone."""
    pool, q, tables, pos0, active = _case(w=1, int8=False, hkv=2)
    tpool, tq, ttab, tpos, tact = _torch_args(pool, q, tables, pos0, active)
    before = tpk.paged_block.launches
    tpk.paged_block(tq, tpool["k"], tpool["v"], ttab, tpos, tact,
                    block_len=BL)
    assert tpk.paged_block.launches == before


def test_other_devices_raise():
    pool, q, tables, pos0, active = _case(w=1, int8=False, hkv=2)
    meta = torch.empty((B, 1, 4, D), device="meta")
    tpool, _, ttab, tpos, tact = _torch_args(pool, q, tables, pos0, active)
    with pytest.raises(ValueError, match="no kernel"):
        tpk.paged_block(meta, tpool["k"], tpool["v"], ttab, tpos, tact,
                        block_len=BL)


# pages a split: one page, two (which does not divide N_PAGES = 3), and
# the whole row in one split
SPLITS = (1, 2, N_PAGES)


@pytest.mark.parametrize("pps", SPLITS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_reference_matches_pallas_and_plain(name, pps):
    """The kernel's split-and-combine algorithm in plain torch against
    the reference's Pallas kernel in interpret mode and against the
    one-pass plain version; dead rows come out exactly 0."""
    case = CASES[name]
    pool, q, tables, pos0, active = _case(**case)
    jpool = {n: jnp.asarray(a) for n, a in pool.items()}
    jo, jm, jl = jpk.paged_block(
        jnp.asarray(q), jpool["k"], jpool["v"], jnp.asarray(tables),
        jnp.asarray(pos0), jnp.asarray(active), block_len=BL, rank=0,
        k_scale=jpool.get("ks"), v_scale=jpool.get("vs"), interpret=True,
    )
    tpool, tq, ttab, tpos, tact = _torch_args(pool, q, tables, pos0, active)
    args = (tq, tpool["k"], tpool["v"], ttab, tpos, tact)
    kw = dict(block_len=BL, k_scale=tpool.get("ks"),
              v_scale=tpool.get("vs"))
    got = tpk.paged_block_split_reference(*args, pages_per_split=pps, **kw)
    plain = tpk.paged_block_reference(*args, **kw)
    for g, want, p in zip(got, (jo, jm, jl), plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=RTOL,
                                   atol=ATOL)
    o, m, l = got
    for r in _dead_rows(case):
        assert torch.all(o[r] == 0) and torch.all(l[r] == 0)
        assert torch.all(m[r] == tpk.NEG_INF)


def _edge_case(kind, seed):
    """Six pages of four slots: ``dead_split`` has every page of its
    second split (pages 2-3 at two pages a split) TRASH between live
    ones; ``last_split_only`` gives row 1 a single live page, the last,
    and row 2 a window ending inside its first split."""
    rng = np.random.RandomState(seed)
    b, bl, n_pages, n_blocks, hkv, h, w = 3, 4, 6, 20, 2, 4, 2
    pool = {n: rng.randn(n_blocks, bl, hkv, D).astype(np.float32)
            for n in ("k", "v")}
    q = rng.randn(b, w, h, D).astype(np.float32)
    tables = (1 + rng.permutation(n_blocks - 1)[: b * n_pages]).reshape(
        b, n_pages).astype(np.int32)
    pos0 = np.asarray([21, 20, 1], np.int32)
    if kind == "dead_split":
        tables[:, 2:4] = jpk.TRASH_BLOCK
    else:
        tables[1, :-1] = jpk.TRASH_BLOCK
    return pool, q, tables, pos0, np.ones(b, bool), bl


@pytest.mark.parametrize("kind", ["dead_split", "last_split_only"])
def test_split_edges_match_pallas(kind):
    pool, q, tables, pos0, active, bl = _edge_case(kind, seed=7)
    jpool = {n: jnp.asarray(a) for n, a in pool.items()}
    want = jpk.paged_block(
        jnp.asarray(q), jpool["k"], jpool["v"], jnp.asarray(tables),
        jnp.asarray(pos0), jnp.asarray(active), block_len=bl, rank=0,
        interpret=True,
    )
    tpool, tq, ttab, tpos, tact = _torch_args(pool, q, tables, pos0, active)
    for pps in (1, 2, 4):
        got = tpk.paged_block_split_reference(
            tq, tpool["k"], tpool["v"], ttab, tpos, tact, block_len=bl,
            pages_per_split=pps)
        for g, w_ in zip(got, want):
            assert torch.all(torch.isfinite(g))
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("n_pages,block_len,b,hkv,row_bytes", [
    (36, 16, 8, 8, 256),     # the serve shape, bf16 D 128: 9 splits of 4
    (256, 16, 32, 8, 256),   # a long window: 16 splits of 4 stages
    (36, 16, 1, 8, 256),     # one row: smaller splits fill the SMs
    (5, 8, 4, 1, 256),
    (3, 8, 3, 2, 32),        # f32 D 8 rows: a split of every page
    (7, 64, 2, 2, 1024),     # f32 D 256 at block_len 64: a page a split
    (1, 16, 1, 1, 128),
    (4096, 16, 64, 8, 128),  # int8 D 128 at 64K tokens
])
def test_split_plan_covers_each_page_once(n_pages, block_len, b, hkv,
                                          row_bytes):
    """The split plan, from shapes alone, covers every page exactly once
    in order; a split is at most ``MAX_STAGES`` stages, each at most
    ``STAGE_BYTES`` of K and V unless it is a single page; the serve
    shape gets 9 splits of one 4-page stage, the long window 16 splits
    of four."""
    pps = tpk.split_pages(n_pages, block_len, b, hkv, row_bytes, 132)
    sp = tpk.stage_pages(block_len, row_bytes)
    plan = tpk.split_plan(n_pages, pps)
    assert plan[0][0] == 0 and plan[-1][1] == n_pages
    assert all(a[1] == c[0] for a, c in zip(plan, plan[1:]))
    assert all(0 < stop - start <= pps for start, stop in plan)
    assert pps <= tpk.MAX_STAGES * sp
    assert sp == 1 or 2 * sp * block_len * row_bytes <= tpk.STAGE_BYTES
    if (n_pages, b) == (36, 8):
        assert (pps, sp, len(plan)) == (4, 4, 9)
    if (n_pages, b) == (256, 32):
        assert (pps, sp, len(plan)) == (16, 4, 16)
