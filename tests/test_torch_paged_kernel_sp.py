"""K1 at sp > 1 (the plain versions on one rank's stripe of each block)
against the JAX package, and the sp combine over the stripes.

Over sp ranks each rank holds a stripe of every pool block: rank r's
shard pool is ``pool[:, r * bl_loc:(r + 1) * bl_loc]`` (``bl_loc =
block_len / sp``), its slot s of page j at global position ``j *
block_len + r * bl_loc + s``. Here the port's ``paged_block_reference``
and ``paged_block_split_reference`` on such a shard, at every rank of sp
2 and 4, meet the reference's Pallas kernel in interpret mode at the
same ``rank``, on the adversarial cases of
tests/test_torch_paged_kernel.py (ragged mid-block pos0, TRASH pages,
inactive and all-TRASH rows, W=1 and W=4, int8, GQA) and on rows whose
window ends below ``bl_loc`` (the upper ranks see nothing of them).
Float32 tolerances are the reference's (rtol 2e-5, atol 2e-6). Then
``serve/paged.py::paged_attend``'s combine over the stripes must give
the unsharded attention on the whole pool, dead rows exactly 0, and two
planted faults in the combine (a per-rank max, one rank's weighted
values left out) must each miss it by far more than the tolerance."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_patterns.serve import paged as jpaged
from tpu_patterns.serve import paged_kernel as jpk
from tpu_patterns_torch.convert import pool_from_numpy
from tpu_patterns_torch.serve import paged as tpaged
from tpu_patterns_torch.serve import paged_kernel as tpk

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
B, BL, N_BLOCKS, N_PAGES, D = 3, 8, 10, 3, 8
SPS = (2, 4)


def _case(*, w, int8, hkv, h=4, seed=0, inactive=None, all_trash=None,
          pos0=(5, 11, 2)):
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
    tables = (1 + rng.permutation(N_BLOCKS - 1)[: B * N_PAGES]).reshape(
        B, N_PAGES
    ).astype(np.int32)
    tables[0, 2] = jpk.TRASH_BLOCK  # row 0 never grew a third page
    if all_trash is not None:
        tables[all_trash] = jpk.TRASH_BLOCK
    active = np.ones(B, bool)
    if inactive is not None:
        active[inactive] = False
    return pool, q, tables, np.asarray(pos0, np.int32), active


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
    # windows ending inside page 0 below bl_loc (2 at sp 4, 4 at sp 2):
    # the upper ranks hold no visible key of rows 0 and 1
    "low_pos0_w1": dict(w=1, int8=False, hkv=2, seed=7, pos0=(1, 0, 3)),
    "low_pos0_int8_w4": dict(w=4, int8=True, hkv=2, seed=8,
                             pos0=(0, 1, 6)),
}


def _stripe(pool: dict, sp: int, r: int) -> dict:
    """Rank r's shard of a global pool: slots [r * bl_loc, (r+1) * bl_loc)
    of every block."""
    bl = BL // sp
    return {n: np.ascontiguousarray(a[:, r * bl:(r + 1) * bl])
            for n, a in pool.items()}


def _torch_args(q, tables, pos0, active):
    return (torch.from_numpy(q), torch.from_numpy(tables),
            torch.from_numpy(pos0), torch.from_numpy(active))


def _dead_rows(case):
    return [r for r in (case.get("inactive"), case.get("all_trash"))
            if r is not None]


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_stripe_matches_pallas_interpret(name, sp):
    """At ranks 0, 1 and sp - 1: the port's one-pass and split plain
    versions (and ``paged_block`` on CPU tensors) on the rank's stripe
    against the reference's kernel at that rank; a row the rank sees
    nothing of has m = NEG_INF and exact zeros."""
    case = CASES[name]
    pool, q, tables, pos0, active = _case(**case)
    tq, ttab, tpos, tact = _torch_args(q, tables, pos0, active)
    for r in sorted({0, 1, sp - 1}):
        shard = _stripe(pool, sp, r)
        jpool = {n: jnp.asarray(a) for n, a in shard.items()}
        want = jpk.paged_block(
            jnp.asarray(q), jpool["k"], jpool["v"], jnp.asarray(tables),
            jnp.asarray(pos0), jnp.asarray(active), block_len=BL, rank=r,
            k_scale=jpool.get("ks"), v_scale=jpool.get("vs"),
            interpret=True,
        )
        tpool = pool_from_numpy(shard)
        args = (tq, tpool["k"], tpool["v"], ttab, tpos, tact)
        kw = dict(block_len=BL, rank=r, k_scale=tpool.get("ks"),
                  v_scale=tpool.get("vs"))
        runs = [tpk.paged_block(*args, **kw),
                tpk.paged_block_reference(*args, **kw)]
        runs += [tpk.paged_block_split_reference(*args, pages_per_split=pps,
                                                 **kw) for pps in (1, 2)]
        for got in runs:
            for g, w_ in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w_),
                                           rtol=RTOL, atol=ATOL)
            o, m, l = got
            blind = m == tpk.NEG_INF
            assert torch.all(o[blind] == 0) and torch.all(l[blind] == 0)
        # a row whose last query lies below this rank's stripe of page 0
        # sees nothing here (the low_pos0 cases' rows at sp > 1)
        below = pos0 + q.shape[1] - 1 < r * (BL // sp)
        assert torch.all(runs[0][1][torch.from_numpy(below)] == tpk.NEG_INF)


@functools.lru_cache(maxsize=None)
def _reference_attend(name):
    """The reference's unsharded attention (interpret mode) of a case."""
    pool, q, tables, pos0, active = _case(**CASES[name])
    jpool = {n: jnp.asarray(a) for n, a in pool.items()}
    return np.asarray(jpk.paged_attend(
        jpool, jnp.asarray(q), jnp.asarray(tables), jnp.asarray(pos0),
        jnp.asarray(active), jpaged.PagedLayout(N_BLOCKS, BL, sp=1), None,
        interpret=True))


def _combined(pool, q, tables, pos0, active, sp):
    layout = tpaged.PagedLayout(N_BLOCKS, BL, sp)
    tq, ttab, tpos, tact = _torch_args(q, tables, pos0, active)
    return tpaged.paged_attend(
        [pool_from_numpy(_stripe(pool, sp, r)) for r in range(sp)],
        [tq] * sp, [ttab] * sp, [tpos] * sp, [tact] * sp, layout)


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_combine_matches_unsharded(name, sp):
    """The sp group's combine over the stripes: every rank's output
    equals the unsharded attention on the whole pool (the port's and the
    reference's interpret-mode one); dead rows exactly 0."""
    case = CASES[name]
    pool, q, tables, pos0, active = _case(**case)
    tq, ttab, tpos, tact = _torch_args(q, tables, pos0, active)
    (one,) = tpaged.paged_attend([pool_from_numpy(pool)], [tq], [ttab],
                                 [tpos], [tact],
                                 tpaged.PagedLayout(N_BLOCKS, BL))
    ref = _reference_attend(name)
    outs = _combined(pool, q, tables, pos0, active, sp)
    assert len(outs) == sp
    for got in outs:
        assert got.shape == q.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
        for r in _dead_rows(case):
            assert torch.all(torch.isfinite(got[r]))
            assert torch.all(got[r] == 0)


def _numer_left_out(orig):
    """The combine's sum of weighted values [B, Hkv, G*W, D] leaves the
    group's last rank out (the normalizers are summed whole)."""
    def wrap(xs):
        if xs[0].dim() == 4:
            return orig(list(xs[:-1]) + [xs[-1] * 0])
        return orig(xs)

    return wrap


FAULTS = {
    "per_rank_max": ("_sp_max", lambda orig: list),
    "numer_left_out": ("_sp_sum", _numer_left_out),
}


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_combine_faults_miss_the_unsharded(fault, sp, monkeypatch):
    """Each planted fault moves some rank's output off the unsharded
    attention by far more than the tolerance: the comparison above would
    catch it."""
    pool, q, tables, pos0, active = _case(**CASES["verify_w4"])
    tq, ttab, tpos, tact = _torch_args(q, tables, pos0, active)
    (one,) = tpaged.paged_attend([pool_from_numpy(pool)], [tq], [ttab],
                                 [tpos], [tact],
                                 tpaged.PagedLayout(N_BLOCKS, BL))
    one = one.numpy()
    attr, wrap = FAULTS[fault]
    monkeypatch.setattr(tpaged, attr, wrap(getattr(tpaged, attr)))
    outs = _combined(pool, q, tables, pos0, active, sp)
    err = max(float(np.abs(o.numpy() - one).max()) for o in outs)
    assert err > 1e3 * (ATOL + RTOL * float(np.abs(one).max()))


@pytest.mark.parametrize("sp", SPS)
def test_launch_refuses_a_rank_outside_the_blocks(sp):
    """The CUDA wrapper's checks, which run before the library loads: a
    rank past block_len / bl_loc, or a pool block that does not divide
    block_len, is refused."""
    d = 32  # a head_dim the kernel takes, so the stripe check is reached
    k = torch.zeros((N_BLOCKS, BL // sp, 2, d))
    q = torch.zeros((B, 1, 4, d))
    _, _, tables, pos0, active = _case(**CASES["decode_w1"])
    _, ttab, tpos, tact = _torch_args(np.zeros(1), tables, pos0, active)
    for block_len, rank in ((BL, sp), (BL, -1), (BL + 1, 0)):
        with pytest.raises(ValueError, match="no stripe"):
            tpk._launch_kernel(q, k, k, ttab, tpos, tact,
                               block_len, rank, None, None)


@pytest.mark.parametrize("sp", (1, *SPS))
def test_layout_write_slot_and_page_positions_agree(sp):
    """Each in-block offset has exactly one owning rank, and the slot it
    writes there is the one ``page_positions`` maps back to the same
    global position; the reference's layout agrees."""
    lay = tpaged.PagedLayout(N_BLOCKS, BL, sp)
    jlay = jpaged.PagedLayout(N_BLOCKS, BL, sp)
    assert lay.bl_loc == jlay.bl_loc == BL // sp
    tables = torch.arange(1, 1 + 2 * N_PAGES, dtype=torch.int32).reshape(
        2, N_PAGES)
    pos = torch.arange(N_PAGES * BL, dtype=torch.int32)[None].expand(2, -1)
    owners = torch.zeros_like(pos)
    for r in range(sp):
        phys, off, own = lay.write_slot(pos, tables, r)
        owners += own.to(owners.dtype)
        posn = lay.page_positions(N_PAGES, "cpu", r)
        np.testing.assert_array_equal(
            posn.numpy(), np.asarray(jlay.page_positions(N_PAGES, None)
                                     if sp == 1 else _jpositions(jlay, r)))
        page = (pos // BL).long()
        slot = page * lay.bl_loc + off.long()
        assert torch.equal(posn[slot][own], pos[own])
        assert torch.equal(phys, tables.gather(1, page))
    assert torch.all(owners == 1)


def _jpositions(jlay, r):
    """The reference's ``page_positions`` at sp rank r (its rank comes
    from the mesh axis inside shard_map; here it is set directly)."""
    jlay._rank = lambda axis: r
    return jlay.page_positions(N_PAGES, "sp")
