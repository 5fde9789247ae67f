"""The plain-torch paged-attention kernel (K1) against the JAX package.

On the CPU ``paged_block`` runs ``paged_block_reference``, the plain
version the CUDA kernel is held against on the card.  Here that plain
version, and ``paged_attend`` around it, meet the reference's Pallas
kernel in interpret mode on the adversarial cases of
tests/test_paged_kernel.py (ragged mid-block pos0, TRASH pages, inactive
and all-TRASH rows, W=1 and W=4, int8, GQA), and the port's own dense
``_pool_attend`` path.  Float32 tolerances are the reference's (rtol
2e-5, atol 2e-6); dead rows must be exactly 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_patterns.serve import paged as jpaged
from tpu_patterns.serve import paged_kernel as jpk
from tpu_patterns_torch.convert import pool_from_numpy
from tpu_patterns_torch.serve import paged as tpaged
from tpu_patterns_torch.serve import paged_kernel as tpk

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
    got = tpk.paged_attend(tpool, tq, ttab, tpos, tact,
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
    want = tpaged._pool_attend(tpool, tq, ttab, mask, layout)
    got = tpk.paged_attend(tpool, tq, ttab, tpos, tact, layout)
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
