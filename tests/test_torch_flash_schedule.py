"""The bf16 backward kernels' tile walk (``flash.bwd_schedule``, the
Python mirror of ``flash_attention_bwd.cu``'s plan) against the JAX
package's causal pair tables and against a brute-force search for the
tiles that hold a visible (query, key) pair."""

import numpy as np
import pytest

from tpu_patterns.longctx import flash as jflash
from tpu_patterns_torch.longctx import flash as tflash

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)


def _rows(schedule):
    """(block, tile, is_first, is_last) rows of a schedule, blocks in
    ascending order: the layout of the reference's pair tables."""
    rows = []
    for block, tiles in sorted(schedule):
        for pos, t in enumerate(tiles):
            rows.append((block, t, int(pos == 0),
                         int(pos == len(tiles) - 1)))
    return np.asarray(rows, np.int32).reshape(-1, 4).T


@pytest.mark.parametrize("nq,nk,bq,bk", [
    (4, 4, 64, 64), (2, 4, 128, 64), (4, 2, 64, 128), (3, 5, 64, 64),
    (32, 64, 128, 64), (64, 32, 64, 128), (1, 1, 128, 64),
])
def test_schedule_matches_reference_pair_tables(nq, nk, bq, bk):
    """At zero offsets and unit stride the dq walk is the reference's
    iq-major table and the dk/dv walk its jk-major one; the heaviest
    blocks come first (the last q-tiles, the first k-tiles)."""
    lq, lk = nq * bq, nk * bk
    dq = tflash.bwd_schedule("dq", lq, lk, bq, bk)
    dkv = tflash.bwd_schedule("dkv", lq, lk, bq, bk)
    np.testing.assert_array_equal(
        _rows(dq), jflash._causal_pair_table(nq, nk, bq, bk))
    np.testing.assert_array_equal(
        _rows(dkv), jflash._causal_pair_table_kmajor(nq, nk, bq, bk))
    assert [b for b, _ in dq] == list(range(nq))[::-1]
    assert [b for b, _ in dkv] == list(range(nk))
    work = [len(t) for _, t in dq] + [-len(t) for _, t in dkv]
    assert work[:nq] == sorted(work[:nq], reverse=True)
    assert work[nq:] == sorted(work[nq:])


def _visible_tiles(kind, lq, lk, bq, bk, causal, q_off, k_off, stride):
    """{block: [tiles holding a visible pair, ascending]} by brute force."""
    qpos = q_off + np.arange(lq) * stride
    kpos = k_off + np.arange(lk) * stride
    vis = (qpos[:, None] >= kpos[None, :]) if causal else np.ones(
        (lq, lk), bool)
    nq, nk = -(-lq // bq), -(-lk // bk)
    out = {}
    for iq in range(nq):
        for ik in range(nk):
            if vis[iq * bq:(iq + 1) * bq, ik * bk:(ik + 1) * bk].any():
                block, tile = (iq, ik) if kind == "dq" else (ik, iq)
                out.setdefault(block, []).append(tile)
    blocks = nq if kind == "dq" else nk
    return {b: sorted(out.get(b, [])) for b in range(blocks)}


@pytest.mark.parametrize("kind", ["dq", "dkv"])
@pytest.mark.parametrize("lq,lk,bq,bk,causal,q_off,k_off,stride", [
    (64, 64, 64, 64, True, 16, 32, 1),
    (64, 64, 64, 64, True, 2, 5, 8),
    (64, 64, 64, 64, True, 0, 40, 1),  # rows 0-39 see no key
    (256, 256, 64, 64, True, 0, 0, 1),
    (64, 192, 64, 64, False, 0, 0, 1),
    (100, 200, 64, 64, True, 0, 0, 1),
    (130, 130, 128, 64, True, 0, 0, 1),
    (130, 130, 64, 128, True, 0, 0, 1),
    (192, 320, 128, 64, True, 256, 0, 2),
    (320, 192, 64, 128, True, 0, 300, 3),
    (40, 72, 64, 64, True, 0, 0, 1),
])
def test_schedule_matches_brute_force(kind, lq, lk, bq, bk, causal, q_off,
                                      k_off, stride):
    """At shard offsets, position strides and ragged lengths each block
    loads exactly the tiles that hold a visible pair, in ascending
    order (the reference's summation order)."""
    got = dict(tflash.bwd_schedule(kind, lq, lk, bq, bk, causal, q_off,
                                   k_off, stride))
    assert got == _visible_tiles(kind, lq, lk, bq, bk, causal, q_off,
                                 k_off, stride)
