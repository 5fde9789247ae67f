"""The port's radix index with host-resident nodes and its host KV tier
against the JAX package's.

The same operation sequences, drawn from a seed, go through the
reference's ``serve/prefix.py`` and ``serve/kvtier.py`` and the port's
copies: after every operation the plans and ``to_state()`` agree
exactly (a hypothesis property over random sequences of insert,
materialize, evict, restore, remove-handle and drop-subtree), and the
host tier round-trips through ``state_arrays``/``load_arrays`` and
through ``commit``/``load_session``, across the two packages in both
directions (the checkpoint format is shared), with the capacity drop,
the format and fingerprint refusals and a bfloat16 leaf kept bit for
bit."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tpu_patterns import ckpt as jckpt
from tpu_patterns.serve.kvtier import HostTier as JHostTier
from tpu_patterns.serve.prefix import PrefixIndex as JPrefixIndex
from tpu_patterns_torch.convert import tensor_from_numpy
from tpu_patterns_torch.serve.kvtier import SESSION_FORMAT, HostTier
from tpu_patterns_torch.serve.prefix import PrefixIndex

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

BL = 2  # block_len: small, so random prompts share blocks often


def _same(j: JPrefixIndex, t: PrefixIndex, probes) -> None:
    """Both indexes in one state: encodings, sets and every probe's
    plan."""
    assert t.to_state() == j.to_state()
    assert t.blocks() == j.blocks() and len(t) == len(j)
    assert t.host_handles() == j.host_handles()
    for tokens in probes:
        jp, tp = j.plan(tokens), t.plan(tokens)
        assert (tp.aliased, tp.restores, tp.donor, tp.donor_len) == (
            jp.aliased, jp.restores, jp.donor, jp.donor_len)
        assert tp.shared_len(BL) == jp.shared_len(BL)


def _both(j, t, method, *args):
    """Call ``method`` on both indexes; their results must agree."""
    got = getattr(t, method)(*args)
    want = getattr(j, method)(*args)
    assert got == want, (method, args)
    return got


_tokens = st.lists(st.integers(0, 2), min_size=1, max_size=4 * BL)


@settings(max_examples=40, deadline=None, derandomize=True,
          database=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_index_property_random_operation_sequences(data):
    """Random sequences over both indexes, each step chosen among the
    operations valid in the current state (the engine's preconditions:
    evict and discard leaf-first, restore only held handles), then a
    round trip through ``to_state``/``from_state``."""
    j, t = JPrefixIndex(BL), PrefixIndex(BL)
    next_block, next_handle = 1, 0
    probes = []
    for _ in range(data.draw(st.integers(1, 24), label="steps")):
        blocks = sorted(j.blocks())
        handles = sorted(j.host_handles())
        # the engine evicts and discards only nodes with no device child,
        # and frees a node with its subtree (here: a leaf)
        evictable = [b for b in blocks if not j.has_resident_children(b)]
        leaves = [b for b in evictable if not j._by_block[b].children]
        ops = ["insert"]
        if blocks:
            ops += ["materialize", "path"]
        if evictable:
            ops += ["evict", "drop_subtree"]
        if leaves:
            ops.append("remove_block")
        if handles:
            ops += ["restore", "remove_handle"]
        op = data.draw(st.sampled_from(ops), label="op")
        if op == "insert":
            tokens = data.draw(_tokens, label="tokens")
            n = len(tokens) // BL
            table = list(range(next_block, next_block + n))
            next_block += n
            new = _both(j, t, "insert", tokens, table)
            if data.draw(st.booleans(), label="materialize now"):
                _both(j, t, "materialize", new)
            probes.append(tokens)
        elif op == "materialize":
            pick = data.draw(st.lists(st.sampled_from(blocks), max_size=3))
            _both(j, t, "materialize", pick)
        elif op == "evict":
            b = data.draw(st.sampled_from(evictable), label="evict")
            _both(j, t, "evict_block", b, next_handle)
            next_handle += 1
        elif op == "restore":
            h = data.draw(st.sampled_from(handles), label="restore")
            _both(j, t, "restore_block", h, next_block)
            next_block += 1
        elif op == "remove_handle":
            h = data.draw(st.sampled_from(handles), label="remove")
            _both(j, t, "remove_handle", h)
        elif op == "drop_subtree":
            b = data.draw(st.sampled_from(evictable), label="drop")
            _both(j, t, "drop_block_subtree", b)
        elif op == "remove_block":
            b = data.draw(st.sampled_from(leaves), label="remove block")
            _both(j, t, "remove_block", b)
        else:
            b = data.draw(st.sampled_from(blocks), label="path")
            path = _both(j, t, "node_path", b)
            _both(j, t, "is_materialized", b)
            _both(j, t, "has_resident_children", b)
            # a fresh index rebuilt from the host paths of this one
            fj, ft = JPrefixIndex(BL), PrefixIndex(BL)
            _both(fj, ft, "add_host_path", path[:BL], next_handle)
            _both(fj, ft, "add_host_path", path, next_handle + 1)
            _same(fj, ft, probes)
        _same(j, t, probes)
    # from_state rebuilds children in sorted order (a donor tie may then
    # break another way, in both packages alike): hold clone to clone
    _same(JPrefixIndex.from_state(BL, j.to_state()),
          PrefixIndex.from_state(BL, t.to_state()), probes)


def _pair(tokens, blocks):
    j, t = JPrefixIndex(4), PrefixIndex(4)
    _both(j, t, "insert", tokens, blocks)
    _both(j, t, "materialize", blocks)
    return j, t


@pytest.mark.parametrize("case", [
    "evict_restore", "device_below_host", "host_never_donates",
    "paths", "remove_handle", "insert_stops_at_host", "drop_cascade",
])
def test_index_host_transitions_match_reference(case):
    """The reference's host-node unit cases, through both indexes."""
    probes = [list(range(8)), list(range(12)), [0, 1, 2, 3, 4, 5, 99]]
    j, t = _pair(list(range(12)), [3, 4, 5])
    if case == "evict_restore":
        _both(j, t, "evict_block", 5, 0)
        assert t.plan(list(range(12))).restores == (0,)
        _both(j, t, "restore_block", 0, 9)
        assert t.plan(list(range(12))).aliased == (3, 4, 9)
    elif case == "device_below_host":
        _both(j, t, "evict_block", 4, 7)
        assert t.plan(list(range(12))).aliased == (3,)
        assert t.plan(list(range(12))).restores == (7,)
    elif case == "host_never_donates":
        _both(j, t, "evict_block", 5, 0)
        _both(j, t, "evict_block", 4, 1)
        assert t.plan([0, 1, 2, 3, 4, 5, 99]).donor is None
    elif case == "paths":
        assert _both(j, t, "node_path", 5) == tuple(range(12))
        fj, ft = JPrefixIndex(4), PrefixIndex(4)
        assert not _both(fj, ft, "add_host_path", tuple(range(8)), 1)
        assert _both(fj, ft, "add_host_path", tuple(range(4)), 0)
        assert _both(fj, ft, "add_host_path", tuple(range(8)), 1)
        assert not _both(fj, ft, "add_host_path", tuple(range(8)), 2)
        _same(fj, ft, probes)
    elif case == "remove_handle":
        _both(j, t, "evict_block", 5, 0)
        _both(j, t, "evict_block", 4, 1)
        assert sorted(_both(j, t, "remove_handle", 1)) == [0]
    elif case == "insert_stops_at_host":
        _both(j, t, "evict_block", 5, 0)
        _both(j, t, "evict_block", 4, 1)
        assert _both(j, t, "insert", list(range(16)), [3, 7, 8, 9]) == []
    else:
        _both(j, t, "evict_block", 5, 0)
        _both(j, t, "evict_block", 4, 1)
        assert sorted(_both(j, t, "drop_block_subtree", 3)) == [0, 1]
    _same(j, t, probes)
    # tier-free nodes keep the 4-element encoding, host nodes add one
    assert t.to_state() == j.to_state()


LEAVES = {"k": (1, 8, 2, 4), "v": (1, 8, 2, 4)}


def _tiers(tmp_path=None, fingerprint=None, capacity=0, sub="sess"):
    sd = str(tmp_path / sub) if tmp_path is not None else None
    j = JHostTier({n: (s, np.dtype(np.float32)) for n, s in LEAVES.items()},
                  block_len=8, session_dir=sd, capacity_blocks=capacity,
                  fingerprint=fingerprint)
    t = HostTier({n: (s, torch.float32) for n, s in LEAVES.items()},
                 block_len=8, session_dir=sd, capacity_blocks=capacity,
                 fingerprint=fingerprint)
    return j, t


def _block(seed):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype(np.float32) for n, s in LEAVES.items()}


def _torch_block(b):
    return {n: tensor_from_numpy(a) for n, a in b.items()}


def test_tier_store_capacity_and_refusals_match_reference():
    j, t = _tiers(capacity=2)
    assert t.block_nbytes() == j.block_nbytes()
    for i, path in enumerate([(1, 2), (1, 2, 3), (4,)]):
        b = _block(i)
        assert t.put(_torch_block(b), path) == j.put(b, path)
        assert (len(t), t.over_capacity(), t.oldest()) == (
            len(j), j.over_capacity(), j.oldest())
    t.discard(t.oldest())
    j.discard(j.oldest())
    assert (t.over_capacity(), t.oldest()) == (j.over_capacity(), j.oldest())
    assert t.paths == j.paths
    for h in j.store:
        for n in LEAVES:
            assert np.array_equal(t.get(h)[n].numpy(), j.get(h)[n])
    with pytest.raises(ValueError, match="leaves"):
        t.put({"k": torch.zeros(LEAVES["k"])}, (9,))
    with pytest.raises(ValueError, match="shape"):
        t.put({n: torch.zeros((2, 8, 2, 4)) for n in LEAVES}, (9,))


def test_tier_put_copies_never_views():
    wave = torch.arange(4 * 8 * 2 * 4, dtype=torch.float32).reshape(
        1, 4, 8, 2, 4)
    _, t = _tiers()
    h = t.put({"k": wave[:, 1], "v": wave[:, 2]}, (1,))
    wave.zero_()
    assert t.get(h)["k"].sum() > 0
    assert t.get(h)["k"].untyped_storage().data_ptr() != (
        wave.untyped_storage().data_ptr())


def test_tier_state_arrays_round_trip():
    j, t = _tiers()
    for i in range(3):
        b = _block(10 + i)
        j.put(b, (i,))
        t.put(_torch_block(b), (i,))
    jh, ja = j.state_arrays()
    th, ta = t.state_arrays()
    assert th == jh
    for n in LEAVES:
        assert np.array_equal(ta[n].numpy(), ja[n])
    _, fresh = _tiers()
    fresh.load_arrays(th, dict(t.paths), ta)
    assert fresh.paths == t.paths and sorted(fresh.store) == th
    assert fresh.put(_torch_block(_block(0)), (7,)) == max(th) + 1
    for h in th:
        for n in LEAVES:
            assert torch.equal(fresh.get(h)[n], t.get(h)[n])
    _, empty = _tiers()
    eh, ea = empty.state_arrays()
    assert eh == [] and ea["k"].shape == (0, *LEAVES["k"])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_session_commit_load_across_packages(tmp_path, writer):
    """A session committed by either package loads in the other, bit for
    bit, with the same shallow-first (path, handle) entries."""
    j, t = _tiers(tmp_path, fingerprint={"cfg": 1})
    blocks = {i: _block(20 + i) for i in range(3)}
    paths = [(10,), (10, 11), (12,)]
    for i, path in enumerate(paths):
        if writer == "reference":
            j.put({n: a.copy() for n, a in blocks[i].items()}, path)
        else:
            t.put(_torch_block(blocks[i]), path)
    assert (j if writer == "reference" else t).commit() is not None
    jr, tr = _tiers(tmp_path, fingerprint={"cfg": 1})
    want = jr.load_session()
    got = tr.load_session()
    assert got == want
    assert [p for p, _ in got] == [(10,), (12,), (10, 11)]
    for path, h in got:
        i = paths.index(path)
        for n in LEAVES:
            assert np.array_equal(tr.get(h)[n].numpy(), blocks[i][n])
            assert np.array_equal(jr.get(h)[n], blocks[i][n])


def test_session_refuses_foreign_fingerprint_and_format(tmp_path):
    _, t = _tiers(tmp_path, fingerprint={"cfg": 1})
    t.put(_torch_block(_block(0)), (1,))
    t.commit()
    j2, t2 = _tiers(tmp_path, fingerprint={"cfg": 2})
    with pytest.raises(ValueError, match="different pool/model"):
        j2.load_session()
    with pytest.raises(ValueError, match=r"different pool/model.*cfg"):
        t2.load_session()
    # a session written under another format is refused by both
    sd = str(tmp_path / "old")
    meta = {"format": SESSION_FORMAT - 1, "handles": [], "paths": {},
            "leaves": {}, "fingerprint": {}}
    jckpt.save(sd, 1, {"k": jnp.zeros((0, 1, 8, 2, 4))},
               extras={"session.json": json.dumps(meta)})
    for tier in _tiers(tmp_path, sub="old"):
        with pytest.raises(ValueError, match="format"):
            tier.load_session()


def test_empty_and_missing_sessions(tmp_path):
    j, t = _tiers(tmp_path)
    assert t.load_session() == j.load_session() == []
    t.commit()  # an empty tier commits and loads back empty
    assert _tiers(tmp_path)[1].load_session() == []
    assert _tiers(tmp_path)[0].load_session() == []
    assert _tiers()[1].commit() is None


def test_bfloat16_leaf_kept_bit_for_bit(tmp_path):
    """numpy has no bfloat16, so the port's store holds torch tensors: a
    bf16 block survives put, commit and load_session with its bits (the
    reference, on ml_dtypes' bfloat16, reads the same bits back)."""
    shape = (2, 8, 2, 4)
    sd = str(tmp_path / "bf16")
    t = HostTier({"k": (shape, torch.bfloat16), "v": (shape, torch.bfloat16)},
                 block_len=8, session_dir=sd)
    g = torch.Generator().manual_seed(5)
    blk = {n: torch.randn(shape, generator=g).to(torch.bfloat16)
           for n in ("k", "v")}
    h = t.put(blk, (3, 4))
    t.commit()
    fresh = HostTier({"k": (shape, torch.bfloat16),
                      "v": (shape, torch.bfloat16)}, block_len=8,
                     session_dir=sd)
    ((path, h2),) = fresh.load_session()
    assert (path, h2) == ((3, 4), h)
    for n in blk:
        assert torch.equal(fresh.get(h2)[n].view(torch.int16),
                           blk[n].view(torch.int16))
    bf16 = np.dtype(jnp.bfloat16)
    j = JHostTier({"k": (shape, bf16), "v": (shape, bf16)}, block_len=8,
                  session_dir=sd)
    ((_, hj),) = j.load_session()
    for n in blk:
        assert np.array_equal(j.get(hj)[n].view(np.int16),
                              blk[n].view(torch.int16).numpy())
