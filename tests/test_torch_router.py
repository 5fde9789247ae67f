"""The port's prefix router (``tpu_patterns_torch/serve/router.py``)
against the JAX package's: on the same seeded prompts, the same
fingerprints, the same ring owners (before and after a removal, which
remaps only the lost arc), the same routes under both policies before
and after a quarantine, the same prefix hits, fallbacks and reroute
counts, and the same ``router.route`` fault firing."""

import numpy as np
import pytest
import torch

from tpu_patterns import faults as jfaults
from tpu_patterns.serve import router as jrouter
from tpu_patterns_torch import faults as tfaults
from tpu_patterns_torch.serve import router as trouter

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (jfaults, tfaults):
        f.configure(None)
    yield
    for f in (jfaults, tfaults):
        f.configure(None)


def _prompts(seed, n=48, vocab=32, block_len=8):
    """Prompts in a few shared-prefix groups plus short ones."""
    rng = np.random.RandomState(seed)
    heads = [rng.randint(0, vocab, size=3 * block_len).tolist()
             for _ in range(4)]
    out = []
    for _ in range(n):
        kind = rng.randint(0, 3)
        if kind == 0:
            out.append(rng.randint(0, vocab, size=rng.randint(1, 7)).tolist())
        else:
            h = heads[rng.randint(0, len(heads))]
            cut = rng.randint(block_len, len(h) + 1)
            out.append(h[:cut] + rng.randint(
                0, vocab, size=rng.randint(0, 9)).tolist())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("route_blocks", [1, 2, 3])
def test_fingerprints_match(seed, route_blocks):
    for p in _prompts(seed):
        assert trouter.prefix_fingerprint(p, 8, route_blocks) == \
            jrouter.prefix_fingerprint(p, 8, route_blocks)


def test_fingerprint_refusals_match():
    for args in (([1, 2], 0, 2), ([1, 2], 8, 0)):
        with pytest.raises(ValueError) as want:
            jrouter.prefix_fingerprint(*args)
        with pytest.raises(ValueError) as got:
            trouter.prefix_fingerprint(*args)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("vnodes", [1, 8, 64])
def test_ring_owners_match_and_a_removal_remaps_only_its_arc(vnodes):
    nodes = [str(i) for i in range(5)]
    keys = [trouter.prefix_fingerprint(p, 8) for p in _prompts(3, n=200)]
    jring = jrouter.ConsistentHashRing(nodes, vnodes=vnodes)
    tring = trouter.ConsistentHashRing(nodes, vnodes=vnodes)
    before = [tring.lookup(k) for k in keys]
    assert before == [jring.lookup(k) for k in keys]
    for ring in (jring, tring):
        ring.remove("2")
    after = [tring.lookup(k) for k in keys]
    assert after == [jring.lookup(k) for k in keys]
    for b, a in zip(before, after):
        assert a == b or b == "2"
    assert [tring.lookup(k, exclude={"0", "1"}) for k in keys] == \
        [jring.lookup(k, exclude={"0", "1"}) for k in keys]
    for ring in (jring, tring):
        ring.restore("2")
    assert [tring.lookup(k) for k in keys] == before


def _drive(mod, policy, prompts):
    """Route every prompt, quarantine the busiest replica, route again
    with fallbacks for a third of the rids; every decision and count."""
    r = mod.Router(["0", "1", "2"], block_len=8, policy=policy)
    first = [r.route(i, p) for i, p in enumerate(prompts)]
    busiest = max(set(first), key=first.count)
    r.quarantine(busiest)
    second = []
    for i, p in enumerate(prompts):
        if i % 3 == 0:
            second.append(r.fallback(i, p, exclude={first[i]}))
        else:
            second.append(r.route(i, p))
    r.restore(busiest)
    third = [r.route(i, p) for i, p in enumerate(prompts[:8])]
    return (first, busiest, second, third, sorted(r.live()), r.routed,
            r.prefix_hits, r.reroutes)


@pytest.mark.parametrize("policy", ["prefix", "round_robin"])
@pytest.mark.parametrize("seed", [0, 5])
def test_routes_and_counts_match(policy, seed):
    prompts = _prompts(seed)
    assert _drive(trouter, policy, prompts) == _drive(jrouter, policy,
                                                      prompts)


def test_no_live_replica_and_bad_policy_refuse_alike():
    for mod in (jrouter, trouter):
        with pytest.raises(ValueError, match="unknown router policy"):
            mod.Router(["0"], block_len=8, policy="random")
        r = mod.Router(["0"], block_len=8)
        r.quarantine("0")
        with pytest.raises(RuntimeError, match="no live replica"):
            r.route(0, [1, 2, 3])
        with pytest.raises(RuntimeError, match="no live replica"):
            r.fallback(0, [1, 2, 3])


def test_route_site_fires_alike():
    prompts = _prompts(7, n=6)
    got = {}
    for mod, f in ((jrouter, jfaults), (trouter, tfaults)):
        f.configure("router.route:error:after=1:count=2")
        r = mod.Router(["0", "1"], block_len=8)
        out = []
        for i, p in enumerate(prompts):
            try:
                out.append(r.route(i, p))
            except f.InjectedFault:
                out.append("fault")
        got[mod.__name__.split(".")[0]] = (out, r.routed)
    assert got["tpu_patterns_torch"] == got["tpu_patterns"]
    assert got["tpu_patterns"][0].count("fault") == 2
