"""The port's elastic policy (``tpu_patterns_torch/serve/elastic.py``)
against the JAX package's: over seeded signal sequences the two make the
same scale-out and scale-in decisions at the same instants (high and
low water, the sustain window, the cooldown, the spare and ``min_live``
limits and the fit rule of a shrink), and refuse the same configs."""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_patterns.serve import elastic as jel
from tpu_patterns_torch.serve import elastic as tel

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

CONFIGS = [
    dict(reserve=1),
    dict(reserve=2, out_occupancy=1.1, in_occupancy=0.1, sustain_s=0.1,
         cooldown_s=0.5),
    dict(reserve=3, sustain_s=0.0, cooldown_s=0.0, min_live=2),
]


def _signals(seed, n=400):
    """A seeded ramp up and down of leases over a fleet that the
    decisions themselves resize."""
    rng = np.random.RandomState(seed)
    t = np.cumsum(rng.uniform(0.01, 0.2, size=n))
    load = (np.sin(np.linspace(0, 3 * np.pi, n)) + 1) * 6
    return t, (load + rng.uniform(-1, 1, size=n)).clip(0).astype(int)


def _run(mod, kw, seed):
    cfg = mod.ElasticConfig(**kw)
    pol = mod.ElasticPolicy(cfg)
    live, spare, out = 1, kw["reserve"], []
    for now, leases in zip(*_signals(seed)):
        sig = mod.FleetSignals(leases=int(leases), pending=int(leases) % 2,
                               live=live, spare=spare, slots=2)
        d = pol.decide(float(now), sig)
        out.append((round(sig.occupancy(), 9), d))
        if d == "out":
            live, spare = live + 1, spare - 1
        elif d == "in":
            live, spare = live - 1, spare + 1
    return out, pol.decisions


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", CONFIGS, ids=["default", "fast", "nohyst"])
def test_decisions_match_over_a_seeded_ramp(kw, seed):
    got = _run(tel, kw, seed)
    want = _run(jel, kw, seed)
    assert got == want
    assert any(d == "out" for _, d in got[0])


def test_signals_and_configs_match():
    sig = dict(leases=5, pending=2, live=3, spare=1, slots=4)
    assert tel.FleetSignals(**sig).occupancy() == \
        jel.FleetSignals(**sig).occupancy()
    assert dataclasses.asdict(tel.ElasticConfig(reserve=2)) == \
        dataclasses.asdict(jel.ElasticConfig(reserve=2))
    for bad in (dict(reserve=-1), dict(reserve=1, in_occupancy=2.0),
                dict(reserve=1, sustain_s=-1.0), dict(reserve=1, min_live=0)):
        with pytest.raises(ValueError) as want:
            jel.ElasticConfig(**bad)
        with pytest.raises(ValueError) as got:
            tel.ElasticConfig(**bad)
        assert str(got.value) == str(want.value)
