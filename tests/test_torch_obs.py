"""The port's obs copies (``obs/metrics.py``, ``obs/slo.py``,
``obs/cost.py``) against the JAX package's.

Each pair is fed the same event sequence with both packages' clocks
replaced by one fake nanosecond clock: the SLO monitors give equal
snapshots, burn rates, mitigation states, fire counts and published
gauges; the cost books give equal snapshots (identities, rollups,
per-request rows), with and without an injected booking fault; the
registries render the same Prometheus text and JSONL (the run-provenance
stamp aside) and read back the same."""

import json

import pytest

from tpu_patterns import faults as jf
from tpu_patterns import obs as jobs
from tpu_patterns.obs import cost as jcost
from tpu_patterns.obs import metrics as jmetrics
from tpu_patterns.obs import slo as jslo
from tpu_patterns_torch import faults as tf
from tpu_patterns_torch import obs as tobs
from tpu_patterns_torch.obs import cost as tcost
from tpu_patterns_torch.obs import metrics as tmetrics
from tpu_patterns_torch.obs import slo as tslo

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)


class _Clock:
    def __init__(self, t: int = 10_000):
        self.t = t

    def __call__(self) -> int:
        return self.t


@pytest.fixture
def clock(monkeypatch, tmp_path):
    c = _Clock()
    for mod in (jslo, tslo, jcost, tcost):
        monkeypatch.setattr(mod, "clock_ns", c)
    # each package's burn trail writes slo.jsonl under its run dir
    monkeypatch.setattr(jobs, "run_dir", lambda: str(tmp_path))
    monkeypatch.setattr(tobs, "run_dir", lambda: str(tmp_path / "port"))
    for reg in (jobs.metrics_registry(), tobs.metrics_registry()):
        reg.clear()
    for pkg in (jf, tf):
        pkg.configure(None)
    yield c
    for pkg in (jf, tf):
        pkg.configure(None)
    for reg in (jobs.metrics_registry(), tobs.metrics_registry()):
        reg.clear()


def _values(reg, prefix: str) -> dict:
    out = {}
    for m in reg.metrics():
        if m.name.startswith(prefix):
            key = (m.name, tuple(sorted(m.labels.items())))
            out[key] = m.value if hasattr(m, "value") else (m.sum, m.count)
    return out


# (dt_ns before the event, tokens, met, ttft_ms, tpot_ms, priority)
SLO_EVENTS = [
    (0, 12, True, 40.0, 5.0, ""),
    (2 * 10**8, 8, True, 55.0, 6.5, "interactive"),
    (3 * 10**8, 20, False, 900.0, 40.0, "bulk"),  # burn: fires
    (10**8, 4, True, 30.0, None, "interactive"),
    (5 * 10**8, 16, False, None, None, "bulk"),
    (3 * 10**9, 10, True, 20.0, 4.0, ""),  # the fast window aged out
    (10**8, 6, True, 25.0, 3.0, "interactive"),
    (2 * 10**8, 30, False, 1500.0, 90.0, ""),  # a second episode
]


@pytest.mark.parametrize("mult", [1.5, 2.0, 6.0])
def test_slo_monitor_matches_reference(clock, mult):
    cfg = dict(fast_window_s=1.0, slow_window_s=4.0, budget=0.1,
               multiplier=mult)
    jm = jslo.SloMonitor(jslo.SloConfig(**cfg))
    tm = tslo.SloMonitor(tslo.SloConfig(**cfg))
    for dt, tokens, met, ttft, tpot, prio in SLO_EVENTS:
        clock.t += dt
        for m in (jm, tm):
            m.observe(tokens=tokens, met=met, ttft_ms=ttft, tpot_ms=tpot,
                      priority=prio)
        assert tm.snapshot() == jm.snapshot()
        assert tm.mitigating() == jm.mitigating()
        assert tm.fires == jm.fires
    clock.t += 5 * 10**9  # every bucket ages out: the episode ends
    assert tm.mitigating() == jm.mitigating() is False
    assert tm.snapshot() == jm.snapshot()
    assert (_values(tobs.metrics_registry(), "tpu_patterns_slo")
            == _values(jobs.metrics_registry(), "tpu_patterns_slo"))


def test_slo_config_invariants_match_reference():
    for bad in (dict(fast_window_s=0.0), dict(fast_window_s=9.0,
                                              slow_window_s=3.0),
                dict(budget=0.0), dict(budget=1.5), dict(multiplier=0.0),
                dict(recover=3.0)):
        with pytest.raises(ValueError) as want:
            jslo.SloConfig(**bad)
        with pytest.raises(ValueError) as got:
            tslo.SloConfig(**bad)
        assert str(got.value) == str(want.value)


def _cost_script(book, clock):
    book.start(0)
    clock.t += 1000
    book.hold(1, 3, scenario="chat", priority="interactive")
    book.tick(3)
    clock.t += 700
    book.book_prefill(700, [(1, "chat", "interactive")])
    book.hold(2, 5, scenario="rag", priority="bulk")
    book.tick(8)
    clock.t += 1001
    book.book_decode(1001, [(1, "chat", "interactive"), (2, "rag", "bulk")])
    book.tick(8)
    clock.t += 333
    book.book_decode(333, [(2, "rag", "bulk"), (1, "chat", "interactive"),
                           (3, "chat", "")])
    book.drop(1)
    book.tick(5)
    clock.t += 250
    book.book_decode(250, [])
    book.hold(3, 2, scenario="chat", priority="")
    clock.t += 90
    book.close(7)
    return book.snapshot()


@pytest.mark.parametrize("spec", [None, "obs.cost_book:error:after=1:count=2"])
def test_cost_book_matches_reference(clock, spec):
    jf.configure(spec)
    t0 = clock.t
    want = _cost_script(jcost.CostBook(16, replica="r0"), clock)
    jf.configure(None)
    tf.configure(spec)
    clock.t = t0
    got = _cost_script(tcost.CostBook(16, replica="r0"), clock)
    assert got == want
    assert got["decode_identity_ok"] and got["conservation_ok"]
    assert (_values(tobs.metrics_registry(), "tpu_patterns_cost")
            == _values(jobs.metrics_registry(), "tpu_patterns_cost"))


def test_cost_book_jsonl_and_registry_match_reference(clock):
    t0 = clock.t
    jb = jcost.register(jcost.CostBook(4))
    _cost_script(jb, clock)
    clock.t = t0
    tb = tcost.register(tcost.CostBook(4))
    _cost_script(tb, clock)
    assert tb.to_jsonl() == jb.to_jsonl()
    assert tcost.books()[-1] is tb
    assert tcost.rollup([{"priority": "bulk", "decode_ns": 1,
                          "prefill_ns": 2, "block_ns": 3}], "priority") == (
        jcost.rollup([{"priority": "bulk", "decode_ns": 1,
                       "prefill_ns": 2, "block_ns": 3}], "priority"))


def _registry_script(metrics_mod):
    reg = metrics_mod.Registry()
    reg.counter("tpu_patterns_x_total", help="an x").inc()
    reg.counter("tpu_patterns_x_total", status="done").inc(3)
    reg.gauge("tpu_patterns_g", scenario='c"hat').set(2.5)
    reg.gauge("tpu_patterns_nan").set(float("nan"))
    h = reg.histogram("tpu_patterns_ms", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 3.0, 30.0, 300.0, 10.0):
        h.observe(v)
    reg.histogram("tpu_patterns_ns").observe(12345.0)
    with pytest.raises(ValueError):
        reg.counter("tpu_patterns_x_total").inc(-1)
    return reg


def _drop_stamp(text: str, jsonl: bool) -> list:
    lines = text.splitlines()
    if jsonl:
        out = []
        for ln in lines:
            d = json.loads(ln)
            if d.get("type") == "run":
                continue
            d.pop("ts")
            out.append(d)
        return out
    return [ln for ln in lines if not ln.startswith("# RUN")]


def _parsed(text: str) -> dict:
    # repr: the NaN gauge reads back as NaN in both, and NaN != NaN
    return {k: repr(v) for k, v in jmetrics.parse_prom_text(text).items()}


def test_registry_exports_match_reference():
    """The port's exports equal the reference's, and the reference's own
    readers read them back."""
    jreg, treg = _registry_script(jmetrics), _registry_script(tmetrics)
    jtext, ttext = jreg.to_prom_text(), treg.to_prom_text()
    assert _drop_stamp(ttext, False) == _drop_stamp(jtext, False)
    assert ttext.startswith("# RUN")
    assert _parsed(ttext) == _parsed(jtext)
    assert (_drop_stamp(treg.to_jsonl(), True)
            == _drop_stamp(jreg.to_jsonl(), True))
    back = jmetrics.registry_from_jsonl(treg.to_jsonl().splitlines())
    assert _parsed(back.render()) == _parsed(ttext)
    h = next(m for m in treg.metrics() if m.name == "tpu_patterns_ms")
    assert h.cumulative() == [(1.0, 1), (10.0, 3), (100.0, 4),
                              (float("inf"), 5)]


def test_facade_is_the_process_registry(clock):
    tobs.counter("tpu_patterns_y_total", a="1").inc(2)
    tobs.gauge("tpu_patterns_y").set(4)
    tobs.histogram("tpu_patterns_y_ms").observe(1.5)
    vals = _values(tobs.metrics_registry(), "tpu_patterns_y")
    assert vals == {("tpu_patterns_y_total", (("a", "1"),)): 2.0,
                    ("tpu_patterns_y", ()): 4.0,
                    ("tpu_patterns_y_ms", ()): (1.5, 1)}
    assert tobs.metrics_registry() is tmetrics.default()


def test_injected_faults_are_counted_as_the_reference_counts_them(clock):
    for pkg in (jf, tf):
        pkg.configure("loadgen.arrive:error:count=2")
        for rid in range(3):
            try:
                pkg.inject("loadgen.arrive", rid=rid, scenario="chat")
            except pkg.InjectedFault:
                pass
        pkg.configure(None)
    name = "tpu_patterns_faults_injected_total"
    want = _values(jobs.metrics_registry(), name)
    assert _values(tobs.metrics_registry(), name) == want
    assert sum(want.values()) == 2.0
