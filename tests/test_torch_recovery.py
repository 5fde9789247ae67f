"""The port's recovery path (retry and quarantine at prefill, step and
verify, the decode-health breaker, slot and in-flight leases) against
the JAX package's.

One set of weights (made by the reference, handed over as numpy) at the
width of ``tests/test_faults.py``'s ``CFG`` (embed 64, 8 x 8, float32),
depth 1: the reference ``ServeEngine`` on a (1, 1, 1) CPU mesh with its
dense decode attention, and the port's on the CPU with K1's plain
version, serve the same traces under the same fault spec, each package
configured through its own injector.  A transient error retries to the
unfaulted run's ids; a deterministic one quarantines the same rows with
the same reasons, leaks nothing and gives every block back (shared,
retained and host-tier ones included); the breaker trips at its
threshold with the queue intact and a half-open probe recovers it; a
snapshot carries ``failed`` through a resume; and the Records count the
quarantined rows with the reference's verdicts."""

import io
import json

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from tpu_patterns import faults as jfaults
from tpu_patterns import obs as jobs
from tpu_patterns import rt as jrt
from tpu_patterns.core.results import ResultWriter as JResultWriter
from tpu_patterns.serve import Request as JRequest
from tpu_patterns.serve import ServeConfig as JServeConfig
from tpu_patterns.serve import ServeEngine as JServeEngine
from tpu_patterns.serve import run_serve as j_run_serve
from tpu_patterns_torch import faults as tfaults
from tpu_patterns_torch import obs as tobs
from tpu_patterns_torch import rt as trt
from tpu_patterns_torch.core.results import ResultWriter
from tpu_patterns_torch.serve.engine import (
    Request,
    ServeConfig,
    ServeEngine,
    run_serve,
)

from test_torch_tier_engine import (
    VOCAB,
    _conv_reqs,
    _invariants,
    _mixed_reqs,
    _port,
    _ref,
)

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

SITES = ("serve.prefill", "serve.step", "serve.verify")
PKGS = {"ref": (JServeEngine, JRequest, jfaults, jobs, jrt),
        "port": (ServeEngine, Request, tfaults, tobs, trt)}


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    for pkg in (jfaults, tfaults):
        pkg.configure(None)
    # both packages' fault logs (faults.jsonl) land in the test's dir
    for o, name in ((jobs, "ref"), (tobs, "port")):
        o.configure(str(tmp_path / name))
    yield
    for pkg in (jfaults, tfaults):
        pkg.configure(None)
    for o in (jobs, tobs):
        o.configure(None)


def _trace(cls, n, n_gen=6, seed=1, min_p=3, max_p=20):
    """``tests/test_serve.py``'s ``_trace``."""
    rng = np.random.RandomState(seed)
    return [cls(rid=i, tokens=rng.randint(0, VOCAB, size=rng.randint(
        min_p, max_p + 1)).tolist(), n_gen=n_gen) for i in range(n)]


def _shared(cls, seed=5, n=3, n_gen=4):
    """``tests/test_faults.py``'s verify-fault trace: one 16-token
    prefix (two blocks) and 3 private tokens a request."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, 64, 16).tolist()
    return [cls(rid=i, tokens=shared + rng.randint(0, 64, 3).tolist(),
                n_gen=n_gen) for i in range(n)]


def _policy(faults):
    return faults.RetryPolicy(max_attempts=2, backoff_base_s=0.0,
                              jitter_frac=0.0)


def _serve(which, n_blocks, trace_fn, *, spec=None, slots=2, sampling=False,
           **kw):
    """Serve ``trace_fn(Request class)`` through ``which`` package's
    engine under ``spec``; the engine, its ids and how far its retries
    and quarantines counters moved."""
    Eng, Req, faults, obs, _ = PKGS[which]
    dec, params = (_ref if which == "ref" else _port)(n_blocks, sampling)
    names = ("tpu_patterns_faults_retries_total",
             "tpu_patterns_faults_quarantined_total")
    sites = SITES

    def counts():
        return ({s: obs.counter(names[0], site=s).value for s in sites},
                {s: obs.counter(names[1], site=s).value for s in sites},
                obs.counter("tpu_patterns_serve_quarantined_total").value)

    before = counts()
    faults.configure(spec)
    try:
        eng = Eng(dec, params, slots=slots, retry_policy=_policy(faults),
                  **kw)
        out = eng.run(trace_fn(Req))
    finally:
        faults.configure(None)
    after = counts()
    moved = ({s: after[0][s] - before[0][s] for s in sites},
             {s: after[1][s] - before[1][s] for s in sites},
             after[2] - before[2])
    return eng, out, moved


def _whole_free_list(eng):
    return sorted(eng.free) == list(range(1, eng.layout.n_blocks))


@pytest.mark.parametrize("site", SITES)
def test_transient_error_retries_to_the_unfaulted_ids(site):
    kw = dict(spec_k=3) if site == "serve.verify" else {}

    def trace(cls):
        return _trace(cls, 3, n_gen=4)

    clean, want, _ = _serve("port", 13, trace, **kw)
    ref, ref_out, ref_moved = _serve("ref", 13, trace,
                                     spec=f"{site}:error:count=1", **kw)
    eng, got, moved = _serve("port", 13, trace,
                             spec=f"{site}:error:count=1", **kw)
    assert got == want == ref_out and not eng.failed and not ref.failed
    assert moved == ref_moved
    assert moved[0][site] == 1 and moved[2] == 0
    assert eng.stats["steps"] == ref.stats["steps"] == clean.stats["steps"]
    assert _whole_free_list(eng)


@pytest.mark.parametrize("spec,kw,n,n_gen", [
    ("serve.prefill:error:count=99", {}, 3, 3),
    ("serve.step:error:count=99", {}, 2, 3),
    ("serve.verify:error:count=99", dict(spec_k=3), 3, 4),
    # later waves: some requests finish before the fault starts
    ("serve.step:error:after=3:count=99", {}, 5, 4),
    ("serve.prefill:error:after=2:count=2", {}, 5, 3),
    ("serve.verify:error:after=2:count=99", dict(spec_k=3), 5, 6),
])
def test_deterministic_error_quarantines_the_references_rows(
        spec, kw, n, n_gen):
    def trace(cls):
        return _trace(cls, n, n_gen=n_gen)

    ref, want, ref_moved = _serve("ref", 13, trace, spec=spec, **kw)
    eng, got, moved = _serve("port", 13, trace, spec=spec, **kw)
    assert eng.failed  # the fault quarantined something
    assert got == want
    assert eng.failed == ref.failed  # same rows, same reasons
    assert all("after retries" in v for v in eng.failed.values())
    assert sorted(set(got) | set(eng.failed)) == list(range(n))
    assert moved == ref_moved
    assert moved[2] == len(eng.failed)
    assert eng.leaked_blocks() == 0 and not eng.ref and not eng.active
    assert _whole_free_list(eng)
    assert len(eng.slot_pool._leased) == 0 and len(eng.inflight) == 0
    assert {rid: lc["status"] for rid, lc in eng.lifecycle.items()} == {
        rid: lc["status"] for rid, lc in ref.lifecycle.items()}


@pytest.mark.parametrize("spec,n_gen", [
    ("serve.verify:error:count=99", 4),
    ("serve.verify:error:after=2:count=99", 12),
])
def test_verify_fault_under_sharing_balances_refcounts(spec, n_gen):
    """The chaos-smoke contract in process (``tests/test_faults.py``):
    shared prefix blocks in flight when the wide steps fail for good
    (from the first, or after two succeeded); nothing lost, every shared
    block home exactly once."""
    def trace(cls):
        return _shared(cls, n_gen=n_gen)

    kw = dict(prefix_share=True, spec_k=3, slots=3)
    ref, want, _ = _serve("ref", 17, trace, spec=spec, **kw)
    eng, got, _ = _serve("port", 17, trace, spec=spec, **kw)
    assert got == want and eng.failed == ref.failed
    assert sorted(set(got) | set(eng.failed)) == [0, 1, 2] and eng.failed
    assert eng.leaked_blocks() == 0 and not eng.ref
    assert _whole_free_list(eng) and len(eng.index) == 0


@pytest.mark.parametrize("spec", [
    "serve.step:error:after=4:count=99",
    "serve.prefill:error:after=1:count=99",
])
def test_quarantine_with_retained_and_host_tier_blocks(spec):
    """The tiered engine on the conversation trace: a quarantined row's
    retained and restored blocks go back through the refcounts into the
    tier's cache; the tiered refcount contract holds after it."""
    def trace(cls):
        return _conv_reqs(6, cls)

    kw = dict(kv_host_tier=True, slots=4)
    ref, want, _ = _serve("ref", 15, trace, spec=spec, **kw)
    eng, got, _ = _serve("port", 15, trace, spec=spec, **kw)
    assert eng.failed and got == want and eng.failed == ref.failed
    assert eng.stats["evictions"] == ref.stats["evictions"]
    assert eng.stats["onload_hits"] == ref.stats["onload_hits"]
    _invariants(eng)
    assert not eng.active and not eng.ref


def test_quarantined_resumed_leg_drops_its_banked_output():
    """Interactive rows preempt running bulk rows into the tier; the
    resumed legs' prefills then fail for good: each is quarantined, its
    banked partial output dropped, nothing dangling."""
    def trace(cls):
        return _mixed_reqs(cls)

    kw = dict(kv_host_tier=True, preempt="bulk", slots=2)
    # prefill 0 admits the bulk rows, 1 the interactive ones that
    # preempt them; from 2 on every prefill is a resumed bulk leg's
    spec = "serve.prefill:error:after=2:count=99"
    ref, want, _ = _serve("ref", 17, trace, spec=spec, **kw)
    eng, got, _ = _serve("port", 17, trace, spec=spec, **kw)
    assert got == want and eng.failed == ref.failed
    assert eng.stats["preempted"] == ref.stats["preempted"] > 0
    assert eng.failed and set(eng.failed) <= eng.preempted_rids
    assert not eng.preempted_partial and not eng.preempted_first_ns
    _invariants(eng)


def _breaker_states(b):
    return (b.failures, b.opened, b.probing)


def test_breaker_trips_with_the_queue_intact_and_a_probe_recovers():
    """``serve.step:error:count=99`` under a ``Breaker(threshold=2)``:
    two whole-wave quarantines open it and the loop stops with the rest
    of the queue unserved; after the cool-down a probe admits, and a
    fresh engine on the same breaker serves the queue clean and closes
    it.  The same states, queue and verdicts in both packages."""
    seen = {}
    for which, (Eng, Req, faults, obs, rt) in PKGS.items():
        b = rt.Breaker(threshold=2, cooldown_s=3600.0)
        before = obs.counter("tpu_patterns_replica_breaker_trips_total").value
        eng, out, _ = _serve(which, 13, lambda cls: _trace(cls, 6, n_gen=3),
                             spec="serve.step:error:count=99", breaker=b)
        trips = (obs.counter("tpu_patterns_replica_breaker_trips_total").value
                 - before)
        queued = [r.rid for r, _ in eng.queue]
        tripped = (eng.breaker_tripped, _breaker_states(b), b.admit())
        b.reopen_at(b.opened_ns - int(7200 * 1e9))  # cool down
        probe = b.admit()
        dec, params = (_ref if which == "ref" else _port)(13)
        eng2 = Eng(dec, params, slots=2, breaker=b)
        out2 = eng2.run([Req(rid=r.rid, tokens=list(r.tokens), n_gen=r.n_gen)
                         for r, _ in eng.queue])
        seen[which] = (out, dict(eng.failed), queued, tripped, trips, probe,
                       out2, eng2.breaker_tripped, _breaker_states(b),
                       [e["action"] for e in eng.decisions.events])
    assert seen["port"] == seen["ref"]
    out, failed, queued, tripped, trips, probe, out2, re_trip, states, \
        decisions = seen["port"]
    assert out == {} and sorted(failed) == [0, 1, 2, 3]
    assert queued == [4, 5]  # the queue stays intact for a reroute
    assert tripped == (True, (2, True, False), "open") and trips == 1
    assert probe == "probe" and sorted(out2) == [4, 5] and not re_trip
    assert states == (0, False, False) and decisions == ["breaker"]


def test_snapshot_round_trips_failed(tmp_path):
    """A quarantined wave, then ``serve.step:preempt``: the committed
    snapshot's ``failed`` is the reference's, a fresh engine restores
    it, and the resumed run finishes the rest."""
    spec = "serve.prefill:error:count=2,serve.step:preempt:after=1:count=1"
    states = {}
    for which, (Eng, Req, faults, obs, _) in PKGS.items():
        snap = str(tmp_path / f"snap_{which}")
        eng, out, _ = _serve(which, 13, lambda cls: _trace(cls, 5, n_gen=4),
                             spec=spec, snapshot_dir=snap,
                             fingerprint={"cfg": "t"})
        assert eng.preempted_at is not None
        from tpu_patterns_torch import ckpt

        state = json.loads(ckpt.read_extra(
            snap, "engine.json", step=ckpt.latest_step(snap)))
        dec, params = (_ref if which == "ref" else _port)(13)
        eng2 = Eng(dec, params, slots=2, snapshot_dir=snap,
                   fingerprint={"cfg": "t"})
        eng2.restore_snapshot()
        restored = dict(eng2.failed)
        out2 = eng2.run([])
        states[which] = (state["failed"], restored, out2, dict(eng2.failed),
                         len(eng2.inflight))
    assert states["port"] == states["ref"]
    failed, restored, out2, final, held = states["port"]
    assert failed == {str(k): v for k, v in restored.items()} and failed
    assert sorted(set(out2) | set(final)) == list(range(5))
    assert held == 0


def _no_env(rec):
    return {k: rec.metrics[k] for k in sorted(rec.metrics)}


def test_preemptible_record_counts_quarantined_as_the_reference(tmp_path):
    """``serve --snapshot_dir`` with sharing and speculation under
    ``serve.verify:error:after=2:count=99`` (chaos-smoke leg d at
    dp = tp = 1): WARNING, the same metrics, the same QUARANTINED notes
    and ``ids_out``'s ``failed`` map."""
    kw = dict(vocab=VOCAB, embed=64, head_dim=8, depth=1, requests=8,
              min_prompt=4, max_prompt=24, gen=6, slots=4, block_len=8,
              prefix_share=True, spec_k=4, shared_prefix=16)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))
    spec = "serve.verify:error:after=2:count=99"
    ids = {w: str(tmp_path / f"ids_{w}.json") for w in PKGS}
    jfaults.configure(spec)
    try:
        (jrec,) = j_run_serve(mesh, JServeConfig(
            **kw, snapshot_dir=str(tmp_path / "jsnap"), ids_out=ids["ref"]),
            JResultWriter(stream=io.StringIO()))
    finally:
        jfaults.configure(None)
    tfaults.configure(spec)
    try:
        (rec,) = run_serve(ServeConfig(
            **kw, snapshot_dir=str(tmp_path / "tsnap"), ids_out=ids["port"],
            device="cpu"), ResultWriter(stream=io.StringIO()))
    finally:
        tfaults.configure(None)
    assert rec.verdict.value == jrec.verdict.value == "WARNING"
    assert _no_env(rec) == _no_env(jrec)
    m = rec.metrics
    assert m["quarantined"] > 0 and m["leaked_blocks"] == 0
    assert m["done_requests"] + m["quarantined"] == 8
    assert rec.notes == jrec.notes and any("QUARANTINED" in n
                                           for n in rec.notes)
    with open(ids["port"]) as f, open(ids["ref"]) as g:
        assert json.load(f) == json.load(g)


def test_other_errors_are_not_retried(monkeypatch):
    """Only ``OSError`` retries: any other exception from a launch ends
    the run at once, with nothing quarantined (a CUDA error is a
    ``RuntimeError``)."""
    dec, params = _port(13)
    eng = ServeEngine(dec, params, slots=2, retry_policy=_policy(tfaults))
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(type(dec), "step", broken)
    with pytest.raises(RuntimeError, match="illegal memory"):
        eng.run(_trace(Request, 2, n_gen=3))
    assert calls == [1] and not eng.failed
