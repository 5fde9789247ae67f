"""The port's runtime core (``rt/``) and the sweep cells' retry loop
(``faults.run_cell_attempts``, ``cell_retry_policy``) against the JAX
package's.

Each case drives both packages with one scripted sequence of calls and
compares what every call returned and the state after it: the breaker's
verdicts (closed, open, probe) and its streak, open and probing flags
and gauge; the lease pool's items (by spawn order), hits, misses and
recycles, the liveness calls its items received and what its breaker
did; the lease table's answers; the cell loop's ``(rc, completed,
attempts, quarantined)``, its sleeps, its progress lines and the retry
and quarantine counters it booked.  The cases are those of
``tests/test_rt.py`` and ``tests/test_faults.py``'s cell-retry tests."""

import threading

import pytest

from tpu_patterns import faults as jf
from tpu_patterns import obs as jobs
from tpu_patterns import rt as jrt
from tpu_patterns.core.timing import clock_ns as j_clock_ns
from tpu_patterns_torch import faults as tf
from tpu_patterns_torch import obs as tobs
from tpu_patterns_torch import rt as trt
from tpu_patterns_torch.core.timing import clock_ns as t_clock_ns

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

PKGS = ((jrt, jobs, j_clock_ns), (trt, tobs, t_clock_ns))
COOLED = int(7200 * 1e9)  # a backdate past any cool-down below


def _breaker_run(rt, obs, clock_ns, script, **kw):
    """Run ``script`` (op names) on a fresh breaker; every op's result
    and the state after it."""
    b = rt.Breaker(cooldown_s=3600.0, gauge="tpu_patterns_test_breaker",
                   replica="t", **kw)
    out = []
    for op in script:
        if op == "admit":
            res = b.admit()
        elif op == "fail":
            res = b.failure()
        elif op == "fail_probe":
            res = b.failure(probe=True)
        elif op == "success":
            res = b.success()
        elif op == "abort":
            res = b.abort_probe()
        else:  # "cool": age the open timestamp past the cool-down
            res = b.reopen_at(clock_ns() - COOLED)
        out.append((op, res, b.failures, b.opened, b.probing,
                    obs.gauge("tpu_patterns_test_breaker",
                              replica="t").value))
    return out


BREAKER_SCRIPTS = {
    "opens_at_threshold": (dict(threshold=2),
                           ["admit", "fail", "admit", "fail", "admit"]),
    "success_resets": (dict(threshold=2),
                       ["fail", "success", "fail", "admit"]),
    "one_probe": (dict(threshold=1),
                  ["fail", "cool", "admit", "admit", "success", "admit"]),
    "failed_probe_reopens": (dict(threshold=1),
                             ["fail", "cool", "admit", "fail_probe",
                              "admit", "cool", "admit", "success"]),
    "abort_unlatches": (dict(threshold=1),
                        ["fail", "cool", "admit", "abort", "admit", "cool",
                         "admit", "success", "admit"]),
    "engine_trip_then_probe": (dict(threshold=2),
                               ["fail", "fail", "fail", "admit", "cool",
                                "admit", "fail_probe", "cool", "admit",
                                "success", "fail", "admit"]),
}


@pytest.mark.parametrize("name", sorted(BREAKER_SCRIPTS))
def test_breaker_matches_reference(name):
    kw, script = BREAKER_SCRIPTS[name]
    got = [_breaker_run(rt, obs, c, script, **kw) for rt, obs, c in PKGS]
    assert got[1] == got[0]


def test_breaker_cooldown_knob_and_threshold_match():
    assert trt.BREAKER_COOLDOWN_S == jrt.BREAKER_COOLDOWN_S
    assert trt.Breaker().cooldown_s == trt.BREAKER_COOLDOWN_S
    for rt in (jrt, trt):
        with pytest.raises(ValueError, match="threshold"):
            rt.Breaker(threshold=0)


class _Item:
    """A liveness-protocol item (the warm worker's shape), numbered in
    spawn order so two packages' pools compare."""

    def __init__(self, n):
        self.n = n
        self.live = True
        self.killed = 0
        self.shut = 0
        self.expired = False

    def alive(self):
        return self.live

    def kill(self):
        self.killed += 1
        self.live = False

    def shutdown(self):
        self.shut += 1
        self.live = False


def _pool_run(rt, script, size=2, max_leased=None, breaker=None,
              spawn_fails=()):
    """Run ``script`` on a fresh pool of numbered items; per op, what
    it returned (an item's number), then every item's liveness calls
    and the pool's accounting."""
    items = []

    def spawn():
        if len(items) in spawn_fails:
            items.append(None)
            return None
        it = _Item(len(items))
        items.append(it)
        return it

    pool = rt.LeasePool(
        size, max_leased=max_leased, spawn=spawn,
        breaker=None if breaker is None else rt.Breaker(
            threshold=breaker, cooldown_s=3600.0),
    )
    held, out = {}, []
    for op, *arg in script:
        if op == "lease":
            it = pool.lease()
            if it is not None:
                held[it.n] = it
            out.append(("lease", None if it is None else it.n))
        elif op == "release":
            n, reusable = arg
            pool.release(held.pop(n), reusable=reusable)
            out.append(("release", n))
        elif op == "expire":
            held[arg[0]].expired = True
        elif op == "die":
            items[arg[0]].live = False
        else:  # shutdown
            pool.shutdown()
            out.append(("shutdown",))
    return out, [None if it is None else (it.killed, it.shut, it.live)
                 for it in items], (pool.hits, pool.misses, pool.recycled,
                                    pool.outstanding(), pool.stats(),
                                    None if pool.breaker is None
                                    else pool.breaker.opened)


POOL_SCRIPTS = {
    "reuse": (dict(), [("lease",), ("release", 0, True), ("lease",)]),
    "max_leased": (dict(size=4, max_leased=2),
                   [("lease",), ("lease",), ("lease",), ("release", 0, True),
                    ("lease",)]),
    "recycle": (dict(), [("lease",), ("release", 0, False), ("lease",)]),
    "expired_and_dead": (dict(),
                         [("lease",), ("expire", 0), ("release", 0, True),
                          ("lease",), ("release", 1, True), ("die", 1),
                          ("lease",)]),
    "overflow_shuts_down": (dict(size=1),
                            [("lease",), ("lease",), ("release", 0, True),
                             ("release", 1, True)]),
    "shutdown": (dict(), [("lease",), ("lease",), ("release", 0, True),
                          ("shutdown",)]),
    "breaker_gates_spawn": (dict(breaker=2, spawn_fails=(0, 1, 2)),
                            [("lease",), ("lease",), ("lease",),
                             ("lease",)]),
    "engine_slots": (dict(size=3, max_leased=3),
                     [("lease",), ("lease",), ("lease",), ("lease",),
                      ("release", 1, True), ("lease",), ("release", 0, True),
                      ("release", 1, True), ("lease",), ("lease",)]),
}


@pytest.mark.parametrize("name", sorted(POOL_SCRIPTS))
def test_lease_pool_matches_reference(name):
    kw, script = POOL_SCRIPTS[name]
    got = [_pool_run(rt, script, **kw) for rt, _, _ in PKGS]
    assert got[1] == got[0]


def test_integer_slots_need_no_liveness_protocol():
    """The serve engine's slots are bare ints from a counter."""
    import itertools

    got = []
    for rt, _, _ in PKGS:
        pool = rt.LeasePool(2, max_leased=2,
                            spawn=itertools.count().__next__)
        a, b = pool.lease(), pool.lease()
        full = pool.lease()
        pool.release(a, reusable=True)
        got.append((a, b, full, pool.lease(), pool.stats()))
    assert got[1] == got[0] == (0, 1, None, 0, got[0][4])


def test_spawn_exception_aborts_the_probe_in_both():
    got = []
    for rt, _, clock_ns in PKGS:
        pool = rt.LeasePool(1, breaker=rt.Breaker(threshold=1,
                                                  cooldown_s=3600.0))

        def boom():
            raise RuntimeError("ENOSPC")

        pool._spawn = boom
        with pytest.raises(RuntimeError):
            pool.lease()
        pool.breaker.failure()
        pool.breaker.reopen_at(clock_ns() - COOLED)
        with pytest.raises(RuntimeError):
            pool.lease()
        got.append((pool.breaker.probing, pool.breaker.opened))
    assert got[1] == got[0] == (False, True)


def _table_run(rt):
    t = rt.LeaseTable()
    out = []
    for i in range(4):
        t.acquire(i, meta=i * 10)
    out.append((sorted(t.held()), len(t), 2 in t, 9 in t))
    out.append(t.release(2))
    out.append(t.release(42))  # a late settle returns None
    try:
        t.acquire(1)
    except ValueError as e:
        out.append(("ValueError", str(e)))
    out.append(t.snapshot())
    out.append(t.release_all())
    out.append((len(t), t.held()))
    return out


def test_lease_table_matches_reference():
    got = [_table_run(rt) for rt, _, _ in PKGS]
    assert got[1] == got[0]


def test_lease_table_under_contention():
    t = trt.LeaseTable()
    errs = []

    def work(base):
        try:
            for i in range(200):
                t.acquire((base, i))
                t.release((base, i))
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)

    threads = [threading.Thread(target=work, args=(b,)) for b in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs and len(t) == 0


def test_metric_totals_match_reference(tmp_path):
    """``metric_total`` over a live registry and ``metric_total_jsonl``
    over its dump sum the same series in both packages."""
    got = []
    for rt, obs, _ in PKGS:
        reg = obs.metrics_registry().__class__()
        reg.counter("tpu_patterns_x_total", site="a").inc(3)
        reg.counter("tpu_patterns_x_total", site="b").inc(4)
        reg.gauge("tpu_patterns_y", replica="1").set(2.5)
        path = tmp_path / f"{rt.__name__}.jsonl"
        path.write_text(reg.to_jsonl())
        got.append((rt.metric_total("tpu_patterns_x_total", registry=reg),
                    rt.metric_total("tpu_patterns_x_total", registry=reg,
                                    site="b"),
                    rt.metric_total("tpu_patterns_y", registry=reg),
                    rt.metric_total_jsonl(str(path),
                                          "tpu_patterns_x_total")))
    assert got[1] == got[0] == (7.0, 4.0, 2.5, 7.0)


CELL_SCRIPTS = {
    "completed_never_retried": ([(3, True)], dict()),
    "crash_then_success": ([(41, False), (0, True)], dict()),
    "same_rc_twice": ([(137, False)] * 5, dict(max_attempts=5)),
    "changing_rc_exhausts": ([(41, False), (42, False), (43, False)],
                             dict(max_attempts=3)),
    "should_stop": ([(41, False), (42, False)],
                    dict(max_attempts=5, stop=True)),
}


@pytest.mark.parametrize("name", sorted(CELL_SCRIPTS))
def test_run_cell_attempts_matches_reference(name):
    script, kw = CELL_SCRIPTS[name]
    got = []
    for faults, obs in ((jf, jobs), (tf, tobs)):
        names = ("tpu_patterns_faults_retries_total",
                 "tpu_patterns_faults_quarantined_total")
        before = [obs.counter(n, site="cell.run").value for n in names]
        rcs = iter(script)
        seen, sleeps, lines = [], [], []

        def attempt(n):
            seen.append(n)
            return next(rcs)

        res = faults.run_cell_attempts(
            attempt,
            policy=faults.RetryPolicy(
                max_attempts=kw.get("max_attempts", 2), backoff_base_s=0.1,
                jitter_frac=0.0),
            cell="c", sleep=sleeps.append, progress=lines.append,
            should_stop=(lambda: True) if kw.get("stop") else None,
        )
        moved = [obs.counter(n, site="cell.run").value - b
                 for n, b in zip(names, before)]
        got.append((res, seen, sleeps, lines, moved))
    assert got[1] == got[0]


def test_cell_retry_policy_matches_reference(monkeypatch):
    import dataclasses

    assert dataclasses.asdict(tf.cell_retry_policy()) == dataclasses.asdict(
        jf.cell_retry_policy())
    monkeypatch.setenv("TPU_PATTERNS_CELL_ATTEMPTS", "4")
    assert tf.cell_retry_policy().max_attempts == 4
    assert dataclasses.asdict(tf.cell_retry_policy()) == dataclasses.asdict(
        jf.cell_retry_policy())
    assert dataclasses.asdict(tf.serve_retry_policy()) == dataclasses.asdict(
        jf.serve_retry_policy())
    assert trt.RetryPolicy is tf.RetryPolicy
