"""The port's span layer, flight recorder, watchdog, exporters and
decision ledger against the JAX package's, and the ``obs`` CLI.

Spans nest per thread, run across threads and turn into one shared
no-op under ``TPU_PATTERNS_OBS=0``; the recorder's ring keeps the same
entries and drop count as the reference's for the same appends; the
watchdog fires on a span past its deadline with a hang dump, every
thread's stack and a WARNING Record; ``chrome_trace`` and ``summarize``
of one entry list give the reference's events and rows (the port draws
its own fixed-width table, so rows and cells are compared, not layout);
the decision ledger refuses what the reference refuses and keeps its
counter identities on a serve run; and one small serve run books the
same set of span and event names in both packages."""

import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tpu_patterns import faults as jfaults
from tpu_patterns import obs as jobs
from tpu_patterns.obs import decisions as jdecisions
from tpu_patterns.obs import export as jexport
from tpu_patterns.obs import recorder as jrecorder
from tpu_patterns_torch import faults as tfaults
from tpu_patterns_torch import obs as tobs
from tpu_patterns_torch.obs import decisions as tdecisions
from tpu_patterns_torch.obs import export as texport
from tpu_patterns_torch.obs import recorder as trecorder
from tpu_patterns_torch.obs import spans as tspans
from tpu_patterns_torch.obs import watchdog as twatchdog
from tpu_patterns_torch.obs.table import markdown_table

from test_torch_recovery import PKGS, _policy, _shared
from test_torch_tier_engine import _conv_reqs, _port, _ref

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    for pkg in (jfaults, tfaults):
        pkg.configure(None)
    for o, name in ((jobs, "ref"), (tobs, "port")):
        o.configure(str(tmp_path / name))
        o.flight_recorder().clear()
    yield
    for pkg in (jfaults, tfaults):
        pkg.configure(None)
    for o in (jobs, tobs):
        o.configure(None)


# -- spans -------------------------------------------------------------------


def test_spans_nest_and_record_in_order():
    with tobs.span("outer", k=1) as outer:
        with tobs.span("inner") as inner:
            tobs.event("tick", n="3")
    ring = tobs.flight_recorder().snapshot()
    assert [(e["kind"], e["name"]) for e in ring] == [
        ("event", "tick"), ("span", "inner"), ("span", "outer")]
    ev, sp_in, sp_out = ring
    assert sp_in["parent_id"] == outer.span_id and sp_in["depth"] == 1
    assert ev["parent_id"] == inner.span_id and ev["depth"] == 2
    assert sp_out["parent_id"] == 0 and sp_out["attrs"] == {"k": 1}
    assert sp_out["dur_ns"] >= sp_in["dur_ns"] >= 0
    assert set(sp_out) == {"kind", "name", "t0_ns", "dur_ns", "span_id",
                           "parent_id", "depth", "tid", "thread", "attrs"}
    assert not tobs.open_spans()


def test_spans_run_across_threads_with_their_own_stacks():
    barrier = threading.Barrier(3)

    def work(i):
        with tobs.span("worker", i=i):
            barrier.wait()  # all three open at once
            with tobs.span("leaf", i=i):
                pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    ring = tobs.flight_recorder().snapshot()
    workers = {e["attrs"]["i"]: e for e in ring if e["name"] == "worker"}
    leaves = [e for e in ring if e["name"] == "leaf"]
    assert len(workers) == 3 and len(leaves) == 3
    for leaf in leaves:
        parent = workers[leaf["attrs"]["i"]]
        assert leaf["parent_id"] == parent["span_id"]
        assert leaf["tid"] == parent["tid"] and leaf["depth"] == 1
    assert len({w["tid"] for w in workers.values()}) == 3


def test_disabled_spans_are_one_shared_noop():
    prev = tobs.enabled()
    tobs.set_enabled(False)
    try:
        a, b = tobs.span("x"), tobs.span("y", deadline_s=5)
        assert a is b
        with a:
            tobs.event("e")
        tobs.complete_span("z", 0, 10)
        assert len(tobs.flight_recorder()) == 0
    finally:
        tobs.set_enabled(prev)


def test_obs_env_zero_disables_at_import():
    code = ("import tpu_patterns_torch.obs as o; "
            "print(o.enabled(), o.span('a') is o.span('b'))")
    env = dict(os.environ, TPU_PATTERNS_OBS="0", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "True"]


def test_span_records_the_error_and_the_duration_histogram():
    with pytest.raises(KeyError):
        with tobs.span("boom"):
            raise KeyError("x")
    (e,) = tobs.flight_recorder().snapshot()
    assert e["error"] == "KeyError"
    h = tobs.histogram("tpu_patterns_span_duration_ns", span="boom")
    assert h.count >= 1


def test_spans_run_on_the_native_clock():
    from tpu_patterns_torch.core import timing

    assert tspans.clock_ns is timing.clock_ns


# -- the flight recorder -------------------------------------------------------


@pytest.mark.parametrize("capacity,n", [(4, 3), (4, 10), (1, 5)])
def test_recorder_ring_and_dropped_match_reference(capacity, n):
    rings = []
    for mod in (jrecorder, trecorder):
        fr = mod.FlightRecorder(capacity=capacity)
        tap = fr.open_tap(capacity=2)
        for i in range(n):
            fr.append({"kind": "event", "name": f"e{i}"})
        rings.append((fr.snapshot(), fr.dropped, len(fr), list(tap)))
        fr.close_tap(tap)
        fr.clear()
        assert len(fr) == 0 and fr.dropped == 0
    assert rings[1] == rings[0]


def test_recorder_dump_writes_meta_open_spans_and_ring(tmp_path):
    dumps = []
    for o, mod in ((jobs, jrecorder), (tobs, trecorder)):
        fr = mod.FlightRecorder(capacity=2)
        for i in range(3):
            fr.append({"kind": "event", "name": f"e{i}"})
        with o.span("still.open", deadline_s=600) as sp:
            path = fr.dump(str(tmp_path / f"{mod.__name__}.jsonl"),
                           open_spans=[sp], reason="test")
        lines = [json.loads(ln) for ln in open(path)]
        meta, opened, *ring = lines
        dumps.append((sorted(meta), {k: meta[k] for k in (
            "kind", "reason", "capacity", "entries", "dropped")},
            sorted(opened), opened["open"], opened["name"], ring))
    assert dumps[1] == dumps[0]


def test_dump_and_run_dir(tmp_path, monkeypatch):
    tobs.configure(str(tmp_path / "run"))
    assert tobs.run_dir() == str(tmp_path / "run")
    with tobs.span("s"):
        pass
    path = tobs.dump()
    assert path == os.path.join(str(tmp_path / "run"), "spans.jsonl")
    assert [e["name"] for e in texport.load_entries(path)] == ["s"]
    tobs.configure(None)
    monkeypatch.setenv("TPU_PATTERNS_OBS_DIR", str(tmp_path / "env"))
    assert tobs.run_dir() == str(tmp_path / "env")


# -- the watchdog --------------------------------------------------------------


def test_watchdog_fires_on_a_span_past_its_deadline(tmp_path, capsys):
    tobs.configure(str(tmp_path / "wd"))
    before = len(tobs.fired_dumps())
    with tobs.span("serve.step", deadline_s=0.2, rows=2):
        deadline = time.monotonic() + 10
        while len(tobs.fired_dumps()) == before:
            assert time.monotonic() < deadline, "the watchdog never fired"
            time.sleep(0.05)
    (path,) = tobs.fired_dumps()[before:]
    assert os.path.basename(path) == f"hang_serve.step_{os.getpid()}.jsonl"
    assert path in tobs.find_dumps(str(tmp_path / "wd"))
    meta, *rest = [json.loads(ln) for ln in open(path)]
    assert meta["reason"].startswith("watchdog: span 'serve.step' open")
    assert any(e.get("open") and e["name"] == "serve.step" for e in rest)
    stacks = open(path[:-len(".jsonl")] + "_stacks.txt").read()
    assert "thread MainThread" in stacks
    assert "tpu-patterns-watchdog" in stacks
    (rec,) = [json.loads(ln) for ln in open(tmp_path / "wd" /
                                            "watchdog.jsonl")]
    assert (rec["pattern"], rec["mode"], rec["verdict"]) == (
        "obs", "watchdog", "WARNING")
    assert "## watchdog | serve.step | WARNING" in capsys.readouterr().err


def test_queue_watch_fires_and_disarms(tmp_path):
    tobs.configure(str(tmp_path / "q"))
    quiet = tobs.watch_queued("cell.fast", 0.2)
    quiet.done()
    before = len(tobs.fired_dumps())
    w = tobs.watch_queued("cell.stuck", 0.2, cell="c")
    deadline = time.monotonic() + 10
    while len(tobs.fired_dumps()) == before:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    w.done()
    (path,) = tobs.fired_dumps()[before:]
    assert "hang_queued_cell.stuck" in path
    tobs.watch_queued("never", 0).done()  # deadline 0: never armed


def test_dump_all_stacks_names_every_thread(tmp_path):
    stop = threading.Event()
    th = threading.Thread(target=stop.wait, name="parked-worker")
    th.start()
    try:
        path = twatchdog.dump_all_stacks(str(tmp_path / "s.txt"))
    finally:
        stop.set()
        th.join()
    text = open(path).read()
    assert "--- thread MainThread" in text and "--- thread parked-worker" in text


# -- export --------------------------------------------------------------------


def _entries():
    """A dump's worth of entries: nested spans, an event, an open span,
    an error, two request lanes (one with a scenario), a journey."""
    e = []
    base = dict(pid=4242, thread="MainThread")
    e.append(dict(base, kind="span", name="serve.run", t0_ns=1_000,
                  dur_ns=900_000, span_id=1, parent_id=0, depth=0, tid=7,
                  attrs={"requests": 4}))
    e.append(dict(base, kind="span", name="serve.step", t0_ns=2_000,
                  dur_ns=400_000, span_id=2, parent_id=1, depth=1, tid=7,
                  attrs={"rows": 2}))
    e.append(dict(base, kind="span", name="serve.step", t0_ns=500_000,
                  dur_ns=300_000, span_id=3, parent_id=1, depth=1, tid=7,
                  attrs={"rows": 2}, error="InjectedFault"))
    e.append(dict(base, kind="event", name="serve.quarantine",
                  t0_ns=810_000, dur_ns=0, span_id=0, parent_id=1, depth=1,
                  tid=7, attrs={"rid": "3", "reason": "x"}))
    e.append(dict(base, kind="span", name="req.queued", t0_ns=0,
                  dur_ns=1_500, span_id=4, parent_id=0, depth=0,
                  tid=1_000_003, attrs={"rid": 3, "jid": "j1"}))
    e.append(dict(base, kind="span", name="req.decode", t0_ns=3_000,
                  dur_ns=600_000, span_id=5, parent_id=0, depth=0,
                  tid=1_000_004, attrs={"rid": 4, "scenario": "chat",
                                        "tokens": 6}))
    e.append(dict(base, kind="span", name="req.failed", t0_ns=820_000,
                  dur_ns=0, span_id=6, parent_id=0, depth=0,
                  tid=1_000_003, attrs={"rid": 3, "jid": "j1"}))
    e.append(dict(base, kind="span", name="serve.verify", t0_ns=850_000,
                  dur_ns=50_000, span_id=7, parent_id=1, depth=1, tid=7,
                  attrs={}, open=True))
    return e


def _cell(c: str):
    """A cell's value: a number as a float (``tabulate`` prints 0.900 as
    0.9), anything else as its text."""
    c = c.strip()
    try:
        return float(c)
    except ValueError:
        return c


def _table_rows(text: str) -> list[list]:
    """The cells of a markdown table's data rows, whatever the column
    widths and number formatting."""
    lines = [ln for ln in text.splitlines() if ln.startswith("|")]
    return [[_cell(c) for c in ln.strip("|").split("|")]
            for ln in lines[2:]]


def test_chrome_trace_matches_reference():
    ents = _entries()
    assert texport.chrome_trace(ents) == jexport.chrome_trace(ents)
    names = {0: "router", 4242: "replica 0"}
    assert texport.chrome_trace(ents, process_names=names) == \
        jexport.chrome_trace(ents, process_names=names)
    trace = texport.chrome_trace(ents)
    lanes = {ev["args"]["name"] for ev in trace["traceEvents"]
             if ev["ph"] == "M"}
    assert lanes == {"req 3", "req 4 [chat]"}


def test_summarize_and_span_stats_match_reference():
    ents = _entries()
    assert texport.span_stats(ents) == jexport.span_stats(ents)
    ours, ref = texport.summarize(ents), jexport.summarize(ents)
    assert _table_rows(ours) == _table_rows(ref)
    assert ours.splitlines()[-1] == ref.splitlines()[-1]


def test_load_and_dedupe_match_reference(tmp_path):
    path = tmp_path / "d.jsonl"
    ents = _entries()
    closed = dict(ents[-1])
    closed.pop("open")
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "meta", "reason": "x"}) + "\n")
        for e in ents + [ents[1], closed]:
            f.write(json.dumps(e) + "\n")
        f.write('{"kind": "span", "name": "torn')  # a dying writer
    got = texport.dedupe_entries(texport.load_entries(str(path)))
    want = jexport.dedupe_entries(jexport.load_entries(str(path)))
    assert got == want and len(got) == len(ents)
    assert not any(e.get("open") for e in got)


def test_write_chrome_trace_loads(tmp_path):
    out = texport.write_chrome_trace(_entries(), str(tmp_path / "t" /
                                                    "trace.json"))
    trace = json.load(open(out))
    assert trace["displayTimeUnit"] == "ms"
    assert {ev["ph"] for ev in trace["traceEvents"]} >= {"X", "i", "M"}


def test_host_device_join_names_its_step(monkeypatch):
    """The join against a device breakdown (``core/profile.py``): no
    device plane gives the reference's host-only line; a breakdown gives
    the reference's device section, its numbers line for line (the
    engines are named for the card: SMs, NCCL, copies)."""
    import re

    from tpu_patterns.core import profile as jprofile
    from tpu_patterns_torch.core import profile as tprofile

    def tail(text):
        lines = text.splitlines()
        return lines[lines.index("device plane (core/profile.py "
                                 "breakdown):"):]

    got = texport.host_device_join(_entries(), "/nonexistent")
    want = jexport.host_device_join(_entries(), "/nonexistent")
    assert got.splitlines()[-1] == want.splitlines()[-1] == (
        "(no device plane under /nonexistent — host spans only)")
    bd = {"compute_ms": 3.5, "collective_ms": 0.25, "dma_ms": 0.125,
          "infeed_outfeed_ms": 0.5, "other_ms": 0.0, "busy_ms": 4.0,
          "wall_ms": 10.0, "idle_ms": 6.0, "compute_frac": 0.8046,
          "collective_frac": 0.0575, "dma_frac": 0.0287,
          "infeed_outfeed_frac": 0.1149, "other_frac": 0.0,
          "n_device_planes": 1.0}
    monkeypatch.setattr(tprofile, "breakdown", lambda d: dict(bd))
    monkeypatch.setattr(jprofile, "breakdown", lambda d: dict(bd))
    got = tail(texport.host_device_join(_entries(), "p"))
    want = tail(jexport.host_device_join(_entries(), "p"))
    num = re.compile(r"[0-9.]+%?")
    assert got[0] == want[0] == "device plane (core/profile.py breakdown):"
    assert [num.findall(ln.split(")", 1)[-1]) for ln in got[1:]] == \
        [num.findall(ln.split(")", 1)[-1]) for ln in want[1:]]
    assert "SMs (compute)" in got[2] and "MXU (compute)" in want[2]


def test_markdown_table_cells():
    text = markdown_table([["a", 1, "2.50"], ["bbb", 10, ""]],
                          headers=["name", "n", "x"])
    assert _table_rows(text) == [["a", 1.0, 2.5], ["bbb", 10.0, ""]]
    assert "| 2.50 |" in text
    head, rule = text.splitlines()[:2]
    assert len(head) == len(rule)


# -- the decision ledger -----------------------------------------------------


def test_ledger_refuses_an_unknown_action_as_the_reference():
    msgs = []
    for mod in (jdecisions, tdecisions):
        with pytest.raises(ValueError) as e:
            mod.DecisionLedger().book("panic")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert tdecisions.ACTIONS == jdecisions.ACTIONS
    assert tdecisions.COUNTER_IDENTITIES == jdecisions.COUNTER_IDENTITIES


def test_ledger_fails_open_under_a_booking_fault():
    led = tdecisions.DecisionLedger()
    before = tobs.counter("tpu_patterns_decision_events_total",
                          action="defer").value
    tfaults.configure("obs.cost_book:error:count=1")
    led.book("defer", rid=1, need=3)
    tfaults.configure(None)
    led.book("defer", rid=2, need=3)
    assert led.count("defer") == 1 and led.events[0]["rid"] == 2
    assert tobs.counter("tpu_patterns_decision_events_total",
                        action="defer").value == before + 1


def _counter_deltas(obs, names, fn):
    """Run ``fn``; how far each (metric, labels) counter moved."""
    before = {k: obs.counter(k[0], **dict(k[1])).value for k in names}
    fn()
    return {k: obs.counter(k[0], **dict(k[1])).value - before[k]
            for k in names}


def test_ledger_keeps_counter_identity_on_a_serve_run():
    """The tiered engine on the conversation trace defers and evicts:
    ``decision_events_total{action}`` moves with the counter each action
    identifies with, the ledger's counts equal the engine's stats, and
    the ledger books what the reference's books."""
    names = [("tpu_patterns_decision_events_total", (("action", a),))
             for a in ("defer", "evict")] + [
        ("tpu_patterns_serve_deferrals_total", ()),
        ("tpu_patterns_serve_kv_evictions_total", ())]
    seen = {}
    for which, (Eng, Req, faults, obs, _) in PKGS.items():
        dec, params = (_ref if which == "ref" else _port)(13)
        eng = Eng(dec, params, slots=4, kv_host_tier=True)
        moved = _counter_deltas(obs, names,
                                lambda: eng.run(_conv_reqs(6, Req)))
        seen[which] = (moved, [(e["action"], e["rid"], e["count"])
                               for e in eng.decisions.events],
                       eng.stats["deferrals"], eng.stats["evictions"])
    assert seen["port"] == seen["ref"]
    moved, events, deferrals, evictions = seen["port"]
    assert moved[names[0]] == moved[names[2]] == deferrals > 0
    assert moved[names[1]] == moved[names[3]] == evictions > 0


# -- one serve run's names -----------------------------------------------------


def _names(obs) -> tuple[set, set]:
    ring = obs.flight_recorder().snapshot()
    return ({e["name"] for e in ring if e["kind"] == "span"},
            {e["name"] for e in ring if e["kind"] == "event"})


def _cow(cls, seed=7):
    """Prompts sharing 12 tokens (one block and a half at block_len 8)
    over 2 slots: rows 2 and 3 admit while row 0 still runs, alias its
    first block and copy the boundary block (CoW)."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, 64, 12).tolist()
    return [cls(rid=i, tokens=shared + rng.randint(0, 64, 4).tolist(),
                n_gen=g) for i, g in enumerate((12, 2, 3, 3))]


@pytest.mark.parametrize("case", ["shared_spec_faulted", "tier", "cow"])
def test_serve_run_books_the_references_span_and_event_names(case):
    """One small serve run per package, the ring cleared before: the same
    span names and the same event names."""
    got = {}
    for which, (Eng, Req, faults, obs, _) in PKGS.items():
        obs.flight_recorder().clear()
        if case == "shared_spec_faulted":
            dec, params = (_ref if which == "ref" else _port)(17)
            faults.configure("serve.verify:error:after=1:count=1,"
                             "serve.prefill:error:after=1:count=2")
            try:
                eng = Eng(dec, params, slots=2, prefix_share=True, spec_k=3,
                          retry_policy=_policy(faults))
                eng.run(_shared(Req, n=5, n_gen=6))
            finally:
                faults.configure(None)
            assert eng.failed
        elif case == "tier":
            dec, params = (_ref if which == "ref" else _port)(13)
            Eng(dec, params, slots=4, kv_host_tier=True).run(
                _conv_reqs(6, Req))
        else:
            dec, params = (_ref if which == "ref" else _port)(13)
            Eng(dec, params, slots=2, prefix_share=True).run(_cow(Req))
        got[which] = _names(obs)
    assert got["port"] == got["ref"]
    spans, events = got["port"]
    assert {"serve.run", "serve.step_outer", "serve.prefill",
            "req.queued", "req.prefill", "req.decode"} <= spans
    if case == "shared_spec_faulted":
        assert {"serve.verify", "req.failed"} <= spans
        assert {"fault.injected", "serve.quarantine"} <= events
    if case == "tier":
        assert {"serve.kv_evict", "serve.kv_onload", "serve.defer",
                "decision.defer", "decision.evict"} <= events
    if case == "cow":
        assert "serve.cow_copy" in events


# -- the obs CLI -------------------------------------------------------------


def _cli(argv):
    from tpu_patterns_torch import cli

    out = io.StringIO()
    import contextlib

    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


SERVE_ARGV = ["serve", "--device", "cpu", "--vocab", "64", "--embed", "64",
              "--head_dim", "8", "--depth", "1", "--requests", "4",
              "--min_prompt", "4", "--max_prompt", "24", "--gen", "8",
              "--slots", "2", "--block_len", "8", "--min_speedup", "0"]


def test_obs_cli_summarize_export_and_cost(tmp_path):
    obs_dir = str(tmp_path / "obs")
    rc, out = _cli(["--obs-dir", obs_dir, "--obs-dump", *SERVE_ARGV])
    assert rc == 0
    for name in ("spans.jsonl", "metrics.jsonl", "cost.jsonl"):
        assert os.path.exists(os.path.join(obs_dir, name)), name
    rc, out = _cli(["--obs-dir", obs_dir, "obs", "summarize"])
    rows = {r[0]: r for r in _table_rows(out.split("\n\n")[0] + "\n")}
    assert rc == 0 and {"serve.run", "serve.step_outer",
                        "serve.step"} <= set(rows)
    trace = str(tmp_path / "trace.json")
    rc, out = _cli(["--obs-dir", obs_dir, "obs", "export",
                    "--chrome-trace", trace, "--prom"])
    assert rc == 0 and json.load(open(trace))["traceEvents"]
    assert "tpu_patterns_serve_tokens_total" in out
    rc, out = _cli(["--obs-dir", obs_dir, "obs", "cost"])
    assert rc == 0 and "identities OK" in out
    assert os.path.exists(os.path.join(obs_dir, "cost_rollup.jsonl"))


@pytest.mark.parametrize("argv,match", [
    # the fleet readers are ported: over an empty obs dir they refuse as
    # the reference's do (these cases keep the ids they had while the
    # readers were refused)
    pytest.param(["obs", "fleet"], "no fleet dumps",
                 id="argv0-Queue 1 step 9"),
    pytest.param(["obs", "journey", "3"], "no fleet dumps",
                 id="argv1-Queue 1 step 9"),
    pytest.param(["obs", "explain", "3"], "no fleet dumps",
                 id="argv2-Queue 1 step 9"),
    # the join reads the obs dumps first (this case's id is the one it
    # had while the join was refused)
    pytest.param(["obs", "summarize", "--profile-dir", "p"], "no obs dumps",
                 id="argv3-Queue 1 step 6"),
    (["obs", "export"], "--chrome-trace"),
    (["obs", "watch"], "plane URL"),
])
def test_obs_cli_refusals(argv, match, tmp_path):
    with pytest.raises(SystemExit) as e:
        _cli(["--obs-dir", str(tmp_path), *argv])
    assert match in str(e.value.code)


def test_crash_handlers_chain_the_previous_hook(tmp_path, monkeypatch):
    import signal

    from tpu_patterns_torch import obs as o

    seen = []
    monkeypatch.setattr(sys, "excepthook", lambda *a: seen.append(a[0]))
    monkeypatch.setattr(o, "_CRASH_INSTALLED", False)
    prev_term = signal.getsignal(signal.SIGTERM)
    try:
        o.configure(str(tmp_path / "crash"))
        o.install_crash_handlers()
        with o.span("before.crash"):
            pass
        sys.excepthook(ValueError, ValueError("boom"), None)
        assert seen == [ValueError]
        dump = [json.loads(ln) for ln in open(tmp_path / "crash" /
                                               "crash.jsonl")]
        assert dump[0]["reason"] == "uncaught ValueError: boom"
        assert dump[-1]["name"] == "before.crash"
        assert signal.getsignal(signal.SIGTERM) is not prev_term
    finally:
        signal.signal(signal.SIGTERM, prev_term)
