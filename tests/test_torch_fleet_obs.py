"""The port's fleet observability (``tpu_patterns_torch/obs/fleet.py``)
against the JAX package's: on the same seeded dumps (a parent and two
replica dirs with their own spans, shipped copies that overlap them,
hang dumps and torn lines) ``merge_fleet`` gives the same entries on the
same clock with the same process lanes, ``journeys`` and
``resolve_journey`` the same journeys, and ``journey_table`` the same
rows; ``FleetObs`` merges shipped metrics and reconciles mirrors
alike."""

import json
import os

import numpy as np
import pytest
import torch

from tpu_patterns import obs as jobs
from tpu_patterns import rt as jrt
from tpu_patterns.obs import fleet as jfleet
from tpu_patterns_torch import obs as tobs
from tpu_patterns_torch import rt as trt
from tpu_patterns_torch.obs import fleet as tfleet

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

NAMES = ["req.queued", "req.prefill", "req.retired", "req.failed",
         "serve.step", "serve.prefill"]


def _write(path, lines):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for ln in lines:
            f.write(ln if isinstance(ln, str) else json.dumps(ln))
            f.write("\n")


def _dumps(root, seed):
    """A fleet's obs dir: the parent's route/reroute anchors and two
    replicas' lifecycle spans, each replica's own dump overlapping its
    shipped copy, plus a hang dump and torn lines."""
    rng = np.random.RandomState(seed)
    jids = [f"j{seed:x}-{i}" for i in range(6)]
    parent = [{"kind": "meta", "reason": "end_of_run", "wall_ts": 1000.0,
               "clock_ns": 5_000_000}]
    for i, jid in enumerate(jids):
        parent.append({"kind": "event", "name": "journey.route",
                       "t0_ns": 5_000_000 + 1000 * i, "dur_ns": 0, "tid": 1,
                       "span_id": 100 + i,
                       "attrs": {"jid": jid, "rid": str(i),
                                 "replica": str(i % 2)}})
    parent.append({"kind": "event", "name": "journey.reroute",
                   "t0_ns": 5_090_000, "dur_ns": 0, "tid": 1, "span_id": 200,
                   "attrs": {"jid": jids[1], "rid": "1", "replica": "0"}})
    parent.append('{"kind": "span", "name": "torn')  # a dying writer
    _write(os.path.join(root, "spans.jsonl"), parent)
    for rep in ("0", "1"):
        own = [{"kind": "meta", "reason": "end_of_run",
                "wall_ts": 1000.0 + 0.5 * int(rep),
                "clock_ns": 70_000_000 + int(rep)}]
        for i, jid in enumerate(jids):
            if i % 2 != int(rep) and not (rep == "0" and i == 1):
                continue
            t0 = 70_000_000 + int(rng.randint(0, 90_000))
            for k, name in enumerate(NAMES):
                if name == "req.failed" and i != 1:
                    continue
                own.append({
                    "kind": "span", "name": name, "t0_ns": t0 + 10 * k,
                    "dur_ns": int(rng.randint(0, 5000)),
                    "tid": 1_000_000 + i, "span_id": 1000 * i + k,
                    "attrs": {"rid": i, "jid": jid, "replica": rep},
                })
            own.append({"kind": "event", "name": "journey.admit",
                        "t0_ns": t0 + 5, "dur_ns": 0, "tid": 3,
                        "span_id": 5000 + i,
                        "attrs": {"jid": jid, "rid": str(i),
                                  "replica": rep}})
        half = len(own) // 2
        _write(os.path.join(root, f"replica-{rep}", "spans.jsonl"),
               own[: half + 3])
        shipped = [{"kind": "meta", "reason": "shipped", "replica": rep,
                    "wall_ts": own[0]["wall_ts"],
                    "clock_ns": own[0]["clock_ns"]}] + own[half:]
        _write(os.path.join(root, f"replica-{rep}", "shipped.jsonl"),
               shipped + ["{not json"])
    _write(os.path.join(root, "replica-1", "hang_3.jsonl"),
           [{"kind": "meta", "reason": "hang"},
            {"kind": "span", "name": "serve.step", "t0_ns": 70_000_500,
             "dur_ns": 0, "tid": 2, "span_id": 9999, "open": True,
             "attrs": {}}])
    os.makedirs(os.path.join(root, "replica-x-not-a-number"))
    return jids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_and_journeys_match(seed, tmp_path):
    jids = _dumps(str(tmp_path), seed)
    got, got_procs = tfleet.merge_fleet(str(tmp_path))
    want, want_procs = jfleet.merge_fleet(str(tmp_path))
    assert got == want and got_procs == want_procs
    assert set(got_procs) == {0, 1, jfleet.ROUTER_PID}
    gj, wj = tfleet.journeys(got), jfleet.journeys(want)
    assert gj == wj and set(gj) == set(jids)
    for key in (jids[1], "1", "4", "nope"):
        assert tfleet.resolve_journey(got, key) == \
            jfleet.resolve_journey(want, key)


def _cell(c: str):
    """A cell's value: a number as a float (the reference renders with
    ``tabulate``, which reformats numeric strings: "0.000" -> "0")."""
    c = c.strip()
    try:
        return float(c)
    except ValueError:
        return c


def _rows(table: str) -> list[list]:
    """A markdown table's cells, the rule row dropped."""
    rows = []
    for line in table.splitlines():
        if not line.startswith("|") or set(line) <= set("|-: "):
            continue
        rows.append([_cell(c) for c in line.strip("|").split("|")])
    return rows


@pytest.mark.parametrize("key", ["1", "4", "j0-2", "absent"])
def test_journey_table_rows_match(key, tmp_path):
    _dumps(str(tmp_path), 0)
    merged, _ = tfleet.merge_fleet(str(tmp_path))
    got = tfleet.journey_table(merged, key)
    want = jfleet.journey_table(jfleet.merge_fleet(str(tmp_path))[0], key)
    assert got.splitlines()[0] == want.splitlines()[0]
    assert _rows(got) == _rows(want)
    if key != "absent":
        assert len(_rows(got)) > 2


def test_names_and_pids_match():
    for name in ("tpu_patterns_serve_tokens_total", "tpu_patterns_x"):
        assert tfleet.fleet_name(name) == jfleet.fleet_name(name)
    with pytest.raises(ValueError):
        tfleet.fleet_name("other_total")
    for rep in ("0", "7", "abc"):
        assert tfleet.replica_pid(rep) == jfleet.replica_pid(rep)
    assert tfleet.ROUTER_PID == jfleet.ROUTER_PID
    assert tfleet.JOURNEY_EVENTS == jfleet.JOURNEY_EVENTS
    assert tfleet.JOURNEY_SPANS == jfleet.JOURNEY_SPANS
    a, b = tfleet.new_journey_id(), tfleet.new_journey_id()
    assert a != b and a.startswith(f"j{os.getpid():x}-")


@pytest.fixture
def _registries(tmp_path):
    for o in (jobs, tobs):
        o.metrics_registry().clear()
        o.configure(str(tmp_path))
    yield
    for o in (jobs, tobs):
        o.metrics_registry().clear()
        o.configure(None)


def _absorb(fleet_mod, rt_mod, base):
    fo = fleet_mod.FleetObs(base)
    fo.reset_base()
    for rep, vals in (("0", (2.0, 5.0)), ("1", (1.0,))):
        for v in vals:
            fo.absorb(rep, {
                "op": "obs",
                "entries": [{"kind": "event", "name": "x", "t0_ns": 1}],
                "metrics": [
                    {"metric": "tpu_patterns_serve_requests_total",
                     "type": "counter", "labels": {}, "value": v},
                    {"metric": "tpu_patterns_serve_active_rows",
                     "type": "gauge", "labels": {}, "value": v * 2},
                ],
                "clock": {"wall_ts": 1.0, "clock_ns": 2},
            })
    fo.mirror("0", "tpu_patterns_replica_drains_total", mode="checkpoint")
    fo.mirror("2", "tpu_patterns_replica_drains_total", mode="checkpoint")
    notes = fo.reconcile()
    fo.close()
    lines = open(os.path.join(base, "replica-0", "shipped.jsonl")).read()
    return (notes, fo.total("tpu_patterns_serve_requests_total"),
            fo.total("tpu_patterns_replica_drains_total", mode="checkpoint"),
            rt_mod.metric_total("tpu_patterns_fleet_serve_requests_total"),
            rt_mod.metric_total("tpu_patterns_fleet_replica_drains_total"),
            sorted(fo.shipped), [json.loads(ln)["kind"]
                                 for ln in lines.splitlines()])


def test_fleet_obs_absorbs_and_reconciles_alike(tmp_path, _registries):
    got = _absorb(tfleet, trt, str(tmp_path / "t"))
    want = _absorb(jfleet, jrt, str(tmp_path / "j"))
    assert got == want
    assert len(got[0]) == 1  # replica 0 shipped, but not its checkpoint


def _fake_fleet(fleet_mod, rt_mod):
    """A manager's surface the live plane reads: handles with states,
    leases, breakers, and the shipped obs totals."""
    import types

    handles = {}
    for rid, state, leases, stalled in (("0", "ready", [3, 1], False),
                                        ("1", "dead", [], False),
                                        ("2", "ready", [], True)):
        lt = rt_mod.LeaseTable()
        for r in leases:
            lt.acquire(r)
        handles[rid] = types.SimpleNamespace(
            id=rid, state=state, leases=lt, obs_stalled=stalled,
            breaker=rt_mod.Breaker(threshold=2), last_msg_ns=0,
            alive=lambda state=state: state != "dead",
        )
    fo = fleet_mod.FleetObs(None)
    fo.absorb("0", {"op": "obs", "entries": [], "metrics": [
        {"metric": "tpu_patterns_serve_requests_total", "type": "counter",
         "labels": {}, "value": 4.0}]})
    return types.SimpleNamespace(handles=handles, fleet_obs=fo)


def test_live_plane_fleet_lanes_match(_registries):
    from tpu_patterns.obs import live as jlive
    from tpu_patterns_torch.obs import live as tlive

    got = {}
    for name, live, fmod, rmod in (("jax", jlive, jfleet, jrt),
                                   ("torch", tlive, tfleet, trt)):
        mgr = _fake_fleet(fmod, rmod)
        live.attach_fleet(mgr)
        try:
            assert live.current_fleet() is mgr
            health = live.health_snapshot()
            status = live.status_snapshot()
        finally:
            live.detach_fleet(mgr)
        assert live.current_fleet() is None
        for lane in status["fleet"]["replicas"]:
            lane.pop("last_msg_age_s")
        got[name] = (health["verdict"], health["fleet"], status["fleet"])
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "degraded"
