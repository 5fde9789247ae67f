"""The port's replica fleet (``tpu_patterns_torch/serve/replica.py``)
against the JAX package's.

Parent-side machinery runs against FAKE replica processes (no
subprocess), in the reference's own ``tests/test_replica.py`` style:
each scenario drives both packages' ``ReplicaManager`` through the same
dispatches, deaths, drains, failures, spawns, obs batches and scale
decisions, and the two must settle the same leases, reroutes, verdicts,
messages and counts.  Then the real thing at a small size: a fleet of
two CPU replica processes (``python -m tpu_patterns_torch`` children)
whose completed ids equal the reference's dense decode of the same
weights, with no block leaked and the coverage identity closed, and a
leg that SIGKILLs one child and reroutes its requests exactly."""

import dataclasses
import json
import os
import queue
import random
import types

import numpy as np
import pytest
import torch

from tpu_patterns import faults as jfaults
from tpu_patterns import obs as jobs
from tpu_patterns import rt as jrt
from tpu_patterns.obs import fleet as jfleet
from tpu_patterns.obs.decisions import DecisionLedger as JLedger
from tpu_patterns.serve import elastic as jelastic
from tpu_patterns.serve import replica as jreplica
from tpu_patterns.serve.engine import Request as JRequest
from tpu_patterns.serve.router import Router as JRouter
from tpu_patterns_torch import faults as tfaults
from tpu_patterns_torch import obs as tobs
from tpu_patterns_torch import rt as trt
from tpu_patterns_torch.obs import fleet as tfleet
from tpu_patterns_torch.obs.decisions import DecisionLedger as TLedger
from tpu_patterns_torch.serve import elastic as telastic
from tpu_patterns_torch.serve import replica as treplica
from tpu_patterns_torch.serve.engine import Request as TRequest
from tpu_patterns_torch.serve.router import Router as TRouter

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

REF = types.SimpleNamespace(
    name="jax", faults=jfaults, obs=jobs, rt=jrt, fleet=jfleet,
    Ledger=JLedger, elastic=jelastic, replica=jreplica, Request=JRequest,
    Router=JRouter, proc="tpu_patterns.exec.proc",
)
PORT = types.SimpleNamespace(
    name="torch", faults=tfaults, obs=tobs, rt=trt, fleet=tfleet,
    Ledger=TLedger, elastic=telastic, replica=treplica, Request=TRequest,
    Router=TRouter, proc="tpu_patterns_torch.exec.proc",
)


class _FakeStdin:
    def __init__(self):
        self.sent = []
        self.broken = False

    def write(self, s):
        if self.broken:
            raise BrokenPipeError("gone")
        self.sent.append(json.loads(s))

    def flush(self):
        pass

    def close(self):
        pass


_FAKE_PROCS: list = []


class _FakeProc:
    """A live 'process' whose stdout never speaks (the reader thread
    parks on a queue-backed line iterator until teardown)."""

    def __init__(self):
        self.stdin = _FakeStdin()
        self._lines: queue.Queue = queue.Queue()
        self.stdout = iter(self._lines.get, None)
        self.dead = False
        _FAKE_PROCS.append(self)

    def poll(self):
        return 1 if self.dead else None

    def wait(self, timeout=None):
        return 0


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    for P in (REF, PORT):
        P.faults.configure(None)
        P.obs.flight_recorder().clear()
        P.obs.metrics_registry().clear()
        P.obs.configure(str(tmp_path / P.name))
    yield
    for P in (REF, PORT):
        P.faults.configure(None)
        P.obs.flight_recorder().clear()
        P.obs.metrics_registry().clear()
        P.obs.configure(None)
    while _FAKE_PROCS:
        _FAKE_PROCS.pop()._lines.put(None)


def _manager(P, n=2, policy="prefix", obs_base=None, reserve=0, slots=2,
             **ecfg_kw):
    """A fake-process manager (the reference test's construction), with
    the elastic plane when ``reserve`` > 0 (zero hysteresis unless
    given: the policy's own hysteresis has its own test)."""
    mgr = P.replica.ReplicaManager.__new__(P.replica.ReplicaManager)
    n_total = n + reserve
    mgr.n = n
    mgr.base_env = {}
    mgr.work_dir = ""
    mgr.child_cfg = {"block_len": 8, "slots": slots}
    mgr.device_slices = [[i] for i in range(n_total)]
    mgr.sp, mgr.tp = 1, 1
    mgr.watchdog_s = 120.0
    mgr.obs_watchdog_s = 120.0
    mgr.warm = []
    mgr.retry_policy = P.rt.RetryPolicy(max_attempts=2, backoff_base_s=0.0)
    mgr.router = P.Router([str(r) for r in range(n_total)], block_len=8,
                          policy=policy)
    mgr.inbox = queue.Queue()
    mgr.handles = {}
    mgr.spawn_retries = 0
    mgr.drains = 0
    mgr.fleet_obs = P.fleet.FleetObs(obs_base)
    mgr.obs_stalls = 0
    mgr.elastic = None
    mgr._spare = []
    mgr.decisions = P.Ledger()
    mgr.roles = {}  # the reference's disagg plane, unused here
    mgr._decode_rr = 0
    if reserve or ecfg_kw:
        ecfg_kw.setdefault("sustain_s", 0.0)
        ecfg_kw.setdefault("cooldown_s", 0.0)
        mgr.elastic = P.elastic.ElasticPolicy(
            P.elastic.ElasticConfig(reserve=reserve, **ecfg_kw))
        mgr._spare = list(range(n, n_total))
        for r in mgr._spare:
            mgr.router.quarantine(str(r))
    for r in range(n):
        h = P.replica.ReplicaHandle(str(r), _FakeProc(), mgr.inbox)
        h.state = "ready"
        mgr.handles[str(r)] = h
    return mgr


def _reqs(P, n, bl=8):
    return [P.Request(rid=i, tokens=[i % 3] * bl + [i], n_gen=4)
            for i in range(n)]


def _res(P, reqs):
    return P.replica.FleetResult(scheduled=len(reqs),
                                 requests_by_rid={r.rid: r for r in reqs})


def _sent(h) -> list[dict]:
    """A handle's protocol messages, journey ids and paths dropped (a
    jid carries the stamping process's pid)."""
    out = []
    for m in h.proc.stdin.sent:
        m = {k: v for k, v in m.items() if k not in ("jid", "snapshot_dir",
                                                     "session_dir")}
        out.append(m)
    return out


def _state(mgr, res) -> dict:
    """Everything a fail-over scenario settles, comparable across the
    packages."""
    return {
        "states": {k: h.state for k, h in sorted(mgr.handles.items())},
        "leases": {k: sorted(h.leases.held())
                   for k, h in sorted(mgr.handles.items())},
        "sent": {k: _sent(h) for k, h in sorted(mgr.handles.items())},
        "done": dict(res.done), "failed": dict(res.failed),
        "shed": dict(res.shed), "rerouted": sorted(res.rerouted),
        "covered": res.covered(), "counts": res.counts(),
        "drains": mgr.drains, "spawn_retries": mgr.spawn_retries,
        "live": sorted(mgr.router.live()),
        "scale_events": list(res.scale_events),
        "spare": list(mgr._spare),
        "routed": mgr.router.routed, "reroutes": mgr.router.reroutes,
        "prefix_hits": mgr.router.prefix_hits,
    }


def _victim(mgr):
    return next(h for h in mgr.handles.values() if len(h.leases))


# -- fail-over scenarios ----------------------------------------------------


def sc_quarantine_releases_every_lease(P, seed):
    rng = random.Random(seed)
    mgr = _manager(P, 3)
    reqs = _reqs(P, rng.randint(1, 12))
    res = _res(P, reqs)
    for r in reqs:
        mgr._dispatch(r, res)
    victim = mgr.handles[rng.choice(["0", "1", "2"])]
    held = set(victim.leases.held())
    mgr._replica_down(victim, "test kill", res)
    assert len(victim.leases) == 0 and held <= res.rerouted
    return _state(mgr, res)


def sc_survivors_checkpoint_on_death(P, seed):
    mgr = _manager(P, 2)
    res = _res(P, [])
    mgr._replica_down(mgr.handles["0"], "test", res)
    assert {"op": "checkpoint"} in mgr.handles["1"].proc.stdin.sent
    return _state(mgr, res)


def sc_drained_handback_reroutes_pending(P, seed):
    mgr = _manager(P, 2)
    reqs = _reqs(P, 4)
    res = _res(P, reqs)
    for r in reqs:
        mgr._dispatch(r, res)
    victim = _victim(mgr)
    mgr._handle(victim.id, {
        "op": "drained", "pending": sorted(victim.leases.held()),
        "snapshot_step": 3, "stats": {"leaked_blocks": 0},
    }, res)
    assert victim.state == "drained" and mgr.drains == 1
    return _state(mgr, res)


def sc_consecutive_failures_open_breaker_and_drain(P, seed):
    mgr = _manager(P, 2)
    reqs = _reqs(P, 6)
    res = _res(P, reqs)
    for r in reqs:
        mgr._dispatch(r, res)
    victim = next(h for h in mgr.handles.values() if len(h.leases) >= 2)
    for rid in sorted(victim.leases.held())[:2]:
        mgr._handle(victim.id,
                    {"op": "failed", "rid": rid, "reason": "step died"}, res)
    assert victim.state == "quarantined"
    return _state(mgr, res)


def sc_single_failure_on_healthy_replica_finalizes(P, seed):
    mgr = _manager(P, 2)
    reqs = _reqs(P, 2)
    res = _res(P, reqs)
    for r in reqs:
        mgr._dispatch(r, res)
    victim = _victim(mgr)
    rid = sorted(victim.leases.held())[0]
    mgr._handle(victim.id,
                {"op": "failed", "rid": rid, "reason": "poisoned row"}, res)
    for other in sorted(victim.leases.held()):
        mgr._handle(victim.id, {"op": "done", "rid": other, "ids": [1]},
                    res)
    mgr._finalize_tentative(res)
    assert res.failed.get(rid) == "poisoned row"
    return _state(mgr, res)


def sc_reroute_budget_is_one(P, seed):
    mgr = _manager(P, 3)
    reqs = _reqs(P, 1)
    res = _res(P, reqs)
    mgr._dispatch(reqs[0], res)
    mgr._replica_down(_victim(mgr), "kill 1", res)
    mgr._replica_down(_victim(mgr), "kill 2", res)
    assert 0 in res.failed and res.covered()
    return _state(mgr, res)


def sc_spawn_site_retries_then_succeeds(P, seed, tmp_path):
    P.faults.configure("replica.spawn:error:count=1")
    mgr = _manager(P, 1)
    mgr.work_dir = str(tmp_path / P.name)
    h = mgr._spawn_one(0)
    assert mgr.spawn_retries == 1
    init = h.proc.stdin.sent[0]
    return {"op": init["op"], "replica": init["replica"],
            "retries": mgr.spawn_retries,
            "keys": sorted(set(init) - {"devices", "role", "spool_dir"})}


def sc_spawn_deterministic_failure_quarantines(P, seed, tmp_path):
    P.faults.configure("replica.spawn:error:count=99")
    mgr = _manager(P, 1)
    mgr.work_dir = str(tmp_path / P.name)
    with pytest.raises(P.faults.Quarantined):
        mgr._spawn_one(0)
    return {"raised": True}


def sc_drain_site_error_reads_as_unresponsive(P, seed):
    P.faults.configure("replica.drain:error:count=1")
    mgr = _manager(P, 2)
    reqs = _reqs(P, 4)
    res = _res(P, reqs)
    for r in reqs:
        mgr._dispatch(r, res)
    victim = _victim(mgr)
    mgr._quarantine(victim, res)
    assert victim.state == "dead" and len(victim.leases) == 0
    return _state(mgr, res)


def sc_counts_identity_closes(P, seed):
    mgr = _manager(P, 2)
    reqs = _reqs(P, 6)
    res = _res(P, reqs)
    for r in reqs:
        mgr._dispatch(r, res)
    victim = _victim(mgr)
    survivor = next(h for h in mgr.handles.values() if h is not victim)
    mgr._replica_down(victim, "chaos", res)
    for rid in sorted(survivor.leases.held()):
        mgr._handle(survivor.id, {"op": "done", "rid": rid, "ids": [rid]},
                    res)
    mgr._finalize_tentative(res)
    c = res.counts()
    assert c["done"] + c["failed"] + c["rerouted"] == res.scheduled
    return _state(mgr, res)


def sc_round_robin_and_quarantine(P, seed):
    mgr = _manager(P, 3, policy="round_robin")
    reqs = _reqs(P, 7)
    res = _res(P, reqs)
    for r in reqs[:3]:
        mgr._dispatch(r, res)
    mgr._quarantine(mgr.handles["1"], res)
    for r in reqs[3:]:
        mgr._dispatch(r, res)
    return _state(mgr, res)


def sc_shed_releases_lease_and_books_terminal(P, seed):
    mgr = _manager(P, 2)
    reqs = _reqs(P, 2)
    res = _res(P, reqs)
    for r in reqs:
        mgr._dispatch(r, res)
    h = _victim(mgr)
    rid = sorted(h.leases.held())[0]
    mgr._handle(h.id, {"op": "shed", "rid": rid, "reason": "burn"}, res)
    assert res.shed[rid] == "burn" and h.breaker.failures == 0
    return _state(mgr, res)


# -- elastic scenarios -----------------------------------------------------


def sc_scale_out_is_warm_up_masked(P, seed, tmp_path):
    mgr = _manager(P, 1, reserve=1)
    mgr.work_dir = str(tmp_path / P.name)
    res = _res(P, [])
    mgr._scale_out(1.0, res)
    assert mgr.router.live() == {"0"}  # not routable before ready
    mgr._handle("1", {"ready": True, "pid": 1}, res)
    st = _state(mgr, res)
    st["sent"] = {k: [m["op"] for m in v] for k, v in st["sent"].items()}
    return st


def sc_scale_out_fault_aborts_attempt(P, seed, tmp_path):
    P.faults.configure("fleet.scale_out:error:count=1")
    mgr = _manager(P, 1, reserve=1)
    mgr.work_dir = str(tmp_path / P.name)
    res = _res(P, [])
    mgr._scale_out(1.0, res)
    assert mgr._spare == [1] and "1" not in mgr.handles
    mgr._scale_out(3.0, res)
    st = _state(mgr, res)
    st["sent"] = {k: [m["op"] for m in v] for k, v in st["sent"].items()}
    return st


def sc_spawn_failure_keeps_slice_reserved(P, seed, tmp_path):
    P.faults.configure("replica.spawn:error:count=99")
    mgr = _manager(P, 1, reserve=1)
    mgr.work_dir = str(tmp_path / P.name)
    res = _res(P, [])
    mgr._scale_out(1.0, res)
    return _state(mgr, res)


def sc_scale_in_drains_coldest(P, seed):
    mgr = _manager(P, 2, reserve=0, out_occupancy=1.25)
    reqs = _reqs(P, 3)
    res = _res(P, reqs)
    mgr._scale_in(5.0, res)  # a tie: the higher id retires first
    mgr2 = _manager(P, 2, reserve=0, out_occupancy=1.25)
    for r in reqs:
        mgr2.handles["1"].leases.acquire(r.rid, r)
    res2 = _res(P, reqs)
    mgr2._scale_in(5.0, res2)  # fewest leases retires
    return [_state(mgr, res), _state(mgr2, res2)]


def sc_scale_in_fault_aborts(P, seed):
    P.faults.configure("fleet.scale_in:error:count=1")
    mgr = _manager(P, 2, reserve=0, out_occupancy=1.25)
    res = _res(P, [])
    mgr._scale_in(5.0, res)
    return _state(mgr, res)


def sc_elastic_tick_out_then_in(P, seed, tmp_path):
    mgr = _manager(P, 1, reserve=1, slots=2)
    mgr.work_dir = str(tmp_path / P.name)
    reqs = _reqs(P, 5)  # 5 leases / (1 live x 2 slots) = 2.5 > 1.25
    res = _res(P, reqs)
    for r in reqs:
        mgr._dispatch(r, res)
    mgr._elastic_tick(1.0, res)
    mgr._handle("1", {"ready": True, "pid": 1}, res)
    for r in reqs:
        h = next(h for h in mgr.handles.values() if r.rid in h.leases)
        mgr._handle(h.id, {"op": "done", "rid": r.rid, "ids": [1]}, res)
    mgr._elastic_tick(2.0, res)  # idle now: under the low water
    st = _state(mgr, res)
    st["sent"] = {k: [m["op"] for m in v] for k, v in st["sent"].items()}
    st["decisions"] = [(e["action"], e.get("target"))
                       for e in mgr.decisions.events]
    return st


# -- obs scenarios ----------------------------------------------------------


class _FakeEngine:
    """Just enough engine surface for _StdinSource.report()."""

    def __init__(self, replica="1"):
        self.done, self.failed, self.shed = {}, {}, {}
        self.stats = {"steps": 0, "tokens": 0}
        self.replica = replica
        self.queue, self.active = [], []
        self.first_ns, self.handoffs, self.adopt_queue = {}, {}, []


def _source(P, shipper):
    sent = []
    src = P.replica._StdinSource(iter([]), _FakeEngine(), sent.append,
                                 shipper=shipper)
    src._last_hb_ns = 0
    return src, sent


def sc_report_ships_bounded_batches_after_control_traffic(P, seed):
    shipper = P.fleet.ObsShipper(max_batch=4)
    for i in range(10):
        P.obs.event("spam", i=i)
    src, sent = _source(P, shipper)
    src.report()
    batch = next(m for m in sent if m["op"] == "obs")
    first = ([m["op"] for m in sent], len(batch["entries"]),
             batch["backlog"], sorted(batch["clock"]))
    src.ship_tail()
    total = sum(len(m["entries"]) for m in sent if m["op"] == "obs")
    return first, total


def sc_obs_ship_fault_suppresses_the_batch(P, seed):
    P.faults.configure("replica.obs_ship:error:count=1")
    shipper = P.fleet.ObsShipper()
    P.obs.event("something")
    src, sent = _source(P, shipper)
    src.report()
    first = [m["op"] for m in sent]
    src._last_hb_ns = 0
    src.report()
    batch = next(m for m in sent if m["op"] == "obs")
    return first, [e.get("name") for e in batch["entries"]
                   if e.get("name") == "something"], P.rt.metric_total(
        "tpu_patterns_faults_injected_total", site="replica.obs_ship")


def sc_obs_message_absorbs_into_fleet_series_and_disk(P, seed, tmp_path):
    base = tmp_path / P.name / "fleet"
    mgr = _manager(P, 2, obs_base=str(base))
    res = _res(P, [])
    for value in (3.0, 5.0):
        mgr._handle("1", {
            "op": "obs",
            "entries": [{"kind": "span", "name": "req.queued", "t0_ns": 5,
                         "dur_ns": 2, "tid": 9, "span_id": 1,
                         "attrs": {"rid": 0}}],
            "metrics": [{"metric": "tpu_patterns_serve_requests_total",
                         "type": "counter", "labels": {}, "value": value}],
            "clock": {"wall_ts": 100.0, "clock_ns": 50},
        }, res)
    mgr.fleet_obs.close()
    lines = [json.loads(ln) for ln in
             (base / "replica-1" / "shipped.jsonl").read_text().splitlines()]
    return (P.rt.metric_total("tpu_patterns_fleet_serve_requests_total",
                              replica="1"),
            mgr.fleet_obs.total("tpu_patterns_serve_requests_total"),
            [ln.get("kind") for ln in lines])


def sc_dispatch_stamps_journey_and_reroute_keeps_it(P, seed):
    mgr = _manager(P, 2)
    req = _reqs(P, 1)[0]
    res = _res(P, [req])
    mgr._dispatch(req, res)
    mgr._replica_down(_victim(mgr), "test", res)
    anchors = [(e["name"], e["attrs"].get("replica"),
                e["attrs"]["jid"] == req.jid)
               for e in P.obs.flight_recorder().snapshot()
               if e["name"].startswith("journey.")]
    sent = [m["jid"] == req.jid for h in mgr.handles.values()
            for m in h.proc.stdin.sent if m.get("op") == "req"]
    return anchors, sent, req.jid.startswith("j")


def sc_obs_stall_watchdog_warns_once(P, seed, tmp_path):
    mgr = _manager(P, 2)
    mgr.obs_watchdog_s = 1.0
    res = _res(P, [])
    h = mgr.handles["1"]
    h.leases.acquire(0, meta=None)
    now = P.replica.clock_ns()
    h.last_msg_ns = now
    h.last_obs_ns = now - int(10e9)
    mgr._check_watchdogs(res)
    mgr._check_watchdogs(res)
    rec = json.loads(
        (tmp_path / P.name / "watchdog.jsonl").read_text().splitlines()[-1])
    return (h.obs_stalled, h.state, mgr.obs_stalls, rec["mode"],
            rec["verdict"], P.rt.metric_total(
                "tpu_patterns_replica_obs_stalls_total", replica="1"))


def sc_mirrors_reconcile_against_shipped_truth(P, seed):
    mgr = _manager(P, 2)
    res = _res(P, [])
    mgr._handle("0", {"op": "obs", "entries": [], "metrics": [
        {"metric": "tpu_patterns_replica_drains_total", "type": "counter",
         "labels": {"replica": "0", "mode": "checkpoint"}, "value": 1.0},
    ]}, res)
    mgr._handle("0", {"op": "checkpointed", "step": 3}, res)
    mgr._handle("1", {"op": "checkpointed", "step": 3}, res)
    notes = mgr.fleet_obs.reconcile()
    # a replica that shipped but whose ledger never saw its checkpoint
    mgr2 = _manager(P, 2)
    mgr2._handle("0", {"op": "obs", "entries": [], "metrics": []}, res)
    mgr2._handle("0", {"op": "checkpointed", "step": 3}, res)
    return (notes, mgr.fleet_obs.total("tpu_patterns_replica_drains_total",
                                       mode="checkpoint"),
            mgr2.fleet_obs.reconcile())


SCENARIOS = [
    (sc_quarantine_releases_every_lease, range(4)),
    (sc_survivors_checkpoint_on_death, [0]),
    (sc_drained_handback_reroutes_pending, [0]),
    (sc_consecutive_failures_open_breaker_and_drain, [0]),
    (sc_single_failure_on_healthy_replica_finalizes, [0]),
    (sc_reroute_budget_is_one, [0]),
    (sc_spawn_site_retries_then_succeeds, [0]),
    (sc_spawn_deterministic_failure_quarantines, [0]),
    (sc_drain_site_error_reads_as_unresponsive, [0]),
    (sc_counts_identity_closes, [0]),
    (sc_round_robin_and_quarantine, [0]),
    (sc_shed_releases_lease_and_books_terminal, [0]),
    (sc_scale_out_is_warm_up_masked, [0]),
    (sc_scale_out_fault_aborts_attempt, [0]),
    (sc_spawn_failure_keeps_slice_reserved, [0]),
    (sc_scale_in_drains_coldest, [0]),
    (sc_scale_in_fault_aborts, [0]),
    (sc_elastic_tick_out_then_in, [0]),
    (sc_report_ships_bounded_batches_after_control_traffic, [0]),
    (sc_obs_ship_fault_suppresses_the_batch, [0]),
    (sc_obs_message_absorbs_into_fleet_series_and_disk, [0]),
    (sc_dispatch_stamps_journey_and_reroute_keeps_it, [0]),
    (sc_obs_stall_watchdog_warns_once, [0]),
    (sc_mirrors_reconcile_against_shipped_truth, [0]),
]


@pytest.mark.parametrize("scenario,seed", [
    pytest.param(fn, seed, id=f"{fn.__name__[3:]}-{seed}")
    for fn, seeds in SCENARIOS for seed in seeds
])
def test_manager_settles_as_the_reference(scenario, seed, tmp_path,
                                          monkeypatch):
    for P in (REF, PORT):
        # ReplicaHandle.kill group-SIGKILLs proc.pid: lethal on a fake
        monkeypatch.setattr(P.proc + ".kill_process_group", lambda p: None)
        monkeypatch.setattr(P.proc + ".popen_in_group",
                            lambda *a, **k: _FakeProc())
    kw = ({"tmp_path": tmp_path}
          if "tmp_path" in scenario.__code__.co_varnames else {})
    want = scenario(REF, seed, **kw)
    got = scenario(PORT, seed, **kw)
    assert got == want


def test_result_accessors_match():
    def accessors(P):
        res = P.replica.FleetResult(scheduled=3)
        res.done[0] = [1, 2]
        res.failed[1] = "x"
        assert not res.covered()
        res.shed[2] = "burn"
        res.rerouted.add(0)
        res.scale_events += [(1.0, "out", "2"), (2.0, "in", "2"),
                             (3.0, "out", "2")]
        res.replica_stats = {"0": {"prefix_hit_blocks": 3,
                                   "leaked_blocks": 0,
                                   "fresh_full_blocks_by_rid": {"0": 2,
                                                                "1": 5}}}
        return (res.covered(), res.counts(), res.scale_outs(),
                res.scale_ins(), res.prefix_hit_blocks(),
                res.rerouted_fresh_blocks(), res.tokens())

    assert accessors(PORT) == accessors(REF)


# -- the real fleet: two CPU replica processes ----------------------------

MODEL = dict(vocab=64, embed=32, heads=4, head_dim=8, depth=2, seed=3,
             requests=8, min_prompt=4, max_prompt=16, gen=5, slots=4,
             block_len=8, min_replica_speedup=0.0, device="cpu")


def _fleet(tmp_path, tag, obs_base=None, **kw):
    """Serve the plan's trace through 2 CPU replica processes (one rank
    each); returns (cfg, plan, FleetResult)."""
    from tpu_patterns_torch.comm.mesh import model_mesh
    from tpu_patterns_torch.serve.engine import ServeConfig

    cfg = ServeConfig(**{**MODEL, **kw}, replicas=2)
    plan = treplica.fleet_plan(cfg, model_mesh(2, device="cpu"))
    mgr = treplica.make_manager(plan, cfg, 2, "prefix",
                                str(tmp_path / tag), obs_base)
    try:
        mgr.spawn_all()
        res = mgr.serve(plan.timed)
    finally:
        mgr.shutdown()
    return cfg, plan, res


def _reference_ids(cfg, requests):
    """The JAX package's per-request dense decode of the port's weights
    (``init_lm_params(seed)`` handed across as numpy)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tpu_patterns.models.transformer import ModelConfig as JModel
    from tpu_patterns.serve.engine import ServeConfig as JServeConfig
    from tpu_patterns.serve.engine import _dense_expected
    from tpu_patterns_torch.convert import params_to_numpy
    from tpu_patterns_torch.models.lm import init_lm_params
    from tpu_patterns_torch.serve.engine import model_config

    mcfg = model_config(cfg)
    params = init_lm_params(cfg.seed, mcfg, cfg.vocab, "cpu")
    flat = {k: jnp.asarray(v)
            for k, v in params_to_numpy(params, mcfg).items()}
    jcfg = JModel(embed=cfg.embed, heads=cfg.heads, head_dim=cfg.head_dim,
                  mlp_mult=cfg.mlp_mult, causal=True, dtype=cfg.dtype,
                  depth=cfg.depth, kv_heads=cfg.kv_heads, rope=cfg.rope)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))
    jserve = JServeConfig(
        **{f.name: getattr(cfg, f.name)
           for f in dataclasses.fields(JServeConfig)
           if hasattr(cfg, f.name) and f.name != "device"}
    )
    reqs = [JRequest(rid=r.rid, tokens=list(r.tokens), n_gen=r.n_gen)
            for r in requests]
    return _dense_expected(mesh, 1, jcfg, jserve, flat, reqs)


def test_two_cpu_replicas_serve_the_reference_ids(tmp_path):
    obs_dir = str(tmp_path / "obs")
    cfg, plan, res = _fleet(tmp_path, "plain", obs_base=obs_dir)
    assert res.covered() and not res.failed and not res.rerouted
    c = res.counts()
    assert c["done"] + c["failed"] + c["rerouted"] + c["shed"] == \
        res.scheduled == 8
    assert res.leaked_blocks() == 0
    assert set(res.replica_stats) == {"0", "1"}
    # both replicas served (the prefix ring spreads random prompts)
    assert all(s["done"] > 0 for s in res.replica_stats.values())
    assert res.shipped_done == 8.0 and not res.mirror_mismatches
    want = _reference_ids(cfg, [r for _, r in plan.timed])
    assert res.done == want
    # the merged fleet timeline: one journey a request, routed by the
    # parent and retired on the replica that served it
    tobs.dump(os.path.join(obs_dir, "spans.jsonl"))
    merged, procs = tfleet.merge_fleet(obs_dir)
    assert set(procs) == {0, 1, tfleet.ROUTER_PID}
    js = tfleet.journeys(merged)
    assert sorted(int(tfleet.resolve_journey(merged, str(r)) is not None)
                  for r in res.done) == [1] * 8
    assert len(js) == 8
    for anchors in js.values():
        names = [a["name"] for a in anchors]
        assert names[0] == "journey.route" and "req.retired" in names


def test_killed_replica_reroutes_and_stays_exact(tmp_path, monkeypatch):
    """``serve.step:kill`` with a shared fault-state dir reaches exactly
    one child; the parent settles its leases from its own ledger and
    reroutes them to the survivor, whose ids stay exact.  With the fleet
    prefix store, the rerouted requests prefill strictly fewer fresh
    blocks."""
    from tpu_patterns_torch.comm.mesh import model_mesh
    from tpu_patterns_torch.serve.engine import ServeConfig

    # the reference's validated recipe (scripts/prefix_store_smoke.py)
    kw = dict(prefix_share=True, kv_host_tier=True, embed=64, heads=8,
              depth=1, max_prompt=16, gen=6, seed=0)
    # both replicas step here (the prompts with a second full block route
    # apart), so the kill names the busy arc owner: its 5th decode step,
    # after its first publish waves, whichever child steps first
    plan = treplica.fleet_plan(ServeConfig(**{**MODEL, **kw}, replicas=2),
                               model_mesh(2, device="cpu"))
    ring = TRouter(["0", "1"], block_len=8)
    owners = [ring.route(r.rid, r.tokens) for _, r in plan.timed]
    busy = max(set(owners), key=owners.count)
    fresh = {}
    for leg in ("base", "store"):
        monkeypatch.setenv("TPU_PATTERNS_FAULTS",
                           f"serve.step:kill:after=4:count=1:replica={busy}")
        monkeypatch.setenv("TPU_PATTERNS_FAULTS_STATE",
                           str(tmp_path / f"{leg}-state"))
        if leg == "store":
            kw["prefix_store"] = str(tmp_path / "store")
        cfg, plan, res = _fleet(tmp_path, leg, **kw)
        monkeypatch.delenv("TPU_PATTERNS_FAULTS")
        assert res.rerouted, leg
        assert res.covered() and not res.failed and res.leaked_blocks() == 0
        # the dead child never reported
        assert set(res.replica_stats) == {"01"[busy == "0"]}
        want = _reference_ids(cfg, [r for _, r in plan.timed])
        assert res.done == want, leg
        fresh[leg] = res.rerouted_fresh_blocks()
        if leg == "store":
            assert res.store_hits() > 0
    assert fresh["store"] < fresh["base"]


def test_a_cuda_child_without_a_card_fails_its_spawn(tmp_path):
    """Nothing falls back to the CPU: a child asked for CUDA on a host
    without a card answers ``ready: false`` and the spawn fails."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    mgr = treplica.ReplicaManager(
        1, base_env=dict(os.environ), work_dir=str(tmp_path),
        child_cfg={"block_len": 8, "slots": 2, "device": "cuda"},
        device_slices=[["cuda:0"]], sp=1, tp=1,
    )
    try:
        with pytest.raises(treplica.ReplicaError, match="no CUDA device"):
            mgr.spawn_all()
    finally:
        mgr.shutdown()
