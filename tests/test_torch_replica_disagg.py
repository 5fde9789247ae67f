"""The port's disaggregated replica fleet (``serve/replica.py``'s roles,
handoff plane and disagg A/B Record) against the JAX package's.

The parent's handoff plane runs against FAKE replica processes, in the
reference's own ``tests/test_replica.py`` style (its
``TestDisaggHandoffPlane``): each scenario drives both packages'
``ReplicaManager`` through the same dispatches, handoffs, first-token
ops and deaths, and the two must settle the same leases, reroutes,
verdicts, messages, decisions and counters.  The child's side (the
``first``/``handoff`` report order and the ``adopt`` op) runs against a
fake engine.  Then the real thing at a small size: ``serve --replicas 2
--disagg 1:1`` over two CPU replica processes, whose Record has the
reference's mode and metric keys and reads SUCCESS with a real
transfer, and whose split fleet's ids equal the reference's dense decode
of the same weights."""

import io

import pytest
import torch

from test_torch_replica import (
    MODEL,
    PORT,
    REF,
    _FakeEngine,
    _FakeProc,
    _manager,
    _reference_ids,
    _reqs,
    _res,
    _state,
)
from tpu_patterns_torch.core.results import ResultWriter
from tpu_patterns_torch.serve import replica as treplica

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)


def _disagg_manager(P, n=3, n_pre=1):
    """A fake-process fleet with replicas 0..n_pre-1 prefill and the rest
    decode: the ring carries only the prefill pool, as the constructor
    builds it."""
    mgr = _manager(P, n)
    mgr.roles = {str(r): "prefill" if r < n_pre else "decode"
                 for r in range(n)}
    mgr.router = P.Router([str(r) for r in range(n_pre)], block_len=8)
    return mgr


def _manifest(rid, blocks=2, nbytes=2048, recompute=False):
    return {
        "rid": rid, "jid": f"j{rid}", "prompt": [1] * 9, "n_gen": 4,
        "scenario": "", "deadline_ms": 0.0, "priority": "bulk",
        "temperature": 0.0, "top_k": 0, "top_p": 1.0, "seed": 0,
        "gen_offset": 0, "tok0": 5, "t_submit_ns": 0, "t_first_ns": 0,
        "path": "" if recompute else f"/spool/kv-{rid}.npz",
        "blocks": 0 if recompute else blocks,
        "nbytes": 0 if recompute else nbytes,
        "recompute": recompute,
    }


DISAGG_SERIES = ("tpu_patterns_disagg_transfers_total",
                 "tpu_patterns_disagg_adopted_blocks_total",
                 "tpu_patterns_disagg_transfer_bytes_total")


def _disagg_state(P, mgr, res) -> dict:
    st = _state(mgr, res)
    st["handoff_rids"] = sorted(res.handoff_rids)
    st["first"] = sorted(res.t_first_ns)
    st["series"] = [P.rt.metric_total(m) for m in DISAGG_SERIES]
    st["decisions"] = [(e["action"], e.get("rid"),
                        {k: v for k, v in e["inputs"].items()})
                       for e in mgr.decisions.events]
    st["journey"] = [(e["name"], e["attrs"].get("src"),
                      e["attrs"].get("replica"))
                     for e in P.obs.flight_recorder().snapshot()
                     if e["name"] == "journey.handoff"]
    return st


def sc_roles_validation(P, tmp_path):
    kw = dict(base_env={}, work_dir=str(tmp_path), child_cfg={
        "block_len": 8}, device_slices=[[0], [1]], sp=1, tp=1)
    out = []
    for roles, extra in (({"0": "prefill", "1": "prefill"}, {}),
                         ({"0": "prefill"}, {}),
                         ({"0": "prefill", "1": "router"}, {}),
                         ({"0": "prefill", "1": "decode"},
                          {"elastic": P.elastic.ElasticConfig(reserve=1)})):
        with pytest.raises(ValueError) as e:
            P.replica.ReplicaManager(2, roles=roles, **kw, **extra)
        out.append(str(e.value))
    mgr = P.replica.ReplicaManager(3, roles={"0": "decode", "1": "prefill",
                                             "2": "prefill"}, **{
        **kw, "device_slices": [[0], [1], [2]]})
    out.append(sorted(mgr.router.live()))
    return out


def sc_handoff_moves_lease_round_robin_and_books(P):
    mgr = _disagg_manager(P, 3)
    reqs = _reqs(P, 3)
    res = _res(P, reqs)
    for r in reqs:
        mgr._dispatch(r, res)
    assert set(mgr.handles["0"].leases.held()) == {0, 1, 2}
    for rid in (0, 1, 2):
        mgr._handle("0", {"op": "handoff", "rid": rid,
                          "m": _manifest(rid)}, res)
    assert len(mgr.handles["0"].leases) == 0
    assert set(mgr.handles["1"].leases.held()) == {0, 2}
    return _disagg_state(P, mgr, res)


def sc_recompute_handoff_counts_transfer_only(P):
    mgr = _disagg_manager(P, 2)
    reqs = _reqs(P, 1)
    res = _res(P, reqs)
    mgr._dispatch(reqs[0], res)
    mgr._handle("0", {"op": "handoff", "rid": 0,
                      "m": _manifest(0, recompute=True)}, res)
    return _disagg_state(P, mgr, res)


def sc_no_live_decode_fails_loudly(P):
    mgr = _disagg_manager(P, 2)
    reqs = _reqs(P, 1)
    res = _res(P, reqs)
    mgr._dispatch(reqs[0], res)
    mgr.handles["1"].state = "dead"
    mgr._handle("0", {"op": "handoff", "rid": 0, "m": _manifest(0)}, res)
    assert "decode" in res.failed[0] and res.covered()
    return _disagg_state(P, mgr, res)


def sc_first_op_stamps_parent_clock_once(P):
    mgr = _disagg_manager(P, 2)
    res = _res(P, _reqs(P, 1))
    mgr._handle("0", {"op": "first", "rid": 0}, res)
    stamp = res.t_first_ns[0]
    # a re-prefilled first token later must not move the front door's
    mgr._handle("1", {"op": "first", "rid": 0}, res)
    assert stamp > 0 and res.t_first_ns[0] == stamp
    return _disagg_state(P, mgr, res)


def sc_decode_death_mid_adopt_reroutes_via_prefill_ring(P):
    mgr = _disagg_manager(P, 2)
    reqs = _reqs(P, 1)
    res = _res(P, reqs)
    mgr._dispatch(reqs[0], res)
    mgr._handle("0", {"op": "handoff", "rid": 0, "m": _manifest(0)}, res)
    assert set(mgr.handles["1"].leases.held()) == {0}
    mgr._replica_down(mgr.handles["1"], "test kill", res)
    assert 0 in res.rerouted
    assert set(mgr.handles["0"].leases.held()) == {0}
    return _disagg_state(P, mgr, res)


def sc_adopter_dies_at_the_send(P):
    mgr = _disagg_manager(P, 3)
    reqs = _reqs(P, 2)
    res = _res(P, reqs)
    for r in reqs:
        mgr._dispatch(r, res)
    mgr.handles["1"].proc.stdin.broken = True
    mgr._handle("0", {"op": "handoff", "rid": 0, "m": _manifest(0)}, res)
    assert mgr.handles["1"].state == "dead" and 0 in res.rerouted
    # the survivor decode replica takes the next handoff
    mgr._handle("0", {"op": "handoff", "rid": 1, "m": _manifest(1)}, res)
    return _disagg_state(P, mgr, res)


def sc_killed_prefill_reroutes_through_the_prefill_ring(P):
    mgr = _disagg_manager(P, 3, n_pre=2)
    reqs = _reqs(P, 6)
    res = _res(P, reqs)
    for r in reqs:
        mgr._dispatch(r, res)
    victim = next(h for h in mgr.handles.values() if len(h.leases))
    held = set(victim.leases.held())
    mgr._replica_down(victim, "chaos (h)", res)
    assert held <= res.rerouted
    assert not mgr.handles["2"].leases.held()  # decode takes no admission
    return _disagg_state(P, mgr, res)


def sc_child_reports_first_then_handoff_then_done(P):
    sent = []
    eng = _FakeEngine()
    src = P.replica._StdinSource(iter([]), eng, sent.append)
    src._last_hb_ns = 0
    eng.first_ns = {3: 1, 4: 2}
    eng.handoffs = {3: _manifest(3)}
    eng.done = {4: [9]}
    src.report()
    src.report()  # each op once
    return [(m["op"], m.get("rid")) for m in sent if m["op"] != "hb"]


def sc_adopt_op_queues_and_holds_the_loop_open(P):
    lines = iter(['{"op": "adopt", "m": {"rid": 7, "blocks": 1}}\n',
                  '{"op": "fin"}\n'])
    eng = _FakeEngine()
    src = P.replica._StdinSource(lines, eng, lambda m: None)
    for _ in range(200):  # the reader thread feeds the queue
        src(idle=True)
        if eng.adopt_queue and src.fin:
            break
    open_with_queue = src()  # fin seen, but an adoption is queued
    eng.adopt_queue.clear()
    return (eng.adopt_queue, open_with_queue, src(), src.fin)


SCENARIOS = [
    sc_roles_validation,
    sc_handoff_moves_lease_round_robin_and_books,
    sc_recompute_handoff_counts_transfer_only,
    sc_no_live_decode_fails_loudly,
    sc_first_op_stamps_parent_clock_once,
    sc_decode_death_mid_adopt_reroutes_via_prefill_ring,
    sc_adopter_dies_at_the_send,
    sc_killed_prefill_reroutes_through_the_prefill_ring,
    sc_child_reports_first_then_handoff_then_done,
    sc_adopt_op_queues_and_holds_the_loop_open,
]


@pytest.mark.parametrize("scenario", [
    pytest.param(fn, id=fn.__name__[3:]) for fn in SCENARIOS])
def test_handoff_plane_settles_as_the_reference(scenario, tmp_path,
                                                monkeypatch):
    for P in (REF, PORT):
        # ReplicaHandle.kill group-SIGKILLs proc.pid: lethal on a fake
        monkeypatch.setattr(P.proc + ".kill_process_group", lambda p: None)
        monkeypatch.setattr(P.proc + ".popen_in_group",
                            lambda *a, **k: _FakeProc())
    kw = ({"tmp_path": tmp_path}
          if "tmp_path" in scenario.__code__.co_varnames else {})
    want = scenario(REF, **kw)
    got = scenario(PORT, **kw)
    assert got == want


def test_result_disagg_accessors_match():
    def accessors(P):
        res = P.replica.FleetResult(scheduled=2)
        res.replica_stats = {
            "0": {"handoffs": 3, "transfer_bytes": 4096,
                  "handoff_recomputes": 1},
            "1": {"adopts": 2, "adopted_blocks": 5, "adopt_recomputes": 1}}
        return (res.handoffs(), res.adopts(), res.adopted_blocks(),
                res.transfer_bytes(), res.disagg_recomputes(),
                res.t_first_ns, res.handoff_rids)

    assert accessors(PORT) == accessors(REF)


# -- the real fleet: --disagg 1:1 over two CPU replica processes -------------

# the reference's disagg Record metrics (tpu_patterns/serve/replica.py,
# run_replicas' disagg branch)
REFERENCE_KEYS = {
    "requests", "ttft_p99_ms_disagg", "ttft_p99_ms_unified",
    "ttft_improvement", "transfers", "adopts", "adopted_blocks",
    "transfer_bytes", "recomputes", "done_disagg", "done_unified",
    "failed", "rerouted", "exact", "covered", "leaked_blocks",
}


def test_disagg_fleet_record_and_reference_ids(tmp_path, monkeypatch):
    from tpu_patterns_torch.comm.mesh import model_mesh
    from tpu_patterns_torch.serve.engine import ServeConfig

    served = []
    serve = treplica.ReplicaManager.serve

    def keep(self, timed):
        res = serve(self, timed)
        served.append((dict(self.roles), res))
        return res

    monkeypatch.setattr(treplica.ReplicaManager, "serve", keep)
    cfg = ServeConfig(**MODEL, replicas=2, disagg="1:1",
                      replica_dir=str(tmp_path / "work"))
    (rec,) = treplica.run_replicas(cfg, ResultWriter(stream=io.StringIO()),
                                   mesh=model_mesh(2, device="cpu"))
    m = rec.metrics
    assert rec.mode == "disagg_trace_p1d1_sp1"
    assert set(m) == REFERENCE_KEYS
    assert rec.verdict.value == "SUCCESS", rec.notes
    assert m["transfers"] >= 1 and m["adopts"] == m["transfers"]
    assert m["exact"] == 1.0 and m["covered"] == 1.0
    assert m["leaked_blocks"] == 0 and m["recomputes"] == 0
    assert m["transfer_bytes"] > 0 and m["ttft_p99_ms_disagg"] > 0
    (roles_d, res_d), (roles_u, res_u) = served
    assert roles_d == {"0": "prefill", "1": "decode"} and roles_u == {}
    # the prefill replica handed off, the decode replica adopted
    assert res_d.replica_stats["0"]["handoffs"] == m["transfers"]
    assert res_d.replica_stats["1"]["adopts"] == m["adopts"]
    assert res_d.handoff_rids and set(res_d.t_first_ns) == set(res_d.done)
    want = _reference_ids(cfg, [res_d.requests_by_rid[r]
                                for r in sorted(res_d.requests_by_rid)])
    assert res_d.done == want and res_u.done == want
    # every spool file was adopted and unlinked, none left half-written
    assert not list((tmp_path / "work" / "disagg" / "spool").iterdir())


@pytest.mark.parametrize("argv,match", [
    (["--replicas", "2", "--disagg", "1-1"], "P:D"),
    (["--replicas", "2", "--disagg", "0:2"], "at least one prefill"),
    (["--replicas", "3", "--disagg", "1:1"], "must equal --replicas 3"),
    (["--replicas", "2", "--disagg", "1:1", "--elastic_reserve", "1",
      "--scenario", "chat"], "mutually exclusive"),
    (["--replicas", "2", "--disagg", "1:1", "--kv_host_tier", "true",
      "--prefix_store", "st"], "prefix_store"),
    (["--disagg", "1:1"], "needs --replicas N"),
])
def test_cli_checks_disagg_as_the_reference(argv, match, capsys):
    """Each refused ``--disagg`` combination exits before a replica
    spawns, in both packages, the port's message naming what the
    reference's names."""
    from tpu_patterns import cli as jcli
    from tpu_patterns_torch import cli as tcli

    with pytest.raises(SystemExit) as want:
        jcli.main(["serve", *argv])
    with pytest.raises(SystemExit) as got:
        tcli.main(["serve", "--device", "cpu", *argv])
    assert want.value.code not in (0, None)
    assert got.value.code not in (0, None)
    assert match in str(got.value.code)
