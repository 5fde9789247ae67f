"""The port's doctor (``tpu_patterns_torch/core/doctor.py``) held against
the JAX package's (``tpu_patterns/core/doctor.py``): with the probes
stubbed identically, the same Record mode, checks and verdict; the same
episode log over the same polls; a hung probe killed within its
deadline; a box with no card reported down, never probed on the CPU in
its place; and ``--workers`` refused."""

import contextlib
import io
import json

import pytest

from tpu_patterns.core import doctor as ref_doctor
from tpu_patterns.core import results as ref_results
from tpu_patterns_torch import cli
from tpu_patterns_torch.core import doctor
from tpu_patterns_torch.core import results

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

# what each probe layer's child prints, by scenario (the stub's answers)
HEALTHY = {
    "backend_init": {"ok": True, "platform": "gpu",
                     "device_kind": "NVIDIA H100 80GB HBM3",
                     "device_count": 1, "init_s": 0.41, "elapsed_s": 2.1},
    "tiny_op": {"ok": True, "compile_s": 0.05, "warm_3x_ms": 0.12,
                "elapsed_s": 1.9},
    "deep_compute": {"ok": True, "deep_s": 0.03, "checksum_ok": True,
                     "elapsed_s": 2.4},
}
SCENARIOS = {
    "healthy": HEALTHY,
    "backend_hang": {**HEALTHY, "backend_init": {
        "ok": False, "error": "hang (killed after 60s)", "elapsed_s": 60.0}},
    "tiny_crash": {**HEALTHY, "tiny_op": {
        "ok": False, "error": "rc=1: RuntimeError: boom", "elapsed_s": 1.0}},
    "deep_garbage": {**HEALTHY, "deep_compute": {
        "ok": True, "deep_s": 0.03, "checksum_ok": False, "elapsed_s": 2.0}},
    "deep_unparseable": {**HEALTHY, "deep_compute": {
        "ok": False, "error": "no parseable probe output"}},
}
ORDER = ("backend_init", "tiny_op", "deep_compute")


def _stub(answers):
    calls = []

    def probe(script, timeout):
        name = ORDER[len(calls)]
        calls.append((name, timeout))
        return dict(answers[name])

    return probe, calls


def _run(mod, res_mod, obs_mod, cfg, answers, monkeypatch, tmp_path,
         native_ok=(True, True)):
    probe, calls = _stub(answers)
    monkeypatch.setattr(mod, "_probe", probe)
    if mod is doctor:
        from tpu_patterns_torch.interop import native
        from tpu_patterns_torch.io import loader
    else:
        from tpu_patterns.interop import native
        from tpu_patterns.io import loader
    monkeypatch.setattr(native, "available", lambda: native_ok[0])
    monkeypatch.setattr(native, "build_error", lambda: "no g++")
    monkeypatch.setattr(loader, "native_available", lambda: native_ok[1])
    monkeypatch.setattr(loader, "build_error", lambda: "no g++")
    obs_mod.configure(str(tmp_path))
    try:
        out = io.StringIO()
        (rec,) = mod.run_doctor(cfg, res_mod.ResultWriter(stream=out))
    finally:
        obs_mod.configure(None)
    return rec, calls, out.getvalue()


@pytest.mark.parametrize("deep", [True, False])
@pytest.mark.parametrize("native_ok", [(True, True), (False, True)])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_run_doctor_matches_reference(scenario, native_ok, deep,
                                      monkeypatch, tmp_path):
    from tpu_patterns import obs as ref_obs
    from tpu_patterns_torch import obs

    answers = SCENARIOS[scenario]
    got, got_calls, got_out = _run(
        doctor, results, obs, doctor.DoctorConfig(deep=deep, device="cpu"),
        answers, monkeypatch, tmp_path / "p", native_ok)
    want, want_calls, want_out = _run(
        ref_doctor, ref_results, ref_obs, ref_doctor.DoctorConfig(deep=deep),
        answers, monkeypatch, tmp_path / "r", native_ok)
    assert got_calls == want_calls
    assert got.pattern == want.pattern == "doctor"
    assert got.mode == want.mode
    assert got.commands == want.commands
    assert got.metrics == want.metrics
    assert got.verdict.value == want.verdict.value
    assert got.notes == want.notes
    assert got_out == want_out


def _fixed_record(res_mod, verdict, failing=()):
    metrics = {f"{n}_ok": 0.0 if n in failing else 1.0
               for n in ("backend_init", "tiny_op", "native_ffi")}
    return res_mod.Record(
        pattern="doctor", mode="cpu", commands="probe_timeout=60s deep=True",
        metrics=metrics, verdict=res_mod.Verdict[verdict], timestamp=0.0,
        run={"run_id": "r"}, env={},
    )


POLLS = (
    ("FAILURE", ("backend_init",)),
    ("FAILURE", ("backend_init",)),
    ("FAILURE", ("backend_init", "tiny_op")),
    ("SUCCESS", ()),
    ("SUCCESS", ()),
    ("FAILURE", ("native_ffi",)),
)


def test_watch_polls_write_the_reference_episode_log(monkeypatch, tmp_path):
    logs, actions = {}, {}
    for who, mod, res_mod in (("ref", ref_doctor, ref_results),
                              ("port", doctor, results)):
        clock = iter(range(1000, 2000, 7))
        monkeypatch.setattr(mod, "wall_time_s", lambda: float(next(clock)))
        path = tmp_path / who / "watch.jsonl"
        actions[who] = [
            mod.record_watch_poll(str(path),
                                  _fixed_record(res_mod, v, failing))
            for v, failing in POLLS
        ]
        logs[who] = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert actions["port"] == actions["ref"] == [
        "opened", "extended", "opened", "closed", "recorded", "opened"]
    assert logs["port"] == logs["ref"]
    assert doctor._failure_signature(_fixed_record(
        results, "FAILURE", ("tiny_op", "backend_init"))) == \
        "backend_init,tiny_op"


def test_a_sleeping_probe_is_killed_within_its_deadline():
    out = doctor._probe("import time; time.sleep(3600)", timeout=2)
    assert not out["ok"]
    assert "hang" in out["error"]
    assert out["elapsed_s"] < 2 + 5


def test_probe_classifies_crashes_and_garbage():
    out = doctor._probe("raise RuntimeError('boom')", timeout=30)
    assert not out["ok"] and "rc=1" in out["error"] and "boom" in out["error"]
    out = doctor._probe("print('not json')", timeout=30)
    assert out == {"ok": False, "error": "no parseable probe output"}
    out = doctor._probe("print('chatter'); print('{\"x\": 1}')", timeout=30)
    assert out["ok"] and out["x"] == 1


def test_no_card_reports_down_and_never_probes_the_cpu(monkeypatch,
                                                       tmp_path):
    """The probes run in children that see no CUDA device here: the
    backend layer fails, the rest are skipped, the verdict is FAILURE."""
    from tpu_patterns_torch import obs

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    obs.configure(str(tmp_path))
    try:
        (rec,) = doctor.run_doctor(doctor.DoctorConfig(deep=False),
                                   results.ResultWriter(stream=io.StringIO()))
    finally:
        obs.configure(None)
    assert rec.verdict is results.Verdict.FAILURE
    assert rec.mode == "down"
    assert rec.metrics["backend_init_ok"] == 0.0
    assert rec.metrics["tiny_op_ok"] == 0.0
    assert rec.notes[0].startswith("backend_init: rc=")
    assert "no CUDA device" in rec.notes[0]
    assert rec.notes[1] == "tiny_op: skipped: backend_init failed"


def test_cpu_probes_run_for_real(tmp_path):
    """The tiny-op probe script itself, on the CPU the tests name (the
    init script runs in the no-card test)."""
    script = doctor._PROBE_TINY.replace("@DEVICE@", repr("cpu"))
    out = doctor._probe(script, timeout=60)
    assert out["ok"] and out["compile_s"] >= 0 and out["warm_3x_ms"] >= 0


def test_workers_are_refused(capsys):
    with pytest.raises(ValueError, match="Queue 1 step 10"):
        doctor.run_doctor(doctor.DoctorConfig(workers=True, device="cpu"),
                          results.ResultWriter(stream=io.StringIO()))
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        cli.main(["doctor", "--workers", "true", "--device", "cpu"])


def test_recent_hang_dumps_warn_and_stale_ones_do_not(monkeypatch,
                                                      tmp_path):
    """The watchdog layer counts hang dumps under the port's obs dir: a
    recent one turns a healthy report into WARNING, one older than the
    window does not."""
    import os

    from tpu_patterns_torch import obs

    probe, _ = _stub(HEALTHY)
    monkeypatch.setattr(doctor, "_probe", probe)
    obs.configure(str(tmp_path))
    try:
        dump = tmp_path / "hang_serve.step_outer_1.jsonl"
        dump.write_text("{}\n")
        (rec,) = doctor.run_doctor(
            doctor.DoctorConfig(device="cpu", deep=False),
            results.ResultWriter(stream=io.StringIO()))
        assert rec.verdict is results.Verdict.WARNING
        assert rec.metrics["watchdog_recent_dumps"] == 1.0
        assert rec.notes == [f"watchdog hang dump: {dump}"]
        os.utime(dump, (1, 1))  # 1970: outside the hour's window
        probe, _ = _stub(HEALTHY)
        monkeypatch.setattr(doctor, "_probe", probe)
        (rec,) = doctor.run_doctor(
            doctor.DoctorConfig(device="cpu", deep=False),
            results.ResultWriter(stream=io.StringIO()))
        assert rec.verdict is results.Verdict.SUCCESS
        assert rec.metrics["watchdog_recent_dumps"] == 0.0
    finally:
        obs.configure(None)
