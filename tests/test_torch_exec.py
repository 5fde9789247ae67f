"""The port's executor (``tpu_patterns_torch/exec/``) against the JAX
package's (``tpu_patterns/exec/``).

Every cell of every suite classifies as the reference's does, with
``"cuda"`` where the reference reads ``"tpu"``; the platform is found
without a CUDA context; the scheduler keeps spec order, drains device
cells serially and banks the engine Record with the reference's keys
(and ``parent_cuda_context``); a timeout kills the cell's whole process
group; and a warm worker on the CPU (``TPU_PATTERNS_DEVICE=cpu``) serves
two cells, is recycled after a nonzero rc, and trips the pool's breaker
when it cannot get ready (the ``worker.ready`` fault site).
"""

import importlib
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from tpu_patterns import exec as jx
from tpu_patterns import sweep as js
from tpu_patterns_torch import exec as tx
from tpu_patterns_torch import sweep as ts
from tpu_patterns_torch.sweep import SweepSpec

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

SUITES = sorted(js.SUITES)
# the modules (the packages re-export a function of the same name)
tclassify = importlib.import_module("tpu_patterns_torch.exec.classify")
jclassify = importlib.import_module("tpu_patterns.exec.classify")


def _cpu_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPU_PATTERNS_")}
    env["TPU_PATTERNS_DEVICE"] = "cpu"
    env.update(extra)
    return env


def test_exports_are_the_references():
    names = {"CellClass", "classify", "detect_platform", "kill_process_group",
             "run_command", "CellResult", "default_jobs", "run_cells",
             "WorkerPool"}
    assert all(hasattr(tx, n) and hasattr(jx, n) for n in names)
    assert [c.value for c in tx.CellClass] == [c.value for c in jx.CellClass]
    assert tx.default_jobs() == jx.default_jobs()
    assert tclassify.BACKEND_FREE_COMMANDS == (
        jclassify.BACKEND_FREE_COMMANDS)


@pytest.mark.parametrize("quick", (False, True))
@pytest.mark.parametrize("suite", SUITES)
def test_classify_every_cell_as_the_reference(suite, quick):
    """The reference at ``"cpu"`` and ``"tpu"`` against the port at
    ``"cpu"`` and ``"cuda"``: the same class for every cell."""
    for want, got in zip(js.specs_for(suite, quick),
                         ts.specs_for(suite, quick)):
        for jp, tp in (("cpu", "cpu"), ("tpu", "cuda")):
            assert (tx.classify(got, tp).value
                    == jx.classify(want, jp).value), (got.name, tp)
        if suite != "runtime":
            assert tx.classify(got, "cuda") is (
                tx.CellClass.DEVICE_EXCLUSIVE)


@pytest.mark.parametrize("key,cls", [
    ("CUDA_LAUNCH_BLOCKING", "env_isolated"),
    ("PYTORCH_NO_CUDA_MEMORY_CACHING", "env_isolated"),
    ("TORCH_ALLOW_TF32_CUBLAS_OVERRIDE", "env_isolated"),
    ("NCCL_DEBUG", "env_isolated"),
    ("TPU_PATTERNS_DEVICE", "env_isolated"),
    ("TPU_PATTERNS_SWEEP_CONFIG", "device_exclusive"),
    ("TPU_PATTERNS_TIMING", "device_exclusive"),
])
def test_backend_keys_force_isolation(key, cls):
    spec = SweepSpec("c", ("concurrency",), env=((key, "1"),))
    assert tx.classify(spec, "cuda").value == cls
    assert tx.classify(SweepSpec("r", ("report", "x")), "cuda") is (
        tx.CellClass.HOST_PARALLEL)


def test_detect_platform_without_a_cuda_context(monkeypatch):
    assert tx.detect_platform({"TPU_PATTERNS_DEVICE": "cuda"}) == "cuda"
    assert tx.detect_platform({"TPU_PATTERNS_DEVICE": "CPU"}) == "cpu"
    assert tx.detect_platform({"TPU_PATTERNS_DEVICE": "cuda:1"}) == "cuda"
    monkeypatch.setattr(tclassify.glob, "glob", lambda pat: [])
    assert tx.detect_platform({"PATH": "/nonexistent"}) == "cpu"
    monkeypatch.setattr(tclassify.glob, "glob",
                        lambda pat: ["/dev/nvidia0"])
    assert tx.detect_platform({"PATH": "/nonexistent"}) == "cuda"
    assert not torch.cuda.is_initialized()


class TestProcessGroupKill:
    def test_timeout_kills_grandchild(self, tmp_path):
        # the child forks a grandchild that outlives it unless the whole
        # group is killed (a kernel build's nvcc under ninja)
        pidfile = tmp_path / "grandchild.pid"
        script = (
            "import subprocess, sys, time\n"
            "p = subprocess.Popen([sys.executable, '-c', "
            "'import time; time.sleep(60)'])\n"
            f"open({str(pidfile)!r}, 'w').write(str(p.pid))\n"
            "print('started', flush=True)\n"
            "time.sleep(60)\n"
        )
        t0 = time.perf_counter()
        out, rc, timed_out = tx.run_command([sys.executable, "-c", script],
                                            timeout=3)
        assert timed_out and rc == 1 and "started" in out
        assert time.perf_counter() - t0 < 30
        pid = int(pidfile.read_text())
        for _ in range(50):
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                break
            time.sleep(0.1)
        else:
            os.kill(pid, 9)
            pytest.fail("grandchild survived the group kill")

    def test_clean_exit_passes_through(self):
        out, rc, timed_out = tx.run_command(
            [sys.executable, "-c", "import sys; print('x'); "
             "sys.stderr.write('e'); sys.exit(3)"], timeout=60)
        assert (rc, timed_out) == (3, False)
        assert "x" in out and "e" in out


class TestScheduler:
    @staticmethod
    def _stub_specs(n_host=6, n_dev=2):
        host = [SweepSpec(f"h{i}", ("topo",)) for i in range(n_host)]
        dev = [SweepSpec(f"d{i}", ("p2p",)) for i in range(n_dev)]
        return host + dev

    def test_results_in_spec_order_and_engine_record(self, tmp_path):
        specs = self._stub_specs()
        seen, lock = [], threading.Lock()

        def runner(spec):
            with lock:
                seen.append(spec.name)
            time.sleep(0.05)
            return 0, True

        results, rec = tx.run_cells(
            specs, str(tmp_path), jobs=4, warm_workers=False,
            cell_timeout=30, platform="cpu", subprocess_runner=runner,
            progress=lambda s: None)
        _, ref = jx.run_cells(
            [js.SweepSpec(s.name, s.argv) for s in specs],
            str(tmp_path / "ref"), jobs=4, warm_workers=False,
            cell_timeout=30, platform="cpu",
            subprocess_runner=lambda s: (0, True), progress=lambda s: None)
        assert [r.spec.name for r in results] == [s.name for s in specs]
        assert sorted(seen) == sorted(s.name for s in specs)
        assert all(r.completed and r.rc == 0 for r in results)
        assert (rec.pattern, rec.mode) == (ref.pattern, ref.mode)
        assert rec.commands == ref.commands
        assert set(rec.metrics) == set(ref.metrics) | {"parent_cuda_context"}
        assert rec.metrics["parent_cuda_context"] == 0.0
        assert rec.metrics["speedup"] > 1.0 and rec.verdict.value == "SUCCESS"

    def test_device_exclusive_cells_never_overlap_on_cuda(self, tmp_path):
        specs = ([SweepSpec(f"h{i}", ("report", "x.log")) for i in range(4)]
                 + [SweepSpec(f"d{i}", ("p2p",)) for i in range(4)])
        active, peak, lock = [], [0], threading.Lock()

        def runner(spec):
            dev = spec.name.startswith("d")
            with lock:
                if dev:
                    active.append(spec.name)
                    peak[0] = max(peak[0], len(active))
            time.sleep(0.05)
            with lock:
                if dev:
                    active.remove(spec.name)
            return 0, True

        _, rec = tx.run_cells(
            specs, str(tmp_path), jobs=4, warm_workers=True,
            cell_timeout=30, platform="cuda", subprocess_runner=runner,
            progress=lambda s: None)
        assert peak[0] == 1
        assert rec.metrics["device_exclusive_cells"] == 4
        assert rec.metrics["host_parallel_cells"] == 4
        assert "worker_cells" not in rec.metrics  # no warm pool on a card

    def test_env_isolated_fans_out_off_the_card_only(self, tmp_path):
        specs = [SweepSpec(f"e{i}", ("concurrency",),
                           env=(("CUDA_LAUNCH_BLOCKING", str(i)),))
                 for i in range(4)]
        active, peak, lock = [], [0], threading.Lock()

        def runner(spec):
            with lock:
                active.append(spec.name)
                peak[0] = max(peak[0], len(active))
            time.sleep(0.05)
            with lock:
                active.remove(spec.name)
            return 0, True

        results, rec = tx.run_cells(
            specs, str(tmp_path), jobs=4, warm_workers=True,
            cell_timeout=30, platform="cpu", subprocess_runner=runner,
            progress=lambda s: None)
        assert peak[0] > 1
        assert all(r.runner == "subprocess" for r in results)
        assert rec.metrics["env_isolated_cells"] == 4
        peak[0] = 0
        tx.run_cells(specs, str(tmp_path), jobs=4, warm_workers=False,
                     cell_timeout=30, platform="cuda",
                     subprocess_runner=runner, progress=lambda s: None)
        assert peak[0] == 1

    def test_failures_propagate_and_retry(self, tmp_path, monkeypatch):
        monkeypatch.setenv("TPU_PATTERNS_CELL_ATTEMPTS", "2")
        tries = {}

        def runner(spec):
            tries[spec.name] = tries.get(spec.name, 0) + 1
            if spec.name == "h0":
                return 1, True  # a completed FAILURE: never retried
            if spec.name == "h1":
                return (41, False) if tries["h1"] == 1 else (0, True)
            return 7, False  # the same crash twice: quarantined

        results, rec = tx.run_cells(
            self._stub_specs(n_host=3, n_dev=0), str(tmp_path), jobs=2,
            warm_workers=False, cell_timeout=30, platform="cpu",
            subprocess_runner=runner, progress=lambda s: None)
        got = {r.spec.name: (r.rc, r.completed, r.attempts, r.quarantined)
               for r in results}
        assert got == {"h0": (1, True, 1, False), "h1": (0, True, 2, False),
                       "h2": (7, False, 2, True)}
        assert rec.metrics["cell_retries"] == 2.0
        assert rec.metrics["cells_quarantined"] == 1.0

    def test_one_host_cell_is_skipped(self, tmp_path):
        _, rec = tx.run_cells(
            [SweepSpec("h0", ("topo",))], str(tmp_path), jobs=4,
            warm_workers=False, cell_timeout=30, platform="cpu",
            subprocess_runner=lambda s: (0, True), progress=lambda s: None)
        assert rec.verdict.value == "SKIPPED"
        assert "nothing to overlap" in rec.notes[0]


class TestRunSweepJobs:
    NAMES = ["p2p.compact.mesh.two_sided.n2",
             "p2p.compact.visible.two_sided.n2",
             "p2p.spread.mesh.two_sided.n2"]

    def test_engine_checkpoints_and_banks_its_record(self, tmp_path,
                                                     monkeypatch, capsys):
        monkeypatch.setattr(
            ts, "run_spec",
            lambda spec, out, base_env=None, timeout=None: (0, True))
        rc = ts.run_sweep("p2p", out_dir=str(tmp_path), quick=True,
                          names=self.NAMES, base_env={
                              "TPU_PATTERNS_DEVICE": "cpu"},
                          jobs=3, warm_workers=False)
        assert rc == 0
        state = ts.load_sweep_state(str(tmp_path))
        assert all(state[n]["completed"] for n in self.NAMES)
        (rec,) = [json.loads(ln) for ln in open(tmp_path /
                                                "sweep-engine.jsonl")]
        assert rec["mode"] == "engine"
        assert rec["metrics"]["host_parallel_cells"] == 3
        out = capsys.readouterr().out
        assert "# sweep cell: p2p.compact.mesh.two_sided.n2 [host_parallel]" \
            in out and "## engine |" in out

    def test_engine_resume_skips_completed_and_aggregates_failure(
            self, tmp_path, monkeypatch):
        calls = []

        def run_spec(spec, out, base_env=None, timeout=None):
            calls.append(spec.name)
            return 1, True

        monkeypatch.setattr(ts, "run_spec", run_spec)
        kw = dict(out_dir=str(tmp_path), quick=True, names=self.NAMES[:1],
                  base_env={}, jobs=2, warm_workers=False)
        assert ts.run_sweep("p2p", **kw) == 1
        assert ts.run_sweep("p2p", resume=True, **kw) == 1
        assert calls == self.NAMES[:1]


class TestWarmWorkers:
    @pytest.fixture(scope="class")
    def pool(self, tmp_path_factory):
        from tpu_patterns_torch.exec.workers import WorkerPool

        pool = WorkerPool(1, _cpu_env(),
                          log_dir=str(tmp_path_factory.mktemp("workers")))
        yield pool
        pool.shutdown()

    def test_worker_serves_two_cells_then_is_recycled_on_failure(
            self, pool, tmp_path):
        w = pool.lease()
        assert w is not None and w.ready
        for i in range(2):  # the second cell reuses the warm runtime
            log = tmp_path / f"cell{i}.log"
            resp = w.request({
                "op": "cell", "cell": f"cell{i}", "argv": ["topo"],
                "env": {"TPU_PATTERNS_SWEEP_CONFIG": "t"}, "log": str(log),
                "jsonl": str(tmp_path / f"cell{i}.jsonl")}, timeout=120)
            assert resp["rc"] == 0 and resp["served"] == i + 1
            assert "devices: 1 (cpu)" in log.read_text()
        assert w.request({"op": "ping"}, timeout=60) == {
            "op": "ping", "rc": 0, "served": 2}
        pool.release(w, reusable=True)
        assert pool.lease() is w and pool.hits == 1
        bad = tmp_path / "bad.log"
        resp = w.request({
            "op": "cell", "cell": "bad",
            "argv": ["allreduce", "--algorithm", "ringg"], "env": {},
            "log": str(bad), "jsonl": str(tmp_path / "bad.jsonl")},
            timeout=120)
        assert resp["rc"] == 2 and "invalid choice" in bad.read_text()
        assert w.alive()  # a cell's failure does not kill the server
        pool.release(w, reusable=False)  # ...but a nonzero rc recycles it
        assert pool.recycled == 1 and not w.alive()

    def test_scheduler_worker_path_end_to_end(self, tmp_path):
        specs = [SweepSpec("t0", ("topo",),
                           env=(("TPU_PATTERNS_SWEEP_CONFIG", "a"),)),
                 SweepSpec("t1", ("topo",),
                           env=(("TPU_PATTERNS_SWEEP_CONFIG", "b"),))]
        results, rec = tx.run_cells(
            specs, str(tmp_path), jobs=2, warm_workers=True,
            cell_timeout=240, base_env=_cpu_env(), progress=lambda s: None)
        assert [(r.rc, r.completed, r.runner) for r in results] == [
            (0, True, "worker")] * 2
        text = (tmp_path / "t0.log").read_text()
        assert text.startswith("export TPU_PATTERNS_SWEEP_CONFIG=a\n")
        assert "devices: 1 (cpu)" in text
        assert rec.metrics["worker_cells"] == 2
        assert rec.commands == "jobs=2 platform=cpu cells=2"

    def test_worker_that_never_gets_ready_opens_the_breaker(self, tmp_path):
        """``worker.ready:crash`` kills every spawn before its handshake:
        two failures open the breaker, and later leases return at once
        (the cells would fall back to subprocesses)."""
        from tpu_patterns_torch.exec.workers import WorkerPool

        pool = WorkerPool(1, _cpu_env(TPU_PATTERNS_FAULTS=
                                      "worker.ready:crash:count=99"),
                          log_dir=str(tmp_path), breaker_cooldown_s=600)
        try:
            assert pool.lease() is None and pool.lease() is None
            assert pool.breaker.opened
            t0 = time.perf_counter()
            assert pool.lease() is None
            assert time.perf_counter() - t0 < 0.5
            assert pool.stats()["worker_spawns"] == 2.0
        finally:
            pool.shutdown()


def test_worker_mode_is_dispatched_before_the_cli():
    """``python -m tpu_patterns_torch`` under the worker flag speaks the
    protocol on stdout and nothing else."""
    from tpu_patterns_torch.exec.worker import ENV_FLAG

    proc = subprocess.run(
        [sys.executable, "-m", "tpu_patterns_torch"],
        input=json.dumps({"op": "ping"}) + "\n" + json.dumps(
            {"op": "shutdown"}) + "\n",
        env=_cpu_env(**{ENV_FLAG: "1"}), capture_output=True, text=True,
        timeout=120)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert proc.returncode == 0
    assert lines[0]["ready"] and lines[0]["platform"] == "cpu"
    assert lines[1] == {"op": "ping", "rc": 0, "served": 0}
