"""The port's sweep (``tpu_patterns_torch/sweep.py``) against the JAX
package's (``tpu_patterns/sweep.py``).

Every suite's cells, quick and full, carry the reference's names, its env
and its argv after the documented translation (``sweep.translate_argv``:
the attention back-ends' words, the quick shapes' head_dim and the
ranks a cell's mesh axes need), and
every cell parses under the port's CLI.  The ``runtime`` suite keeps the
reference's targets with the CUDA and PyTorch runtime's knobs.  The
state file, resume, the readers of a finished run (``summarize_sweep``,
``fit_gates``, the promotions, ``check_runtime_bite``) give what the
reference gives on the same files, and one tiny cell runs end to end on
the CPU (``TPU_PATTERNS_DEVICE=cpu``), once healed after a crash at the
``cell.run`` fault site.
"""

import contextlib
import io
import json
import os

import pytest

from tpu_patterns import sweep as js
from tpu_patterns.core import results as jr
from tpu_patterns_torch import cli
from tpu_patterns_torch import sweep as ts
from tpu_patterns_torch.core import results as tr

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

SUITES = sorted(js.SUITES)
TIERS = (False, True)
# the quick tier's cheapest real cell: no model, one rank on the CPU
TINY = "hier.dcn2.float32"


def _cpu_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPU_PATTERNS_")}
    env["TPU_PATTERNS_DEVICE"] = "cpu"
    env.update(extra)
    return env


def test_suites_and_helpers_are_the_references():
    assert sorted(ts.SUITES) == SUITES
    assert ts.FIRST_PASS_SUFFIX == js.FIRST_PASS_SUFFIX
    assert ts.DEFAULT_CELL_TIMEOUT == js.DEFAULT_CELL_TIMEOUT
    assert ts.CONCURRENCY_ENV_CONFIGS == js.CONCURRENCY_ENV_CONFIGS
    assert ts._SUMMARY_METRICS == js._SUMMARY_METRICS
    assert ts._FLASH_LEVER_CELLS == js._FLASH_LEVER_CELLS
    assert ts._FLASH_BASE_CELL == js._FLASH_BASE_CELL


@pytest.mark.parametrize("quick", TIERS)
@pytest.mark.parametrize("suite", [s for s in SUITES if s != "runtime"])
def test_spec_tables_match_reference(suite, quick):
    want = js.specs_for(suite, quick)
    got = ts.specs_for(suite, quick)
    assert [s.name for s in got] == [s.name for s in want]
    for g, w in zip(got, want):
        assert g.argv == ts.translate_argv(w.argv), g.name
        assert g.env == w.env, g.name


def _runtime_target(name: str) -> str:
    return name.split(".", 2)[2]  # runtime.<config>.<target>


@pytest.mark.parametrize("quick", TIERS)
def test_runtime_suite_keeps_targets_with_cuda_knobs(quick):
    """The reference's targets and argv, one table a config; the knobs
    are the CUDA driver's and PyTorch's, each config named for what it
    toggles, and the JAX package's libtpu/JAX knobs appear nowhere."""
    want = js.specs_for("runtime", quick)
    got = ts.specs_for("runtime", quick)
    argv_of = {_runtime_target(s.name): ts.translate_argv(s.argv)
               for s in want}
    assert {_runtime_target(s.name) for s in got} == set(argv_of)
    for s in got:
        assert s.argv == argv_of[_runtime_target(s.name)], s.name
        cfg = s.name.split(".")[1]
        env = dict(s.env)
        assert env.pop("TPU_PATTERNS_SWEEP_CONFIG") == f"runtime.{cfg}"
        assert env == ts.RUNTIME_ENV_CONFIGS[cfg][0]
        assert all(k.startswith(("CUDA_", "PYTORCH_", "TORCH_"))
                   for k in env)
    knobs = {k for env, _ in ts.RUNTIME_ENV_CONFIGS.values() for k in env}
    assert knobs == {"CUDA_LAUNCH_BLOCKING", "CUDA_DEVICE_MAX_CONNECTIONS",
                     "PYTORCH_NO_CUDA_MEMORY_CACHING", "CUDA_MODULE_LOADING",
                     "TORCH_ALLOW_TF32_CUBLAS_OVERRIDE"}
    assert ts.RUNTIME_ENV_CONFIGS["default"] == js.RUNTIME_ENV_CONFIGS[
        "default"]


def _parses(parser, argv) -> str:
    """'' when ``argv`` parses, else argparse's last complaint."""
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            parser.parse_args(list(argv))
    except SystemExit:
        return err.getvalue().strip().splitlines()[-1]
    return ""


@pytest.mark.parametrize("quick", TIERS)
@pytest.mark.parametrize("suite", SUITES)
def test_every_port_cell_parses(suite, quick):
    parser = cli.build_parser()
    bad = {s.name: _parses(parser, s.argv)
           for s in ts.specs_for(suite, quick)}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_cells_the_port_parser_refuses_are_translated():
    """57 of the reference's 399 cells do not parse as they stand (the
    attention back-ends' words); each of them is one the translation
    rewrites, and after it every one parses."""
    parser = cli.build_parser()
    refused = [s for q in TIERS for s in js.specs_for("all", q)
               if _parses(parser, s.argv)]
    assert len(refused) == 57
    for s in refused:
        assert ts.translate_argv(s.argv) != s.argv
        assert not _parses(parser, ts.translate_argv(s.argv)), s.name


@pytest.mark.parametrize("argv,want", [
    (("flagship", "--attn", "xla"), ("flagship", "--attn", "dense")),
    (("flagship", "--attn", "pallas", "--seq", "8"),
     ("flagship", "--attn", "kernel", "--seq", "8")),
    (("serve", "--paged_attn", "pallas"), ("serve", "--paged_attn",
                                           "kernel")),
    (("serve", "--embed", "64", "--head_dim", "8"),
     ("serve", "--embed", "512", "--head_dim", "64")),
    (("longctx", "--head_dim", "32"), ("longctx", "--head_dim", "64")),
    (("longctx", "--head_dim", "128"), ("longctx", "--head_dim", "128")),
    (("p2p", "--attn"), ("p2p", "--attn")),
    (("decode", "--tp", "2"), ("decode", "--tp", "2", "--devices", "2")),
    (("lm", "--devices", "8", "--dp", "2", "--tp", "2"),
     ("lm", "--devices", "8", "--dp", "2", "--tp", "2")),
])
def test_translate_argv(argv, want):
    assert ts.translate_argv(argv) == want


def test_cell_names_unique_in_each_tier():
    for quick in TIERS:
        names = [s.name for s in ts.specs_for("all", quick)]
        assert len(names) == len(set(names))


# -- the state file ---------------------------------------------------------


def _stub_run_spec(monkeypatch, results):
    """run_spec answering ``(rc, completed)`` pairs in turn; the calls
    land in the returned list."""
    calls, it = [], iter(results)

    def run_spec(spec, out, base_env=None, timeout=None):
        calls.append(spec.name)
        return next(it)

    monkeypatch.setattr(ts, "run_spec", run_spec)
    monkeypatch.setenv("TPU_PATTERNS_CELL_ATTEMPTS", "2")
    return calls


def test_state_shared_across_suite_args_with_retries(tmp_path, monkeypatch,
                                                     capsys):
    """'sweep all' and 'sweep p2p' share one history: the failure the
    per-suite run records is what 'all --resume' sees.  The counterpart
    of the JAX package's ``test_sweep_state_shared_across_suite_args``
    (``tests/test_cli.py:922``), whose stub returns ``completed=False``
    twice and runs dry under the cell retries its sweep makes; here the
    stub answers every attempt the retry policy takes."""
    name = "p2p.compact.mesh.two_sided.n2"
    # 'all': attempt 1 crashes, attempt 2 passes
    calls = _stub_run_spec(monkeypatch, [(1, False), (0, True)])
    ts.run_sweep("all", out_dir=str(tmp_path), quick=True, names=[name])
    assert calls == [name, name]
    assert ts.load_sweep_state(str(tmp_path))[name]["completed"]
    # 'p2p': a deterministic crash, the same rc twice -> quarantined
    calls = _stub_run_spec(monkeypatch, [(3, False), (3, False)])
    ts.run_sweep("p2p", out_dir=str(tmp_path), quick=True, names=[name])
    st = ts.load_sweep_state(str(tmp_path))[name]
    assert st["rc"] == 3 and not st["completed"]
    assert "QUARANTINED" in capsys.readouterr().out
    # 'all --resume' sees the newest (crashed) state and re-runs the cell
    calls = _stub_run_spec(monkeypatch, [(0, True)])
    ts.run_sweep("all", out_dir=str(tmp_path), quick=True, names=[name],
                 resume=True)
    assert calls == [name]


def test_resume_skips_completed_failure_and_keeps_its_rc(tmp_path,
                                                         monkeypatch):
    name = "p2p.compact.mesh.two_sided.n2"
    calls = _stub_run_spec(monkeypatch, [(1, True)])
    assert ts.run_sweep("p2p", out_dir=str(tmp_path), quick=True,
                        names=[name]) == 1
    calls = _stub_run_spec(monkeypatch, [])
    assert ts.run_sweep("p2p", out_dir=str(tmp_path), quick=True,
                        names=[name], resume=True) == 1
    assert calls == []


def test_resume_reruns_on_a_workload_or_device_change(tmp_path, monkeypatch):
    """A quick pass never satisfies a full-size resume, nor a pass under
    ``TPU_PATTERNS_DEVICE=cpu`` a resume on the card."""
    name = "p2p.compact.mesh.two_sided.n2"
    calls = _stub_run_spec(monkeypatch, [(0, True)] * 4)
    monkeypatch.setenv("TPU_PATTERNS_DEVICE", "cpu")
    ts.run_sweep("p2p", out_dir=str(tmp_path), quick=True, names=[name])
    ts.run_sweep("p2p", out_dir=str(tmp_path), quick=False, names=[name],
                 resume=True)
    assert calls == [name, name]
    ts.run_sweep("p2p", out_dir=str(tmp_path), quick=False, names=[name],
                 resume=True)
    assert calls == [name, name]
    monkeypatch.delenv("TPU_PATTERNS_DEVICE")
    ts.run_sweep("p2p", out_dir=str(tmp_path), quick=False, names=[name],
                 resume=True)
    assert calls == [name, name, name]


def test_forget_only_the_selected_cells(tmp_path, monkeypatch):
    name = "p2p.compact.mesh.two_sided.n2"
    (tmp_path / "sweep-state.jsonl").write_text(json.dumps(
        {"cell": "p2p.other.cell", "rc": 0, "sig": "y", "completed": True})
        + "\n")
    _stub_run_spec(monkeypatch, [(0, True)])
    ts.run_sweep("p2p", out_dir=str(tmp_path), quick=True, names=[name])
    st = ts.load_sweep_state(str(tmp_path), "p2p")
    assert st["p2p.other.cell"] == {"rc": 0, "sig": "y", "completed": True}
    assert st[name]["rc"] == 0


def test_legacy_state_migrates_as_the_reference(tmp_path):
    """Per-suite legacy files fold into the unified file keeping the
    newest record a cell, in both packages alike."""
    recs = {
        "all.sweep-state.jsonl": [
            {"cell": "a", "rc": 0, "sig": "s", "ts": 100.0},
            {"cell": "b", "rc": 1, "sig": "s", "ts": 300.0}],
        "p2p.sweep-state.jsonl": [
            {"cell": "a", "rc": 1, "sig": "s", "ts": 200.0},
            {"cell": "b", "rc": 0, "sig": "s", "ts": "bad"}],
        "sweep-state.jsonl": [{"cell": "c", "rc": 0, "sig": "t",
                               "ts": 50.0}],
    }
    got = {}
    for pkg in (js, ts):
        d = tmp_path / pkg.__name__
        d.mkdir()
        for fname, lines in recs.items():
            (d / fname).write_text(
                "".join(json.dumps(r) + "\n" for r in lines) + "{torn\n")
        pkg._migrate_legacy_state(str(d))
        assert sorted(os.listdir(d)) == ["sweep-state.jsonl"]
        got[pkg] = pkg.load_sweep_state(str(d))
    assert got[ts] == got[js]
    assert got[ts]["a"]["rc"] == 1 and got[ts]["b"]["rc"] == 1


def test_state_signatures_never_cross_packages(tmp_path, monkeypatch):
    """The port's signature leads with its package, so a state file of
    either package's sweep never satisfies the other's resume or
    ``suite_complete``."""
    spec_j = js.specs_for("hier", quick=True)[0]
    spec_t = ts.specs_for("hier", quick=True)[0]
    assert spec_j.argv == spec_t.argv and spec_j.env == spec_t.env
    env = {"TPU_PATTERNS_DEVICE": "cpu", "PATH": "/bin"}
    sig_t = ts._spec_sig(spec_t, env)
    assert json.loads(sig_t)[0] == "tpu_patterns_torch"
    assert sig_t != js._spec_sig(spec_j, env)
    # the port's ambient keys: the framework tier, CUDA's and torch's
    assert json.loads(ts._spec_sig(spec_t, {
        "CUDA_LAUNCH_BLOCKING": "1", "HOME": "/h", "TORCH_X": "1"}))[3] == [
        ["CUDA_LAUNCH_BLOCKING", "1"], ["TORCH_X", "1"]]
    for pkg, other in ((js, ts), (ts, js)):
        d = tmp_path / pkg.__name__
        d.mkdir()
        for s in pkg.specs_for("hier", quick=True):
            pkg._record_cell(str(d), "hier", s.name, 0, pkg._spec_sig(s),
                             True)
        assert pkg.suite_complete(str(d), "hier", quick=True)
        assert not other.suite_complete(str(d), "hier", quick=True)


def test_concurrent_record_cell_is_lossless(tmp_path):
    import threading

    def write(t):
        for i in range(50):
            ts._record_cell(str(tmp_path), "x", f"c{t}.{i}", 0, "s", True)

    threads = [threading.Thread(target=write, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(ts.load_sweep_state(str(tmp_path))) == 200


@pytest.mark.parametrize("rc,timed_out,out,records,want", [
    (0, False, "", False, True),
    (1, False, "", True, True),  # an honest FAILURE verdict
    (1, False, "Traceback (most recent call last)", True, False),
    (1, False, "", False, False),  # nothing banked
    (-9, False, "", True, False),  # a signal kill
    (0, True, "", True, False),  # a timeout
])
def test_cell_completed_as_the_reference(tmp_path, rc, timed_out, out,
                                         records, want):
    path = tmp_path / "c.jsonl"
    if records:
        path.write_text("{}\n")
    got = ts.cell_completed(rc, timed_out, out, str(path))
    assert got == js.cell_completed(rc, timed_out, out, str(path)) == want


# -- the readers of a finished run -----------------------------------------


def _write_cells(d, pkg_results, cells):
    """One Record a cell in ``pkg_results``'s class, tagged as the sweep
    tags it (a ``.fp`` name is a first-pass twin)."""
    for name, kw in cells:
        kw = {"timestamp": 1.9e9, **kw}
        kw["verdict"] = pkg_results.Verdict(kw.get("verdict", "SUCCESS"))
        env = {"TPU_PATTERNS_SWEEP_CONFIG": name.removesuffix(".fp")}
        if name.endswith(".fp"):
            env["TPU_PATTERNS_SWEEP_TIER"] = "first_pass"
        rec = pkg_results.Record(env=env, **kw)
        with open(os.path.join(d, f"{name}.jsonl"), "a") as f:
            f.write(rec.to_json() + "\n")


SUMMARY_CELLS = [
    ("measured.onesided_hbm", dict(
        pattern="onesided", mode="local_put", commands="x",
        metrics={"bandwidth_GBps": 1466.5, "hbm_plausible": 1.0})),
    ("measured.concurrency.xla.concurrent.C_C", dict(
        pattern="concurrency", mode="xla:concurrent", commands="C C",
        metrics={"speedup": 1.9, "timing_converged": 0.0},
        verdict="FAILURE")),
    ("measured.decode_kv_cache.fp", dict(
        pattern="decode", mode="decode", commands="x",
        metrics={"ms_per_token": 3.0, "tokens_per_s": 2000.0})),
    ("measured.decode_kv_cache", dict(
        pattern="decode", mode="decode", commands="x",
        metrics={"ms_per_token": 2.5, "tokens_per_s": 2400.0})),
    ("measured.lm_vocab_parallel.fp", dict(
        pattern="lm", mode="lm", commands="steps=5",
        metrics={"train_steps_per_s": 40.0})),
    ("serve.continuous", dict(
        pattern="serve", mode="slots4", commands="x",
        metrics={"tokens_per_s": 900.0, "exact": 1.0})),
    ("asymptote.multi.size262KB", dict(
        pattern="onesided", mode="local_put", commands="x",
        metrics={"bandwidth_GBps": 99999.0, "bytes_per_put": 262144.0})),
    ("measured.flash_bf16_grad", dict(
        pattern="longctx", mode="flash_grad", commands="x",
        metrics={"tflops": 189.7}, timestamp=1.0)),
]


def _table_rows(md: str) -> list[str]:
    return [ln for ln in md.splitlines() if ln.startswith("| ")]


def test_summarize_sweep_rows_equal_the_references(tmp_path):
    """The same records give the same per-suite tables (refined rows
    shadow their first-pass twins, stale grad records refused, quick-tier
    names shown); the port adds no TPU plateau and assumes no peak."""
    out = {}
    for pkg, res in ((js, jr), (ts, tr)):
        d = tmp_path / pkg.__name__
        d.mkdir()
        _write_cells(str(d), res, SUMMARY_CELLS)
        out[pkg] = pkg.summarize_sweep(str(d))
    j_md, t_md = out[js], out[ts]
    assert _table_rows(t_md) == _table_rows(j_md)
    heads = [ln for ln in t_md.splitlines() if ln.startswith("## ")]
    assert heads == [ln for ln in j_md.splitlines() if ln.startswith("## ")]
    assert "| measured.decode_kv_cache | decode | tokens_per_s | 2400 |" in t_md
    assert "2000" not in t_md  # the fp twin shadowed
    assert "SUCCESS (first_pass)" in t_md  # the unshadowed lm twin
    assert "FAILURE [NOISE-BOUND]" in t_md
    assert "189.7" not in t_md and "refused 1 grad record" in t_md
    assert "r4" not in t_md and "TPU" not in t_md
    empty = tmp_path / "empty"
    empty.mkdir()
    assert "no cell records" in ts.summarize_sweep(str(empty))


def test_summarize_mfu_reads_the_cards_peak(tmp_path):
    """The flagship MFU table is scored against the dense bf16 peak of
    the card the records name, and assumes none when they name no card
    of the spec table."""
    cmds = "dp1 sp1 tp1 B2 L4096 E1024 bfloat16"
    _write_cells(str(tmp_path), tr, [
        ("measured.flagship_pallas", dict(
            pattern="flagship", mode="kernel", commands=cmds,
            metrics={"tflops": 494.5},
            config={"device_kind": "NVIDIA H100 80GB HBM3"})),
        ("measured.flagship.pallas_bq512_bk1024", dict(
            pattern="flagship", mode="kernel", commands=cmds,
            metrics={"tflops": 544.0},
            config={"device_kind": "NVIDIA H100 80GB HBM3"}))])
    md = ts.summarize_sweep(str(tmp_path))
    assert "vs the NVIDIA H100 80GB HBM3 989 TFLOP/s dense bf16 peak" in md
    assert ("| measured.flagship.pallas_bq512_bk1024 | 544.0 | 55.0% | "
            "+10.0% | refined |") in md
    other = tmp_path / "o"
    other.mkdir()
    _write_cells(str(other), tr, [("measured.flagship_pallas", dict(
        pattern="flagship", mode="kernel", commands=cmds,
        metrics={"tflops": 100.0}, config={"device_kind": "cpu"}))])
    assert "no MFU" in ts.summarize_sweep(str(other))


def test_summarize_asymptote_curve(tmp_path):
    for mb, g in ((47, 1460.0), (189, 1466.5), (755, 1462.0)):
        _write_cells(str(tmp_path), tr, [(f"asymptote.multi.size{mb}MB", dict(
            pattern="onesided", mode="local_put", commands="x",
            metrics={"bandwidth_GBps": g, "bytes_per_put": mb * 1e6}))])
    md = ts.summarize_sweep(str(tmp_path))
    assert "flat within 0.4%" in md
    assert "best schedule: asymptote.multi.size189MB at 1466.5 GB/s" in md


def _gate_runs(d, res, cfg, violations, width=None):
    with open(os.path.join(d, f"gates.{cfg}.r0.jsonl"), "w") as f:
        for i, v in enumerate(violations):
            metrics = {"gate_violation": v}
            if width is not None:
                metrics["gate_width_eps"] = width
            f.write(res.Record(pattern="longctx", mode="flash_grad",
                               commands=f"run {i}",
                               metrics=metrics).to_json() + "\n")


def test_fit_and_promote_gates_equal_the_references(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_PATTERNS_GATES_FIT", "/dev/null")
    fits = {}
    for pkg, res in ((js, jr), (ts, tr)):
        d = tmp_path / pkg.__name__
        d.mkdir()
        _gate_runs(str(d), res, "clean", [0.3, 0.5, 0.6])
        _gate_runs(str(d), res, "tight", [0.05, 0.08], width=4.0)
        fits[pkg] = pkg.fit_gates(str(d))
        dest = tmp_path / f"{pkg.__name__}.gates_fit.json"
        pkg.promote_gates(str(d), dest=str(dest))
        fits[pkg, "promoted"] = json.loads(dest.read_text())
        fits[pkg, "source"] = fits[pkg, "promoted"].pop("source")
    assert fits[ts] == fits[js]
    assert fits[ts]["recommended_width_eps"] == 8
    assert fits[ts, "promoted"] == fits[js, "promoted"]
    # a defect is refused by both
    bad = tmp_path / "bad"
    bad.mkdir()
    _gate_runs(str(bad), tr, "broken", [1.5])
    fit = ts.fit_gates(str(bad))
    assert fit["configs"]["gates.broken"]["defect"]
    with pytest.raises(ValueError, match="defect"):
        ts.promote_gates(str(bad), dest=str(tmp_path / "x.json"))
    with pytest.raises(FileNotFoundError):
        ts.fit_gates(str(tmp_path / "nothing"))


def _tune_cell(d, name, gbps, verdict="SUCCESS"):
    with open(os.path.join(d, f"{name}.jsonl"), "a") as f:
        f.write(json.dumps({"pattern": "onesided", "mode": "local_put",
                            "metrics": {"bandwidth_GBps": gbps},
                            "verdict": verdict}) + "\n")


def test_promote_tuned_equals_the_references(tmp_path):
    for name, g, v in (("tune.multi.chunks8", 1400.0, "SUCCESS"),
                       ("tune.multi.chunks16", 1450.0, "SUCCESS"),
                       ("tune.multi.chunks32", 1500.0, "FAILURE"),
                       ("tune.streamed.rows1024", 1466.5, "SUCCESS"),
                       ("tune.streamed.rows512", 1300.0, "SUCCESS")):
        _tune_cell(str(tmp_path), name, g, v)
    got = ts.promote_tuned(str(tmp_path), dest=str(tmp_path / "t.json"))
    want = js.promote_tuned(str(tmp_path), dest=str(tmp_path / "j.json"))
    assert got == want
    assert (got["chunks"], got["block_rows"]) == (16, 1024)
    assert json.loads((tmp_path / "t.json").read_text()) == got
    with pytest.raises(FileNotFoundError):
        ts.promote_tuned(str(tmp_path / "empty"), dest=str(tmp_path / "n"))


@pytest.mark.parametrize("base,lever,base_tier,lever_tier", [
    (121.8, 130.0, "", ""),  # a win: promoted
    (121.8, 122.5, "", ""),  # within noise
    (118.0, 125.0, ".fp", ""),  # across tiers
    (100.0, 110.0, ".fp", ".fp"),  # both first pass
])
def test_promote_flash_equals_the_references(tmp_path, base, lever,
                                             base_tier, lever_tier):
    for name, tflops in (
            (js._FLASH_BASE_CELL + base_tier, base),
            ("measured.flagship.pallas_bq512_bk1024" + lever_tier, lever)):
        (tmp_path / f"{name}.jsonl").write_text(json.dumps({
            "pattern": "flagship", "mode": "kernel", "commands": "x",
            "metrics": {"tflops": tflops, "timing_converged": 1.0},
            "verdict": "SUCCESS"}) + "\n")
    got = ts.promote_flash(str(tmp_path), dest=str(tmp_path / "t.json"))
    want = js.promote_flash(str(tmp_path), dest=str(tmp_path / "j.json"))
    assert got == want
    assert (tmp_path / "t.json").exists() == bool(got["promoted"])


def _runtime_cells(d, values):
    """runtime.<config>.<target> cells with one Record each."""
    for (cfg, target), v in values.items():
        with open(os.path.join(d, f"runtime.{cfg}.{target}.jsonl"), "w") as f:
            f.write(tr.Record(pattern="concurrency", mode="m",
                              metrics={"speedup": v}).to_json() + "\n")


@pytest.mark.parametrize("platform,moved,want", [
    ("cpu", 0.5, "SKIPPED"),
    ("cuda", 0.5, "SUCCESS"),
    ("cuda", 0.01, "WARNING"),
])
def test_check_runtime_bite(tmp_path, platform, moved, want):
    """The port reads ``"cuda"`` where the reference reads ``"tpu"``;
    the metrics are the reference's on the same records."""
    _runtime_cells(str(tmp_path), {
        ("default", "xla.concurrent"): 2.0,
        ("launch_blocking", "xla.concurrent"): 2.0 * (1 - moved),
        ("default", "flagship"): 10.0,
        ("one_hw_queue", "flagship"): 10.0})
    got = ts.check_runtime_bite(str(tmp_path), platform=platform)
    ref = js.check_runtime_bite(
        str(tmp_path), platform="tpu" if platform == "cuda" else "cpu")
    assert got.verdict.value == want == ref.verdict.value
    assert got.metrics == ref.metrics
    assert (got.mode, got.commands) == (ref.mode, ref.commands)
    if want == "SKIPPED":
        assert "CUDA runtime" in got.notes[0]


def test_check_runtime_bite_asks_no_cuda_context(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_PATTERNS_DEVICE", "cpu")
    rec = ts.check_runtime_bite(str(tmp_path))
    assert rec.verdict.value == "SKIPPED"
    assert not torch.cuda.is_initialized()


# -- real cells on the CPU --------------------------------------------------


def test_tiny_cell_end_to_end_on_the_cpu(tmp_path, capsys):
    """One real quick cell through ``run_sweep``: a ``python -m
    tpu_patterns_torch`` child in its own process group, its log with
    the cell's export lines, its Record in JSONL, the state completed,
    and the report table printed."""
    rc = ts.run_sweep("hier", out_dir=str(tmp_path), quick=True,
                      names=[TINY], base_env=_cpu_env(), cell_timeout=240)
    out = capsys.readouterr().out
    assert rc == 0
    st = ts.load_sweep_state(str(tmp_path))[TINY]
    assert st["completed"] and st["rc"] == 0
    assert json.loads(st["sig"])[0] == "tpu_patterns_torch"
    (rec,) = [json.loads(ln) for ln in open(tmp_path / f"{TINY}.jsonl")]
    assert rec["pattern"] == "hierarchical" and rec["run"]["package"] == (
        "tpu_patterns_torch")
    log = (tmp_path / f"{TINY}.log").read_text()
    assert f"## {rec['mode']} | {rec['commands']} | {rec['verdict']}" in log
    assert f"# sweep cell: {TINY}" in out and "| commands" in out
    assert os.path.exists(tmp_path / "sweep-metrics.jsonl")


def test_cell_crash_heals_on_attempt_two(tmp_path, capsys):
    """``cell.run:crash`` on the cell by name, with a shared fault-state
    dir: attempt 1 dies before dispatch (rc 41, nothing banked), attempt
    2 runs; one retry is counted at the site."""
    from tpu_patterns_torch.rt import metric_total, metric_total_jsonl

    # the registry is this process's: count what this sweep adds
    before = metric_total("tpu_patterns_faults_retries_total")
    env = _cpu_env(TPU_PATTERNS_FAULTS=f"cell.run:crash:cell={TINY}",
                   TPU_PATTERNS_FAULTS_STATE=str(tmp_path / "fstate"),
                   TPU_PATTERNS_OBS_DIR=str(tmp_path / "obs"))
    rc = ts.run_sweep("hier", out_dir=str(tmp_path / "d"), quick=True,
                      names=[TINY], base_env=env, cell_timeout=240)
    out = capsys.readouterr().out
    assert rc == 0
    assert "attempt 1 did not complete (rc=41)" in out
    assert "# -> exit 0 (attempts=2)" in out
    assert ts.load_sweep_state(str(tmp_path / "d"))[TINY]["completed"]
    assert metric_total_jsonl(str(tmp_path / "d" / "sweep-metrics.jsonl"),
                              "tpu_patterns_faults_retries_total") == (
        before + 1.0)
    (fired,) = [json.loads(ln) for ln in open(tmp_path / "obs" /
                                               "faults.jsonl")]
    assert (fired["mode"], fired["commands"]) == ("cell.run", "crash")


# -- the CLI ------------------------------------------------------------------


@pytest.mark.parametrize("argv,msg", [
    (["--jsonl", "x.jsonl", "sweep", "p2p"], "--jsonl does not apply"),
    (["--enable_profiling", "sweep", "p2p"], "--enable_profiling does not"),
    (["--obs-dump", "sweep", "p2p"], "--obs-dump does not apply"),
    (["sweep", "p2p", "--gates-dir", "g"], "--gates-dir applies"),
    (["sweep", "p2p", "--flash-dir", "g"], "--flash-dir applies"),
    (["sweep", "promote", "--jobs", "2"], "do not apply to 'sweep promote'"),
    (["sweep", "summarize", "--name", "x"], "do not apply to 'sweep summ"),
    (["sweep", "summarize", "--quick"], "--quick/--resume do not apply"),
    (["sweep", "p2p", "--jobs", "-1"], "--jobs must be >= 0"),
    (["sweep", "promote", "--gates-dir", "a", "--flash-dir", "b"],
     "EXACTLY ONE"),
    (["sweep", "p2p", "--quick", "--name", "nope"], "unknown cell name"),
])
def test_sweep_refusals(argv, msg):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert msg in str(e.value)


def test_sweep_summarize_and_promote_via_cli(tmp_path, capsys):
    _write_cells(str(tmp_path), tr, SUMMARY_CELLS[:1])
    assert cli.main(["sweep", "summarize", "--out", str(tmp_path)]) == 0
    assert "| measured.onesided_hbm | local_put |" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        cli.main(["sweep", "promote", "--out", str(tmp_path)])
