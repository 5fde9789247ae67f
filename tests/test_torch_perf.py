"""The port's perf observatory (``tpu_patterns_torch/perf/``,
``core/ratchet.py``) held against the JAX package's: analytic counts
equal over a grid of model configs, the same ratchet and baseline
splits and diff verdicts on the same snapshot dicts, the same report
rows, a CPU capture of every ported executable whose analytic values
equal the reference's formulas, the committed baseline diffing clean,
the provenance stamp on every Record, and ``perf diff`` naming an
injected ``serve.step`` regression."""

import contextlib
import copy
import io
import itertools
import json
import os

import pytest

from tpu_patterns.core import ratchet as ref_ratchet
from tpu_patterns.models.transformer import ModelConfig as RefModelConfig
from tpu_patterns.perf import analytic as ref_analytic
from tpu_patterns.perf import baseline as ref_baseline
from tpu_patterns.perf import report as ref_report
from tpu_patterns_torch import cli
from tpu_patterns_torch.core import ratchet
from tpu_patterns_torch.core.results import Record, ResultWriter
from tpu_patterns_torch.models.transformer import ModelConfig
from tpu_patterns_torch.perf import analytic, provenance
from tpu_patterns_torch.perf import baseline as perf_baseline
from tpu_patterns_torch.perf import history as perf_history
from tpu_patterns_torch.perf import registry
from tpu_patterns_torch.perf import report as perf_report

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

# -- analytic --------------------------------------------------------------

GRID = [
    dict(embed=e, heads=h, head_dim=d, kv_heads=kv, mlp_mult=m, depth=dp,
         dtype=dt, causal=c, remat=r)
    for (e, h, d, kv, m, dp, dt, c, r) in itertools.product(
        (64, 1024), (4, 8), (16, 128), (0, 2), (4,), (1, 3),
        ("float32", "bfloat16"), (True, False), (False, True))
    if not (e == 64 and d == 128)
]


def _pair(kw):
    return ModelConfig(**kw), RefModelConfig(**kw)


@pytest.mark.parametrize("cache_int8", [False, True])
@pytest.mark.parametrize("vocab,rows,length,width", [
    (256, 4, 24, 4), (2048, 8, 512, 5), (50257, 1, 4096, 1)])
def test_analytic_counts_equal_reference(vocab, rows, length, width,
                                         cache_int8):
    for kw in GRID:
        got, want = _pair(kw)
        for fn, args in (
            ("param_count", (vocab,)),
            ("param_bytes", (vocab,)),
            ("prefill_flops", (vocab, rows, length)),
            ("step_flops", (vocab, rows, length)),
            ("verify_flops", (vocab, rows, width, length)),
            ("train_step_flops", (rows, length)),
            ("kv_token_bytes", (cache_int8,)),
            ("prefill_hbm_bytes", (vocab, rows, length, cache_int8)),
            ("step_hbm_bytes", (vocab, rows, length, cache_int8)),
            ("train_step_hbm_bytes", (rows, length)),
        ):
            a = getattr(analytic, fn)(got, *args)
            b = getattr(ref_analytic, fn)(want, *args)
            assert a == b and type(a) is type(b), (fn, kw, a, b)


# -- the ratchet and the baseline ------------------------------------------


def _snapshot(mesh_fp="aaaabbbbcccc", scale=1.0, drop=(), device="cpu"):
    """A snapshot dict of the registry's shape (the same dict is handed to
    both packages)."""
    execs = {
        "decoder.step": {"analytic_flops": 1.5e9, "analytic_hbm_bytes": 4e6,
                         "step_ms": 2.0 * scale, "achieved_gbps": 2.0},
        "serve.step": {"analytic_flops": 9.0e8, "analytic_hbm_bytes": 3e6,
                       "step_ms": 5.0 * scale, "mfu": 0.01},
        "serve.kv_tier": {"kv_evict_bytes": 65536.0, "kv_evictions": 4.0,
                          "step_ms": 7.0},
        "copy_blocks": {"analytic_flops": 0.0, "analytic_hbm_bytes": 65536.0,
                        "step_ms": 0.08},
    }
    for n in drop:
        execs.pop(n)
    return {
        "run": {"run_id": "r1", "git_sha": "abc", "mesh_fp": mesh_fp},
        "ts": 0.0,
        "config": {"vocab": 256, "embed": 64, "k": 5, "inner": 16,
                   "include": "", "device": device},
        "mesh": {"shape": {"dp": 1, "sp": 1, "tp": 1}, "devices": 1,
                 "platform": "cpu"},
        "executables": execs,
    }


def _perturbed():
    """(label, snapshot) pairs a diff must read as the reference does."""
    base = _snapshot()
    slow = _snapshot(scale=10.0)
    flops = copy.deepcopy(base)
    flops["executables"]["decoder.step"]["analytic_flops"] *= 0.99
    tier = copy.deepcopy(base)
    tier["executables"]["serve.kv_tier"]["kv_evict_bytes"] *= 2
    fast = _snapshot(scale=0.2)
    return [
        ("same", base), ("slow", slow), ("flops_drop", flops),
        ("tier_thrash", tier), ("fast", fast),
        ("foreign_machine", _snapshot(mesh_fp="ffffeeeedddd", scale=10.0)),
        ("removed", _snapshot(drop=("copy_blocks",))),
        ("new_shape", _snapshot(device="cuda")),
        ("added", {**base, "executables": {
            **base["executables"], "train.step": {"step_ms": 1.0,
                                                  "analytic_flops": 1e9}}}),
    ]


def _diff_view(d):
    return (
        [(f.executable, f.metric, f.cls, f.baseline_value, f.current_value,
          f.rel_delta) for f in d.regressions],
        [(f.executable, f.metric, f.rel_delta) for f in d.improvements],
        d.unbaselined, d.skipped, d.stale, d.checked, d.exit_code,
        [f.message() for f in d.regressions],
    )


def test_save_baseline_writes_the_reference_file(tmp_path):
    snap = _snapshot()
    old = {}
    for mod, name in ((perf_baseline, "port"), (ref_baseline, "ref")):
        mod.save_baseline(str(tmp_path / f"{name}.json"), snap, old)
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    assert perf_baseline.config_fingerprint(snap) == \
        ref_baseline.config_fingerprint(snap)


@pytest.mark.parametrize("tolerances", [None, {"measured": None},
                                        {"measured": 0.5}])
@pytest.mark.parametrize("label", [lbl for lbl, _ in _perturbed()])
def test_diff_verdicts_equal_reference(label, tolerances, tmp_path):
    base = _snapshot()
    cur = dict(_perturbed())[label]
    path = str(tmp_path / "bl.json")
    ref_baseline.save_baseline(path, base, {})
    got = perf_baseline.diff_snapshot(cur, perf_baseline.load_baseline(path),
                                      tolerances=tolerances)
    want = ref_baseline.diff_snapshot(cur, ref_baseline.load_baseline(path),
                                      tolerances=tolerances)
    assert _diff_view(got) == _diff_view(want)
    if label == "slow" and tolerances != {"measured": None}:
        assert got.exit_code == 1


def test_ratchet_core_equals_reference(tmp_path):
    entries = [{"fingerprint": f"f{i}", "justification": j, "value": i}
               for i, j in enumerate(("", "kept: known", "", "why"))]
    old = {"f0": {"fingerprint": "f0", "justification": "old note"},
           "f2": {"fingerprint": "f2", "justification": ""}}
    assert ratchet.preserve_justifications(entries, old) == \
        ref_ratchet.preserve_justifications(entries, old)
    seen = ["f1", "f2", "f9"]
    base = {e["fingerprint"]: e for e in entries}
    filt = lambda e: e["value"] != 3  # noqa: E731
    assert ratchet.split_entries(seen, base, stale_filter=filt) == \
        ref_ratchet.split_entries(seen, base, stale_filter=filt)
    for mod, name in ((ratchet, "p"), (ref_ratchet, "r")):
        path = str(tmp_path / f"{name}.json")
        mod.save_entries(path, entries, version=1)
        assert mod.prune_stale(path, seen, version=1) == \
            (2, [entries[0], entries[3]])
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "r.json").read_text()
    (tmp_path / "v.json").write_text('{"version": 2, "entries": []}')
    for mod in (ratchet, ref_ratchet):
        with pytest.raises(ValueError, match="version"):
            mod.load_entries(str(tmp_path / "v.json"), version=1)


def _rows(text):
    return [ln for ln in text.splitlines() if ln.startswith("|")]


@pytest.mark.parametrize("label", ["same", "slow", "added"])
def test_render_snapshot_rows_equal_reference(label):
    snap = dict(_perturbed())[label]
    assert _rows(perf_report.render_snapshot(snap)) == \
        _rows(ref_report.render_snapshot(snap))


def test_report_header_names_the_card():
    snap = _snapshot()
    snap["mesh"]["card"] = "NVIDIA H100 80GB HBM3, 700.00 W"
    text = perf_report.render_snapshot(snap)
    assert "- card NVIDIA H100 80GB HBM3, 700.00 W" in text
    assert "card" not in perf_report.render_snapshot(_snapshot())


# -- the capture -----------------------------------------------------------


@pytest.fixture(scope="module")
def captured():
    """One CPU capture of the full registry at PerfConfig's defaults
    (k and inner small: the measurement policy is no part of a
    fingerprint)."""
    cfg = registry.PerfConfig(k=2, inner=2, device="cpu")
    return registry.capture(cfg), cfg


def test_capture_runs_every_ported_executable(captured):
    snap, cfg = captured
    # the whole registry: disagg.stream, skipped until the disaggregated
    # handoff was ported, is captured too
    assert set(snap["executables"]) == set(registry.EXECUTABLES) == {
        "train.step", "zero.step", "decoder.prefill", "decoder.step",
        "decoder.verify", "decoder.step_pallas", "decoder.verify_pallas",
        "copy_blocks", "disagg.stream", "serve.step", "serve.kv_tier",
        "serve.prefix_store"}
    assert "skipped" not in snap
    assert set(snap["run"]) == {"run_id", "git_sha", "mesh_fp"}
    assert snap["mesh"] == {"shape": {"dp": 1, "sp": 1, "tp": 1},
                            "devices": 1, "platform": "cpu"}
    for name, m in snap["executables"].items():
        assert m["step_ms"] > 0, name
        assert "mfu" not in m  # no peak off the card
        assert not {"xla_flops", "compile_s", "temp_bytes"} & set(m)
    tier = snap["executables"]["serve.kv_tier"]
    assert tier["kv_evictions"] > 0 and tier["kv_onload_hits"] > 0
    # the fetcher found every block the publisher committed
    store = snap["executables"]["serve.prefix_store"]
    assert store["store_hits"] > 0
    assert store["store_fetch_bytes"] == store["store_publish_bytes"] > 0


@pytest.mark.parametrize("requests,evicts", [(6, False), (21, False),
                                             (22, True), (24, True)])
def test_kv_tier_capture_evicts_at_eight_slots_from_22_requests(requests,
                                                                evicts):
    """The serve width's 8 slots: the trace's max(slots + 2, requests //
    2) conversations outgrow the pool only from 11 on, so the smoke's
    capture runs 24 requests and gates on its evictions."""
    cfg = registry.PerfConfig(k=1, inner=1, slots=8, requests=requests,
                              device="cpu")
    tier = registry._capture_kv_tier(cfg, "cpu")["serve.kv_tier"]
    assert (tier["kv_evictions"] > 0) is evicts
    assert (tier["kv_onload_hits"] > 0) is evicts
    assert (tier["kv_evict_bytes"] > 0) is evicts


def test_capture_analytic_values_equal_reference_formulas(captured):
    snap, cfg = captured
    mc = RefModelConfig(embed=cfg.embed, heads=cfg.heads,
                        head_dim=cfg.head_dim, mlp_mult=cfg.mlp_mult,
                        causal=True, dtype=cfg.dtype, depth=cfg.depth,
                        kv_heads=cfg.kv_heads)
    A, ex = ref_analytic, snap["executables"]
    width = cfg.spec_width + 1
    ctx = (cfg.min_prompt + cfg.max_prompt) // 2 + cfg.gen // 2
    step_b = A.step_hbm_bytes(mc, cfg.vocab, cfg.slots, cfg.max_prompt)
    want = {
        "train.step": (A.train_step_flops(mc, cfg.batch, cfg.seq),
                       A.train_step_hbm_bytes(mc, cfg.batch, cfg.seq)),
        "decoder.prefill": (
            A.prefill_flops(mc, cfg.vocab, cfg.slots, cfg.max_prompt),
            A.prefill_hbm_bytes(mc, cfg.vocab, cfg.slots, cfg.max_prompt)),
        "decoder.step": (A.step_flops(mc, cfg.vocab, cfg.slots,
                                      cfg.max_prompt), step_b),
        "decoder.verify": (
            A.verify_flops(mc, cfg.vocab, cfg.slots, width, cfg.max_prompt),
            width * step_b - (width - 1) * A.param_bytes(mc, cfg.vocab)),
        "copy_blocks": (0.0, 2 * 2 * cfg.block_len
                        * A.kv_token_bytes(mc, False)),
        "serve.step": (A.step_flops(mc, cfg.vocab, cfg.slots, ctx),
                       A.step_hbm_bytes(mc, cfg.vocab, cfg.slots, ctx)),
    }
    # the reference's disagg.stream floor: one request's table window,
    # two hops each reading and writing it
    n_pages = -(-(cfg.max_prompt + cfg.gen) // cfg.block_len)
    wire = n_pages * cfg.block_len * A.kv_token_bytes(mc, False)
    want["disagg.stream"] = (0.0, 4.0 * wire)
    assert ex["disagg.stream"]["transfer_bytes"] == wire
    want["decoder.step_pallas"] = want["decoder.step"]
    want["decoder.verify_pallas"] = want["decoder.verify"]
    for name, (flops, byts) in want.items():
        assert ex[name]["analytic_flops"] == flops, name
        assert ex[name]["analytic_hbm_bytes"] == byts, name
        ms = ex[name]["step_ms"]
        assert ex[name]["achieved_gbps"] == pytest.approx(
            byts / (ms / 1e3) / 1e9)


def test_committed_baseline_diffs_clean(captured):
    """The committed pins (``perf update-baseline --device cpu``) at
    PerfConfig's defaults: every analytic pin matches, nothing is
    unbaselined or stale; measured entries are informational here (a
    shared CPU's load moves them; the card gates them in its own
    call)."""
    snap, _cfg = captured
    bl = perf_baseline.load_baseline()
    d = perf_baseline.diff_snapshot(snap, bl, tolerances={"measured": None})
    assert d.regressions == [], [f.message() for f in d.regressions]
    assert d.unbaselined == [] and d.stale == []
    analytic_pins = [e for e in bl.values() if e["class"] == "analytic"]
    assert d.checked == len(analytic_pins) > 0
    assert {e["config"] for e in bl.values()} == {
        perf_baseline.config_fingerprint(snap)}


def test_include_selects_and_refuses():
    with pytest.raises(ValueError, match="unknown executable"):
        registry._selected(registry.PerfConfig(include="decoder.stepp"))
    # refused until the disaggregated handoff was ported; now selected
    assert registry._selected(registry.PerfConfig(
        include="decoder.step,disagg.stream")) == [
            "decoder.step", "disagg.stream"]
    # the fleet prefix store's capture is ported: selected, not refused
    assert registry._selected(registry.PerfConfig(
        include="decoder.step,serve.prefix_store")) == [
            "decoder.step", "serve.prefix_store"]
    assert registry._selected(registry.PerfConfig(
        include="serve.step, copy_blocks")) == ["serve.step", "copy_blocks"]
    assert registry._selected(registry.PerfConfig(
        include="zero.step")) == ["zero.step"]


def test_report_includes_zero_step(capsys):
    """``perf report --include zero.step`` on the CPU: the ZeRO-adam
    step over two dp ranks, timed, with the train step's analytic
    floors, SUCCESS."""
    rc = cli.main(["perf", "report", "--include", "zero.step", "--device",
                   "cpu", "--no-history", "--k", "2", "--inner", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "zero.step" in out
    snap = registry.capture(registry.PerfConfig(include="zero.step", k=1,
                                                inner=1, device="cpu"))
    m = snap["executables"]["zero.step"]
    assert m["step_ms"] > 0
    cfg = registry.PerfConfig()
    assert m["analytic_flops"] == analytic.train_step_flops(
        registry._mcfg(cfg), cfg.batch, cfg.seq)


def test_perf_diff_names_a_serve_step_sleep_regression(tmp_path,
                                                       monkeypatch):
    """The JAX package's ``test_sleep_fault_at_serve_step_flags_the_
    regression`` through the port's CLI: pin, re-capture under a sleep at
    the ``serve.step`` site, and ``perf diff`` exits 1 naming it.  One
    intra-op thread: with the suite's workers each running a full pool
    on the same cores, a tiny decode step swung from ~2 ms to ~170 ms,
    which a pin must not carry."""
    import torch

    from tpu_patterns_torch import faults

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _sleep_regression(tmp_path, faults)
    finally:
        torch.set_num_threads(threads)


def _sleep_regression(tmp_path, faults):
    bl = str(tmp_path / "bl.json")
    common = ["--device", "cpu", "--k", "2", "--inner", "2",
              "--requests", "2", "--gen", "3", "--no-history",
              "--baseline", bl]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["perf", "update-baseline", *common])
    assert rc == 0
    pinned = [e["value"] for e in json.load(open(bl))["entries"]
              if e["executable"] == "serve.step" and e["metric"] == "step_ms"]
    jl = tmp_path / "diff.jsonl"
    faults.configure("serve.step:sleep:delay_s=0.2:count=10000")
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--jsonl", str(jl), "perf", "diff", *common,
                           "--include", "serve.step"])
    finally:
        faults.configure(None)
    recs = [json.loads(ln) for ln in open(jl)]
    assert rc == 1, (pinned, recs, [ln for ln in out.getvalue().splitlines()
                                    if ln.startswith("# ")])
    by_mode = {r["mode"]: r for r in recs}
    assert by_mode["serve.step"]["verdict"] == "FAILURE"
    assert "serve.step.step_ms [measured]" in by_mode["serve.step"][
        "notes"][0]
    assert by_mode["diff"]["verdict"] == "FAILURE"
    assert by_mode["diff"]["metrics"]["stale"] == 0.0  # --include subset


def test_perf_report_prune_and_history(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    pd = str(tmp_path / "perf")
    out = io.StringIO()
    jl = tmp_path / "r.jsonl"
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--jsonl", str(jl), "perf", "report", "--device",
                       "cpu", "--k", "1", "--inner", "1", "--include",
                       "copy_blocks", "--perf-dir", pd])
    assert rc == 0
    assert "| copy_blocks |" in out.getvalue()
    (rec,) = [json.loads(ln) for ln in open(jl)]
    assert rec["mode"] == "report"
    assert rec["metrics"]["history_snapshots"] == 1.0
    assert rec["metrics"]["bench_rounds"] == 0.0  # no TPU rounds
    assert perf_history.history_path(pd) == os.path.join(pd, "history.jsonl")
    (snap,) = perf_history.load_history(pd)
    assert set(snap["executables"]) == {"copy_blocks"}
    # prune-stale: an entry whose executable left the registry goes, the
    # rest stay byte for byte
    bl = tmp_path / "bl.json"
    ref_baseline.save_baseline(str(bl), _snapshot(), {})
    data = json.loads(bl.read_text())
    data["entries"].append({**data["entries"][0], "executable": "gone",
                            "fingerprint": "0" * 16})
    bl.write_text(json.dumps(data, indent=1, sort_keys=True) + "\n")
    with contextlib.redirect_stdout(out):
        rc = cli.main(["perf", "prune-stale", "--baseline", str(bl)])
    assert rc == 0
    kept = json.loads(bl.read_text())["entries"]
    assert kept == data["entries"][:-1]


def test_perf_cli_refuses(tmp_path):
    err = io.StringIO()
    for argv in (["perf", "report", "--include", "disagg.streams"],
                 ["perf", "update-baseline", "--include", "serve.step"],
                 ["perf", "diff", "--dp", "2"]):
        with pytest.raises(SystemExit) as e, \
                contextlib.redirect_stderr(err):
            cli.main([*argv, "--device", "cpu", "--no-history"])
        assert e.value.code not in (0, None), argv


# -- provenance ------------------------------------------------------------


def test_every_record_carries_the_reference_provenance_keys(tmp_path):
    path = tmp_path / "r.jsonl"
    w = ResultWriter(jsonl_path=path, stream=io.StringIO())
    w.record(Record(pattern="p", mode="m"))
    w.record(Record(pattern="p", mode="m2"))
    lines = [json.loads(ln) for ln in open(path)]
    for d in lines:
        assert set(d["run"]) == {"run_id", "git_sha", "mesh_fp", "package"}
        assert d["run"]["package"] == "tpu_patterns_torch"
        assert len(d["run"]["mesh_fp"]) == 12
    assert lines[0]["run"] == lines[1]["run"]


def test_cli_main_rotates_the_run_stamp(tmp_path):
    out = io.StringIO()
    ids = []
    for _ in range(2):
        with contextlib.redirect_stdout(out):
            cli.main(["perf", "prune-stale", "--baseline",
                      str(tmp_path / "none.json")])
        ids.append(provenance.current_stamp().run_id)
    assert ids[0] != ids[1]
    a, b = provenance.new_run(), provenance.new_run()
    assert a.git_sha == b.git_sha and a.mesh_fp == b.mesh_fp


def test_mesh_fingerprint_reads_env_knobs_not_the_device(monkeypatch):
    fp = provenance.mesh_fingerprint()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    assert provenance.mesh_fingerprint() != fp
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert provenance.mesh_fingerprint() == fp


def test_timeline_joins_only_this_packages_records(tmp_path):
    res = tmp_path / "results"
    res.mkdir()
    mine = {"pattern": "serve", "mode": "m", "verdict": "SUCCESS",
            "timestamp": 2.0, "metrics": {},
            "run": {"run_id": "a", "package": "tpu_patterns_torch"}}
    theirs = {**mine, "timestamp": 1.0, "run": {"run_id": "b"}}
    (res / "x.jsonl").write_text(
        json.dumps(theirs) + "\n" + json.dumps(mine) + "\nnot json\n")
    (tmp_path / "BENCH_r01.json").write_text('{"n": 1, "parsed": {}}')
    tl = perf_history.build_timeline(str(tmp_path / "perf"), str(res))
    assert [r["run"]["run_id"] for r in tl["records"]] == ["a"]
    assert tl["bench_rounds"] == [] and tl["snapshots"] == []
    text = perf_report.render_trajectory(tl)
    assert "1 total, 1 run-stamped across 1 distinct runs" in text


def test_chip_peak_reads_the_datasheet_without_halving(monkeypatch):
    import torch

    from tpu_patterns_torch import runtime

    assert runtime.chip_peak_tflops("bfloat16", "cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert runtime.chip_peak_tflops("bfloat16") == 989.0
    assert runtime.chip_peak_tflops(torch.bfloat16) == 989.0
    assert runtime.chip_peak_tflops("float32") == 67.0  # no TPU halving
    assert runtime.chip_peak_tflops() == 989.0
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA A100-SXM4-80GB")
    assert runtime.chip_peak_tflops("bfloat16") is None  # unknown card


@pytest.mark.parametrize("metrics,match", [
    ({"step_ms": 1.0, "analytic_flops": 2e12, "analytic_hbm_bytes": 1e6},
     "mfu"),
    ({"step_ms": 1.0, "analytic_flops": 1e6, "analytic_hbm_bytes": 5e9},
     "GB/s"),
])
def test_derive_raises_on_impossible_card_readings(metrics, match,
                                                   monkeypatch):
    """On the card, a rate past the datasheet is a fault, never a result:
    2 TFLOP in 1 ms is 2000 TFLOP/s against 989; 5 GB in 1 ms is 5000
    GB/s against 1.15 x 3350."""
    from tpu_patterns_torch import runtime

    monkeypatch.setattr(runtime, "chip_peak_tflops", lambda d, dev: 989.0)
    monkeypatch.setattr(runtime, "chip_hbm_gbps", lambda dev: 3350.0)
    with pytest.raises(RuntimeError, match=match):
        registry._derive(dict(metrics), "bfloat16", "cuda")
    ok = {"step_ms": 10.0, "analytic_flops": 2e12, "analytic_hbm_bytes": 5e9}
    registry._derive(ok, "bfloat16", "cuda")
    assert ok["mfu"] == pytest.approx(200 / 989)
    assert ok["achieved_gbps"] == pytest.approx(500.0)


def test_mesh_fingerprint_never_touches_the_device(monkeypatch):
    import torch

    def boom(*a, **k):
        raise AssertionError("the fingerprint touched the device")

    for name in ("init", "device_count", "get_device_name",
                 "is_available", "current_device"):
        monkeypatch.setattr(torch.cuda, name, boom)
    assert len(provenance.mesh_fingerprint()) == 12
