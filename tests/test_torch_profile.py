"""The port's trace reader (``tpu_patterns_torch/core/profile.py``) held
against the JAX package's (``tpu_patterns/core/profile.py``): the same
breakdown on single-stream planes, the union of intervals across
overlapping streams, the same classifier verdicts on the reference's
vocabulary, Kineto JSON round trips, and the ``--enable_profiling`` and
``profilecheck`` Records with the reference's keys and verdicts."""

import io
import json
import os

import numpy as np
import pytest
import torch

from tpu_patterns.core import profile as ref
from tpu_patterns_torch import cli
from tpu_patterns_torch.core import profile as prof

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


def _synthetic_names():
    with open(os.path.join(FIXDIR, "op_names_synthetic.json")) as f:
        return sorted(json.load(f))


def _random_planes(seed: int, n_planes: int, n_events: int):
    """The same single-stream planes in both packages' dataclasses:
    non-overlapping events with gaps, names from the reference's
    vocabulary, plus a re-aggregating line both readers skip."""
    rng = np.random.RandomState(seed)
    names = _synthetic_names()
    ref_planes, port_planes = [], []
    for p in range(n_planes):
        t, evs = 0, []
        for _ in range(n_events):
            t += int(rng.randint(0, 5)) * 1000  # gaps (may be 0)
            dur = int(rng.randint(1, 50)) * 1000
            evs.append((names[rng.randint(len(names))], t, dur))
            t += dur
        base = int(rng.randint(0, 1000))
        for mod, out in ((ref, ref_planes), (prof, port_planes)):
            ops = mod.XLine("XLA Ops",
                            [mod.XEvent(n, o, d) for n, o, d in evs], base)
            steps = mod.XLine("Steps", [mod.XEvent("step", 0, t)], base)
            out.append(mod.XPlane(f"/device:{p}", [ops, steps]))
    return ref_planes, port_planes


@pytest.mark.parametrize("seed,n_planes,n_events",
                         [(0, 1, 1), (1, 1, 40), (2, 3, 25), (3, 2, 200)])
def test_single_stream_breakdown_equals_reference(seed, n_planes, n_events):
    ref_planes, port_planes = _random_planes(seed, n_planes, n_events)
    assert prof.breakdown_planes(port_planes) == \
        ref.breakdown_planes(ref_planes)


def test_overlapping_streams_take_the_union():
    ev = prof.XEvent
    # stream 7: [0, 10) and [30, 40) us; stream 9: [5, 20) and [35, 50);
    # the union is [0, 20) + [30, 50) = 40 us of a 50 us wall
    us = 1_000_000
    plane = prof.XPlane("/device:cuda:0", [
        prof.XLine("stream 7", [ev("ampere_sgemm_128x64_nn", 0, 10 * us),
                                ev("Memcpy DtoD (Device -> Device)",
                                   30 * us, 10 * us)]),
        prof.XLine("stream 9", [ev("ncclDevKernel_AllReduce_Sum_f32",
                                   5 * us, 15 * us),
                                ev("Memcpy HtoD (Pageable -> Device)",
                                   35 * us, 15 * us)]),
    ])
    bd = prof.breakdown_planes([plane])
    assert bd["busy_ms"] == pytest.approx(0.040)
    assert bd["wall_ms"] == pytest.approx(0.050)
    assert bd["idle_ms"] == pytest.approx(0.010)
    # categories still sum over events: 50 us, the fractions' base
    assert bd["compute_ms"] == pytest.approx(0.010)
    assert bd["collective_ms"] == pytest.approx(0.015)
    assert bd["dma_ms"] == pytest.approx(0.010)
    assert bd["infeed_outfeed_ms"] == pytest.approx(0.015)
    assert bd["compute_frac"] == 0.2 and bd["collective_frac"] == 0.3
    # a second card's idle adds per plane; the wall is the longest
    other = prof.XPlane("/device:cuda:1", [
        prof.XLine("stream 7", [ev("flash_fwd_wgmma_kernel", 0, 10 * us),
                                ev("flash_fwd_wgmma_kernel", 20 * us,
                                   10 * us)])])
    bd2 = prof.breakdown_planes([plane, other])
    assert bd2["busy_ms"] == pytest.approx(0.060)
    assert bd2["idle_ms"] == pytest.approx(0.020)
    assert bd2["wall_ms"] == pytest.approx(0.050)


def test_union_of_nested_and_touching_intervals():
    assert prof.union_ps([]) == 0
    assert prof.union_ps([(0, 10), (2, 5), (10, 12), (20, 21)]) == 13
    assert prof.union_ps([(5, 9), (0, 10)]) == 10


@pytest.mark.parametrize("name", _synthetic_names())
def test_classify_agrees_with_reference_on_its_vocabulary(name):
    assert prof.classify(name) == ref.classify(name)


@pytest.mark.parametrize("name,category", [
    ("ampere_sgemm_128x64_nn", "compute"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "compute"),
    ("nvjet_hsh_256x128_64x4_2x1_v_bz_coopA_NNT", "compute"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >(int, ...)", "compute"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>",
     "compute"),
    ("paged_attention_split_kernel", "compute"),
    ("void flash_bwd_wgmma_dkv_kernel<128, 2>(FlashBwdParams)", "compute"),
    ("dma_compute_kernel", "compute"),
    ("local_put_streamed_kernel", "compute"),
    ("ncclDevKernel_Reduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096>)",
     "collective"),
    ("Memcpy HtoD (Pageable -> Device)", "infeed_outfeed"),
    ("Memcpy DtoH (Device -> Pinned)", "infeed_outfeed"),
    ("Memcpy DtoD (Device -> Device)", "dma"),
    ("Memset (Device)", "dma"),
])
def test_classify_books_the_cuda_vocabulary(name, category):
    assert prof.classify(name) == category


def _kineto_trace(path, device_events, host=True):
    """A Kineto Chrome trace with ``device_events`` (device, stream, cat,
    name, ts_us, dur_us) beside host events the reader drops."""
    events = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
               "args": {"name": "python"}}]
    if host:
        events += [
            {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
             "tid": 1, "ts": 1000.0, "dur": 400.0},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "pid": 1, "tid": 1, "ts": 1001.0, "dur": 4.0},
            {"ph": "X", "cat": "gpu_user_annotation", "name": "step",
             "pid": 0, "tid": 7, "ts": 900.0, "dur": 5000.0},
            {"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 7,
             "ts": 1010.0, "id": 3},
        ]
    for dev, stream, cat, name, ts, dur in device_events:
        events.append({"ph": "X", "cat": cat, "name": name, "pid": dev,
                       "tid": stream, "ts": ts, "dur": dur,
                       "args": {"device": dev, "stream": stream}})
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events,
                   "baseTimeNanoseconds": 1790857026000000000}, f)


def test_kineto_json_round_trip(tmp_path):
    _kineto_trace(tmp_path / "a.pt.trace.json", [
        (0, 7, "kernel", "ampere_sgemm_128x64_nn", 1433695833313.465, 10.25),
        (0, 7, "gpu_memset", "Memset (Device)", 1433695833330.0, 2.001),
        (0, 13, "gpu_memcpy", "Memcpy DtoH (Device -> Pageable)",
         1433695833318.0, 20.0),
    ])
    (plane,) = prof.parse_trace(str(tmp_path / "a.pt.trace.json"))
    assert plane.name == "/device:cuda:0"
    assert [ln.name for ln in plane.lines] == ["stream 7", "stream 13"]
    first = plane.lines[0].events[0]
    assert first.offset_ps == 1433695833313465000
    assert first.duration_ps == 10_250_000
    assert plane.lines[0].events[1].duration_ps == 2_001_000
    bd = prof.breakdown(str(tmp_path))
    # union: [313.465, 338.0) us = 24.535 us of a 24.535 us wall
    assert bd["busy_ms"] == pytest.approx(0.024535)
    assert bd["wall_ms"] == pytest.approx(0.024535)
    assert bd["idle_ms"] == pytest.approx(0.0)
    assert bd["n_device_planes"] == 1.0
    snap = prof.op_name_snapshot(str(tmp_path))
    assert snap["Memset (Device)"] == {"count": 1, "duration_ps": 2_001_000,
                                       "category": "dma"}
    assert set(snap) == {"ampere_sgemm_128x64_nn", "Memset (Device)",
                         "Memcpy DtoH (Device -> Pageable)"}


def test_newest_trace_wins_and_gz_reads(tmp_path):
    import gzip

    _kineto_trace(tmp_path / "old.pt.trace.json",
                  [(0, 7, "kernel", "gemm_a", 0.0, 1.0)])
    os.utime(tmp_path / "old.pt.trace.json", (1, 1))
    sub = tmp_path / "run2"
    sub.mkdir()
    _kineto_trace(sub / "new.json", [(0, 7, "kernel", "gemm_b", 0.0, 2.0)])
    with open(sub / "new.json", "rb") as f, \
            gzip.open(sub / "new.pt.trace.json.gz", "wb") as g:
        g.write(f.read())
    os.remove(sub / "new.json")
    assert set(prof.op_name_snapshot(str(tmp_path))) == {"gemm_b"}


def test_host_only_traces_give_none(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    assert prof.breakdown(str(tmp_path)) is None  # no file
    with profile(activities=[ProfilerActivity.CPU]) as p:
        x = torch.ones(64, 64)
        (x @ x).sum()
    assert prof.planes_from_profile(p) == []
    assert prof.breakdown_of(prof.planes_from_profile(p)) is None
    p.export_chrome_trace(str(tmp_path / "cpu.pt.trace.json"))
    assert prof.parse_trace(str(tmp_path / "cpu.pt.trace.json")) == []
    assert prof.breakdown(str(tmp_path)) is None
    assert prof.op_name_snapshot(str(tmp_path)) is None
    _kineto_trace(tmp_path / "z.pt.trace.json", [])  # newer, still empty
    assert prof.breakdown(str(tmp_path)) is None


def _reference_to_kineto(path, planes):
    """The reference's xplane planes as one Kineto trace: plane i ->
    device i, its op line -> stream 7 (the re-aggregating lines are
    dropped, as both readers drop them)."""
    evs = []
    for i, p in enumerate(ref.device_planes(planes)):
        for line in p.lines:
            if any(s in line.name.lower() for s in ref._SKIP_LINES):
                continue
            base = line.timestamp_ns * 1000
            for e in line.events:
                evs.append((i, 7, "kernel", e.name,
                            (base + e.offset_ps) / 1e6, e.duration_ps / 1e6))
    _kineto_trace(path, evs)


def _main_records(main, argv, tmp_path, name):
    jl = tmp_path / f"{name}.jsonl"
    rc = main(["--jsonl", str(jl), *argv])
    recs = [json.loads(ln) for ln in open(jl)] if jl.exists() else []
    return rc, recs


def test_profilecheck_records_match_reference(tmp_path, monkeypatch):
    from tpu_patterns.cli import main as ref_main

    monkeypatch.chdir(tmp_path)
    planes = ref.parse_xspace(os.path.join(FIXDIR, "synthetic.xplane.pb"))
    kdir = tmp_path / "kineto"
    kdir.mkdir()
    _reference_to_kineto(str(kdir / "t.pt.trace.json"), planes)
    rates = tmp_path / "rates.jsonl"
    rates.write_text(json.dumps({
        "pattern": "longctx", "mode": "pallas", "commands": "x",
        "metrics": {"tflops_hw": 40.0}, "verdict": "SUCCESS",
        "config": {"dtype": "float32", "device": "cpu"}, "env": {},
        "timestamp": 0.0, "notes": [], "run": {}, "superseded": False,
    }) + "\n")
    snaps = {}
    out = {}
    for who, main, d in (("ref", ref_main, FIXDIR), ("port", cli.main,
                                                     str(kdir))):
        snaps[who] = str(tmp_path / f"{who}_names.json")
        rc, recs = _main_records(main, [
            "profilecheck", d, "--snapshot-out", snaps[who],
            "--rates-jsonl", str(rates)], tmp_path, who)
        out[who] = (rc, [(r["mode"], r["verdict"], r["metrics"])
                         for r in recs])
    assert out["port"] == out["ref"]
    assert [m for m, _, _ in out["port"][1]] == ["profile_ops",
                                                 "profile_crosscheck"]
    with open(snaps["ref"]) as f, open(snaps["port"]) as g:
        assert json.load(f) == json.load(g)


def test_profilecheck_warns_on_unclassified_time(tmp_path):
    _kineto_trace(tmp_path / "t.pt.trace.json", [
        (0, 7, "kernel", "mystery_kernel_a", 0.0, 80.0),
        (0, 7, "kernel", "gemm_kernel", 100.0, 20.0),
    ])
    rc, recs = _main_records(cli.main, ["profilecheck", str(tmp_path)],
                             tmp_path, "w")
    (rec,) = recs
    assert rc == 0 and rec["verdict"] == "WARNING"
    assert rec["metrics"] == {"unique_names": 2.0, "frac_other_time": 0.8}
    assert "mystery_kernel_a" in rec["notes"][0]


def test_profilecheck_empty_dir_is_skipped(tmp_path):
    rc, recs = _main_records(cli.main, ["profilecheck", str(tmp_path)],
                             tmp_path, "e")
    assert rc == 0
    assert [(r["mode"], r["verdict"]) for r in recs] == [
        ("profile_ops", "SKIPPED")]


def test_enable_profiling_banks_the_reference_breakdown(tmp_path,
                                                        monkeypatch):
    """The ``profile_breakdown`` Record carries the reference's keys and
    values on the same device planes (the trace the CPU run exports has
    no device event, so the parse is handed the reference's planes)."""
    planes = ref.parse_xspace(os.path.join(FIXDIR, "synthetic.xplane.pb"))
    want = ref.breakdown(FIXDIR)
    kdir = tmp_path / "k"
    kdir.mkdir()
    _reference_to_kineto(str(kdir / "t.pt.trace.json"), planes)
    port_planes = prof.parse_trace(str(kdir / "t.pt.trace.json"))
    monkeypatch.setattr(prof, "parse_trace", lambda path: port_planes)
    rc, recs = _main_records(cli.main, [
        "--enable_profiling", "--profile_dir", str(tmp_path / "prof"),
        "perf", "prune-stale", "--baseline", str(tmp_path / "bl.json"),
    ], tmp_path, "p")
    assert rc == 0
    bd = [r for r in recs if r["mode"] == "profile_breakdown"]
    (rec,) = bd
    assert rec["pattern"] == "perf" and rec["verdict"] == "SUCCESS"
    assert rec["metrics"] == {k: round(v, 4) for k, v in want.items()}
    assert os.listdir(tmp_path / "prof")  # the trace was exported


def test_enable_profiling_without_device_plane_keeps_the_verdict(tmp_path):
    out = io.StringIO()
    import contextlib

    with contextlib.redirect_stdout(out):
        rc, recs = _main_records(cli.main, [
            "--enable_profiling", "--profile_dir", str(tmp_path / "prof"),
            "perf", "prune-stale", "--baseline", str(tmp_path / "bl.json"),
        ], tmp_path, "n")
    assert rc == 0
    assert [r["mode"] for r in recs] == ["prune-stale"]  # its own alone
    assert "no device plane in the trace" in out.getvalue()


@pytest.mark.parametrize("tflops,bd,peak,n", [
    (60.0, {"compute_ms": 0.0, "busy_ms": 8.0, "wall_ms": 10.0}, None, 1),
    (0.0, {"compute_ms": 0.0, "busy_ms": 8.0, "wall_ms": 10.0}, 197.0, 1),
    (150.0, {"compute_ms": 5.0, "busy_ms": 8.0, "wall_ms": 10.0}, 197.0, 1),
    (150.0, {"compute_ms": 5.0, "busy_ms": 8.0, "wall_ms": 10.0}, 67.0, 2),
    (400.0, {"compute_ms": 12.0, "busy_ms": 12.0, "wall_ms": 10.0}, 989.0,
     1),
    (10.0, {"compute_ms": 1.0, "busy_ms": 1.0, "wall_ms": 0.0}, 989.0, 1),
])
def test_crosscheck_rate_equals_reference(tflops, bd, peak, n):
    assert prof.crosscheck_rate(tflops, bd, peak, n) == \
        ref.crosscheck_rate(tflops, bd, peak, n)


class _KinetoEvent:
    """An in-memory Kineto event as torch reports it: the device type
    and the user-annotation flag, no activity type."""

    def __init__(self, name, dev_type, start, dur, annotation=False):
        self._v = (name, dev_type, start, dur, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def device_index(self):
        return 0

    def device_resource_id(self):
        return 7


def test_in_memory_events_without_activity_type():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [
        _KinetoEvent("gemm_a", cuda, 1000, 500),
        _KinetoEvent("step", cuda, 0, 9000, annotation=True),
        _KinetoEvent("aten::mm", cpu, 900, 700),
        _KinetoEvent("Memset (Device)", cuda, 2000, 100),
        _KinetoEvent("empty", cuda, 3000, 0),
    ]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    (plane,) = prof.planes_from_profile(Prof)
    (line,) = plane.lines
    assert [(e.name, e.offset_ps, e.duration_ps) for e in line.events] == [
        ("gemm_a", 1_000_000, 500_000), ("Memset (Device)", 2_000_000,
                                         100_000)]


TORCH_FIXDIR = os.path.join(os.path.dirname(__file__), "torch_fixtures")


def _card_fixtures():
    import glob

    return sorted(glob.glob(os.path.join(TORCH_FIXDIR, "op_names_*.json")))


@pytest.mark.parametrize("path", _card_fixtures(),
                         ids=lambda p: os.path.basename(p))
def test_card_vocabulary_classifies(path):
    """The device op names ``profilecheck --snapshot-out`` took on an
    H100 (``chip_smoke.py`` phase 18, the serve and flagship traces),
    re-classified by the current rules: at most 20% of busy time in
    ``other``, the port's kernels booked as compute.  The reference's
    rules alone book most of it as ``other``: its token matcher wants no
    letter beside a token, which cuBLAS's and ATen's names never give."""
    with open(path) as f:
        names = json.load(f)
    total = sum(d["duration_ps"] for d in names.values())
    assert names and total > 0

    def other(classify):
        return sum(d["duration_ps"] for n, d in names.items()
                   if classify(n) == "other") / total

    assert other(prof.classify) <= 0.20
    assert other(ref.classify) > 0.5
    for n in names:
        if any(k in n for k in ("paged_attention", "flash_")):
            assert prof.classify(n) == "compute", n


def test_card_fixtures_are_committed():
    assert [os.path.basename(p) for p in _card_fixtures()] == [
        "op_names_h100_flagship.json", "op_names_h100_serve.json"]


def test_enable_profiling_with_an_unparsable_trace(tmp_path, monkeypatch):
    """A trace that does not parse gives a progress line and no
    breakdown Record; the run's own Record and exit code stand."""
    import contextlib

    def broken(path):
        raise ValueError("truncated trace")

    monkeypatch.setattr(prof, "parse_trace", broken)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, recs = _main_records(cli.main, [
            "--enable_profiling", "--profile_dir", str(tmp_path / "prof"),
            "perf", "prune-stale", "--baseline", str(tmp_path / "bl.json"),
        ], tmp_path, "u")
    assert rc == 0
    assert [r["mode"] for r in recs] == ["prune-stale"]
    assert "trace unparsable (ValueError: truncated trace)" in out.getvalue()
