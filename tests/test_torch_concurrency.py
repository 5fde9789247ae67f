"""The port's concurrency suite (K6, K7, the harness) against the JAX
package's.

The same numpy inputs go through the reference's busy-wait (its XLA
version and its Pallas kernel in interpret mode, as
tests/test_concurrency.py runs it on the CPU) and the port's wrappers on
CPU tensors, which run the plain torch versions of the CUDA kernels.
Each step rounds once to float32 on both sides, so every comparison of
values is exact.  Records of both packages' ``run_concurrency`` are
compared in their pattern, mode, commands, metric keys and bytes;
times and speedups are measurements and are not compared."""

import io
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_patterns import cli as jcli
from tpu_patterns.concurrency import backends as jb
from tpu_patterns.concurrency import commands as jc
from tpu_patterns.concurrency import harness as jh
from tpu_patterns.concurrency import kernels as jk
from tpu_patterns.core.results import ResultWriter as JWriter
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch.concurrency import backends as tb
from tpu_patterns_torch.concurrency import commands as tc
from tpu_patterns_torch.concurrency import harness as th
from tpu_patterns_torch.concurrency import kernels as tk
from tpu_patterns_torch.core.results import ResultWriter as TWriter
from tpu_patterns_torch.core.results import Verdict
from tpu_patterns_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]


def _x(rows, seed=0):
    return np.random.default_rng(seed).random((rows, 128), dtype=np.float32)


# -- K6 ------------------------------------------------------------------


@pytest.mark.parametrize("trips", [0, 1, 3, 50])
@pytest.mark.parametrize("rows", [1, 3, 8, 9, 64])
def test_busy_wait_matches_reference(rows, trips):
    """Plain K6 (and the wrapper on a CPU tensor) equals the reference's
    Pallas kernel in interpret mode and its XLA version, bit for bit."""
    a = _x(rows, seed=rows + trips)
    want = np.asarray(jk.busy_wait_pallas(jnp.asarray(a), trips,
                                          interpret=True))
    np.testing.assert_array_equal(
        np.asarray(jk.busy_wait_xla(jnp.asarray(a), trips)), want)
    x = torch.from_numpy(a)
    for got in (tk.busy_wait_plain(x, trips), tk.busy_wait(x, trips)):
        assert got.dtype == torch.float32 and got.shape == x.shape
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(x.numpy(), a)  # input untouched


def test_two_roundings_do_not_match_the_reference():
    """``x * a + b`` in float32 rounds twice a step and drifts from the
    reference (~3.8e-6 a trip); the plain version's single rounding does
    not.  This pins why the kernel uses an FMA intrinsic."""
    a, trips = _x(8, seed=5), 200
    want = np.asarray(jk.busy_wait_xla(jnp.asarray(a), trips))
    x = torch.from_numpy(a)
    np.testing.assert_array_equal(tk.busy_wait_plain(x, trips).numpy(), want)
    twice = x.clone()
    for _ in range(tk.FMAS_PER_TRIP * trips):
        twice = twice * tk.A32 + tk.B32
    gap = np.abs(twice.numpy() - want).max()
    assert gap > 1e-4, gap


def test_busy_wait_constants_and_flops_match_reference():
    assert (tk._A, tk._B, tk.FMAS_PER_TRIP) == (jk._A, jk._B,
                                                jk.FMAS_PER_TRIP)
    assert (tk.A32, tk.B32) == (float(np.float32(jk._A)),
                                float(np.float32(jk._B)))
    for n, t in ((1024, 40_000), (1, 0), (8192, 3)):
        assert tk.flops(n, t) == jk.flops(n, t)


def test_wrappers_have_no_fallback():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on a
    device with no kernel raises, and bad inputs raise on every device."""
    meta = torch.empty((8, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tk.busy_wait(meta, 3)
    with pytest.raises(ValueError, match="no kernel"):
        tb.dma_compute([meta], [], [])
    with pytest.raises(ValueError, match="float32"):
        tk.busy_wait(torch.zeros((8, 128), dtype=torch.float64), 1)
    with pytest.raises(ValueError, match="tripcount"):
        tk.busy_wait(torch.zeros((8, 128)), -1)
    x = torch.zeros((1, 128))
    with pytest.raises(ValueError, match="at most"):
        tb.dma_compute([x] * (tb.MAX_COPIES + 1), [], [])
    with pytest.raises(ValueError, match="one tripcount"):
        tb.dma_compute([], [x], [])
    with pytest.raises(ValueError, match="no copy and no compute"):
        tb.dma_compute([], [], [])
    with pytest.raises(ValueError, match="one CUDA device"):
        tb.K7Launch([x], [], [], True, [torch.empty_like(x)], [])
    assert tk.busy_wait.launches == 0 and tb.dma_compute.launches == 0


# -- K7 ------------------------------------------------------------------


def _cmds(module, group, **knobs):
    cmds = module.parse_group(group)
    for c in cmds:
        for k, v in knobs.items():
            setattr(c, k, v)
    return cmds


@pytest.mark.parametrize("mode", ["dma_serial", "dma_overlap"])
@pytest.mark.parametrize("group", ["C D2D", "D2D D2D C C"])
def test_dma_compute_matches_reference_kernel(group, mode):
    """The port's pallas group (plain K7 on the CPU) from its own seeded
    buffers equals the reference's kernel in interpret mode
    (``build(...).direct_fn()``), outputs in the reference's order."""
    knobs = dict(tripcount=5, elements=2048, copy_elements=4224)
    want = jb.PallasBackend().build(_cmds(jc, group, **knobs),
                                    mode).direct_fn()
    got = tb.PallasBackend().build(_cmds(tc, group, **knobs), mode,
                                   "cpu").direct_fn()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # and the wrapper itself, on the same inputs, with the plain version
    copies = [torch.from_numpy(_x(33, 10 + i)) for i in range(2)]
    comps = [torch.from_numpy(_x(16, 20 + i)) for i in range(2)]
    outs = tb.dma_compute(copies, comps, [5, 5], mode == "dma_overlap")
    plain = tb.dma_compute_plain(copies, comps, [5, 5])
    for g, w in zip(outs, plain):
        assert torch.equal(g, w)
    assert torch.equal(outs[0], copies[0]) and outs[0] is not copies[0]


@pytest.mark.parametrize("rows,row_bytes,want", [
    (32768, 512, (256, 65536)),   # the default 16 MiB copy: 128-row tiles
    (33, 512, (1, 16896)),        # 4224 elements: one tile
    (1, 512, (1, 512)),
    (262144, 512, (2048, 65536)),  # the 128 MiB cap
    (229, 512, (229, 512)),        # prime rows: one row a tile
])
def test_copy_plan_tiles_rows_within_a_stage(rows, row_bytes, want):
    x = torch.empty((rows, row_bytes // 4))
    n_seg, seg = tb.copy_plan(x)
    assert (n_seg, seg) == want
    assert n_seg * seg == rows * row_bytes and seg <= 112 * 1024


# -- commands ------------------------------------------------------------

TOKENS = ["C", "c", " C ", "M2D", "H2D", "D2H", "S2D", "D2S", "D2D", "h2s",
          "M2S", "D2M", "Q2D", "H2H", "S2S", "M2M", "C2D", "D2", "", "CC"]


def _parsed(module, tok):
    try:
        c = module.parse_command(tok)
    except ValueError as e:
        return ("error", str(e))
    return (c.text, c.kind, c.src and c.src.name, c.dst and c.dst.name,
            c.tripcount, c.elements, c.copy_elements, c.bytes)


@pytest.mark.parametrize("tok", TOKENS)
def test_parse_command_matches_reference(tok):
    assert _parsed(tc, tok) == _parsed(jc, tok)


@pytest.mark.parametrize("group", ["C M2D D2M", "  C   C ", "", "C Q2D",
                                   "D2D D2D C C"])
def test_parse_group_matches_reference(group):
    def run(module):
        try:
            return [_parsed(module, c.text) for c in module.parse_group(group)]
        except ValueError as e:
            return str(e)

    assert run(tc) == run(jc)


@pytest.mark.parametrize("factor", [1e-12, 1e-3, 0.37, 0.5, 1.0, 2.0, 7.3,
                                    1e3, 1e9])
def test_scaled_matches_reference(factor):
    """The rescale, the floors and the caps are the reference's."""
    assert (tc.Command.MAX_TRIPCOUNT, tc.Command.MAX_COPY_ELEMENTS) == (
        jc.Command.MAX_TRIPCOUNT, jc.Command.MAX_COPY_ELEMENTS)
    for tok in ("C", "H2D", "D2D"):
        for trips, n in ((40_000, 1 << 22), (3, 128), (9_999_999, 4224)):
            got = tc.parse_command(tok)
            ref = jc.parse_command(tok)
            got.tripcount = ref.tripcount = trips
            got.copy_elements = ref.copy_elements = n
            g, r = got.scaled(factor), ref.scaled(factor)
            assert (g.tripcount, g.copy_elements, g.elements) == (
                r.tripcount, r.copy_elements, r.elements)


@pytest.mark.parametrize("tok", ["C", "M2D", "H2D", "S2D", "D2D"])
def test_alloc_gives_the_reference_buffer(tok):
    """Same generator, same seed, same array; on the CPU every memory
    kind is a plain CPU tensor (M, whose copies the reference keeps as
    numpy, included)."""
    ref, port = jc.parse_command(tok), tc.parse_command(tok)
    ref.copy_elements = port.copy_elements = 640
    ref.elements = port.elements = 256
    want = np.asarray(jc.alloc(ref, seed=7))
    got = tc.alloc(port, "cpu", seed=7)
    assert got.device.type == "cpu" and not got.is_pinned()
    np.testing.assert_array_equal(got.numpy(), want)
    assert tc.empty_in(tc.MemKind.S, (2, 128), "cpu").device.type == "cpu"


# -- validation, backends, harness ---------------------------------------


@pytest.mark.parametrize("backend,mode,group,match", [
    ("xla", "concurrent", "C M2D", "pageable host"),
    ("xla", "serial", "D2M", "pageable host"),
    ("xla", "concurrent", "D2D", "elided"),
    ("xla", "dispatch_async", "C D2D", "elided"),
    ("pallas", "dma_overlap", "C H2D", "D2D"),
    ("pallas", "dma_serial", "S2D", "D2D"),
    ("xla", "warp_speed", "C", "unknown mode"),
    ("pallas", "concurrent", "C", "unknown mode"),
])
def test_validation_matches_reference(backend, mode, group, match):
    for bmod, cmod in ((jb, jc), (tb, tc)):
        with pytest.raises(ValueError, match=match):
            bmod.get_backend(backend).validate(mode, cmod.parse_group(group))


@pytest.mark.parametrize("backend,mode,group", [
    ("xla", "dispatch_async", "C M2D"),
    ("xla", "dispatch_serial", "M2D D2M"),
    ("pallas", "dma_serial", "C D2D"),
    ("xla", "concurrent", "C S2D H2D"),
])
def test_valid_groups_match_reference(backend, mode, group):
    for bmod, cmod in ((jb, jc), (tb, tc)):
        bmod.get_backend(backend).validate(mode, cmod.parse_group(group))


def test_backends_and_modes_match_reference():
    assert set(tb.BACKENDS) == set(jb.BACKENDS) == {"xla", "pallas"}
    for name in tb.BACKENDS:
        port, ref = tb.get_backend(name), jb.get_backend(name)
        assert port.modes == ref.modes
        for m in ref.modes:
            assert port.solo_mode(m) == ref.solo_mode(m)
    with pytest.raises(KeyError, match="xla"):
        tb.get_backend("cuda")


def test_concurrency_cli_flags_match_reference():
    """``--backend`` takes the reference's choices, and every flag of
    ``tpu-patterns concurrency`` exists with its default."""
    def actions(parser):
        sub = parser._subparsers._group_actions[0].choices["concurrency"]
        return {a.dest: a for a in sub._actions if a.dest != "help"}

    ref, port = actions(jcli.build_parser()), actions(tcli.build_parser())
    assert tuple(port["backend"].choices) == tuple(ref["backend"].choices)
    assert set(ref) <= set(port) and set(port) - set(ref) == {"device"}
    for dest, a in ref.items():
        assert port[dest].default == a.default, dest


def _record(module, writer, **kw):
    cfg = module.ConcurrencyConfig(reps=2, warmup=1, tripcount=50,
                                   elements=1024, copy_elements=1 << 14,
                                   **kw)
    if module is th:
        cfg.device = "cpu"
    else:
        cfg.chain_lengths = (1, 3)  # as tests/test_concurrency.py runs it
    return module.run_concurrency(cfg, writer)[0]


@pytest.mark.parametrize("backend,mode,group", [
    ("xla", "serial", "C S2D"),
    ("xla", "concurrent", "C S2D"),
    ("xla", "dispatch_async", "M2D D2M"),
    ("pallas", "dma_serial", "C D2D"),
    ("pallas", "dma_overlap", "C D2D"),
])
def test_run_concurrency_record_matches_reference(backend, mode, group):
    """With auto-tune off, both packages measure the same workload: the
    Records agree in pattern, mode, commands, metric keys and bytes per
    iteration (copies as round trips under xla's in-stream modes)."""
    kw = dict(backend=backend, mode=mode, commands=(group,), auto_tune=False)
    ref = _record(jh, JWriter(stream=io.StringIO()), **kw)
    got = _record(th, TWriter(stream=io.StringIO()), **kw)
    assert (got.pattern, got.mode, got.commands) == (
        ref.pattern, ref.mode, ref.commands)
    assert set(got.metrics) == set(ref.metrics)
    assert got.metrics["bytes_per_iter"] == ref.metrics["bytes_per_iter"]
    assert got.metrics["speedup"] > 0 and got.metrics["serial_total_us"] > 0
    assert got.metrics["theoretical_speedup"] >= 1.0
    assert got.config["device_kind"] == "cpu"


def test_auto_tune_matches_reference(monkeypatch):
    """Both packages' ``_measure_solo`` patched to the same times: the
    tuned commands and the progress lines (cap warning included) are
    the reference's."""
    times = {"C": 5.2e6, "S2D": 3.0e4, "H2D": 4.1e6, "D2D": 1.0e4}

    def fake(backend, cmd, cfg, cache=None):
        return (times[cmd.text], cmd.bytes, True)

    monkeypatch.setattr(jh, "_measure_solo", fake)
    monkeypatch.setattr(th, "_measure_solo", fake)
    for group in ("C S2D", "C H2D D2D", "D2D C C"):
        outs = []
        for h, mod, writer_cls, b in ((jh, jc, JWriter, jb),
                                      (th, tc, TWriter, tb)):
            stream = io.StringIO()
            cfg = h.ConcurrencyConfig()
            cmds = h._apply_defaults(mod.parse_group(group), cfg)
            tuned = h.auto_tune(b.get_backend("xla"), cmds, cfg,
                                writer_cls(stream=stream), {})
            outs.append(([(c.text, c.tripcount, c.elements, c.copy_elements)
                          for c in tuned], stream.getvalue()))
        assert outs[0] == outs[1]
    assert "hit workload caps" in outs[1][1]


def test_min_bandwidth_gate(tmp_path):
    w = TWriter(tmp_path / "r.jsonl", stream=io.StringIO())
    rec = _record(th, w, backend="xla", mode="concurrent",
                  commands=("C S2D",), min_bandwidth=1e12, auto_tune=False)
    assert rec.verdict is Verdict.FAILURE
    assert any("below floor" in n for n in rec.notes)
    assert w.exit_code == 1


def test_cli_runs_and_exits_with_the_verdict(tmp_path):
    out = tmp_path / "r.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-m", "tpu_patterns_torch", "--jsonl", str(out),
         "concurrency", "--device", "cpu", "--tripcount", "50",
         "--copy_elements", "16384", "--reps", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    from tpu_patterns_torch.core.results import Record

    recs = [Record.from_json(ln) for ln in out.read_text().splitlines()]
    assert [(x.mode, x.commands) for x in recs] == [("xla:concurrent",
                                                      "C C")]
    assert r.returncode == (1 if recs[0].verdict is Verdict.FAILURE else 0)
    assert f"## xla:concurrent | C C | {recs[0].verdict.value}" in r.stdout


# -- kernel build key ----------------------------------------------------


def test_build_key_covers_headers_in_other_directories(tmp_path,
                                                       monkeypatch):
    """K7 includes K8's staging header from comm/csrc: a change to it
    must change K7's library path, or a stale library would load."""
    pkg = tmp_path / "tpu_patterns_torch"
    for p in build.PKG_DIR.rglob("*.cu*"):
        dst = pkg / p.relative_to(build.PKG_DIR)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(p, dst)
    monkeypatch.setattr(build, "PKG_DIR", pkg)
    src = pkg / "concurrency" / "csrc" / "dma_compute.cu"
    before = {n: build.target(s) for n, s in build.sources().items()}
    assert set(before) >= {"busy_wait", "dma_compute", "managed_alloc",
                           "local_put"}
    hdr = pkg / "comm" / "csrc" / "bulk_copy.cuh"
    hdr.write_text(hdr.read_text() + "\n// changed\n")
    after = build.target(src)
    assert after != before["dma_compute"]
    assert build.target(pkg / "comm" / "csrc" / "local_put.cu") != \
        before["local_put"]
