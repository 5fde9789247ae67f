"""The port's miniapp framework and ring-allreduce app against the JAX
package's (tests/test_miniapps.py, over the port).

Each case runs the reference's variant on the conftest's CPU mesh (its
pallas variant in interpret mode) and the port's on a CPU rank mesh of
as many ranks, with the same arguments, and compares the Records:
pattern, mode, commands, config, verdict, the metric keys and
``validated``.  Times are measurements and are not compared.  The
miniapp's own check (every element equals p(p-1)/2 within ``tol``)
cannot see ring order; tests/test_torch_ring.py holds the rings to the
reference bit for bit on random data."""

import io
import json

import numpy as np
import pytest
from jax.sharding import Mesh

from tpu_patterns.core.results import ResultWriter as JWriter
from tpu_patterns.miniapps import framework as jframework
from tpu_patterns.miniapps.apps import allreduce as jcore
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch.comm.mesh import default_mesh
from tpu_patterns_torch.core.results import ResultWriter, Verdict
from tpu_patterns_torch.miniapps import framework
from tpu_patterns_torch.miniapps.apps import allreduce as core
from tpu_patterns_torch.miniapps.apps.allreduce import pallas as tpallas

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

N = 512  # small per-rank buffer for CPU runs
FAST = dict(elements=N, reps=2, warmup=1)


def _quiet():
    return ResultWriter(stream=io.StringIO())


def _both(devices, name, n, **kw):
    """(reference Record, port Record) of variant ``name`` on n ranks."""
    variant = name.split("/")[1]
    want = jframework.get_variant("allreduce", variant).run(
        mesh=Mesh(np.array(devices[:n]), ("ranks",)),
        writer=JWriter(stream=io.StringIO()), **kw)
    got = framework.get_variant("allreduce", variant).run(
        mesh=default_mesh(n, "cpu"), writer=_quiet(), **kw)
    return want, got


def _same_record(want, got):
    assert got.pattern == want.pattern
    assert got.mode == want.mode
    assert got.commands == want.commands
    assert got.config == want.config
    assert got.verdict.value == want.verdict.value
    assert set(got.metrics) == set(want.metrics)
    assert got.metrics["validated"] == want.metrics["validated"]
    assert got.metrics["bytes_per_rank"] == want.metrics["bytes_per_rank"]


def test_discovery_finds_allreduce_variants():
    names = {s.name for s in framework.discover()}
    assert names == {s.name for s in jframework.discover()} == {
        "allreduce/xla", "allreduce/pallas"}
    x = framework.get_variant("allreduce", "xla")
    assert "float32" in x.dtypes and "int32" in x.dtypes
    with pytest.raises(KeyError):
        framework.get_variant("allreduce", "cuda")


def test_typed_runs_match_reference():
    def pairs(fw):
        return [(s.name, d, s.axes) for s, d in fw.typed_runs()]

    assert [(n, d) for n, d, _ in pairs(framework)] == \
        [(n, d) for n, d, _ in pairs(jframework)]
    for (_, _, got), (_, _, want) in zip(pairs(framework),
                                          pairs(jframework)):
        assert got["algorithm"] == want["algorithm"]
        assert tuple(got["mem_kind"]) == tuple(want["mem_kind"])
    assert framework.DEFAULT_NP == jframework.DEFAULT_NP == 4


# The full matrix: variant x dtype x algorithm (≙ CTest's app list).
MATRIX = [
    (spec.name, dt, alg)
    for spec, dt in framework.typed_runs()
    for alg in spec.axes.get("algorithm", ("ring",))
]


@pytest.mark.parametrize(
    "name,dtype,alg", MATRIX, ids=[f"{s}.{d}.{a}" for s, d, a in MATRIX]
)
def test_allreduce_matrix_matches_reference(devices, name, dtype, alg):
    want, got = _both(devices, name, 4, dtype=dtype, algorithm=alg, **FAST)
    _same_record(want, got)
    assert got.verdict is Verdict.SUCCESS
    assert got.metrics["validated"] == 1.0 and got.metrics["wall_s"] > 0
    assert got.config["world"] == 4
    assert "4 ranks on the CPU" in got.notes[0]


def test_pallas_variant_runs_plain_on_cpu_ranks():
    tpallas.reset_launches()
    rec = framework.get_variant("allreduce", "pallas").run(
        mesh=default_mesh(4, "cpu"), writer=_quiet(), **FAST)
    assert rec.verdict is Verdict.SUCCESS
    assert tpallas.launch_counts() == {"accumulate": 0}
    assert core.allreduces_per_run(core.AllreduceConfig(**FAST)) == 2 * 3 + 1


def test_allreduce_eight_ranks(devices):
    want, got = _both(devices, "allreduce/xla", 8, dtype="float32",
                      algorithm="ring_opt", **FAST)
    _same_record(want, got)
    assert got.verdict is Verdict.SUCCESS


def test_world_size_requirement(devices):
    spec = framework.get_variant("allreduce", "xla")
    with pytest.raises(ValueError, match="even world size >= 4, got 2"):
        spec.run(mesh=default_mesh(2, "cpu"), dtype="float32", **FAST)
    want, got = _both(devices, "allreduce/xla", 2, dtype="float32",
                      require_even_ge4=False, **FAST)
    _same_record(want, got)
    assert got.verdict is Verdict.SUCCESS


def test_pallas_rejects_library_path():
    with pytest.raises(ValueError, match="manual ring"):
        framework.get_variant("allreduce", "pallas").run(
            mesh=default_mesh(4, "cpu"), dtype="float32", algorithm="psum",
            **FAST)


def test_ring_opt_divisibility():
    with pytest.raises(ValueError, match="elements % world"):
        framework.get_variant("allreduce", "xla").run(
            mesh=default_mesh(4, "cpu"), dtype="float32",
            algorithm="ring_opt", elements=130, reps=1)


@pytest.mark.parametrize("kind", sorted(core.MEM_KINDS))
@pytest.mark.parametrize("variant", ["xla", "pallas"])
def test_allocator_matrix(devices, variant, kind):
    """On the CPU every kind is a plain CPU tensor: all read SUCCESS.
    The reference's pallas variant on host kinds does not trace on its
    CPU mesh (its ring carry changes memory kind), so there the port's
    Record is checked alone."""
    kw = dict(dtype="float32", mem_kind=kind, **FAST)
    if variant == "pallas" and kind != "D":
        got = framework.get_variant("allreduce", variant).run(
            mesh=default_mesh(4, "cpu"), writer=_quiet(), **kw)
    else:
        want, got = _both(devices, f"allreduce/{variant}", 4, **kw)
        assert want.verdict.value == "SUCCESS"
        _same_record(want, got)
    assert got.verdict is Verdict.SUCCESS
    assert got.config["mem_kind"] == kind


def test_run_all_aggregates(tmp_path):
    writer = ResultWriter(jsonl_path=tmp_path / "miniapps.jsonl",
                          stream=io.StringIO())
    records = framework.run_all(writer=writer, mesh=default_mesh(4, "cpu"),
                                **FAST)
    assert len(records) == len(list(framework.typed_runs()))
    assert writer.exit_code == 0
    lines = (tmp_path / "miniapps.jsonl").read_text().splitlines()
    assert len(lines) == len(records)
    assert [json.loads(ln)["mode"] for ln in lines] == [r.mode for r in
                                                        records]


def test_wire_bytes_model():
    for alg in core.ALGORITHMS:
        for p in (2, 4, 8):
            assert core.wire_bytes_per_rank(alg, 1000, p) == \
                jcore.wire_bytes_per_rank(alg, 1000, p)
    assert core.wire_bytes_per_rank("ring", 1000, 4) == 3000
    assert core.wire_bytes_per_rank("ring_opt", 1000, 4) == 1500


def test_config_matches_reference():
    import dataclasses

    def fields(cls):
        return [(f.name, f.default, dict(f.metadata))
                for f in dataclasses.fields(cls)]

    assert fields(core.AllreduceConfig) == fields(jcore.AllreduceConfig)
    assert core.ALGORITHMS == jcore.ALGORITHMS
    assert set(core.MEM_KINDS) == set(jcore.MEM_KINDS)


def test_rescale_keeps_dtype():
    import torch

    assert core._rescale(torch.full((4,), 6, dtype=torch.int32), 4).tolist() \
        == [1] * 4
    y = core._rescale(torch.full((4,), 6.0, dtype=torch.bfloat16), 4)
    assert y.dtype == torch.bfloat16 and y.tolist() == [1.5] * 4


def test_cli_allreduce_and_miniapps(capsys):
    assert tcli.main(["allreduce", "--device", "cpu", "--devices", "4",
                      "--elements", "512", "--reps", "2",
                      "--variant", "pallas"]) == 0
    assert "## pallas:ring | 4dev float32 D N=512 | SUCCESS" in \
        capsys.readouterr().out
    assert tcli.main(["miniapps", "--device", "cpu", "--devices", "4",
                      "--elements", "512", "--reps", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("| SUCCESS") == len(list(framework.typed_runs()))
    assert tcli.main(["allreduce", "--device", "cpu", "--devices", "2"]) == 0
    assert "## xla:ring | devices=2 | SKIPPED" in capsys.readouterr().out
    assert tcli.main(["allreduce", "--device", "cpu", "--devices", "4",
                      "--algorithm", "ring_opt", "--elements", "130"]) == 0
    assert "## xla:ring_opt | devices=4 | SKIPPED" in capsys.readouterr().out
    assert tcli.main(["p2p", "--transport", "one_sided", "--device", "cpu",
                      "--devices", "4", "--count", "2048", "--reps", "2"]) == 0
    assert "## ring_put | 4dev x 0MB | SUCCESS" in capsys.readouterr().out
    for placement in ("spread", "compact_plan"):
        assert tcli.main(["allreduce", "--device", "cpu", "--devices", "4",
                          "--elements", "512", "--reps", "2", "--placement",
                          placement, "--mechanism", "visible"]) == 0
        assert "## xla:ring | 4dev float32 D N=512 | SUCCESS" in \
            capsys.readouterr().out
    for argv in (["allreduce", "--placement", "diagonal"],
                 ["allreduce", "--mechanism", "affinity"],
                 ["allreduce", "--algorithm", "tree"],
                 ["allreduce", "--mem_kind", "M"]):
        with pytest.raises(SystemExit):
            tcli.build_parser().parse_args(argv)
