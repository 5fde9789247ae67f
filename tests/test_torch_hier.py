"""The port's hierarchical allreduce (``comm/hierarchical.py``) and its
``hier`` CLI against the JAX package's.

The same seeded numpy inputs go through the reference's collectives
under ``shard_map`` on the conftest's CPU mesh (a ``(dcn, ici)`` view of
8 devices at most) and through the port's rank lists.  XLA's float sums
take their own order, so floats are held to the reference's own gate,
64 eps times the largest magnitude of the float64 sum (``hierarchical.py
:276-286``), against that sum and against the reference's output;
integers wrap and are compared bit for bit.  ``run_hierarchical``'s
Records are held to the reference's (keys, modes, commands, verdicts,
the traffic model exactly; times are measurements)."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_patterns.comm import hierarchical as jh
from tpu_patterns.core.results import ResultWriter as JWriter
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch.comm import hierarchical as th
from tpu_patterns_torch.comm import mesh as tmesh
from tpu_patterns_torch.core.results import ResultWriter as TWriter
from tpu_patterns_torch.core.results import Verdict

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

N = 48  # elements a rank: divisible by every ici below


def _data(dcn, ici, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-2**31, 2**31, (dcn, ici, N), dtype=np.int32)
    return rng.standard_normal((dcn, ici, N)).astype(np.float32)


def _jax(fn, data):
    dcn, ici, _ = data.shape
    m = Mesh(np.array(jax.devices()[:dcn * ici]).reshape(dcn, ici),
             ("dcn", "ici"))
    f = jax.jit(jax.shard_map(
        lambda a: fn(a[0, 0])[None, None], mesh=m,
        in_specs=P("dcn", "ici", None), out_specs=P("dcn", "ici", None)))
    x = jax.device_put(jnp.asarray(data),
                       NamedSharding(m, P("dcn", "ici", None)))
    return np.asarray(f(x)).reshape(dcn * ici, N)


def _port(fn, data):
    dcn, ici, _ = data.shape
    mesh = tmesh.default_mesh(dcn * ici, "cpu")
    return mesh.gather(fn(mesh.scatter(data.reshape(-1)))).numpy().reshape(
        dcn * ici, N)


GRIDS = [(2, 4), (4, 2), (1, 4), (2, 2), (1, 8), (8, 1), (2, 3)]


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("dcn,ici", GRIDS)
@pytest.mark.parametrize("variant", ["flat", "hier"])
def test_allreduce_matches_reference(variant, dcn, ici, dtype):
    data = _data(dcn, ici, dtype, seed=dcn * 10 + ici)
    if variant == "flat":
        want = _jax(lambda a: jh.flat_allreduce(a, "ici", "dcn"), data)
        got = _port(th.flat_allreduce, data)
    else:
        want = _jax(lambda a: jh.hierarchical_allreduce(a, "ici", ici,
                                                        "dcn"), data)
        got = _port(lambda xs: th.hierarchical_allreduce(xs, ici), data)
    assert got.dtype == want.dtype
    if dtype == np.int32:
        np.testing.assert_array_equal(got, want)
        return
    exact = data.astype(np.float64).sum(axis=(0, 1))
    tol = 64 * float(np.finfo(np.float32).eps) * max(1.0,
                                                     np.abs(exact).max())
    assert np.abs(got - exact).max() <= tol
    assert np.abs(got - want).max() <= tol
    assert (got == got[0]).all()  # every rank holds the same sum


def test_indivisible_leading_dim_raises_as_reference():
    xs = [torch.ones(10) for _ in range(8)]
    with pytest.raises(ValueError, match="not divisible"):
        th.hierarchical_allreduce(xs, 4)
    with pytest.raises(ValueError, match="groups of 3"):
        th.hierarchical_allreduce([torch.ones(12)] * 4, 3)


@pytest.mark.parametrize("n_bytes,ici,dcn", [(1 << 20, 4, 2), (4096, 2, 4),
                                             (12, 1, 8), (1000, 8, 1)])
def test_traffic_model_matches_reference(n_bytes, ici, dcn):
    assert th.traffic_model(n_bytes, ici, dcn) == jh.traffic_model(
        n_bytes, ici, dcn)


class FakeDev:
    def __init__(self, process_index, slice_index=None, platform="cpu"):
        self.process_index = process_index
        self.platform = platform
        if slice_index is not None:
            self.slice_index = slice_index


DETECT = {
    "tpu_slices": [FakeDev(0, s, "tpu") for s in (1, 0, 1, 0)],
    "tpu_one_slice_multihost": [FakeDev(p, 0, "tpu") for p in (0, 0, 1, 1)],
    "gpu_constant_slice": [FakeDev(p, 0, "gpu") for p in (0, 0, 1, 1)],
    "processes": [FakeDev(p) for p in (0, 0, 1, 1, 2, 2)],
    "unordered": [FakeDev(p) for p in (1, 0, 1, 0)],
    "tpu_no_slice": [FakeDev(p, platform="tpu") for p in (1, 1, 0, 0)],
    "unequal": [FakeDev(p) for p in (0, 0, 1)],
    "torch_devices": [torch.device("cpu")] * 4,
}


@pytest.mark.parametrize("name", DETECT)
def test_detect_hierarchy_matches_reference(name):
    devs = DETECT[name]
    try:
        want = jh.detect_hierarchy(devs)
    except ValueError as e:
        with pytest.raises(ValueError, match="unequal slice sizes"):
            th.detect_hierarchy(devs)
        assert "unequal slice sizes" in str(e)
        return
    n, ordered = th.detect_hierarchy(devs)
    assert n == want[0]
    assert [id(d) for d in ordered] == [id(d) for d in want[1]]


def _notes(rec):
    return [n for n in rec.notes
            if "noise-bound" not in n and "not a fabric" not in n]


def _records(p, **kw):
    cfg = dict(count=1000, reps=2, warmup=1, **kw)
    ref = jh.run_hierarchical(Mesh(np.array(jax.devices()[:p]), ("x",)),
                              jh.HierConfig(**cfg),
                              JWriter(stream=io.StringIO()))
    port = th.run_hierarchical(tmesh.default_mesh(p, "cpu"),
                               th.HierConfig(**cfg),
                               TWriter(stream=io.StringIO()))
    return ref, port


@pytest.mark.parametrize("p,dcn,dtype", [
    (4, 2, "float32"), (8, 2, "float32"), (8, 4, "int32"), (4, 0, "float32"),
    (8, 4, "bfloat16"), (6, 2, "int32"),
])
def test_run_hierarchical_records_match_reference(p, dcn, dtype):
    ref, port = _records(p, dcn=dcn, dtype=dtype)
    assert [r.mode for r in port] == [r.mode for r in ref] == ["flat",
                                                               "hier"]
    for got, want in zip(port, ref):
        assert (got.pattern, got.commands, got.verdict.value) == (
            want.pattern, want.commands, want.verdict.value)
        assert got.verdict is Verdict.SUCCESS, got.notes
        assert set(got.metrics) == set(want.metrics)
        for k in ("checksum_ok", "flat_bytes_per_device",
                  "ici_bytes_per_device", "dcn_bytes_per_device"):
            assert got.metrics[k] == want.metrics[k], k
        assert _notes(got) == _notes(want)
        assert got.config == {"device_kind": "cpu", "world": p}


def test_one_rank_a_group_is_skipped_as_reference():
    ref, port = _records(4, dcn=4)
    assert len(port) == len(ref) == 1
    for r in (ref[0], port[0]):
        assert (r.mode, r.commands, r.verdict.value, r.notes) == (
            "hier", "4x1", "SKIPPED", ["hierarchy needs ici >= 2, have 4x1"])


def test_a_skipped_outer_tier_fails_the_gate(monkeypatch):
    """Each group summing only itself (the dcn allreduce dropped) must
    fail the hier Record."""
    def groups_only(xs, ici):
        out = []
        for g in range(len(xs) // ici):
            out += th.flat_allreduce(xs[g * ici:(g + 1) * ici])
        return out

    monkeypatch.setattr(th, "hierarchical_allreduce", groups_only)
    flat, hier = th.run_hierarchical(
        tmesh.default_mesh(4, "cpu"), th.HierConfig(count=64, reps=1,
                                                    warmup=0),
        TWriter(stream=io.StringIO()))
    assert flat.verdict is Verdict.SUCCESS
    assert hier.verdict is Verdict.FAILURE
    assert hier.metrics["checksum_ok"] == 0.0
    assert "hierarchical allreduce result mismatch" in hier.notes


def test_hier_cli(capsys, monkeypatch, tmp_path):
    """``hier`` with the reference's world checks; ranks may share a
    card (here all lie on the CPU)."""
    from tpu_patterns_torch.core.results import Record

    for var in ("DCN", "COUNT", "REPS"):
        monkeypatch.delenv("TPU_PATTERNS_" + var, raising=False)
    small = ["--device", "cpu", "--count", "4096", "--reps", "2",
             "--warmup", "1"]
    assert tcli.main(["hier", "--devices", "4", "--dcn", "2", *small]) == 0
    out = capsys.readouterr().out
    assert "## flat | 2x2dev x 0MB | SUCCESS" in out
    assert "## hier | 2x2dev x 0MB | SUCCESS" in out
    assert tcli.main(["hier", "--devices", "4", "--dcn", "0", *small]) == 0
    assert "## hier | 1x4dev x 0MB | SUCCESS" in capsys.readouterr().out
    for argv, n, dcn in ((["--devices", "4", "--dcn", "3"], 4, 3),
                         (["--devices", "4", "--dcn", "4"], 4, 4),
                         ([], 1, 2)):
        log = tmp_path / f"{n}-{dcn}.jsonl"
        assert tcli.main(["--jsonl", str(log), "hier", *argv, *small]) == 0
        rec, = [Record.from_json(ln) for ln in log.read_text().splitlines()]
        assert (rec.mode, rec.commands, rec.verdict, rec.notes) == (
            "hier", f"devices={n}", Verdict.SKIPPED,
            [f"need dcn|{n} and ici >= 2, have dcn={dcn}"])
