"""The port's two-sided pair exchange (``comm/p2p.py``) and its ``p2p``
CLI against the JAX package's.

The same seeded numpy inputs go through the reference's ``lax.ppermute``
under ``shard_map`` on the conftest's CPU mesh and through the port's
``pair_exchange`` over a CPU rank mesh: a copy, so every comparison is
bit for bit, as are the per-shard checksums.  ``run_p2p``'s Records are
held to the reference's: keys, modes, commands, verdicts, checksums and
the notes both write (bandwidths are measurements and are not
compared)."""

import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from tpu_patterns.comm import p2p as jp2p
from tpu_patterns.comm import verify as jverify
from tpu_patterns.core.results import ResultWriter as JWriter
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch.comm import mesh as tmesh
from tpu_patterns_torch.comm import p2p as tp2p
from tpu_patterns_torch.comm import verify as tverify
from tpu_patterns_torch.convert import fill_from_numpy
from tpu_patterns_torch.core.results import ResultWriter as TWriter
from tpu_patterns_torch.core.results import Verdict

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

N = 96  # elements a rank


def _data(p, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-2**31, 2**31, (p, N), dtype=np.int32)
    return rng.standard_normal((p, N)).astype(np.float32)


def _jmesh(p):
    return Mesh(np.array(jax.devices()[:p]), ("x",))


def _jax_map(fn, data):
    p = data.shape[0]
    f = jax.jit(jax.shard_map(fn, mesh=_jmesh(p), in_specs=P("x"),
                              out_specs=P("x")))
    return np.asarray(f(jnp.asarray(data.reshape(-1))))


@pytest.mark.parametrize("n", range(0, 10))
def test_permutations_match_reference(n):
    for bidir in (False, True):
        assert tp2p.pair_permutation(n, bidir) == jp2p.pair_permutation(
            n, bidir)
    assert tp2p.stream_permutation(n) == jp2p.stream_permutation(n)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("bidir", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_exchange_matches_ppermute(p, bidir, dtype):
    """Tolerance: none (bit for bit): each output shard is a copy of its
    sender's, or zeros."""
    data = _data(p, dtype, seed=p)
    perm = jp2p.pair_permutation(p, bidir)
    want = _jax_map(functools.partial(jp2p._exchange, axis="x", perm=perm),
                    data).reshape(p, N)
    mesh = tmesh.default_mesh(p, "cpu")
    shards = mesh.scatter(data.reshape(-1))
    out = tp2p.pair_exchange(shards, perm)
    got = mesh.gather(out).numpy().reshape(p, N)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # each receiver's buffer is its own, never an input's storage
    inputs = {s.data_ptr() for s in shards}
    assert not inputs & {o.data_ptr() for o in out}
    assert len({o.data_ptr() for o in out}) == p


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_shard_checksums_match_reference(dtype):
    """The reference's per-shard ``checksum_device`` (an int32 sum) and
    the port's on the same fill, exact; before and after a bidirectional
    exchange, where ``expect[d] = src[s]``."""
    p, count = 4, 5000
    fill = np.asarray(jverify.fill_randomly(p * count, dtype, 3))
    f = jax.jit(jax.shard_map(functools.partial(jp2p._shard_checksums,
                                                axis="x"),
                              mesh=_jmesh(p), in_specs=P("x"),
                              out_specs=P("x")))
    want = [int(v) for v in np.asarray(f(jnp.asarray(fill)))]
    mesh = tmesh.default_mesh(p, "cpu")
    shards = mesh.scatter(fill_from_numpy(fill))
    assert tp2p.shard_checksums(shards) == want
    perm = tp2p.pair_permutation(p, True)
    moved = tp2p.shard_checksums(tp2p.pair_exchange(shards, perm))
    assert moved == [want[s] for s, _ in sorted(perm, key=lambda e: e[1])]


def _notes(rec):
    """The notes both packages write, measured rates masked: the port's
    zero-fill and shared-card notes and either's noise note are their
    own."""
    return [re.sub(r"[\d.]+ GB/s", "* GB/s", n) for n in rec.notes
            if "noise-bound" not in n and "zero fill" not in n
            and "not a fabric" not in n]


def _records(p, monkeypatch, **kw):
    """Both packages' ``run_p2p`` on the reference's fill."""
    cfg = dict(count=1024, reps=2, warmup=1, **kw)
    ref = jp2p.run_p2p(_jmesh(p), jp2p.P2PConfig(**cfg),
                       JWriter(stream=io.StringIO()))
    fill = np.asarray(jverify.fill_randomly(p * cfg["count"], "float32", 0))
    monkeypatch.setattr(tverify, "fill_randomly",
                        lambda n, dtype, seed, device: fill_from_numpy(
                            fill, device))
    port = tp2p.run_p2p(tmesh.default_mesh(p, "cpu"), tp2p.P2PConfig(**cfg),
                        TWriter(stream=io.StringIO()))
    return ref, port


@pytest.mark.parametrize("p", [2, 4, 8])
def test_run_p2p_records_match_reference(p, monkeypatch):
    ref, port = _records(p, monkeypatch)
    assert [r.mode for r in port] == [r.mode for r in ref] == [
        "unidirectional", "bidirectional"]
    for got, want in zip(port, ref):
        assert (got.pattern, got.commands, got.verdict.value) == (
            want.pattern, want.commands, want.verdict.value)
        assert got.verdict is Verdict.SUCCESS, got.notes
        assert set(got.metrics) == set(want.metrics)
        for k in ("checksum_ok", "bytes_per_pair", "num_transfers"):
            assert got.metrics[k] == want.metrics[k]
        assert got.metrics["bandwidth_GBps_per_pair"] == pytest.approx(
            got.metrics["bandwidth_GBps"] / got.metrics["num_transfers"])
        assert _notes(got) == _notes(want)
        assert got.config == {"device_kind": "cpu", "world": p}
    uni, bi = port
    assert any("zero fill of the " + str(p // 2) in n for n in uni.notes)
    assert not any("zero fill" in n for n in bi.notes)
    assert f"{p} ranks on the CPU: the exchanges are host-memory copies, " \
        "not a fabric" in uni.notes


def test_min_bandwidth_gate_fails_as_reference(monkeypatch):
    ref, port = _records(2, monkeypatch, min_bandwidth=1e12,
                         bidirectional=False)
    assert len(port) == len(ref) == 1
    assert port[0].verdict.value == ref[0].verdict.value == "FAILURE"
    assert _notes(port[0]) == _notes(ref[0])
    assert port[0].metrics["checksum_ok"] == 1.0


def test_a_lost_copy_fails_the_checksum(monkeypatch):
    """A receiver that keeps its own shard instead of its sender's (a
    copy never made) must fail the Record."""
    real = tp2p.pair_exchange

    def lossy(shards, perm):
        out = real(shards, perm)
        out[perm[0][1]] = shards[perm[0][1]].clone()
        return out

    monkeypatch.setattr(tp2p, "pair_exchange", lossy)
    recs = tp2p.run_p2p(tmesh.default_mesh(4, "cpu"),
                        tp2p.P2PConfig(count=512, reps=1, warmup=0),
                        TWriter(stream=io.StringIO()))
    for rec in recs:
        assert rec.verdict is Verdict.FAILURE
        assert rec.metrics["checksum_ok"] == 0.0
        assert "checksum mismatch after exchange" in rec.notes


@pytest.mark.parametrize("p", [1, 3])
def test_odd_or_single_world_rejected(p):
    with pytest.raises(ValueError, match="even"):
        tp2p.run_p2p(tmesh.default_mesh(p, "cpu"), tp2p.P2PConfig(count=16))


def test_p2p_cli_two_sided(capsys, monkeypatch):
    """``p2p`` (two_sided, the default transport) on 4 CPU ranks writes
    both Records SUCCESS; 1 or 3 ranks the reference's SKIPPED Record;
    the placement flags are taken; the environment tier sets reps."""
    for var in ("REPS", "COUNT", "BIDIRECTIONAL"):
        monkeypatch.delenv("TPU_PATTERNS_" + var, raising=False)
    assert tcli.main(["p2p", "--device", "cpu", "--devices", "4", "--count",
                      "4096", "--reps", "2", "--warmup", "1"]) == 0
    out = capsys.readouterr().out
    assert "## unidirectional | 4dev x 0MB | SUCCESS" in out
    assert "## bidirectional | 4dev x 0MB | SUCCESS" in out
    for n in ("1", "3"):
        assert tcli.main(["p2p", "--device", "cpu", "--devices", n]) == 0
        assert f"## two_sided | devices={n} | SKIPPED" in \
            capsys.readouterr().out
    for placement in ("compact", "spread", "compact_plan"):
        for mechanism in ("mesh", "visible"):
            assert tcli.main(["p2p", "--device", "cpu", "--devices", "2",
                              "--count", "512", "--reps", "1",
                              "--bidirectional", "false", "--placement",
                              placement, "--mechanism", mechanism]) == 0
            out = capsys.readouterr().out
            assert "## unidirectional | 2dev x 0MB | SUCCESS" in out
            assert "bidirectional |" not in out.replace("## uni", "")
    monkeypatch.setenv("TPU_PATTERNS_REPS", "3")
    monkeypatch.setenv("TPU_PATTERNS_COUNT", "256")
    assert tcli.main(["p2p", "--device", "cpu", "--devices", "2"]) == 0
    assert "reps=3" in capsys.readouterr().out
    assert tcli.main(["p2p", "--device", "cpu", "--devices", "2",
                      "--reps", "1"]) == 0
    assert "reps=1" in capsys.readouterr().out


def test_p2p_cli_flags_are_the_references():
    """The port's p2p takes every flag of the reference's p2p, with the
    same defaults and choices."""
    from tpu_patterns import cli as jcli

    def flags(parser):
        sub = parser._subparsers._group_actions[0].choices["p2p"]
        return {a.dest: (a.default, tuple(a.choices or ()))
                for a in sub._actions if a.dest != "help"}

    ref, port = flags(jcli.build_parser()), flags(tcli.build_parser())
    assert set(ref) == set(port) - {"device"}
    for k, v in ref.items():
        assert port[k] == v, k
    assert torch.device(port["device"][0]).type == "cuda"
