"""The port's parallelism patterns (``parallel/overlap.py``,
``pipeline.py``, ``moe.py``), the library collectives they use
(``comm/ring.py``) and the ``overlap``, ``pipeline`` and ``moe`` CLI
against the JAX package's.

The same seeded numpy inputs (float32) go through the reference under
``shard_map`` over the first n devices of the conftest's CPU mesh and
through the port on a rank mesh of n CPU ranks.  Tolerances: the
collectives and the all-gather matmul within 1e-5 absolute; the
reduce-scatter matmul (whose partial sums add in another order),
pipeline outputs, losses and gradients within 1e-5 times
max(1, max |reference|); MoE outputs within 1e-5
absolute, with equal dispatch statistics and exact zeros for dropped
tokens.  Records are held to the reference's count, pattern, mode,
commands, verdicts and metric keys (the inputs differ: ``jax.random``
there, a ``torch.Generator`` here)."""

import contextlib
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_patterns import cli as jcli
from tpu_patterns.core.results import ResultWriter as JWriter
from tpu_patterns.parallel import moe as jmoe
from tpu_patterns.parallel import overlap as jov
from tpu_patterns.parallel import pipeline as jpipe
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch.comm import mesh as tmesh
from tpu_patterns_torch.comm import ring as tring
from tpu_patterns_torch.core.results import ResultWriter as TWriter
from tpu_patterns_torch.core.results import Verdict
from tpu_patterns_torch.parallel import moe as tmoe
from tpu_patterns_torch.parallel import overlap as tov
from tpu_patterns_torch.parallel import pipeline as tpipe

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

ATOL = 1e-5
RTOL_OF_MAX = 1e-5


def _jmesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("x",))


def _jax(fn, n, in_specs, out_specs, *arrays, vma=True):
    """``fn`` (a shard-level function) as one shard_map program over the
    first n CPU devices, on global arrays."""
    mesh = _jmesh(n)
    f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs, check_vma=vma))
    args = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, s))
            for a, s in zip(arrays, in_specs)]
    return jax.tree.map(np.asarray, f(*args))


def _cut(a, n, dim):
    """The port's shards of a global numpy array along ``dim``."""
    return [torch.from_numpy(np.ascontiguousarray(b))
            for b in np.split(a, n, axis=dim)]


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- the library collectives ------------------------------------------------


COLLECTIVES = {
    # name: (reference body, port function, in dim, out dim)
    "all_gather": (lambda x: lax.all_gather(x, "x", axis=1, tiled=True),
                   lambda xs: tring.library_all_gather(xs, 1)),
    "reduce_scatter": (
        lambda x: lax.psum_scatter(x, "x", scatter_dimension=1, tiled=True),
        lambda xs: tring.library_reduce_scatter(xs, 1)),
    "all_to_all": (
        lambda x: lax.all_to_all(x, "x", split_axis=1, concat_axis=0,
                                 tiled=True),
        lambda xs: tring.all_to_all(xs, split=1, concat=0)),
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_library_collectives_match_reference(name, n):
    jfn, tfn = COLLECTIVES[name]
    a = _normal(n, 4 * n, 8 * n)
    # each rank's [4, 8n] row block; results gathered along the rows
    want = _jax(jfn, n, (P("x", None),), P("x", None), a, vma=False)
    got = torch.cat(tfn(_cut(a, n, 0))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# -- overlap ------------------------------------------------------------------


@pytest.mark.parametrize("decomposed", [False, True])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("kind", ["ag", "rs"])
def test_collective_matmul_matches_reference(kind, n, decomposed):
    if kind == "ag":
        x, w = _normal(1, 4 * n, 32), _normal(2, 32, 8 * n)
        specs, out_spec, dims, cat = ((P("x", None), P(None, "x")),
                                      P(None, "x"), (0, 1), 1)
        jfn, tfn = jov.allgather_matmul, tov.allgather_matmul
    else:
        x, w = _normal(3, 4 * n, 32 * n), _normal(4, 32 * n, 8)
        specs, out_spec, dims, cat = ((P(None, "x"), P("x", None)),
                                      P("x", None), (1, 0), 0)
        jfn, tfn = jov.matmul_reducescatter, tov.matmul_reducescatter
    want = _jax(functools.partial(jfn, axis_name="x", axis_size=n,
                                  decomposed=decomposed),
                n, specs, out_spec, x, w)
    outs = tfn(_cut(x, n, dims[0]), _cut(w, n, dims[1]),
               decomposed=decomposed)
    got = torch.cat(outs, cat).numpy()
    if kind == "ag":  # the same products, block by block
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    else:  # the ranks' partial sums are added in another order
        _close_of_max(got, want)
    _close_of_max(got, x @ w)


# -- pipeline -----------------------------------------------------------------

N_MICRO, B, D = 8, 4, 16


def _stage(mod):
    tanh = torch.tanh if mod is torch else jnp.tanh
    return lambda w, a: tanh(a @ w[0])


@pytest.fixture(scope="module")
def pipe_data():
    return _normal(5, 4, D, D) * 0.5, _normal(6, N_MICRO, B, D)


def _jax_pipeline(pp, sharded, what, w, micro):
    stage = _stage(jnp)
    wspec = P("x", None, None)
    mspec = P("x", None, None) if sharded else P()
    if what == "apply":
        body = functools.partial(jpipe.pipeline_apply, stage, axis_name="x",
                                 axis_size=pp, micro_sharded=sharded)
        return _jax(body, pp, (wspec, mspec), P(), w, micro)
    if what == "gpipe":
        def loss(wv, mv):
            out = jpipe.pipeline_apply(stage, wv, mv, "x", pp,
                                       micro_sharded=sharded)
            return jnp.sum(out ** 2)

        return _jax(jax.value_and_grad(loss), pp, (wspec, mspec),
                    (P(), wspec), w, micro)

    def out_grad(y):
        return jnp.sum(y ** 2), 2.0 * y

    body = functools.partial(jpipe.pipeline_train_1f1b, stage,
                             axis_name="x", axis_size=pp,
                             out_grad_fn=out_grad, micro_sharded=sharded)
    return _jax(body, pp, (wspec, mspec), (P(), wspec), w, micro)


def _port_pipeline(pp, sharded, what, w, micro):
    stage = _stage(torch)
    ws = _cut(w, pp, 0)
    ms = (_cut(micro, pp, 0) if sharded
          else [torch.from_numpy(micro.copy()) for _ in range(pp)])
    if what == "apply":
        outs = tpipe.pipeline_apply(stage, ws, ms, sharded)
        for o in outs[1:]:  # replicated on every rank
            torch.testing.assert_close(o, outs[0], rtol=0, atol=0)
        return outs[0].numpy()
    if what == "gpipe":
        leaves = [p.requires_grad_() for p in ws]
        out = tpipe.pipeline_apply(stage, leaves, ms, sharded)
        loss = (out[0] ** 2).sum()
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), torch.cat(grads).numpy()
    losses, grads = tpipe.pipeline_train_1f1b(
        stage, ws, ms, lambda y: ((y ** 2).sum(), 2.0 * y), sharded)
    assert all(float(x) == float(losses[0]) for x in losses)
    return float(losses[0]), torch.cat(grads).numpy()


def _close_of_max(got, want):
    tol = RTOL_OF_MAX * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(np.asarray(got) - want).max()) <= tol


@pytest.mark.parametrize("what", ["apply", "gpipe", "1f1b"])
@pytest.mark.parametrize("sharded", [True, False],
                         ids=["sharded", "replicated"])
@pytest.mark.parametrize("pp", [2, 4])
def test_pipeline_matches_reference(pipe_data, pp, sharded, what):
    w, micro = pipe_data
    w = w[:pp]
    want = _jax_pipeline(pp, sharded, what, w, micro)
    got = _port_pipeline(pp, sharded, what, w, micro)
    if what == "apply":
        _close_of_max(got, want)
        return
    # the loss and each stage's gradient: through the ring copies on
    # the autograd tape (gpipe) or the explicit backward slots (1f1b)
    _close_of_max(got[0], np.asarray(want[0]))
    _close_of_max(got[1], want[1])


@pytest.mark.parametrize("pp,n_micro", [(1, 3), (2, 2), (4, 8), (8, 4)])
def test_schedule_accounting_matches_reference(pp, n_micro):
    for schedule in ("gpipe", "1f1b"):
        assert tpipe.bubble_fraction(schedule, pp, n_micro) == \
            jpipe.bubble_fraction(schedule, pp, n_micro)
        assert tpipe.peak_stash_microbatches(schedule, pp, n_micro) == \
            jpipe.peak_stash_microbatches(schedule, pp, n_micro)
    with pytest.raises(ValueError, match="unknown schedule"):
        tpipe.bubble_fraction("zb", pp, n_micro)


# -- moe ----------------------------------------------------------------------

T, E = 16, 16


@pytest.mark.parametrize("cf", [0.0, 2.0, 1.0])
@pytest.mark.parametrize("ep", [4, 8])
def test_moe_matches_reference(ep, cf):
    we, wg, xs = _normal(7, ep, E, E) * 0.3, _normal(8, E, ep), \
        _normal(9, ep * T, E)
    body = functools.partial(jmoe.moe_apply, _stage(jnp), axis_name="x",
                             axis_size=ep, capacity_factor=cf)
    want = _jax(body, ep, (P("x", None, None), P(), P("x", None)),
                P("x", None), we, wg, xs)
    got = torch.cat(tmoe.moe_apply(
        _stage(torch), _cut(we, ep, 0), torch.from_numpy(wg),
        _cut(xs, ep, 0), capacity_factor=cf)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    cap = tmoe.capacity(T, ep, cf)
    assert cap == jmoe.capacity(T, ep, cf)
    dropped = 0
    for r in range(ep):
        xb = xs[r * T:(r + 1) * T]
        t_hot, t_w = tmoe.top1_route(torch.from_numpy(xb),
                                     torch.from_numpy(wg))
        j_hot, j_w = jmoe.top1_route(jnp.asarray(xb), jnp.asarray(wg))
        np.testing.assert_array_equal(t_hot.numpy(), np.asarray(j_hot))
        np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), atol=ATOL)
        t_drop, t_per = tmoe.dispatch_stats(t_hot, cap)
        j_drop, j_per = jmoe.dispatch_stats(j_hot, cap)
        assert int(t_drop) == int(j_drop)
        np.testing.assert_array_equal(t_per.numpy(), np.asarray(j_per))
        np.testing.assert_array_equal(
            tmoe.build_dispatch(t_hot, cap, torch.float32).numpy(),
            np.asarray(jmoe.build_dispatch(j_hot, cap, jnp.float32)))
        np.testing.assert_array_equal(
            tmoe.build_dispatch_column(t_hot, r % ep, cap,
                                       torch.float32).numpy(),
            np.asarray(jmoe.build_dispatch_column(j_hot, r % ep, cap,
                                                  jnp.float32)))
        dropped += int(t_drop)
    # dropped tokens: exactly zero rows, in both packages
    zero_rows = np.all(want == 0, axis=1)
    assert int(zero_rows.sum()) == dropped
    assert np.all(got[zero_rows] == 0)
    if cf == 1.0:
        assert dropped > 0, "the binding factor must drop tokens"
    # the host replay agrees with both
    h_want, h_dropped = tmoe.host_reference(
        torch.from_numpy(we), torch.from_numpy(wg), torch.from_numpy(xs),
        ep, cap)
    assert h_dropped == dropped
    np.testing.assert_allclose(got, h_want, rtol=0, atol=ATOL)


def test_top1_route_counts_in_int32():
    """The reference's test of the same name, in bfloat16: slot counting
    must not happen in the token dtype (a bf16 cumsum stops at 256)."""
    x = torch.ones((300, 8), dtype=torch.bfloat16)
    wg = torch.zeros((8, 4), dtype=torch.bfloat16)
    wg[0, 0] = 100.0
    onehot, weight = tmoe.top1_route(x, wg)
    assert onehot.dtype == torch.int32
    assert weight.dtype == torch.bfloat16
    slots = tmoe._slot_indices(onehot)
    assert not slots.dtype.is_floating_point
    assert len(np.unique(slots.numpy())) == 300
    np.testing.assert_array_equal(
        slots.numpy(),
        np.asarray(jmoe._slot_indices(jnp.asarray(onehot.numpy()))))


def test_moe_refuses_a_gate_of_another_width():
    xs = [torch.zeros((4, 8)) for _ in range(4)]
    with pytest.raises(ValueError, match="gate has 2 experts"):
        tmoe.moe_apply(_stage(torch), [torch.zeros((1, 8, 8))] * 4,
                       torch.zeros((8, 2)), xs)


# -- the measured patterns ---------------------------------------------------


def _ref_and_port(name, n, **cfg):
    jrun, jcfg, trun, tcfg = {
        "overlap": (jov.run_overlap, jov.OverlapConfig, tov.run_overlap,
                    tov.OverlapConfig),
        "pipeline": (jpipe.run_pipeline, jpipe.PipelineConfig,
                     tpipe.run_pipeline, tpipe.PipelineConfig),
        "moe": (jmoe.run_moe, jmoe.MoEConfig, tmoe.run_moe,
                tmoe.MoEConfig),
    }[name]
    ref = jrun(_jmesh(n), jcfg(**cfg), JWriter(stream=io.StringIO()))
    port = trun(tmesh.default_mesh(n, "cpu"), tcfg(device="cpu", **cfg),
                TWriter(stream=io.StringIO()))
    return ref, port


SMALL = {
    "overlap": dict(rows=8, contract=32, cols=16, dtype="float32", reps=2,
                    warmup=1),
    "pipeline": dict(batch=2, dim=16, reps=2, warmup=1),
    "moe": dict(tokens=16, dim=16, reps=2, warmup=1),
}


def _notes(rec):
    return [n for n in rec.notes
            if "noise-bound" not in n and "not a fabric" not in n]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_run_records_match_reference(name):
    ref, port = _ref_and_port(name, 4, **SMALL[name])
    assert len(port) == len(ref) == {"overlap": 2, "pipeline": 2,
                                     "moe": 3}[name]
    for got, want in zip(port, ref):
        assert (got.pattern, got.mode, got.commands, got.verdict.value) == (
            want.pattern, want.mode, want.commands, want.verdict.value)
        assert got.verdict is Verdict.SUCCESS, got.notes
        assert set(got.metrics) == set(want.metrics)
        assert _notes(got) == _notes(want)
        assert any("4 ranks on the CPU" in n for n in got.notes)
    keys = {"overlap": ("ring_bytes",),
            "pipeline": ("bubble_fraction", "peak_stash_microbatches",
                         "peak_stash_bytes"),
            "moe": ("capacity", "capacity_factor", "total_tokens",
                    "a2a_bytes")}[name]
    for got, want in zip(port, ref):
        for key in keys:
            assert got.metrics[key] == want.metrics[key], key


def test_overlap_divergence_is_failure(monkeypatch):
    """A broken decomposition must fail the Record, as the reference's
    test holds of its own."""
    orig = tov.allgather_matmul

    def broken(xs, ws, decomposed=True):
        out = orig(xs, ws, decomposed)
        return [o + 1.0 for o in out] if decomposed else out

    monkeypatch.setattr(tov, "allgather_matmul", broken)
    (rec,) = tov.run_overlap(
        tmesh.default_mesh(4, "cpu"),
        tov.OverlapConfig(rows=8, contract=32, cols=16, dtype="float32",
                          pattern="ag", reps=2, warmup=1, device="cpu"),
        TWriter(stream=io.StringIO()))
    assert rec.verdict is Verdict.FAILURE
    assert any("diverges" in n for n in rec.notes)


def test_pipeline_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="n_micro 6 not divisible by pp=4"):
        tpipe.run_pipeline(tmesh.default_mesh(4, "cpu"),
                           tpipe.PipelineConfig(n_micro=6, device="cpu"),
                           TWriter(stream=io.StringIO()))


# -- the CLI -----------------------------------------------------------------


def _flags(parser, cmd):
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {o for a in sub.choices[cmd]._actions for o in a.option_strings}


@pytest.mark.parametrize("cmd", ["overlap", "pipeline", "moe"])
def test_cli_takes_every_flag_of_the_reference(cmd):
    assert _flags(jcli.build_parser(), cmd) <= _flags(tcli.build_parser(),
                                                       cmd)
    args = tcli.build_parser().parse_args([cmd])
    assert (args.devices, args.device) == (0, "cuda")


def _cli(main, argv, tmp_path, name):
    jl = tmp_path / f"{name}.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = main(["--jsonl", str(jl), *argv])
    with open(jl) as f:
        return rc, [json.loads(ln) for ln in f]


def test_cli_pipeline_world_skip_matches_reference(tmp_path):
    argv = ["pipeline", "--devices", "3"]
    rc, port = _cli(tcli.main, [*argv, "--device", "cpu"], tmp_path, "port")
    jrc, ref = _cli(jcli.main, argv, tmp_path, "ref")
    assert rc == jrc == 0
    keys = ("pattern", "mode", "commands", "verdict", "notes")
    assert [[r[k] for k in keys] for r in port] == [
        [r[k] for k in keys] for r in ref]
    assert port[0]["verdict"] == "SKIPPED"


CLI_RUNS = {
    "overlap": ["--rows", "8", "--contract", "32", "--cols", "16",
                "--dtype", "float32", "--pattern", "rs"],
    "pipeline": ["--batch", "2", "--dim", "16", "--schedule", "1f1b",
                 "--micro_sharded", "false"],
    "moe": ["--tokens", "16", "--dim", "16", "--capacity_factor", "1.0",
            "--capacity_factor", "0"],
}


@pytest.mark.parametrize("cmd", sorted(CLI_RUNS))
def test_cli_runs_on_cpu_ranks(tmp_path, cmd):
    argv = [cmd, "--device", "cpu", "--devices", "4", "--reps", "1",
            "--warmup", "0", *CLI_RUNS[cmd]]
    rc, recs = _cli(tcli.main, argv, tmp_path, cmd)
    assert rc == 0
    modes = {"overlap": ["rs"], "pipeline": ["1f1b"],
             "moe": ["cf1.0", "exact"]}[cmd]
    assert [r["mode"] for r in recs] == modes
    assert all(r["verdict"] == "SUCCESS" for r in recs)


def test_entry_points_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tov.run_overlap(),
                 lambda: tpipe.run_pipeline(),
                 lambda: tmoe.run_moe(),
                 lambda: tcli.main(["overlap"]),
                 lambda: tcli.main(["pipeline", "--devices", "4"]),
                 lambda: tcli.main(["moe"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
