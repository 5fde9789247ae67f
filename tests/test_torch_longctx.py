"""The port's sequence-parallel attention (``longctx/ring_attention.py``,
``ulysses.py``, ``pattern.py``) and its ``longctx`` CLI against the JAX
package's.

The same seeded numpy inputs (float32, L = 64, H = 4, D = 16) go through
the reference under ``shard_map`` over an ``sp`` axis of the conftest's
CPU mesh (its fused strategies in interpret mode, i.e. its XLA twins for
the ring and interpret-mode Pallas for Ulysses) and through the port on
a rank mesh of CPU ranks (the kernel wrappers' plain versions).
Tolerances: outputs within 1e-5 absolute; gradients within 1e-5 times
max |reference gradient|.  Records are held to the reference's count,
pattern, mode, commands, verdicts and metric keys (the inputs differ:
``jax.random`` there, a ``torch.Generator`` here)."""

import functools
import importlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_patterns import cli as jcli
from tpu_patterns.core.results import ResultWriter as JWriter
from tpu_patterns.longctx import attention as jatt
from tpu_patterns.longctx import pattern as jpat
from tpu_patterns.longctx.ring_attention import ring_attention as jring
from tpu_patterns.longctx.ulysses import ulysses_attention as julysses
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch.comm import mesh as tmesh
from tpu_patterns_torch.core.results import ResultWriter as TWriter
from tpu_patterns_torch.core.results import Verdict
from tpu_patterns_torch.core.timing import ChainMeasurement
from tpu_patterns_torch.longctx import attention as tatt
from tpu_patterns_torch.longctx import flash as tflash
from tpu_patterns_torch.longctx import pattern as tpat
from tpu_patterns_torch.longctx import ulysses as tuly

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

# the packages export ``ring_attention`` the function under the
# module's name
tring = importlib.import_module("tpu_patterns_torch.longctx.ring_attention")
jring_mod = importlib.import_module("tpu_patterns.longctx.ring_attention")

L, H, D = 64, 4, 16
OUT_ATOL = 1e-5
GRAD_RTOL = 1e-5  # of max |reference gradient|


def _arrays(seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((L, H, D)).astype(np.float32)
            for _ in range(n)]


def _jax_fn(attn, sp, vma=True, **kw):
    """The reference's shard-level ``attn`` as one shard_map program
    over the first ``sp`` CPU devices (global arrays in and out)."""
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    spec = P("sp", None, None)
    fn = jax.shard_map(
        functools.partial(attn, axis_name="sp", axis_size=sp, **kw),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=vma)
    sharding = NamedSharding(mesh, spec)
    return fn, lambda a: jax.device_put(jnp.asarray(a), sharding)


def _jax_out(attn, sp, arrays, vma=True, **kw):
    fn, put = _jax_fn(attn, sp, vma, **kw)
    return np.asarray(jax.jit(fn)(*(put(a) for a in arrays)))


def _jax_vjp(attn, sp, arrays, ct, vma=True, **kw):
    fn, put = _jax_fn(attn, sp, vma, **kw)
    grads = jax.jit(lambda c, *a: jax.vjp(fn, *a)[1](c))(
        put(ct), *(put(a) for a in arrays))
    return [np.asarray(g) for g in grads]


def _port_out(attn, sp, arrays, **kw):
    mesh = tmesh.default_mesh(sp, "cpu")
    with torch.no_grad():
        outs = attn(*(mesh.scatter(a) for a in arrays), **kw)
    return mesh.gather(outs).numpy()


def _port_vjp(attn, sp, arrays, ct, **kw):
    mesh = tmesh.default_mesh(sp, "cpu")
    leaves = [s.requires_grad_() for a in arrays for s in mesh.scatter(a)]
    outs = attn(leaves[:sp], leaves[sp:2 * sp], leaves[2 * sp:], **kw)
    grads = torch.autograd.grad(outs, leaves, grad_outputs=mesh.scatter(ct))
    return [mesh.gather(grads[i * sp:(i + 1) * sp]).numpy()
            for i in range(3)]


def _striped(arrays, sp):
    got = [tatt.stripe(a, sp) for a in arrays]
    for g, a in zip(got, arrays):
        np.testing.assert_array_equal(g, jatt.stripe(a, sp))
    return got


def _close_grads(got, want):
    for name, g, w in zip("dq dk dv".split(), got, want):
        tol = GRAD_RTOL * float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= tol, name


# -- forward parity -------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_impl", ["xla", "pallas"])
@pytest.mark.parametrize("sp,layout", [
    (1, "contiguous"), (2, "contiguous"), (4, "contiguous"), (4, "striped")])
def test_ring_attention_matches_reference(sp, layout, block_impl, causal):
    arrays = _arrays(sp * 10 + causal)
    if layout == "striped":
        arrays = _striped(arrays, sp)
    want = _jax_out(jring, sp, arrays, vma=block_impl == "xla",
                    causal=causal, block_impl=block_impl, interpret=True,
                    layout=layout)
    got = _port_out(tring.ring_attention, sp, arrays, causal=causal,
                    block_impl=block_impl, layout=layout)
    assert float(np.abs(got - want).max()) <= OUT_ATOL
    if layout == "striped":  # and in global order, the dense attention
        dense = np.asarray(jatt.attention_reference(
            *(jnp.asarray(tpat._unstripe(a, sp)) for a in arrays),
            causal=causal))
        assert float(np.abs(tpat._unstripe(got, sp) - dense).max()) <= (
            OUT_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_impl", ["xla", "pallas"])
@pytest.mark.parametrize("sp", [1, 2, 4])
def test_ulysses_matches_reference(sp, block_impl, causal):
    arrays = _arrays(sp * 20 + causal)
    want = _jax_out(julysses, sp, arrays, vma=block_impl == "xla",
                    causal=causal, block_impl=block_impl)
    got = _port_out(tuly.ulysses_attention, sp, arrays, causal=causal,
                    block_impl=block_impl)
    assert float(np.abs(got - want).max()) <= OUT_ATOL


def test_run_sharded_launchers_match_reference():
    arrays = _arrays(5)
    jmesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    from tpu_patterns.longctx import ulysses as ju

    mesh = tmesh.default_mesh(4, "cpu")
    for jmod, tmod in ((jring_mod, tring), (ju, tuly)):
        want = np.asarray(jmod.run_sharded(*arrays, jmesh, causal=True))
        got = tmod.run_sharded(*arrays, mesh, causal=True).numpy()
        assert float(np.abs(got - want).max()) <= OUT_ATOL


def test_ulysses_refuses_indivisible_heads_as_reference():
    xs = [torch.zeros(16, 3, D) for _ in range(4)]
    with pytest.raises(ValueError, match="heads 3 not divisible by sp axis"):
        tuly.ulysses_attention(xs, xs, xs)


# -- gradients: the second ring and Ulysses ------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("layout", ["contiguous", "striped"])
def test_ring_flash_second_ring_gradients_match_reference(layout, causal):
    """sp 4: a shift of +1 differs from -1 there, so a wrong direction or
    count of the dk/dv accumulators' shifts shows."""
    sp = 4
    *arrays, ct = _arrays(40 + causal, 4)
    if layout == "striped":
        arrays = _striped(arrays, sp)
        ct = tatt.stripe(ct, sp)
    want = _jax_vjp(jring, sp, arrays, ct, vma=False, causal=causal,
                    block_impl="pallas", interpret=True, layout=layout)
    got = _port_vjp(tring.ring_attention, sp, arrays, ct, causal=causal,
                    block_impl="pallas", layout=layout)
    _close_grads(got, want)


@pytest.mark.parametrize("block_impl", ["xla", "pallas"])
@pytest.mark.parametrize("sp", [2, 4])
def test_ulysses_gradients_match_reference(sp, block_impl):
    *arrays, ct = _arrays(50 + sp, 4)
    want = _jax_vjp(julysses, sp, arrays, ct, vma=block_impl == "xla",
                    causal=True, block_impl=block_impl)
    got = _port_vjp(tuly.ulysses_attention, sp, arrays, ct, causal=True,
                    block_impl=block_impl)
    _close_grads(got, want)


def test_plain_ring_gradients_match_reference():
    *arrays, ct = _arrays(60, 4)
    want = _jax_vjp(jring, 4, arrays, ct, causal=True)
    got = _port_vjp(tring.ring_attention, 4, arrays, ct, causal=True)
    _close_grads(got, want)


def test_fused_ring_calls_each_block_kernel_sp_squared_times(monkeypatch):
    """Every (rank, step) block is launched, the wholly masked ones too:
    sp^2 K3 forward and sp^2 K4 (dq and dk/dv) backward."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tflash.flash_block, tflash.flash_block_bwd

    def count(kind, fn):
        def wrapped(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tflash, "flash_block", count("fwd", fwd))
    monkeypatch.setattr(tflash, "flash_block_bwd", count("bwd", bwd))
    *arrays, ct = _arrays(70, 4)
    _port_vjp(tring.ring_attention, 4, arrays, ct, causal=True,
              block_impl="pallas")
    assert calls == {"fwd": 16, "bwd": 16}


# -- the pattern's pieces -----------------------------------------------


def test_pieces_equal_reference():
    ref = _arrays(80, 1)[0]
    diff = (_arrays(81, 1)[0] * 1e-6).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        jc = jpat.LongCtxConfig(dtype=dtype)
        tc = tpat.LongCtxConfig(dtype=dtype)
        assert tpat._eps_effective(tc) == jpat._eps_effective(jc)
        for depth in (1, 4):
            assert dataclasses_equal(tpat._gates(tc, ref, depth),
                                     jpat._gates(jc, ref, depth))
        for width in (None, 2.0, 8.0):
            tg = tpat._grad_gates(tc, ref, width)
            jg = jpat._grad_gates(jc, ref, width)
            assert dataclasses_equal(tg, jg)
            assert tg.check_elem(diff, ref) == jg.check_elem(diff, ref)
            assert tg.width_needed(diff, ref) == jg.width_needed(diff, ref)
        assert tpat._gates(tc, ref).width_needed(diff, ref) is None
    assert tpat._gate_width_eps() == jpat._gate_width_eps() == 8.0
    assert tpat._rms(ref) == jpat._rms(ref)
    assert tpat.GRAD_FLOP_MULT == jpat.GRAD_FLOP_MULT
    assert tpat.GRAD_HW_FLOP_MULT == jpat.GRAD_HW_FLOP_MULT
    assert (tpat.GRAD_HW_FLOP_MULT_DEFAULT
            == jpat.GRAD_HW_FLOP_MULT_DEFAULT)
    assert set(tpat.STRATEGIES) == set(jpat.STRATEGIES)
    assert tpat.STRIPED == jpat.STRIPED
    for args in ((4096, 8, 128, True), (64, 4, 16, False), (100, 3, 8, True)):
        assert tpat.attention_flops(*args) == jpat.attention_flops(*args)
    for sp in (1, 2, 4):
        striped = tatt.stripe(ref, sp)
        np.testing.assert_array_equal(striped, jatt.stripe(ref, sp))
        np.testing.assert_array_equal(
            tatt.stripe(torch.from_numpy(ref), sp).numpy(), striped)
        np.testing.assert_array_equal(tpat._unstripe(striped, sp),
                                      jpat._unstripe(striped, sp))
        np.testing.assert_array_equal(tpat._unstripe(striped, sp), ref)


def dataclasses_equal(a, b) -> bool:
    return (a.rtol, a.atol, a.rms, a.unit_atol) == (
        b.rtol, b.atol, b.rms, b.unit_atol)


def test_config_fields_match_reference():
    import dataclasses

    want = {f.name: f.default for f in dataclasses.fields(jpat.LongCtxConfig)}
    got = {f.name: f.default for f in dataclasses.fields(tpat.LongCtxConfig)}
    assert got == {**want, "device": "cuda"}


@pytest.mark.parametrize("causal,chunk", [(True, 32), (False, 2048)])
def test_reference_blockwise_matches_reference(monkeypatch, causal, chunk):
    q, k, v = _arrays(90)
    for mod in (jpat, tpat):  # 32: two chunks a side
        monkeypatch.setattr(mod, "REF_CHUNK", chunk)
    want = jpat.reference_blockwise(q, k, v, causal)
    got = tpat.reference_blockwise(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal)
    assert float(np.abs(got - want).max()) <= OUT_ATOL


def test_compact_grid_refused_without_causal_as_reference():
    for mod in (jpat, tpat):
        cfg = mod.LongCtxConfig(causal=False, causal_grid="compact")
        with pytest.raises(ValueError, match="requires --causal true"):
            mod._resolve_strategy("flash", cfg)
        mod._resolve_strategy("ring_pallas", cfg)  # no grid_mode there


# -- the runners' Records -----------------------------------------------

SP4 = ("ring", "ring_pallas", "ring_striped", "ulysses", "ulysses_pallas")


def _notes(rec):
    return [n for n in rec.notes
            if "noise-bound" not in n and "not a fabric" not in n]


def _run_both(sp, **kw):
    cfg = dict(seq=L, heads=H, head_dim=D, reps=2, warmup=1, **kw)
    ref = jpat.run_longctx(Mesh(np.array(jax.devices()[:sp]), ("sp",)),
                           jpat.LongCtxConfig(**cfg),
                           JWriter(stream=io.StringIO()))
    port = tpat.run_longctx(tmesh.default_mesh(sp, "cpu"),
                            tpat.LongCtxConfig(device="cpu", **cfg),
                            TWriter(stream=io.StringIO()))
    return ref, port


@pytest.mark.parametrize("grad", [False, True])
def test_run_longctx_records_match_reference(grad):
    ref, port = _run_both(4, grad=grad, strategies=SP4)
    assert len(port) == len(ref) == len(SP4) + (not grad)
    for got, want in zip(port, ref):
        assert (got.pattern, got.mode, got.commands, got.verdict.value) == (
            want.pattern, want.mode, want.commands, want.verdict.value)
        assert got.verdict is Verdict.SUCCESS, got.notes
        assert set(got.metrics) == set(want.metrics)
        assert _notes(got) == _notes(want)
        if grad:
            assert got.config == {"dtype": "float32", "device": "cpu"}
            for key in ("hw_flop_mult", "flops", "gate_width_eps"):
                assert got.metrics[key] == want.metrics[key], key
        elif got.mode != "agreement":
            assert got.metrics["flops"] == want.metrics["flops"]
            assert got.metrics["max_abs_err"] <= OUT_ATOL
    if grad:
        assert all("4 ranks on the CPU" in " ".join(r.notes) for r in port)


def test_run_longctx_refusals_match_reference():
    mesh = tmesh.default_mesh(4, "cpu")
    jmesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    for kw, match in ((dict(seq=66), "seq 66 not divisible by sp=4"),
                      (dict(heads=6, strategies=("ulysses",)),
                       "heads 6 not divisible by sp=4"),
                      (dict(strategies=("flash",)), "single-device")):
        with pytest.raises(ValueError, match=match):
            jpat.run_longctx(jmesh, jpat.LongCtxConfig(**kw))
        with pytest.raises(ValueError, match=match):
            tpat.run_longctx(mesh, tpat.LongCtxConfig(device="cpu", **kw))


def test_tflops_hw_bound_counts_cards_not_ranks(monkeypatch):
    """Four ranks on one device may not claim four devices' peak: at a
    fixed per-op time the silicon rate sits between one and four peaks,
    and the Record must fail."""
    from tpu_patterns_torch import runtime

    per_op_ns = 1e3
    cfg = tpat.LongCtxConfig(seq=L, heads=H, head_dim=D, reps=1, warmup=0,
                             grad=True, strategies=("ring_pallas",),
                             device="cpu")
    rate = (tpat.attention_flops(L, H, D, True) * 4.5 / per_op_ns / 1e3)
    monkeypatch.setattr(tpat.timing, "measure_chain",
                        lambda *a, **kw: ChainMeasurement(per_op_ns))
    for peak, verdict in ((rate / 2, Verdict.FAILURE),
                          (rate * 2, Verdict.SUCCESS)):
        monkeypatch.setattr(runtime, "chip_peak_tflops",
                            lambda dtype=None, device="cuda", p=peak: p)
        (rec,) = tpat.run_longctx(tmesh.default_mesh(4, "cpu"), cfg,
                                  TWriter(stream=io.StringIO()))
        assert rec.metrics["tflops_hw"] == pytest.approx(rate)
        assert rec.verdict is verdict, rec.notes
        if verdict is Verdict.FAILURE:
            assert any("exceeds 1-card peak" in n for n in rec.notes)


# -- the CLI -----------------------------------------------------------------


def _cli(main, argv, tmp_path, name):
    jl = tmp_path / f"{name}.jsonl"
    rc = main(["--jsonl", str(jl), *argv])
    with open(jl) as f:
        return rc, [json.loads(ln) for ln in f]


SMALL = ["--seq", "64", "--heads", "4", "--head_dim", "16", "--reps", "2",
         "--warmup", "1"]


@pytest.mark.parametrize("argv", [
    ["--devices", "4"],
    ["--devices", "1"],
], ids=["both4", "both1"])
def test_cli_longctx_runs_as_reference(tmp_path, argv):
    rc, port = _cli(tcli.main, ["longctx", "--device", "cpu", *SMALL, *argv],
                    tmp_path, "port")
    jrc, ref = _cli(jcli.main, ["longctx", *SMALL, *argv], tmp_path, "ref")
    assert rc == jrc == 0
    assert [(r["mode"], r["commands"], r["verdict"]) for r in port] == [
        (r["mode"], r["commands"], r["verdict"]) for r in ref]
    assert all(r["verdict"] == "SUCCESS" for r in port)
    assert [sorted(r["metrics"]) for r in port] == [
        sorted(r["metrics"]) for r in ref]


@pytest.mark.parametrize("argv", [
    ["--devices", "4", "--seq", "66"],
    ["--devices", "4", "--heads", "6", "--strategy", "ulysses"],
    ["--devices", "4", "--heads", "6", "--strategy", "ulysses_pallas"],
    ["--devices", "4", "--heads", "6"],
    ["--devices", "2", "--strategy", "flash"],
], ids=["seq", "heads_ulysses", "heads_ulysses_pallas", "heads_both",
        "flash2"])
def test_cli_world_skips_match_reference(tmp_path, argv):
    base = ["--head_dim", "16", "--reps", "1", "--warmup", "0"]
    argv = ["--seq", "64", "--heads", "4", *base, *argv]
    rc, port = _cli(tcli.main, ["longctx", "--device", "cpu", *argv],
                    tmp_path, "port")
    jrc, ref = _cli(jcli.main, ["longctx", *argv], tmp_path, "ref")
    assert rc == jrc == 0
    keys = ("pattern", "mode", "commands", "verdict", "notes")
    assert [[r[k] for k in keys[:4]] + [_notes_of(r)] for r in port] == [
        [r[k] for k in keys[:4]] + [_notes_of(r)] for r in ref]


def _notes_of(rec: dict) -> list:
    return [n for n in rec["notes"]
            if "noise-bound" not in n and "not a fabric" not in n]


def test_cli_takes_every_flag_of_the_reference():
    def flags(parser):
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return {o for a in sub.choices["longctx"]._actions
                for o in a.option_strings}

    assert flags(jcli.build_parser()) <= flags(tcli.build_parser())
