"""The port's dense decoder and ``decode`` pattern against the JAX
package's on the CPU.

The same seeded numpy weights and inputs go through the reference on a
(1, 1, 1) mesh and through the port on ``device="cpu"``.  Float32
outputs agree within 64 float32 eps of their magnitude (the reference's
own teacher-forcing bound: both sides do float32 math, summed in
different orders); with an int8 cache the quantized values are equal
bit for bit, their float32 scales within 64 eps (each is a max over
k/v projections that the two sides round apart by an ulp or two), and
the outputs agree within 1e-5 of their magnitude.
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_patterns import cli as jcli
from tpu_patterns.models import decode as jdec
from tpu_patterns.models import transformer as jtr
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch.convert import block_params_from_jax
from tpu_patterns_torch.core.results import ResultWriter
from tpu_patterns_torch.models import decode as tdec
from tpu_patterns_torch.models import transformer as ttr

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

EPS64 = 64 * np.finfo(np.float32).eps
B, LP, GEN = 3, 16, 4
LENS = np.array([LP, 11, 5], np.int32)
VARIANTS = {
    "mha": dict(),
    "gqa_rope": dict(kv_heads=2, rope=True),
    "rope_int8": dict(rope=True),
    "gqa_int8": dict(kv_heads=2),
}


def _cfgs(**kw):
    base = dict(embed=64, heads=8, head_dim=8, dtype="float32", depth=2,
                causal=True)
    base.update(kw)
    return jtr.ModelConfig(**base), ttr.ModelConfig(**base)


def _scaled_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(np.asarray(got, np.float32) - want).max()) / scale


@pytest.fixture(scope="module")
def mesh(devices):
    return Mesh(np.array(devices[:1]).reshape(1, 1, 1), ("dp", "sp", "tp"))


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def decoded(mesh):
    """Per variant: the reference's prefill and generate outputs,
    lockstep and ragged, on the weights and inputs handed to the port."""
    out = {}
    for name, kw in VARIANTS.items():
        int8 = name.endswith("int8")
        jcfg, tcfg = _cfgs(**kw)
        flat = _np_tree(jdec._stacked_params(jax.random.key(3), jcfg))
        x = np.random.RandomState(4).randn(B, LP, 64).astype(np.float32)
        pre, gen = jdec.make_decoder(mesh, jcfg, B, LP, GEN,
                                     cache_int8=int8)
        runs = {}
        for mode, lens, t0 in (("lockstep", None, LP),
                               ("ragged", LENS, (LENS, 0))):
            c, y0 = pre(flat, jnp.asarray(x),
                        None if lens is None else jnp.asarray(lens))
            c2, ys = gen(flat, c, y0, t0, GEN)
            runs[mode] = (_np_tree(c), np.asarray(y0), _np_tree(c2),
                          np.asarray(ys))
        out[name] = (tcfg, flat, x, int8, runs)
    return out


@pytest.mark.parametrize("mode", ["lockstep", "ragged"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_make_decoder_matches_reference(decoded, name, mode):
    tcfg, flat, x, int8, runs = decoded[name]
    jc, jy0, jc2, jys = runs[mode]
    params = block_params_from_jax(flat, tcfg)
    pre, gen = tdec.make_decoder(tcfg, B, LP, GEN, cache_int8=int8)
    if mode == "lockstep":
        c, y0 = pre(params, torch.from_numpy(x))
        t0 = LP
    else:
        c, y0 = pre(params, torch.from_numpy(x), torch.from_numpy(LENS))
        t0 = (torch.from_numpy(LENS), 0)
    prefill_cache = {k: v.clone() for k, v in c.items()}
    c2, ys = gen(params, c, y0, t0, GEN)
    # donate=False: the caller's cache is left as prefill made it
    for k in c:
        assert torch.equal(c[k], prefill_cache[k])
    tol = 1e-5 if int8 else EPS64
    assert tuple(ys.shape) == jys.shape == (B, GEN, 64)
    assert _scaled_err(y0, jy0) <= tol
    assert _scaled_err(ys, jys) <= tol
    for got, want in ((c, jc), (c2, jc2)):
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            if int8 and k in ("k", "v"):  # the quantized values
                np.testing.assert_array_equal(got[k].numpy(), want[k])
            else:  # float caches and the int8 scales
                assert _scaled_err(got[k], want[k]) <= EPS64


def test_donated_generate_updates_the_cache_in_place():
    _, tcfg = _cfgs()
    params = tdec._stacked_params(0, tcfg, "cpu")
    x = torch.randn(B, LP, 64, generator=torch.Generator().manual_seed(1))
    pre, gen = tdec.make_decoder(tcfg, B, LP, GEN, donate=True)
    c, y0 = pre(params, x)
    k_before = c["k"].clone()
    c2, _ = gen(params, c, y0, LP, GEN)
    assert c2["k"].data_ptr() == c["k"].data_ptr()
    assert not torch.equal(c["k"], k_before)  # the gen slots were written
    _, none = gen(params, c2, y0, LP, 0)
    assert tuple(none.shape) == (B, 0, 64)


@pytest.mark.parametrize("kw", [dict(), dict(kv_heads=2, rope=True, depth=3)])
def test_forward_stack_matches_reference(kw):
    jcfg, tcfg = _cfgs(**kw)
    flat = _np_tree(jdec._stacked_params(jax.random.key(5), jcfg))
    x = np.random.RandomState(6).randn(2, 12, 64).astype(np.float32)
    want = jtr.forward_stack(flat, jnp.asarray(x), jcfg)
    got = ttr.forward_stack({k: torch.tensor(v) for k, v in flat.items()},
                            torch.from_numpy(x), tcfg)
    assert _scaled_err(got, want) <= EPS64


def test_gather_last_valid_matches_reference():
    y = np.random.RandomState(7).randn(4, LP, 8).astype(np.float32)
    lens = np.array([LP, 1, 7, 0], np.int32)  # 0: no valid position
    want = jdec._gather_last_valid(
        jnp.asarray(y), jnp.asarray(lens), jdec._CacheLayout(LP, GEN, 1),
        None)
    got = tdec._gather_last_valid(torch.from_numpy(y), torch.from_numpy(lens),
                                  tdec._CacheLayout(LP, GEN))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[3].any()


GATE_CASES = {
    "mha": dict(depth=1),
    "rope_depth2": dict(depth=2, rope=True),
    "gqa_rope": dict(depth=1, kv_heads=2, rope=True),
}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", list(GATE_CASES))
def test_teacher_forcing_gate_holds(name, int8):
    _, tcfg = _cfgs(**GATE_CASES[name])
    assert tdec._teacher_forcing_gate(tcfg, cache_int8=int8)


@pytest.mark.parametrize("name", list(GATE_CASES))
def test_ragged_gate_holds(name):
    _, tcfg = _cfgs(**GATE_CASES[name])
    assert tdec._ragged_gate(tcfg)
    # the edges: every row at the full prompt, every row at one token
    assert tdec._ragged_gate(tcfg, lens_fn=lambda b, lp: [lp] * b)
    assert tdec._ragged_gate(tcfg, lens_fn=lambda b, lp: [1] * b)


def test_ragged_gate_agrees_with_reference(mesh):
    # (the reference's teacher-forcing verdict is in its run_decode
    # Record, held below)
    jcfg, tcfg = _cfgs(depth=1, rope=True)
    assert jdec._ragged_gate(mesh, jcfg) and tdec._ragged_gate(tcfg)


def _misaddressed(monkeypatch, shift_t0):
    """Swap the port's make_decoder for one whose generate is handed a
    wrong position (``shift_t0``): the gates must catch it."""
    real = tdec.make_decoder

    def wrong(*a, **k):
        pre, gen = real(*a, **k)
        return pre, lambda p, c, y, t0, n: gen(p, c, y, shift_t0(t0), n)

    monkeypatch.setattr(tdec, "make_decoder", wrong)


def test_gates_catch_misaddressed_slots(monkeypatch):
    _, tcfg = _cfgs(depth=1, rope=True)
    with monkeypatch.context() as m:
        _misaddressed(m, lambda t0: (t0[0] + 1, t0[1]))  # lens one off
        assert not tdec._ragged_gate(tcfg)
    with monkeypatch.context() as m:
        _misaddressed(m, lambda t0: t0 + 1)  # one slot further on
        assert not tdec._teacher_forcing_gate(tcfg)
        assert not tdec._teacher_forcing_gate(
            dataclasses.replace(tcfg, rope=False))
    assert tdec._ragged_gate(tcfg) and tdec._teacher_forcing_gate(tcfg)


SMALL = dict(embed=64, heads=8, head_dim=8, depth=2, batch=2, prefill=32,
             gen=8, reps=2, warmup=1)


def _ref_record(mesh, **kw):
    class Sink:
        def record(self, rec):
            self.rec = rec

    sink = Sink()
    (rec,) = jdec.run_decode(mesh, jdec.DecodeConfig(**SMALL, **kw), sink)
    return rec


@pytest.mark.parametrize("kw", [
    dict(dtype="float32"),
    dict(dtype="bfloat16", kv_heads=2, rope=True, cache_int8=True),
])
def test_run_decode_record_matches_reference(mesh, kw):
    want = _ref_record(mesh, **kw)
    (got,) = tdec.run_decode(tdec.DecodeConfig(**SMALL, **kw, device="cpu"),
                             ResultWriter(stream=io.StringIO()))
    assert got.pattern == want.pattern == "decode"
    assert got.mode == want.mode
    assert got.commands == want.commands
    assert set(got.metrics) == set(want.metrics)
    assert got.metrics["cache_MB"] == want.metrics["cache_MB"]
    assert got.metrics["prefill_context"] == want.metrics["prefill_context"]
    assert got.verdict.value == want.verdict.value == "SUCCESS", got.notes
    assert got.metrics["tokens_per_s"] > 0 and got.metrics["prefill_ms"] > 0


def test_run_decode_fails_its_tokens_floor():
    (rec,) = tdec.run_decode(
        tdec.DecodeConfig(**SMALL, min_tokens_per_s=1e12, device="cpu"),
        ResultWriter(stream=io.StringIO()))
    assert rec.verdict.value == "FAILURE"


def test_decode_config_is_the_references_plus_device():
    ref = {f.name: f.default for f in dataclasses.fields(jdec.DecodeConfig)}
    port = {f.name: f.default for f in dataclasses.fields(tdec.DecodeConfig)}
    assert port.pop("device") == "cuda"
    assert port == ref


def _flags(parser, cmd):
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {a.dest for a in sub.choices[cmd]._actions if a.dest != "help"}


@pytest.mark.parametrize("cmd", ["decode", "lm"])
def test_cli_flags_are_the_references_minus_the_mesh(cmd):
    """The reference's flags, the mesh's included, plus ``--device``."""
    ref = _flags(jcli.build_parser(), cmd)
    port = _flags(tcli.build_parser(), cmd)
    assert set(tcli._MESH_FLAGS) <= ref
    assert port == ref | {"device"}
    args = tcli.build_parser().parse_args(
        [cmd, "--devices", "8", "--dp", "2", "--tp", "2"])
    assert (args.devices, args.dp, args.tp) == (8, 2, 2)
    assert tcli.build_parser().parse_args([cmd]).device == "cuda"


@pytest.mark.parametrize("cmd", ["decode", "lm"])
def test_cli_refuses_unported_options(cmd):
    """A mesh that dp*tp does not divide is refused, as the reference's
    ``_mesh3d_from_args`` refuses it; ``serve`` and ``loadgen`` take
    ``--devices`` and ``--tp`` (the sharded serve) and refuse a dp other
    than 1 with the reference's message."""
    with pytest.raises(SystemExit, match="not divisible by dp\\*tp = 4"):
        tcli.main([cmd, "--device", "cpu", "--devices", "6", "--dp", "4"])
    for sub in ("serve", "loadgen"):
        args = tcli.build_parser().parse_args(
            [sub, "--devices", "4", "--tp", "2"])
        assert (args.devices, args.dp, args.tp) == (4, 1, 2)
        with pytest.raises(SystemExit, match=f"{sub} requires --dp 1"):
            tcli.main([sub, "--device", "cpu", "--devices", "2", "--dp",
                       "2"])


def test_cli_decode_runs_on_the_cpu(capsys):
    rc = tcli.main(["decode", "--device", "cpu", "--embed", "32",
                    "--heads", "4", "--head_dim", "8", "--depth", "1",
                    "--batch", "2", "--prefill", "16", "--gen", "4",
                    "--reps", "2", "--dtype", "float32"])
    assert rc == 0
    assert "## sp1 | B2 prefill16 gen4 depth1 float32 | SUCCESS" in (
        capsys.readouterr().out)
