"""The port's decoder over a dp x sp x tp rank mesh against the JAX
package's sharded decoder, on the CPU.

The reference's own small shapes (E 64, H 8, D 8, depth 2; its
``mesh3d`` is (2, 2, 2)) and one seeded numpy prompt go through the
reference's ``make_decoder`` under ``shard_map`` on the conftest's CPU
devices and through the port on CPU ranks, the weights handed over as
numpy (``convert.block_params_from_jax``).  Per-rank results are
assembled into the reference's global layout (``NamedMesh.assemble``)
before they are compared.  Float32: prefill and generated outputs and
float caches within 64 float32 eps of their magnitude (the reference's
own teacher-forcing bound: both sides do float32 math, the tp and sp
sums in different orders, and the outputs reach |y| ~ 10 at this init,
where 1e-5 absolute is ~10 ulps); with an int8 cache the quantized values
bit for bit and their scales within the same bound (each is a max over
k/v projections that the two sides round apart by an ulp or two, as in
``test_torch_decode.py``).  The
gates run at the mesh and must catch the faults a sharded cache invites:
a write on every rank, a per-rank max in the softmax combine."""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_patterns.longctx.attention import stripe as jstripe
from tpu_patterns.models import decode as jdec
from tpu_patterns.models import transformer as jtr
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch.comm.mesh import model_mesh
from tpu_patterns_torch.convert import block_params_from_jax
from tpu_patterns_torch.core.results import ResultWriter
from tpu_patterns_torch.models import decode as tdec
from tpu_patterns_torch.models import transformer as ttr

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

E, H, D = 64, 8, 8
LP, GEN = 16, 4
EPS64 = 64 * np.finfo(np.float32).eps
KV_SPEC = (None, "dp", "tp", "sp", None)
# name -> (mesh (dp, sp, tp), config, int8 cache)
CASES = {
    "222": ((2, 2, 2), dict(), False),
    "striped_141": ((1, 4, 1), dict(attn_layout="striped", rope=True), False),
    # the mixture at ep = tp, GQA (4 K/V heads over tp 2), RoPE, int8
    "moe_gqa_rope_int8_122": ((1, 2, 2), dict(moe=True, kv_heads=4,
                                              rope=True), True),
}


def _scaled_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(np.asarray(got, np.float32) - want).max()) / scale


def jmesh(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("dp", "sp", "tp"))


def tmesh(shape):
    return model_mesh(int(np.prod(shape)), shape[0], shape[2], device="cpu")


def _cfgs(**kw):
    base = dict(embed=E, heads=H, head_dim=D, dtype="float32", depth=2,
                causal=True)
    base.update(kw)
    return jtr.ModelConfig(**base), ttr.ModelConfig(**base)


@pytest.fixture(scope="module")
def decoded():
    """Per case: the reference's prefill and generate outputs, lockstep
    and (for 222) ragged, on the weights and prompt handed to the
    port."""
    out = {}
    for name, (shape, kw, int8) in CASES.items():
        jcfg, tcfg = _cfgs(**kw)
        b = 2 * shape[0]
        n_exp = shape[2] if jcfg.moe else 0
        flat = {k: np.asarray(v) for k, v in jdec._stacked_params(
            jax.random.key(3), jcfg, n_exp).items()}
        x = np.random.RandomState(4).randn(b, LP + GEN, E).astype(
            np.float32)
        xp = x[:, :LP]
        if jcfg.attn_layout == "striped":
            xp = np.asarray(jstripe(xp, shape[1], axis=1))
        pre, gen = jdec.make_decoder(jmesh(shape), jcfg, b, LP, GEN,
                                     cache_int8=int8)
        lens = np.array([LP - 5 * i for i in range(b)], np.int32)
        runs = {}
        for mode in ("lockstep", "ragged") if name == "222" else (
                "lockstep",):
            ragged = mode == "ragged"
            c, y0 = pre(flat, jnp.asarray(xp),
                        jnp.asarray(lens) if ragged else None)
            c2, ys = gen(flat, c, y0, (jnp.asarray(lens), 0) if ragged
                         else LP, GEN)
            runs[mode] = ({k: np.asarray(v) for k, v in c2.items()},
                          np.asarray(y0), np.asarray(ys))
        out[name] = (tcfg, flat, xp, lens, runs)
    return out


@pytest.mark.parametrize("name,mode", [(n, "lockstep") for n in CASES]
                         + [("222", "ragged")])
def test_make_decoder_matches_reference(decoded, name, mode):
    tcfg, flat, xp, lens, runs = decoded[name]
    jc, jy0, jys = runs[mode]
    shape, _, int8 = CASES[name]
    mesh = tmesh(shape)
    b = 2 * shape[0]
    pre, gen = tdec.make_decoder(tcfg, b, LP, GEN, cache_int8=int8,
                                 mesh=mesh)
    params = ttr.shard_params(block_params_from_jax(flat, tcfg), mesh, tcfg)
    xs = mesh.shard(torch.from_numpy(xp), ("dp", "sp", None))
    ragged = mode == "ragged"
    c, y0 = pre(params, xs, lens if ragged else None)
    c2, ys = gen(params, c, y0, (lens, 0) if ragged else LP, GEN)
    got_y0 = mesh.assemble(y0, ("dp", None, None)).numpy()
    got_ys = mesh.assemble(ys, ("dp", None, None)).numpy()
    assert _scaled_err(got_y0, jy0) <= EPS64
    assert got_ys.shape == jys.shape == (b, GEN, E)
    assert _scaled_err(got_ys, jys) <= EPS64
    assert set(c2[0]) == set(jc)
    for k, want in jc.items():
        spec = KV_SPEC if want.ndim == 5 else KV_SPEC[:4]
        got = mesh.assemble([cr[k] for cr in c2], spec).numpy()
        assert got.shape == want.shape, k
        if int8 and k in ("k", "v"):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            assert _scaled_err(got, want) <= EPS64, k


@pytest.mark.parametrize("striped", [False, True],
                         ids=["contiguous", "striped"])
def test_cache_layout_matches_reference_at_sp4(striped):
    """Every method of the port's per-rank layout against the
    reference's class, each sp rank in turn (the reference's rank is
    ``lax.axis_index``; a subclass pins it)."""
    layout = "striped" if striped else "contiguous"
    lp, lg, sp = 16, 8, 4

    class At(jdec._CacheLayout):
        def __init__(self, rank):
            super().__init__(lp, lg, sp, layout)
            self.rank = rank

        def _rank(self, sp_axis):
            return self.rank

    port = tdec._CacheLayout(lp, lg, sp, layout)
    assert (port.lp_loc, port.lg_loc, port.lc_loc) == (4, 2, 6)
    pos = jnp.arange(-2, lp + 3)
    owners = np.zeros(lp + 5, np.int32)
    gen_owners = np.zeros(lg + 3, np.int32)
    for r in range(sp):
        ref = At(r)

        def same(got, want):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

        same(port.prompt_positions("cpu", r), ref.prompt_positions("sp"))
        same(port.gen_indices("cpu", r), ref.gen_indices("sp"))
        same(port.kv_positions("cpu", r), ref.kv_positions("sp"))
        for got, want in zip(port.slot_meta("cpu", r), ref.slot_meta("sp")):
            same(got, want)
        idx, owned = port.prompt_local_slot(torch.arange(-2, lp + 3), r)
        jidx, jowned = ref.prompt_local_slot(pos, "sp")
        same(owned, jowned)
        same(idx[owned], np.asarray(jidx)[np.asarray(jowned)])
        owners += owned.numpy()
        for n in range(-1, lg + 2):
            off, ok = port.write_offset_gen(n, r)
            joff, jok = ref.write_offset_gen(n, "sp")
            assert bool(ok) == bool(jok), (r, n)
            if ok:
                assert off == int(joff)
            gen_owners[n + 1] += ok
    # every prompt position and gen index in range has exactly one owner
    np.testing.assert_array_equal(owners[2:2 + lp], 1)
    assert owners[:2].sum() == owners[2 + lp:].sum() == 0
    np.testing.assert_array_equal(gen_owners[1:1 + lg], 1)
    with pytest.raises(ValueError, match="divide over sp=4"):
        tdec._CacheLayout(lp + 2, lg, sp)
    with pytest.raises(ValueError, match="unknown cache layout"):
        tdec._CacheLayout(lp, lg, sp, "banded")


GATES = {
    "222": ((2, 2, 2), dict()),
    "striped_rope_141": ((1, 4, 1), dict(attn_layout="striped", rope=True)),
    "moe_122": ((1, 2, 2), dict(moe=True)),
    "gqa_rope_222": ((2, 2, 2), dict(kv_heads=4, rope=True)),
}


@pytest.mark.parametrize("name", list(GATES))
def test_gates_hold_at_the_mesh(name):
    shape, kw = GATES[name]
    _, tcfg = _cfgs(**kw)
    mesh = tmesh(shape)
    assert tdec._teacher_forcing_gate(tcfg, mesh=mesh)
    if not tcfg.moe and not tcfg.kv_heads:
        rcfg = dataclasses.replace(tcfg, rope=True)
        assert tdec._ragged_gate(rcfg, mesh=mesh)
        # the edges: every row at the full prompt (the last sp rank's
        # final slot), every row at one token (rank 0's first)
        assert tdec._ragged_gate(rcfg, lambda b, lp: [lp] * b, mesh=mesh)
        assert tdec._ragged_gate(rcfg, lambda b, lp: [1] * b, mesh=mesh)


def test_int8_gate_holds_at_the_mesh():
    _, tcfg = _cfgs(kv_heads=4, rope=True, attn_layout="striped")
    assert tdec._teacher_forcing_gate(tcfg, cache_int8=True,
                                      mesh=tmesh((2, 2, 2)))


@pytest.mark.parametrize("fault", ["write_everywhere", "per_rank_max",
                                   "numer_left_out"])
def test_gates_catch_sharded_cache_faults(monkeypatch, fault):
    """A gen slot written on every sp rank (the slot index is the same
    on each, so the others' gen slots are overwritten), a softmax that
    normalizes each rank by its own max, and a combine that leaves one
    rank's weighted values out: each fails a gate at sp 4."""
    _, tcfg = _cfgs(rope=True, depth=1)
    mesh = tmesh((1, 4, 1))
    if fault == "write_everywhere":
        real = tdec._CacheLayout.write_offset_gen
        monkeypatch.setattr(tdec._CacheLayout, "write_offset_gen",
                            lambda self, n, rank=0: (real(self, n, 0)[0],
                                                     True))
    elif fault == "per_rank_max":
        monkeypatch.setattr(tdec, "_sp_max", list)
    else:
        real_sum = tdec._sp_sum
        monkeypatch.setattr(
            tdec, "_sp_sum",
            lambda xs: real_sum(xs[:-1] + [torch.zeros_like(xs[-1])])
            if xs[0].shape[-1] != 1 else real_sum(xs))
    assert not (tdec._teacher_forcing_gate(tcfg, mesh=mesh)
                and tdec._ragged_gate(tcfg, mesh=mesh))


def test_group_attention_is_one_device_attention_over_the_joined_cache():
    """The sp combine over four cache blocks equals one device's
    attention over the blocks joined, masks and int8 scales included."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 3, 8, 8, generator=g)
    k = torch.randn(2, 4, 24, 8, generator=g)
    v = torch.randn(2, 4, 24, 8, generator=g)
    mask = torch.rand(2, 3, 24, generator=g) > 0.3
    mask[1, 2] = False  # a query that sees nothing anywhere
    kq, ks = tdec._quantize_kv(k)
    vq, vs = tdec._quantize_kv(v)
    for cache in ({"k": k, "v": v}, {"k": kq, "v": vq, "ks": ks, "vs": vs}):
        want = tdec._cache_attend(cache, q, mask)
        blocks = [{n: t[:, :, 6 * i:6 * (i + 1)] for n, t in cache.items()}
                  for i in range(4)]
        got = tdec._group_attention([q] * 4, blocks,
                                    [mask[..., 6 * i:6 * (i + 1)]
                                     for i in range(4)])
        for o in got:
            torch.testing.assert_close(o, want, rtol=0, atol=1e-6)
        assert torch.equal(got[0][1, 2], torch.zeros(8, 8))


SMALL = dict(embed=E, heads=H, head_dim=D, depth=2, batch=2, prefill=32,
             gen=8, reps=1, warmup=0)


def test_run_decode_record_matches_reference():
    class Sink:
        def record(self, rec):
            self.rec = rec

    kw = dict(dtype="float32", kv_heads=4, rope=True, layout="striped",
              moe=True)
    (want,) = jdec.run_decode(jmesh((1, 2, 2)),
                              jdec.DecodeConfig(**SMALL, **kw), Sink())
    (got,) = tdec.run_decode(tdec.DecodeConfig(**SMALL, **kw, device="cpu"),
                             ResultWriter(stream=io.StringIO()),
                             mesh=tmesh((1, 2, 2)))
    assert got.mode == want.mode == "sp2_gqa4_rope_striped_moe"
    assert got.commands == want.commands
    assert set(got.metrics) == set(want.metrics)
    assert got.metrics["cache_MB"] == want.metrics["cache_MB"]
    assert got.verdict.value == want.verdict.value == "SUCCESS", got.notes
    assert any("4 ranks on the CPU" in n for n in got.notes)


def test_cli_decode_on_a_mesh(capsys):
    rc = tcli.main(["decode", "--device", "cpu", "--devices", "4", "--tp",
                    "2", "--embed", "32", "--heads", "4", "--head_dim", "8",
                    "--depth", "1", "--batch", "2", "--prefill", "16",
                    "--gen", "4", "--reps", "1", "--warmup", "0",
                    "--dtype", "float32", "--layout", "striped"])
    assert rc == 0
    assert "## sp2_striped | B2 prefill16 gen4 depth1 float32 | SUCCESS" in (
        capsys.readouterr().out)
