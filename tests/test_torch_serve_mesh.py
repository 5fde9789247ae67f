"""The port's sharded serve (the paged pool over sp x tp ranks) against
the JAX package's, on the CPU.

The reference's ``TestExactness`` meshes (tests/test_serve.py: E 64, 8
heads of 8, depth 2, block_len 8, 13 blocks, 40-token tables, 3 slots,
five requests of 3-20 tokens and 6 generated) and (1, 2, 1): the
reference's ``ServeEngine`` on the conftest's CPU devices and the port's
``PagedDecoder`` over CPU ranks, on one set of weights handed over as
numpy, must retire the same ids, with K1's plain version and with the
dense gather, and the port's ids must equal its same-mesh dense decode
(``_oracle_expected`` over the mesh). After a run the port's pool,
assembled to the global layout, matches the reference's: float pools
within 64 float32 eps of their magnitude (both sides do float32 math,
the tp and sp sums in other orders), int8 values bit for bit and their
scales within the same bound (each is a max over k/v projections that
the two sides round apart by an ulp or two, as in
``test_torch_decode.py``). Then the decoder's contracts (dp refused, a
block that sp does not divide refused), the one-device decoder being the
(1, 1, 1) mesh's, the kv tier's block copies at (1, 2, 2), a snapshot
taken at (1, 2, 1) resumed there and on one device, and the
``run_serve`` and ``run_loadgen`` Records at (1, 2, 2), whose modes,
metric keys and verdicts equal the reference's."""

import dataclasses
import functools
import io

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_patterns.core.results import ResultWriter as JResultWriter
from tpu_patterns.loadgen import runner as jl
from tpu_patterns.models.lm import init_lm_params as j_init_lm_params
from tpu_patterns.models.transformer import ModelConfig as JModelConfig
from tpu_patterns.serve import engine as jengine
from tpu_patterns.serve import Request as JRequest
from tpu_patterns.serve import ServeEngine as JServeEngine
from tpu_patterns.serve import make_paged_lm_decoder as j_make_decoder
from tpu_patterns_torch import faults
from tpu_patterns_torch.comm.mesh import model_mesh
from tpu_patterns_torch.convert import params_from_jax
from tpu_patterns_torch.core.results import ResultWriter
from tpu_patterns_torch.loadgen import runner as tl
from tpu_patterns_torch.models.transformer import ModelConfig
from tpu_patterns_torch.serve import engine as tengine
from tpu_patterns_torch.serve.paged import (
    POOL_SPEC,
    SCALE_SPEC,
    make_paged_lm_decoder,
)

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

VOCAB = 64
EPS64 = 64 * np.finfo(np.float32).eps
MODEL = dict(embed=64, heads=8, head_dim=8, dtype="float32", depth=2)
POOL = dict(n_blocks=13, block_len=8, max_len=40)
# name -> ((dp, sp, tp), kv_heads, rope, cache_int8): the reference's
# TestExactness meshes, and sp 2 alone
CASES = {
    "142_rope": ((1, 4, 2), 0, True, False),
    "181": ((1, 8, 1), 0, False, False),
    "124_gqa4_rope": ((1, 2, 4), 4, True, False),
    "142_rope_int8": ((1, 4, 2), 0, True, True),
    "121_rope": ((1, 2, 1), 0, True, False),
}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.configure(None)
    yield
    faults.configure(None)


def _trace(n=5, seed=1):
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(0, VOCAB, size=rng.randint(3, 21)).tolist())
            for i in range(n)]


def jmesh(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("dp", "sp", "tp"))


def tmesh(shape):
    return model_mesh(int(np.prod(shape)), shape[0], shape[2], device="cpu")


@functools.lru_cache(maxsize=None)
def _flat(kv_heads, rope):
    jcfg = JModelConfig(**MODEL, kv_heads=kv_heads, rope=rope)
    return {k: np.asarray(v) for k, v in j_init_lm_params(
        jax.random.key(0), jcfg, VOCAB).items()}


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference engine's ids and its global pool after the run."""
    shape, kv, rope, int8 = CASES[name]
    jcfg = JModelConfig(**MODEL, kv_heads=kv, rope=rope)
    dec = j_make_decoder(jmesh(shape), jcfg, VOCAB, cache_int8=int8, **POOL)
    eng = JServeEngine(dec, dec.stack_params(_flat(kv, rope)), slots=3)
    out = eng.run([JRequest(rid=i, tokens=t, n_gen=6) for i, t in _trace()])
    assert not eng.failed and eng.leaked_blocks() == 0
    return out, {n: np.asarray(a) for n, a in eng.pool.items()}


def _port_decoder(name, attn="kernel", mesh=None):
    shape, kv, rope, int8 = CASES[name]
    cfg = ModelConfig(**MODEL, kv_heads=kv, rope=rope)
    dec = make_paged_lm_decoder(cfg, VOCAB, cache_int8=int8, attn=attn,
                                device="cpu", mesh=mesh or tmesh(shape),
                                **POOL)
    return cfg, dec, dec.stack_params(params_from_jax(_flat(kv, rope), cfg))


def _requests():
    return [tengine.Request(rid=i, tokens=t, n_gen=6) for i, t in _trace()]


@functools.lru_cache(maxsize=None)
def _oracle(name):
    cfg, dec, params = _port_decoder(name)
    return tengine._oracle_expected(
        cfg, VOCAB, params, _requests(), max_prompt=20, max_gen=6,
        cache_int8=dec.cache_int8, mesh=dec.mesh)


def _global_pool(dec, pool) -> dict[str, np.ndarray]:
    return {n: dec.mesh.assemble(leaves, dec._spec(n)).numpy()
            for n, leaves in pool.items()}


def _scaled_err(got, want) -> float:
    scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(got.astype(np.float32) - want).max()) / scale


@pytest.mark.parametrize("attn", ["kernel", "dense"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_matches_reference_and_dense_oracle(name, attn):
    want, jpool = _reference(name)
    _, dec, params = _port_decoder(name, attn)
    eng = tengine.ServeEngine(dec, params, slots=3)
    got = eng.run(_requests())
    assert eng.leaked_blocks() == 0 and not eng.failed
    assert got == want
    assert got == _oracle(name)
    # the pool, assembled, against the reference's (the trash block's
    # colliding writes aside)
    pool = _global_pool(dec, eng.pool)
    assert set(pool) == set(jpool)
    for n, a in pool.items():
        assert a.shape == jpool[n].shape
        if n in ("k", "v") and a.dtype == np.int8:
            np.testing.assert_array_equal(a[:, 1:], jpool[n][:, 1:])
        else:
            assert _scaled_err(a[:, 1:], jpool[n][:, 1:]) <= EPS64, n


def test_pool_leaves_are_the_ranks_stripes_and_heads():
    """Each rank holds [depth, n_blocks, block_len / sp, Hkv / tp, D]
    (scales without D), and the pool's bytes summed over the ranks are
    the global pool's."""
    _, dec, _ = _port_decoder("142_rope_int8")
    pool = dec.init_pool()
    assert pool["k"][0].shape == (2, 13, 2, 4, 8)
    assert pool["ks"][0].shape == (2, 13, 2, 4)
    assert len(pool["k"]) == 8
    total = sum(t.numel() * t.element_size() for leaves in pool.values()
                for t in leaves)
    assert total == dec.pool_nbytes()
    assert (dec._spec("k"), dec._spec("ks")) == (POOL_SPEC, SCALE_SPEC)


def test_factory_contracts_match_reference():
    cfg = ModelConfig(**MODEL)
    jcfg = JModelConfig(**MODEL)
    kw = dict(n_blocks=4, block_len=8, max_len=16)
    with pytest.raises(ValueError, match="fold dp into sp"):
        make_paged_lm_decoder(cfg, VOCAB, device="cpu",
                              mesh=tmesh((2, 2, 1)), **kw)
    with pytest.raises(ValueError, match="fold dp into sp"):
        j_make_decoder(jmesh((2, 2, 1)), jcfg, VOCAB, **kw)
    kw["block_len"] = 6
    with pytest.raises(ValueError, match="divide over sp"):
        make_paged_lm_decoder(cfg, VOCAB, device="cpu",
                              mesh=tmesh((1, 4, 1)), **kw)
    with pytest.raises(ValueError, match="divide over sp"):
        j_make_decoder(jmesh((1, 4, 1)), jcfg, VOCAB, **kw)


def test_one_device_is_the_one_rank_mesh():
    """The decoder made without a mesh runs the cores of the one made
    over the (1, 1, 1) mesh, on plain tensors where that one holds lists
    of one: the same ids and a bit-equal pool."""
    cfg, mdec, mparams = _port_decoder("121_rope", mesh=tmesh((1, 1, 1)))
    one = make_paged_lm_decoder(cfg, VOCAB, device="cpu", **POOL)
    assert one.mesh is None and one.ranks.shape == (1, 1, 1)
    params = one.stack_params(params_from_jax(_flat(0, True), cfg))
    assert all(isinstance(v, torch.Tensor) for v in params.values())
    runs = [tengine.ServeEngine(d, p, slots=3)
            for d, p in ((one, params), (mdec, mparams))]
    assert runs[0].run(_requests()) == runs[1].run(_requests())
    for n, t in runs[0].pool.items():
        assert torch.equal(t, runs[1].pool[n][0]), n


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 2, 2)])
def test_every_k1_call_goes_through_the_kernel_module(shape, monkeypatch):
    """Each verify call reaches ``paged_kernel.paged_block`` (where the
    smoke's launch counters and recorders stand) depth x ranks times."""
    from tpu_patterns_torch.serve import paged as tpaged
    from tpu_patterns_torch.serve import paged_kernel as tpk

    calls = {"k1": 0, "verify": 0}
    k1, verify = tpk.paged_block, tpaged.PagedDecoder.verify

    def counted_k1(*a, **k):
        calls["k1"] += 1
        return k1(*a, **k)

    def counted_verify(self, *a, **k):
        calls["verify"] += 1
        return verify(self, *a, **k)

    monkeypatch.setattr(tpk, "paged_block", counted_k1)
    monkeypatch.setattr(tpaged.PagedDecoder, "verify", counted_verify)
    _, dec, params = _port_decoder("121_rope", mesh=tmesh(shape))
    tengine.ServeEngine(dec, params, slots=3).run(_requests())
    assert calls["verify"] > 0
    assert calls["k1"] == MODEL["depth"] * dec.ranks.size * calls["verify"]


@pytest.mark.parametrize("int8", [False, True])
def test_block_copies_round_trip_in_the_global_layout(int8):
    """At (1, 2, 2): ``onload_blocks`` writes global-layout blocks that
    ``gather_blocks`` reads back, ``copy_blocks`` clones whole blocks on
    every rank, and the pool's buffers stay in place."""
    cfg = ModelConfig(**MODEL)
    dec = make_paged_lm_decoder(cfg, VOCAB, n_blocks=6, block_len=8,
                                max_len=16, cache_int8=int8, device="cpu",
                                mesh=tmesh((1, 2, 2)))
    pool = dec.init_pool()
    ptrs = dec.pool_ptrs(pool)
    gen = torch.Generator().manual_seed(5)
    glob = {}
    for n, (shape, dt) in dec._pool_leaves().items():
        glob[n] = (torch.randint(-127, 128, shape, generator=gen).to(dt)
                   if dt == torch.int8 else
                   torch.randn(shape, generator=gen).to(dt))
    dec.onload_blocks(pool, glob, np.arange(6))
    got = dec.gather_blocks(pool, np.array([3, 1]))
    for n, a in glob.items():
        assert torch.equal(got[n], a[:, [3, 1]])
    dec.copy_blocks(pool, np.array([2, 5]), np.array([4, 0]))
    got = dec.gather_blocks(pool, np.arange(6))
    for n, a in glob.items():
        want = a.clone()
        want[:, [4, 0]] = a[:, [2, 5]]
        assert torch.equal(got[n], want)
    assert dec.pool_ptrs(pool) == ptrs


def test_snapshot_resumes_on_the_mesh_and_on_one_device(tmp_path):
    """A run at (1, 2, 1) preempted after two decode steps commits a
    snapshot of the global pool; resumed at (1, 2, 1) and on one device,
    each finishes with the uninterrupted run's ids."""
    name = "121_rope"
    _, dec, params = _port_decoder(name)
    want = tengine.ServeEngine(dec, params, slots=3).run(_requests())
    fp = {"case": name}
    eng = tengine.ServeEngine(dec, params, slots=3,
                              snapshot_dir=str(tmp_path), fingerprint=fp)
    faults.configure("serve.step:preempt:after=2:count=1")
    eng.run(_requests())
    faults.configure(None)
    assert eng.preempted_at is not None and len(eng.done) < len(want)
    for mesh in (tmesh((1, 2, 1)), tmesh((1, 1, 1))):
        if mesh.size == 1:
            cfg, _, _ = _port_decoder(name)
            one = make_paged_lm_decoder(cfg, VOCAB, device="cpu", **POOL)
            d2, p2 = one, one.stack_params(
                params_from_jax(_flat(0, True), cfg))
        else:
            _, d2, p2 = _port_decoder(name, mesh=mesh)
        eng2 = tengine.ServeEngine(d2, p2, slots=3,
                                   snapshot_dir=str(tmp_path),
                                   fingerprint=fp)
        assert eng2.restore_snapshot() == eng.preempted_at
        assert eng2.run([]) == want
        assert eng2.leaked_blocks() == 0


SERVE = dict(vocab=VOCAB, embed=32, heads=4, head_dim=8, depth=1,
             requests=6, min_prompt=4, max_prompt=24, gen=6, slots=4,
             block_len=8, min_speedup=0.0)
LOADGEN = dict(vocab=VOCAB, embed=32, heads=4, head_dim=8, depth=1,
               slots=4, block_len=8, time_scale=0.02, slo_ttft_ms=60_000,
               slo_tpot_ms=20_000,
               scenarios=("chat:requests=3:min_prompt=4:mean_prompt=6"
                          ":max_prompt=8:min_gen=4:mean_gen=4:max_gen=6",))


@functools.lru_cache(maxsize=None)
def _reference_records():
    mesh = jmesh((1, 2, 2))
    w = JResultWriter(stream=io.StringIO())
    return (jengine.run_serve(mesh, jengine.ServeConfig(**SERVE), w)
            + jl.run_loadgen(mesh, jl.LoadGenConfig(**LOADGEN), w))


def test_run_serve_and_loadgen_records_match_reference():
    mesh = tmesh((1, 2, 2))
    w = ResultWriter(stream=io.StringIO())
    ours = (tengine.run_serve(tengine.ServeConfig(**SERVE, device="cpu"),
                              w, mesh)
            + tl.run_loadgen(tl.LoadGenConfig(**LOADGEN, device="cpu"), w,
                             mesh))
    refs = _reference_records()
    assert [r.mode for r in ours] == [r.mode for r in refs] == [
        "slots4_bl8_sp2", "chat_sp2"]
    for got, ref in zip(ours, refs):
        assert got.pattern == ref.pattern
        assert sorted(got.metrics) == sorted(ref.metrics)
        assert got.verdict.value == ref.verdict.value == "SUCCESS", got.notes
        assert any("4 ranks on the CPU" in n for n in got.notes)
    assert ours[0].metrics["exact"] == 1.0


def test_every_serve_and_loadgen_mode_names_the_meshs_sp(tmp_path):
    """The Records that hard-coded sp 1 name the mesh's sp: prefix
    sharing, speculative decoding, the kv tier, the session cache, the
    preemptible run and the load generator's chaos twin, at (1, 2, 1).
    The gates that race two wall clocks (the tier against the defer-only
    engine, the chaos twin's p99 against the clean run's) are off: on a
    loaded CPU host they are a race, and the card holds them (phase
    23)."""
    mesh = tmesh((1, 2, 1))
    w = ResultWriter(stream=io.StringIO())
    base = tengine.ServeConfig(**SERVE, device="cpu")
    recs = tengine.run_serve(dataclasses.replace(
        base, prefix_share=True, shared_prefix=16, spec_k=2), w, mesh)
    recs += tengine.run_serve(dataclasses.replace(
        base, kv_host_tier=True, slots=3, min_tier_speedup=0.0), w, mesh)
    recs += tengine.run_serve(dataclasses.replace(
        base, kv_host_tier=True, slots=3,
        session_dir=str(tmp_path / "sess")), w, mesh)
    recs += tengine.run_serve(dataclasses.replace(
        base, snapshot_dir=str(tmp_path / "snap")), w, mesh)
    recs += tl.run_loadgen(tl.LoadGenConfig(
        **LOADGEN, device="cpu", chaos_p99_mult=1e9,
        chaos="loadgen.arrive:error:after=1:count=1"), w, mesh)
    modes = [r.mode for r in recs]
    assert modes == ["slots4_bl8_sp2", "prefix_share_req6_bl8_sp2",
                     "spec_decode_k2_sp2", "kv_tier_slots3_bl8_sp2",
                     "kv_session_slots3_bl8_sp2", "preemptible_slots4_sp2",
                     "chat_sp2", "chat_chaos_sp2"]
    assert [r.verdict.value for r in recs] == ["SUCCESS"] * 7 + ["WARNING"]
