"""The port's speculative decoding against the JAX package's.

The verify step (``PagedDecoder.verify``, K1 at W = k+1 on the kernel
path, whose plain version runs on the CPU) against the reference's
``verify_jit`` on the same pool, weights and inputs: ids equal, pool
leaves within 1e-5 (int8 values equal, their scales within 1e-5
relative), for the kernel and dense paths, MHA and GQA, float32 and
int8 pools.  The prompt-lookup
drafter proposes what the reference's proposes, and the speculative
engine retires the reference engine's ids with equal step and
acceptance counts, equal to plain decode's ids."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_patterns.models.lm import init_lm_params as j_init_lm_params
from tpu_patterns.models.transformer import ModelConfig as JModelConfig
from tpu_patterns.serve import Request as JRequest
from tpu_patterns.serve import ServeEngine as JServeEngine
from tpu_patterns.serve import engine as jengine
from tpu_patterns.serve import make_paged_lm_decoder as j_make_decoder
from tpu_patterns_torch.convert import params_from_jax, pool_from_numpy
from tpu_patterns_torch.models.transformer import ModelConfig
from tpu_patterns_torch.serve import engine as tengine
from tpu_patterns_torch.serve.engine import Request, ServeEngine
from tpu_patterns_torch.serve.paged import make_paged_lm_decoder

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

VOCAB = 64
MODEL = dict(embed=64, heads=8, head_dim=8, dtype="float32", depth=2,
             rope=True)
BL, N_BLOCKS, MAX_LEN = 8, 24, 40
POOL_TOL = 1e-5


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))


@functools.lru_cache(maxsize=None)
def _flat(kv_heads):
    jcfg = JModelConfig(**MODEL, kv_heads=kv_heads)
    return {
        k: np.asarray(v)
        for k, v in j_init_lm_params(jax.random.key(0), jcfg, VOCAB).items()
    }


def _decoders(kv_heads, int8, attn, n_blocks=N_BLOCKS):
    jdec = j_make_decoder(
        _mesh(), JModelConfig(**MODEL, kv_heads=kv_heads), VOCAB,
        n_blocks=n_blocks, block_len=BL, max_len=MAX_LEN, cache_int8=int8,
        attn="dense",
    )
    cfg = ModelConfig(**MODEL, kv_heads=kv_heads)
    tdec = make_paged_lm_decoder(
        cfg, VOCAB, n_blocks=n_blocks, block_len=BL, max_len=MAX_LEN,
        cache_int8=int8, attn=attn, device="cpu",
    )
    jparams = jdec.stack_params(_flat(kv_heads))
    tparams = tdec.stack_params(params_from_jax(_flat(kv_heads), cfg))
    return jdec, jparams, tdec, tparams


def _pool(kv_heads, int8, rng):
    hkv = kv_heads or MODEL["heads"]
    shape = (MODEL["depth"], N_BLOCKS, BL, hkv, MODEL["head_dim"])
    if int8:
        return {
            "k": rng.randint(-127, 128, size=shape).astype(np.int8),
            "v": rng.randint(-127, 128, size=shape).astype(np.int8),
            "ks": rng.uniform(0.005, 0.02, size=shape[:-1]).astype(
                np.float32),
            "vs": rng.uniform(0.005, 0.02, size=shape[:-1]).astype(
                np.float32),
        }
    return {n: rng.randn(*shape).astype(np.float32) for n in ("k", "v")}


def _verify_inputs(w, rng):
    """Four rows: ragged positions mid-block, drafts of 0..w-1 tokens,
    row 2 inactive, and row 3 at the end of its table, so that its
    padding lanes lie past the table (clamped, written to TRASH)."""
    n_pages = -(-MAX_LEN // BL)
    rows = 4
    perm = 1 + rng.permutation(N_BLOCKS - 1)
    tables = perm[: rows * n_pages].reshape(rows, n_pages).astype(np.int32)
    tables[0, 3:] = 0  # row 0 owns 3 blocks
    toks = rng.randint(0, VOCAB, size=(rows, w)).astype(np.int32)
    lens = np.asarray([9, 17, 5, 30], np.int32)
    steps = np.asarray([3, 0, 4, n_pages * BL - 31], np.int32)
    n_draft = np.asarray([w - 1, 1, w - 1, 0], np.int32)
    active = np.asarray([True, True, False, True])
    return toks, lens, steps, n_draft, tables, active


VERIFY_CASES = {  # name -> (kv_heads, int8, port attention)
    "mha_f32_kernel": (0, False, "kernel"),
    "mha_f32_dense": (0, False, "dense"),
    "gqa_f32_kernel": (2, False, "kernel"),
    "gqa_f32_dense": (2, False, "dense"),
    "gqa_int8_kernel": (2, True, "kernel"),
    "mha_int8_dense": (0, True, "dense"),
}


@pytest.mark.parametrize("w", [2, 5])
@pytest.mark.parametrize("name", sorted(VERIFY_CASES))
def test_verify_matches_reference(name, w):
    kv_heads, int8, attn = VERIFY_CASES[name]
    rng = np.random.RandomState(len(name) + w)
    jdec, jparams, tdec, tparams = _decoders(kv_heads, int8, attn)
    pool = _pool(kv_heads, int8, rng)
    args = _verify_inputs(w, rng)
    jpool, jout = jdec.verify_jit(4, w)(
        jparams, {n: jax.numpy.asarray(a) for n, a in pool.items()}, *args
    )
    tpool = pool_from_numpy(pool)
    tout = tdec.verify(tparams, tpool, *args)
    assert tout.dtype == torch.int32 and tout.shape == (4, w)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert (tout[2] == 0).all()  # the inactive row
    for n, leaf in tpool.items():
        # block 0 absorbs colliding padding writes: its value is garbage
        got, want = leaf.numpy()[:, 1:], np.asarray(jpool[n])[:, 1:]
        if int8 and n in ("k", "v"):
            np.testing.assert_array_equal(got, want, err_msg=n)
        elif n in ("ks", "vs"):
            # max |k| / 127 of K/V that XLA and torch project with
            # different float rounding: equal to ~1e-6 relative
            np.testing.assert_allclose(got, want, rtol=POOL_TOL, atol=0,
                                       err_msg=n)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=POOL_TOL,
                                       err_msg=n)


def test_verify_kernel_equals_dense_and_step():
    """The wide step's first lane is the one-token step: on the same pool
    the kernel and dense verify return equal ids, and lane 0 equals
    ``step``'s id."""
    rng = np.random.RandomState(5)
    _, _, tdec, tparams = _decoders(2, False, "kernel")
    _, _, ddec, _ = _decoders(2, False, "dense")
    pool = _pool(2, False, rng)
    toks, lens, steps, n_draft, tables, active = _verify_inputs(5, rng)
    got = tdec.verify(tparams, pool_from_numpy(pool), toks, lens, steps,
                      n_draft, tables, active)
    dense = ddec.verify(tparams, pool_from_numpy(pool), toks, lens, steps,
                        n_draft, tables, active)
    one = tdec.step(tparams, pool_from_numpy(pool), toks[:, 0], lens, steps,
                    tables, active)
    assert torch.equal(got, dense)
    assert torch.equal(got[:, 0], one)


@pytest.mark.parametrize("k", [1, 4])
def test_draft_matches_reference(k):
    rng = np.random.RandomState(k)
    for _ in range(200):
        n = int(rng.randint(0, 24))
        ctx = rng.randint(0, 5, size=n).tolist()
        assert ServeEngine._draft(ctx, k) == JServeEngine._draft(ctx, k), ctx
    assert ServeEngine._draft([1, 2, 3, 1, 2], k) == [3, 1, 2][:k]


def _spec_cfg(**kw):
    return dict(vocab=VOCAB, requests=6, min_prompt=6, max_prompt=24,
                gen=9, seed=3, **kw)


@functools.lru_cache(maxsize=None)
def _reference_spec(kv_heads, int8, spec_k):
    trace = jengine._repetitive_trace(
        jengine.ServeConfig(**_spec_cfg()), np.random.RandomState(6)
    )
    jdec, jparams, _, _ = _decoders(kv_heads, int8, "kernel")
    eng = JServeEngine(jdec, jparams, slots=4, spec_k=spec_k)
    out = eng.run([JRequest(rid=r.rid, tokens=r.tokens, n_gen=r.n_gen)
                   for r in trace])
    assert not eng.failed and eng.leaked_blocks() == 0
    keys = ("steps", "tokens", "spec_steps", "spec_tokens", "spec_row_steps")
    return out, {k: eng.stats[k] for k in keys}


@pytest.mark.parametrize("attn", ["kernel", "dense"])
@pytest.mark.parametrize("kv_heads,int8", [(0, False), (2, True)],
                         ids=["mha_f32", "gqa_int8"])
def test_spec_engine_matches_reference(kv_heads, int8, attn):
    want, want_stats = _reference_spec(kv_heads, int8, 4)
    trace = tengine.repetitive_trace(
        tengine.ServeConfig(**_spec_cfg()), np.random.RandomState(6)
    )
    _, _, tdec, tparams = _decoders(kv_heads, int8, attn)
    eng = ServeEngine(tdec, tparams, slots=4, spec_k=4)
    out = eng.run([Request(r.rid, r.tokens, r.n_gen) for r in trace])
    assert out == want
    assert {k: eng.stats[k] for k in want_stats} == want_stats
    assert eng.stats["spec_tokens"] > eng.stats["spec_row_steps"]
    assert eng.leaked_blocks() == 0 and not eng.ref
    plain = ServeEngine(tdec, tparams, slots=4)
    assert plain.run([Request(r.rid, r.tokens, r.n_gen)
                      for r in trace]) == out
    assert eng.stats["steps"] < plain.stats["steps"]


def test_traces_draw_as_the_reference():
    """Both Records' traces, on a given stream and on their own seeds."""
    cfg = _spec_cfg(shared_prefix=10)
    for ours, ref in ((tengine.repetitive_trace, jengine._repetitive_trace),
                      (tengine.shared_trace, jengine._shared_trace)):
        got = ours(tengine.ServeConfig(**cfg), np.random.RandomState(8))
        want = ref(jengine.ServeConfig(**cfg), np.random.RandomState(8))
        if ours is tengine.shared_trace:
            assert got[1] == want[1]
            got, want = got[0], want[0]
        assert [(r.rid, r.tokens, r.n_gen) for r in got] == [
            (r.rid, r.tokens, r.n_gen) for r in want]
    cfg = tengine.ServeConfig(**cfg)
    jcfg = jengine.ServeConfig(**_spec_cfg(shared_prefix=10))
    assert [r.tokens for r in tengine.repetitive_trace(cfg)] == [
        r.tokens for r in jengine._repetitive_trace(
            jcfg, np.random.RandomState(jcfg.seed + 3))]
    assert [r.tokens for r in tengine.shared_trace(cfg)[0]] == [
        r.tokens for r in jengine._shared_trace(
            jcfg, np.random.RandomState(jcfg.seed + 2))[0]]
