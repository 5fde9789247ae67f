"""The port's copy-on-write prefix sharing against the JAX package's.

``PrefixIndex`` plans the same aliases and donors, and keeps the same
materialized and live sets, as the reference's over seeded random
insert/materialize/remove sequences.  The sharing engine retires the
reference engine's ids (equal to non-shared serving) with equal
``peak_blocks``, ``prefix_hit_blocks``, ``cow_copies`` and deferrals on
traces made to reach a CoW boundary copy (float32 and int8 pools),
same-wave sharing and a deferred request that admits by aliasing; after
every iteration the refcounts sum to the live table references and no
block leaks.  ``run_serve`` on the CPU with both features emits the
``prefix_share_*`` and ``spec_decode_*`` Records of the reference's
``run_serve`` on the same weights: same modes, keys, verdicts and
values."""

import dataclasses
import functools
import io

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_patterns.core.results import ResultWriter as JResultWriter
from tpu_patterns.models.lm import init_lm_params as j_init_lm_params
from tpu_patterns.models.transformer import ModelConfig as JModelConfig
from tpu_patterns.serve import Request as JRequest
from tpu_patterns.serve import ServeEngine as JServeEngine
from tpu_patterns.serve import engine as jengine
from tpu_patterns.serve import make_paged_lm_decoder as j_make_decoder
from tpu_patterns.serve.prefix import PrefixIndex as JPrefixIndex
from tpu_patterns_torch.convert import params_from_jax
from tpu_patterns_torch.core.results import ResultWriter
from tpu_patterns_torch.models.transformer import ModelConfig
from tpu_patterns_torch.serve import engine as tengine
from tpu_patterns_torch.serve.engine import Request, ServeEngine
from tpu_patterns_torch.serve.paged import TRASH_BLOCK, make_paged_lm_decoder
from tpu_patterns_torch.serve.prefix import PrefixIndex

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

VOCAB = 64
MODEL = dict(embed=64, heads=8, head_dim=8, dtype="float32", depth=2,
             rope=True)
BL, MAX_LEN = 8, 48


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


# -- the radix index ---------------------------------------------------------


def _plan_tuple(p):
    return (tuple(p.aliased), p.donor, p.donor_len)


@pytest.mark.parametrize("seed", range(6))
def test_index_matches_reference(seed):
    """Random prompts over a 3-token alphabet (so prefixes collide), each
    inserted under fresh block ids, materialized at random, and removed
    block by block in table order at random times; after every operation
    both indexes plan the same for a batch of probes and hold the same
    blocks."""
    rng = np.random.RandomState(seed)
    bl = 1 + seed % 4
    ours, ref = PrefixIndex(bl), JPrefixIndex(bl)
    live: list[list[int]] = []
    next_block = 1
    for _ in range(60):
        op = rng.randint(3)
        if op == 0 or not live:
            toks = rng.randint(0, 3, size=rng.randint(1, 6 * bl)).tolist()
            plan = ours.plan(toks)
            assert _plan_tuple(plan) == _plan_tuple(ref.plan(toks))
            n = -(-len(toks) // bl)
            table = list(plan.aliased) + list(
                range(next_block, next_block + n - len(plan.aliased)))
            next_block += n
            assert ours.insert(toks, table) == ref.insert(toks, table)
            live.append(table)
        elif op == 1:
            table = live[rng.randint(len(live))]
            ours.materialize(table)
            ref.materialize(table)
        else:
            table = live.pop(rng.randint(len(live)))
            held = {b for t in live for b in t}
            for b in table:
                if b not in held:
                    ours.remove_block(b)
                    ref.remove_block(b)
        assert ours.blocks() == ref.blocks() and len(ours) == len(ref)
        for _ in range(4):
            probe = rng.randint(0, 3, size=rng.randint(0, 6 * bl)).tolist()
            assert _plan_tuple(ours.plan(probe)) == _plan_tuple(
                ref.plan(probe))


def test_index_donor_needs_materialized_block():
    idx = PrefixIndex(4)
    assert idx.insert([1, 2, 3, 4, 5, 6, 7, 8], [7, 9]) == [7, 9]
    plan = idx.plan([1, 2, 3, 4, 5, 6, 0, 0])
    assert plan.aliased == (7,) and plan.donor is None
    idx.materialize([7, 9])
    plan = idx.plan([1, 2, 3, 4, 5, 6, 0, 0])
    assert (plan.aliased, plan.donor, plan.donor_len) == ((7,), 9, 2)
    assert plan.shared_len(4) == 6
    idx.remove_block(9)
    assert idx.plan([1, 2, 3, 4, 5, 6]).donor is None and len(idx) == 1


# -- the engine --------------------------------------------------------------


def _prompt(rng, n):
    return rng.randint(0, VOCAB, size=n).tolist()


def _traces():
    """name -> (requests as (rid, tokens, n_gen), slots, n_blocks)."""
    rng = np.random.RandomState(4)
    p20, p17 = _prompt(rng, 20), _prompt(rng, 17)
    # a CoW boundary: A's prompt is prefilled and materialized while A
    # runs; B shares 20 tokens with it, two whole blocks and 4 tokens of
    # A's third, so B aliases two blocks and copies the third
    cow = ([(0, p20 + _prompt(rng, 10), 8), (1, _prompt(rng, 9), 1),
            (2, p20 + _prompt(rng, 6), 5)], 2, 17)
    # same-wave sharing: three rows of one prefill wave alias the blocks
    # the first of them writes in that same call
    wave = ([(i, p17 + _prompt(rng, 3 + i), 6) for i in range(3)]
            + [(3, _prompt(rng, 12), 4)], 4, 25)
    # a deferral: X and A fill the pool; B (A's prefix) cannot get even
    # its two fresh blocks, defers, and admits once X retires, aliasing
    # A's blocks while A still runs (without sharing it waits for A)
    defer = ([(0, _prompt(rng, 10), 3), (1, p20 + _prompt(rng, 10), 12),
              (2, p20 + _prompt(rng, 6), 4)], 3, 10)
    return {"cow": cow, "same_wave": wave, "defer": defer}


TRACES = _traces()


@functools.lru_cache(maxsize=None)
def _reference(name, kv_heads, int8, share):
    reqs, slots, n_blocks = TRACES[name]
    jdec = j_make_decoder(
        _mesh(), JModelConfig(**MODEL, kv_heads=kv_heads), VOCAB,
        n_blocks=n_blocks, block_len=BL, max_len=MAX_LEN, cache_int8=int8,
        attn="dense",
    )
    eng = JServeEngine(jdec, jdec.stack_params(_flat(kv_heads)),
                       slots=slots, prefix_share=share)
    out = eng.run([JRequest(rid=r, tokens=t, n_gen=g) for r, t, g in reqs])
    assert not eng.failed and eng.leaked_blocks() == 0
    keys = ("peak_blocks", "prefix_hit_blocks", "cow_copies", "deferrals",
            "steps", "tokens")
    return out, {k: eng.stats[k] for k in keys}


class _Checked(ServeEngine):
    """The engine with its refcount invariants checked after every
    decode step: the refcounts sum to the live table references, every
    live block is counted, and no allocated block is unreferenced."""

    def _check(self):
        refs = [b for s in self.active for b in s.table if b != TRASH_BLOCK]
        assert sum(self.ref.values()) == len(refs)
        assert set(self.ref) == set(refs)
        assert self.leaked_blocks() == 0
        self.checks += 1

    def _step(self):
        super()._step()
        self._check()


def _port(name, kv_heads, int8, attn, share):
    reqs, slots, n_blocks = TRACES[name]
    cfg = ModelConfig(**MODEL, kv_heads=kv_heads)
    dec = make_paged_lm_decoder(
        cfg, VOCAB, n_blocks=n_blocks, block_len=BL, max_len=MAX_LEN,
        cache_int8=int8, attn=attn, device="cpu",
    )
    params = dec.stack_params(params_from_jax(_flat(kv_heads), cfg))
    eng = _Checked(dec, params, slots=slots, prefix_share=share)
    eng.checks = 0
    out = eng.run([Request(r, list(t), g) for r, t, g in reqs])
    assert eng.checks > 0 and not eng.ref and eng.leaked_blocks() == 0
    assert sorted(eng.free) == list(range(1, n_blocks))
    return out, eng


ENGINE_CASES = {  # name -> (trace, kv_heads, int8)
    "cow_f32": ("cow", 0, False),
    "cow_gqa_int8": ("cow", 2, True),
    "same_wave_f32": ("same_wave", 0, False),
    "same_wave_int8": ("same_wave", 0, True),
    "defer_gqa_f32": ("defer", 2, False),
}


@pytest.mark.parametrize("attn", ["kernel", "dense"])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_prefix_engine_matches_reference(case, attn):
    name, kv_heads, int8 = ENGINE_CASES[case]
    want, want_stats = _reference(name, kv_heads, int8, True)
    out, eng = _port(name, kv_heads, int8, attn, True)
    assert out == want
    assert {k: eng.stats[k] for k in want_stats} == want_stats
    plain, plain_eng = _port(name, kv_heads, int8, attn, False)
    assert plain == out
    assert plain_eng.stats["prefix_hit_blocks"] == 0
    assert eng.stats["prefix_hit_blocks"] > 0
    if name == "cow":
        assert eng.stats["cow_copies"] == 1
    if name == "same_wave":
        assert eng.stats["prefix_hit_blocks"] == 4
        assert eng.stats["peak_blocks"] < plain_eng.stats["peak_blocks"]
    if name == "defer":
        assert eng.stats["deferrals"] > 0
        assert plain_eng.stats["deferrals"] > eng.stats["deferrals"]


def test_copy_blocks_clones_every_leaf():
    cfg = ModelConfig(**MODEL, kv_heads=2)
    dec = make_paged_lm_decoder(cfg, VOCAB, n_blocks=6, block_len=BL,
                                max_len=MAX_LEN, cache_int8=True,
                                device="cpu")
    pool = dec.init_pool()
    g = torch.Generator().manual_seed(0)
    for n, leaf in pool.items():
        leaf.copy_(torch.randint(-100, 100, leaf.shape, generator=g))
    before = {n: t.clone() for n, t in pool.items()}
    dec.copy_blocks(pool, np.asarray([3, 1, 0, 0], np.int32),
                    np.asarray([5, 2, 0, 0], np.int32))
    for n, leaf in pool.items():
        assert torch.equal(leaf[:, 5], before[n][:, 3])
        assert torch.equal(leaf[:, 2], before[n][:, 1])
        for b in (1, 3, 4):
            assert torch.equal(leaf[:, b], before[n][:, b])


# -- the Records -------------------------------------------------------------

RECORD_CFG = dict(vocab=VOCAB, embed=32, heads=4, head_dim=8, depth=1,
                  requests=8, min_prompt=4, max_prompt=32, gen=6, slots=4,
                  block_len=8, min_speedup=0.0, spec_k=4, prefix_share=True)


def test_run_serve_records_match_reference(monkeypatch):
    """``run_serve`` with both features on the reference's weights
    (handed over for the port's own ``init_lm_params``): the port's
    ``prefix_share_*`` and ``spec_decode_*`` Records equal the
    reference's in mode, commands, metric keys and values and verdict;
    the main Record comes first."""
    jcfg = jengine.ServeConfig(**RECORD_CFG)
    buf = io.StringIO()
    jrecs = jengine.run_serve(_mesh(), jcfg, JResultWriter(stream=buf))
    jmcfg = JModelConfig(
        embed=jcfg.embed, heads=jcfg.heads, head_dim=jcfg.head_dim,
        mlp_mult=jcfg.mlp_mult, causal=True, dtype=jcfg.dtype,
        depth=jcfg.depth, kv_heads=jcfg.kv_heads, rope=jcfg.rope,
    )  # run_serve's
    flat = {k: np.asarray(v) for k, v in j_init_lm_params(
        jax.random.key(jcfg.seed), jmcfg, VOCAB).items()}

    def reference_weights(seed, mcfg, vocab, device):
        return params_from_jax(flat, mcfg)

    monkeypatch.setattr(tengine, "init_lm_params", reference_weights)
    cfg = tengine.ServeConfig(**RECORD_CFG, device="cpu")
    recs = tengine.run_serve(cfg, ResultWriter(stream=io.StringIO()))
    assert [r.mode for r in recs] == [
        "slots4_bl8_sp1", "prefix_share_req8_bl8_sp1", "spec_decode_k4_sp1"]
    assert recs[0].verdict.value == "SUCCESS", recs[0].notes
    assert len(jrecs) == 2
    for got, want in zip(recs[1:], jrecs):
        assert (got.mode, got.commands) == (want.mode, want.commands)
        assert got.metrics == want.metrics
        assert got.verdict.value == want.verdict.value == "SUCCESS", (
            got.notes, want.notes)
    spec = recs[2].metrics
    assert spec["accepted_tokens_per_step"] > 1.0 and spec["exact"] == 1.0
    assert recs[1].metrics["leaked_blocks"] == 0.0


def test_serve_config_defaults_match_reference():
    names = ("prefix_share", "shared_prefix", "min_block_savings", "spec_k",
             "min_accepted")
    ours = {f.name: f.default for f in dataclasses.fields(tengine.ServeConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jengine.ServeConfig)}
    assert {n: ours[n] for n in names} == {n: ref[n] for n in names}
