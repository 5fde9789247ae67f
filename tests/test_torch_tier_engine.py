"""The port's tiered, preempting and snapshot-resumed serve engine
against the JAX package's.

One set of weights (made by the reference, handed over as numpy), a
small width (depth 1, embed 64, float32): the reference ``ServeEngine``
on a (1, 1, 1) CPU mesh and the port's on the CPU serve the same traces
and must retire identical ids with equal tier, preemption and snapshot
stats.  Covered: the session trace with the tier on and off, a block
gathered and onloaded bit for bit, interactive rows preempting bulk
(greedy and sampled), the preempt fault failing open, the evict and
onload faults falling back, ``serve.step:preempt`` then
``restore_snapshot`` in a fresh engine (``engine.json`` as the
reference writes it at format 3), a session restart with no history
prefilled, the ``run_serve`` and loadgen Records, and the CLI's
flags."""

import ast
import dataclasses
import functools
import inspect
import io
import json
from collections import Counter

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_patterns import ckpt as jckpt
from tpu_patterns import faults as jfaults
from tpu_patterns.loadgen import runner as jrunner
from tpu_patterns.models.lm import init_lm_params as j_init_lm_params
from tpu_patterns.models.transformer import ModelConfig as JModelConfig
from tpu_patterns.serve import Request as JRequest
from tpu_patterns.serve import ServeConfig as JServeConfig
from tpu_patterns.serve import ServeEngine as JServeEngine
from tpu_patterns.serve import engine as jengine
from tpu_patterns.serve import make_paged_lm_decoder as j_make_decoder
from tpu_patterns.serve import run_serve as j_run_serve
from tpu_patterns.core.results import ResultWriter as JResultWriter
from tpu_patterns_torch import ckpt as tckpt
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch import faults as tfaults
from tpu_patterns_torch.convert import params_from_jax
from tpu_patterns_torch.core.results import ResultWriter
from tpu_patterns_torch.loadgen.runner import LoadGenConfig, run_loadgen
from tpu_patterns_torch.models.transformer import ModelConfig
from tpu_patterns_torch.serve.engine import (
    SNAPSHOT_FORMAT,
    Request,
    ServeConfig,
    ServeEngine,
    run_serve,
)
from tpu_patterns_torch.serve.paged import TRASH_BLOCK, make_paged_lm_decoder

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

VOCAB = 64
MODEL = dict(embed=64, heads=8, head_dim=8, dtype="float32", depth=1)
TIER_KEYS = ("evictions", "onload_hits", "pressure_admits", "deferrals",
             "retained_peak", "prompt_fresh_full_blocks", "steps",
             "evict_bytes", "onload_bytes", "tier_fallbacks",
             "session_loaded", "preempted", "preempted_resumed")


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in (jfaults, tfaults):
        pkg.configure(None)
    yield
    for pkg in (jfaults, tfaults):
        pkg.configure(None)


@functools.lru_cache(maxsize=None)
def _flat():
    jcfg = JModelConfig(**MODEL)
    return {k: np.asarray(v) for k, v in
            j_init_lm_params(jax.random.key(0), jcfg, VOCAB).items()}


@functools.lru_cache(maxsize=None)
def _ref(n_blocks, sampling=False):
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))
    dec = j_make_decoder(mesh, JModelConfig(**MODEL), VOCAB,
                         n_blocks=n_blocks, block_len=8, max_len=40,
                         attn="dense", sampling=sampling)
    return dec, dec.stack_params(_flat())


@functools.lru_cache(maxsize=None)
def _port(n_blocks, sampling=False, cache_int8=False):
    cfg = ModelConfig(**MODEL)
    dec = make_paged_lm_decoder(cfg, VOCAB, n_blocks=n_blocks, block_len=8,
                                max_len=40, sampling=sampling,
                                cache_int8=cache_int8, device="cpu")
    return dec, dec.stack_params(params_from_jax(_flat(), cfg))


def _conv_reqs(n_conv, cls, n_gen=4, seed=4):
    """The reference test's conversation trace: a shared 2-block system
    prompt, a private history growing a block a turn, turn-major."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, VOCAB, size=16).tolist()
    convs = [rng.randint(0, VOCAB, size=16).tolist() for _ in range(n_conv)]
    return [cls(rid=turn * n_conv + g, tokens=shared + convs[g][: 8 * (turn + 1)],
                n_gen=n_gen)
            for turn in range(2) for g in range(n_conv)]


def _mixed_reqs(cls, sampled=False, seed=9):
    """The reference test's priority trace: 2 bulk rows first (they
    admit and run), 2 interactive behind them."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(4):
        bulk = i < 2
        kw = dict(temperature=0.8, top_k=16, seed=40 + i) if sampled else {}
        reqs.append(cls(
            rid=i, tokens=rng.randint(0, VOCAB,
                                      size=rng.randint(9, 14)).tolist(),
            n_gen=8 if bulk else 3,
            priority="bulk" if bulk else "interactive", **kw))
    return reqs


def _shared_reqs(cls, n=5, seed=3):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, VOCAB, size=16).tolist()
    return [cls(rid=i, tokens=shared + rng.randint(
        0, VOCAB, size=rng.randint(1, 6)).tolist(), n_gen=6)
            for i in range(n)]


def _invariants(eng):
    """The tiered refcount contract (the reference test's): refcounts
    mirror live table references, retained blocks are allocated with no
    reference, the free list is disjoint from the indexed and retained
    sets, the host-resident handles are the tier's, nothing leaks."""
    live = Counter(b for s in eng.active for b in s.table if b != TRASH_BLOCK)
    assert dict(eng.ref) == dict(live)
    allocated = set(range(1, eng.layout.n_blocks)) - set(eng.free)
    assert allocated == set(live) | set(eng.retained)
    assert not set(eng.free) & (eng.index.blocks() | set(eng.retained))
    assert eng.index.host_handles() == set(eng.tier.store)
    assert eng.leaked_blocks() == 0


def _serve_both(n_blocks, trace_fn, slots, sampling=False, **kw):
    jdec, jparams = _ref(n_blocks, sampling)
    tdec, tparams = _port(n_blocks, sampling)
    jeng = JServeEngine(jdec, jparams, slots=slots, **kw)
    want = jeng.run(trace_fn(JRequest))
    teng = ServeEngine(tdec, tparams, slots=slots, **kw)
    got = teng.run(trace_fn(Request))
    return got, want, teng, jeng


def _stats(eng):
    return {k: eng.stats[k] for k in TIER_KEYS}


@pytest.mark.parametrize("tier", [False, True])
def test_session_trace_matches_reference(tier):
    got, want, teng, jeng = _serve_both(
        15, lambda cls: _conv_reqs(6, cls), 4, kv_host_tier=tier)
    assert got == want
    assert _stats(teng) == _stats(jeng)
    if tier:
        assert teng.stats["evictions"] > 0 and teng.stats["onload_hits"] > 0
        assert teng.stats["deferrals"] == 0 < jeng.stats["pressure_admits"]
        _invariants(teng)
    else:
        assert teng.stats["deferrals"] > 0


@pytest.mark.parametrize("int8", [False, True])
def test_gather_then_onload_is_bit_identical(int8):
    """gather reads without writing; onload writes in place; the blocks
    come back bit for bit, scales included.  Then the engine: every
    block it restores equals what it evicted."""
    dec, params = _port(15, cache_int8=int8)
    pool = dec.init_pool()
    g = torch.Generator().manual_seed(1)
    for leaf in pool.values():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=g))
    before = {n: t.clone() for n, t in pool.items()}
    ptrs = {n: t.data_ptr() for n, t in pool.items()}
    out = {n: t.to("cpu") for n, t in dec.gather_blocks(pool, [3, 5]).items()}
    for n in pool:
        assert torch.equal(pool[n], before[n])
    dec.onload_blocks(pool, out, [7, 2])
    assert {n: t.data_ptr() for n, t in pool.items()} == ptrs
    for n in pool:
        assert torch.equal(pool[n][:, 7], before[n][:, 3])
        assert torch.equal(pool[n][:, 2], before[n][:, 5])
        assert torch.equal(pool[n][:, 9], before[n][:, 9])

    eng = ServeEngine(dec, params, slots=4, kv_host_tier=True)
    stored, checked = {}, []
    evict, restore = eng.index.evict_block, eng.index.restore_block

    def evict_hook(block, handle):
        stored[handle] = {n: t.clone() for n, t in
                          eng.tier.get(handle).items()}
        evict(block, handle)

    def restore_hook(handle, block):
        restore(handle, block)
        got = dec.gather_blocks(eng.pool, [block])
        for n, t in stored[handle].items():
            assert torch.equal(got[n][:, 0], t)
        checked.append(handle)

    eng.index.evict_block, eng.index.restore_block = evict_hook, restore_hook
    ptrs = eng.pool_ptrs()
    eng.run(_conv_reqs(6, Request))
    assert checked and len(checked) == eng.stats["onload_hits"]
    assert eng.pool_ptrs() == ptrs


@pytest.mark.parametrize("sampled", [False, True])
def test_interactive_preempts_bulk_matches_reference(sampled):
    got, want, teng, jeng = _serve_both(
        21, lambda cls: _mixed_reqs(cls, sampled), 2, sampling=sampled,
        kv_host_tier=True, preempt="bulk")
    assert got == want
    assert _stats(teng) == _stats(jeng)
    tdec, tparams = _port(21, sampled)
    plain = ServeEngine(tdec, tparams, slots=2).run(_mixed_reqs(Request,
                                                                sampled))
    assert got == plain  # the stitched streams equal unpreempted ones
    assert teng.stats["preempted"] >= 1 and teng.stats["preempted_resumed"] >= 1
    assert not teng.preempted_partial and not teng.preempted_first_ns
    assert {rid: lc["n_out"] for rid, lc in teng.lifecycle.items()} == {
        r.rid: r.n_gen for r in _mixed_reqs(Request, sampled)}
    _invariants(teng)


def test_preempt_fault_fails_open():
    jfaults.configure("serve.preempt:error:count=99")
    tfaults.configure("serve.preempt:error:count=99")
    got, want, teng, jeng = _serve_both(
        21, lambda cls: _mixed_reqs(cls), 2, kv_host_tier=True,
        preempt="bulk")
    assert got == want
    assert teng.stats["preempted"] == 0 == jeng.stats["preempted"]
    assert _stats(teng) == _stats(jeng)
    _invariants(teng)


@pytest.mark.parametrize("count", [1, 1000000])
def test_evict_fault_retries_or_falls_back(count, capsys):
    """One error retries through; an error on every try discards the
    wave (no host copy, a WARNING Record on stderr) and the run stays
    exact, as in the reference."""
    jfaults.configure(f"serve.evict:error:count={count}")
    tfaults.configure(f"serve.evict:error:count={count}")
    got, want, teng, jeng = _serve_both(
        15, lambda cls: _conv_reqs(6, cls), 4, kv_host_tier=True)
    assert got == want
    assert _stats(teng) == _stats(jeng)
    if count == 1:
        assert teng.stats["evictions"] > 0
        assert teng.stats["tier_fallbacks"] == 0
    else:
        assert teng.stats["evictions"] == 0 and len(teng.tier) == 0
        assert teng.stats["tier_fallbacks"] > 0
        assert "kv_tier_fallback" in capsys.readouterr().err
    _invariants(teng)


def test_onload_fault_prefills_fresh(tmp_path):
    dec, params = _port(15)
    sd = str(tmp_path / "sess")
    first = ServeEngine(dec, params, slots=4, kv_host_tier=True,
                        session_dir=sd, fingerprint={"t": 2})
    want = first.run(_conv_reqs(6, Request))
    eng = ServeEngine(dec, params, slots=4, kv_host_tier=True,
                      session_dir=sd, fingerprint={"t": 2})
    assert eng.stats["session_loaded"] > 0
    tfaults.configure("serve.onload:error:count=99")
    got = eng.run(_conv_reqs(6, Request))
    assert got == want
    assert eng.stats["onload_hits"] == 0 and eng.stats["tier_fallbacks"] > 0
    assert eng.stats["prompt_fresh_full_blocks"] > 0
    assert eng.leaked_blocks() == 0


def test_session_restart_prefills_no_history(tmp_path):
    """A second engine over the committed session adopts its blocks and
    prefills none of the history, with the reference's counts."""
    counts = []
    for pkg, (dec, params), cls, Eng in (
            ("jax", _ref(15), JRequest, JServeEngine),
            ("torch", _port(15), Request, ServeEngine)):
        sd = str(tmp_path / pkg)
        kw = dict(slots=4, kv_host_tier=True, session_dir=sd,
                  fingerprint={"t": 1})
        out1 = Eng(dec, params, **kw).run(_conv_reqs(6, cls))
        eng = Eng(dec, params, **kw)
        loaded = eng.stats["session_loaded"]
        assert eng.run(_conv_reqs(6, cls)) == out1
        assert eng.stats["prompt_fresh_full_blocks"] == 0
        counts.append((loaded, {k: eng.stats[k] for k in TIER_KEYS
                                if k != "session_loaded"}, out1))
    assert counts[0] == counts[1]


def _preempted_run(pkg, dec, params, trace, snap, after, **kw):
    pkg_faults, Eng = (jfaults, JServeEngine) if pkg == "jax" else (
        tfaults, ServeEngine)
    pkg_faults.configure(f"serve.step:preempt:after={after}:count=1")
    try:
        eng = Eng(dec, params, snapshot_dir=snap, fingerprint={"t": "idx"},
                  **kw)
        eng.run(trace)
    finally:
        pkg_faults.configure(None)
    return eng


@pytest.mark.parametrize("case", ["shared", "tier_preempt", "sampled"])
def test_step_preempt_snapshot_and_resume(case, tmp_path):
    """``serve.step:preempt`` snapshots at the iteration boundary; a
    fresh engine restores index, refcounts and queues and finishes the
    trace with the ids of an uninterrupted run.  ``engine.json`` holds
    what the reference's holds at format 3."""
    if case == "shared":
        n_blocks, sampled, kw, after = 17, False, dict(
            slots=3, prefix_share=True), 2
        trace = functools.partial(_shared_reqs)
    else:
        n_blocks, sampled, kw, after = 21, case == "sampled", dict(
            slots=2, kv_host_tier=True, preempt="bulk"), 3
        trace = functools.partial(_mixed_reqs, sampled=sampled)
    tdec, tparams = _port(n_blocks, sampled)
    jdec, jparams = _ref(n_blocks, sampled)
    want = ServeEngine(tdec, tparams, **kw).run(trace(Request))
    teng = _preempted_run("torch", tdec, tparams, trace(Request),
                          str(tmp_path / "t"), after, **kw)
    jeng = _preempted_run("jax", jdec, jparams, trace(JRequest),
                          str(tmp_path / "j"), after, **kw)
    assert teng.preempted_at == jeng.preempted_at is not None
    tstate = json.loads(tckpt.read_extra(str(tmp_path / "t"), "engine.json"))
    jstate = json.loads(jckpt.read_extra(str(tmp_path / "j"), "engine.json"))
    assert tstate["format"] == jstate["format"] == SNAPSHOT_FORMAT == 3
    assert set(tstate) == set(jstate)
    for key in ("queue", "active", "free", "ref", "index", "done", "shed",
                "preempted_partial", "preempted_rids", "retained", "tier"):
        assert tstate.get(key) == jstate.get(key), key
    assert set(tstate["preempted_first_ns"]) == set(
        jstate["preempted_first_ns"])
    common = set(tstate["stats"]) & set(jstate["stats"])
    assert {k: tstate["stats"][k] for k in common} == {
        k: jstate["stats"][k] for k in common}
    if case != "shared":
        assert teng.preempted_partial and teng.stats["preempted"] >= 1

    fresh = ServeEngine(tdec, tparams, snapshot_dir=str(tmp_path / "t"),
                        fingerprint={"t": "idx"}, **kw)
    assert fresh.restore_snapshot() == teng.preempted_at
    assert fresh.index.to_state() == teng.index.to_state()
    assert fresh.ref == teng.ref
    assert fresh.run([]) == want
    if case != "shared":
        assert fresh.stats["preempted_resumed"] >= 1
        _invariants(fresh)
    other = ServeEngine(tdec, tparams, snapshot_dir=str(tmp_path / "t"),
                        fingerprint={"t": "other"}, **kw)
    with pytest.raises(ValueError, match=r"mismatched: \['t'\]"):
        other.restore_snapshot()


def _metric_keys(fn):
    """Each ``metrics={...}`` dict literal's keys in ``fn``'s source, in
    source order."""
    found = [
        node.value for node in ast.walk(ast.parse(inspect.getsource(fn)))
        if isinstance(node, ast.keyword) and node.arg == "metrics"
        and isinstance(node.value, ast.Dict)
    ]
    return [{k.value for k in d.keys}
            for d in sorted(found, key=lambda d: d.lineno)]


KV_TIER_DETERMINISTIC = ("exact", "deferrals", "defer_baseline_deferrals",
                         "pressure_admits", "evictions", "evict_MB",
                         "onload_hits", "onload_MB", "retained_peak",
                         "tier_fallbacks", "decode_steps",
                         "defer_decode_steps", "leaked_blocks")


def test_run_serve_kv_tier_records_match_reference(tmp_path):
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))
    kw = dict(vocab=VOCAB, embed=64, head_dim=8, depth=1, requests=12,
              gen=6, slots=4, block_len=8, kv_host_tier=True)
    (jrec,) = j_run_serve(mesh, JServeConfig(**kw),
                          JResultWriter(stream=io.StringIO()))
    (rec,) = run_serve(ServeConfig(**kw, device="cpu"),
                       ResultWriter(stream=io.StringIO()))
    assert rec.mode == jrec.mode and set(rec.metrics) == set(jrec.metrics)
    assert {k: rec.metrics[k] for k in KV_TIER_DETERMINISTIC} == {
        k: jrec.metrics[k] for k in KV_TIER_DETERMINISTIC}
    assert rec.metrics["exact"] == 1.0 and rec.metrics["evictions"] > 0
    sess = dict(kw, session_dir=str(tmp_path / "sess"))
    recs = [run_serve(ServeConfig(**sess, device="cpu"),
                      ResultWriter(stream=io.StringIO()))[0]
            for _ in range(2)]
    (want_keys,) = _metric_keys(jengine._kv_session_record)
    for r in recs:
        assert r.verdict.value == "SUCCESS" and set(r.metrics) == want_keys
    assert recs[0].metrics["session_loaded"] == 0
    assert recs[1].metrics["session_loaded"] > 0
    assert recs[1].metrics["prompt_fresh_full_blocks"] == 0


def test_run_serve_preempt_resume_records(tmp_path):
    """``--snapshot_dir`` preempted by ``serve.step:preempt`` writes the
    reference's WARNING Record; ``--resume`` its SUCCESS one, exact, the
    ids file holding every request; a changed flag refuses to resume,
    naming it."""
    snap, ids = str(tmp_path / "snap"), str(tmp_path / "ids.json")
    base = dict(vocab=VOCAB, embed=64, head_dim=8, depth=1, requests=6,
                gen=8, slots=4, block_len=8, min_prompt=4, max_prompt=24,
                snapshot_dir=snap, device="cpu")
    tfaults.configure("serve.step:preempt:after=3:count=1")
    try:
        (rec,) = run_serve(ServeConfig(**base),
                           ResultWriter(stream=io.StringIO()))
    finally:
        tfaults.configure(None)
    warn_keys, done_keys = _metric_keys(jengine._run_preemptible)
    assert rec.verdict.value == "WARNING" and set(rec.metrics) == warn_keys
    assert rec.metrics["preempted"] == 1.0
    step = rec.metrics["snapshot_step"]
    with pytest.raises(ValueError, match=r"mismatched: \['seed'\]"):
        run_serve(ServeConfig(**dict(base, seed=1), resume=True),
                  ResultWriter(stream=io.StringIO()))
    (rec,) = run_serve(ServeConfig(**base, resume=True, ids_out=ids),
                       ResultWriter(stream=io.StringIO()))
    assert rec.verdict.value == "SUCCESS" and set(rec.metrics) == done_keys
    assert rec.metrics["exact"] == 1.0
    assert rec.metrics["resumed_from"] == step
    with open(ids) as f:
        assert sorted(int(k) for k in json.load(f)["done"]) == list(range(6))


def test_kv_tier_loadgen_record_keys_and_verdict():
    """The loadgen race on the reference's tier-race traffic (its
    ``serve.kv_tier`` sweep cell, token lengths doubled for block_len
    16): the reference's metric keys; the tier never defers where the
    defer-only leg does, decodes in fewer steps, evicts and leaks
    nothing; the verdict is the gates read off its own metrics."""
    cfg = LoadGenConfig(
        vocab=512, embed=64, head_dim=8, depth=1, device="cpu",
        kv_host_tier=True, time_scale=0.02,
        scenarios=("chat:requests=16:min_prompt=52:mean_prompt=56"
                   ":max_prompt=60:min_gen=16:mean_gen=18:max_gen=20"
                   ":prefix_groups=1:shared_prefix=32:working_set_mult=1.4"
                   ":slo_ttft_ms=60000:slo_tpot_ms=20000",))
    main, race = run_loadgen(cfg, ResultWriter(stream=io.StringIO()))
    assert main.mode == "chat_sp1" and race.mode == "chat_kv_tier_sp1"
    (want_keys,) = _metric_keys(jrunner._kv_tier_loadgen_record)
    m = race.metrics
    assert set(m) == want_keys
    assert m["deferrals"] == 0 < m["defer_baseline_deferrals"]
    assert race.config["decode_steps"] < race.config["defer_decode_steps"]
    assert m["evictions"] > 0 and m["leaked_blocks"] == 0
    ok = (m["tokens_per_s"] > m["defer_tokens_per_s"]
          and m["goodput"] >= m["defer_goodput"])
    assert (race.verdict.value == "SUCCESS") == ok


def test_cli_takes_the_tier_flags_and_refuses_the_rest(capsys):
    parser = tcli.build_parser()
    args = parser.parse_args([
        "serve", "--snapshot_dir", "s", "--resume", "true", "--ids_out",
        "i.json", "--kv_host_tier", "true", "--session_dir", "d",
        "--host_tier_blocks", "4", "--min_tier_speedup", "1.5",
        "--preempt", "bulk"])
    assert (args.snapshot_dir, args.resume, args.ids_out, args.kv_host_tier,
            args.session_dir, args.host_tier_blocks, args.min_tier_speedup,
            args.preempt) == ("s", True, "i.json", True, "d", 4, 1.5, "bulk")
    args = parser.parse_args(["loadgen", "--kv_host_tier", "true",
                              "--preempt", "bulk", "--session_dir", "d"])
    assert (args.kv_host_tier, args.preempt, args.session_dir) == (
        True, "bulk", "d")
    # the fleet prefix store parses since the replica fleet was ported;
    # without --replicas it is refused before anything runs, as the
    # reference refuses it
    assert parser.parse_args(["serve", "--prefix_store", "p"]).prefix_store \
        == "p"
    # the watchdog's deadline is taken now (the recovery and obs slice)
    assert parser.parse_args(["serve", "--watchdog_s", "5"]).watchdog_s == 5
    assert parser.parse_args(["loadgen", "--watchdog_s", "5"]).watchdog_s == 5
    for argv in (["serve", "--preempt", "bulk"],
                 ["serve", "--resume", "true"],
                 ["serve", "--session_dir", "d"],
                 ["serve", "--prefix_store", "p", "--kv_host_tier", "true"]):
        with pytest.raises(SystemExit) as e:
            tcli.main(argv + ["--device", "cpu"])
        assert "error" in str(e.value.code)
    # an error at the decode step retries and quarantines: the spec
    # parses as the reference's does
    for text in ("serve.step:error:count=1", "serve.verify:error",
                 "serve.prefill:error:count=99"):
        assert [dataclasses.asdict(s) for s in tfaults.parse_spec(text)] == [
            dataclasses.asdict(s) for s in jfaults.parse_spec(text)]
    assert tfaults.parse_spec("serve.step:preempt:after=2:count=1")
    assert tfaults.parse_spec("serve.evict:error,serve.onload:sleep")


def test_loadgen_counts_preemptions():
    """A bulk/interactive chat mix over 2 slots with ``preempt="bulk"``:
    the Record reads the engine's preemptions (every preempted request
    resumed and retired), with the reference's metric keys."""
    cfg = LoadGenConfig(
        vocab=512, embed=64, head_dim=8, depth=1, device="cpu", slots=2,
        kv_host_tier=True, preempt="bulk", time_scale=0.001,
        scenarios=("chat:requests=8:bulk_fraction=0.5",))
    (rec,) = run_loadgen(cfg, ResultWriter(stream=io.StringIO()))
    (main_keys,) = _metric_keys(jrunner.run_loadgen)
    m = rec.metrics
    assert main_keys <= set(m) and rec.verdict.value == "SUCCESS"
    assert m["preempted"] >= 1 and m["preempted_resumed"] >= 1
    assert m["done"] == m["requests"] == 8
