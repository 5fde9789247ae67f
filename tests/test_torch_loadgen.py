"""The port's load generator (``tpu_patterns_torch/loadgen``) against the
JAX package's.

* The copied modules: arrival offsets, percentile sketches, parsed
  scenarios and built schedules equal the reference's for every preset
  and seeds 0, 1 and 7, with and without ``time_scale``, shared prefixes
  and a bulk fraction; the reference's own cases for arrivals, the
  sketch, the grammar, replay and the ``loadgen.arrive`` site hold on the
  port.
* The sampled serve path: a sampling ``PagedDecoder`` and ``ServeEngine``
  driven by ``ArrivalSource`` on ``chat-sampled:requests=8`` retire ids
  equal to both the port's and the reference's fixed-seed oracle on the
  same weights, at ``spec_k`` 0 and 2, through the kernel's plain version
  and the dense gather.
* ``run_loadgen`` on the CPU: Records with the reference Records'
  pattern, mode, metric keys and verdicts, and the CLI around it.

No test gates on a wall-clock latency.
"""

import dataclasses
import functools
import json
import random

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from tpu_patterns import faults as jf
from tpu_patterns import loadgen as jl
from tpu_patterns.core.results import ResultWriter as JResultWriter
from tpu_patterns.core.results import Verdict as JVerdict
from tpu_patterns.models.lm import init_lm_params as j_init_lm_params
from tpu_patterns.models.transformer import ModelConfig as JModelConfig
from tpu_patterns.serve import engine as jengine
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch import faults as tf
from tpu_patterns_torch import loadgen as tl
from tpu_patterns_torch.convert import params_from_jax
from tpu_patterns_torch.core.results import ResultWriter, Verdict
from tpu_patterns_torch.core.timing import clock_ns
from tpu_patterns_torch.loadgen.runner import _resolved_specs
from tpu_patterns_torch.models.transformer import ModelConfig
from tpu_patterns_torch.serve.engine import Request, ServeEngine
from tpu_patterns_torch.serve.engine import _oracle_expected
from tpu_patterns_torch.serve.paged import make_paged_lm_decoder

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

PRESETS = sorted(jl.PRESETS)
REQ_FIELDS = ("rid", "tokens", "n_gen", "scenario", "deadline_ms",
              "priority", "temperature", "top_k", "top_p", "seed",
              "gen_offset")


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in (jf, tf):
        pkg.configure(None)
    yield
    for pkg in (jf, tf):
        pkg.configure(None)


def _rows(schedule):
    return [(tr.arrival_s, tuple(getattr(tr.request, f) for f in REQ_FIELDS))
            for tr in schedule]


# -- the copied modules against the reference --------------------------------


def test_presets_equal_reference():
    assert sorted(tl.PRESETS) == PRESETS
    for name in PRESETS:
        assert (dataclasses.asdict(tl.PRESETS[name])
                == dataclasses.asdict(jl.PRESETS[name]))


@pytest.mark.parametrize("variant", ["plain", "time_scale", "shared_prefix",
                                     "bulk_fraction"])
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("preset", PRESETS)
def test_schedule_equals_reference(preset, seed, variant):
    text, scale = preset, 1.0
    if variant == "time_scale":
        scale = 0.25
    elif variant == "shared_prefix":
        text += ":prefix_groups=2:shared_prefix=4"
    elif variant == "bulk_fraction":
        text += ":bulk_fraction=0.3"
    spec, jspec = tl.parse_scenario(text), jl.parse_scenario(text)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    got = tl.build_schedule(spec, vocab=97, seed=seed, time_scale=scale)
    want = jl.build_schedule(jspec, vocab=97, seed=seed, time_scale=scale)
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal"])
def test_arrival_offsets_equal_reference(process, seed):
    assert (tl.arrival_offsets(process, 200, 6.0, random.Random(seed))
            == jl.arrival_offsets(process, 200, 6.0, random.Random(seed)))


@pytest.mark.parametrize("cap", [8, 64, 2048])
def test_percentiles_equal_reference(cap):
    rng = random.Random(cap)
    vals = [rng.lognormvariate(3.0, 1.0) for _ in range(500)]
    ours, ref = tl.StreamingPercentiles(cap), jl.StreamingPercentiles(cap)
    for v in vals:
        ours.observe(v)
        ref.observe(v)
    assert ours._vw == ref._vw and ours.count == ref.count
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert ours.quantile(q) == ref.quantile(q)
    assert ours.summary() == ref.summary()


# -- the reference's cases on the port ----------------------------------------


@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal"])
def test_arrivals_seeded_replay_is_bit_identical(process):
    a = tl.arrival_offsets(process, 50, 8.0, random.Random(7))
    assert a == tl.arrival_offsets(process, 50, 8.0, random.Random(7))
    assert a != tl.arrival_offsets(process, 50, 8.0, random.Random(8))


@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal"])
def test_arrivals_positive_and_nondecreasing(process):
    offs = tl.arrival_offsets(process, 40, 4.0, random.Random(1))
    assert len(offs) == 40 and offs[0] > 0
    assert all(x <= y for x, y in zip(offs, offs[1:]))


def test_diurnal_ramps_up():
    offs = tl.arrival_offsets("diurnal", 200, 10.0, random.Random(2))
    gaps = [y - x for x, y in zip(offs, offs[1:])]
    q = len(gaps) // 4
    assert np.mean(gaps[:q]) > np.mean(gaps[-q:])


@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal"])
def test_long_run_rate_matches_the_requested_rate(process):
    offs = tl.arrival_offsets(process, 5000, 8.0, random.Random(0))
    assert 5000 / offs[-1] == pytest.approx(8.0, rel=0.10), process


@pytest.mark.parametrize("args, match", [
    (("uniform", 5, 1.0), "unknown arrival process"),
    (("poisson", 5, 0.0), "rate_rps"),
    (("poisson", 0, 1.0), "at least one"),
])
def test_unknown_process_and_bad_params_rejected(args, match):
    with pytest.raises(ValueError, match=match):
        tl.arrival_offsets(*args, random.Random(0))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 17, 100])
def test_percentiles_exact_below_the_cap_vs_numpy(n):
    rng = random.Random(n)
    vals = [rng.uniform(-50, 50) for _ in range(n)]
    sk = tl.StreamingPercentiles()
    for v in vals:
        sk.observe(v)
    for q in (0.0, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert sk.quantile(q) == pytest.approx(float(np.quantile(vals, q)),
                                               abs=1e-9), (n, q)
    assert sk.mean == pytest.approx(float(np.mean(vals)))
    assert sk.count == n


def test_percentiles_edges_and_compaction():
    sk = tl.StreamingPercentiles()
    assert sk.quantile(0.5) is None and sk.mean is None
    assert sk.summary() == {} and len(sk) == 0
    with pytest.raises(ValueError):
        sk.observe(float("nan"))
    sk.observe(1.0)
    with pytest.raises(ValueError):
        sk.quantile(1.5)
    rng = random.Random(0)
    big = tl.StreamingPercentiles(max_samples=256)
    for _ in range(10_000):
        big.observe(rng.uniform(0.0, 1.0))
    assert big.quantile(0.5) == pytest.approx(0.5, abs=0.06)
    assert big.quantile(0.95) == pytest.approx(0.95, abs=0.06)
    assert big.quantile(0.0) == big._min and big.quantile(1.0) == big._max
    assert big.count == 10_000


def test_percentiles_merge():
    xs = [float(v) for v in range(10)]
    ys = [float(v) for v in range(100, 120)]
    a, b = tl.StreamingPercentiles(), tl.StreamingPercentiles()
    for v in xs:
        a.observe(v)
    for v in ys:
        b.observe(v)
    a.merge(b)
    for q in (0.1, 0.5, 0.95):
        assert a.quantile(q) == pytest.approx(float(np.quantile(xs + ys, q)))
    big = tl.StreamingPercentiles(max_samples=16)
    for v in range(100):
        big.observe(float(v))
    small = tl.StreamingPercentiles(max_samples=16)
    small.observe(1e6)
    big.merge(small)
    assert len(big._vw) <= 16 and big.quantile(1.0) == 1e6


def test_grammar_defaults_and_overrides():
    assert {s.arrival for s in tl.PRESETS.values()} == {
        "poisson", "bursty", "diurnal"}
    chat = tl.parse_scenario("chat")
    assert chat == tl.PRESETS["chat"]
    tuned = tl.parse_scenario("chat:requests=9:rate_rps=3.5")
    assert tuned.requests == 9 and tuned.rate_rps == 3.5
    assert tuned.slo_ttft_ms == chat.slo_ttft_ms
    s = tl.parse_scenario("chat:slo_ttft_ms=1000:slo_tpot_ms=100")
    assert s.deadline_ms(1) == 1000 and s.deadline_ms(11) == 2000


@pytest.mark.parametrize("text, match", [
    ("beam", "unknown preset"),
    ("chat:burstiness=2", "unknown key"),
    ("chat:requests", "not key=value"),
    ("chat:requests=many", "not a int"),
    ("chat:mean_prompt=100", "min_prompt <= mean_prompt"),
    ("chat:slo_ttft_ms=0", "SLO budgets"),
    ("chat:chaos_p99_mult=0.5", "chaos_p99_mult"),
    ("chat:working_set_mult=-1", "working_set_mult"),
    ("chat:prefix_groups=2", "come together"),
    ("chat:prefix_groups=2:shared_prefix=48", "private suffix"),
    ("chat:bulk_fraction=1.5", "bulk_fraction"),
    ("chat:temperature_spread=0.2", "temperature_spread"),
    ("chat:top_p=0", "top_p"),
])
def test_grammar_rejects_like_the_reference(text, match):
    with pytest.raises(ValueError, match=match):
        tl.parse_scenario(text)
    with pytest.raises(ValueError, match=match):
        jl.parse_scenario(text)


def test_resolved_specs_and_validate_config():
    specs = _resolved_specs(tl.LoadGenConfig(scenarios="chat,rag",
                                             slo_ttft_ms=9000))
    assert [s.name for s in specs] == ["chat", "rag"]
    assert all(s.slo_ttft_ms == 9000 for s in specs)
    with pytest.raises(ValueError, match="duplicate scenario"):
        _resolved_specs(tl.LoadGenConfig(scenarios=("chat", "chat")))
    tl.validate_config(tl.LoadGenConfig())
    tl.validate_config(tl.LoadGenConfig(kv_host_tier=True, preempt="bulk",
                                        session_dir="/tmp/x",
                                        host_tier_blocks=4))
    # the live plane, the watchdog and errors at the recovering decode
    # sites are taken, as the reference takes them
    for kw in (dict(obs_http=9100), dict(watchdog_s=5.0),
               dict(chaos="serve.step:error:count=1,"
                          "serve.step:error:after=6:count=1"),
               dict(chaos="serve.prefill:error:count=99"),
               dict(chaos="serve.verify:error:after=2:count=99")):
        tl.validate_config(tl.LoadGenConfig(**kw))
        jl.validate_config(jl.LoadGenConfig(**kw))
    for cfg, match in (
        (dict(scenarios=("chatt",)), "unknown preset"),
        (dict(chaos="nope.site:error"), "unknown site"),
        (dict(time_scale=0.0), "time_scale"),
        (dict(vocab=1), "vocab"),
        (dict(min_goodput=2.0), "min_goodput"),
        (dict(session_dir="/tmp/x"), "kv_host_tier"),
        (dict(preempt="everything"), "preempt must be"),
        (dict(preempt="bulk"), "requires kv_host_tier"),
        (dict(chaos="serve.prefil:error"), "unknown site"),
        (dict(obs_http=-1), "must be >= 0"),
        (dict(watchdog_s=-5.0), "must be >= 0"),
        (dict(burn_mitigation="panic"), "burn_mitigation"),
        (dict(slo_budget=0.0), "budget"),
    ):
        with pytest.raises(ValueError, match=match):
            tl.validate_config(tl.LoadGenConfig(**cfg))


def test_config_fields_are_the_references_plus_device():
    ours = {f.name: f.default for f in dataclasses.fields(tl.LoadGenConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jl.LoadGenConfig)}
    assert set(ours) - set(ref) == {"device"} and set(ref) <= set(ours)
    assert ours["device"] == "cuda"
    # the port's decode attention defaults to its kernel, as ServeConfig
    assert ours.pop("paged_attn") == "kernel"
    ref.pop("paged_attn")
    ours.pop("device")
    assert ours == ref


def test_schedule_replay_and_labels():
    spec = tl.parse_scenario("agentic:requests=12")
    a = tl.build_schedule(spec, vocab=64, seed=3, time_scale=0.5)
    assert a == tl.build_schedule(spec, vocab=64, seed=3, time_scale=0.5)
    c = tl.build_schedule(spec, vocab=64, seed=4, time_scale=0.5)
    assert [t.arrival_s for t in a] != [t.arrival_s for t in c]
    rag = tl.parse_scenario("rag:requests=30")
    for tr in tl.build_schedule(rag, vocab=64, seed=0):
        r = tr.request
        assert rag.min_prompt <= len(r.tokens) <= rag.max_prompt
        assert rag.min_gen <= r.n_gen <= rag.max_gen
        assert r.scenario == "rag" and r.deadline_ms == rag.deadline_ms(
            r.n_gen)
    chat = tl.parse_scenario("chat:requests=8")
    full = tl.build_schedule(chat, vocab=64, seed=1, time_scale=1.0)
    fast = tl.build_schedule(chat, vocab=64, seed=1, time_scale=0.1)
    for x, y in zip(full, fast):
        assert y.arrival_s == pytest.approx(x.arrival_s * 0.1)
        assert y.request.deadline_ms == x.request.deadline_ms


def test_sampled_preset_draws_per_request_sampling():
    sched = tl.build_schedule(tl.parse_scenario("chat-sampled:requests=12"),
                              vocab=64, seed=0)
    for tr in sched:
        r = tr.request
        assert 0.4 - 1e-9 <= r.temperature <= 1.2 + 1e-9
        assert (r.top_k, r.top_p) == (16, 0.95) and 0 <= r.seed < 2**31
    greedy = tl.build_schedule(tl.parse_scenario("chat:requests=4"),
                               vocab=64, seed=0)
    assert all(tr.request.temperature == 0 for tr in greedy)


def _toy_schedule(n, arrival_s=0.0):
    return [tl.TimedRequest(request=Request(rid=i, tokens=[1, 2, 3], n_gen=2,
                                            scenario="chat"),
                            arrival_s=arrival_s)
            for i in range(n)]


def test_arrive_site_is_registered():
    assert "loadgen.arrive" in tf.KNOWN_SITES
    (spec,) = tf.parse_spec("loadgen.arrive:error:rid=3")
    assert spec.site == "loadgen.arrive" and spec.match == (("rid", "3"),)


@pytest.mark.parametrize("spec, released, dropped", [
    ("loadgen.arrive:error:count=1", [1, 2], [0]),
    ("loadgen.arrive:error:rid=1", [0, 2], [1]),
    ("loadgen.arrive:error:after=2:count=1", [0, 1], [2]),
])
def test_error_drops_the_arrival_and_records_it(spec, released, dropped):
    tf.configure(spec)
    src = tl.ArrivalSource(_toy_schedule(3), scenario="chat")
    batch = src(idle=True)
    assert [r.rid for r, _ in batch] == released
    assert list(src.dropped) == dropped
    assert "dropped" in src.dropped[dropped[0]]
    assert src(idle=False) is None  # exhausted


def test_sleep_delays_but_still_releases():
    tf.configure("loadgen.arrive:sleep:delay_s=0.05:count=1")
    src = tl.ArrivalSource(_toy_schedule(2), scenario="chat")
    t0 = clock_ns()
    batch = src(idle=True)
    assert (clock_ns() - t0) / 1e9 >= 0.05
    assert [r.rid for r, _ in batch] == [0, 1] and not src.dropped


def test_source_paces_future_arrivals_and_backdates_submission():
    src = tl.ArrivalSource(_toy_schedule(1, arrival_s=0.04),
                           scenario="chat", max_sleep_s=0.01)
    batches = []
    for _ in range(50):
        b = src(idle=True)
        if b is None:
            break
        batches.extend(b)
    assert [r.rid for r, _ in batches] == [0]
    # submission is the scheduled arrival, not the release
    assert batches[0][1] == src._t0_ns + int(0.04 * 1e9)


# -- the sampled serve path ---------------------------------------------------

VOCAB = 64
MODEL = dict(embed=64, heads=8, head_dim=8, mlp_mult=4, dtype="float32",
             depth=1, rope=True)
SAMPLED = "chat-sampled:requests=8"


@functools.lru_cache(maxsize=None)
def _flat():
    return {k: np.asarray(v) for k, v in j_init_lm_params(
        jax.random.key(4), JModelConfig(**MODEL), VOCAB).items()}


@functools.lru_cache(maxsize=None)
def _schedule():
    spec = tl.parse_scenario(SAMPLED)
    return spec, tl.build_schedule(spec, vocab=VOCAB, seed=0,
                                   time_scale=0.02)


@functools.lru_cache(maxsize=None)
def _reference_oracle():
    spec, sched = _schedule()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))
    return jengine._oracle_expected(
        mesh, 1, JModelConfig(**MODEL), VOCAB, _flat(),
        [tr.request for tr in sched], max_prompt=spec.max_prompt,
        max_gen=spec.max_gen,
    )


@pytest.mark.parametrize("attn", ["kernel", "dense"])
@pytest.mark.parametrize("spec_k", [0, 2])
def test_sampled_engine_equals_both_oracles(spec_k, attn):
    spec, sched = _schedule()
    cfg = ModelConfig(**MODEL)
    max_len = spec.max_prompt + spec.max_gen
    dec = make_paged_lm_decoder(
        cfg, VOCAB, n_blocks=4 * (max_len // 8) + 1, block_len=8,
        max_len=max_len, attn=attn, sampling=True, device="cpu",
    )
    params = dec.stack_params(params_from_jax(_flat(), cfg))
    eng = ServeEngine(dec, params, slots=4, spec_k=spec_k)
    src = tl.ArrivalSource(sched, scenario=spec.name)
    out = eng.run([], source=src)
    assert all(tr.request.temperature > 0 for tr in sched)
    want = _oracle_expected(cfg, VOCAB, params, [tr.request for tr in sched],
                            max_prompt=spec.max_prompt,
                            max_gen=spec.max_gen)
    assert want == _reference_oracle()
    assert out == want
    assert sorted(eng.lifecycle) == sorted(out) and not eng.leaked_blocks()
    for rid, lc in eng.lifecycle.items():
        assert lc["status"] == "done" and lc["n_out"] == len(out[rid])
        assert lc["ttft_ms"] is not None and lc["e2e_ms"] >= lc["ttft_ms"]
    snap = eng.cost.snapshot()
    assert snap["decode_identity_ok"] and snap["prefill_identity_ok"]
    assert snap["conservation_ok"]
    if spec_k:
        assert eng.stats["spec_steps"] == eng.stats["steps"] > 0


def test_greedy_rows_through_sampling_cores_keep_their_ids():
    """A greedy trace served through the sampling cores retires the ids
    of the unsampled cores."""
    cfg = ModelConfig(**MODEL)
    spec = tl.parse_scenario("chat:requests=6")
    sched = tl.build_schedule(spec, vocab=VOCAB, seed=2)
    outs = []
    for sampling in (False, True):
        dec = make_paged_lm_decoder(cfg, VOCAB, n_blocks=41, block_len=8,
                                    max_len=72, sampling=sampling,
                                    device="cpu")
        params = dec.stack_params(params_from_jax(_flat(), cfg))
        eng = ServeEngine(dec, params, slots=4)
        outs.append(eng.run([dataclasses.replace(tr.request)
                             for tr in sched]))
    assert outs[0] == outs[1]


def test_sampling_decoder_needs_its_rows():
    cfg = ModelConfig(**MODEL)
    dec = make_paged_lm_decoder(cfg, VOCAB, n_blocks=9, block_len=8,
                                max_len=16, sampling=True, device="cpu")
    params = dec.stack_params(params_from_jax(_flat(), cfg))
    with pytest.raises(ValueError, match="sampling=True"):
        dec.step(params, dec.init_pool(), [1], [3], [0], [[1, 2]], [True])


def test_burn_shedding_sheds_bulk_first_and_accounts_it():
    """With every deadline missed the burn monitor fires and the shed
    ladder takes queued bulk requests before interactive ones; done +
    shed still covers the trace."""
    from tpu_patterns_torch.obs.slo import SloConfig

    cfg = ModelConfig(**MODEL)
    dec = make_paged_lm_decoder(cfg, VOCAB, n_blocks=41, block_len=8,
                                max_len=72, device="cpu")
    params = dec.stack_params(params_from_jax(_flat(), cfg))
    reqs = [Request(rid=i, tokens=[1, 2, 3, 4], n_gen=3,
                    deadline_ms=1e-6, priority="bulk" if i % 2 else
                    "interactive")
            for i in range(12)]
    eng = ServeEngine(dec, params, slots=2, burn_mitigation="shed",
                      slo=SloConfig(fast_window_s=60, slow_window_s=60,
                                    budget=0.1, multiplier=1.0))
    out = eng.run(reqs)
    assert eng.slo.fires == 1 and eng.shed
    assert set(out) | set(eng.shed) == set(range(12))
    # in shedding order: every bulk request before any interactive one
    is_bulk = [rid % 2 for rid in eng.shed]
    assert is_bulk == sorted(is_bulk, reverse=True) and is_bulk[0]
    assert eng.stats["sheds"] == len(eng.shed)


# -- run_loadgen and the CLI ------------------------------------------------

QUICK = dict(vocab=VOCAB, embed=64, head_dim=8, depth=1, slots=4,
             block_len=8, time_scale=0.02, slo_ttft_ms=60_000,
             slo_tpot_ms=20_000,
             chaos="loadgen.arrive:error:after=2:count=1")
# 16-24 generated tokens a request: the chaos twin's p99 gate compares
# two runs' wall clocks, and at 2-3 tokens a compiled run's p99 is ~2 ms,
# so one scheduling hiccup of a loaded CPU passed the 5x gate
REF_SCENARIOS = tuple(
    f"{p}:requests=3:min_prompt=4:mean_prompt=6:max_prompt=8"
    ":min_gen=16:mean_gen=16:max_gen=24" for p in ("chat", "chat-sampled"))


@functools.lru_cache(maxsize=None)
def _reference_records():
    """The reference's Records on small scenarios of the same presets:
    their pattern, mode, metric keys and verdicts do not depend on the
    sizes."""
    import io

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))
    recs = jl.run_loadgen(
        mesh, jl.LoadGenConfig(scenarios=REF_SCENARIOS, **QUICK),
        JResultWriter(stream=io.StringIO()))
    return {r.mode: r for r in recs}


@functools.lru_cache(maxsize=None)
def _port_records():
    import io

    cfg = tl.LoadGenConfig(scenarios=("chat:requests=8",
                                      "chat-sampled:requests=8"),
                           device="cpu", **QUICK)
    return {r.mode: r for r in tl.run_loadgen(
        cfg, ResultWriter(stream=io.StringIO()))}


@pytest.mark.parametrize("mode", ["chat_sp1", "chat_chaos_sp1",
                                  "chat-sampled_sp1",
                                  "chat-sampled_chaos_sp1"])
def test_run_loadgen_records_match_reference(mode):
    ours, ref = _port_records()[mode], _reference_records()[mode]
    assert list(_port_records()) == list(_reference_records())
    assert ours.pattern == ref.pattern == "loadgen"
    assert sorted(ours.metrics) == sorted(ref.metrics)
    assert ours.verdict.value == ref.verdict.value
    m = ours.metrics
    assert m["done"] + m["failed"] + m["dropped"] == m["requests"] == 8
    if "_chaos_" in mode:
        # an arrival dropped and healed: the reference's WARNING
        assert ours.verdict is Verdict.WARNING
        assert ref.verdict is JVerdict.WARNING
        assert m["dropped"] == 1 and m["injected"] == 1
        assert m["covered"] == 1 and m["leaked_blocks"] == 0
    else:
        assert ours.verdict is Verdict.SUCCESS
        assert m["goodput"] == 1.0 and m["cost_identity_ok"] == 1.0
        assert m["sampled_exact"] == (1.0 if "sampled" in mode else -1.0)
        assert m["tpot_p50_ms"] <= m["tpot_p99_ms"]
        assert 0 < m["ttft_p50_ms"] <= m["ttft_p99_ms"] <= m["e2e_p99_ms"]


def test_loadgen_cli_writes_one_record_per_scenario(tmp_path, capsys):
    jsonl = tmp_path / "lg.jsonl"
    rc = tcli.main([
        "--jsonl", str(jsonl), "loadgen", "--device", "cpu",
        "--scenarios", "chat:requests=4,chat-sampled:requests=4",
        "--vocab", "64", "--embed", "64", "--head_dim", "8", "--depth", "1",
        "--slots", "4", "--block_len", "8", "--time_scale", "0.02",
    ])
    recs = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    assert rc == 0
    assert [r["mode"] for r in recs] == ["chat_sp1", "chat-sampled_sp1"]
    ref_keys = sorted(_reference_records()["chat_sp1"].metrics)
    for r in recs:
        assert r["pattern"] == "loadgen" and r["verdict"] == "SUCCESS"
        assert sorted(r["metrics"]) == ref_keys
    assert "## chat-sampled_sp1" in capsys.readouterr().out


def test_serve_scenario_bridge(tmp_path):
    jsonl = tmp_path / "sv.jsonl"
    rc = tcli.main([
        "--jsonl", str(jsonl), "serve", "--device", "cpu", "--scenario",
        "chat:requests=4", "--vocab", "64", "--embed", "64", "--head_dim",
        "8", "--depth", "1", "--slots", "4", "--block_len", "8",
        "--time_scale", "0.02",
    ])
    (rec,) = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    assert rc == 0 and rec["mode"] == "chat_sp1"
    assert rec["verdict"] == "SUCCESS"
    assert rec["config"]["paged_attn"] == "kernel"


@pytest.mark.parametrize("argv", [
    # an error at serve.step and the watchdog are taken now: a typo'd
    # site and a negative deadline are what stays refused
    ["loadgen", "--chaos", "serve.stpe:error:count=1"],
    ["loadgen", "--kv_host_tier", "true", "--watchdog_s", "-5"],
    ["loadgen", "--preempt", "bulk"],
    ["loadgen", "--scenarios", "chatt"],
    ["loadgen", "--dp", "2"],
    ["serve", "--scenario", "chat:requests=many"],
    ["serve", "--scenario", "chat", "--snapshot_dir", "snap"],
    ["serve", "--scenario", "chat", "--time_scale", "0"],
])
def test_cli_refuses_with_a_message(argv, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(argv + ["--device", "cpu"])
    assert e.value.code != 0
    err = capsys.readouterr().err + str(e.value.code)
    assert "error" in err
