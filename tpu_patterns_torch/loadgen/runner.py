"""Drive scenario schedules through the real ServeEngine; judge SLOs.

Counterpart of ``tpu_patterns/loadgen/runner.py``.  One scenario run is
one deterministic schedule (``scenarios.build_schedule``) released onto
the wall clock by :class:`ArrivalSource` and served by the same
``ServeEngine`` the ``serve`` patterns use: iteration-level admission,
the paged pool, deferrals, all live, with decode attention through the
paged kernel (K1) by default.  The engine's per-request lifecycle gives
TTFT / TPOT / e2e per request; the streaming percentile sketch turns
those into p50/p95/p99; goodput-under-SLO is the fraction of generated
tokens that came from requests meeting their deadline.  Each scenario
banks ONE Record with a pass/fail SLO verdict, and, with a chaos spec,
a second Record gating that p99 degrades bounded (<= the scenario's
multiplier over the clean run) and that done + failed + dropped exactly
covers the trace: no request silently lost.

With ``kv_host_tier`` every leg runs the tiered engine (with
``session_dir`` its session cache, with ``preempt="bulk"`` priority
preemption of the scenario's bulk rows), and a scenario that declares
memory pressure (``working_set_mult > 0``) also races the tier against
the defer-only engine (:func:`_kv_tier_loadgen_record`).

``obs_http`` serves the live plane (``obs/live.py``) for the whole run
and ``watchdog_s`` arms the hang watchdog on every engine's prefill,
step and verify spans.  A chaos spec may name the sites the port fires
(``loadgen.arrive``, ``obs.cost_book``, ``obs.scrape`` and the serve
engine's ``serve.*`` sites, ``error`` at prefill, step and verify
included: retried, then quarantined, with the chaos Record's coverage
counting the quarantined rows as failed).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time

from tpu_patterns_torch import faults, obs
from tpu_patterns_torch.core.timing import clock_ns
from tpu_patterns_torch.loadgen.percentiles import StreamingPercentiles
from tpu_patterns_torch.loadgen.scenarios import (
    ScenarioSpec,
    TimedRequest,
    build_schedule,
    parse_scenario,
)
from tpu_patterns_torch.serve.engine import (
    ServeEngine,
    _mesh_notes,
    _oracle_expected,
    _slo_kwargs,
    _sp_mode,
)


class ArrivalSource:
    """Releases a schedule into the engine on the wall clock.

    Plugged into ``ServeEngine.run(source=...)``: polled once per
    scheduler iteration, it hands over every request whose arrival
    offset has passed as ``(request, t_submit_ns)``, submission
    backdated to the scheduled arrival, so engine lateness reads as
    queue wait.  When the engine is IDLE (nothing queued or active) it
    owns the wait, sleeping in slices of at most ``max_sleep_s`` until
    the next arrival, so the scheduler loop itself stays sleep-free.

    Every release passes the ``loadgen.arrive`` fault site (ctx: rid,
    scenario): an injected ``sleep``/``hang`` DELAYS the arrival (the
    injector blocks inside the release loop, exactly a stalled
    front-end), an injected ``error`` DROPS it, recorded in
    ``self.dropped`` so the coverage accounting still closes.
    """

    def __init__(
        self,
        schedule: list[TimedRequest],
        *,
        scenario: str,
        max_sleep_s: float = 0.25,
    ):
        self._pending = collections.deque(
            sorted(schedule, key=lambda tr: (tr.arrival_s, tr.request.rid))
        )
        self.scenario = scenario
        self.dropped: dict[int, str] = {}
        self.released = 0
        self._t0_ns: int | None = None
        self._max_sleep_s = max_sleep_s

    def _elapsed_s(self) -> float:
        return (clock_ns() - self._t0_ns) / 1e9

    def __call__(self, idle: bool = False):
        if not self._pending:
            return None
        if self._t0_ns is None:
            self._t0_ns = clock_ns()
        if idle:
            wait_s = self._pending[0].arrival_s - self._elapsed_s()
            if wait_s > 0:
                # arrival pacing IS the load model: an idle engine waits
                # for the next scheduled arrival (a bounded slice; the
                # engine polls again)
                time.sleep(min(wait_s, self._max_sleep_s))
        batch = []
        now_s = self._elapsed_s()
        while self._pending and self._pending[0].arrival_s <= now_s:
            tr = self._pending.popleft()
            # submission is backdated to the SCHEDULED arrival: if the
            # engine was mid-iteration (or an injected delay stalled the
            # release), that lateness is queue wait the user felt;
            # counting it is the coordinated-omission fix
            t_submit_ns = self._t0_ns + int(tr.arrival_s * 1e9)
            req = dataclasses.replace(
                tr.request, tokens=list(tr.request.tokens)
            )
            try:
                faults.inject(
                    "loadgen.arrive", rid=req.rid, scenario=self.scenario
                )
            except faults.InjectedFault as e:
                self.dropped[req.rid] = f"arrival dropped: {e}"
                obs.counter(
                    "tpu_patterns_loadgen_requests_total",
                    scenario=self.scenario, status="dropped",
                ).inc()
                obs.event(
                    "loadgen.drop", rid=str(req.rid),
                    scenario=self.scenario,
                )
                continue
            batch.append((req, t_submit_ns))
            self.released += 1
        return batch


@dataclasses.dataclass
class LoadGenConfig:
    """CLI ``loadgen`` subcommand: scenario traces with SLO verdicts."""

    # model/pool shape: the same knobs as ServeConfig so `serve
    # --scenario` maps one-to-one
    vocab: int = 512
    embed: int = 128
    heads: int = 8
    head_dim: int = 16
    mlp_mult: int = 4
    depth: int = 2
    dtype: str = "float32"
    rope: bool = True
    kv_heads: int = 0
    cache_int8: bool = False
    # decode attention (ServeConfig.paged_attn): "kernel" runs the fused
    # paged-attention kernel K1, "dense" the pool-gather round trip; the
    # JAX package defaults to its dense path here, this package to the
    # kernel, as its ServeConfig does
    paged_attn: str = "kernel"
    slots: int = 8
    block_len: int = 16
    n_blocks: int = 0  # 0 = auto: full slots x max_len rectangle + trash
    spec_k: int = 0  # speculative decoding under load (engine flag)
    prefix_share: bool = False  # CoW prefix sharing under load
    # the tiered KV cache under load: every leg runs the tiered engine,
    # and a scenario with working_set_mult > 0 also races it against
    # the defer-only engine (admit-where-deferred, goodput above)
    kv_host_tier: bool = False
    session_dir: str = ""  # persist evicted prefixes across restarts
    host_tier_blocks: int = 0
    # preemption of running bulk rows (needs kv_host_tier; pair with a
    # scenario whose bulk_fraction > 0 so there are victims)
    preempt: str = "off"
    watchdog_s: float = 0.0  # per-step watchdog deadline (0 = spans only)
    # the workload: comma-separated scenario specs
    # ("chat,rag:requests=16", the scenarios.parse_scenario grammar)
    scenarios: tuple[str, ...] = ("chat",)
    seed: int = 0
    time_scale: float = 1.0  # compress virtual arrival time onto wall
    slo_ttft_ms: float = 0.0  # > 0 overrides every scenario's preset
    slo_tpot_ms: float = 0.0
    min_goodput: float = 1.0  # the SLO pass bar (fraction of tokens)
    # chaos-under-load: a TPU_PATTERNS_FAULTS spec; each scenario runs a
    # SECOND time under it, gating bounded p99 + full trace coverage
    chaos: str = ""
    chaos_p99_mult: float = 0.0  # > 0 overrides the scenario preset
    # the live telemetry plane and the burn monitor's ladder (the same
    # knobs as `serve`): obs_http > 0 serves /metrics /healthz /statusz
    # /costz on 127.0.0.1 for the whole run; burn_mitigation shed |
    # spec_off arms the engine's degradation ladder
    obs_http: int = 0
    burn_mitigation: str = "off"
    slo_fast_s: float = 60.0
    slo_slow_s: float = 300.0
    slo_budget: float = 0.1
    burn_multiplier: float = 2.0
    device: str = "cuda"  # "cpu" runs the plain torch versions


def _resolved_specs(cfg: LoadGenConfig) -> list[ScenarioSpec]:
    scenarios = cfg.scenarios
    if isinstance(scenarios, str):
        # the CLI hands sequence fields over as the raw comma-separated
        # string; scenario params use ':' so ',' stays unambiguous as
        # the list separator
        scenarios = tuple(s for s in scenarios.split(",") if s.strip())
    specs = []
    for text in scenarios:
        spec = parse_scenario(text)
        overrides = {}
        if cfg.slo_ttft_ms > 0:
            overrides["slo_ttft_ms"] = cfg.slo_ttft_ms
        if cfg.slo_tpot_ms > 0:
            overrides["slo_tpot_ms"] = cfg.slo_tpot_ms
        if cfg.chaos_p99_mult > 0:
            overrides["chaos_p99_mult"] = cfg.chaos_p99_mult
        if overrides:
            spec = dataclasses.replace(spec, **overrides)
        specs.append(spec)
    if not specs:
        raise ValueError("loadgen needs at least one scenario")
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(
            f"duplicate scenario presets in one run ({names}): their "
            "Records would overwrite each other's mode"
        )
    return specs


def validate_config(cfg: LoadGenConfig) -> None:
    """The parse-time surface: scenario specs, the chaos spec and the
    schedule-shaping scalars.  Raises ValueError on any typo, so the CLI
    can report it in one line before the model is built."""
    _resolved_specs(cfg)
    if cfg.chaos:
        faults.parse_spec(cfg.chaos)
    if cfg.time_scale <= 0:
        raise ValueError(f"time_scale must be > 0, got {cfg.time_scale}")
    if cfg.vocab < 2:
        raise ValueError(f"vocab must be >= 2, got {cfg.vocab}")
    if not 0.0 <= cfg.min_goodput <= 1.0:
        raise ValueError(
            f"min_goodput is a token fraction in [0, 1], got "
            f"{cfg.min_goodput}"
        )
    if cfg.session_dir and not cfg.kv_host_tier:
        raise ValueError("session_dir requires kv_host_tier")
    if cfg.preempt not in ("off", "bulk"):
        raise ValueError(
            f"preempt must be off | bulk, got {cfg.preempt!r}"
        )
    if cfg.preempt != "off" and not cfg.kv_host_tier:
        raise ValueError(
            "preempt requires kv_host_tier: a preempted row is forced "
            "through the evict path into the host tier"
        )
    if cfg.burn_mitigation not in ("off", "shed", "spec_off"):
        raise ValueError(
            f"burn_mitigation must be off | shed | spec_off, got "
            f"{cfg.burn_mitigation!r}"
        )
    if cfg.obs_http < 0 or cfg.watchdog_s < 0:
        raise ValueError(
            f"obs_http ({cfg.obs_http}) and watchdog_s ({cfg.watchdog_s}) "
            "must be >= 0 (0 = off)"
        )
    # the SloConfig invariants, surfaced at parse time as one line
    _slo_kwargs(cfg)


def _session_fingerprint(cfg: LoadGenConfig) -> dict:
    """The config a committed session's K/V depends on (the weights'
    seed and dims and the block layout), handed to the host tier so a
    session dir committed under another model is refused.  Pool size
    and scenario shape are left out: block contents do not depend on
    them."""
    return {
        k: getattr(cfg, k)
        for k in ("vocab", "embed", "heads", "head_dim", "mlp_mult",
                  "depth", "dtype", "rope", "kv_heads", "cache_int8",
                  "block_len", "seed")
    }


def _drive(
    decoder, params, cfg: LoadGenConfig, spec: ScenarioSpec,
    schedule: list[TimedRequest], *, kv_tier: bool = False,
    use_session: bool = True, use_preempt: bool = True,
) -> tuple[ServeEngine, ArrivalSource, float]:
    """Serve ``schedule`` through a fresh engine; the tiered one when
    ``kv_tier`` (its session dir and preemption unless ``use_session``
    or ``use_preempt`` is false: the tier race and the chaos twin turn
    them off, so neither measures the cache or the priority schedule)."""
    eng = ServeEngine(
        decoder, params, slots=cfg.slots, watchdog_s=cfg.watchdog_s,
        prefix_share=cfg.prefix_share, spec_k=cfg.spec_k,
        kv_host_tier=kv_tier,
        session_dir=(cfg.session_dir or None)
        if kv_tier and use_session else None,
        host_tier_blocks=cfg.host_tier_blocks,
        preempt=cfg.preempt if kv_tier and use_preempt else "off",
        fingerprint=_session_fingerprint(cfg) if kv_tier else None,
        **_slo_kwargs(cfg),
    )
    source = ArrivalSource(schedule, scenario=spec.name)
    t0 = clock_ns()
    with obs.span(
        "loadgen.scenario", scenario=spec.name, requests=len(schedule)
    ):
        eng.run([], source=source)
    return eng, source, (clock_ns() - t0) / 1e9


def _pending_rids(source: ArrivalSource) -> list[int]:
    """Arrivals the source never released."""
    return [tr.request.rid for tr in source._pending]


def _stats(
    eng: ServeEngine, source: ArrivalSource, schedule: list[TimedRequest]
) -> dict:
    """Percentiles + goodput + coverage from one run's lifecycle."""
    ttft = StreamingPercentiles()
    tpot = StreamingPercentiles()
    e2e = StreamingPercentiles()
    good_tokens = 0
    done = failed = 0
    # per-priority-class sketches keyed off the lifecycle's priority
    # field: the interactive/bulk split refines the flat series, never a
    # second measurement path
    by_class: dict[str, dict] = {}

    def _cls(priority: str) -> dict:
        return by_class.setdefault(priority or "interactive", {
            "ttft": StreamingPercentiles(),
            "tpot": StreamingPercentiles(),
            "good_tokens": 0,
        })

    for lc in eng.lifecycle.values():
        # failed requests stay in the latency sample: excluding them
        # would let a fault that drops the slowest rows shrink the chaos
        # p99 on a survivor-biased sample
        cls = _cls(lc.get("priority", ""))
        if lc["ttft_ms"] is not None:
            ttft.observe(lc["ttft_ms"])
            cls["ttft"].observe(lc["ttft_ms"])
        if lc["tpot_ms"] is not None:
            tpot.observe(lc["tpot_ms"])
            cls["tpot"].observe(lc["tpot_ms"])
        e2e.observe(lc["e2e_ms"])
        if lc["status"] == "done":
            done += 1
            if lc["met"]:
                good_tokens += lc["n_out"]
                cls["good_tokens"] += lc["n_out"]
        else:
            failed += 1
    total_tokens = sum(tr.request.n_gen for tr in schedule)
    # per-class goodput's denominator comes from the SCHEDULE (every
    # token the class asked for): shed or dropped work counts against
    # its class
    class_tokens: dict[str, int] = {}
    for tr in schedule:
        key = tr.request.priority or "interactive"
        class_tokens[key] = class_tokens.get(key, 0) + tr.request.n_gen
    for key, cls in by_class.items():
        tot = class_tokens.get(key, 0)
        cls["goodput"] = cls["good_tokens"] / tot if tot else 0.0
    scheduled = {tr.request.rid for tr in schedule}
    accounted = (
        set(eng.lifecycle) | set(source.dropped)
        # shed admissions are a terminal bucket: counted, never lost
        | set(eng.shed)
        | {r.rid for r, _ in eng.queue} | {s.rid for s in eng.active}
        | set(_pending_rids(source))
    )
    return {
        "ttft": ttft, "tpot": tpot, "e2e": e2e,
        "done": done, "failed": failed, "dropped": len(source.dropped),
        "sheds": len(eng.shed),
        "preempted": eng.stats["preempted"],
        "preempted_resumed": eng.stats["preempted_resumed"],
        "goodput": good_tokens / total_tokens if total_tokens else 0.0,
        "tokens": sum(
            lc["n_out"] for lc in eng.lifecycle.values()
            if lc["status"] == "done"
        ),
        "unaccounted": sorted(scheduled - accounted),
        "deferrals": eng.stats["deferrals"],
        "by_class": by_class,
        "cost": eng.cost.snapshot(),
    }


def _pcts(sk: StreamingPercentiles) -> tuple[float, float, float]:
    """(p50, p95, p99), -1 marking an empty series in Record metrics."""
    if not sk.count:
        return (-1.0, -1.0, -1.0)
    return (sk.quantile(0.5), sk.quantile(0.95), sk.quantile(0.99))


def _class_cost_metrics(st: dict) -> dict:
    """Record refinements on every loadgen leg: per-priority-class
    latency and goodput, and the cost book's totals with its identity
    verdict (1.0 == attributed + unattributed equals the measured wall
    exactly AND busy + free block-seconds equal pool x elapsed
    exactly)."""
    out: dict = {}
    for cname, cls in sorted(st["by_class"].items()):
        for key in ("ttft", "tpot"):
            p50, p95, p99 = _pcts(cls[key])
            out[f"{cname}_{key}_p50_ms"] = round(p50, 3)
            out[f"{cname}_{key}_p95_ms"] = round(p95, 3)
            out[f"{cname}_{key}_p99_ms"] = round(p99, 3)
        out[f"{cname}_goodput"] = round(cls["goodput"], 4)
    c = st["cost"]
    out["cost_decode_ms"] = round(c["decode_wall_ns"] / 1e6, 3)
    out["cost_prefill_ms"] = round(c["prefill_wall_ns"] / 1e6, 3)
    out["cost_busy_block_s"] = round(c["busy_block_ns"] / 1e9, 3)
    out["cost_identity_ok"] = float(
        c["decode_identity_ok"] and c["prefill_identity_ok"]
        and c["conservation_ok"]
    )
    return out


def _publish_gauges(spec: ScenarioSpec, st: dict) -> None:
    for key in ("ttft", "tpot", "e2e"):
        p50, p95, p99 = _pcts(st[key])
        for q, v in (("p50", p50), ("p95", p95), ("p99", p99)):
            obs.gauge(
                f"tpu_patterns_loadgen_{key}_{q}_ms", scenario=spec.name
            ).set(v)
    obs.gauge(
        "tpu_patterns_loadgen_goodput", scenario=spec.name
    ).set(st["goodput"])
    for status, n in (
        ("done", st["done"]), ("failed", st["failed"]),
    ):
        if n:
            obs.counter(
                "tpu_patterns_loadgen_requests_total",
                scenario=spec.name, status=status,
            ).inc(n)


def _injected_total() -> float:
    """Every injected firing so far, over all sites and actions."""
    from tpu_patterns_torch import rt

    return rt.metric_total("tpu_patterns_faults_injected_total")


def _scenario_commands(cfg: LoadGenConfig, spec: ScenarioSpec) -> str:
    return (
        f"req{spec.requests} {spec.arrival}@{spec.rate_rps:g}rps "
        f"prompt{spec.min_prompt}-{spec.max_prompt} "
        f"gen{spec.min_gen}-{spec.max_gen} "
        f"slo {spec.slo_ttft_ms:g}+{spec.slo_tpot_ms:g}ms "
        f"x{cfg.time_scale:g}"
    )


def build_loadgen(cfg: LoadGenConfig, specs: list[ScenarioSpec],
                  mesh=None):
    """(model config, decoder, params) for ``cfg``'s scenarios on its
    device (or over ``mesh``, sp x tp): one decoder covering every
    scenario's longest request, with the sampling cores when any
    scenario samples (greedy rows through them keep their ids, so one
    decoder serves a mixed list), weights drawn from ``cfg.seed`` as
    ``build_serve`` draws them."""
    from tpu_patterns_torch.models.lm import init_lm_params
    from tpu_patterns_torch.models.transformer import ModelConfig
    from tpu_patterns_torch.runtime import resolve_device
    from tpu_patterns_torch.serve.paged import make_paged_lm_decoder

    dev = resolve_device(cfg.device) if mesh is None else mesh.devices[0]
    mcfg = ModelConfig(
        embed=cfg.embed, heads=cfg.heads, head_dim=cfg.head_dim,
        mlp_mult=cfg.mlp_mult, dtype=cfg.dtype, depth=cfg.depth,
        kv_heads=cfg.kv_heads, rope=cfg.rope,
    )
    max_len = max(s.max_prompt + s.max_gen for s in specs)
    per_row = -(-max_len // cfg.block_len)
    # default pool: the full rectangle; SLO runs measure queueing and
    # latency, so deferral should come from load, not a starved pool
    n_blocks = cfg.n_blocks or (cfg.slots * per_row + 1)
    ws_mult = max((s.working_set_mult for s in specs), default=0.0)
    if not cfg.n_blocks and ws_mult > 0:
        # memory-pressure mode: the scenario declares its concurrent
        # block working set EXCEEDS the pool by working_set_mult
        ws = cfg.slots * per_row
        n_blocks = max(math.ceil(ws / ws_mult), per_row + 1) + 1
    decoder = make_paged_lm_decoder(
        mcfg, cfg.vocab, n_blocks=n_blocks, block_len=cfg.block_len,
        max_len=max_len, cache_int8=cfg.cache_int8, attn=cfg.paged_attn,
        sampling=any(s.temperature > 0 for s in specs), device=dev,
        mesh=mesh,
    )
    params = decoder.stack_params(
        init_lm_params(cfg.seed, mcfg, cfg.vocab, dev)
    )
    return mcfg, decoder, params


def run_loadgen(cfg: LoadGenConfig, writer=None, mesh=None) -> list:
    """Measured pattern: one SLO Record per scenario (plus a chaos twin
    per scenario when ``cfg.chaos`` is set), on one device or, with
    ``mesh`` (sp x tp, dp 1), through the sharded decoder over it (the
    oracle the same-mesh dense decoder, the modes ``_sp{sp}``).

    Clean-run gates: every scheduled request retires (nothing
    unaccounted), none failed or dropped, goodput-under-SLO >=
    ``min_goodput``, and a sampled scenario's ids equal the fixed-seed
    oracle's.  Chaos gates: coverage again (done + failed + dropped ==
    scheduled), at least one injected firing, and p99 e2e <=
    ``chaos_p99_mult`` x the clean run's p99.
    """
    from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict

    writer = writer or ResultWriter()
    validate_config(cfg)
    if cfg.obs_http:
        # the live plane covers the whole run (clean, kv-tier and chaos
        # legs alike: each engine attaches at run() entry)
        from tpu_patterns_torch.obs.live import ObsHttp

        plane = ObsHttp(cfg.obs_http)
        port = plane.start()
        writer.progress(
            f"obs http plane live on http://127.0.0.1:{port} "
            "(/metrics /healthz /statusz; poll it with "
            f"`python -m tpu_patterns_torch obs watch "
            f"http://127.0.0.1:{port}`)"
        )
        try:
            return run_loadgen(dataclasses.replace(cfg, obs_http=0), writer,
                               mesh)
        finally:
            plane.stop()
    specs = _resolved_specs(cfg)
    mcfg, decoder, params = build_loadgen(cfg, specs, mesh)
    config = {"device": str(decoder.device), "paged_attn": cfg.paged_attn}

    records = []
    for spec in specs:
        schedule = build_schedule(
            spec, vocab=cfg.vocab, seed=cfg.seed,
            time_scale=cfg.time_scale,
        )
        writer.progress(
            f"loadgen {spec.name}: {len(schedule)} requests over "
            f"{schedule[-1].arrival_s:.2f}s "
            f"({_scenario_commands(cfg, spec)})"
        )
        eng, source, _wall = _drive(decoder, params, cfg, spec, schedule,
                                    kv_tier=cfg.kv_host_tier)
        st = _stats(eng, source, schedule)
        _publish_gauges(spec, st)
        ttft_p = _pcts(st["ttft"])
        tpot_p = _pcts(st["tpot"])
        e2e_p = _pcts(st["e2e"])
        # stochastic scenarios gate token EXACTNESS against the
        # fixed-seed oracle: the dense batch-1 decoder replays each
        # request's (seed, index) keys, engine-independent
        mismatched: list[int] = []
        sampled_exact = -1.0
        if spec.temperature > 0:
            want = _oracle_expected(
                mcfg, cfg.vocab, params, [tr.request for tr in schedule],
                max_prompt=spec.max_prompt, max_gen=spec.max_gen,
                cache_int8=cfg.cache_int8, mesh=decoder.mesh,
            )
            mismatched = sorted(
                rid for rid, ids in eng.done.items()
                if list(ids) != want[rid][: len(ids)]
            )
            sampled_exact = float(not mismatched)
        ok = (
            not st["unaccounted"]
            and st["failed"] == 0
            and st["dropped"] == 0
            and eng.preempted_at is None
            and st["goodput"] >= cfg.min_goodput
            and not mismatched
        )
        rec = Record(
            pattern="loadgen",
            mode=spec.name + _sp_mode(decoder),
            commands=_scenario_commands(cfg, spec),
            metrics={
                "goodput": round(st["goodput"], 4),
                "ttft_p50_ms": round(ttft_p[0], 3),
                "ttft_p95_ms": round(ttft_p[1], 3),
                "ttft_p99_ms": round(ttft_p[2], 3),
                "tpot_p50_ms": round(tpot_p[0], 3),
                "tpot_p95_ms": round(tpot_p[1], 3),
                "tpot_p99_ms": round(tpot_p[2], 3),
                "e2e_p50_ms": round(e2e_p[0], 3),
                "e2e_p95_ms": round(e2e_p[1], 3),
                "e2e_p99_ms": round(e2e_p[2], 3),
                "requests": float(len(schedule)),
                "done": float(st["done"]),
                "failed": float(st["failed"]),
                "dropped": float(st["dropped"]),
                "shed": float(st["sheds"]),
                "preempted": float(st["preempted"]),
                "preempted_resumed": float(st["preempted_resumed"]),
                "deferrals": float(st["deferrals"]),
                "tokens": float(st["tokens"]),
                "slo_ttft_ms": spec.slo_ttft_ms,
                "slo_tpot_ms": spec.slo_tpot_ms,
                # -1 = greedy scenario (gate not applicable)
                "sampled_exact": sampled_exact,
            },
            verdict=Verdict.SUCCESS if ok else Verdict.FAILURE,
            config=config,
        )
        rec.metrics.update(_class_cost_metrics(st))
        if mismatched:
            rec.notes.append(
                f"request(s) {mismatched[:8]} diverged from the "
                "fixed-seed oracle: the engine's sampled stream is "
                "not replaying its (seed, index) keys"
            )
        if st["unaccounted"]:
            rec.notes.append(
                f"request(s) {st['unaccounted'][:8]} neither completed "
                "nor dropped nor shed: scheduler bug"
            )
        if st["failed"]:
            rec.notes.append(
                f"{st['failed']} request(s) failed on a CLEAN run"
            )
        if st["goodput"] < cfg.min_goodput:
            rec.notes.append(
                f"goodput {st['goodput']:.3f} < {cfg.min_goodput}: "
                "deadline misses under the scenario SLO "
                f"(ttft {spec.slo_ttft_ms:g}ms + "
                f"tpot {spec.slo_tpot_ms:g}ms/token)"
            )
        if st["sheds"]:
            rec.notes.append(
                f"{st['sheds']} admission(s) shed by burn-rate "
                "mitigation on the clean leg: the SLO budget burned "
                "under the scenario's own load"
            )
        rec.notes += _mesh_notes(decoder)
        writer.record(rec)
        records.append(rec)
        if cfg.kv_host_tier and spec.working_set_mult > 0:
            # the race needs a scenario that declares memory pressure: on
            # a pool it does not oversubscribe the defer-only leg never
            # defers and the contrast is vacuous
            records.append(_kv_tier_loadgen_record(
                decoder, params, cfg, spec, schedule, writer, config
            ))
        if cfg.chaos:
            records.append(_chaos_record(
                decoder, params, cfg, spec, schedule, st, writer, config
            ))
    return records


def _kv_tier_loadgen_record(decoder, params, cfg, spec, schedule, writer,
                            config):
    """The schedule served by the tiered engine and by the defer-only one
    (no retention, no tier) through the same pool, after one tiered
    warm-up pass, and the comparison Record: the defer-only leg defers
    (> 0) where the tiered leg never does; the tier evicted and leaked
    nothing; tokens per wall second above the defer-only leg's with
    goodput-under-SLO no worse.  Session and preemption stay off on the
    tiered legs: the race measures the ladder, not the cache or the
    priority schedule.  The Record's config adds the copies'
    milliseconds and each leg's decode steps."""
    from tpu_patterns_torch.core.results import Record, Verdict

    _drive(decoder, params, cfg, spec, schedule, kv_tier=True,
           use_session=False, use_preempt=False)
    with obs.span("loadgen.kv_tier", scenario=spec.name):
        tier_eng, tier_source, tier_wall_s = _drive(
            decoder, params, cfg, spec, schedule, kv_tier=True,
            use_session=False, use_preempt=False,
        )
    tier_st = _stats(tier_eng, tier_source, schedule)
    with obs.span("loadgen.kv_defer_baseline", scenario=spec.name):
        eng, source, wall_s = _drive(decoder, params, cfg, spec, schedule,
                                     kv_tier=False)
    base_st = _stats(eng, source, schedule)
    tier_tps = tier_st["tokens"] / tier_wall_s if tier_wall_s > 0 else 0.0
    base_tps = base_st["tokens"] / wall_s if wall_s > 0 else 0.0
    speedup = tier_tps / base_tps if base_tps > 0 else 0.0
    est = tier_eng.stats
    leaked = tier_eng.leaked_blocks()
    ok = (
        not tier_st["unaccounted"] and not base_st["unaccounted"]
        and base_st["deferrals"] > 0
        and tier_st["deferrals"] == 0
        and est["evictions"] > 0
        and leaked == 0
        and tier_tps > base_tps
        and tier_st["goodput"] >= base_st["goodput"]
    )
    rec = Record(
        pattern="loadgen",
        mode=f"{spec.name}_kv_tier" + _sp_mode(decoder),
        commands=(f"{_scenario_commands(cfg, spec)} "
                  f"ws_mult{spec.working_set_mult:g}"),
        metrics={
            "goodput": round(tier_st["goodput"], 4),
            "defer_goodput": round(base_st["goodput"], 4),
            "tokens_per_s": round(tier_tps, 1),
            "defer_tokens_per_s": round(base_tps, 1),
            "goodput_speedup": round(speedup, 3),
            "deferrals": float(tier_st["deferrals"]),
            "defer_baseline_deferrals": float(base_st["deferrals"]),
            "evictions": float(est["evictions"]),
            "evict_MB": round(est["evict_bytes"] / 1e6, 4),
            "onload_hits": float(est["onload_hits"]),
            "onload_MB": round(est["onload_bytes"] / 1e6, 4),
            "pressure_admits": float(est["pressure_admits"]),
            "retained_peak": float(est["retained_peak"]),
            "leaked_blocks": float(leaked),
        },
        verdict=Verdict.SUCCESS if ok else Verdict.FAILURE,
        config={**config, "evict_ms": est["evict_ns"] / 1e6,
                "commit_ms": est["commit_ns"] / 1e6,
                "onload_ms": est["onload_ns"] / 1e6,
                "decode_steps": est["steps"],
                "defer_decode_steps": eng.stats["steps"]},
    )
    if not base_st["deferrals"] > 0:
        rec.notes.append(
            "the defer-only leg never deferred: working_set_mult did not "
            "oversubscribe the pool, the contrast is vacuous"
        )
    if tier_st["deferrals"] > 0:
        rec.notes.append(
            f"tiered leg deferred {tier_st['deferrals']} time(s): the "
            "ladder fell through to the cliff"
        )
    if est["evictions"] == 0:
        rec.notes.append(
            "tiered leg never evicted: retention alone absorbed the "
            "pressure, the host tier went unexercised"
        )
    if not tier_tps > base_tps:
        rec.notes.append(
            f"goodput {tier_tps:.1f} tok/s <= defer-only {base_tps:.1f}: "
            "admitting earlier did not pay"
        )
    if tier_st["goodput"] < base_st["goodput"]:
        rec.notes.append(
            f"SLO goodput {tier_st['goodput']:.3f} < defer-only "
            f"{base_st['goodput']:.3f}"
        )
    rec.notes += _mesh_notes(decoder)
    writer.record(rec)
    return rec


def _chaos_record(
    decoder, params, cfg, spec, schedule, clean_st, writer, config
):
    """The same schedule served again under ``cfg.chaos`` faults."""
    from tpu_patterns_torch.core.results import Record, Verdict

    injected_before = _injected_total()
    faults.configure(cfg.chaos)
    try:
        # session off: inheriting the clean leg's committed session would
        # hand this leg its history for free (and chaos evictions must
        # not touch the user's session dir)
        with obs.span("loadgen.chaos", scenario=spec.name):
            eng, source, _wall = _drive(decoder, params, cfg, spec,
                                        schedule, kv_tier=cfg.kv_host_tier,
                                        use_session=False)
    finally:
        faults.configure(None)
    injected = _injected_total() - injected_before
    st = _stats(eng, source, schedule)
    clean_p99 = _pcts(clean_st["e2e"])[2]
    chaos_p99 = _pcts(st["e2e"])[2]
    ratio = chaos_p99 / clean_p99 if clean_p99 > 0 else -1.0
    covered = not st["unaccounted"] and eng.preempted_at is None
    bounded = (
        chaos_p99 < 0  # nothing finished: coverage gate carries it
        or clean_p99 <= 0
        or chaos_p99 <= spec.chaos_p99_mult * clean_p99
    )
    verdict = Verdict.SUCCESS
    if not covered or not bounded:
        verdict = Verdict.FAILURE
    elif st["failed"] or st["dropped"] or st["sheds"] or injected == 0:
        verdict = Verdict.WARNING  # healed (or inert), not unscathed
    rec = Record(
        pattern="loadgen",
        mode=f"{spec.name}_chaos" + _sp_mode(decoder),
        commands=f"{_scenario_commands(cfg, spec)} | {cfg.chaos}",
        metrics={
            "goodput": round(st["goodput"], 4),
            "e2e_p99_ms": round(chaos_p99, 3),
            "clean_e2e_p99_ms": round(clean_p99, 3),
            "p99_ratio": round(ratio, 3),
            "p99_mult_gate": spec.chaos_p99_mult,
            "injected": injected,
            "requests": float(len(schedule)),
            "done": float(st["done"]),
            "failed": float(st["failed"]),
            "dropped": float(st["dropped"]),
            "shed": float(st["sheds"]),
            "slo_burn_fires": float(eng.slo.fires),
            "covered": float(covered),
            "leaked_blocks": float(eng.leaked_blocks()),
        },
        verdict=verdict,
        config=config,
    )
    if st["unaccounted"]:
        rec.notes.append(
            f"request(s) {st['unaccounted'][:8]} silently lost under "
            "chaos: done+failed+dropped must cover the trace"
        )
    if eng.preempted_at is not None:
        rec.notes.append(
            "engine preempted mid-trace by the injected fault; pending "
            "requests are accounted but the scenario did not complete"
        )
    if not bounded:
        rec.notes.append(
            f"p99 e2e {chaos_p99:.1f}ms > {spec.chaos_p99_mult:g}x the "
            f"clean run's {clean_p99:.1f}ms: chaos degradation "
            "unbounded"
        )
    if injected == 0:
        rec.notes.append(
            f"chaos spec {cfg.chaos!r} never fired: the chaos leg "
            "measured a clean run"
        )
    for rid in sorted(eng.failed)[:4]:
        rec.notes.append(f"request {rid} QUARANTINED: {eng.failed[rid]}")
    for rid in sorted(source.dropped)[:4]:
        rec.notes.append(f"request {rid} DROPPED: {source.dropped[rid]}")
    rec.notes += _mesh_notes(decoder)
    writer.record(rec)
    return rec
