"""Scenario presets + the ``name[:key=value]*`` spec grammar.

A copy of ``tpu_patterns/loadgen/scenarios.py`` whose ``Request`` is the
port's engine's: the presets, the grammar and the schedule builder are
the reference's, so one (spec, seed, time_scale) gives both packages the
same trace.

A scenario is everything the load generator needs to synthesize a
request trace: an arrival process and rate, prompt/output length
distributions, and the SLO the trace is judged against.  Presets cover
the canonical serving shapes:

  chat             Poisson arrivals, mid-length prompts, mid-length
                   answers — independent users typing at a chatbot
  rag              Poisson arrivals, LONG prompts (retrieved context),
                   SHORT answers — the long-prompt-short-answer regime
                   where prefill dominates
  batch-summarize  diurnal ramp (the nightly batch window filling up),
                   long prompts, medium summaries — throughput-shaped
                   traffic that must still respect a deadline
  agentic          bursty (Markov-modulated) arrivals of SHORT
                   many-turn requests — an agent loop firing tool-call
                   volleys

Specs use the same fail-loudly grammar as ``TPU_PATTERNS_FAULTS``
(faults/injector.py): ``chat:requests=32:rate_rps=8`` overrides preset
fields by name; unknown presets, unknown keys, and uncoercible values
all raise at parse time — a typo'd scenario must never silently bench
something else.

``build_schedule`` turns a spec into the concrete timed trace.  EVERY
draw (arrival gaps, prompt/output lengths, token ids) comes from one
``random.Random(seed)``, so the same (spec, seed, time_scale) replays
bit-identically: same arrival offsets, same lengths, same tokens.
"""

from __future__ import annotations

import dataclasses
import random
import typing

from tpu_patterns_torch.loadgen.arrivals import (
    ARRIVAL_PROCESSES,
    arrival_offsets,
)
from tpu_patterns_torch.serve.engine import Request


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One fully-resolved scenario (preset defaults + overrides)."""

    name: str
    arrival: str  # poisson | bursty | diurnal
    requests: int
    rate_rps: float  # mean arrival rate, virtual requests/second
    min_prompt: int
    max_prompt: int
    mean_prompt: int
    min_gen: int
    max_gen: int
    mean_gen: int
    slo_ttft_ms: float  # time-to-first-token budget
    slo_tpot_ms: float  # per-output-token budget after the first
    # chaos gate: p99 e2e under faults may degrade at most this factor
    # over the clean run of the same schedule
    chaos_p99_mult: float
    # shared system prompts: with both > 0 each request opens with one
    # of ``prefix_groups`` distinct ``shared_prefix``-token prefixes
    # (drawn once per schedule, assignment seeded per request) — the
    # chat-traffic shape the prefix cache and the prefix-aware router
    # exist for.  Both default 0: existing schedules replay
    # bit-identically.  Spell e.g. ``chat:prefix_groups=2:
    # shared_prefix=16`` to turn it on.
    prefix_groups: int = 0
    shared_prefix: int = 0
    # memory-pressure knob: with > 0 the loadgen runner sizes the
    # device pool to (concurrent block working set) / mult — a mult
    # above 1 makes the trace's working set EXCEED the pool, the
    # regime where the defer-only engine stalls and the tiered KV
    # cache (--kv_host_tier) must degrade gracefully instead.  0 (the
    # default) keeps the full-rectangle pool every existing scenario
    # runs under.
    working_set_mult: float = 0.0
    # priority mix: with > 0 each request draws its class — ``bulk``
    # with this probability, ``interactive`` otherwise.  Priority-aware
    # admission sheds/preempts bulk first (docs/robustness.md's
    # degradation ladder).  0 (the default) tags nothing and draws
    # nothing, so priority-free schedules replay bit-identically.
    bulk_fraction: float = 0.0
    # stochastic sampling: with temperature > 0 every request draws a
    # per-request temperature (uniform in ``temperature +/-
    # temperature_spread``, floored just above 0) and a per-request
    # seed, and carries the spec's top_k/top_p — exercising the
    # engine's fused seeded-sampling cores.  The runner's exactness
    # gate for such a scenario is the FIXED-SEED ORACLE (the dense
    # batch-1 decoder replaying each request's (seed, index) keys), not
    # greedy ids.  0 (the default) draws nothing: greedy schedules
    # replay bit-identically.
    temperature: float = 0.0
    temperature_spread: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.arrival not in ARRIVAL_PROCESSES:
            raise ValueError(
                f"scenario {self.name!r}: unknown arrival process "
                f"{self.arrival!r} (want one of {sorted(ARRIVAL_PROCESSES)})"
            )
        if self.requests < 1:
            raise ValueError(
                f"scenario {self.name!r}: requests must be >= 1"
            )
        for what, lo, mid, hi in (
            ("prompt", self.min_prompt, self.mean_prompt, self.max_prompt),
            ("gen", self.min_gen, self.mean_gen, self.max_gen),
        ):
            if not 1 <= lo <= mid <= hi:
                raise ValueError(
                    f"scenario {self.name!r}: want 1 <= min_{what} <= "
                    f"mean_{what} <= max_{what}, got "
                    f"({lo}, {mid}, {hi})"
                )
        if self.rate_rps <= 0:
            raise ValueError(f"scenario {self.name!r}: rate_rps must be > 0")
        if self.slo_ttft_ms <= 0 or self.slo_tpot_ms <= 0:
            raise ValueError(
                f"scenario {self.name!r}: SLO budgets must be > 0"
            )
        if self.chaos_p99_mult < 1.0:
            raise ValueError(
                f"scenario {self.name!r}: chaos_p99_mult must be >= 1"
            )
        if (self.prefix_groups > 0) != (self.shared_prefix > 0):
            raise ValueError(
                f"scenario {self.name!r}: prefix_groups and "
                "shared_prefix come together (both > 0) or not at all"
            )
        if self.shared_prefix and self.shared_prefix >= self.max_prompt:
            raise ValueError(
                f"scenario {self.name!r}: shared_prefix "
                f"{self.shared_prefix} leaves no room for a private "
                f"suffix under max_prompt {self.max_prompt}"
            )
        if self.working_set_mult < 0:
            raise ValueError(
                f"scenario {self.name!r}: working_set_mult must be "
                f">= 0 (0 = full-rectangle pool), got "
                f"{self.working_set_mult}"
            )
        if not 0.0 <= self.bulk_fraction <= 1.0:
            raise ValueError(
                f"scenario {self.name!r}: bulk_fraction must be in "
                f"[0, 1], got {self.bulk_fraction}"
            )
        if self.temperature < 0 or self.temperature_spread < 0:
            raise ValueError(
                f"scenario {self.name!r}: temperature and "
                "temperature_spread must be >= 0"
            )
        if self.temperature == 0 and self.temperature_spread > 0:
            raise ValueError(
                f"scenario {self.name!r}: temperature_spread needs "
                "temperature > 0 (the spread widens a sampled preset)"
            )
        if self.top_k < 0:
            raise ValueError(
                f"scenario {self.name!r}: top_k must be >= 0 (0 = all)"
            )
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"scenario {self.name!r}: top_p must be in (0, 1], got "
                f"{self.top_p}"
            )

    def deadline_ms(self, n_gen: int) -> float:
        """A request's submit->last-token budget: first token under the
        TTFT budget, every later token under the TPOT budget."""
        return self.slo_ttft_ms + self.slo_tpot_ms * max(n_gen - 1, 0)


# Preset latency budgets are deliberately generous relative to real
# hardware: the repo's CI runs the engine on a CPU-simulated mesh, and
# the SLO exists to catch scheduler pathologies (unbounded queueing,
# starvation, chaos blowups), not to benchmark XLA's CPU backend.
PRESETS: dict[str, ScenarioSpec] = {
    "chat": ScenarioSpec(
        name="chat", arrival="poisson", requests=32, rate_rps=8.0,
        min_prompt=8, max_prompt=48, mean_prompt=24,
        min_gen=4, max_gen=24, mean_gen=12,
        slo_ttft_ms=2000.0, slo_tpot_ms=500.0, chaos_p99_mult=5.0,
    ),
    "rag": ScenarioSpec(
        name="rag", arrival="poisson", requests=24, rate_rps=4.0,
        min_prompt=48, max_prompt=96, mean_prompt=80,
        min_gen=2, max_gen=8, mean_gen=4,
        slo_ttft_ms=4000.0, slo_tpot_ms=500.0, chaos_p99_mult=5.0,
    ),
    "batch-summarize": ScenarioSpec(
        name="batch-summarize", arrival="diurnal", requests=24,
        rate_rps=6.0,
        min_prompt=32, max_prompt=96, mean_prompt=64,
        min_gen=8, max_gen=24, mean_gen=16,
        slo_ttft_ms=8000.0, slo_tpot_ms=1000.0, chaos_p99_mult=6.0,
    ),
    "agentic": ScenarioSpec(
        name="agentic", arrival="bursty", requests=40, rate_rps=12.0,
        min_prompt=4, max_prompt=24, mean_prompt=10,
        min_gen=2, max_gen=10, mean_gen=4,
        slo_ttft_ms=1500.0, slo_tpot_ms=400.0, chaos_p99_mult=5.0,
    ),
    # chat traffic with STOCHASTIC decoding: every request samples at
    # its own temperature (0.8 +/- 0.4) under top-k/top-p truncation
    # with its own seed — the preset that exercises the fused
    # seeded-sampling decode cores.  Its Record's exactness gate is the
    # fixed-seed oracle (serve/engine._oracle_expected), not greedy ids.
    "chat-sampled": ScenarioSpec(
        name="chat-sampled", arrival="poisson", requests=24,
        rate_rps=8.0,
        min_prompt=8, max_prompt=48, mean_prompt=24,
        min_gen=4, max_gen=16, mean_gen=8,
        slo_ttft_ms=2000.0, slo_tpot_ms=500.0, chaos_p99_mult=5.0,
        temperature=0.8, temperature_spread=0.4, top_k=16, top_p=0.95,
    ),
}

# the override surface IS the dataclass (minus the identity field) —
# a new ScenarioSpec field is automatically spellable in the grammar
_HINTS = typing.get_type_hints(ScenarioSpec)
_FIELD_TYPES = {
    f.name: _HINTS[f.name]
    for f in dataclasses.fields(ScenarioSpec)
    if f.name != "name"
}


def parse_scenario(text: str) -> ScenarioSpec:
    """``preset[:key=value]*`` -> a validated ScenarioSpec; malformed
    input raises (same discipline as faults.parse_spec)."""
    parts = [p.strip() for p in text.strip().split(":")]
    name = parts[0]
    if name not in PRESETS:
        raise ValueError(
            f"scenario {text!r}: unknown preset {name!r} "
            f"(want one of {sorted(PRESETS)})"
        )
    overrides: dict[str, object] = {}
    for part in parts[1:]:
        if "=" not in part:
            raise ValueError(f"scenario {text!r}: {part!r} is not key=value")
        k, v = part.split("=", 1)
        k = k.strip()
        ftype = _FIELD_TYPES.get(k)
        if ftype is None:
            raise ValueError(
                f"scenario {text!r}: unknown key {k!r} "
                f"(options: {sorted(_FIELD_TYPES)})"
            )
        try:
            overrides[k] = ftype(v.strip()) if ftype is not str else v.strip()
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"scenario {text!r}: {k}={v.strip()!r} is not a "
                f"{ftype.__name__}"
            ) from e
    return dataclasses.replace(PRESETS[name], **overrides)


@dataclasses.dataclass(frozen=True)
class TimedRequest:
    """One scheduled arrival: the request plus its release offset
    (seconds after the run starts, time scaling already applied)."""

    request: Request
    arrival_s: float


def _tri(rng: random.Random, lo: int, mid: int, hi: int) -> int:
    """Integer triangular draw clamped to [lo, hi] — mode at the mean
    field, so presets read as 'mostly around mid, tails to the caps'."""
    if lo == hi:
        return lo
    return max(lo, min(hi, round(rng.triangular(lo, hi, mid))))


def build_schedule(
    spec: ScenarioSpec,
    *,
    vocab: int,
    seed: int = 0,
    time_scale: float = 1.0,
) -> list[TimedRequest]:
    """The concrete trace: per-request arrival offset, prompt tokens,
    output budget, and deadline — deterministic from the arguments.

    ``time_scale`` compresses virtual ARRIVAL time onto the wall clock
    (CI runs a day-shaped ramp in seconds).  Deadlines do NOT scale:
    service time is real compute, so the SLO budget is wall-clock by
    definition — a compressed run simply queues harder, which is the
    point.
    """
    if time_scale <= 0:
        raise ValueError(f"time_scale must be > 0, got {time_scale}")
    if vocab < 2:
        raise ValueError(f"vocab must be >= 2, got {vocab}")
    rng = random.Random(seed)
    offsets = arrival_offsets(
        spec.arrival, spec.requests, spec.rate_rps, rng
    )
    # shared system prompts: one pool of group prefixes per schedule.
    # Drawn BEFORE the per-request loop (and only when enabled), so a
    # prefix-free spec's draw sequence — and therefore its schedule —
    # is bit-identical to what it was before this feature existed.
    prefixes: list[list[int]] = []
    if spec.prefix_groups > 0:
        prefixes = [
            [rng.randrange(vocab) for _ in range(spec.shared_prefix)]
            for _ in range(spec.prefix_groups)
        ]
    out: list[TimedRequest] = []
    for rid, off in enumerate(offsets):
        lp = _tri(rng, spec.min_prompt, spec.mean_prompt, spec.max_prompt)
        n_gen = _tri(rng, spec.min_gen, spec.mean_gen, spec.max_gen)
        if prefixes:
            group = prefixes[rng.randrange(len(prefixes))]
            tail = max(1, lp - spec.shared_prefix)
            tokens = group + [
                rng.randrange(vocab) for _ in range(tail)
            ]
        else:
            tokens = [rng.randrange(vocab) for _ in range(lp)]
        # priority draw LAST and only when enabled, so priority-free
        # specs keep their exact historical draw sequence
        priority = "interactive"
        if spec.bulk_fraction > 0:
            if rng.random() < spec.bulk_fraction:
                priority = "bulk"
        # sampling draws AFTER priority and only when enabled — greedy
        # specs keep their exact historical draw sequence too
        temperature, seed_r = 0.0, 0
        if spec.temperature > 0:
            temperature = spec.temperature
            if spec.temperature_spread > 0:
                temperature += rng.uniform(
                    -spec.temperature_spread, spec.temperature_spread
                )
            temperature = max(temperature, 0.05)  # spread never => greedy
            seed_r = rng.randrange(1 << 31)
        out.append(
            TimedRequest(
                request=Request(
                    rid=rid, tokens=tokens, n_gen=n_gen,
                    scenario=spec.name,
                    deadline_ms=spec.deadline_ms(n_gen),
                    priority=priority,
                    temperature=temperature, seed=seed_r,
                    top_k=spec.top_k if temperature > 0 else 0,
                    top_p=spec.top_p if temperature > 0 else 1.0,
                ),
                arrival_s=off * time_scale,
            )
        )
    return out
