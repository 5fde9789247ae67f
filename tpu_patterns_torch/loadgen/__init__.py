"""loadgen/ -- trace-driven load generation + SLO verdicts for serving.

Counterpart of ``tpu_patterns/loadgen/``.  This layer measures what a
*user* of the engine feels: requests arrive over time from a seeded
stochastic process, each carries a deadline, and the verdict is
latency-shaped: TTFT / TPOT / e2e percentiles and goodput-under-SLO (the
fraction of tokens from requests that met their deadline).

  arrivals.py     seeded arrival processes: Poisson, bursty (Markov-
                  modulated on/off), diurnal ramp; offsets in virtual
                  seconds, bit-identical under the same seed (a copy)
  scenarios.py    scenario presets (chat, rag, batch-summarize,
                  agentic, chat-sampled) + the ``name[:key=value]*``
                  spec grammar and the deterministic schedule builder
                  (a copy, on the port's ``Request``)
  percentiles.py  mergeable streaming quantile sketch: exact below its
                  buffer cap, deterministic compaction above (a copy)
  runner.py       drives a schedule through the port's ServeEngine on
                  the wall clock (``loadgen.arrive`` fault site per
                  release), computes the percentile/goodput stats from
                  the engine's per-request lifecycle, and banks ONE
                  Record per scenario, plus a chaos twin gating bounded
                  p99 degradation and zero lost requests

CLI: ``python -m tpu_patterns_torch loadgen --scenarios chat,rag`` (or
``python -m tpu_patterns_torch serve --scenario chat``).
"""

from tpu_patterns_torch.loadgen.arrivals import (  # noqa: F401
    ARRIVAL_PROCESSES,
    arrival_offsets,
)
from tpu_patterns_torch.loadgen.percentiles import (  # noqa: F401
    StreamingPercentiles,
)
from tpu_patterns_torch.loadgen.runner import (  # noqa: F401
    ArrivalSource,
    LoadGenConfig,
    run_loadgen,
    validate_config,
)
from tpu_patterns_torch.loadgen.scenarios import (  # noqa: F401
    PRESETS,
    ScenarioSpec,
    TimedRequest,
    build_schedule,
    parse_scenario,
)
