"""obs/ — live, in-process observability for every runner path.

The port's copy of ``tpu_patterns/obs/`` (all jax-free there):

  spans.py     context-manager tracing on ``timing.clock_ns`` (the native
               clock) — nestable, thread-safe, Chrome trace_event export
  recorder.py  flight recorder: fixed-size ring of recent entries, dumped
               on demand / on crash / by the watchdog
  watchdog.py  hang watchdog: open span outlives its deadline -> ring +
               all-thread-stack dump + WARNING Record, live
  metrics.py   counters/gauges/histograms, JSONL + Prometheus text export
  export.py    Chrome trace and span summaries
  live.py      opt-in HTTP plane (/metrics /healthz /statusz /costz on a
               daemon thread — ``serve --obs_http PORT``) + the
               ``obs watch`` poller
  slo.py       rolling dual-window SLO burn-rate monitor feeding the
               serve engine's shed/spec_off mitigation ladder
  cost.py      resource attribution: measured decode/prefill walls
               apportioned per request, pool block-second integrals,
               rollups for ``obs cost`` / ``/costz`` / cost.jsonl
  decisions.py the scheduler decision ledger: one structured event per
               defer/evict/shed/preempt/breaker carrying the signals that
               drove it, counter-identity-gated
  table.py     the fixed-width markdown tables of the readers (the JAX
               package renders them with ``tabulate``)

  fleet.py     the replica fleet's plane: child-side span and counter
               shipping, the parent's sink and mirror reconciliation,
               the merged fleet timeline that ``obs fleet``, ``obs
               journey`` and ``obs explain`` read, request journeys

Usage (the whole API most call sites need)::

    from tpu_patterns_torch import obs

    with obs.span("p2p.pair_exchange", bytes=n):
        ...
    obs.counter("steps_total").inc()
    obs.dump("where_did_it_go.jsonl")       # flight recorder, on demand

``TPU_PATTERNS_OBS=0`` disables span/event recording entirely (a shared
no-op context manager: zero overhead on the timing paths);
``TPU_PATTERNS_OBS_DIR`` sets where watchdog/crash dumps land;
``TPU_PATTERNS_WATCHDOG_S`` tunes the collective/barrier deadline
(0 disables deadlines).
"""

from __future__ import annotations

import os

from tpu_patterns_torch.obs import recorder as _recorder
from tpu_patterns_torch.obs.cost import (  # noqa: F401
    CostBook,
    cost_table,
    load_dir as load_cost_dir,
)
from tpu_patterns_torch.obs.decisions import (  # noqa: F401
    DecisionLedger,
    decision_entries,
    explain_table,
)
from tpu_patterns_torch.obs.metrics import (  # noqa: F401
    counter,
    default as metrics_registry,
    gauge,
    histogram,
    parse_prom_text,
)
from tpu_patterns_torch.obs.spans import (  # noqa: F401
    collective_deadline_s,
    complete_span,
    enabled,
    event,
    open_spans,
    set_collective_deadline_s,
    set_enabled,
    span,
)
from tpu_patterns_torch.obs.watchdog import (  # noqa: F401
    find_dumps,
    fired_dumps,
    watch_queued,
)


def flight_recorder() -> "_recorder.FlightRecorder":
    return _recorder.get()


def configure(run_dir: str | None = None) -> None:
    """Set the directory watchdog/crash/on-demand dumps land in."""
    _recorder.set_run_dir(run_dir)


def run_dir() -> str:
    return _recorder.run_dir()


def dump(path: str | None = None, reason: str = "on_demand") -> str:
    """Dump the flight recorder (plus open spans) now; returns the path.
    Default path: ``<run_dir>/spans.jsonl``."""
    from tpu_patterns_torch.obs import spans as _spans

    path = path or os.path.join(_recorder.run_dir(), "spans.jsonl")
    return _recorder.get().dump(
        path, open_spans=_spans.open_spans(), reason=reason
    )


def dump_metrics(path: str | None = None) -> str:
    """Write the default registry as JSONL; returns the path."""
    from tpu_patterns_torch.obs import metrics as _metrics

    path = path or os.path.join(_recorder.run_dir(), "metrics.jsonl")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(_metrics.default().to_jsonl())
    return path


def dump_cost(path: str | None = None) -> str:
    """Write every registered cost book (obs/cost.py) as JSONL next to
    the metrics dump; returns the path."""
    from tpu_patterns_torch.obs import cost as _cost

    path = path or os.path.join(_recorder.run_dir(), "cost.jsonl")
    return _cost.dump_all(path)


_CRASH_INSTALLED = False


def install_crash_handlers() -> None:
    """Dump the flight recorder on uncaught exceptions and SIGTERM.

    Chains the previous excepthook/signal handler — the dump is a side
    observation, never a behavior change.  Idempotent.
    """
    global _CRASH_INSTALLED
    if _CRASH_INSTALLED:
        return
    _CRASH_INSTALLED = True
    import signal
    import sys

    prev_hook = sys.excepthook

    def hook(tp, val, tb):
        try:
            dump(
                os.path.join(_recorder.run_dir(), "crash.jsonl"),
                reason=f"uncaught {tp.__name__}: {val}",
            )
        except Exception:
            pass
        prev_hook(tp, val, tb)

    sys.excepthook = hook

    try:
        prev_term = signal.getsignal(signal.SIGTERM)
        if prev_term is None:
            # a non-Python (C-level) handler we can neither call nor
            # faithfully restore: chaining is impossible, so leave the
            # signal path untouched (excepthook still covers crashes)
            return

        def on_term(signum, frame):
            try:
                dump(
                    os.path.join(_recorder.run_dir(), "crash.jsonl"),
                    reason="SIGTERM",
                )
            except Exception:
                pass
            if callable(prev_term):
                prev_term(signum, frame)
            elif prev_term is signal.SIG_IGN:
                # the process was surviving SIGTERM before us; observing
                # it must not start killing it
                return
            else:  # SIG_DFL (or an unknowable non-Python handler):
                # restore and re-deliver the default disposition
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                signal.raise_signal(signal.SIGTERM)

        signal.signal(signal.SIGTERM, on_term)
    except (ValueError, OSError):
        pass  # not the main thread / restricted env: excepthook still works
