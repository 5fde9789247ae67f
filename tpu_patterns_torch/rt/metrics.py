"""Registry-wide metric totals — one summing helper, three consumers.

The port's copy of ``tpu_patterns/rt/metrics.py``.

"Sum metric NAME over every label set" is the question each
self-healing gate asks (did anything retry? how many firings? how many
blocks leaked fleet-wide?), and the loadgen runner, the chaos/replica
smokes, and the replica manager each hand-rolled it.  Two forms:

  metric_total(name)            over the LIVE in-process registry
  metric_total_jsonl(path, name) over a banked metrics JSONL dump
                                (the ``sweep-metrics.jsonl`` shape —
                                provenance header objects are skipped)
"""

from __future__ import annotations

import json


def metric_total(name: str, registry=None, **labels) -> float:
    """Sum ``name`` over all label sets in a metrics registry
    (default: the process-wide obs registry).  ``labels`` narrows the
    sum to series matching every given label — the fleet merge asks
    per-replica questions this way (``metric_total(
    "tpu_patterns_fleet_serve_requests_total", replica="1")``)."""
    if registry is None:
        from tpu_patterns_torch import obs

        registry = obs.metrics_registry()
    want = {str(k): str(v) for k, v in labels.items()}
    return sum(
        m.value
        for m in registry.metrics()
        if m.name == name
        and hasattr(m, "value")
        and all(
            str(m.labels.get(k)) == v for k, v in want.items()
        )
    )


def metric_total_jsonl(path: str, name: str) -> float:
    """Sum ``name`` over all label sets in a banked JSONL dump."""
    total = 0.0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            m = json.loads(line)
            if m.get("metric") == name:
                total += float(m.get("value", 0.0))
    return total
