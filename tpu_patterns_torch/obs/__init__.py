"""obs/ -- the metrics registry, the SLO burn monitor and the cost book.

Counterpart of part of ``tpu_patterns/obs/`` (all jax-free there; these
are the port's own copies):

  metrics.py  Registry, Counter, Gauge, Histogram; Prometheus text and
              JSONL export
  slo.py      SloConfig, SloMonitor: rolling good/bad-token burn rates
              and the mitigation flag the serve engine reads
  cost.py     CostBook: per-request device time and block-seconds with
              identities that close exactly

The facade gives ``counter``, ``gauge``, ``histogram`` (the process-wide
registry's) and ``metrics_registry``.  Spans, events, the flight
recorder, the dumps and the live HTTP plane are not ported yet: every
call the reference makes to them on a ported path is dropped (ROADMAP
Queue 3).
"""

from tpu_patterns_torch.obs.metrics import (  # noqa: F401
    counter,
    default as metrics_registry,
    gauge,
    histogram,
)
