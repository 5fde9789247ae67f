"""rt/ — the shared runtime core: pool + lease + breaker + metrics.

The port's copy of ``tpu_patterns/rt/``.  Ported: ``Breaker``,
``LeasePool``, ``LeaseTable``, ``metric_total``/``metric_total_jsonl``
and the re-exported ``RetryPolicy``.  The serve engine leases its slots
from a ``LeasePool``, tracks in-flight rows in a ``LeaseTable`` and
feeds an opt-in ``Breaker``.  ``LeasePool``'s spawn and kill hooks stay
generic: the warm-worker pool that also drives them (``exec/``) and the
replica manager that watches replicas with a ``Breaker`` wait for
ROADMAP.md Queue 1 steps 10 and 9.

Three subsystems grew the same machinery independently: the sweep
engine's warm-worker pool (exec/workers.py: lease/recycle accounting +
a half-open circuit breaker on spawn failures), the serve engine
(serve/engine.py: bounded scheduler slots, quarantine escalation), and
the loadgen runner (loadgen/runner.py: registry-wide metric totals).
This package is the one surface all of them consume:

  breaker.py  :class:`Breaker` — closed -> open (K consecutive
              failures) -> half-open (ONE probe after the
              ``TPU_PATTERNS_BREAKER_COOLDOWN_S`` cool-down) ->
              closed|open.  The exact state machine the warm-worker
              pool proved out, now also watching serve replicas and
              (opt-in) a replica engine's own decode health.
  pool.py     :class:`LeasePool` — bounded lease/release over live
              resources with reuse accounting, recycle policy, and an
              attached Breaker; :class:`LeaseTable` — the rid ->
              in-flight ledger the replica router settles fail-over
              against (quarantine must release every lease).
  metrics.py  registry-wide totals (sum one metric name over all its
              label sets) for live registries and banked JSONL dumps.

The RECOVERY policy object stays where it was: ``faults.RetryPolicy``
(faults/retry.py) is consumed by rt users, not duplicated here —
"how many times, how long between, when to give up" remains a single
tunable surface.
"""

from tpu_patterns_torch.faults.retry import RetryPolicy  # noqa: F401
from tpu_patterns_torch.rt.breaker import (  # noqa: F401
    BREAKER_COOLDOWN_S,
    Breaker,
)
from tpu_patterns_torch.rt.metrics import (  # noqa: F401
    metric_total,
    metric_total_jsonl,
)
from tpu_patterns_torch.rt.pool import (  # noqa: F401
    LeasePool,
    LeaseTable,
)
