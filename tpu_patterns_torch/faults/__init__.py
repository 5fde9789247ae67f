"""faults/ -- deterministic fault injection and the retry policy.

Counterpart of ``tpu_patterns/faults/`` for the sites this package has:

  injector.py  named fault sites (``inject("ckpt.save", step=4)``) fired
               by a seeded ``TPU_PATTERNS_FAULTS`` spec; each firing is
               logged as a WARNING Record on stderr and counted in
               ``tpu_patterns_faults_injected_total``
  retry.py     RetryPolicy (bounded attempts, exponential backoff and
               jitter, same-signature-twice -> quarantine) for ckpt I/O
               and the serve engine's kv tier

Fault sites:

  ckpt.save     ckpt/checkpoint.py, mid-save (after the shards, before
                the manifest commit marker)
  ckpt.restore  ckpt/checkpoint.py, before the shard reads
  train.step    models/train_loop.py, per step (``nan`` poisons loss)
  loadgen.arrive  loadgen/runner.py, per released arrival (``error``
                drops it, ``sleep``/``hang`` delays it)
  obs.cost_book obs/cost.py, per booking (fails open: skips it)
  serve.evict   serve/engine.py, before a kv-tier eviction wave's
                device->host copy (retried; a deterministic failure
                discards the wave's retained blocks)
  serve.onload  serve/engine.py, before a restore's host->device copy
                (retried; a deterministic failure prefills fresh)
  serve.preempt serve/engine.py, before a bulk row is preempted (fails
                open: the victim keeps running)
  serve.shed    serve/engine.py, before a burn-ladder shed (fails open:
                the request admits)
  serve.step    serve/engine.py, before each decode step's launch
                (serve.verify: before the speculative wide step's);
  serve.verify  ``preempt`` snapshots at the iteration boundary,
                ``sleep``/``hang`` stall the step, ``error`` is refused
                at parse time until the step's retry and quarantine are
                ported

``serve.prefill`` and the fleet's sites are not ported: a spec naming one
is refused at parse time.
"""

from tpu_patterns_torch.faults.injector import (  # noqa: F401
    ENV_SPEC,
    ENV_STATE,
    KNOWN_SITES,
    MATCH_KEYS,
    FaultSpec,
    InjectedFault,
    active,
    configure,
    inject,
    parse_spec,
)
from tpu_patterns_torch.faults.retry import (  # noqa: F401
    Quarantined,
    RetryPolicy,
    call_with_retry,
    ckpt_retry_policy,
    serve_retry_policy,
)
