"""faults/ -- deterministic fault injection and the retry policy.

Counterpart of ``tpu_patterns/faults/`` for the sites this package has:

  injector.py  named fault sites (``inject("ckpt.save", step=4)``) fired
               by a seeded ``TPU_PATTERNS_FAULTS`` spec; each firing is
               logged as a WARNING Record on stderr and counted in
               ``tpu_patterns_faults_injected_total``
  retry.py     RetryPolicy (bounded attempts, exponential backoff and
               jitter, same-signature-twice -> quarantine) for ckpt I/O

Fault sites:

  ckpt.save     ckpt/checkpoint.py, mid-save (after the shards, before
                the manifest commit marker)
  ckpt.restore  ckpt/checkpoint.py, before the shard reads
  train.step    models/train_loop.py, per step (``nan`` poisons loss)
  loadgen.arrive  loadgen/runner.py, per released arrival (``error``
                drops it, ``sleep``/``hang`` delays it)
  obs.cost_book obs/cost.py, per booking (fails open: skips it)

The ``serve.*`` sites wait for the engine's retry and quarantine path: a
spec naming one is refused at parse time.
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
)
