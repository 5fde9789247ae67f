"""faults/ — deterministic fault injection + shared recovery policies.

The port's copy of ``tpu_patterns/faults/``: the runtime treats
preemption, transient faults, and numerical blowups as EXPECTED inputs:

  injector.py  named fault sites (``inject("serve.step")``) fired by a
               seeded ``TPU_PATTERNS_FAULTS`` spec — every recovery
               path is reachable on the CPU, and every firing is logged
               as an obs WARNING Record (``faults.jsonl``), a
               ``fault.injected`` event and a counter
  retry.py     the shared RetryPolicy (bounded attempts, exponential
               backoff + jitter, same-signature-twice -> quarantine)
               applied to ckpt I/O, the serve engine's prefill, decode
               and verify calls and the kv tier's copies, and
               ``run_cell_attempts``/``cell_retry_policy``, the sweep
               cells' loop (``sweep.run_sweep``, ``exec.run_cells``)

Fault sites of this package (all of the JAX package's):

  cell.run       cli.py main(), before dispatch (ctx: cell, cmd; the
                 sweep exports TPU_PATTERNS_CELL into each cell's env,
                 and a crashed cell is retried by run_cell_attempts)
  worker.ready   exec/worker.py, before the warm worker's ready
                 handshake (ctx: pid)
  ckpt.save      ckpt/checkpoint.py, mid-save (after the shards, before
                 the manifest commit marker)
  ckpt.restore   ckpt/checkpoint.py, before the shard reads
  train.step     models/train_loop.py, per step (``nan`` poisons loss)
  serve.prefill  serve/engine.py, before each prefill's launch
                 (``error`` retries; exhaustion quarantines exactly the
                 admitted rows with a per-request verdict)
  serve.step     serve/engine.py, before each decode step's launch
                 (``preempt`` raises SIGTERM; the engine finishes the
                 step, snapshots, and exits clean; ``error`` retries
                 under the serve policy, quarantining the active set on
                 exhaustion; ``sleep``/``hang`` stall it)
  serve.verify   serve/engine.py, before each speculative wide step's
                 launch (``spec_k > 0`` replaces serve.step with this
                 site; same recovery contract — retries, then quarantine
                 with shared-block refcounts released)
  serve.evict    serve/engine.py, before a kv-tier eviction wave's
                 device->host copy (retried; a deterministic failure
                 discards the wave's retained blocks)
  serve.onload   serve/engine.py, before a restore's host->device copy
                 (retried; a deterministic failure prefills fresh)
  serve.preempt  serve/engine.py, before a bulk row is preempted (fails
                 open: the victim keeps running)
  serve.shed     serve/engine.py, before a burn-ladder shed (fails open:
                 the request admits)
  loadgen.arrive loadgen/runner.py, per released arrival (``error``
                 drops it, ``sleep``/``hang`` delays it)
  obs.cost_book  obs/cost.py and obs/decisions.py, per booking (fails
                 open: skips it)
  obs.scrape     obs/live.py, per HTTP request to the live plane (any
                 error answers 503)

  router.route   serve/router.py, after the ring's decision, before the
                 dispatch (``error`` falls back to another live replica,
                 counted as a reroute; ``sleep`` stalls the front door)
  replica.spawn  serve/replica.py, before a child's fork (retried under
                 the replica policy)
  replica.drain  serve/replica.py, before a drain or checkpoint request
                 (``error``: the replica is treated as unresponsive)
  replica.obs_ship  serve/replica.py (child), before each obs batch
                 (``error`` drops that batch; the obs watchdog sees it)
  fleet.scale_out, fleet.scale_in  serve/replica.py, before an elastic
                 spawn or drain (``error`` aborts that action)
  store.publish, store.fetch, store.prewarm  serve/engine.py, before a
                 fleet-store commit, admission-miss read or scale-out
                 pre-fetch (each degrades to fresh prefill)
  disagg.transfer  serve/engine.py (prefill role), before the gather of
                 a finished prefill's blocks for the handoff (retried; a
                 deterministic failure ships a no-payload manifest, and
                 the decode pool re-prefills; a ``kill`` leaves no
                 partial spool file)
  disagg.adopt   serve/engine.py (decode role), before a shipped
                 payload's onload (retried; a deterministic failure
                 returns the blocks and re-prefills locally)

A spec naming any other site is refused at parse time.
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
    cell_retry_policy,
    ckpt_retry_policy,
    run_cell_attempts,
    serve_retry_policy,
)
