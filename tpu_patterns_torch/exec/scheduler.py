"""The engine: per-class queues, bounded fan-out, one honest Record.

The port's counterpart of ``tpu_patterns/exec/scheduler.py``, with
``"cuda"`` where the JAX package reads ``"tpu"``.  Scheduling contract:

* HOST_PARALLEL cells run ``jobs``-wide on a thread pool (each thread
  waits on a warm worker or a subprocess — the parallelism is in the
  children, the threads just marshal).
* DEVICE_EXCLUSIVE and ENV_ISOLATED cells drain strictly serially on
  the calling thread, in spec order, through the same fresh-subprocess
  path the serial engine uses — their logs/JSONL are produced by an
  identical execution and stay bit-identical to serial mode.
* Results come back in SPEC ORDER regardless of completion order, and
  per-cell state records are keyed by cell name — resume semantics are
  engine-independent.

Every cell gets an ``obs.span`` (watchdog-armed past its subprocess
deadline) plus queue-wait/run-time histograms; cells still queued are
covered by ``watchdog.watch_queued`` deadlines scaled by their queue
position, so a wedged pool is diagnosed live, not discovered at the
end of a silent night.  The engine's own verdict — the concurrency
suite's question applied to the harness — is returned as a Record:
``speedup = sum(per-cell run time) / wall clock``, SUCCESS iff
concurrent submission beat serial, in the same pass/fail shape as the
suite this repo exists to reproduce.  Its ``parent_cuda_context``
metric says whether this (scheduling) process held a CUDA context when
the schedule ended: it must read 0, or the parent took the card from
its cells.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Mapping, Sequence

from tpu_patterns_torch.exec.classify import (
    CellClass,
    classify,
    detect_platform,
)
from tpu_patterns_torch.exec.workers import WorkerError, WorkerPool
from tpu_patterns_torch.faults import cell_retry_policy, run_cell_attempts
from tpu_patterns_torch.sweep import SweepSpec


def default_jobs() -> int:
    """Auto width for ``--jobs 0``: one short of the cores, clamped to
    [2, 8] — each host-parallel cell is itself a multi-threaded torch
    process, so wider schedules oversubscribe instead of overlapping."""
    n = os.cpu_count() or 2
    return max(2, min(8, n - 1))


def _holds_cuda_context() -> bool:
    """Whether this process has created a CUDA context (asked of torch
    only when torch is loaded; asking creates none)."""
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


@dataclasses.dataclass
class CellResult:
    """One scheduled cell's outcome (spec order preserved by caller)."""

    spec: SweepSpec
    cell_class: CellClass
    rc: int
    completed: bool
    queue_wait_s: float
    run_s: float
    runner: str  # "worker" | "subprocess"
    attempts: int = 1  # total tries under the cell RetryPolicy
    quarantined: bool = False  # same crash signature twice: gave up early


def _run_on_worker(
    pool: WorkerPool,
    spec: SweepSpec,
    out_dir: str,
    timeout: float,
) -> tuple[int, bool] | None:
    """One cell on a leased warm worker; None = unavailable/broken pipe
    (caller falls back to the subprocess path, which re-creates the
    cell artifacts from scratch)."""
    from tpu_patterns_torch import sweep as sweep_mod

    worker = pool.lease()
    if worker is None:
        return None
    log_path = os.path.join(out_dir, f"{spec.name}.log")
    jsonl_path = os.path.join(out_dir, f"{spec.name}.jsonl")
    if os.path.exists(jsonl_path):
        os.unlink(jsonl_path)  # same stale-cell rule as run_spec
    with open(log_path, "w") as f:
        # export-context lines first: parse_log keys table rows by them
        for k, v in spec.env:
            f.write(f"export {k}={v}\n")
    req = {
        "op": "cell",
        "cell": spec.name,
        "argv": list(spec.argv),
        # TPU_PATTERNS_CELL: same name tag the subprocess path exports,
        # so the `cell.run` fault site can target cells on either path
        "env": {**dict(spec.env), "TPU_PATTERNS_CELL": spec.name},
        "log": log_path,
        "jsonl": jsonl_path,
    }
    try:
        resp = worker.request(req, timeout if timeout > 0 else None)
    except WorkerError:
        pool.release(worker, reusable=False)
        return None
    if resp.get("timed_out"):
        pool.release(worker, reusable=False)
        with open(log_path, "a") as f:
            f.write(f"\n## {spec.name} | timeout | FAILURE\n")
        return 1, False
    rc = int(resp.get("rc", 1))
    # nonzero rc recycles the worker: a failing cell may have poisoned
    # process state, and the fresh-runtime guarantee wins over warmth
    pool.release(worker, reusable=(rc == 0))
    try:
        with open(log_path) as f:
            log_text = f.read()
    except OSError:
        log_text = ""
    return rc, sweep_mod.cell_completed(rc, False, log_text, jsonl_path)


def run_cells(
    specs: Sequence[SweepSpec],
    out_dir: str,
    *,
    jobs: int,
    suite: str = "",
    warm_workers: bool = True,
    cell_timeout: float = 1800.0,
    base_env: Mapping[str, str] | None = None,
    platform: str | None = None,
    subprocess_runner: Callable[[SweepSpec], tuple[int, bool]] | None = None,
    on_result: Callable[[CellResult], None] | None = None,
    progress: Callable[[str], None] | None = None,
):
    """Schedule ``specs``; returns ``(results_in_spec_order, Record)``.

    ``subprocess_runner(spec) -> (rc, completed)`` is the fresh-process
    fallback/serial path (``sweep.run_spec`` by default); ``on_result``
    fires as each cell finishes (state checkpointing must not wait for
    the suite — a killed run resumes from whatever landed).
    """
    from tpu_patterns_torch import obs
    from tpu_patterns_torch.core.results import Record, Verdict
    from tpu_patterns_torch.core.timing import clock_ns
    from tpu_patterns_torch.obs import watchdog

    env_full = dict(os.environ if base_env is None else base_env)
    # detect against the MAPPING OBJECT the cells actually inherit:
    # os.environ itself when base_env is None (its identity also lets
    # detect_platform trust this process's already-initialized backend)
    platform = platform or detect_platform(
        os.environ if base_env is None else base_env
    )
    jobs = int(jobs) if jobs and jobs > 0 else default_jobs()
    if subprocess_runner is None:
        from tpu_patterns_torch import sweep as sweep_mod

        def subprocess_runner(spec):
            return sweep_mod.run_spec(
                spec, out_dir, base_env=base_env, timeout=cell_timeout
            )

    os.makedirs(out_dir, exist_ok=True)
    classes = [classify(s, platform) for s in specs]

    def _fans_out(c: CellClass) -> bool:
        # env-isolated cells' constraint is "no warm process" — a fresh
        # subprocess already gives each a private env, so off the card
        # they fan out too (on it they also own the card: serial)
        return c is CellClass.HOST_PARALLEL or (
            c is CellClass.ENV_ISOLATED and platform != "cuda"
        )

    host_idx = [i for i, c in enumerate(classes) if _fans_out(c)]
    serial_idx = [i for i, c in enumerate(classes) if not _fans_out(c)]
    results: list[CellResult | None] = [None] * len(specs)
    print_lock = threading.Lock()

    def say(text: str) -> None:
        with print_lock:
            if progress is not None:
                progress(text)
            else:
                print(text, flush=True)

    pool = None
    # no pool on a card: a worker's warm_backend() would hold a CUDA
    # context beside the device-exclusive queue's cells (any host-
    # parallel cells there are backend-free readers; subprocesses serve
    # them fine)
    if warm_workers and host_idx and jobs > 1 and platform != "cuda":
        pool = WorkerPool(
            min(jobs, len(host_idx)),
            env_full,
            log_dir=os.path.join(out_dir, ".workers"),
        )

    # transient crash/timeout recovery: each cell gets up to
    # policy.max_attempts tries before its failure is final (completed
    # FAILUREs are verdicts and never retried — see run_cell_attempts)
    retry_policy = cell_retry_policy()

    # Queued-cell deadlines: cell q of a width-w queue should have
    # STARTED within ceil((q+1)/w) cell budgets; past that the queue
    # itself is wedged (a hung pool thread, a dead worker spawn) and the
    # watchdog dumps the evidence live.  A cell budget covers every
    # retry attempt it may take.
    watches: dict[int, object] = {}
    if cell_timeout > 0:
        per = (cell_timeout + 60) * retry_policy.max_attempts
        for qpos, i in enumerate(serial_idx):
            watches[i] = watchdog.watch_queued(
                f"sweep.queue:{specs[i].name}",
                deadline_s=(qpos + 1) * per,
                suite=suite,
                cell=specs[i].name,
                cell_class=classes[i].value,
            )
        for qpos, i in enumerate(host_idx):
            slot = qpos // jobs
            watches[i] = watchdog.watch_queued(
                f"sweep.queue:{specs[i].name}",
                deadline_s=(slot + 1) * per,
                suite=suite,
                cell=specs[i].name,
                cell_class=classes[i].value,
            )

    t_sched0 = clock_ns()

    aborted = threading.Event()

    def execute(i: int) -> None:
        spec, cls = specs[i], classes[i]
        t_start = clock_ns()
        queue_wait_s = (t_start - t_sched0) / 1e9
        w = watches.get(i)
        if w is not None:
            w.done()
        say(f"# sweep cell: {spec.name} [{cls.value}]")
        runner_box = ["subprocess"]

        def one_attempt(attempt: int) -> tuple[int, bool]:
            out = None
            if pool is not None and cls is CellClass.HOST_PARALLEL:
                out = _run_on_worker(pool, spec, out_dir, cell_timeout)
                if out is not None:
                    runner_box[0] = "worker"
            if out is None:
                runner_box[0] = "subprocess"
                if aborted.is_set():
                    # the schedule is being torn down (Ctrl-C, a
                    # scheduler bug): the teardown killed this cell's
                    # worker — do NOT respawn it as a cold subprocess
                    # that would outlive the abort by up to a full
                    # cell_timeout.  Not completed: --resume re-runs it.
                    return 1, False
                out = subprocess_runner(spec)
            return out

        with obs.span(
            "sweep.cell",
            deadline_s=(
                (cell_timeout + 60) * retry_policy.max_attempts
                if cell_timeout > 0
                else None
            ),
            suite=suite,
            cell=spec.name,
            cell_class=cls.value,
        ):
            rc, completed, attempts, quarantined = run_cell_attempts(
                one_attempt,
                policy=retry_policy,
                cell=spec.name,
                should_stop=aborted.is_set,
                progress=lambda msg: say(f"# {msg}"),
            )
        run_s = (clock_ns() - t_start) / 1e9
        obs.histogram(
            "tpu_patterns_sweep_queue_wait_s", cell_class=cls.value
        ).observe(queue_wait_s)
        obs.histogram(
            "tpu_patterns_sweep_cell_run_s", cell_class=cls.value
        ).observe(run_s)
        obs.counter(
            "tpu_patterns_sweep_cells_total",
            suite=suite,
            status="completed" if completed else "aborted",
        ).inc()
        res = CellResult(
            spec=spec,
            cell_class=cls,
            rc=rc,
            completed=completed,
            queue_wait_s=queue_wait_s,
            run_s=run_s,
            runner=runner_box[0],
            attempts=attempts,
            quarantined=quarantined,
        )
        results[i] = res
        say(
            f"# -> {spec.name} exit {rc}"
            + (f" (attempts={attempts})" if attempts > 1 else "")
            + (" QUARANTINED" if quarantined else "")
        )
        if on_result is not None:
            on_result(res)

    executor = None
    try:
        futures = []
        if host_idx:
            executor = ThreadPoolExecutor(
                max_workers=jobs, thread_name_prefix="sweep-host"
            )
            futures = [executor.submit(execute, i) for i in host_idx]
        # the device-exclusive/env-isolated queue drains on THIS thread
        # while the host pool works — the overlap the engine exists for
        for i in serial_idx:
            execute(i)
        for f in futures:
            f.result()  # propagate scheduler bugs, not swallow them
    except BaseException:
        # abort BEFORE the finally kills the pool: in-flight worker
        # cells must fail fast, not respawn as cold subprocesses.
        # (A cell already inside subprocess_runner still runs to its
        # own deadline — its process group is owned by that call.)
        aborted.set()
        raise
    finally:
        if executor is not None:
            executor.shutdown(
                wait=not aborted.is_set(),
                cancel_futures=aborted.is_set(),  # queued cells never start
            )
        for w in watches.values():
            w.done()
        if pool is not None:
            pool.shutdown()

    wall_s = (clock_ns() - t_sched0) / 1e9
    done = [r for r in results if r is not None]
    # speedup = Σ per-cell run time / wall clock — the overlap actually
    # achieved.  The numerator is measured UNDER concurrency, so host
    # contention inflates it: this is an upper bound on the true
    # serial-vs-concurrent win, honest about overlap but not about
    # slowdown-per-cell.
    serial_estimate_s = sum(r.run_s for r in done)
    speedup = serial_estimate_s / wall_s if wall_s > 0 else 0.0
    waits = [r.queue_wait_s for r in done]
    metrics = {
        "jobs": float(jobs),
        "cells": float(len(done)),
        "host_parallel_cells": float(len(host_idx)),
        "device_exclusive_cells": float(
            sum(c is CellClass.DEVICE_EXCLUSIVE for c in classes)
        ),
        "env_isolated_cells": float(
            sum(c is CellClass.ENV_ISOLATED for c in classes)
        ),
        "serial_estimate_s": round(serial_estimate_s, 3),
        "wall_s": round(wall_s, 3),
        "speedup": round(speedup, 4),
        "queue_wait_mean_s": round(
            sum(waits) / len(waits) if waits else 0.0, 3
        ),
        "queue_wait_max_s": round(max(waits, default=0.0), 3),
        # the self-healing trail: how many extra attempts the schedule
        # absorbed, and how many cells were quarantined as deterministic
        "cell_retries": float(sum(r.attempts - 1 for r in done)),
        "cells_quarantined": float(sum(r.quarantined for r in done)),
        "parent_cuda_context": float(_holds_cuda_context()),
    }
    if pool is not None:
        metrics.update(
            {k: round(v, 4) for k, v in pool.stats().items()}
        )
    notes = []
    if len(host_idx) < 2 or jobs <= 1:
        verdict = Verdict.SKIPPED
        notes.append(
            "nothing to overlap: "
            f"{len(host_idx)} host-parallel cell(s) at jobs={jobs} "
            f"on platform {platform!r}"
        )
    elif speedup > 1.0:
        # the suite's own question, answered for the harness: concurrent
        # submission beat serial submission
        verdict = Verdict.SUCCESS
    else:
        verdict = Verdict.WARNING
        notes.append(
            "concurrent submission did not beat the serial estimate — "
            "cells may be contending for the same host resources"
        )
    obs.gauge("tpu_patterns_sweep_engine_speedup", suite=suite).set(speedup)
    rec = Record(
        pattern="sweep",
        mode="engine",
        commands=f"jobs={jobs} platform={platform} cells={len(specs)}",
        metrics=metrics,
        verdict=verdict,
        notes=notes,
    )
    return results, rec
