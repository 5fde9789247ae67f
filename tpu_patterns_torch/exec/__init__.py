"""exec/ — the sweep engine's executor: resource-aware cell scheduling.

The port's counterpart of ``tpu_patterns/exec/``:

  classify.py   one cell -> one resource class: DEVICE_EXCLUSIVE (owns
                the card; drains serially in a fresh subprocess),
                HOST_PARALLEL (fans out N-wide), or ENV_ISOLATED
                (spec.env sets state read at process start; keeps the
                fresh-subprocess path); ``detect_platform`` finds the
                cells' platform without creating a CUDA context
  proc.py       process-group subprocess runner: a timeout SIGKILLs the
                whole group, so a kernel build's ninja and nvcc
                processes die with the cell that started them
  worker.py     the warm-worker server: a ``python -m tpu_patterns_torch``
                process that pays torch's import and the device's
                warm-up once, then takes cell argv over a pipe protocol
  workers.py    the parent side: a bounded pool of warm workers on
                ``rt.LeasePool`` and ``rt.Breaker``, leased a cell,
                recycled after K cells or on any nonzero rc
  scheduler.py  the engine: per-class queues, deterministic result
                order, obs spans and histograms a cell with watchdog
                deadlines, and one serial-vs-concurrent ``speedup``
                Record in the concurrency suite's shape

``sweep.run_sweep(jobs=N)`` / ``python -m tpu_patterns_torch sweep
<suite> --jobs N`` is the entry point; ``--no-warm-workers`` keeps the
subprocess path for every cell.
"""

from __future__ import annotations

from tpu_patterns_torch.exec.classify import (  # noqa: F401
    CellClass,
    classify,
    detect_platform,
)
from tpu_patterns_torch.exec.proc import (  # noqa: F401
    kill_process_group,
    run_command,
)
from tpu_patterns_torch.exec.scheduler import (  # noqa: F401
    CellResult,
    default_jobs,
    run_cells,
)
from tpu_patterns_torch.exec.workers import WorkerPool  # noqa: F401
