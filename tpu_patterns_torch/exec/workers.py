"""Warm-worker pool (parent side): lease, run, recycle.

The port's counterpart of ``tpu_patterns/exec/workers.py``.  A
:class:`WorkerPool` holds up to ``size`` live workers.  ``lease()`` hands
a ready worker to exactly one scheduler thread; ``release()`` returns it
for reuse, or kills it when the cell failed, timed out, or the worker
reached its recycle budget.  A worker that dies mid-protocol is a miss:
the caller runs the cell as a fresh subprocess, so warm workers are an
optimisation, never a correctness dependency.

Recycle policy: a worker serves at most ``TPU_PATTERNS_WORKER_RECYCLE``
cells (default 25) and is killed on the first nonzero rc, since a
failing cell may have left the process in a bad state.

The circuit breaker (``rt.Breaker``: closed -> open after two
consecutive spawn or ready failures -> half-open after
``TPU_PATTERNS_BREAKER_COOLDOWN_S``) and the lease accounting
(``rt.LeasePool``) are the shared runtime core's, as in the JAX package;
this module keeps the process protocol and the exec metric names
(``tpu_patterns_exec_spawn_failures_total``,
``tpu_patterns_exec_fallbacks_total``,
``tpu_patterns_exec_breaker_open``).
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
from typing import Mapping

from tpu_patterns_torch import rt
from tpu_patterns_torch.exec import proc as _proc
from tpu_patterns_torch.exec.worker import ENV_FLAG

DEFAULT_RECYCLE_AFTER = int(
    os.environ.get("TPU_PATTERNS_WORKER_RECYCLE", "25")
)
# torch's import and a CUDA context take seconds; the ready deadline is
# a spawn budget, not a cell budget
READY_TIMEOUT_S = float(os.environ.get("TPU_PATTERNS_WORKER_READY_S", "180"))
BREAKER_COOLDOWN_S = rt.BREAKER_COOLDOWN_S


class WorkerError(RuntimeError):
    """The worker died or broke protocol: run the cell as a subprocess."""


class WarmWorker:
    """One live server process (``exec/worker.py`` has the protocol)."""

    def __init__(
        self,
        base_env: Mapping[str, str],
        stderr_path: str | None = None,
        recycle_after: int = DEFAULT_RECYCLE_AFTER,
    ):
        self.recycle_after = recycle_after
        self.served = 0
        self.ready = False
        self._stderr_f = open(stderr_path, "ab") if stderr_path else None
        self.proc = _proc.popen_in_group(
            [*_proc.python_argv(), "-m", "tpu_patterns_torch"],
            env={**base_env, ENV_FLAG: "1"},
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=self._stderr_f
            if self._stderr_f is not None
            else subprocess.DEVNULL,
            text=True,
        )

    def _read_line(self, timeout: float | None) -> str | None:
        """One protocol line within ``timeout``; None = deadline passed.
        A helper thread does the blocking read: killing the worker EOFs
        the pipe, which ends the helper."""
        box: dict = {}

        def read():
            try:
                box["line"] = self.proc.stdout.readline()
            except (ValueError, OSError):
                box["line"] = ""

        t = threading.Thread(target=read, daemon=True)
        t.start()
        t.join(timeout if timeout and timeout > 0 else None)
        if t.is_alive():
            return None
        return box.get("line", "")

    def wait_ready(self, timeout: float = READY_TIMEOUT_S) -> bool:
        if self.ready:
            return True
        line = self._read_line(timeout)
        if not line:
            return False
        try:
            msg = json.loads(line)
        except ValueError:
            return False
        self.ready = bool(msg.get("ready"))
        return self.ready

    def request(self, req: dict, timeout: float | None) -> dict:
        """One request and its response.  Raises :class:`WorkerError` on
        a dead or garbled worker; returns ``{"timed_out": True}`` after
        killing the group at the deadline."""
        try:
            self.proc.stdin.write(json.dumps(req) + "\n")
            self.proc.stdin.flush()
        except (BrokenPipeError, OSError) as e:
            raise WorkerError(f"worker pipe closed: {e}") from e
        line = self._read_line(timeout)
        if line is None:
            # the deadline: SIGKILL the worker's whole group (the cell
            # runs in it, with anything it spawned)
            from tpu_patterns_torch import obs

            obs.counter("tpu_patterns_exec_worker_timeouts_total").inc()
            self.kill()
            return {"timed_out": True}
        if not line:
            raise WorkerError("worker EOF mid-request")
        try:
            resp = json.loads(line)
        except ValueError as e:
            raise WorkerError(f"garbled worker response: {line!r}") from e
        if req.get("op") == "cell":
            self.served += 1
        return resp

    @property
    def expired(self) -> bool:
        return self.served >= self.recycle_after

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        _proc.kill_process_group(self.proc)
        try:
            self.proc.wait(timeout=10)
        except (OSError, subprocess.TimeoutExpired):
            pass  # already reaped, or stuck in the kernel: nothing to add
        for f in (self.proc.stdin, self.proc.stdout, self._stderr_f):
            try:
                if f is not None:
                    f.close()
            except OSError:
                pass

    def shutdown(self) -> None:
        """A polite exit first (the worker flushes), then the kill."""
        try:
            self.proc.stdin.write(json.dumps({"op": "shutdown"}) + "\n")
            self.proc.stdin.flush()
            self.proc.wait(timeout=5)
        except (OSError, ValueError, subprocess.TimeoutExpired):
            pass  # pipe gone or too slow: the kill below settles it
        self.kill()


class WorkerPool(rt.LeasePool):
    """``rt.LeasePool`` with the worker spawn hook and the exec metric
    names.  ``stats()`` feeds the engine Record: a cell served by a
    worker that had served one before is a reuse hit; a fresh spawn's
    first cell is a miss."""

    def __init__(
        self,
        size: int,
        base_env: Mapping[str, str],
        log_dir: str | None = None,
        recycle_after: int = DEFAULT_RECYCLE_AFTER,
        breaker_cooldown_s: float = BREAKER_COOLDOWN_S,
    ):
        super().__init__(
            size,
            breaker=rt.Breaker(
                threshold=2,  # one retry absorbs a blip
                cooldown_s=breaker_cooldown_s,
                gauge="tpu_patterns_exec_breaker_open",
            ),
            fallback_counter="tpu_patterns_exec_fallbacks_total",
            spawn_failure_counter="tpu_patterns_exec_spawn_failures_total",
        )
        self.base_env = dict(base_env)
        self.log_dir = log_dir
        self.recycle_after = recycle_after
        self._spawned = 0  # guarded by _lock

    def _spawn(self) -> WarmWorker | None:
        with self._lock:
            n = self._spawned
            self._spawned += 1
        stderr_path = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            stderr_path = os.path.join(self.log_dir, f"worker-{n}.log")
        try:
            w = WarmWorker(
                self.base_env, stderr_path, recycle_after=self.recycle_after
            )
        except OSError:
            return None
        if not w.wait_ready():
            w.kill()
            return None
        return w

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "worker_cells": float(total),
            "worker_reuse_hits": float(self.hits),
            "worker_spawns": float(self._spawned),
            "worker_recycled": float(self.recycled),
            "worker_hit_rate": (self.hits / total) if total else 0.0,
        }
