"""Warm-worker server: one warmed runtime, many cells.

The port's counterpart of ``tpu_patterns/exec/worker.py``.  Spawned as
``python -m tpu_patterns_torch`` with ``_TPU_PATTERNS_TORCH_EXEC_WORKER=1``
(``__main__.py`` dispatches here before the CLI, and the protocol
channel is claimed before anything can print on fd 1).  The worker pays
the interpreter start, torch's import and the device's warm-up once
(``runtime.warm_backend``), announces readiness, then serves cells over
a line-oriented JSON pipe protocol:

  parent -> worker (stdin):  {"op": "cell", "cell": name,
                              "argv": [...], "env": {...},
                              "log": path, "jsonl": path}
                             {"op": "ping"} | {"op": "shutdown"}
  worker -> parent (stdout): {"ready": true, "pid": ..., "platform": ...}
                             {"op": "cell", "cell": ..., "rc": ...,
                              "served": k}

Each cell runs in-process through ``cli.main(["--jsonl", jsonl, *argv])``
with fds 1 and 2 pointed at the cell's log for the call (native output
included, so the log reads as the subprocess path's), and the cell's
env overlay applied around it.

Isolation: the worker serves one cell at a time, and the parent recycles
it after K cells or on any nonzero rc (``workers.py``).  The scheduler
makes no pool on a card (device cells drain in fresh subprocesses), so
warm workers serve the host-parallel cells off the card.
"""

from __future__ import annotations

import json
import os
import sys
import traceback
from typing import IO

ENV_FLAG = "_TPU_PATTERNS_TORCH_EXEC_WORKER"


def _send(out: IO[str], obj: dict) -> None:
    out.write(json.dumps(obj) + "\n")
    out.flush()


def _run_cell(req: dict) -> int:
    """One in-process CLI run with the log captured at the fd level and
    the cell's env overlaid."""
    argv = [str(a) for a in req.get("argv", [])]
    log_path = req.get("log")
    jsonl_path = req.get("jsonl")
    env_overlay = {str(k): str(v) for k, v in (req.get("env") or {}).items()}

    saved_env = {k: os.environ.get(k) for k in env_overlay}
    os.environ.update(env_overlay)
    sys.stdout.flush()
    sys.stderr.flush()
    saved1, saved2 = os.dup(1), os.dup(2)
    logf = open(log_path, "a") if log_path else None
    try:
        if logf is not None:
            os.dup2(logf.fileno(), 1)
            os.dup2(logf.fileno(), 2)
        from tpu_patterns_torch.cli import main as cli_main

        try:
            cli_args = (["--jsonl", jsonl_path] if jsonl_path else []) + argv
            rc = cli_main(cli_args)
        except SystemExit as e:  # argparse errors and explicit exits keep
            # the subprocess semantics: a bare exit is SUCCESS, a message
            # exit prints the message (fd 2 is the cell's log)
            if e.code is None or isinstance(e.code, int):
                rc = e.code or 0
            else:
                print(e.code, file=sys.stderr)
                rc = 1
        except Exception:
            # the artifact a crashing subprocess leaves: the traceback in
            # the cell's log (sweep.cell_completed keys on it)
            traceback.print_exc()
            rc = 1
        return int(rc or 0)
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os.dup2(saved1, 1)
        os.dup2(saved2, 2)
        os.close(saved1)
        os.close(saved2)
        if logf is not None:
            logf.close()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def serve(proto_in: IO[str], proto_out: IO[str]) -> int:
    """The worker's loop: warm up, then serve requests until EOF or a
    shutdown op.  A protocol error ends the worker (the parent counts a
    dead worker as a miss and runs the cell as a subprocess)."""
    from tpu_patterns_torch import faults

    # fault site: a worker that dies or wedges before the ready
    # handshake; the parent's ready deadline and breaker recover
    faults.inject("worker.ready", pid=os.getpid())
    try:
        from tpu_patterns_torch.runtime import warm_backend

        platform = warm_backend()
    except Exception as e:
        _send(
            proto_out,
            {"ready": False, "error": f"{type(e).__name__}: {e}"},
        )
        return 1
    _send(proto_out, {"ready": True, "pid": os.getpid(), "platform": platform})
    served = 0
    for line in proto_in:
        if not line.strip():
            continue
        try:
            req = json.loads(line)
        except ValueError:
            return 2  # a garbled request: the pipe is not trustworthy
        op = req.get("op")
        if op == "shutdown":
            return 0
        if op == "ping":
            _send(proto_out, {"op": "ping", "rc": 0, "served": served})
            continue
        if op != "cell":
            _send(proto_out, {"op": op, "rc": 1, "error": "unknown op"})
            continue
        rc = _run_cell(req)
        served += 1
        _send(
            proto_out,
            {"op": "cell", "cell": req.get("cell", ""), "rc": rc,
             "served": served},
        )
    return 0


def main(proto_fd: int) -> int:
    """Serve on ``proto_fd``, the dup of fd 1 that ``__main__.py`` took
    before pointing fd 1 at stderr."""
    return serve(sys.stdin, os.fdopen(proto_fd, "w"))
