"""Process-group children: a kill takes the WHOLE group.

The port's copy of ``tpu_patterns/exec/proc.py``: the sweep's cell
runner (:func:`run_command`) and the helpers that the warm workers and
the replica fleet spawn their children with.  ``Popen.kill`` ends only
the direct child; a child that forked a helper (a compiler, an
extension build: ninja and its nvcc processes) would leave it alive and
holding the card.  Every child here starts in its own session, so
pgid == pid and :func:`kill_process_group` SIGKILLs everything it
spawned.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
from typing import Mapping, Sequence


def kill_process_group(proc: subprocess.Popen) -> None:
    """SIGKILL ``proc``'s whole process group (it was started with
    ``start_new_session=True``, so pgid == pid); falls back to killing
    the lone child when the group is already gone."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.kill()
        except OSError:
            pass


def run_command(
    cmd: Sequence[str],
    env: Mapping[str, str] | None = None,
    timeout: float | None = None,
    cwd: str | None = None,
) -> tuple[str, int, bool]:
    """Run ``cmd`` in its own process group; returns
    ``(stdout_text, rc, timed_out)`` with stderr folded into stdout.

    On timeout the group is SIGKILLed and the output captured so far
    (the lines before the hang, which say where it hung) is still
    returned; ``rc`` is 1 and ``timed_out`` True.  ``timeout`` <= 0 or
    None means no deadline.
    """
    proc = subprocess.Popen(
        list(cmd),
        env=dict(env) if env is not None else None,
        cwd=cwd,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        start_new_session=True,
    )
    try:
        stdout, _ = proc.communicate(
            timeout=timeout if timeout and timeout > 0 else None
        )
        return stdout or "", proc.returncode, False
    except subprocess.TimeoutExpired:
        kill_process_group(proc)
        # reap and drain: everything the child flushed before dying
        try:
            stdout, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:  # pipe held open by a survivor
            proc.kill()
            stdout = ""
        return stdout or "", 1, True
    except BaseException:
        # the caller is dying (KeyboardInterrupt, a scheduler bug): never
        # leave the cell's group running behind it
        kill_process_group(proc)
        raise


def popen_in_group(
    cmd: Sequence[str],
    env: Mapping[str, str] | None = None,
    **kwargs,
) -> subprocess.Popen:
    """``Popen`` in a fresh session (its own process group), so that
    :func:`kill_process_group` reaches everything the child starts."""
    return subprocess.Popen(
        list(cmd),
        env=dict(env) if env is not None else None,
        start_new_session=True,
        **kwargs,
    )


def python_argv() -> list[str]:
    """Unbuffered interpreter argv for protocol children: a
    pipe-buffered stdout would hold protocol lines past deadlines."""
    return [sys.executable, "-u"]
