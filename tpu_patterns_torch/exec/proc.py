"""Process-group children: a kill takes the WHOLE group.

The port's copy of the helpers of ``tpu_patterns/exec/proc.py`` that the
replica fleet spawns its engine processes with.  ``Popen.kill`` ends
only the direct child; a child that forked a helper (a compiler, an
extension build) would leave it alive and holding the card.  Every
child here starts in its own session, so pgid == pid and
:func:`kill_process_group` SIGKILLs everything it spawned.
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
