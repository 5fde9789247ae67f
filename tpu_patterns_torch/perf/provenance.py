"""Run provenance: who produced this artifact, where, at what code.

Counterpart of ``tpu_patterns/perf/provenance.py``.  Every Record and
perf snapshot is stamped with one :class:`RunStamp` so runs are
joinable across time.  Three fields:

* ``run_id`` — unique per run, even for two runs inside one process
  (``cli.main`` rotates the stamp per invocation via :func:`new_run`).
* ``git_sha`` — the commit the code ran at (best-effort; "" outside a
  git checkout).  ``+dirty`` marks uncommitted changes, because a
  number measured on uncommitted code is not reproducible from the SHA.
* ``mesh_fp`` — a fingerprint of the environment that shapes the
  numbers: the device and allocator env knobs, the host's CPU count, the
  Python version, and the torch version with the CUDA version it was
  built for.  Two runs with equal ``mesh_fp`` are comparable; the perf
  baseline gates machine-dependent (measured) metrics only within a
  matching fingerprint (``perf/baseline.py``).

It never initialises the device: the fingerprint reads the torch build,
never a live card, so a stamp taken before the first CUDA call equals
one taken after it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading

from tpu_patterns_torch.core.timing import wall_time_s

# Environment knobs that shape measured numbers: which cards are seen,
# TF32, the allocator and cuBLAS's workspace
_FP_ENV_VARS = (
    "CUDA_VISIBLE_DEVICES",
    "NVIDIA_TF32_OVERRIDE",
    "PYTORCH_CUDA_ALLOC_CONF",
    "CUBLAS_WORKSPACE_CONFIG",
    "TPU_PATTERNS_PLATFORM",
)


@dataclasses.dataclass(frozen=True)
class RunStamp:
    run_id: str
    git_sha: str
    mesh_fp: str
    started_s: float

    def to_dict(self) -> dict[str, str]:
        return {
            "run_id": self.run_id,
            "git_sha": self.git_sha,
            "mesh_fp": self.mesh_fp,
        }


_GIT_SHA: str | None = None  # cached per process; the SHA cannot change


def git_sha() -> str:
    """HEAD commit of the repo the package runs from (best-effort)."""
    global _GIT_SHA
    if _GIT_SHA is not None:
        return _GIT_SHA
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            cwd=root, capture_output=True, text=True, timeout=10,
        ).stdout.strip()
        if sha:
            # untracked (non-ignored) files count as dirty: a run whose
            # behavior comes from a new source file is as unreproducible
            # from the bare SHA as one from an edit
            dirty = subprocess.run(
                ["git", "status", "--porcelain"],
                cwd=root, capture_output=True, text=True, timeout=10,
            ).stdout.strip()
            if dirty:
                sha += "+dirty"
    except (OSError, subprocess.SubprocessError):
        sha = ""
    _GIT_SHA = sha
    return sha


def mesh_fingerprint() -> str:
    """Fingerprint of the measurement environment (12 hex chars): env
    knobs, host shape and versions, never live device state."""
    import importlib.metadata
    import sys

    import torch

    parts = [f"{k}={os.environ.get(k, '')}" for k in _FP_ENV_VARS]
    parts.append(f"cpus={os.cpu_count()}")
    parts.append(f"py={sys.version_info[:2]}")
    try:
        parts.append(f"torch={importlib.metadata.version('torch')}")
    except importlib.metadata.PackageNotFoundError:
        parts.append(f"torch={torch.__version__}")
    parts.append(f"cuda={torch.version.cuda}")
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:12]


_LOCK = threading.Lock()
_CURRENT: RunStamp | None = None
_SEQ = 0


def _make_stamp() -> RunStamp:
    global _SEQ
    _SEQ += 1
    t = wall_time_s()
    # time + pid make it unique across processes; the sequence number
    # makes two runs in ONE process distinct
    rid = f"{int(t * 1000):x}-{os.getpid():x}-{_SEQ:x}"
    return RunStamp(
        run_id=rid,
        git_sha=git_sha(),
        mesh_fp=mesh_fingerprint(),
        started_s=t,
    )


def current_stamp() -> RunStamp:
    """The active run's stamp (created lazily on first use)."""
    global _CURRENT
    with _LOCK:
        if _CURRENT is None:
            _CURRENT = _make_stamp()
        return _CURRENT


def new_run() -> RunStamp:
    """Rotate the stamp: everything banked from here on belongs to a
    NEW run.  ``cli.main`` calls this per invocation."""
    global _CURRENT
    with _LOCK:
        _CURRENT = _make_stamp()
        return _CURRENT


def stamp_dict() -> dict[str, str]:
    """The stamp as the plain dict every artifact embeds."""
    return current_stamp().to_dict()
