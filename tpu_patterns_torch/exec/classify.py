"""Cell classification: which resource does a sweep cell own?

The port's counterpart of ``tpu_patterns/exec/classify.py``, with the
CUDA and PyTorch runtime in place of XLA's.  Three classes, in
decreasing order of constraint:

* ENV_ISOLATED — the cell's ``spec.env`` sets state that is read at
  interpreter start or at the CUDA context's creation (``CUDA_*``,
  ``PYTORCH_*``, ``TORCH_*``, ``NCCL_*``, the device pin).  A warm
  worker has already created its context and loaded torch, so these
  knobs would be inert in one: exactly the silent no-op
  ``sweep.check_runtime_bite`` polices.  These cells always run in a
  fresh subprocess; off the card they fan out (a private subprocess is
  the isolation), on it they drain serially, since they own the card.

* DEVICE_EXCLUSIVE — the cell runs on a host with a CUDA card.  Cells
  must not share the card while they measure, so these drain strictly
  serially, each in a fresh subprocess, as on the JAX package's TPU.
  That includes ``topo`` and ``interop``: they touch the card too.

* HOST_PARALLEL — everything else: every cell on a host with no card
  (the CPU tests, whose cells run on the CPU because the caller pinned
  ``TPU_PATTERNS_DEVICE=cpu``), and the backend-free log and checkpoint
  readers on any host.  These fan out across a bounded worker pool.

``TPU_PATTERNS_DEVICE`` counts as a backend key: it picks the device a
process initialises, and a warm worker has already warmed the device of
its own environment.  The other framework-tier variables
(``TPU_PATTERNS_SWEEP_CONFIG``, ``..._TIER``, the workload knobs) are
read again by each run's config tier, so a warm worker applies them a
cell, and they do not force isolation.
"""

from __future__ import annotations

import enum
import glob
import os
import shutil
import sys
from typing import Mapping

from tpu_patterns_torch.sweep import SweepSpec


class CellClass(enum.Enum):
    DEVICE_EXCLUSIVE = "device_exclusive"
    HOST_PARALLEL = "host_parallel"
    ENV_ISOLATED = "env_isolated"


# spec.env keys read at interpreter start or at the CUDA context's
# creation: too late to apply inside a warm worker
_BACKEND_ENV_PREFIXES = ("CUDA_", "PYTORCH_", "TORCH_", "NCCL_")
_BACKEND_ENV_KEYS = frozenset(
    {
        "TPU_PATTERNS_DEVICE",
        "TPU_PATTERNS_PLATFORM",
        "NVIDIA_TF32_OVERRIDE",
        "PYTHONPATH",
        "LD_PRELOAD",
    }
)

# subcommands that never touch a device (log, checkpoint and obs-dump
# readers); on a card every other cell owns it.  An unknown subcommand
# defaults to device-owning: misclassifying toward safety costs wall
# clock, never correctness.
BACKEND_FREE_COMMANDS = frozenset({"report", "ckpt", "obs"})


def _mutates_backend_env(spec: SweepSpec) -> bool:
    return any(
        k.startswith(_BACKEND_ENV_PREFIXES) or k in _BACKEND_ENV_KEYS
        for k, _ in spec.env
    )


def classify(spec: SweepSpec, platform: str) -> CellClass:
    """Resource class of one cell when its cells run on ``platform``
    (``"cuda"`` or ``"cpu"``, from :func:`detect_platform`)."""
    if _mutates_backend_env(spec):
        return CellClass.ENV_ISOLATED
    cmd = spec.argv[0] if spec.argv else ""
    if platform == "cuda" and cmd not in BACKEND_FREE_COMMANDS:
        return CellClass.DEVICE_EXCLUSIVE
    return CellClass.HOST_PARALLEL


def detect_platform(env: Mapping[str, str] | None = None) -> str:
    """The platform the cells will run on, found WITHOUT creating a
    CUDA context in this process: the sweep parent must never hold the
    card its cells need.

    Order: the ``TPU_PATTERNS_DEVICE`` pin (the config tier's, which
    every cell reads too); a context this process already made (free to
    ask: the creation this function avoids has happened); then the
    card's traces on the host, a ``/dev/nvidia<N>`` node or an
    ``nvidia-smi`` on the PATH.  With none of them the host has no card
    a cell could use, and the answer is ``"cpu"``.  Nothing here calls
    ``torch.cuda.init()`` or ``torch.cuda.is_available()``.
    """
    env = os.environ if env is None else env
    # the pin's device type: "cuda:1" owns a card as "cuda" does
    pin = env.get("TPU_PATTERNS_DEVICE", "").strip().lower().split(":")[0]
    if pin:
        return pin
    if env is os.environ and "torch" in sys.modules:
        import torch

        if torch.cuda.is_initialized():
            return "cuda"
    if glob.glob("/dev/nvidia[0-9]*"):
        return "cuda"
    if shutil.which("nvidia-smi", path=env.get("PATH")):
        return "cuda"
    return "cpu"
