"""Multi-process bootstrap: the launcher↔process contract.

Counterpart of ``tpu_patterns/topo/bootstrap.py``, with the same
environment contract; where the reference calls
``jax.distributed.initialize``, this calls
``torch.distributed.init_process_group`` (nccl on ``cuda``, gloo on
``cpu``) with the coordinator as its TCP address.

Environment tier (first present wins per field):
  coordinator: TPU_PATTERNS_COORDINATOR, JAX_COORDINATOR_ADDRESS
  num_processes: TPU_PATTERNS_NUM_PROCESSES, JAX_NUM_PROCESSES
  process_id: TPU_PATTERNS_PROCESS_ID, JAX_PROCESS_ID, PALS_RANKID,
              PMI_RANK, OMPI_COMM_WORLD_RANK   (launcher compatibility)
"""

from __future__ import annotations

import dataclasses
import os

import torch

from tpu_patterns_torch.runtime import resolve_device

_COORD_VARS = ("TPU_PATTERNS_COORDINATOR", "JAX_COORDINATOR_ADDRESS")
_NPROC_VARS = ("TPU_PATTERNS_NUM_PROCESSES", "JAX_NUM_PROCESSES")
_PID_VARS = (
    "TPU_PATTERNS_PROCESS_ID",
    "JAX_PROCESS_ID",
    "PALS_RANKID",
    "PMI_RANK",
    "OMPI_COMM_WORLD_RANK",
)


def _first_env(names: tuple[str, ...]) -> str | None:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return v
    return None


@dataclasses.dataclass(frozen=True)
class ProcessInfo:
    process_id: int
    num_processes: int
    local_device_count: int
    global_device_count: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def bootstrap(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: torch.device | str | None = None,
) -> ProcessInfo:
    """Join (or skip joining) the distributed job, then report identity.

    With no arguments and no environment, this is a no-op single-process
    init.  Explicit arguments override the environment.  ``device``
    (``cuda`` unless ``cpu`` is named) picks the backend and the devices
    counted.
    """
    dev = resolve_device(device)
    coordinator_address = coordinator_address or _first_env(_COORD_VARS)
    if num_processes is None:
        v = _first_env(_NPROC_VARS)
        num_processes = int(v) if v else None
    if process_id is None:
        v = _first_env(_PID_VARS)
        process_id = int(v) if v else None

    multi = (num_processes or 0) > 1
    if coordinator_address and not num_processes:
        raise ValueError(
            "distributed config is partial: coordinator_address is set but "
            "num_processes is not — refusing to silently run single-process "
            f"(set one of {_NPROC_VARS})"
        )
    if multi and not coordinator_address:
        raise ValueError(
            "distributed config is partial: num_processes > 1 but no "
            f"coordinator address (set one of {_COORD_VARS})"
        )
    if multi and process_id is None:
        raise ValueError(
            "distributed config is partial: num_processes > 1 but no process "
            f"id (set one of {_PID_VARS})"
        )
    if coordinator_address and multi:
        addr = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        torch.distributed.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method=addr,
            world_size=num_processes,
            rank=process_id,
        )
    return process_info(dev)


def process_info(device: torch.device | str | None = None) -> ProcessInfo:
    """This process's rank and the world's size (0 and 1 outside a
    process group), and the devices of ``device``'s type: this process's
    visible cards (the CPU counts one), and the world's as that many a
    process."""
    dev = resolve_device(device)
    dist = torch.distributed
    joined = dist.is_available() and dist.is_initialized()
    pid = dist.get_rank() if joined else 0
    world = dist.get_world_size() if joined else 1
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    return ProcessInfo(
        process_id=pid,
        num_processes=world,
        local_device_count=local,
        global_device_count=local * world,
    )
