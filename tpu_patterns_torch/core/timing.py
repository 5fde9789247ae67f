"""Clocks, the device barrier and CUDA-event timing.

The host clock times host-visible work (a request, a serve run) that
ends in a device barrier; a kernel's time comes from CUDA events around
its launches, since PyTorch returns before the device finishes.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def clock_ns() -> int:
    """Monotonic nanoseconds for durations."""
    return time.perf_counter_ns()


def wall_time_s() -> float:
    """Wall-clock epoch seconds, for provenance (record timestamps)
    only, never for durations."""
    return time.time()


def device_barrier(device: torch.device | str | None = None) -> None:
    """Wait for every queued kernel on a CUDA device; a no-op on the
    CPU, where PyTorch runs synchronously."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cuda_time_ms(
    fn: Callable[[], object],
    reps: int = 20,
    warmup: int = 3,
    before: Callable[[], object] | None = None,
) -> float:
    """Mean device milliseconds of one ``fn()`` call, from a CUDA event
    pair around each call.  ``before`` runs outside the timed window
    before every call (an L2 flush, so each call finds its inputs cold
    in device memory as the real caller would)."""
    for _ in range(warmup):
        if before is not None:
            before()
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        if before is not None:
            before()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / reps
