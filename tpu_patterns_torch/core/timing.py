"""Clocks, the device barrier and CUDA-event timing.

The host clock times host-visible work (a request, a serve run) that
ends in a device barrier; a kernel's time comes from CUDA events around
its launches, since PyTorch returns before the device finishes.
``measure_chain`` times a chain of dependent ops (train steps) as the
reference's does, with CUDA events in place of its fetch round trip.
"""

from __future__ import annotations

import dataclasses
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


CHAIN_K = 2  # dependent ops per timed window
SPREAD_LIMIT = 0.1  # reps spread past this share of their min: noise


@dataclasses.dataclass
class ChainMeasurement:
    """Per-op time of a chain of dependent ops: the minimum over reps
    of one timed window of ``CHAIN_K`` ops, divided by ``CHAIN_K``.
    ``converged`` is False when the reps spread by more than
    ``SPREAD_LIMIT`` of that minimum: the per-op time is then
    noise-bound, and records say so."""

    per_op_ns: float
    converged: bool = True

    def noise_note(self, what: str = "rate") -> str | None:
        if self.converged:
            return None
        return (f"timed windows spread beyond the noise limit — {what} is "
                "noise-bound, not measured")


def measure_chain(
    build_chain: Callable[[int], Callable[[], object]],
    reps: int = 5,
    warmup: int = 1,
    device: torch.device | str = "cuda",
) -> ChainMeasurement:
    """Time ``build_chain(CHAIN_K)()``, a callable running ``CHAIN_K``
    dependent ops (each feeding the next, so none can be skipped),
    ``reps`` times after ``warmup`` untimed runs.  On the card each
    window is a CUDA-event pair around the chain; on the CPU, where
    torch runs synchronously, the host clock."""
    dev = torch.device(device)
    run = build_chain(CHAIN_K)
    for _ in range(warmup):
        run()
    windows = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            windows.append(start.elapsed_time(end) * 1e6)
        else:
            t0 = clock_ns()
            run()
            windows.append(float(clock_ns() - t0))
    best = min(windows)
    return ChainMeasurement(
        per_op_ns=best / CHAIN_K,
        converged=max(windows) - best <= SPREAD_LIMIT * best,
    )
