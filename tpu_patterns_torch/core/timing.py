"""Clocks, the device barrier and CUDA-event timing.

The host clock is the native module's ``CLOCK_MONOTONIC``
(``interop/native.py``, built at first use), as the reference's is
(``tpu_patterns/core/timing.py:28-51``); a failed build raises and no
other clock is taken.  It times host-visible work (a request, a serve
run) that ends in a device barrier; a kernel's time comes from CUDA
events around its launches, since PyTorch returns before the device
finishes.
``measure_chain`` times a chain of dependent ops (train steps, puts) as
the reference's does, with CUDA events in place of its fetch round trip.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import torch

from tpu_patterns_torch.interop import native


def clock_ns() -> int:
    """Monotonic nanoseconds for durations, from the native clock."""
    return native.clock_ns()


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


def max_over_processes_s(dt_s: float) -> float:
    """Max-over-ranks duration (the reference's ``MPI_Allreduce`` with
    ``MPI_MAX``).  The port runs its ranks in one process (a rank mesh),
    whose timed window already covers every rank, so this is the
    identity; the reference gathers over processes here."""
    return dt_s


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


def cuda_time_repeated_ms(
    fn: Callable[[], object],
    calls: int = 5,
    reps: int = 20,
    warmup: int = 3,
    before: Callable[[], object] | None = None,
) -> dict:
    """:func:`cuda_time_ms` read ``calls`` times in a row: the median of
    the readings (``ms``) with their ``min``, ``max`` and every reading
    (``runs``), so that a small kernel's time does not rest on one
    reading."""
    runs = [cuda_time_ms(fn, reps=reps, warmup=warmup, before=before)
            for _ in range(calls)]
    return {"ms": statistics.median(runs), "min": min(runs),
            "max": max(runs), "runs": runs}


CHAIN_K = 2  # chain iterations per timed window
SPREAD_LIMIT = 0.1  # reps spread past this share of their min: noise
# Dependent ops per chain iteration for callers that pass
# ``ops_per_iter=CHAIN_UNROLL`` (as the reference's puts do): one window
# then holds CHAIN_K x CHAIN_UNROLL ops, which keeps a fast op's window
# well above the event resolution.
CHAIN_UNROLL = 8


def unrolled_chain(op: Callable[[object], object], a: object, k: int):
    """``k`` iterations of exactly ``CHAIN_UNROLL`` dependent ``op``
    applications, each fed the previous one's output; returns the last.
    The unroll is fixed so that it cannot drift from the accounting."""
    for _ in range(k):
        for _ in range(CHAIN_UNROLL):
            a = op(a)
    return a


def noise_bound_note(what: str = "rate") -> str:
    """The shared not-a-measurement wording for a metric whose timed
    windows spread past ``SPREAD_LIMIT`` (see
    :meth:`ChainMeasurement.noise_note`)."""
    return (f"timed windows spread beyond the noise limit — {what} is "
            "noise-bound, not measured")


@dataclasses.dataclass
class ChainMeasurement:
    """Per-op time of a chain of dependent ops: the minimum over reps
    of one timed window of ``CHAIN_K`` iterations, divided by the ops it
    ran.
    ``converged`` is False when the reps spread by more than
    ``SPREAD_LIMIT`` of that minimum: the per-op time is then
    noise-bound, and records say so."""

    per_op_ns: float
    converged: bool = True

    def gbps(self, n_bytes: float) -> float:
        """bytes per ns == decimal GB/s, the reference's unit."""
        return n_bytes / self.per_op_ns

    def us(self) -> float:
        return self.per_op_ns * 1e-3

    def noise_note(self, what: str = "rate") -> str | None:
        return None if self.converged else noise_bound_note(what)


def measure_chain(
    build_chain: Callable[[int], Callable[[], object]],
    reps: int = 5,
    warmup: int = 1,
    device: torch.device | str = "cuda",
    ops_per_iter: int = 1,
) -> ChainMeasurement:
    """Time ``build_chain(CHAIN_K)()``, a callable running ``CHAIN_K``
    iterations of ``ops_per_iter`` dependent ops each (each op feeding
    the next, so none can be skipped), ``reps`` times after ``warmup``
    untimed runs; the per-op time is per single op.  On the card each
    window is a CUDA-event pair around the chain, recorded on the
    current stream: a chain that forks work to side streams joins them
    back to it inside each iteration, or the window misses their work.
    On the CPU, where torch runs synchronously, the host clock.  Buffers the chain takes
    from the caching allocator are cached by the warmup runs, so no
    window waits on a device allocation."""
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
        per_op_ns=best / (CHAIN_K * ops_per_iter),
        converged=max(windows) - best <= SPREAD_LIMIT * best,
    )
