"""Concurrency backends: commands on CUDA streams, and the copy-and-compute
kernel K7.

Counterpart of ``tpu_patterns/concurrency/backends.py``, under the
reference's backend and mode names (a Record's mode is
``f"{backend}:{mode}"``):

* ``XLABackend`` (``xla``) -- each command is its own device work: a
  compute ``C`` launches the busy-wait kernel K6, a copy is one
  ``copy_`` (the reference's copies are runtime transfers too).
  ``serial`` queues every command on the current stream in group order
  (the in-order queue); ``concurrent`` gives each command a stream of its
  own, forked from the current stream and joined back to it with events
  in every iteration (the out-of-order queue).  ``dispatch_serial`` waits
  for the device after each command, ``dispatch_async`` once after all
  (per-command wait against nowait + taskwait).
* ``PallasBackend`` (``pallas``) -- one launch of K7
  (``csrc/dma_compute.cu``) per group: D2D copies staged through shared
  memory by bulk asynchronous copies in some blocks, busy-wait computes
  in others.  ``dma_serial`` starts no compute before every copy has
  landed; ``dma_overlap`` runs them side by side.

On a CUDA tensor :func:`dma_compute` launches K7 (counted in
``dma_compute.launches``) or raises; on CPU tensors it runs
:func:`dma_compute_plain`.  Streams and buffers are made once per
``build``, outside any timed window.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Sequence

import torch

from tpu_patterns_torch.comm.onesided import streamed_block_rows
from tpu_patterns_torch.concurrency.commands import (
    Command,
    MemKind,
    alloc,
    empty_in,
)
from tpu_patterns_torch.concurrency.kernels import (
    A32,
    B32,
    busy_wait,
    busy_wait_plain,
)
from tpu_patterns_torch.core import timing


@dataclasses.dataclass
class BuiltGroup:
    """What a backend hands the harness for one command group x mode."""

    build_chain: Callable[[int], Callable[[], object]]  # for measure_chain
    direct_fn: Callable[[], object]  # one run, device-fenced
    n_bytes_per_iter: int
    cmd_bytes: list[int] = dataclasses.field(default_factory=list)
    # bytes each command moves per measured iteration, in input order
    # (copies chained as round trips count both directions)


def _chain(step: Callable[[list], list], first: list):
    """``build_chain`` of a group: ``k`` iterations of ``step``, each fed
    the previous one's outputs."""

    def make(k: int):
        def run():
            ins = first
            for _ in range(k):
                ins = step(ins)
            return ins

        return run

    return make


class XLABackend:
    name = "xla"
    modes = ("serial", "concurrent", "dispatch_serial", "dispatch_async")

    def solo_mode(self, mode: str) -> str:
        """Mode used for single-command serial probes: must share the
        group's execution path (queued vs dispatched) so M commands stay
        legal and times stay comparable."""
        return "dispatch_serial" if mode.startswith("dispatch") else "serial"

    def validate(self, mode: str, cmds: Sequence[Command]) -> None:
        """The reference's validation, texts kept."""
        if mode not in self.modes:
            raise ValueError(f"backend {self.name}: unknown mode {mode!r}; "
                             f"modes: {self.modes}")
        if not mode.startswith("dispatch"):
            bad = [c.text for c in cmds if MemKind.M in (c.src, c.dst)]
            if bad:
                raise ValueError(
                    f"commands {bad} touch pageable host memory (M), whose "
                    "copies block the host and cannot be queued on a "
                    "stream; use the dispatch_* modes or the S (managed) "
                    "kind"
                )
        if any(c.kind == "copy" and c.src is c.dst for c in cmds):
            raise ValueError(
                "D2D under the xla backend is refused as in the reference, "
                "where a same-space copy is elided by the compiler; use the "
                "pallas backend, whose kernel materializes the copy"
            )

    @staticmethod
    def _iter_bytes(cmd: Command) -> int:
        return cmd.bytes * (2 if cmd.kind == "copy" else 1)

    def build(self, cmds: Sequence[Command], mode: str,
              device: torch.device | str) -> BuiltGroup:
        dev = torch.device(device)
        if mode.startswith("dispatch"):
            return self._build_dispatch(cmds, mode, dev)
        bufs = [alloc(c, dev, seed=i) for i, c in enumerate(cmds)]
        # the far end of each copy's round trip
        peers = [None if c.kind == "compute" else
                 empty_in(c.dst, b.shape, dev) for c, b in zip(cmds, bufs)]

        def step(i: int, x: torch.Tensor) -> torch.Tensor:
            """One measured unit whose output feeds the next iteration:
            compute feeds through directly; a copy runs as a round trip
            (X2Y then Y2X), so it moves 2x its bytes per iteration."""
            cmd = cmds[i]
            if cmd.kind == "compute":
                return busy_wait(x, cmd.tripcount)
            peers[i].copy_(x, non_blocking=True)
            return x.copy_(peers[i], non_blocking=True)

        if mode == "serial" or dev.type == "cpu":
            def group_once(ins):
                return [step(i, b) for i, b in enumerate(ins)]
        else:
            streams = [torch.cuda.Stream(dev) for _ in cmds]
            for s, b, p in zip(streams, bufs, peers):
                for t in (b, p):
                    if t is not None and t.device.type == "cuda":
                        t.record_stream(s)

            def group_once(ins):
                cur = torch.cuda.current_stream(dev)
                fork = cur.record_event()
                outs = []
                for i, (s, b) in enumerate(zip(streams, ins)):
                    s.wait_event(fork)
                    with torch.cuda.stream(s):
                        outs.append(step(i, b))
                for s in streams:
                    cur.wait_stream(s)
                return outs

        def direct():
            out = group_once(bufs)
            timing.device_barrier(dev)
            return out

        return BuiltGroup(
            build_chain=_chain(group_once, bufs),
            direct_fn=direct,
            n_bytes_per_iter=sum(self._iter_bytes(c) for c in cmds),
            cmd_bytes=[self._iter_bytes(c) for c in cmds],
        )

    # -- eagerly dispatched commands -------------------------------------

    def _build_dispatch(self, cmds: Sequence[Command], mode: str,
                        dev: torch.device) -> BuiltGroup:
        block_each = mode == "dispatch_serial"
        bufs = [alloc(c, dev, seed=i) for i, c in enumerate(cmds)]
        fns = []
        for cmd, buf in zip(cmds, bufs):
            if cmd.kind == "compute":
                fns.append(functools.partial(busy_wait, buf, cmd.tripcount))
            else:
                dst = empty_in(cmd.dst, buf.shape, dev)
                fns.append(functools.partial(dst.copy_, buf,
                                             non_blocking=True))

        def run_once():
            outs = []
            for f in fns:
                outs.append(f())
                if block_each:
                    timing.device_barrier(dev)
            timing.device_barrier(dev)
            return outs

        def make(k: int):
            def run_k():
                out = None
                for _ in range(k):
                    out = run_once()
                return out

            return run_k

        return BuiltGroup(
            build_chain=make,
            direct_fn=run_once,
            n_bytes_per_iter=sum(c.bytes for c in cmds),
            cmd_bytes=[c.bytes for c in cmds],
        )


# -- K7: copies and computes in one kernel --------------------------------

# csrc/dma_compute.cu's MAX_COPIES and MAX_COMPUTES (the smoke checks the
# two agree)
MAX_COPIES = 8
MAX_COMPUTES = 8


def _dma_library() -> ctypes.CDLL:
    from tpu_patterns_torch.kernels.build import load

    lib = load("dma_compute")
    if lib.dma_compute.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        i64s = ctypes.POINTER(ctypes.c_longlong)
        lib.dma_compute.restype = i32
        lib.dma_compute.argtypes = [ptrs, ptrs, i64s, i64s, i32, ptrs, ptrs,
                                    i64s, i64s, i32, f32, f32, i32, ptr, ptr]
        for name in ("dma_compute_max_copies", "dma_compute_max_computes"):
            getattr(lib, name).restype = i32
            getattr(lib, name).argtypes = []
    return lib


def copy_plan(x: torch.Tensor) -> tuple[int, int]:
    """(segments, bytes each) of a K7 copy of ``x``: tiles of whole rows,
    the largest row count that divides the rows and fits one
    shared-memory stage, as K8b tiles its puts."""
    rows = x.shape[0]
    row_bytes = x.numel() // rows * x.element_size()
    tile = streamed_block_rows(rows, row_bytes, rows)
    return rows // tile, tile * row_bytes


def dma_compute_plain(copy_srcs: Sequence[torch.Tensor],
                      comp_ins: Sequence[torch.Tensor],
                      tripcounts: Sequence[int]) -> tuple:
    """Plain K7: a ``copy_`` of each copy source, then
    :func:`busy_wait_plain` of each compute input; the copy destinations
    first, then the compute outputs (the reference's output order).  The
    mode orders the work, not its results."""
    dsts = [torch.empty_like(s).copy_(s) for s in copy_srcs]
    outs = [busy_wait_plain(x, t) for x, t in zip(comp_ins, tripcounts)]
    return (*dsts, *outs)


def _check_k7(copy_srcs, comp_ins, tripcounts) -> None:
    if len(comp_ins) != len(tripcounts):
        raise ValueError("dma_compute: one tripcount per compute")
    if not copy_srcs and not comp_ins:
        raise ValueError("dma_compute: no copy and no compute")
    if len(copy_srcs) > MAX_COPIES or len(comp_ins) > MAX_COMPUTES:
        raise ValueError(
            f"dma_compute: at most {MAX_COPIES} copies and {MAX_COMPUTES} "
            f"computes per launch, got {len(copy_srcs)} and {len(comp_ins)}")
    if any(t < 0 for t in tripcounts):
        raise ValueError(f"tripcounts must be >= 0, got {list(tripcounts)}")
    for t in (*copy_srcs, *comp_ins):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.ndim < 1 \
                or t.numel() == 0:
            raise ValueError("dma_compute: want non-empty contiguous float32 "
                             f"tensors, got {t.dtype} {tuple(t.shape)}")


class K7Launch:
    """One K7 launch with its arguments marshalled once: copies of
    ``copy_srcs`` into ``dsts`` and busy-waits of ``comp_ins`` (at
    ``tripcounts``) into ``outs``, in the mode ``overlap`` names.  Each
    call launches on the current stream (or raises), counts in
    ``dma_compute.launches`` and returns ``(*dsts, *outs)``.  A backend
    that launches the same group again and again binds it once, so its
    timed windows hold no marshalling."""

    def __init__(self, copy_srcs, comp_ins, tripcounts, overlap: bool,
                 dsts, outs):
        _check_k7(copy_srcs, comp_ins, tripcounts)
        tensors = (*copy_srcs, *comp_ins, *dsts, *outs)
        dev = tensors[0].device
        if dev.type != "cuda" or any(t.device != dev for t in tensors):
            raise ValueError("K7Launch: want tensors on one CUDA device, "
                             f"got {sorted({str(t.device) for t in tensors})}")
        if [(t.shape, t.dtype) for t in (*dsts, *outs)] != [
                (t.shape, t.dtype) for t in (*copy_srcs, *comp_ins)] or any(
                not t.is_contiguous() for t in (*dsts, *outs)):
            raise ValueError("K7Launch: outputs must match the inputs' "
                             "shapes and be contiguous float32")
        plans = [copy_plan(s) for s in copy_srcs]
        # dma_serial's count of copy blocks done, zeroed by the launch
        self._done = (torch.empty(1, dtype=torch.int32, device=dev)
                      if copy_srcs and not overlap else None)

        def ptrs(ts):
            return (ctypes.c_void_p * max(1, len(ts)))(
                *[t.data_ptr() for t in ts])

        def ints(vs):
            return (ctypes.c_longlong * max(1, len(vs)))(*vs)

        self._args = (
            ptrs(copy_srcs), ptrs(dsts), ints([n for n, _ in plans]),
            ints([b for _, b in plans]), len(copy_srcs), ptrs(comp_ins),
            ptrs(outs), ints([x.numel() for x in comp_ins]),
            ints(list(tripcounts)), len(comp_ins), A32, B32,
            int(not overlap),
            None if self._done is None else self._done.data_ptr(),
        )
        self._dev = dev
        # the tensors whose addresses the arguments hold, kept alive
        self._inputs = (*copy_srcs, *comp_ins)
        self.outputs = (*dsts, *outs)

    def __call__(self) -> tuple:
        with torch.cuda.device(self._dev):
            rc = _dma_library().dma_compute(
                *self._args, torch.cuda.current_stream(self._dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"dma_compute kernel launch failed: CUDA "
                               f"error {rc}")
        dma_compute.launches += 1
        return self.outputs


def dma_compute(copy_srcs: Sequence[torch.Tensor],
                comp_ins: Sequence[torch.Tensor],
                tripcounts: Sequence[int], overlap: bool = True) -> tuple:
    """K7: copies of ``copy_srcs`` and busy-waits of ``comp_ins`` (at
    ``tripcounts``) in one launch on the current stream; returns the copy
    destinations, then the compute outputs, as new tensors.  ``overlap``
    (``dma_overlap``) runs copies and computes side by side; otherwise
    (``dma_serial``) no compute starts before every copy has landed.
    CPU tensors run :func:`dma_compute_plain`; CUDA tensors launch the
    kernel (through :class:`K7Launch`) or raise."""
    _check_k7(copy_srcs, comp_ins, tripcounts)
    tensors = (*copy_srcs, *comp_ins)
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("dma_compute: tensors on more than one device")
    if dev.type == "cpu":
        return dma_compute_plain(copy_srcs, comp_ins, tripcounts)
    if dev.type != "cuda":
        raise ValueError(f"dma_compute: no kernel for device {dev}")
    return K7Launch(copy_srcs, comp_ins, tripcounts, overlap,
                    [torch.empty_like(s) for s in copy_srcs],
                    [torch.empty_like(x) for x in comp_ins])()


dma_compute.launches = 0


class PallasBackend:
    name = "pallas"
    modes = ("dma_serial", "dma_overlap")

    def solo_mode(self, mode: str) -> str:
        return "dma_serial"

    def validate(self, mode: str, cmds: Sequence[Command]) -> None:
        if mode not in self.modes:
            raise ValueError(f"backend {self.name}: unknown mode {mode!r}; "
                             f"modes: {self.modes}")
        for c in cmds:
            if c.kind == "copy" and not (c.src is MemKind.D
                                         and c.dst is MemKind.D):
                raise ValueError(
                    f"pallas backend overlaps on-device copies with compute "
                    f"in one kernel; command {c.text!r} is not a D2D copy "
                    "(the kernel copies device memory only)"
                )

    def build(self, cmds: Sequence[Command], mode: str,
              device: torch.device | str) -> BuiltGroup:
        dev = torch.device(device)
        overlap = mode == "dma_overlap"
        copies = [c for c in cmds if c.kind == "copy"]
        computes = [c for c in cmds if c.kind == "compute"]
        copy_bufs = [alloc(c, dev, seed=10 + i) for i, c in enumerate(copies)]
        comp_bufs = [alloc(c, dev, seed=20 + i)
                     for i, c in enumerate(computes)]
        n_copy = len(copies)
        trips = [c.tripcount for c in computes]
        args = [*copy_bufs, *comp_bufs]

        if dev.type == "cuda":
            # outputs mirror inputs (copy destinations + compute outputs,
            # same shapes), so they feed the next iteration directly: two
            # buffer sets in turn, each launch bound once, here
            other = [torch.empty_like(t) for t in args]
            to_other = K7Launch(args[:n_copy], args[n_copy:], trips,
                                overlap, other[:n_copy], other[n_copy:])
            to_args = K7Launch(other[:n_copy], other[n_copy:], trips,
                               overlap, args[:n_copy], args[n_copy:])

            def call(ins):
                return list((to_other if ins[0] is args[0] else to_args)())
        else:
            def call(ins):
                return list(dma_compute(ins[:n_copy], ins[n_copy:], trips,
                                        overlap))

        def direct():
            out = call(args)
            timing.device_barrier(dev)
            return out

        return BuiltGroup(
            build_chain=_chain(call, args),
            direct_fn=direct,
            n_bytes_per_iter=sum(c.bytes for c in cmds),
            cmd_bytes=[c.bytes for c in cmds],
        )


BACKENDS = {b.name: b for b in (XLABackend(), PallasBackend())}


def get_backend(name: str):
    try:
        return BACKENDS[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; available: {', '.join(BACKENDS)}"
        ) from None
