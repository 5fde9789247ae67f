"""Ring-allreduce miniapp core (shared by the xla and pallas variants).

Counterpart of ``tpu_patterns/miniapps/apps/allreduce/__init__.py``:

* each rank owns a full N-element buffer initialized to its rank id,
  here one shard of a (p*N,) array per rank of a rank mesh;
* the timed region runs the manual ring (accumulate, then (size-1) x
  {ring shift, accumulate}), the bandwidth-optimal ring (reduce-scatter
  + all-gather) or the library contrast (``psum``), over
  ``comm/ring.py``;
* allocator matrix ``-H/-D/-S``: every buffer of the allreduce lives in
  pinned host memory, device memory or CUDA managed memory, the taxonomy
  of ``concurrency/commands.py`` (on the CPU all three are plain CPU
  tensors);
* requires an even world size >= 4;
* validation: every element equals ``size*(size-1)/2`` within 1e-6,
  each rank reporting ``Passed <rank>``;
* timing: a chain of dependent allreduces, CUDA events on rank 0's
  stream.  Ranks that share a card run one after another on its stream,
  so ``wall_s`` is the world's serial time (the reference's ranks run in
  parallel, one per device).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_patterns_torch.comm import ring
from tpu_patterns_torch.comm.dtypes import get_dtype
from tpu_patterns_torch.comm.mesh import RankMesh, fresh_like
from tpu_patterns_torch.core import timing
from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict

ALGORITHMS = ("ring", "ring_opt", "psum")

# Allocator letter -> memory kind (≙ the -H/-D/-S getopt choices; the
# same taxonomy as concurrency/commands.py).
MEM_KINDS = {"H": "pinned_host", "D": "device", "S": "managed"}
# what a ring shift between two ranks of one card copies through
_SHIFT_MEMORY = {"H": "pinned-host-memory", "S": "managed-memory"}


@dataclasses.dataclass
class AllreduceConfig:
    elements: int = 1 << 25  # per-rank N
    dtype: str = "float32"
    # manual ring is the no-flag default; choices feed argparse
    algorithm: str = dataclasses.field(
        default="ring", metadata={"choices": ALGORITHMS}
    )
    mem_kind: str = dataclasses.field(
        default="D", metadata={"choices": tuple(MEM_KINDS)}
    )
    reps: int = 5
    warmup: int = 1
    tol: float = 1e-6  # elementwise tolerance
    require_even_ge4: bool = True


def _check_world(p: int, cfg: AllreduceConfig) -> None:
    if cfg.require_even_ge4 and (p < 4 or p % 2):
        raise ValueError(
            f"allreduce miniapp needs an even world size >= 4, got {p} "
            "(≙ allreduce-mpi-sycl.cpp:95-97)"
        )


def _rescale(y: torch.Tensor, p: int) -> torch.Tensor:
    """Bounded loop-carried feed for the timing chain: after one
    allreduce all shards are equal, so dividing by p makes further
    iterations a fixed point.  Floor division for integers; for floats
    a multiply by 1/p in the tensor's own dtype.  A new buffer in ``y``'s
    memory kind."""
    out = fresh_like(y)
    if y.is_floating_point():
        return torch.mul(y, 1.0 / p, out=out)
    return torch.floor_divide(y, p, out=out)


def wire_bytes_per_rank(algorithm: str, n_bytes: int, p: int) -> float:
    """Bytes each rank puts on the wire for one allreduce."""
    if algorithm == "ring":
        return float((p - 1) * n_bytes)  # full buffer each step
    # reduce-scatter + all-gather (also the busbw convention for psum)
    return 2.0 * (p - 1) / p * n_bytes


def allreduces_per_run(cfg: AllreduceConfig) -> int:
    """How many allreduces :func:`run_allreduce` performs: the timing
    chain's warm-up and timed windows, then one for validation."""
    return timing.CHAIN_K * (cfg.warmup + cfg.reps) + 1


def run_allreduce(
    mesh: RankMesh,
    cfg: AllreduceConfig,
    writer: ResultWriter | None = None,
    op=None,
    variant: str = "xla",
) -> Record:
    """One app invocation: init, timed allreduce, validate, verdict."""
    writer = writer or ResultWriter()
    p = mesh.size
    _check_world(p, cfg)
    if cfg.algorithm not in ALGORITHMS:
        raise ValueError(
            f"unknown algorithm {cfg.algorithm!r}; one of {ALGORITHMS}")
    if cfg.algorithm == "ring_opt" and cfg.elements % p:
        raise ValueError(
            f"ring_opt needs elements % world == 0, got {cfg.elements} % {p}"
        )
    kind = MEM_KINDS[cfg.mem_kind]
    spec = get_dtype(cfg.dtype)
    n_bytes = cfg.elements * spec.itemsize
    label = f"{p}dev {cfg.dtype} {cfg.mem_kind} N={cfg.elements}"
    writer.progress(
        f"allreduce[{variant}:{cfg.algorithm}]: {label} "
        f"({n_bytes / 1e6:.1f} MB/rank)"
    )

    # Initialize: rank r holds the constant r.  Host staging in the
    # narrowest integer type, widened as each shard is placed.
    host = np.repeat(np.arange(p, dtype=np.min_scalar_type(p)), cfg.elements)
    try:
        x = mesh.scatter(host, cfg.mem_kind, spec.canonical)
        for d in mesh.cards():
            timing.device_barrier(d)
    except Exception as e:
        if cfg.mem_kind == "D":
            raise  # device placement must work; only host kinds may fail
        return writer.record(Record(
            pattern="allreduce",
            mode=f"{variant}:{cfg.algorithm}",
            commands=label,
            verdict=Verdict.SKIPPED,
            notes=[f"memory kind {kind!r} unavailable: {e}"],
        ))
    del host

    def reduce_fn(v):
        return ring.allreduce(v, cfg.algorithm, op)

    def build_chain(k: int):
        def run():
            v = x
            for _ in range(k):
                v = [_rescale(y, p) for y in reduce_fn(v)]
            mesh.join()
        return run

    with mesh.allocating_in(cfg.mem_kind):
        res = timing.measure_chain(build_chain, reps=cfg.reps,
                                   warmup=cfg.warmup, device=mesh.devices[0])
        out = mesh.gather(reduce_fn(x)).reshape(p, cfg.elements)
    wall_s = timing.max_over_processes_s(res.per_op_ns * 1e-9)

    # Validation: elementwise size*(size-1)/2 within tol, checked per
    # shard so each rank reports its own Passed line.
    expect = p * (p - 1) // 2
    ok_all = True
    for r in range(p):
        shard_ok = bool(
            ((out[r].to(torch.float64) - expect).abs() <= cfg.tol).all())
        ok_all &= shard_ok
        writer.progress(f"Passed {r}" if shard_ok else f"FAILED {r}")

    wire = wire_bytes_per_rank(cfg.algorithm, n_bytes, p)
    busbw = 2.0 * (p - 1) / p * n_bytes / (wall_s * 1e9)  # GB/s
    writer.metric(f"allreduce[{variant}:{cfg.algorithm}] time", wall_s, "s")
    rec = Record(
        pattern="allreduce",
        mode=f"{variant}:{cfg.algorithm}",
        commands=label,
        metrics={
            "wall_s": wall_s,
            "busbw_GBps": busbw,
            "wire_GBps": wire / (wall_s * 1e9),
            "bytes_per_rank": float(n_bytes),
            "validated": float(ok_all),
            "timing_converged": float(res.converged),
        },
        verdict=Verdict.SUCCESS if ok_all else Verdict.FAILURE,
        config={
            "elements": cfg.elements,
            "dtype": cfg.dtype,
            "algorithm": cfg.algorithm,
            "mem_kind": cfg.mem_kind,
            "world": p,
        },
    )
    if note := mesh.note(memory=_SHIFT_MEMORY.get(cfg.mem_kind)
                         if mesh.on_cuda else None):
        rec.notes.append(note)
    if not ok_all:
        rec.notes.append(f"elementwise check != {expect} (tol {cfg.tol})")
    if note := res.noise_note("GB/s"):
        rec.notes.append(note)
    return writer.record(rec)
