"""Collective matmul: the tensor-parallel matmuls with their collective
cut into ring hops, one matmul a hop.

Counterpart of ``tpu_patterns/parallel/overlap.py``.  Two duals (the two
Megatron-style TP matmuls):

* :func:`allgather_matmul`: column-parallel ``Y = X @ W_col`` with X's
  rows sharded; instead of all-gathering X and one matmul, each rank's
  X chunk travels the ring and is multiplied on arrival;
* :func:`matmul_reducescatter`: row-parallel ``Y = sum_r X_r @ W_r``
  with the output's rows scattered; the accumulator travels the
  reduce-scatter ring, each rank adding its partial product for the
  block's final owner before passing it on.

Each is checked against its undecomposed form (the library collective
and one matmul) element by element, and the pair is timed as a contrast
(``speedup = baseline / decomposed``).

There each function runs inside ``shard_map`` and XLA's scheduler may
hide a hop's transfer under the previous hop's matmul.  Here a function
takes and returns per-rank lists (``comm/mesh.py``), a hop is
``comm/ring.py::ring_shift`` and every copy and matmul goes on the
rank's current stream, with no side stream.  Ranks that share a card run
one after another, so nothing can overlap there: the speedup is
informational (``min_speedup < 0``) and each Record's note says so.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from tpu_patterns_torch.comm.mesh import RankMesh, default_mesh
from tpu_patterns_torch.comm.ring import (
    library_all_gather,
    library_reduce_scatter,
    ring_shift,
)
from tpu_patterns_torch.core import timing
from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict
from tpu_patterns_torch.runtime import exact_f32, torch_dtype


def allgather_matmul(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                     decomposed: bool = True) -> list[torch.Tensor]:
    """Column-parallel collective matmul.

    ``xs[r]``: [B_local, E] (rows sharded), ``ws[r]``: [E, F_local]
    (columns sharded).  Returns each rank's [n * B_local, F_local]: every
    row of x against the rank's columns.

    decomposed=False: the baseline, all-gather then one matmul.
    decomposed=True: x chunks ride the ring; hop i multiplies the chunk
    that started at rank (r - i) mod n and writes it into that rank's
    row block, so the blocks hold the baseline's products.  n multiplies
    need n - 1 transfers: nothing travels after the last (a drain hop
    would sit on the critical path and skew the contrast)."""
    n = len(xs)
    if not decomposed:
        return [full @ w for full, w in zip(library_all_gather(xs), ws)]
    bl = xs[0].shape[0]
    outs = [x.new_empty((n * bl, w.shape[1])) for x, w in zip(xs, ws)]
    chunks = list(xs)
    for i in range(n):
        for r in range(n):
            src = (r - i) % n  # the rank this chunk's rows belong to
            torch.mm(chunks[r], ws[r], out=outs[r][src * bl:(src + 1) * bl])
        if i < n - 1:
            chunks = ring_shift(chunks)
    return outs


def matmul_reducescatter(xs: Sequence[torch.Tensor],
                         ws: Sequence[torch.Tensor],
                         decomposed: bool = True) -> list[torch.Tensor]:
    """Row-parallel collective matmul.

    ``xs[r]``: [B, E_local] (the contraction dim sharded), ``ws[r]``:
    [E_local, F].  The full product is the sum over ranks of
    ``x_r @ w_r``; each rank keeps its [B / n, F] row block of the sum.

    decomposed=False: one local matmul, then the reduce-scatter.
    decomposed=True: the accumulator travels the reduce-scatter ring; at
    hop i a rank adds only its partial product for the block owned by
    rank ``(r + n-1-i) % n``, n - 1 transfers among n matmul chunks."""
    n = len(xs)
    if not decomposed:
        return library_reduce_scatter([x @ w for x, w in zip(xs, ws)])
    bl = xs[0].shape[0] // n
    accs: list[torch.Tensor] = [None] * n  # type: ignore[list-item]
    for i in range(n):
        for r in range(n):
            dst = (r + (n - 1) - i) % n
            rows = xs[r][dst * bl:(dst + 1) * bl]
            accs[r] = (rows @ ws[r] if i == 0
                       else torch.addmm(accs[r], rows, ws[r]))
        if i < n - 1:
            accs = ring_shift(accs)
    return accs


@dataclasses.dataclass
class OverlapConfig:
    """CLI ``overlap`` subcommand."""

    rows: int = 1024  # per-rank rows of x (AG) / output rows (RS)
    contract: int = 4096  # contraction dim E
    cols: int = 4096  # per-rank output columns F
    dtype: str = "bfloat16"
    pattern: str = "both"  # ag | rs | both
    reps: int = 5
    warmup: int = 2
    min_speedup: float = -1.0  # <0: speedup is informational only
    seed: int = 0
    device: str = "cuda"


def _shards(mesh: RankMesh, a: torch.Tensor, dim: int) -> list[torch.Tensor]:
    """``a`` cut into the mesh's ranks' blocks along ``dim`` (a
    ``NamedSharding`` over the mesh axis at that dim), each a contiguous
    buffer of its own on its rank."""
    k = a.shape[dim] // mesh.size
    return [a.narrow(dim, r * k, k).to(d, copy=True).contiguous()
            for r, d in enumerate(mesh.devices)]


def _run_one(mesh: RankMesh, cfg: OverlapConfig, kind: str,
             writer: ResultWriter) -> Record:
    n = mesh.size
    dev = mesh.devices[0]
    dtype = torch_dtype(cfg.dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    x = normal(n * cfg.rows, cfg.contract)
    if kind == "ag":
        fn = allgather_matmul
        # the global W is column-sharded: each rank owns an [E, cols] block
        w = normal(cfg.contract, n * cfg.cols)
        xs, ws = _shards(mesh, x, 0), _shards(mesh, w, 1)
        # FLOPs a rank: every row x its local columns
        flops = 2.0 * (n * cfg.rows) * cfg.contract * cfg.cols
        moved = (n - 1) * cfg.rows * cfg.contract * itemsize
    elif kind == "rs":
        fn = matmul_reducescatter
        w = normal(cfg.contract, cfg.cols)
        xs, ws = _shards(mesh, x, 1), _shards(mesh, w, 0)
        flops = 2.0 * (n * cfg.rows) * cfg.contract * cfg.cols / n
        moved = (n - 1) * cfg.rows * cfg.cols * itemsize
    else:
        raise ValueError(f"unknown overlap pattern {kind!r}; want ag|rs")
    del x, w

    base = fn(xs, ws, decomposed=False)
    dec = fn(xs, ws, decomposed=True)
    # decomposed == undecomposed collective, element by element, with a
    # tolerance scaled to the magnitude (rs sums the ranks in another
    # order)
    err = max(float((b.float() - d.float()).abs().max())
              for b, d in zip(base, dec))
    scale = max(1.0, max(float(b.float().abs().max()) for b in base))
    tol = (64 if dtype == torch.float32 else 16) * float(
        torch.finfo(dtype).eps) * scale
    exact_ok = err <= tol
    del base, dec

    times, measures = {}, {}
    for name, decomposed in (("baseline", False), ("decomposed", True)):
        def build_chain(k: int, _d=decomposed):
            def run():
                for _ in range(k):
                    fn(xs, ws, decomposed=_d)
                mesh.join()
            return run

        measures[name] = timing.measure_chain(
            build_chain, reps=cfg.reps, warmup=cfg.warmup, device=dev)
        times[name] = measures[name].per_op_ns

    speedup = (times["baseline"] / times["decomposed"]
               if times["decomposed"] else 0.0)
    perf_ok = cfg.min_speedup < 0 or speedup >= cfg.min_speedup
    converged = all(m.converged for m in measures.values())
    rec = Record(
        pattern="overlap",
        mode=kind,
        commands=f"{n}dev rows{cfg.rows} E{cfg.contract} F{cfg.cols} "
        f"{cfg.dtype}",
        metrics={
            "baseline_us": round(times["baseline"] / 1e3, 2),
            "decomposed_us": round(times["decomposed"] / 1e3, 2),
            "speedup": round(speedup, 4),
            "tflops_decomposed": round(
                flops / times["decomposed"] / 1e3, 2
            ) if times["decomposed"] else 0.0,
            "ring_bytes": float(moved),
            "timing_converged": float(converged),
        },
        verdict=Verdict.SUCCESS if (exact_ok and perf_ok)
        else Verdict.FAILURE,
    )
    if not converged:
        rec.notes.append(timing.noise_bound_note("speedup"))
    if not exact_ok:
        rec.notes.append("decomposed result diverges from the library "
                         f"collective: {err:.3e} > {tol:.3e}")
    if note := mesh.note("ring shifts and collectives"):
        rec.notes.append(
            note + "; ranks sharing a card run one after another, so no "
            "transfer hides under a matmul: the speedup is informational "
            "and tflops_decomposed is a rank's share of the card's rate")
    writer.record(rec)
    return rec


def run_overlap(mesh: RankMesh | None = None,
                cfg: OverlapConfig | None = None,
                writer: ResultWriter | None = None) -> list[Record]:
    """The ``ag`` and/or ``rs`` Records over ``mesh`` (default: one rank
    a card of ``cfg.device``)."""
    cfg = cfg or OverlapConfig()
    writer = writer or ResultWriter()
    mesh = mesh or default_mesh(0, cfg.device)
    kinds = ("ag", "rs") if cfg.pattern == "both" else (cfg.pattern,)
    with exact_f32(mesh.on_cuda), torch.no_grad():
        return [_run_one(mesh, cfg, k, writer) for k in kinds]
