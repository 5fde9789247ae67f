"""Hierarchical (two-tier) allreduce: inner tier first, outer tier second.

Counterpart of ``tpu_patterns/comm/hierarchical.py``.  The ranks of a
rank mesh (``comm/mesh.py``) are viewed as a row-major ``(dcn, ici)``
grid: ``dcn`` groups (the slow outer tier) of ``ici`` ranks each (the
fast inner tier).  The decomposition of the cross-tier allreduce:

    reduce_scatter(ici)  ->  allreduce(dcn)  ->  all_gather(ici)

so each rank ships only ``1/ici`` of the buffer across the outer tier,
against a flat allreduce over every rank.  Where the reference runs
``psum_scatter``, ``psum`` and ``all_gather`` under ``shard_map``, each
step here is torch copies between ranks (peer copies across cards) and
adds, summing in rank order.  XLA's float sums take their own order, so
floats are held to the reference's magnitude-scaled gate and integers
(whose wrapping adds any order gets right) bit for bit.

Traffic accounting per rank (N payload bytes, p = ici x dcn ranks):

    flat:  2 (p-1)/p N
    hier:  ici tier 2 (ici-1)/ici N  +  dcn tier 2 (dcn-1)/dcn N / ici

With one process, every rank lies in one process group, so
:func:`detect_hierarchy` finds one group (``--dcn 0``); an explicit
``dcn`` splits the ranks as asked, and ranks sharing a card move their
chunks through its memory (``RankMesh.note``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import numpy as np
import torch

from tpu_patterns_torch.comm import verify
from tpu_patterns_torch.comm.dtypes import get_dtype
from tpu_patterns_torch.comm.mesh import RankMesh, fresh_like
from tpu_patterns_torch.comm.ring import library_allreduce
from tpu_patterns_torch.core import timing
from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict


def flat_allreduce(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """One allreduce over every rank of both tiers (the reference's
    ``psum`` over both axes): the library sum, copied to every rank."""
    return library_allreduce(xs)


def hierarchical_allreduce(xs: Sequence[torch.Tensor], ici: int
                           ) -> list[torch.Tensor]:
    """reduce_scatter over each group of ``ici`` consecutive ranks,
    allreduce of each chunk across the groups, all_gather within each
    group.  Rank order is row-major (dcn, ici); the per-rank length must
    divide by ``ici``."""
    p = len(xs)
    n = xs[0].shape[0]
    if n % ici != 0:
        raise ValueError(
            f"leading dim {n} not divisible by ici axis size {ici}"
        )
    if p % ici:
        raise ValueError(f"{p} ranks do not split into groups of {ici}")
    dcn, c = p // ici, n // ici

    def sent(src: torch.Tensor, r: int) -> torch.Tensor:
        """``src`` of another rank, in a fresh buffer of rank ``r``."""
        return torch.empty_like(src, device=xs[r].device).copy_(src)

    def summed(parts: list[torch.Tensor]) -> torch.Tensor:
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        return acc

    # reduce_scatter: rank (g, j) sums chunk j of its group's ranks
    shard = []
    for r in range(p):
        g, j = divmod(r, ici)
        chunks = [xs[g * ici + i][j * c:(j + 1) * c] for i in range(ici)]
        shard.append(summed([x if i == j else sent(x, r)
                             for i, x in enumerate(chunks)]))
    # allreduce over dcn: rank (g, j) sums chunk j across the groups
    total = []
    for r in range(p):
        g, j = divmod(r, ici)
        total.append(summed([shard[r] if h == g else
                             sent(shard[h * ici + j], r)
                             for h in range(dcn)]))
    # all_gather: rank (g, j) collects its group's chunks in order
    out = []
    for r in range(p):
        g = r // ici
        buf = fresh_like(xs[r])
        for i in range(ici):
            buf[i * c:(i + 1) * c].copy_(total[g * ici + i])
        out.append(buf)
    return out


VARIANTS = ("flat", "hier")


def traffic_model(
    n_bytes: int, ici: int, dcn: int
) -> dict[str, float]:
    """Analytic per-device wire bytes of each variant (module docstring)."""
    p = ici * dcn
    return {
        "flat_bytes_per_device": 2 * (p - 1) / p * n_bytes,
        "ici_bytes_per_device": 2 * (ici - 1) / ici * n_bytes,
        "dcn_bytes_per_device": 2 * (dcn - 1) / dcn * n_bytes / ici,
    }


@dataclasses.dataclass
class HierConfig:
    count: int = 2**22  # per-device elements (gradient-shard scale)
    dtype: str = "float32"
    dcn: int = 2  # outer axis size; 0 = auto-detect (process groups)
    reps: int = 5
    warmup: int = 2
    seed: int = 0


def detect_hierarchy(devices) -> tuple[int, list]:
    """The outer tier from the devices themselves: on platform ``tpu``
    ``slice_index``, elsewhere ``process_index`` (0 when a device has
    none, as a ``torch.device`` has not).  Returns ``(n_groups,
    devices)`` with the devices reordered group-contiguously."""

    def keys_by(attr: str, default=None) -> list | None:
        vals = [getattr(d, attr, default) for d in devices]
        return None if any(v is None for v in vals) else [int(v) for v in vals]

    is_tpu = bool(devices) and getattr(devices[0], "platform", "") == "tpu"
    keys = keys_by("slice_index") if is_tpu else None
    if keys is None:  # non-TPU, or a TPU runtime not reporting slices
        keys = keys_by("process_index", 0)
    groups: dict[int, list] = collections.defaultdict(list)
    for key, d in zip(keys, devices):
        groups[key].append(d)
    sizes = {len(v) for v in groups.values()}
    if len(sizes) != 1:
        raise ValueError(
            f"unequal slice sizes {sorted(len(v) for v in groups.values())}: "
            "cannot form a rectangular (dcn, ici) mesh"
        )
    ordered = [d for k in sorted(groups) for d in groups[k]]
    return len(groups), ordered


def _mesh2d(mesh: RankMesh, dcn: int) -> tuple[RankMesh, int, int]:
    """The mesh's ranks in group-contiguous order (``dcn == 0``: the
    groups :func:`detect_hierarchy` finds) and the ``(dcn, ici)`` split;
    the incoming rank order must follow group boundaries."""
    devs = list(mesh.devices)
    if dcn == 0:
        dcn, devs = detect_hierarchy(devs)
    if dcn < 1 or len(devs) % dcn:
        raise ValueError(
            f"dcn axis size {dcn} must divide device count {len(devs)}"
        )
    return RankMesh(tuple(devs)), dcn, len(devs) // dcn


def _wrapped_sum(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """Sum over the two leading axes in the integer ``dtype``'s width,
    wrapping as the ranks' adds wrap, as float64."""
    bits = torch.iinfo(dtype).bits
    s = x.astype(np.int64).sum(axis=(0, 1)) % (1 << bits)
    if torch.iinfo(dtype).min < 0:
        s = np.where(s >= 1 << (bits - 1), s - (1 << bits), s)
    return s.astype(np.float64)


def run_hierarchical(
    mesh: RankMesh,
    cfg: HierConfig | None = None,
    writer: ResultWriter | None = None,
) -> list[Record]:
    """Measure flat vs hierarchical cross-tier allreduce on the mesh's
    (dcn, ici) view; verify every rank's output against the
    host-computed elementwise sum."""
    cfg = cfg or HierConfig()
    writer = writer or ResultWriter()
    spec = get_dtype(cfg.dtype)

    m, dcn, ici = _mesh2d(mesh, cfg.dcn)
    p = dcn * ici
    if ici < 2:
        rec = Record(
            pattern="hierarchical", mode="hier", commands=f"{dcn}x{ici}",
            verdict=Verdict.SKIPPED,
            notes=[f"hierarchy needs ici >= 2, have {dcn}x{ici}"],
        )
        return [writer.record(rec)]

    # per-device length must tile the inner scatter
    n = max(ici, cfg.count - cfg.count % ici)
    n_bytes = n * spec.itemsize
    dev = m.devices[0]
    x_global = verify.fill_randomly(p * n, cfg.dtype, cfg.seed, dev)
    host = x_global.cpu().reshape(dcn, ici, n)
    integer = not spec.canonical.is_floating_point
    if integer:
        want = _wrapped_sum(host.numpy(), spec.canonical)
    else:
        want = host.to(torch.float64).sum(dim=(0, 1)).numpy()
    xs = m.scatter(x_global)
    del x_global
    for d in m.cards():
        timing.device_barrier(d)

    fns = {
        "flat": flat_allreduce,
        "hier": lambda b: hierarchical_allreduce(b, ici),
    }
    model = traffic_model(n_bytes, ici, dcn)
    records = []
    for name in VARIANTS:
        body = fns[name]

        # the chain feeds each allreduce's output to the next, in the
        # wire dtype; a float that grows by p a hop changes no timing
        def build_chain(k: int, body=body):
            def run():
                timing.unrolled_chain(body, xs, k)
                m.join()
            return run

        res = timing.measure_chain(build_chain, reps=cfg.reps,
                                   warmup=cfg.warmup, device=dev,
                                   ops_per_iter=timing.CHAIN_UNROLL)

        outs = [o.cpu().to(torch.float64).numpy() for o in body(xs)]
        # magnitude-scaled gate, the reference's
        tol = (
            0.0
            if integer
            else 64
            * float(torch.finfo(spec.canonical).eps)
            * max(1.0, np.abs(want).max())
        )
        data_ok = all(bool((np.abs(o - want) <= tol).all()) for o in outs)

        wire = model["flat_bytes_per_device"] if name == "flat" else (
            model["ici_bytes_per_device"] + model["dcn_bytes_per_device"]
        )
        gbps = wire / res.per_op_ns
        writer.metric(f"{name} allreduce", res.us() / 1e3, "ms")
        rec = Record(
            pattern="hierarchical",
            mode=name,
            commands=f"{dcn}x{ici}dev x {n_bytes // 1_000_000}MB",
            metrics={
                "time_us": res.us(),
                "timing_converged": float(res.converged),
                "wire_GBps_per_device": gbps,
                "checksum_ok": float(data_ok),
                **{k: float(v) for k, v in model.items()},
            },
            config={"device_kind": (torch.cuda.get_device_name(dev)
                                    if m.on_cuda else "cpu"),
                    "world": p},
            verdict=Verdict.SUCCESS if data_ok else Verdict.FAILURE,
        )
        if not data_ok:
            rec.notes.append("hierarchical allreduce result mismatch")
        if note := m.note("the collectives' steps"):
            rec.notes.append(note)
        if note := res.noise_note("GB/s"):
            rec.notes.append(note)
        records.append(writer.record(rec))
    return records
