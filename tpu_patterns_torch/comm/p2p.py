"""Point-to-point pair-exchange bandwidth pattern (the two-sided transport).

Counterpart of ``tpu_patterns/comm/p2p.py``.  There a pair exchange is
one ``lax.ppermute`` under ``shard_map``: every even mesh position sends
its shard to its odd neighbour (uni), and the bidirectional pass is one
ppermute with both directions.  Here it is :func:`pair_exchange` over a
rank mesh (``comm/mesh.py``) with ppermute's semantics: for each (s, d)
rank d gets a copy of shard s in a buffer of its own (``Tensor.copy_``,
a peer copy between cards), and a rank that receives nothing holds
zeros.  That zero fill is part of the exchange, so it lies inside the
timed window; the Record says so.  Timing is the ring put's: a chain of
``CHAIN_UNROLL`` dependent exchanges, CUDA events on rank 0's stream
with every card joined back to it.  Verification is the reference's
per-shard checksum: receiver d must sum to ``sum(src[s])`` over its
senders, a non-receiver to 0.

No link spec is known for a card, so the Record has no ``ici_plausible``
key, as the reference's has none on a chip without one.  Ranks sharing a
card (``RankMesh.note``) exchange through its memory, one after another.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from tpu_patterns_torch.comm import verify
from tpu_patterns_torch.comm.dtypes import get_dtype
from tpu_patterns_torch.comm.mesh import RankMesh, fresh_like
from tpu_patterns_torch.core import timing
from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict


@dataclasses.dataclass
class P2PConfig:
    # the reference workload: 1179648*40 floats ≈ 188.74 MB per pair
    count: int = 1179648 * 40
    dtype: str = "float32"
    reps: int = 10  # min over reps
    warmup: int = 2
    min_bandwidth: float = -1.0  # GB/s floor; <0 disables
    bidirectional: bool = True  # run the second, bidirectional pass
    seed: int = 0


def pair_permutation(n: int, bidirectional: bool = False) -> list[tuple[int, int]]:
    """Even->odd neighbour pairs; the bidirectional pass adds the
    reverse direction."""
    pairs = [(i, i + 1) for i in range(0, n - 1, 2)]
    if bidirectional:
        pairs += [(d, s) for (s, d) in pairs]
    return pairs


def stream_permutation(n: int) -> list[tuple[int, int]]:
    """The bidirectional even/odd pairing over ``n`` ranks (an
    involution), or the identity on odd or single worlds."""
    if n >= 2 and n % 2 == 0:
        return pair_permutation(n, bidirectional=True)
    return [(i, i) for i in range(n)]


def pair_exchange(shards: Sequence[torch.Tensor],
                  perm: Sequence[tuple[int, int]]) -> list[torch.Tensor]:
    """ppermute over a rank list: ``out[d]`` is a fresh buffer on rank
    d's device holding ``shards[s]`` for each (s, d) of ``perm``; a rank
    that is no destination gets zeros."""
    out: list[torch.Tensor | None] = [None] * len(shards)
    for s, d in perm:
        out[d] = fresh_like(shards[d]).copy_(shards[s])
    return [torch.zeros_like(x) if o is None else o
            for x, o in zip(shards, out)]


def make_block_stream(mesh, axis: str = "sp"):
    """The prefill->decode KV-block transfer core: a function that takes a
    payload ``{leaf: [tensor of each rank]}`` over ``mesh`` (a
    ``NamedMesh``) and pair-exchanges every leaf within each ``axis``
    group and back (:func:`stream_permutation`, an involution), so the
    bytes cross between the ranks' buffers and land bit-identical to the
    input.  The payload is consumed: its dict is emptied, so the staging
    copy dies once shipped (the reference donates it).  Pure data
    movement: no compute, no reduction."""
    groups = (mesh.groups(axis) if axis in mesh.axes
              else [[r] for r in range(mesh.size)])
    perm = stream_permutation(len(groups[0]))

    def hop(leaves: list) -> list:
        out = list(leaves)
        for g in groups:
            for r, t in zip(g, pair_exchange([leaves[r] for r in g], perm)):
                out[r] = t
        return out

    def stream(vals: dict) -> dict:
        there = {k: hop(v) for k, v in vals.items()}
        vals.clear()
        return {k: hop(v) for k, v in there.items()}

    return stream


def shard_checksums(shards: Sequence[torch.Tensor]) -> list[int]:
    """Each shard's values summed as integers and wrapped to 32 bits:
    the reference's per-shard ``checksum_device``."""
    return [verify._wrap32(int(verify.checksum_device(s))) for s in shards]


def run_p2p(
    mesh: RankMesh,
    cfg: P2PConfig | None = None,
    writer: ResultWriter | None = None,
) -> list[Record]:
    """Run the uni- (and optionally bi-) directional pair exchange; one
    Record per direction with bandwidth in GB/s (bytes/ns)."""
    cfg = cfg or P2PConfig()
    writer = writer or ResultWriter()
    n_dev = mesh.size
    if n_dev < 2 or n_dev % 2:
        raise ValueError(
            f"p2p needs an even number of devices >= 2, got {n_dev} "
            "(the reference likewise pairs even/odd ranks)"
        )

    spec = get_dtype(cfg.dtype)
    shard_bytes = cfg.count * spec.itemsize
    dev = mesh.devices[0]
    writer.progress(
        f"p2p: {n_dev} devices, {shard_bytes / 1e6:.2f} MB/pair, "
        f"dtype={cfg.dtype}, reps={cfg.reps}"
    )
    shards = mesh.scatter(
        verify.fill_randomly(cfg.count * n_dev, cfg.dtype, cfg.seed, dev))
    for d in mesh.cards():
        timing.device_barrier(d)
    src_sums = shard_checksums(shards)

    records = []
    passes = [("unidirectional", False)]
    if cfg.bidirectional:
        passes.append(("bidirectional", True))
    for name, bidir in passes:
        perm = pair_permutation(n_dev, bidir)

        def build_chain(k: int, perm=perm):
            def run():
                timing.unrolled_chain(lambda a: pair_exchange(a, perm),
                                      shards, k)
                mesh.join()
            return run

        res = timing.measure_chain(build_chain, reps=cfg.reps,
                                   warmup=cfg.warmup, device=dev,
                                   ops_per_iter=timing.CHAIN_UNROLL)
        num_pairs = len(perm)  # transfers in flight (bi counts both)
        gbps = res.gbps(shard_bytes * num_pairs)
        per_pair = gbps / max(1, num_pairs)
        out_sums = shard_checksums(pair_exchange(shards, perm))
        expect = [0] * n_dev
        for s, d in perm:
            expect[d] = verify._wrap32(expect[d] + src_sums[s])
        data_ok = out_sums == expect
        bw_ok = cfg.min_bandwidth < 0 or gbps >= cfg.min_bandwidth
        writer.metric(f"{name.capitalize()} Bandwidth", gbps, "GB/s")
        rec = Record(
            pattern="p2p",
            mode=name,
            commands=f"{n_dev}dev x {shard_bytes // 1_000_000}MB",
            metrics={
                "bandwidth_GBps": gbps,
                "bandwidth_GBps_per_pair": per_pair,
                "min_time_us": res.us(),
                "bytes_per_pair": float(shard_bytes),
                "num_transfers": float(num_pairs),
                "checksum_ok": float(data_ok),
                "timing_converged": float(res.converged),
            },
            config={"device_kind": (torch.cuda.get_device_name(dev)
                                    if mesh.on_cuda else "cpu"),
                    "world": n_dev},
            verdict=Verdict.SUCCESS if data_ok and bw_ok else Verdict.FAILURE,
        )
        if not data_ok:
            rec.notes.append("checksum mismatch after exchange")
        if not bw_ok:
            rec.notes.append(
                f"bandwidth {gbps:.2f} GB/s below floor {cfg.min_bandwidth}"
            )
        idle = n_dev - len({d for _, d in perm})
        if idle:
            rec.notes.append(
                f"the zero fill of the {idle} rank(s) that receive nothing "
                "is inside the timed window (ppermute's semantics)")
        if note := mesh.note("the exchanges"):
            rec.notes.append(note)
        if note := res.noise_note():
            rec.notes.append(note)
        records.append(writer.record(rec))
    return records
