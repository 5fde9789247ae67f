"""A rank mesh: p ranks in one process, each with its own buffers.

Stands in for the JAX package's 1-D ``jax.sharding.Mesh`` plus
``shard_map``: there each device runs one shard of one program; here a
rank is a ``torch.device`` and a list of per-rank tensors is the sharded
array (rank r's tensor is shard r).  Ring code (``comm/ring.py``,
``comm/onesided.py::ring_put``) takes and returns such lists.

One deliberate difference from the reference: its ``default_mesh``
(``miniapps/framework.py``) and ``_build_mesh`` (``cli.py``) raise when
asked for more ranks than devices.  Here ranks are placed over the
visible cards (``topo/placement.py``), several to a card where there are
more ranks than cards, as an MPI launch places several ranks on one
GPU.  Ranks that share a card run their work one after another on its
current stream, and a ring step between them is a copy in that card's
memory, not a transfer over a fabric; :meth:`RankMesh.note` says so in
each Record.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from tpu_patterns_torch.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """``devices[r]`` is rank r's device (a CUDA device always with its
    index)."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a rank mesh needs at least one rank")
        devs = tuple(_indexed(resolve_device(d)) for d in self.devices)
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"ranks on cpu and cuda together: {devs}")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def on_cuda(self) -> bool:
        return self.devices[0].type == "cuda"

    def cards(self) -> list[torch.device]:
        """The distinct devices, in rank order."""
        return list(dict.fromkeys(self.devices))

    def note(self, what: str = "ring shifts", memory: str | None = None
             ) -> str | None:
        """What a Record says about shared devices (None when every rank
        has a card of its own): ``what`` moves between ranks as copies in
        ``memory`` (default: the ranks' device memory, or host memory on
        the CPU)."""
        cards = self.cards()
        if len(cards) == self.size:
            return None
        where = (f"{len(cards)} GPU" + ("s" if len(cards) > 1 else "")
                 if self.on_cuda else "the CPU")
        if memory is None:
            memory = "device-memory" if self.on_cuda else "host-memory"
        return (f"{self.size} ranks on {where}: {what} are {memory} "
                "copies, not a fabric")

    def scatter(self, global_, kind: str = "D",
                dtype: torch.dtype | None = None) -> list[torch.Tensor]:
        """Split ``global_`` (numpy or torch, leading axis divisible by
        the rank count) into per-rank shards, rank r getting rows
        ``[r*rows, (r+1)*rows)`` as a ``NamedSharding`` over the mesh
        axis gives them, each a new buffer on its rank in memory ``kind`` (D
        device, H pinned host, S managed; on the CPU a plain tensor),
        converted to ``dtype`` when given."""
        from tpu_patterns_torch.concurrency.commands import MemKind, empty_in

        src = (torch.from_numpy(np.ascontiguousarray(global_))
               if isinstance(global_, np.ndarray) else global_)
        n = src.shape[0]
        if n % self.size:
            raise ValueError(f"leading axis {n} not divisible by "
                             f"{self.size} ranks")
        rows = n // self.size
        shards = []
        for r, dev in enumerate(self.devices):
            part = src[r * rows:(r + 1) * rows]
            t = empty_in(MemKind[kind], part.shape, dev,
                         dtype or part.dtype)
            t.copy_(part)
            shards.append(t)
        return shards

    def gather(self, shards: list[torch.Tensor]) -> torch.Tensor:
        """The shards concatenated in rank order, on the CPU."""
        if len(shards) != self.size:
            raise ValueError(f"{len(shards)} shards for {self.size} ranks")
        return torch.cat([s.cpu() for s in shards])

    def join(self) -> None:
        """Make rank 0's current stream wait for the work queued so far
        on every other card's, so that CUDA events on rank 0's stream
        time the whole mesh (``timing.measure_chain``'s rule)."""
        if not self.on_cuda:
            return
        first, *others = self.cards()
        for dev in others:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            torch.cuda.current_stream(first).wait_event(ev)

    @contextlib.contextmanager
    def allocating_in(self, kind: str):
        """Inside, the caching allocator of every card of the mesh hands
        out managed memory when ``kind`` is S (so the buffers a ring
        makes stay in the kind its inputs were given in); for other
        kinds, and on the CPU, nothing changes."""
        with contextlib.ExitStack() as stack:
            if kind == "S" and self.on_cuda:
                from tpu_patterns_torch.concurrency.commands import (
                    _managed_pool,
                )

                pool = _managed_pool()
                for dev in self.cards():
                    stack.enter_context(torch.cuda.use_mem_pool(pool, dev))
            yield


def default_mesh(n: int = 0, device: torch.device | str | None = None
                 ) -> RankMesh:
    """``n`` ranks placed compactly over the visible cards
    (``topo/placement.py::make_mesh`` at compact/mesh): the first n cards
    up to one rank a card, else rank r on card ``r * g // n`` of g;
    ``n = 0`` means one rank per card.  On ``device="cpu"`` every rank
    is on the CPU (``n = 0``: one rank)."""
    from tpu_patterns_torch.topo.placement import make_mesh

    return make_mesh(n, device=device)


def fresh_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialized buffer shaped like ``t`` on ``t``'s device,
    pinned when ``t`` is a pinned host tensor, so that a ring step keeps
    its buffers in the memory kind they were given in.  Contiguous
    either way; ``empty_like`` is the cheaper call on the host (a ring
    step makes one per rank)."""
    if t.device.type == "cpu" and t.is_pinned():
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return torch.empty_like(t, memory_format=torch.contiguous_format)


def _indexed(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
