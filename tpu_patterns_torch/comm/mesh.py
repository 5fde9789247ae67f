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
import functools

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


@dataclasses.dataclass(frozen=True)
class NamedMesh:
    """Named axes over the ranks of a :class:`RankMesh`: the counterpart
    of a ``jax.sharding.Mesh`` of ``np.array(devices).reshape(*shape)``
    with ``axes`` as its axis names.  Rank r sits at the row-major
    coordinate of r in ``shape`` (the last axis varies fastest), so a
    per-rank list over ``ranks`` is a sharded array over this mesh."""

    ranks: RankMesh
    axes: tuple[str, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} for shape {self.shape}")
        if len(set(self.axes)) != len(self.axes):
            raise ValueError(f"repeated axis name in {self.axes}")
        if int(np.prod(self.shape)) != self.ranks.size:
            raise ValueError(f"mesh shape {self.shape} for "
                             f"{self.ranks.size} ranks")

    @property
    def size(self) -> int:
        return self.ranks.size

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return self.ranks.devices

    @property
    def on_cuda(self) -> bool:
        return self.ranks.on_cuda

    def dim(self, axis: str) -> int:
        """The size of ``axis``; 1 for an axis the mesh does not have."""
        return (self.shape[self.axes.index(axis)] if axis in self.axes
                else 1)

    def coord(self, r: int) -> dict[str, int]:
        """Rank r's coordinate, axis by axis."""
        return dict(zip(self.axes, _coord(self.shape, r)))

    def rank(self, **coord: int) -> int:
        """The rank at ``coord`` (every axis named)."""
        return int(np.ravel_multi_index(
            tuple(coord[a] for a in self.axes), self.shape))

    def group(self, axes: str | tuple[str, ...], r: int) -> list[int]:
        """The ranks that share rank r's coordinate on every axis but
        ``axes``, in row-major order over ``axes``: "the sp group of
        (d, t)" is ``group("sp", rank(dp=d, sp=0, tp=t))``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        grid = np.arange(self.size).reshape(self.shape)
        at = self.coord(r)
        index = tuple(slice(None) if a in axes else at[a]
                      for a in self.axes)
        return [int(i) for i in grid[index].reshape(-1)]

    def groups(self, axes: str | tuple[str, ...]) -> list[list[int]]:
        """Every group along ``axes`` (:meth:`group`), each once, in the
        order of their first ranks; together they cover the mesh."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return [list(g) for g in _groups(self.axes, self.shape, axes)]

    def sub(self, axis: str, index: int) -> tuple["NamedMesh", list[int]]:
        """The mesh of the ranks at coordinate ``index`` of ``axis``, over
        the other axes, and those ranks in this mesh's numbering (rank i
        of the sub-mesh is rank ``ranks[i]`` here)."""
        ranks = self.group(tuple(a for a in self.axes if a != axis),
                           self.rank(**{a: index if a == axis else 0
                                        for a in self.axes}))
        keep = [i for i, a in enumerate(self.axes) if a != axis]
        return (NamedMesh(RankMesh(tuple(self.devices[r] for r in ranks)),
                          tuple(self.axes[i] for i in keep),
                          tuple(self.shape[i] for i in keep)), ranks)

    def index(self, shape, spec, r: int) -> list[list[int]]:
        """Rank r's block of a global ``shape`` split per ``spec`` (one
        axis name or None a dimension, as a ``PartitionSpec`` with single
        names; missing trailing entries are None): ``[start, stop]`` a
        dimension."""
        at = self.coord(r)
        out = []
        for i, n in enumerate(shape):
            ax = spec[i] if i < len(spec) else None
            if ax is None:
                out.append([0, int(n)])
                continue
            k = self.dim(ax)
            if n % k:
                raise ValueError(f"dimension {i} of {tuple(shape)} not "
                                 f"divisible by {ax}={k}")
            step = n // k
            out.append([at.get(ax, 0) * step, (at.get(ax, 0) + 1) * step])
        return out

    def replica(self, spec, r: int) -> int:
        """0 when rank r holds the first copy of its block (its
        coordinate is 0 on every axis ``spec`` does not name), else 1:
        the one copy a checkpoint writes."""
        named = {a for a in spec if a is not None}
        at = self.coord(r)
        return int(any(at[a] for a in self.axes if a not in named))

    def shard(self, a: torch.Tensor, spec) -> list[torch.Tensor]:
        """``a`` split per ``spec``: rank r's block, a contiguous copy on
        rank r's device."""
        out = []
        for r, dev in enumerate(self.devices):
            idx = tuple(slice(s, e) for s, e in self.index(a.shape, spec, r))
            out.append(a[idx].to(device=dev, copy=True,
                                 memory_format=torch.contiguous_format))
        return out

    def assemble(self, shards, spec) -> torch.Tensor:
        """The global array of per-rank blocks split per ``spec`` (each
        block's replica 0), on the first rank's device."""
        first = shards[0]
        shape = [n * (self.dim(spec[i]) if i < len(spec) and spec[i]
                      else 1) for i, n in enumerate(first.shape)]
        out = first.new_empty(shape)
        for r, s in enumerate(shards):
            if self.replica(spec, r) == 0:
                idx = tuple(slice(a, b)
                            for a, b in self.index(shape, spec, r))
                out[idx] = s.to(first.device)
        return out

    def note(self, what: str = "ring shifts", memory: str | None = None
             ) -> str | None:
        return self.ranks.note(what, memory)

    def describe(self) -> str:
        return " ".join(f"{a}{n}" for a, n in zip(self.axes, self.shape))


@functools.lru_cache(maxsize=None)
def _coord(shape: tuple[int, ...], r: int) -> tuple[int, ...]:
    return tuple(int(i) for i in np.unravel_index(r, shape))


@functools.lru_cache(maxsize=None)
def _groups(names: tuple[str, ...], shape: tuple[int, ...],
            axes: tuple[str, ...]) -> tuple[tuple[int, ...], ...]:
    """:meth:`NamedMesh.groups` of a mesh's axis names and shape (the
    decode and train steps ask for the same groups every layer)."""
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    over = sorted(names.index(a) for a in set(axes) if a in names)
    moved = np.moveaxis(grid, over, range(len(names) - len(over),
                                          len(names)))
    rows = moved.reshape(-1, int(np.prod([shape[i] for i in over])))
    return tuple(sorted((tuple(int(i) for i in g) for g in rows),
                        key=lambda g: g[0]))


def model_mesh(n: int, dp: int = 1, tp: int = 1, pp: int = 0,
               device: torch.device | str | None = None) -> NamedMesh:
    """The model commands' ``("dp", "sp", "tp")`` mesh (``pp > 0`` adds
    a fourth axis, ``"pp"``) over ``n`` ranks placed by
    :func:`default_mesh` (``n = 0``: one rank a card): dp, tp and pp as
    given, sp the rest.  Raises when dp·tp(·pp) does not divide n."""
    ranks = default_mesh(n, device)
    fixed = dp * tp * max(pp, 1)
    if ranks.size % fixed:
        raise ValueError(f"devices {ranks.size} not divisible by "
                         f"dp*tp{'*pp' if pp else ''} = {fixed}")
    sp = ranks.size // fixed
    if pp:
        return NamedMesh(ranks, ("dp", "sp", "tp", "pp"), (dp, sp, tp, pp))
    return NamedMesh(ranks, ("dp", "sp", "tp"), (dp, sp, tp))


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
