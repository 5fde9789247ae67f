"""Ring collectives over a rank mesh: shift, naive ring allreduce,
bandwidth-optimal ring allreduce.

Counterpart of ``tpu_patterns/comm/ring.py``.  There each function runs
inside ``shard_map``, one program per device, and a shift is
``lax.ppermute``.  Here a function takes and returns a list of per-rank
tensors (``comm/mesh.py``), and a shift copies each rank's buffer into a
fresh buffer of its neighbour: a copy in device memory between ranks on
one card, a peer copy between cards.  The order of every add is the
reference's, so the results equal it bit for bit.

* :func:`ring_allreduce_naive`: accumulate, then (p-1) x {shift, add},
  each step moving the full buffer;
* :func:`ring_allreduce_optimal`: reduce-scatter then all-gather, each a
  (p-1)-step ring of 1/p chunks;
* :func:`library_allreduce`: the library contrast, one sum;
* :func:`library_all_gather`, :func:`library_reduce_scatter` and
  :func:`all_to_all`: the other library collectives (``lax.all_gather``,
  ``lax.psum_scatter`` and ``lax.all_to_all``, each tiled), which the
  parallelism patterns (``parallel/``) contrast with their rings.

``op(acc, buf)`` is the per-step accumulate, plain ``+`` by default; it
may also be a sequence of one op per rank (the miniapp's pallas variant
binds each rank's device into its K5 launches that way).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from tpu_patterns_torch.comm.mesh import fresh_like

Op = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def ring_perm(n: int, shift: int = 1) -> list[tuple[int, int]]:
    """source->dest pairs moving data ``shift`` steps around the ring."""
    return [(i, (i + shift) % n) for i in range(n)]


def ring_shift(xs: Sequence[torch.Tensor], shift: int = 1
               ) -> list[torch.Tensor]:
    """One ring step: rank i's buffer goes to rank (i + shift) % p, each
    destination a fresh buffer on the destination rank's device."""
    out: list[torch.Tensor | None] = [None] * len(xs)
    for src, dst in ring_perm(len(xs), shift):
        out[dst] = fresh_like(xs[dst]).copy_(xs[src])
    return out  # type: ignore[return-value]


def _ops(op: Op | Sequence[Op] | None, p: int) -> list[Op]:
    if op is None:
        return [lambda a, b: a + b] * p
    if callable(op):
        return [op] * p
    if len(op) != p:
        raise ValueError(f"{len(op)} ops for {p} ranks")
    return list(op)


def library_allreduce(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The library contrast (the reference's ``lax.psum``): one sum over
    the stacked shards on rank 0's device, in the shards' dtype, copied
    back to each rank.  Not a port of anything: its schedule and order
    of adds are torch's."""
    home = xs[0].device
    total = torch.stack([x.to(home) for x in xs]).sum(0, dtype=xs[0].dtype)
    return [fresh_like(x).copy_(total) for x in xs]


def _blocks(x: torch.Tensor, dim: int, n: int) -> list[torch.Tensor]:
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} not "
                         f"divisible by {n} ranks")
    return list(x.chunk(n, dim))


def library_all_gather(xs: Sequence[torch.Tensor], dim: int = 0
                       ) -> list[torch.Tensor]:
    """The tiled ``lax.all_gather``: every rank gets the shards
    concatenated along ``dim`` in rank order, a buffer of its own on its
    device."""
    home = xs[0].device
    full = torch.cat([x.to(home) for x in xs], dim)
    return [full.to(x.device, copy=True) for x in xs]


def library_reduce_scatter(xs: Sequence[torch.Tensor], dim: int = 0
                           ) -> list[torch.Tensor]:
    """The tiled ``lax.psum_scatter``: rank r gets the sum over ranks of
    block r of ``dim``, summed in the shards' dtype on rank 0's device
    (torch's order of adds, not a ring's)."""
    home = xs[0].device
    total = torch.stack([x.to(home) for x in xs]).sum(0, dtype=xs[0].dtype)
    return [b.to(x.device, copy=True)
            for b, x in zip(_blocks(total, dim, len(xs)), xs)]


def all_to_all(xs: Sequence[torch.Tensor], split: int, concat: int
               ) -> list[torch.Tensor]:
    """The tiled ``lax.all_to_all``: each rank's tensor is cut into p
    blocks along ``split``; rank r gets block r of every rank,
    concatenated along ``concat`` in rank order (a fresh contiguous
    tensor on rank r's device).  Autograd carries the gradient back the
    same way."""
    p = len(xs)
    parts = [_blocks(x, split, p) for x in xs]
    return [torch.cat([part[r].to(xs[r].device) for part in parts],
                      concat).contiguous()
            for r in range(p)]


def ring_allreduce_naive(xs: Sequence[torch.Tensor],
                         op: Op | Sequence[Op] | None = None
                         ) -> list[torch.Tensor]:
    """Reference-parity ring: accumulate, then (p-1) x {shift, op}.
    Rank r ends with ``((x_r + x_{r-1}) + x_{r-2}) + ...``."""
    p = len(xs)
    if p == 1:
        return list(xs)
    ops = _ops(op, p)
    acc, buf = list(xs), list(xs)
    for _ in range(p - 1):
        buf = ring_shift(buf)
        acc = [ops[r](acc[r], buf[r]) for r in range(p)]
    return acc


def ring_allreduce_optimal(xs: Sequence[torch.Tensor],
                           op: Op | Sequence[Op] | None = None
                           ) -> list[torch.Tensor]:
    """Bandwidth-optimal ring: reduce-scatter then all-gather, each a
    (p-1)-step chunk ring.  The per-rank length must divide by p.  Each
    rank works on its own copy of its shard (the inputs stay as they
    were, as JAX's arrays do), updated in place chunk by chunk."""
    p = len(xs)
    if p == 1:
        return list(xs)
    (n,) = xs[0].shape
    if n % p != 0:
        raise ValueError(f"per-device length {n} not divisible by ring "
                         f"size {p}")
    ops = _ops(op, p)
    csz = n // p
    flat = [fresh_like(x).copy_(x) for x in xs]

    def chunk(r: int, idx: int) -> torch.Tensor:
        return flat[r][idx * csz:(idx + 1) * csz]

    # step 0 sends chunk r; each later step forwards what just arrived,
    # which is exactly chunk (r - t) % p
    send = [chunk(r, r) for r in range(p)]
    for t in range(p - 1):
        recv = ring_shift(send)
        send = []
        for r in range(p):
            dst = chunk(r, (r - t - 1) % p)
            new_val = ops[r](dst, recv[r])
            dst.copy_(new_val)
            send.append(new_val)
    # rank r now owns the fully reduced chunk (r + 1) % p
    send = [chunk(r, (r + 1) % p) for r in range(p)]
    for t in range(p - 1):
        recv = ring_shift(send)
        for r in range(p):
            chunk(r, (r - t) % p).copy_(recv[r])
        send = recv
    return flat


# (variant, ranks, elements) of every schedule dispatched in this process
_TRACED: set[tuple[str, int, int]] = set()


def allreduce(xs: Sequence[torch.Tensor], variant: str,
              op: Op | Sequence[Op] | None = None) -> list[torch.Tensor]:
    """Dispatch over the miniapp's algorithms.  ``op`` customizes the
    manual rings' accumulate; the library path ignores it."""
    from tpu_patterns_torch import obs

    # one flight-recorder event a schedule: which variant ran over which
    # ring size, booked at its first dispatch (the JAX package books it
    # once a traced program; the port's ranks run eagerly, and an event
    # a call would sit inside the timed reps)
    key = (variant, len(xs), int(xs[0].numel()) if xs else 0)
    if key not in _TRACED:
        _TRACED.add(key)
        obs.event("ring.allreduce.trace", variant=variant, axis="ranks",
                  axis_size=key[1], elements=key[2])
    if variant == "psum":
        return library_allreduce(xs)
    if variant == "ring":
        return ring_allreduce_naive(xs, op)
    if variant == "ring_opt":
        return ring_allreduce_optimal(xs, op)
    raise ValueError(f"unknown allreduce variant {variant!r}")
