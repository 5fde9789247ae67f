"""Rank→device placement: compact / spread / plan, as rank orderings.

Counterpart of ``tpu_patterns/topo/placement.py``: the same orderings
over a :class:`~tpu_patterns_torch.topo.topology.Topology`.  There
placement is the order in which devices enter a ``jax.sharding.Mesh``;
here it is the device each rank of a rank mesh
(``comm/mesh.py::RankMesh``) lives on.  The two mechanisms:
  * ``Mechanism.MESH``    — ranks take the mode's order of every device
    (≙ an affinity mask: every device visible, order decides adjacency);
  * ``Mechanism.VISIBLE`` — ranks take a subset, ``select_devices``
    (≙ a device selector).
Up to one rank a device both place as the reference's CLI does
(``tpu_patterns/cli.py::_build_mesh``).  With more ranks than devices,
which the reference refuses and the rank mesh allows, MESH deals the
ranks out in blocks over the mode's order (rank r on ``order[r*g//n]``
of g devices) and VISIBLE wraps modulo (``select_devices``).
"""

from __future__ import annotations

import enum

import torch

from tpu_patterns_torch.comm.mesh import RankMesh
from tpu_patterns_torch.runtime import resolve_device
from tpu_patterns_torch.topo.topology import Topology, discover


class PlacementMode(enum.Enum):
    COMPACT = "compact"  # fill cores of a chip first
    SPREAD = "spread"  # round-robin across chips
    PLAN = "compact_plan"  # topology-derived ring walk


class Mechanism(enum.Enum):
    MESH = "mesh"  # ordering mechanism (≙ an affinity mask)
    VISIBLE = "visible"  # subset mechanism (≙ a device selector)


def order_devices(
    topo: Topology | None = None,
    mode: PlacementMode = PlacementMode.COMPACT,
) -> list[int]:
    """Device-index ordering for a given placement mode.

    compact: chips in coordinate order, all cores of a chip adjacent.
    spread: core-major — consecutive ranks land on *different* chips.
    plan: walk the rings from the topology probe (planes) so that
    consecutive ranks are directly-wired neighbors.
    """
    topo = topo or discover()
    if mode is PlacementMode.COMPACT:
        return topo.flat()
    if mode is PlacementMode.SPREAD:
        return [
            d.index
            for d in sorted(topo.devices, key=lambda d: (d.core_on_chip, d.coords))
        ]
    # PLAN: concatenate the discovered rings, skipping repeats
    seen: set[int] = set()
    order: list[int] = []
    for ring in topo.planes():
        for idx in ring:
            if idx not in seen:
                seen.add(idx)
                order.append(idx)
    for d in topo.devices:  # devices on no ring (isolated)
        if d.index not in seen:
            order.append(d.index)
    return order


def select_devices(
    num: int,
    topo: Topology | None = None,
    mode: PlacementMode = PlacementMode.COMPACT,
) -> list[int]:
    """VISIBLE mechanism: the first ``num`` devices of the mode's
    ordering.  Oversubscription wraps modulo."""
    order = order_devices(topo, mode)
    return [order[i % len(order)] for i in range(num)]


def partition_devices(
    n_groups: int,
    topo: Topology | None = None,
    mode: PlacementMode = PlacementMode.COMPACT,
    devices_per_group: int | None = None,
) -> list[list[int]]:
    """DISJOINT device-index slices for ``n_groups`` independent
    replicas: the mode's ordering, cut into contiguous equal runs.
    Unlike :func:`select_devices`, groups never overlap."""
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    topo = topo or discover()
    order = order_devices(topo, mode)
    per = (
        devices_per_group
        if devices_per_group is not None
        else len(order) // n_groups
    )
    if per < 1:
        raise ValueError(
            f"{len(order)} devices cannot give {n_groups} groups at "
            "least one device each"
        )
    if n_groups * per > len(order):
        raise ValueError(
            f"{n_groups} groups x {per} devices = {n_groups * per} > "
            f"{len(order)} available — replica slices must be disjoint"
        )
    return [
        order[g * per : (g + 1) * per] for g in range(n_groups)
    ]


def rank_devices(
    n: int,
    topo: Topology,
    mode: PlacementMode | str = PlacementMode.COMPACT,
    mechanism: Mechanism | str = Mechanism.MESH,
) -> list[int]:
    """The device index of each of ``n`` ranks (module docstring)."""
    mode, mechanism = PlacementMode(mode), Mechanism(mechanism)
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    if mechanism is Mechanism.VISIBLE:
        return select_devices(n, topo, mode)
    order = order_devices(topo, mode)
    g = len(order)
    if n <= g:
        return order[:n]
    return [order[r * g // n] for r in range(n)]


def make_mesh(
    n: int = 0,
    mode: PlacementMode | str = PlacementMode.COMPACT,
    mechanism: Mechanism | str = Mechanism.MESH,
    device: torch.device | str | None = None,
) -> RankMesh:
    """A rank mesh of ``n`` ranks (0 = one a device) over the visible
    devices of ``device`` (``cuda`` unless ``cpu`` is named; on the CPU
    every rank is on the one CPU), placed by ``mode`` and
    ``mechanism``."""
    dev = resolve_device(device)
    topo = discover(device=dev)
    idx = rank_devices(n or topo.num_devices, topo, mode, mechanism)
    if dev.type == "cpu":
        return RankMesh(tuple(torch.device("cpu") for _ in idx))
    return RankMesh(tuple(torch.device("cuda", topo.devices[i].id)
                          for i in idx))
