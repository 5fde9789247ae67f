"""Interconnect-topology discovery: devices, coordinates, planes.

Counterpart of ``tpu_patterns/topo/topology.py``, the same code over
the same device attributes: :func:`discover` reads ``coords``,
``core_on_chip``, ``id``, ``process_index`` and ``platform`` through
``getattr``, so the tests feed both packages the same fake devices.  A
device without ``coords`` takes the reference's coordinate-less path:
synthetic ``(i,)`` coordinates, one chain.  ``planes()`` groups devices
that agree on every coordinate but one (a ring of a torus axis);
``flat()`` and ``entry(n)`` are the prober's two output modes.

``discover()`` with no devices lists this process's visible CUDA cards
(:func:`local_devices`).  A card has no torus coordinates, so it is a
coordinate-less device on platform ``gpu``, core 0, as the JAX package
reports a CUDA device.  ``impl="auto"`` runs the C++ core
(``topo/native.py``) and raises when it cannot be built, where the
reference falls back to Python; ``impl="python"`` forces Python.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Any, Sequence

import torch

from tpu_patterns_torch.runtime import resolve_device


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    """One addressable device."""

    index: int  # position in the discovered device list
    id: int
    process_index: int
    platform: str
    coords: tuple[int, ...]  # torus coordinates (synthetic linear if none)
    core_on_chip: int
    synthetic_coords: bool  # True when coords were invented

    @property
    def chip_key(self) -> tuple[int, ...]:
        """Identity of the physical chip (all cores of a chip share it)."""
        return self.coords


def _device_info(i: int, d: Any) -> DeviceInfo:
    coords = getattr(d, "coords", None)
    synthetic = coords is None
    if synthetic:
        coords = (i, )
    core = getattr(d, "core_on_chip", 0) or 0
    return DeviceInfo(
        index=i,
        id=getattr(d, "id", i),
        process_index=getattr(d, "process_index", 0),
        platform=getattr(d, "platform", "unknown"),
        coords=tuple(int(c) for c in coords),
        core_on_chip=int(core),
        synthetic_coords=synthetic,
    )


@dataclasses.dataclass
class Topology:
    """The discovered device fabric."""

    devices: list[DeviceInfo]

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    @property
    def torus_shape(self) -> tuple[int, ...]:
        """Bounding box of chip coordinates (per-axis extent)."""
        ndim = len(self.devices[0].coords)
        return tuple(
            len({d.coords[ax] for d in self.devices}) for ax in range(ndim)
        )

    @property
    def cores_per_chip(self) -> int:
        by_chip: dict[tuple[int, ...], int] = {}
        for d in self.devices:
            by_chip[d.chip_key] = by_chip.get(d.chip_key, 0) + 1
        return max(by_chip.values())

    @staticmethod
    def _native_result(impl: str, fn_name: str, *args):
        """One dispatch for every impl= method: validate, run the C++
        core unless impl="python" (None: the caller runs Python).  A core
        that cannot be built raises."""
        if impl not in ("auto", "native", "python"):
            raise ValueError(f"unknown impl {impl!r}; want auto|native|python")
        if impl == "python":
            return None
        from tpu_patterns_torch.topo import native as topo_native

        return getattr(topo_native, fn_name)(*args)

    def planes(self, impl: str = "auto") -> list[list[int]]:
        """Rings: for each torus axis with extent > 1, the groups of
        devices that agree on every *other* coordinate and the core, each
        sorted along the axis, as device ``index`` lists.

        ``impl``: "auto" and "native" run the C++ core, "python" this
        method's own loop; the tests require both to agree.
        """
        native = self._native_result(impl, "planes_native", self.devices)
        if native is not None:
            return native
        ndim = len(self.devices[0].coords)
        extents = self.torus_shape
        rings: list[list[int]] = []
        for ax in range(ndim):
            if extents[ax] <= 1 and ndim > 1:
                continue
            groups: dict[tuple, list[DeviceInfo]] = {}
            for d in self.devices:
                key = d.coords[:ax] + d.coords[ax + 1 :] + (d.core_on_chip,)
                groups.setdefault(key, []).append(d)
            for members in groups.values():
                if len(members) > 1 or self.num_devices == 1:
                    members.sort(key=lambda d: d.coords[ax])
                    rings.append([d.index for d in members])
        if not rings:  # single device, or degenerate: one plane of everything
            rings = [[d.index for d in self.devices]]
        return rings

    def flat(self) -> list[int]:
        """Canonical flattened device order: coords-major, then core."""
        return [
            d.index
            for d in sorted(self.devices, key=lambda d: (d.coords, d.core_on_chip))
        ]

    def entry(self, n: int) -> int:
        """N-th device in canonical order (wraps modulo)."""
        flat = self.flat()
        return flat[n % len(flat)]

    def neighbors(self, index: int, impl: str = "auto") -> list[int]:
        """Device indices one hop away (±1 along each axis, torus wrap).

        ``impl`` as in :meth:`planes`.
        """
        native = self._native_result(
            impl, "neighbors_native", self.devices, index
        )
        if native is not None:
            return native
        me = self.devices[index]
        extents = self.torus_shape
        out = []
        for other in self.devices:
            if other.index == index or other.core_on_chip != me.core_on_chip:
                continue
            diffs = [
                min(
                    abs(a - b),
                    extents[ax] - abs(a - b) if extents[ax] > 1 else abs(a - b),
                )
                for ax, (a, b) in enumerate(zip(me.coords, other.coords))
            ]
            if sum(diffs) == 1:
                out.append(other.index)
        return sorted(out)

    def describe(self) -> str:
        lines = [
            f"devices: {self.num_devices} ({self.devices[0].platform}), "
            f"torus {'x'.join(map(str, self.torus_shape))}, "
            f"{self.cores_per_chip} core(s)/chip"
            + (" [synthetic coords]" if self.devices[0].synthetic_coords else "")
        ]
        for i, ring in enumerate(self.planes()):
            lines.append(f"plane {i}: {ring}")
        return "\n".join(lines)


def _process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def local_devices(device: torch.device | str | None = None) -> list[Any]:
    """This process's devices of ``device``'s type (``cuda`` unless
    ``cpu`` is named), as objects with the attributes :func:`discover`
    reads: each visible CUDA card (platform ``gpu``, no coordinates), or
    the one CPU."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    platform = "gpu" if dev.type == "cuda" else "cpu"
    pid = _process_index()
    return [types.SimpleNamespace(id=i, process_index=pid, platform=platform)
            for i in range(n)]


def discover(devices: Sequence[Any] | None = None,
             device: torch.device | str | None = None) -> Topology:
    """Probe the fabric of ``devices``, by default :func:`local_devices`
    of ``device``."""
    if devices is None:
        devices = local_devices(device)
    return Topology(devices=[_device_info(i, d) for i, d in enumerate(devices)])
