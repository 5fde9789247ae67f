"""ctypes binding for the native topology core (``csrc/topo.cc``).

Counterpart of ``tpu_patterns/topo/native.py``.  The source is the
port's own copy of the reference's, built with g++ at first use through
``interop/native.py``'s :class:`LazyLib` into ``build/torch_native/``.
Where the reference's loader returns None and its ``Topology`` falls back
to Python, a failed build here raises (and every later call raises it
again): ``Topology``'s ``impl="auto"`` never switches to Python quietly.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from tpu_patterns_torch.interop.native import LazyLib

SOURCE = Path(__file__).resolve().parent / "csrc" / "topo.cc"


def _configure(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.tp_topo_planes.restype = ctypes.c_int32
    lib.tp_topo_planes.argtypes = [
        i32p, i32p, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.tp_topo_neighbors.restype = ctypes.c_int32
    lib.tp_topo_neighbors.argtypes = [
        i32p, i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, ctypes.c_int32,
    ]


TOPO = LazyLib(SOURCE, _configure)


def load() -> ctypes.CDLL:
    """The topology core, built first if needed; raises when it cannot
    be built."""
    return TOPO.load()


def _pack(devices) -> tuple:
    n = len(devices)
    ndim = len(devices[0].coords)
    coords = (ctypes.c_int32 * (n * ndim))()
    cores = (ctypes.c_int32 * n)()
    for i, d in enumerate(devices):
        cores[i] = d.core_on_chip
        for ax, c in enumerate(d.coords):
            coords[i * ndim + ax] = c
    return coords, cores, n, ndim


def planes_native(devices) -> list[list[int]]:
    """Rings via the C++ core, as ``DeviceInfo.index`` lists.  Raises on
    a core-reported error (bad arguments, overflow)."""
    lib = load()
    coords, cores, n, ndim = _pack(devices)
    cap_members = n * (ndim + 1)
    cap_rings = n * ndim + 1
    members = (ctypes.c_int32 * cap_members)()
    offsets = (ctypes.c_int32 * (cap_rings + 1))()
    rc = lib.tp_topo_planes(
        coords, cores, n, ndim, members, offsets, cap_members, cap_rings
    )
    if rc < 0:
        raise RuntimeError(
            f"tp_topo_planes failed (rc={rc}) for n={n}, ndim={ndim}"
        )
    # the core speaks list positions; the Python path returns
    # DeviceInfo.index, so map them (a hand-built Topology's index may
    # differ from its position)
    return [
        [devices[members[i]].index for i in range(offsets[r], offsets[r + 1])]
        for r in range(rc)
    ]


def neighbors_native(devices, index: int) -> list[int]:
    """One-hop adjacency via the C++ core.  ``index`` is a list position,
    as the Python path's ``self.devices[index]``; the output maps back
    to ``DeviceInfo.index``."""
    lib = load()
    coords, cores, n, ndim = _pack(devices)
    out = (ctypes.c_int32 * n)()
    rc = lib.tp_topo_neighbors(coords, cores, n, ndim, index, out, n)
    if rc < 0:
        raise RuntimeError(
            f"tp_topo_neighbors failed (rc={rc}) for n={n}, index={index}"
        )
    return sorted(devices[out[i]].index for i in range(rc))
