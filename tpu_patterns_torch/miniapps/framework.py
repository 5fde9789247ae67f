"""Miniapp discovery and typed runs (the reference's CMake/CTest
framework, as ``tpu_patterns/miniapps/framework.py`` has it).

* apps live as modules ``tpu_patterns_torch/miniapps/apps/<app>/<variant>.py``,
  each exporting a ``VARIANT: VariantSpec``; discovery walks the package;
* the dtype matrix is ``VariantSpec.dtypes``, expanded by
  :func:`typed_runs`;
* ``mpirun -np 4`` becomes a rank mesh of 4 ranks (:func:`default_mesh`),
  placed over the visible cards, several to a card when there are fewer
  cards than ranks (``comm/mesh.py``);
* CTest's exit-code aggregation is :func:`run_all` + ``ResultWriter.exit_code``.
"""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil
from typing import Any, Callable, Iterator

import torch

from tpu_patterns_torch.comm import mesh as rank_mesh
from tpu_patterns_torch.core.results import Record, ResultWriter

DEFAULT_NP = 4  # ≙ mpirun -np 4


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """One ``<app>/<variant>`` build (≙ one CMake target)."""

    app: str
    variant: str
    dtypes: tuple[str, ...]  # ≙ add_typed_mpi_app instantiations
    run: Callable[..., Record]  # run(mesh, dtype=..., writer=..., **cfg)
    # Config axes this variant supports beyond dtype (e.g. algorithms);
    # sweeps and tests enumerate the full matrix from them.
    axes: dict[str, tuple[Any, ...]] = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        return f"{self.app}/{self.variant}"


def discover() -> list[VariantSpec]:
    """Walk ``miniapps/apps`` for modules exporting ``VARIANT``."""
    from tpu_patterns_torch.miniapps import apps as apps_pkg

    specs: list[VariantSpec] = []
    for info in pkgutil.walk_packages(apps_pkg.__path__,
                                      apps_pkg.__name__ + "."):
        mod = importlib.import_module(info.name)
        spec = getattr(mod, "VARIANT", None)
        if isinstance(spec, VariantSpec):
            specs.append(spec)
    return sorted(specs, key=lambda s: (s.app, s.variant))


def get_variant(app: str, variant: str) -> VariantSpec:
    for spec in discover():
        if spec.app == app and spec.variant == variant:
            return spec
    known = ", ".join(s.name for s in discover())
    raise KeyError(f"no miniapp variant {app}/{variant}; available: {known}")


def typed_runs() -> Iterator[tuple[VariantSpec, str]]:
    """(variant, dtype) pairs: the ``add_typed_mpi_app float/int`` matrix."""
    for spec in discover():
        for dt in spec.dtypes:
            yield spec, dt


def default_mesh(n_devices: int = DEFAULT_NP,
                 device: torch.device | str | None = None
                 ) -> rank_mesh.RankMesh:
    """``n_devices`` ranks (≙ the 4 mpirun ranks) over the visible cards
    of ``device`` (``cuda`` unless ``cpu`` is named)."""
    return rank_mesh.default_mesh(n_devices, device)


def run_all(
    writer: ResultWriter | None = None,
    n_devices: int = DEFAULT_NP,
    mesh: rank_mesh.RankMesh | None = None,
    device: torch.device | str | None = None,
    **overrides,
) -> list[Record]:
    """Run every typed variant once with defaults: the ``ctest`` sweep.

    The aggregated pass/fail is ``writer.exit_code``.  (The reference
    wraps each run in an ``obs`` span and counts it; both wait for the
    port of ``obs/``.)"""
    writer = writer or ResultWriter()
    mesh = mesh if mesh is not None else default_mesh(n_devices, device)
    records = []
    for spec, dtype in typed_runs():
        writer.progress(f"miniapp {spec.name}.{dtype}")
        records.append(
            spec.run(mesh=mesh, dtype=dtype, writer=writer, **overrides)
        )
    return records
