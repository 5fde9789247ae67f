"""Config dtype name -> torch dtype, wire itemsize and exact modulus.

Counterpart of ``tpu_patterns/comm/dtypes.py``.  The JAX package runs
with 64-bit types off, so there ``float64``, ``int64`` and ``uint64``
materialize as their 32-bit forms; this table gives those forms too, so
every name has the reference's itemsize (what reaches the wire, and so
what a GB/s counts) and exact modulus (the largest M with every integer
in [0, M) exactly representable, capped at 2^31 - 1 because the fill
and checksum index and sum in 32 bits).
"""

from __future__ import annotations

import dataclasses

import torch

INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class DTypeSpec:
    name: str
    canonical: torch.dtype  # what materializes
    itemsize: int  # of the canonical dtype
    exact_modulus: int


def _spec(name: str, dt: torch.dtype, exact_modulus: int | None = None
          ) -> DTypeSpec:
    if exact_modulus is None:
        if dt.is_floating_point:
            # every integer in [0, 2^(mantissa bits + 1)] is exact, and
            # eps is 2^-(mantissa bits)
            exact_modulus = round(2 / torch.finfo(dt).eps)
        else:
            exact_modulus = int(torch.iinfo(dt).max)
    return DTypeSpec(name=name, canonical=dt, itemsize=dt.itemsize,
                     exact_modulus=min(exact_modulus, INT32_MAX))


DTYPES: dict[str, DTypeSpec] = {
    s.name: s
    for s in [
        _spec("float32", torch.float32),
        _spec("float64", torch.float32),  # 64-bit off in the reference
        _spec("int32", torch.int32),
        _spec("uint32", torch.uint32),
        _spec("int64", torch.int32),
        _spec("uint64", torch.uint32),
        _spec("int16", torch.int16),
        _spec("int8", torch.int8),
        _spec("uint8", torch.uint8),
        _spec("bool", torch.bool, exact_modulus=2),
        _spec("bfloat16", torch.bfloat16),
        _spec("float16", torch.float16),
        _spec("byte", torch.uint8),
    ]
}


def get_dtype(name: str) -> DTypeSpec:
    """The spec for ``name``; KeyError lists the known names."""
    try:
        return DTYPES[name]
    except KeyError:
        raise KeyError(
            f"unknown dtype {name!r}; known: {', '.join(sorted(DTYPES))}"
        ) from None


def dtype_name(dt: torch.dtype) -> str:
    """The config name of a torch dtype (``torch.float32`` -> ``float32``)."""
    return str(dt).removeprefix("torch.")
