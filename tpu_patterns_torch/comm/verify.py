"""Data-integrity verifier: shuffled-iota fill and exact wrapped checksum.

Counterpart of ``tpu_patterns/comm/verify.py``.  The fill is a
permutation of iota(n) reduced mod the dtype's exact modulus, made on
the device from ``torch.randperm`` with a generator seeded by ``seed``;
it is not JAX's permutation, but the multiset of values, and so the
checksum, is the same for any permutation.  The checksum is the sum of
the values as integers, wrapped to 32 bits as the reference's int32 sum
wraps, and compared with the exact sum computed in Python.
"""

from __future__ import annotations

import torch

from tpu_patterns_torch.comm.dtypes import dtype_name, get_dtype


def fill_randomly(n: int, dtype: str = "float32", seed: int = 0,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """Shuffled iota(n) mod the dtype's exact modulus, made on
    ``device``."""
    spec = get_dtype(dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    perm = torch.randperm(n, generator=gen, device=device)
    return (perm % spec.exact_modulus).to(spec.canonical)


def expected_checksum(n: int, dtype: str = "float32") -> int:
    """The wrapped sum of ``fill_randomly(n, dtype)`` for any seed: each
    v in [0, M) appears ``n // M`` times, once more if ``v < n % M``.
    Exact Python ints, wrapped to int32 range."""
    m = get_dtype(dtype).exact_modulus
    full, part = divmod(n, m)
    total = full * (m * (m - 1) // 2) + part * (part - 1) // 2
    return _wrap32(total)


def checksum_device(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x``'s values as integers, where the data lives.
    ``torch.sum`` of integers gives int64; :func:`checksum_ok` wraps it
    to 32 bits."""
    return torch.sum(x.to(torch.int64))


def checksum_ok(x: torch.Tensor, n: int | None = None,
                dtype: str | None = None) -> bool:
    """Whether ``x`` holds the multiset :func:`fill_randomly` made."""
    n = n if n is not None else x.numel()
    dtype = dtype if dtype is not None else dtype_name(x.dtype)
    return _wrap32(int(checksum_device(x))) == expected_checksum(n, dtype)


def _wrap32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v
