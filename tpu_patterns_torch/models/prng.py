"""The ``jax.random`` calls the seeded sampler makes, in torch.

The reference draws its sampling noise with ``jax.random`` under
``jax_default_prng_impl=threefry2x32`` and
``jax_threefry_partitionable=True`` (jax 0.9).  This module reproduces
exactly the calls ``sample_token_rows`` makes, bit for bit:

* ``key(0)``: key data ``[0, 0]``;
* ``fold_in(key, data)``: ``threefry2x32(key, (0, data mod 2**32))``;
* ``random_bits(key, c)``: 32-bit words ``y0 ^ y1`` of
  ``threefry2x32(key, (0, i))`` for counter ``i`` in ``[0, c)`` (the
  partitionable layout: the high and low words of a 64-bit iota);
* ``uniform(key, c)``: ``(bits >> 9) | 0x3F800000`` read as float32,
  minus 1, scaled to ``[tiny, 1)`` and clamped at ``tiny``;
* ``gumbel(key, c)``: ``-log(-log(uniform))``, jax's ``mode=None``.

Keys are ``[..., 2]`` tensors and every function runs vectorised over
the leading axes on the tensors' device.  torch's ``uint32`` support is
partial, so the words are held in int64 and masked to 32 bits after
every operation that can carry past them.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1)
    under key words (k0, k1); int64 tensors holding uint32 values,
    broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s key data for a seed that fits 32 bits
    unsigned: ``[0, seed]``."""
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys ``[..., 2]`` and ``data`` (an int or
    an integer tensor broadcasting over the leading axes, read as
    uint32) -> keys ``[..., 2]``."""
    if isinstance(data, int):
        # filled on the device: a host scalar never becomes a copy (and
        # a copy's wait) inside a generation loop
        d = torch.full(k.shape[:-1], data & MASK32, dtype=torch.int64,
                       device=k.device)
    else:
        d = torch.as_tensor(data, device=k.device).to(torch.int64) & MASK32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack((y0, y1), dim=-1)


def random_bits(k: torch.Tensor, c: int) -> torch.Tensor:
    """32-bit random words ``[..., c]`` (int64) of a ``(c,)`` draw per
    key of ``k [..., 2]``."""
    i = torch.arange(c, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(k: torch.Tensor, c: int) -> torch.Tensor:
    """``jax.random.uniform(k, (c,), float32, minval=tiny, maxval=1)``
    per key: float32 ``[..., c]``."""
    bits = (random_bits(k, c) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    one = torch.tensor(1.0, dtype=torch.float32, device=k.device)
    tiny = torch.tensor(_TINY, dtype=torch.float32, device=k.device)
    return torch.maximum(tiny, floats * (one - tiny) + tiny)


def gumbel(k: torch.Tensor, c: int) -> torch.Tensor:
    """``jax.random.gumbel(k, (c,), float32)`` per key: float32
    ``[..., c]``."""
    return -torch.log(-torch.log(uniform(k, c)))
