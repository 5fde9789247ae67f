"""The port's threefry PRNG (``models/prng.py``) against ``jax.random``.

The sampler keys row b's draw ``fold_in(fold_in(key(0), seed), gidx)``
and draws a ``(c,)`` Gumbel vector from it.  For 240 seeded (seed, gidx)
pairs (0, negative and 2**31 - 1 seeds among them) and widths 1-64, the
key data, the raw 32-bit words and the uniforms must equal jax's bit for
bit, and the Gumbel values agree at rtol 1e-6 plus atol 1e-6: XLA's CPU
``log`` and torch's differ in the last ulp, and where ``-log(u)`` lies
near 1 the outer log's value is near 0, so an ulp there is no small
relative error.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_patterns_torch.models import prng

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

WIDTHS = [1, 2, 3, 4, 5, 8, 16, 31, 32, 33, 63, 64]


@functools.lru_cache(maxsize=None)
def _pairs():
    rng = np.random.RandomState(20)
    seeds = rng.randint(-2**31, 2**31 - 1, size=240).astype(np.int32)
    gidx = rng.randint(0, 4096, size=240).astype(np.int32)
    seeds[:6] = [0, -1, 2**31 - 1, -2**31, 1, 3]
    gidx[:6] = [0, 2**31 - 1, 7, 0, 2**31 - 1, 5]
    return seeds, gidx


@functools.lru_cache(maxsize=None)
def _jax_draws(c):
    def one(s, g):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.key(0), s), g)
        return (
            jax.random.key_data(k),
            jax.random.bits(k, (c,), jnp.uint32),
            jax.random.uniform(k, (c,), jnp.float32,
                               minval=np.finfo(np.float32).tiny, maxval=1.0),
            jax.random.gumbel(k, (c,), jnp.float32),
        )

    seeds, gidx = _pairs()
    out = jax.jit(jax.vmap(one))(jnp.asarray(seeds), jnp.asarray(gidx))
    return tuple(np.asarray(a) for a in out)


def _port_keys():
    seeds, gidx = _pairs()
    return prng.fold_in(
        prng.fold_in(prng.key(0), torch.from_numpy(seeds)),
        torch.from_numpy(gidx),
    )


def test_the_test_vector():
    k = prng.fold_in(prng.fold_in(prng.key(0), 3), 5)
    assert k.tolist() == [1244721678, 2594860169]
    np.testing.assert_allclose(
        prng.gumbel(k, 4).numpy(),
        [0.3667981, 2.3004694, -0.791523, 2.3178077], rtol=1e-6,
    )


def test_key_data_equals_jax():
    want = _jax_draws(1)[0].astype(np.int64)
    got = _port_keys().numpy()
    assert want.shape == got.shape == (240, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", WIDTHS)
def test_bits_and_uniform_equal_jax(c):
    _, bits, uni, _ = _jax_draws(c)
    k = _port_keys()
    np.testing.assert_array_equal(prng.random_bits(k, c).numpy(),
                                  bits.astype(np.int64))
    got = prng.uniform(k, c).numpy()
    np.testing.assert_array_equal(got.view(np.int32), uni.view(np.int32))


@pytest.mark.parametrize("c", WIDTHS)
def test_gumbel_agrees_with_jax(c):
    want = _jax_draws(c)[3]
    got = prng.gumbel(_port_keys(), c).numpy()
    assert got.dtype == np.float32 and got.shape == (240, c)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_rows_are_independent_of_their_batch():
    """A row's draw depends on its (seed, gidx) alone, not on the rows
    beside it: the replay rule the serve cores rely on."""
    seeds, gidx = _pairs()
    full = prng.gumbel(_port_keys(), 16)
    for b in (0, 5, 239):
        k = prng.fold_in(prng.fold_in(prng.key(0), int(seeds[b])),
                         int(gidx[b]))
        assert torch.equal(prng.gumbel(k, 16), full[b])


def test_fold_in_reads_data_as_uint32():
    base = prng.key(0)
    assert torch.equal(prng.fold_in(base, -1), prng.fold_in(base, 2**32 - 1))
    assert prng.key(7).tolist() == [0, 7]
