"""The port's per-row seeded sampler against the JAX package's.

``sample_token_rows`` (``models/lm.py``) on the same seeded logits and
per-row (seed, gidx, temp, top_k, top_p) gives the reference's ids
exactly (tp_axis None): V 50, 64 and 200 put the vocab below, at and
above the 64-candidate cap; rows mix temperatures 0, 0.5 and 1.5, top-k
0, 1, 5, 64 and 100 and top-p 1.0, 0.9 and 0.05, and some hold planted
ties (rounded logits with +0.0 and -0.0, constant rows, ties across the
cap).  The dense decoder's ``sample_rows`` rollout gives the reference's
ids on the same handed-over weights.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_patterns.models.lm import init_lm_params as j_init_lm_params
from tpu_patterns.models.lm import make_lm_decoder as j_make_lm_decoder
from tpu_patterns.models.lm import sample_token_rows as j_sample
from tpu_patterns.models.transformer import ModelConfig as JModelConfig
from tpu_patterns_torch.convert import params_from_jax
from tpu_patterns_torch.models.lm import (
    SAMPLE_CANDIDATES,
    make_lm_decoder,
    sample_rows_on,
    sample_token_rows,
    sharded_argmax,
)
from tpu_patterns_torch.models.transformer import ModelConfig

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

ROWS = 48


def _case(v: int, seed: int):
    """Seeded logits [ROWS, v] and per-row sampling arrays; rows 0-9
    rounded (ties, +-0.0), 10-13 constant, 14-16 all zeros with every
    third -0.0, 17-19 a block of ties straddling the cap."""
    rng = np.random.RandomState(1000 * v + seed)
    lg = (rng.randn(ROWS, v) * rng.choice([0.5, 3.0, 10.0])).astype(
        np.float32)
    lg[:10] = np.round(lg[:10])
    lg[10:14] = 1.0
    lg[14:17] = 0.0
    lg[15, ::3] = -0.0
    lg[17:20, : min(v, 80)] = 2.0
    temp = rng.choice([0.0, 0.5, 1.5], ROWS).astype(np.float32)
    topk = rng.choice([0, 1, 5, 64, 100], ROWS).astype(np.int32)
    topp = rng.choice([1.0, 0.9, 0.05], ROWS).astype(np.float32)
    seeds = rng.randint(-2**31, 2**31 - 1, ROWS).astype(np.int32)
    seeds[:3] = [0, -1, 2**31 - 1]
    gidx = rng.randint(0, 5000, ROWS).astype(np.int32)
    return lg, seeds, gidx, temp, topk, topp


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("v", [50, 64, 200])
def test_ids_equal_reference(v, seed):
    arrays = _case(v, seed)
    want = np.asarray(j_sample(*(jnp.asarray(a) for a in arrays), None))
    got = sample_token_rows(*(torch.from_numpy(a) for a in arrays))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("v", [50, 64, 200])
def test_greedy_rows_take_the_argmax(v):
    """Greedy rows give ``sharded_argmax``'s ids wherever the maximum is
    not shared by -0.0 and +0.0 (row 15 of the case, where the
    reference's candidate order puts +0.0 first)."""
    lg, seeds, gidx, _, topk, topp = _case(v, 9)
    lg[15] = 0.0
    temp = np.zeros(ROWS, np.float32)
    got = sample_token_rows(*(torch.from_numpy(a) for a in
                              (lg, seeds, gidx, temp, topk, topp)))
    assert torch.equal(got, sharded_argmax(torch.from_numpy(lg)))


def test_top_k_one_is_greedy_and_candidates_are_capped():
    lg, seeds, gidx, temp, _, topp = _case(200, 3)
    lg[15] = 0.0
    temp[:] = 1.5
    one = np.ones(ROWS, np.int32)
    got = sample_token_rows(*(torch.from_numpy(a) for a in
                              (lg, seeds, gidx, temp, one, topp)))
    assert torch.equal(got, sharded_argmax(torch.from_numpy(lg)))
    assert SAMPLE_CANDIDATES == 64


def test_sample_rows_on_packs_one_block_and_skips_greedy():
    rows = ([3, -1], [0, 9], [0.5, 0.0], [5, 0], [0.9, 1.0])
    seeds, gidx, temp, topk, topp = sample_rows_on("cpu", *rows)
    assert seeds.tolist() == [3, -1] and gidx.tolist() == [0, 9]
    assert temp.dtype == topp.dtype == torch.float32
    assert temp.tolist() == [0.5, 0.0] and topk.tolist() == [5, 0]
    assert topp.tolist() == pytest.approx([0.9, 1.0])
    assert seeds.untyped_storage().data_ptr() == (
        topp.untyped_storage().data_ptr())
    assert sample_rows_on("cpu", [1], [0], [0.0], [0], [1.0]) is None


VOCAB = 64
MODEL = dict(embed=64, heads=8, head_dim=8, dtype="float32", depth=2,
             rope=True)
PROMPT, GEN, BATCH = 12, 8, 3


@functools.lru_cache(maxsize=None)
def _flat():
    cfg = JModelConfig(**MODEL)
    return {k: np.asarray(v) for k, v in
            j_init_lm_params(jax.random.key(2), cfg, VOCAB).items()}


def _prompts():
    rng = np.random.RandomState(5)
    toks = rng.randint(0, VOCAB, size=(BATCH, PROMPT)).astype(np.int32)
    lens = np.array([PROMPT, 7, 3], np.int32)
    rows = (np.array([11, -5, 2**31 - 1], np.int32),
            np.array([0, 3, 100], np.int32),
            np.array([0.9, 1.4, 0.0], np.float32),
            np.array([16, 0, 5], np.int32),
            np.array([0.95, 1.0, 0.9], np.float32))
    return toks, lens, rows


def test_dense_decoder_sample_rows_equal_reference():
    toks, lens, rows = _prompts()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))
    jpre, jgen = j_make_lm_decoder(mesh, JModelConfig(**MODEL), VOCAB,
                                   BATCH, PROMPT, GEN)
    jrows = tuple(jnp.asarray(a) for a in rows)
    caches, t0 = jpre(_flat(), toks, jnp.asarray(lens), sample_rows=jrows)
    _, gen = jgen(_flat(), caches, t0, (jnp.asarray(lens), 0), GEN - 1,
                  sample_rows=jrows)
    want = np.concatenate([np.asarray(t0)[:, None], np.asarray(gen)], 1)

    cfg = ModelConfig(**MODEL)
    params = params_from_jax(_flat(), cfg)
    pre, gen_t = make_lm_decoder(cfg, VOCAB, BATCH, PROMPT, GEN)
    cache, t0_t = pre(params, torch.from_numpy(toks), lens,
                      sample_rows=rows)
    _, gen_ids = gen_t(params, cache, t0_t, (lens, 0), GEN - 1,
                       sample_rows=rows)
    got = torch.cat([t0_t[:, None], gen_ids], 1).numpy()
    np.testing.assert_array_equal(got, want)
    # the greedy row (temp 0) is the unsampled rollout's
    cache, g0 = pre(params, torch.from_numpy(toks), lens)
    _, g = gen_t(params, cache, g0, (lens, 0), GEN - 1)
    np.testing.assert_array_equal(got[2], torch.cat([g0[:, None], g], 1)[2])
