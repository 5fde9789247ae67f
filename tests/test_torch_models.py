"""tpu_patterns_torch model math against the JAX package on the CPU.

The same seeded numpy inputs go through each JAX function and its torch
counterpart.  Float32 tolerances are the reference's own for kernel vs
dense agreement (rtol 2e-5, atol 2e-6): both sides do float32 math,
summed in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_patterns.models import decode as jdec
from tpu_patterns.models import lm as jlm
from tpu_patterns.models import transformer as jtr
from tpu_patterns_torch.convert import params_from_jax
from tpu_patterns_torch.models import decode as tdec
from tpu_patterns_torch.models import lm as tlm
from tpu_patterns_torch.models import transformer as ttr

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32),
        rtol=rtol, atol=atol,
    )


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**kw):
    base = dict(embed=32, heads=4, head_dim=8, dtype="float32", depth=1)
    base.update(kw)
    return jtr.ModelConfig(**base), ttr.ModelConfig(**base)


@pytest.mark.parametrize("kv_heads", [0, 2])
def test_qkv_native(kv_heads):
    jcfg, tcfg = _cfgs(kv_heads=kv_heads)
    flat = {
        k: np.asarray(v)
        for k, v in jtr.init_params(jax.random.key(1), jcfg).items()
    }
    x = np.random.RandomState(0).randn(2, 5, 32).astype(np.float32)
    want = jtr.qkv_native(flat, jnp.asarray(x))
    got = ttr.qkv_native({k: _t(v) for k, v in flat.items()}, _t(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


def test_init_params_layout_and_scale():
    _, tcfg = _cfgs(kv_heads=2, depth=3)
    p = ttr.init_params(torch.Generator().manual_seed(0), tcfg)
    for k, shape in ttr.param_shapes(tcfg).items():
        assert tuple(p[k].shape) == (3, *shape)
        fan_in = float(np.prod(shape[:-1]))
        # fan-in scaled unit normals: std within 10% of fan_in**-0.5
        assert abs(float(p[k].std()) * fan_in**0.5 - 1) < 0.1


def test_rope_tables_and_apply():
    rng = np.random.RandomState(1)
    pos = rng.randint(0, 600, size=(3, 4)).astype(np.int32)
    x = rng.randn(3, 4, 2, 16).astype(np.float32)
    jc, js = jtr.rope_tables(jnp.asarray(pos), 16, 10000.0, jnp.float32)
    tc, ts = ttr.rope_tables(_t(pos), 16, 10000.0, torch.float32)
    _close(tc, jc, rtol=1e-5, atol=1e-5)
    _close(ts, js, rtol=1e-5, atol=1e-5)
    _close(ttr.apply_rope(_t(x), tc, ts),
           jtr.apply_rope(jnp.asarray(x), jc, js), rtol=1e-5, atol=1e-5)
    # shared [L, D/2] tables broadcast over the batch
    jc1, js1 = jtr.rope_tables(jnp.arange(4), 16, 10000.0, jnp.float32)
    tc1, ts1 = ttr.rope_tables(torch.arange(4), 16, 10000.0, torch.float32)
    _close(ttr.apply_rope(_t(x), tc1, ts1),
           jtr.apply_rope(jnp.asarray(x), jc1, js1), rtol=1e-5, atol=1e-5)


def test_quantize_kv_bit_equal():
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 3, 5, 16) * rng.uniform(0.01, 10, (2, 3, 5, 1))
         ).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero slot takes the 1e-8 floor
    x[1, 2, 4, :2] = [127.5, -254.0]  # ties at .5 round half to even
    jq, js = jdec._quantize_kv(jnp.asarray(x))
    tq, ts = tdec._quantize_kv(_t(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_mlp():
    jcfg, tcfg = _cfgs()
    flat = {
        k: np.asarray(v)
        for k, v in jtr.init_params(jax.random.key(2), jcfg).items()
    }
    y = np.random.RandomState(3).randn(2, 3, 32).astype(np.float32)
    want = jdec._mlp(flat, jnp.asarray(y), None, jcfg)
    got = tdec._mlp({k: _t(v) for k, v in flat.items()}, _t(y))
    _close(got, want)


def _attn_inputs(seed, int8):
    rng = np.random.RandomState(seed)
    b, lq, h, hkv, lc, d = 3, 2, 4, 2, 12, 8
    q = rng.randn(b, lq, h, d).astype(np.float32)
    mask = rng.rand(b, lq, lc) < 0.6
    mask[1] = False  # a row with no visible slot: exact zeros
    if int8:
        ck = rng.randint(-127, 128, (b, hkv, lc, d)).astype(np.int8)
        cv = rng.randint(-127, 128, (b, hkv, lc, d)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (b, hkv, lc)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (b, hkv, lc)).astype(np.float32)
        return q, ck, cv, mask, ks, vs
    ck = rng.randn(b, hkv, lc, d).astype(np.float32)
    cv = rng.randn(b, hkv, lc, d).astype(np.float32)
    return q, ck, cv, mask, None, None


@pytest.mark.parametrize("int8", [False, True])
def test_distributed_attention(int8):
    q, ck, cv, mask, ks, vs = _attn_inputs(4 + int8, int8)
    want = jdec._distributed_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(mask),
        None,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs),
    )
    got = tdec._distributed_attention(
        _t(q), _t(ck), _t(cv), _t(mask),
        k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs),
    )
    _close(got, want)
    assert torch.all(got[1] == 0)


def test_kv_slot_bytes():
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        for int8 in (False, True):
            assert tdec.kv_slot_bytes(128, 8, dt, int8) == (
                jdec.kv_slot_bytes(128, 8, jdt, int8)
            )


def test_embed_tokens_and_argmax_ties():
    rng = np.random.RandomState(5)
    wemb = rng.randn(16, 8).astype(np.float32)
    toks = rng.randint(0, 16, (2, 5)).astype(np.int32)
    _close(tlm.embed_tokens(_t(wemb), _t(toks)),
           jlm.embed_tokens(jnp.asarray(wemb), jnp.asarray(toks), None))
    logits = rng.randn(4, 16).astype(np.float32)
    logits[1, [3, 9]] = 50.0  # tie: the lowest id wins
    logits[2, :] = 0.0  # all tied: id 0
    got = tlm.sharded_argmax(_t(logits))
    want = jlm.sharded_argmax(jnp.asarray(logits), None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[1]) == 3 and int(got[2]) == 0


@pytest.mark.parametrize("cache_int8", [False, True])
def test_lm_decoder_oracle(devices, cache_int8):
    """The dense per-request oracle on converted params: greedy ids
    equal the reference's, caches within tolerance, and the prefill
    logits of a full-length row match the reference's training forward
    at the last position."""
    kw = dict(embed=64, heads=8, head_dim=8, dtype="float32", depth=2,
              rope=True)
    jcfg, tcfg = jtr.ModelConfig(**kw), ttr.ModelConfig(**kw)
    vocab, batch, lp, gen = 64, 3, 12, 6
    mesh = Mesh(np.array(devices[:1]).reshape(1, 1, 1), ("dp", "sp", "tp"))
    flat = {
        k: np.asarray(v)
        for k, v in jlm.init_lm_params(jax.random.key(0), jcfg, vocab).items()
    }
    rng = np.random.RandomState(6)
    toks = rng.randint(0, vocab, (batch, lp)).astype(np.int32)
    lens = np.asarray([lp, 7, 3], np.int32)

    jpre, jgen = jlm.make_lm_decoder(
        mesh, jcfg, vocab, batch, lp, gen, cache_int8=cache_int8
    )
    jcache, jtok0 = jpre(flat, jnp.asarray(toks), jnp.asarray(lens))
    _, jids = jgen(flat, jcache, jtok0, (jnp.asarray(lens), 0), gen - 1)

    params = params_from_jax(flat, tcfg)
    tpre, tgen = tlm.make_lm_decoder(
        tcfg, vocab, batch, lp, gen, cache_int8=cache_int8
    )
    tcache, ttok0, logits = tpre(params, _t(toks), _t(lens),
                                 return_logits=True)
    for n in tcache:  # caches: [depth, B, Hkv, lc, ...] on both sides
        if n in ("k", "v") and cache_int8:
            diff = tcache[n].numpy().astype(int) - np.asarray(jcache[n])
            assert np.abs(diff).max() <= 1  # a rounding-boundary flip
        else:
            _close(tcache[n], jcache[n], rtol=1e-4, atol=1e-5)
    _, tids = tgen(params, tcache, ttok0, (_t(lens), 0), gen - 1)
    np.testing.assert_array_equal(ttok0.numpy(), np.asarray(jtok0))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))

    if not cache_int8:
        blocks = {k: jnp.asarray(v) for k, v in flat.items() if k != "wemb"}
        y = jtr.forward_stack(
            blocks, jnp.asarray(flat["wemb"])[toks[:1]], jcfg
        )
        want = y[0, -1] @ jnp.asarray(flat["wemb"]).T
        _close(logits[0], want, rtol=1e-4, atol=1e-5)
