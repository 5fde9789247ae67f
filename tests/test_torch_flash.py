"""The port's flash attention (K2, K3, K4) against the JAX package's.

The same seeded numpy inputs go through the reference's Pallas kernels
in interpret mode (as tests/test_longctx.py runs them on the CPU) and
the port's wrappers on CPU tensors, which run the plain torch versions
of the CUDA kernels.  Tolerances are the reference's own for its
kernels against their XLA twins: float32 2e-5 forward, 1e-4 gradients
(both sides do float32 math, summed in different orders and tiles)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_patterns.longctx import attention as jatt
from tpu_patterns.longctx import flash as jflash
from tpu_patterns_torch.longctx import attention as tatt
from tpu_patterns_torch.longctx import flash as tflash
from tpu_patterns_torch.longctx import tuning

L, H, D = 64, 8, 16
FWD_ATOL, GRAD_ATOL = 2e-5, 1e-4


def _np(seed, shape=(L, H, D)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _qkv(seed):
    return tuple(_np(seed + i) for i in range(3))


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               err_msg=msg)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_off,k_off,stride",
                         [(0, 0, 1), (16, 32, 1), (2, 5, 8)])
def test_flash_block_and_bwd_match_reference(causal, q_off, k_off, stride):
    """K3 and K4 at shard offsets and strides, forward triple and
    gradients, against the reference's interpret-mode kernels fed the
    same row statistics."""
    q, k, v = _qkv(11)
    jo, jm, jl = jflash.flash_block(
        *map(jnp.asarray, (q, k, v)), q_off, k_off, causal=causal,
        block_q=16, block_k=16, interpret=True, pos_stride=stride,
    )
    to, tm, tl = tflash.flash_block(
        _t(q), _t(k), _t(v), q_off, k_off, causal=causal, block_q=16,
        block_k=16, pos_stride=stride,
    )
    for name, a, b in (("o", to, jo), ("m", tm, jm), ("l", tl, jl)):
        _close(a, b, FWD_ATOL, name)

    out, lse = jflash._row_stats(jo, jm, jl)
    g = _np(3)
    delta = jflash._delta(jnp.asarray(g), out)
    want = jflash.flash_block_bwd(
        *map(jnp.asarray, (q, k, v, g)), lse, delta, q_off, k_off,
        causal=causal, block_q=16, block_k=16, interpret=True,
        pos_stride=stride,
    )
    got = tflash.flash_block_bwd(
        _t(q), _t(k), _t(v), _t(g), _t(lse), _t(delta), q_off, k_off,
        causal=causal, block_q=16, block_k=16, pos_stride=stride,
    )
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        _close(a, b, GRAD_ATOL, name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("grid_mode", ["dense", "compact"])
def test_flash_attention_matches_reference(causal, grid_mode):
    """K2, both grid modes (non-causal compact runs the dense grid in
    both packages)."""
    q, k, v = _qkv(5)
    want = jflash.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, block_q=16,
        block_k=32, interpret=True, grid_mode=grid_mode,
    )
    got = tflash.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                 block_q=16, block_k=32, grid_mode=grid_mode)
    assert got.dtype == torch.float32
    _close(got, want, FWD_ATOL)


def test_flash_block_noncausal_lq_ne_lk():
    q = _np(20, (32, H, D))
    k, v = _np(21), _np(22)
    want = jflash.flash_block(*map(jnp.asarray, (q, k, v)), 0, 0,
                              block_q=16, block_k=32, interpret=True)
    got = tflash.flash_block(_t(q), _t(k), _t(v), 0, 0, block_q=16,
                             block_k=32)
    for a, b in zip(got, want):
        _close(a, b, FWD_ATOL)


def test_flash_block_bf16_rounding_points():
    """bfloat16 inputs: p is rounded to v's dtype before P V in both
    packages; the results then differ only by where each rounds p (the
    reference against a running max per tile, the plain version against
    the row's max), well under bf16 resolution of max |o|."""
    q, k, v = _qkv(30)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jo, jm, jl = jflash.flash_block(jq, jk, jv, 0, 0, causal=True,
                                    block_q=16, block_k=16, interpret=True)
    tq, tk, tv = (_t(np.asarray(a, np.float32)).to(torch.bfloat16)
                  for a in (jq, jk, jv))
    to, tm, tl = tflash.flash_block(tq, tk, tv, 0, 0, causal=True,
                                    block_q=16, block_k=16)
    scale = float(np.abs(np.asarray(jo)).max())
    _close(to, jo, 2e-2 * scale, "o")
    _close(tm, jm, FWD_ATOL, "m")
    _close(tl, jl, 1e-3 * float(np.asarray(jl).max()), "l")


@functools.lru_cache(maxsize=None)
def _jax_diff(grid_mode, bq, bk):
    q, k, v = _qkv(7)

    def loss(a, b, c):
        out = jflash.flash_attention_diff(a, b, c, True, None, bq, bk, True,
                                          grid_mode)
        return jnp.sum(out * jnp.cos(out))

    args = tuple(map(jnp.asarray, (q, k, v)))
    out = jflash.flash_attention_diff(*args, True, None, bq, bk, True,
                                      grid_mode)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("grid_mode,bq,bk", [
    ("dense", 16, 16), ("compact", 16, 16), ("dense", 16, 32),
    ("compact", 32, 16),
])
def test_flash_attention_diff_grads_match_reference(grid_mode, bq, bk):
    """K3 forward + K4 backward through autograd against the
    reference's custom_vjp under jax.grad, same objective."""
    want_out, want_grads = _jax_diff(grid_mode, bq, bk)
    q, k, v = (_t(a).requires_grad_(True) for a in _qkv(7))
    out = tflash.flash_attention_diff(q, k, v, True, None, bq, bk, grid_mode)
    (out * torch.cos(out)).sum().backward()
    _close(out.detach(), want_out, FWD_ATOL, "out")
    for name, a, b in zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad),
                          want_grads):
        _close(a, b, GRAD_ATOL, name)


def test_flash_attention_diff_primal_is_k2(monkeypatch):
    """Without a gradient the primal runs K2 (flash_attention); under
    autograd the forward is K3 (flash_block)."""
    calls = []
    for name in ("flash_attention", "flash_block"):
        fn = getattr(tflash, name)
        monkeypatch.setattr(
            tflash, name,
            functools.partial(lambda f, n, *a, **kw: calls.append(n)
                              or f(*a, **kw), fn, name),
        )
    q, k, v = (_t(a) for a in _qkv(8))
    with torch.no_grad():
        tflash.flash_attention_diff(q, k, v, True, None, 16, 16)
    assert calls == ["flash_attention"]
    calls.clear()
    tflash.flash_attention_diff(q.requires_grad_(True), k, v, True, None,
                                16, 16)
    assert calls == ["flash_block"]


@pytest.mark.parametrize("call,match", [
    (lambda q: tflash.flash_attention(q, q, q, block_q=48, block_k=48),
     "divide"),
    (lambda q: tflash.flash_block(q, q, q, 0, 0, block_q=24, block_k=48),
     "divide"),
    (lambda q: tflash.flash_attention(q, q, q, grid_mode="sparse"),
     "grid_mode"),
    (lambda q: tflash.flash_block(q, q, q, 16, 0, causal=True,
                                  grid_mode="compact"),
     "static zero shard offsets"),
    (lambda q: tflash.flash_block_bwd(q, q, q, q, q[:, :, 0].T, q[:, :, 0].T,
                                      q_off=8, causal=True,
                                      grid_mode="compact"),
     "static zero shard offsets"),
    (lambda q: tflash.flash_block_bwd(q[:32], q, q, q[:32], q[:32, :, 0].T,
                                      q[:32, :, 0].T, causal=True,
                                      grid_mode="compact"),
     "Lq == Lk"),
])
def test_reference_errors(call, match):
    """The reference's refusals, raised by the wrapper on both paths."""
    with pytest.raises(ValueError, match=match):
        call(_t(_np(6)))


def test_no_kernel_for_other_devices():
    q = torch.empty((L, H, D), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tflash.flash_attention(q, q, q, block_q=16, block_k=16)


@pytest.mark.parametrize("nq,nk,bq,bk", [
    (4, 4, 16, 16), (2, 4, 32, 16), (4, 2, 16, 32), (3, 5, 16, 16),
])
def test_pair_tables_match_reference(nq, nk, bq, bk):
    np.testing.assert_array_equal(
        tflash._causal_pair_table(nq, nk, bq, bk).numpy(),
        jflash._causal_pair_table(nq, nk, bq, bk),
    )
    np.testing.assert_array_equal(
        tflash._causal_pair_table_kmajor(nq, nk, bq, bk).numpy(),
        jflash._causal_pair_table_kmajor(nq, nk, bq, bk),
    )


@pytest.mark.parametrize("causal", [False, True])
def test_dense_twins_match_reference(causal):
    """attention_reference, block_attention + combine_blocks + finalize,
    empty_state, and the flash kernels' agreement with them."""
    q, k, v = _qkv(40)
    jargs, targs = tuple(map(jnp.asarray, (q, k, v))), (_t(q), _t(k), _t(v))
    want = jatt.attention_reference(*jargs, causal=causal)
    _close(tatt.attention_reference(*targs, causal=causal), want, FWD_ATOL)
    mask = None
    if causal:
        mask = tatt.causal_mask(torch.arange(L), torch.arange(L))
        np.testing.assert_array_equal(
            mask.numpy(), np.asarray(jatt.causal_mask(jnp.arange(L),
                                                      jnp.arange(L))))
    half = L // 2
    state = tatt.empty_state(targs[0])
    jstate = jatt.empty_state(jargs[0])
    for a, b in zip(state, jstate):
        _close(a, b, 0.0)
    for lo in (0, half):
        sl = slice(lo, lo + half)
        m = None if mask is None else mask[:, sl]
        blk = tatt.block_attention(targs[0], targs[1][sl], targs[2][sl],
                                   mask=m)
        jblk = jatt.block_attention(
            jargs[0], jargs[1][sl], jargs[2][sl],
            mask=None if m is None else jnp.asarray(m.numpy()),
        )
        for a, b in zip(blk, jblk):
            _close(a, b, FWD_ATOL)
        state = tatt.combine_blocks(state, blk)
    _close(tatt.finalize(state), want, FWD_ATOL)
    _close(tflash.flash_attention(*targs, causal=causal, block_q=16,
                                  block_k=16), want, FWD_ATOL)


def test_tile_fit_and_tuned_defaults(tmp_path):
    """The shared-memory ladder: the largest pair <= the request that
    fits 227 KB in every kernel it serves, halving the larger side."""
    budget = tuning.H100_SMEM_OPTIN
    # the flagship's bf16 D=128 tiles from the 1024 x 1024 request
    assert tuning._auto_block(4096, 4096, 128, 2, ("fwd",), 1024,
                              1024) == (64, 128)
    assert tuning._auto_block(4096, 4096, 128, 2, ("dq", "dkv"), 1024,
                              1024) == (64, 64)
    for kinds in (("fwd",), ("dq", "dkv")):
        for ib in (2, 4):
            for d in (64, 128):
                bq, bk = tuning._auto_block(4096, 4096, d, ib, kinds, 1024,
                                            1024)
                assert all(tuning.smem_bytes(k, bq, bk, d, ib) <= budget
                           for k in kinds)
                bigger = (2 * bq, bk) if bq < bk else (bq, 2 * bk)
                assert any(tuning.smem_bytes(k, *bigger, d, ib) > budget
                           for k in kinds)
    # short sequences clamp the request; a small request is kept
    assert tuning._auto_block(64, 64, 16, 4, ("fwd",), 1024, 1024) == (64, 64)
    assert tuning._auto_block(64, 64, 16, 4, ("fwd",), 16, 32) == (16, 32)
    assert tuning.load_tuned_blocks(str(tmp_path / "absent.json")) == (
        tuning.DEFAULT_BLOCK_Q, tuning.DEFAULT_BLOCK_K)
    path = tmp_path / "flash_tuned.json"
    path.write_text('{"block_q": 256, "block_k": 512}')
    assert tuning.load_tuned_blocks(str(path)) == (256, 512)
