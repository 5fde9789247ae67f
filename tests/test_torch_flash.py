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

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

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
    """The shared-memory ladder: each kernel's own pair, which fits 227
    KB where a pair one step larger does not."""
    budget = tuning.H100_SMEM_OPTIN
    # the flagship's bf16 D=128 tiles from the 1024 x 1024 request: the
    # wgmma forward's largest, two consumer warpgroups by 128 keys; the
    # backward's dq two warpgroups of rows by 64 keys, its dk/dv 64 rows
    # by two warpgroups of keys (a pair each: asking for both is refused)
    assert tuning._auto_block(4096, 4096, 128, 2, ("fwd",), 1024,
                              1024) == (128, 128)
    assert tuning._auto_block(4096, 4096, 128, 2, ("dq",), 1024,
                              1024) == (128, 64)
    assert tuning._auto_block(4096, 4096, 128, 2, ("dkv",), 1024,
                              1024) == (64, 128)
    for ib in (2, 4):
        with pytest.raises(ValueError, match="a tile pair each"):
            tuning._auto_block(4096, 4096, 128, ib, ("dq", "dkv"), 1024,
                               1024)
    for d in (64, 128):
        bq, bk = tuning._auto_block(4096, 4096, d, 2, ("fwd",), 1024, 1024)
        assert tuning.smem_bytes("fwd", bq, bk, d, 2) <= budget
        bigger = (2 * bq, bk) if bq < bk else (bq, 2 * bk)
        assert tuning.smem_bytes("fwd", *bigger, d, 2) > budget
    # the float32 backward's ladder at one head (no grid of unit pairs
    # fills the card): 32-entry units by tiles of head_dim; at 32 heads
    # 64 by 64, since a 64-entry unit by 128 would not fit at D 128
    for d in (64, 128):
        small = {"dq": (32, d), "dkv": (d, 32)}
        for kind, tiles in small.items():
            assert tuning._auto_block(4096, 4096, d, 4, (kind,), 1024,
                                      1024) == tiles
            assert tuning._auto_block(4096, 4096, d, 4, (kind,), 1024,
                                      1024, heads=32) == (64, 64)
            assert tuning.smem_bytes(kind, *tiles, d, 4) <= budget
            assert tuning.smem_bytes(kind, 64, 64, d, 4) <= budget
    assert tuning.smem_bytes("dq", 64, 128, 128, 4) > budget
    assert tuning.smem_bytes("dkv", 128, 64, 128, 4) > budget
    # the float32 forward's ladder: its kernel's tile (32-row q-units,
    # k-tiles of head_dim keys), whatever the request, within the budget
    for d in (64, 128):
        assert tuning._auto_block(4096, 4096, d, 4, ("fwd",), 1024,
                                  1024) == (32, d)
        assert tuning.smem_bytes("fwd", 32, d, d, 4) <= budget
    # whatever the request, the float32 kernels take their sides (below
    # head_dim 64, the smallest: no kernel takes such a head_dim)
    assert tuning._auto_block(64, 64, 16, 4, ("dq",), 1024,
                              1024) == (32, 64)
    assert tuning._auto_block(64, 64, 16, 4, ("dkv",), 16,
                              32) == (64, 32)
    assert tuning._auto_block(64, 64, 16, 4, ("fwd",), 1024, 1024) == (32, 64)
    assert tuning._auto_block(64, 64, 16, 4, ("fwd",), 16, 32) == (32, 64)
    assert tuning.load_tuned_blocks(str(tmp_path / "absent.json")) == (
        tuning.DEFAULT_BLOCK_Q, tuning.DEFAULT_BLOCK_K)
    path = tmp_path / "flash_tuned.json"
    path.write_text('{"block_q": 256, "block_k": 512}')
    assert tuning.load_tuned_blocks(str(path)) == (256, 512)


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_forward_tiles_fit_and_mask_ragged_edges(d):
    """Every tile pair the bf16 forward's ladder can return fits 227 KB
    at D 64 and 128; its sides are 64 or 128, the largest <= the
    request that divides the length, else 64 (the kernel masks the
    ragged edge, so the wrapper does not refuse it)."""
    budget = tuning.H100_SMEM_OPTIN
    got = set()
    for lq in (16, 64, 100, 192, 256, 4096):
        for lk in (16, 64, 100, 192, 256, 4096):
            for req in (16, 64, 100, 128, 1024):
                bq, bk = tuning._auto_block(lq, lk, d, 2, ("fwd",), req, req)
                assert bq in tuning.FWD_BF16_SIDES
                assert bk in tuning.FWD_BF16_SIDES
                assert (bq == 64 or (bq <= req and lq % bq == 0))
                assert (bk == 64 or (bk <= req and lk % bk == 0))
                got.add((bq, bk))
    assert got == {(a, b) for a in tuning.FWD_BF16_SIDES
                   for b in tuning.FWD_BF16_SIDES}
    for bq, bk in got:
        assert tuning.smem_bytes("fwd", bq, bk, d, 2) <= budget
    # a ragged bf16 forward runs (on the CPU, its plain version)
    q = _t(_np(5, (100, 2, d))).to(torch.bfloat16)
    k = _t(_np(6, (200, 2, d))).to(torch.bfloat16)
    o, m, l = tflash.flash_block(q, k, k, 0, 0, causal=True)
    assert o.shape == (100, 2, d) and m.shape == l.shape == (2, 100)


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_backward_tiles_fit_and_mask_ragged_edges(d):
    """The bf16 backward's pairs: dq owns 64 or 128 rows and streams 64
    keys, dk/dv owns 64 or 128 keys and streams 64 rows; the owned side
    is the largest <= the request that divides its length, else 64 (the
    kernels mask the ragged edge), and every pair fits 227 KB.  A ragged
    bf16 backward runs (on the CPU, its plain version)."""
    budget = tuning.H100_SMEM_OPTIN
    got = {"dq": set(), "dkv": set()}
    for lq in (16, 64, 100, 192, 256, 4096):
        for lk in (16, 64, 100, 192, 256, 4096):
            for req in (16, 64, 100, 128, 1024):
                bq, bk = tuning._auto_block(lq, lk, d, 2, ("dq",), req, req)
                assert bq in tuning.BWD_BF16_SIDES
                assert bk == tuning.BWD_STREAM
                assert bq == 64 or (bq <= req and lq % bq == 0)
                got["dq"].add((bq, bk))
                bq, bk = tuning._auto_block(lq, lk, d, 2, ("dkv",), req,
                                            req)
                assert bq == tuning.BWD_STREAM
                assert bk in tuning.BWD_BF16_SIDES
                assert bk == 64 or (bk <= req and lk % bk == 0)
                got["dkv"].add((bq, bk))
    assert got == {"dq": {(s, 64) for s in tuning.BWD_BF16_SIDES},
                   "dkv": {(64, s) for s in tuning.BWD_BF16_SIDES}}
    for kind, pairs in got.items():
        for bq, bk in pairs:
            assert tuning.smem_bytes(kind, bq, bk, d, 2) <= budget
    q = _t(_np(5, (100, 2, d))).to(torch.bfloat16)
    k = _t(_np(6, (200, 2, d))).to(torch.bfloat16)
    assert tflash._bwd_tiles(q, k, 1024, 1024) == {"dq": (64, 64),
                                                   "dkv": (64, 64)}
    assert tflash._bwd_tiles(k, k, 1024, 1024) == {"dq": (64, 64),
                                                   "dkv": (64, 64)}
    assert tflash._bwd_tiles(q[:64], k[:128], 1024, 1024) == {
        "dq": (64, 64), "dkv": (64, 128)}
    do = _t(_np(7, (100, 2, d))).to(torch.bfloat16)
    lse, delta = _t(_np(8, (2, 100))), _t(_np(9, (2, 100)))
    for causal in (False, True):
        got = tflash.flash_block_bwd(q, k, k, do, lse, delta, 0, 0,
                                     causal=causal)
        want = tflash.flash_block_bwd_reference(q, k, k, do, lse, delta, 0,
                                                0, causal)
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            assert torch.equal(a, b)
