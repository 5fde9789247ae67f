"""The port's ZeRO step (``parallel/zero.py``) and its small optimizer
(``parallel/optim.py``) against the JAX package's ``zero`` with optax.

The same seeded numpy params and per-rank grads go through the
reference's ``zero_init``/``zero_apply`` under ``shard_map`` over the
conftest's 8 CPU devices with ``optax.sgd``/``optax.adam``, and through
the port over 8 CPU ranks with its own ``sgd``/``adam``: two steps each,
the new params within 2e-6 relative (1e-7 absolute) of the reference's.
Each rank's optimizer state covers only its 1/dp shard."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_patterns.parallel import zero as jzero
from tpu_patterns_torch.parallel import optim as topt
from tpu_patterns_torch.parallel import zero as tzero

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

DP = 8
LR = 0.05
RTOL, ATOL = 2e-6, 1e-7


def _tree(seed, n_elem, dp=None):
    """A two-leaf tree: a vector of ``n_elem`` (61 takes the pad path)
    and a [5, 3] matrix; with ``dp``, one such tree a rank."""
    rng = np.random.default_rng(seed)
    lead = () if dp is None else (dp,)
    return {"w": rng.standard_normal(lead + (n_elem,)).astype(np.float32),
            "m": rng.standard_normal(lead + (5, 3)).astype(np.float32)}


def _reference(opt, params, grads, grads_reduced, steps=2):
    tx = {"sgd": optax.sgd, "adam": optax.adam}[opt](LR)
    mesh = Mesh(np.array(jax.devices()[:DP]), ("x",))

    def body(g, p):
        g = jax.tree.map(lambda a: a[0], g)
        state = jzero.zero_init(tx, p, "x", DP)
        for _ in range(steps):
            p, state = jzero.zero_apply(tx, g, state, p, "x", DP,
                                        grads_reduced=grads_reduced)
        return p

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("x"), P()),
                               out_specs=P(), check_vma=False))
    g = jax.device_put(jax.tree.map(jnp.asarray, grads),
                       NamedSharding(mesh, P("x")))
    return jax.tree.map(np.asarray, fn(g, jax.tree.map(jnp.asarray,
                                                       params)))


def _port(opt, params, grads, grads_reduced, steps=2):
    tx = {"sgd": topt.sgd, "adam": topt.adam}[opt](LR)
    ps = [{k: torch.from_numpy(v.copy()) for k, v in params.items()}
          for _ in range(DP)]
    gs = [{k: torch.from_numpy(v[r].copy()) for k, v in grads.items()}
          for r in range(DP)]
    state = tzero.zero_init(tx, ps)
    for _ in range(steps):
        ps, state = tzero.zero_apply(tx, gs, state, ps,
                                     grads_reduced=grads_reduced)
    return ps, state


@pytest.mark.parametrize("grads_reduced", [False, True],
                         ids=["scatter", "reduced"])
@pytest.mark.parametrize("n_elem", [64, 61])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_zero_apply_matches_reference(opt, n_elem, grads_reduced):
    params = _tree(0, n_elem)
    grads = _tree(1, n_elem, DP)
    if grads_reduced:  # every rank holds the summed gradient
        grads = {k: np.broadcast_to(v.sum(0), v.shape).copy()
                 for k, v in grads.items()}
    want = _reference(opt, params, grads, grads_reduced)
    got, state = _port(opt, params, grads, grads_reduced)
    for p in got:  # replicated: every rank holds the same new params
        for k in want:
            np.testing.assert_allclose(p[k].numpy(), want[k], rtol=RTOL,
                                       atol=ATOL)
            assert p[k].shape == params[k].shape
            assert p[k].dtype == torch.float32
    if opt == "adam":
        # the moments cover a rank's shard only: 1/dp of the state
        for st in state:
            assert int(st.count) == 2
            assert st.mu["w"].shape == (tzero.shard_size(n_elem, DP),)
            assert st.nu["m"].shape == (tzero.shard_size(15, DP),)
    else:
        assert all(st == () for st in state)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_optimizer_rules_match_optax(opt):
    """Three steps of the port's rule against optax's on one replicated
    tree (nested dict), with a new gradient each step."""
    params = {"a": _tree(2, 9), "b": np.linspace(-1, 1, 7, dtype=np.float32)}
    kw = dict(b1=0.8, b2=0.99, eps=1e-6) if opt == "adam" else {}
    jtx = {"sgd": optax.sgd, "adam": optax.adam}[opt](LR, **kw)
    ttx = {"sgd": topt.sgd, "adam": topt.adam}[opt](LR, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    jst, tst = jtx.init(jp), ttx.init(tp)
    for step in range(3):
        g = jax.tree.map(lambda a, s=step: np.cos(a * (s + 2)), params)
        upd, jst = jtx.update(jax.tree.map(jnp.asarray, g), jst, jp)
        jp = optax.apply_updates(jp, upd)
        upd, tst = ttx.update(
            jax.tree.map(lambda a: torch.from_numpy(a), g), tst, tp)
        tp = topt.apply_updates(tp, upd)
    for got, want in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("axis_size,state_arrays", [(1, 2), (8, 2), (8, 1),
                                                    (3, 2)])
def test_memory_model_matches_reference(axis_size, state_arrays):
    shapes = {"a": ((100,), "float32"), "b": ((3, 7), "bfloat16")}
    jp = {k: jnp.ones(s, d) for k, (s, d) in shapes.items()}
    tp = {k: torch.ones(s, dtype=getattr(torch, d))
          for k, (s, d) in shapes.items()}
    want = jzero.memory_model(jp, axis_size, state_arrays)
    got = tzero.memory_model(tp, axis_size, state_arrays)
    assert got == want
    assert set(got) == {"opt_state_bytes_replicated",
                        "opt_state_bytes_zero", "wire_bytes_per_device"}


@pytest.mark.parametrize("n", [1, 61, 64])
def test_shards_round_trip(n):
    """param_shard cuts every element to exactly one rank (the pad is
    zeros), and unshard restores shape and dtype."""
    p = torch.arange(n, dtype=torch.float32).reshape(-1)
    ps = [p.clone() for _ in range(DP)]
    shards = tzero.param_shard(ps)
    assert [s.numel() for s in shards] == [tzero.shard_size(n, DP)] * DP
    flat = torch.cat(shards)
    torch.testing.assert_close(flat[:n], p)
    assert bool((flat[n:] == 0).all())
    for out in tzero.unshard(ps, shards):
        torch.testing.assert_close(out, p, rtol=0, atol=0)
    # the scatter sums the ranks' grads, rank r keeping block r
    summed = torch.cat(tzero.grad_shard(ps))[:n]
    torch.testing.assert_close(summed, p * DP)
