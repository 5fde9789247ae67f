"""The port's ZeRO train step (``models/zero_step.py``) over a
(2, 2, 2) rank mesh against the JAX package's ``make_zero_train_step``
on the conftest's 8 CPU devices, and against the port's own SGD step.

The reference's params (numpy) and one seeded numpy batch go through
both packages; the objective is normalised by the element count.
Float32: loss rtol 1e-5; the gathered params after one zero-sgd step
(lr 1.0) and after two zero-adam steps (lr 1e-4: Adam's
m / (sqrt(v) + eps) turns a rounding difference in a gradient near eps
into up to ~1e-2 of lr) within atol 1e-6 of the reference's; zero-sgd
equal to the replicated SGD step within rtol 1e-5 / atol 1e-7; every sp
replica of a slice bit-identical; the Adam state 1/dp of each tp-local
block."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_patterns.models import transformer as jtr
from tpu_patterns_torch.comm.mesh import model_mesh
from tpu_patterns_torch.convert import block_params_from_jax, params_to_numpy
from tpu_patterns_torch.models import transformer as ttr
from tpu_patterns_torch.models import zero_step as tzs
from tpu_patterns_torch.parallel import zero

from test_torch_model_mesh import (
    B,
    D,
    E,
    H,
    L,
    N_GLOBAL,
    batch,
    jmesh,
    port_cfg,
    shard_batch,
)

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

SHAPE = (2, 2, 2)
RUNS = {  # name -> (optimizer, lr, steps, extra config)
    "sgd": ("sgd", 1.0, 1, {}),
    "sgd_moe": ("sgd", 1.0, 1, dict(moe=True)),
    "adam": ("adam", 1e-4, 2, {}),
}


@functools.lru_cache(maxsize=None)
def reference(name):
    opt, lr, steps, kw = RUNS[name]
    jcfg = jtr.ModelConfig(embed=E, heads=H, head_dim=D, **kw)
    mesh = jmesh(SHAPE)
    params = jtr.init_params(jax.random.key(4), jcfg,
                             n_experts=SHAPE[2] if jcfg.moe else 0)
    step, init, _ = jtr.make_zero_train_step(mesh, jcfg, lr=lr,
                                             optimizer=opt,
                                             n_global=N_GLOBAL)
    shards, state = init(jtr.shard_params(params, mesh, jcfg))
    sx = jax.device_put(jnp.asarray(batch()),
                        NamedSharding(mesh, P("dp", "sp", None)))
    losses = []
    for _ in range(steps):
        shards, state, loss = step(shards, state, sx)
        losses.append(float(loss))
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in step.gather(shards).items()},
            losses)


def port_run(name, attn="dense", **kw):
    opt, lr, steps, extra = RUNS[name]
    flat, _, _ = reference(name)
    cfg = port_cfg(extra, attn)
    mesh = model_mesh(8, SHAPE[0], SHAPE[2], device="cpu")
    step, init, specs = tzs.make_zero_train_step(
        mesh, cfg, lr=lr, optimizer=opt, n_global=N_GLOBAL, **kw)
    shards, state = init(ttr.shard_params(block_params_from_jax(flat, cfg),
                                          mesh, cfg))
    xs = shard_batch(mesh, batch())
    losses = []
    for _ in range(steps):
        shards, state, loss = step(shards, state, xs)
        losses.append(float(loss))
    return mesh, cfg, step, specs, shards, state, losses


@pytest.mark.parametrize("attn", ["dense", "kernel"])
@pytest.mark.parametrize("name", sorted(RUNS))
def test_zero_step_matches_reference(name, attn):
    _, want, want_losses = reference(name)
    mesh, cfg, step, _, shards, state, losses = port_run(name, attn)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got = params_to_numpy(ttr.gather_params(step.gather(shards), mesh, cfg),
                          cfg)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    # every sp replica of a slice is the same bits
    for k, per_rank in shards.items():
        for g in mesh.groups("sp"):
            for r in g[1:]:
                assert torch.equal(per_rank[g[0]].view(torch.int32),
                                   per_rank[r].view(torch.int32)), k


def test_zero_sgd_equals_the_sgd_step():
    flat, _, _ = reference("sgd")
    mesh, cfg, step, _, shards, _, losses = port_run("sgd")
    sgd = ttr.make_train_step(mesh, cfg, lr=1.0, n_global=N_GLOBAL)
    new, loss = sgd(ttr.shard_params(block_params_from_jax(flat, cfg), mesh,
                                     cfg), shard_batch(mesh, batch()))
    np.testing.assert_allclose(losses[0], float(loss), rtol=1e-5)
    want = ttr.gather_params(new, mesh, cfg)
    got = ttr.gather_params(step.gather(shards), mesh, cfg)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_adam_state_is_sharded_and_specs_cover_the_blocks():
    mesh, cfg, _, specs, shards, state, _ = port_run("adam")
    for k, (shape, spec) in ttr.param_specs(cfg).items():
        n_local = int(np.prod(tzs.local_shape(shape, spec, mesh)))
        k_shard = zero.shard_size(n_local, mesh.dim("dp"))
        assert all(s.numel() == k_shard for s in shards[k])
        assert all(st.mu[k].numel() == st.nu[k].numel() == k_shard
                   for st in state)
        assert specs[k] == ((mesh.dim("tp"), mesh.dim("dp") * k_shard),
                            ("tp", "dp"))
    assert all(int(st.count) == 2 for st in state)


@pytest.mark.parametrize("kw", [dict(donate=True),
                                dict(offload_state=True)])
def test_donate_and_offload_change_no_bits(kw):
    *_, shards, state, losses = port_run("adam", **kw)
    *_, want_shards, want_state, want_losses = port_run("adam")
    assert losses == want_losses
    for k in shards:
        for a, b in zip(shards[k], want_shards[k]):
            assert torch.equal(a, b), k
    for a, b in zip(state, want_state):
        for k in a.mu:
            assert torch.equal(a.mu[k], b.mu[k])
            assert torch.equal(a.nu[k], b.nu[k])


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="unknown optimizer"):
        tzs.make_zero_train_step(model_mesh(2, 2, device="cpu"),
                                 port_cfg({}, "dense"), optimizer="adamw")
    assert B * L * E == N_GLOBAL
