"""The port's pipelined stack (``models/pipeline_step.py``) over a
(1, 2, 2, 2) dp x sp x tp x pp rank mesh against the JAX package's
``make_pipeline_train_step`` on the conftest's 8 CPU devices.

The reference's stack (its ``init_stack_params``, handed over as numpy
by ``convert.stack_params_from_jax``) and one seeded numpy batch go
through both packages; the reference runs ``attn="xla"``, the port
"dense" and "kernel".  The objective is the reference's unnormalised
sum of squares over 2 microbatches.  Float32: loss rtol 1e-5; the
updated stack after one step at lr 1e-3 within atol 1e-6; GPipe and
1F1B in the port within atol 1e-6 of each other (lr 1.0, so the
updates carry the grads whole); the loss equal to the sequential
stack's."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_patterns.models import transformer as jtr
from tpu_patterns_torch.comm.mesh import model_mesh
from tpu_patterns_torch.convert import params_to_numpy, stack_params_from_jax
from tpu_patterns_torch.models import pipeline_step as tps
from tpu_patterns_torch.models import transformer as ttr

from test_torch_model_mesh import D, E, H, batch, jmesh, port_cfg

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

SHAPE = (1, 2, 2, 2)
AXES4 = ("dp", "sp", "tp", "pp")
N_MICRO = 2
LR = 1e-3


@functools.lru_cache(maxsize=None)
def reference(schedule, moe):
    jcfg = jtr.ModelConfig(embed=E, heads=H, head_dim=D, moe=moe)
    mesh = jmesh(SHAPE, AXES4)
    stack = jtr.init_stack_params(jax.random.key(9), jcfg, SHAPE[3],
                                  n_experts=SHAPE[2] if moe else 0)
    step, pspecs = jtr.make_pipeline_train_step(mesh, jcfg, N_MICRO, lr=LR,
                                                schedule=schedule)
    p = {k: jax.device_put(v, NamedSharding(mesh, pspecs[k]))
         for k, v in stack.items()}
    sx = jax.device_put(jnp.asarray(batch()),
                        NamedSharding(mesh, P("dp", "sp", None)))
    new, loss = step(p, sx)
    return ({k: np.asarray(v) for k, v in stack.items()},
            {k: np.asarray(v) for k, v in new.items()}, float(loss))


def port_step(flat, schedule, attn, moe, lr=LR):
    cfg = port_cfg(dict(moe=moe), attn)
    mesh = model_mesh(8, SHAPE[0], SHAPE[2], pp=SHAPE[3], device="cpu")
    stack = stack_params_from_jax(flat, cfg)
    sharded = ttr.shard_params(stack, mesh, cfg, lead="pp")
    xs = mesh.shard(torch.from_numpy(batch()), ("dp", "sp", None))
    step = tps.make_pipeline_train_step(mesh, cfg, N_MICRO, lr=lr,
                                        schedule=schedule)
    new, loss = step(sharded, xs)
    scfg = dataclasses.replace(cfg, depth=SHAPE[3])
    got = params_to_numpy(ttr.gather_params(new, mesh, scfg, lead="pp"),
                          scfg)
    return got, float(loss), stack, cfg


@pytest.mark.parametrize("attn", ["dense", "kernel"])
@pytest.mark.parametrize("schedule,moe", [("gpipe", False), ("1f1b", False),
                                          ("gpipe", True)])
def test_pipeline_step_matches_reference(schedule, moe, attn):
    flat, want, want_loss = reference(schedule, moe)
    got, loss, _, _ = port_step(flat, schedule, attn, moe)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_schedules_agree_and_loss_is_the_sequential_stacks():
    flat, _, _ = reference("gpipe", False)
    a, la, stack, cfg = port_step(flat, "gpipe", "kernel", False, lr=1.0)
    b, lb, _, _ = port_step(flat, "1f1b", "kernel", False, lr=1.0)
    np.testing.assert_allclose(la, lb, rtol=1e-5)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    z = ttr.forward_stack(stack, torch.from_numpy(batch()), cfg)
    np.testing.assert_allclose(la, float((z.float() ** 2).sum()),
                               rtol=1e-5)


def test_depth_is_refused():
    mesh = model_mesh(8, 1, 2, pp=2, device="cpu")
    with pytest.raises(ValueError, match="single blocks"):
        tps.make_pipeline_train_step(mesh, port_cfg(dict(depth=2), "dense"),
                                     N_MICRO)
