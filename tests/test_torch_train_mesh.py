"""The port's resumable train loop on a rank mesh against the JAX
package's on a device mesh, and its sharded checkpoints.

Cross-package parity: both packages' ``train`` run 4 steps at the
reference's test shapes (E 64, H 8, D 8, B 4, L 32, lr 1e-2) on a
(2, 2, 2) mesh with ``data="native"`` (the native loader's batches are
equal in both, ``test_torch_io.py``), each from its own seed-0 init
handed over as the reference's step-0 checkpoint; the final params
agree within rtol 1e-5 / atol 1e-6 and the losses within rtol 1e-5.
The port's checkpoint holds each distinct block once with its index
and the reference's spec, and the reference's ``restore`` reads it.
Resume: killed at step 4 and resumed to 6 on the same mesh the run is
bit-exact with a straight one (SGD and ZeRO-adam); resumed on another
mesh (SGD (2, 2, 2) -> (4, 2, 1); ZeRO-adam (2, 2, 1) -> (1, 4, 1)) the
params are within atol 1e-5 of the straight run's."""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_patterns import ckpt as jc
from tpu_patterns.models import train_loop as jtl
from tpu_patterns.models import transformer as jtr
from tpu_patterns_torch import ckpt as tc
from tpu_patterns_torch.comm.mesh import model_mesh
from tpu_patterns_torch.convert import params_to_numpy
from tpu_patterns_torch.models import train_loop as ttl

from test_torch_io import reference_loader  # noqa: F401 - autouse fixture
from test_torch_model_mesh import jmesh

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

BASE = dict(embed=64, heads=8, head_dim=8, seq=32, batch=4, dtype="float32",
            lr=1e-2)


def port(tmp, shape=(2, 2, 2), **kw):
    cfg = ttl.TrainLoopConfig(**{**BASE, "ckpt_dir": str(tmp), **kw})
    return ttl.train(cfg, mesh=model_mesh(int(np.prod(shape)), shape[0],
                                          shape[2], device="cpu"))


def _bit_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), k


def test_loop_on_a_mesh_matches_reference(tmp_path):
    mesh = jmesh((2, 2, 2))
    mcfg = jtl._model_cfg(jtl.TrainLoopConfig(**BASE))
    init = jtr.shard_params(jtr.init_params(jax.random.key(0), mcfg), mesh,
                            mcfg)
    jc.save(str(tmp_path / "init"), 0,
            {"params": init, "step": jnp.zeros((), jnp.int32)})
    for d in ("ref", "port"):
        shutil.copytree(tmp_path / "init", tmp_path / d)
    kw = dict(steps=4, resume=True, data="native", ckpt_every=2)
    ref = jtl.train(mesh, jtl.TrainLoopConfig(
        **BASE, ckpt_dir=str(tmp_path / "ref"), **kw))
    got = port(tmp_path / "port", **kw)
    assert got["start_step"] == ref["start_step"] == 0
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    cfg = ttl._model_cfg(ttl.TrainLoopConfig(**BASE))
    have = params_to_numpy(got["params"], cfg)
    for k, v in ref["state"]["params"].items():
        np.testing.assert_allclose(have[k], np.asarray(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # the same leaf table, specs included; each distinct block once
    last = tc.describe(str(tmp_path / "port"))["steps"][-1]
    assert last["leaves"] == jc.describe(
        str(tmp_path / "ref"))["steps"][-1]["leaves"]
    with open(tmp_path / "port" / "step_4" / "shards_proc0.json") as f:
        table = json.load(f)
    by_leaf = {}
    for e in table:
        by_leaf.setdefault(e["leaf"], []).append(e["index"])
    keys = [leaf["key"] for leaf in last["leaves"]]
    wqkv = by_leaf[keys.index("['params']['wqkv']")]
    assert wqkv == [[[0, 3], [0, 64], [0, 4], [0, 8]],
                    [[0, 3], [0, 64], [4, 8], [0, 8]]]
    assert len(by_leaf[keys.index("['step']")]) == 1
    back = jc.restore(str(tmp_path / "port"), ref["state"])
    for k, v in back["params"].items():
        np.testing.assert_array_equal(np.asarray(v), have[k])


@pytest.mark.parametrize("optimizer", ["sgd", "zero-adam"])
def test_killed_run_resumes_bit_exact_on_the_same_mesh(tmp_path, optimizer):
    kw = dict(optimizer=optimizer, ckpt_every=2)
    ref = port(tmp_path / "a", steps=6, **kw)
    port(tmp_path / "b", steps=4, **kw)
    res = port(tmp_path / "b", steps=6, resume=True, **kw)
    assert res["start_step"] == 4
    assert np.isfinite(res["loss"]) and res["loss"] == ref["loss"]
    _bit_equal(ref["params"], res["params"])
    assert tc.available_steps(str(tmp_path / "b")) == [4, 6]


@pytest.mark.parametrize("optimizer,mesh_a,mesh_b", [
    ("sgd", (2, 2, 2), (4, 2, 1)),
    ("zero-adam", (2, 2, 1), (1, 4, 1)),
])
def test_resume_on_another_mesh(tmp_path, optimizer, mesh_a, mesh_b):
    kw = dict(optimizer=optimizer, ckpt_every=2)
    port(tmp_path / "run", mesh_a, steps=4, **kw)
    res = port(tmp_path / "run", mesh_b, steps=6, resume=True, **kw)
    assert res["start_step"] == 4 and np.isfinite(res["loss"])
    ref = port(tmp_path / "ref", mesh_a, steps=6, **kw)
    for k, want in ref["params"].items():
        np.testing.assert_allclose(res["params"][k].numpy(), want.numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    # the resumed state is mesh B's: its blocks are mesh B's shards
    key = "shards" if optimizer != "sgd" else "params"
    leaf = res["state"][key]["w1"]
    assert len(leaf.shards) == int(np.prod(mesh_b))


def test_zero_state_refuses_a_tp_change(tmp_path):
    kw = dict(optimizer="zero-sgd", ckpt_every=2)
    port(tmp_path / "run", (2, 2, 2), steps=2, **kw)
    with pytest.raises(ValueError, match="shape"):
        port(tmp_path / "run", (2, 4, 1), steps=4, resume=True, **kw)
