"""The port's resumable training loop against the JAX package's.

Loop parity: the reference writes a step-0 checkpoint of its
``init_params`` with its public ``ckpt.save``; both packages'
``train(resume=True, data="native")`` run 6 steps from copies of it
(the native loader's batches are equal in both, ``test_torch_io.py``).
On the CPU the reference's step takes ``attention_reference``, as the
port's "dense" path does.  Float32; the final params agree with rtol
1e-5 / atol 1e-6 (as in ``test_torch_train.py``), ``final_loss`` with
rtol 1e-5, and the Records' keys and verdicts are equal.  The port's
kill/resume is bit-exact; the guard's halt and skip-step Records match
the reference's; the kernel path (the plain versions of K3 and K4 on
CPU tensors) equals the dense path within rtol 1e-4 / atol 1e-6."""

import argparse
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_patterns import ckpt as jc
from tpu_patterns import cli as jcli
from tpu_patterns import faults as jf
from tpu_patterns.core.results import ResultWriter as JWriter
from tpu_patterns.models import train_loop as jtl
from tpu_patterns.models import transformer as jtr
from tpu_patterns_torch import ckpt as tc
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch import faults as tf
from tpu_patterns_torch.core.results import ResultWriter as TWriter
from tpu_patterns_torch.models import train_loop as ttl

from test_torch_io import reference_loader  # noqa: F401 - autouse fixture

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

BASE = dict(embed=32, heads=4, head_dim=8, seq=32, batch=2, dtype="float32",
            lr=1e-2)


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in (jf, tf):
        pkg.configure("")
    yield
    for pkg in (jf, tf):
        pkg.configure(None)


@pytest.fixture(scope="module")
def mesh(devices):
    return Mesh(np.array(devices[:1]).reshape(1, 1, 1), ("dp", "sp", "tp"))


def _records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _run_ref(mesh, tmp, **kw):
    jsonl = tmp / "ref.jsonl"
    jsonl.unlink(missing_ok=True)  # this run's Records only
    out = jtl.train(mesh, jtl.TrainLoopConfig(**{**BASE, **kw}),
                    JWriter(jsonl_path=jsonl))
    return out, _records(jsonl)


def _run_port(tmp, **kw):
    jsonl = tmp / "port.jsonl"
    jsonl.unlink(missing_ok=True)
    out = ttl.train(ttl.TrainLoopConfig(**{**BASE, **kw}),
                    TWriter(jsonl_path=jsonl), device="cpu")
    return out, _records(jsonl)


def _shape(recs):
    """What must agree between the packages' Records: pattern, mode,
    commands, verdict, notes and metric keys, in order."""
    return [(r["pattern"], r["mode"], r["commands"], r["verdict"],
             r["notes"], sorted(r["metrics"])) for r in recs]


def _step0_checkpoint(mesh, root, depth):
    """The reference's init_params (seed 0) and step 0, saved by the
    reference's public ckpt.save."""
    mcfg = jtl._model_cfg(jtl.TrainLoopConfig(**BASE, depth=depth))
    params = jtr.shard_params(jtr.init_params(jax.random.key(0), mcfg),
                              mesh, mcfg)
    jc.save(str(root), 0, {"params": params,
                           "step": jnp.zeros((), jnp.int32)})


@pytest.mark.parametrize("depth", [1, 2])
def test_loop_matches_reference_from_its_checkpoint(mesh, tmp_path, depth):
    _step0_checkpoint(mesh, tmp_path / "init", depth)
    for d in ("ref", "port"):
        shutil.copytree(tmp_path / "init", tmp_path / d)
    kw = dict(depth=depth, steps=6, resume=True, data="native",
              ckpt_every=2, log_every=2)
    ref, ref_recs = _run_ref(mesh, tmp_path, ckpt_dir=str(tmp_path / "ref"),
                             **kw)
    got, got_recs = _run_port(tmp_path, ckpt_dir=str(tmp_path / "port"),
                              **kw)
    assert got["start_step"] == ref["start_step"] == 0
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    assert int(got["state"]["step"]) == int(np.asarray(ref["state"]["step"]))
    want = {k: np.asarray(v) for k, v in ref["state"]["params"].items()}
    assert set(got["state"]["params"]) == set(want)
    for k, v in got["state"]["params"].items():
        assert tuple(v.shape) == want[k].shape, k
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert _shape(got_recs) == _shape(ref_recs)
    assert [r["pattern"] for r in got_recs] == ["train_step"] * 3 + ["train"]
    np.testing.assert_allclose(got_recs[-1]["metrics"]["final_loss"],
                               ref_recs[-1]["metrics"]["final_loss"],
                               rtol=1e-5)
    # both committed the same steps, in one format: each reads the other's
    assert tc.available_steps(str(tmp_path / "port")) == jc.available_steps(
        str(tmp_path / "ref")) == [4, 6]
    assert jc.describe(str(tmp_path / "port"))["steps"][-1]["leaves"] == [
        {**leaf, "spec": [None] * len(leaf["shape"])}
        for leaf in jc.describe(str(tmp_path / "ref"))["steps"][-1]["leaves"]
    ]
    back = jc.restore(str(tmp_path / "port"), ref["state"])
    for k, v in back["params"].items():
        np.testing.assert_array_equal(np.asarray(v),
                                      got["state"]["params"][k].numpy())


def _bit_equal(a, b):
    assert set(a["params"]) == set(b["params"])
    for k in a["params"]:
        assert torch.equal(a["params"][k].view(torch.int32),
                           b["params"][k].view(torch.int32)), k
    assert int(a["step"]) == int(b["step"])


@pytest.mark.parametrize("kw", [
    dict(data="native"),
    dict(data="synthetic", ckpt_async=True),
    dict(data="synthetic", depth=2, attn="kernel"),
])
def test_kill_and_resume_is_bit_exact(tmp_path, kw):
    kw = dict(kw, ckpt_every=2)
    ref, _ = _run_port(tmp_path, steps=6, ckpt_dir=str(tmp_path / "a"), **kw)
    _run_port(tmp_path, steps=4, ckpt_dir=str(tmp_path / "b"), **kw)
    res, recs = _run_port(tmp_path, steps=6, resume=True,
                          ckpt_dir=str(tmp_path / "b"), **kw)
    assert res["start_step"] == 4
    assert np.isfinite(res["loss"]) and res["loss"] == ref["loss"]
    _bit_equal(ref["state"], res["state"])
    assert recs[-1]["metrics"]["resumed_from"] == 4.0
    assert tc.available_steps(str(tmp_path / "b")) == [4, 6]


def test_training_moves_params_and_streams_differ(tmp_path):
    a, _ = _run_port(tmp_path, steps=2)
    b, _ = _run_port(tmp_path, steps=2, data="native")
    c, _ = _run_port(tmp_path, steps=2)
    assert int(a["state"]["step"]) == 2 and np.isfinite(a["loss"])
    assert a["loss"] != b["loss"]
    _bit_equal(a["state"], c["state"])
    init = ttl.init_params(torch.Generator().manual_seed(0),
                           ttl._model_cfg(ttl.TrainLoopConfig(**BASE)))
    assert not torch.equal(init["w1"][0], a["state"]["params"]["w1"])


def test_fresh_run_into_used_dir_refused(tmp_path):
    _run_port(tmp_path, steps=2, ckpt_dir=str(tmp_path / "ck"),
              ckpt_every=2)
    with pytest.raises(ValueError, match="already holds committed"):
        _run_port(tmp_path, steps=2, ckpt_dir=str(tmp_path / "ck"))


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    out, _ = _run_port(tmp_path, steps=2, resume=True,
                       ckpt_dir=str(tmp_path / "ck"))
    assert out["start_step"] == 0 and np.isfinite(out["loss"])


def test_noop_resume_matches_reference(mesh, tmp_path):
    _run_port(tmp_path, steps=2, ckpt_dir=str(tmp_path / "p"), ckpt_every=2)
    jtl.train(mesh, jtl.TrainLoopConfig(**BASE, steps=2, ckpt_every=2,
                                        ckpt_dir=str(tmp_path / "r")))
    got, got_recs = _run_port(tmp_path, steps=2, resume=True,
                              ckpt_dir=str(tmp_path / "p"))
    ref, ref_recs = _run_ref(mesh, tmp_path, steps=2, resume=True,
                             ckpt_dir=str(tmp_path / "r"))
    assert got["loss"] is None and ref["loss"] is None
    assert got["start_step"] == ref["start_step"] == 2
    assert _shape(got_recs) == _shape(ref_recs)
    assert got_recs[-1]["verdict"] == "SUCCESS"
    assert got_recs[-1]["metrics"]["steps_per_s"] == 0.0


@pytest.mark.parametrize("nonfinite,every", [("halt", 1), ("skip-step", 0)])
def test_guard_records_match_reference(mesh, tmp_path, nonfinite, every):
    kw = dict(steps=4, nonfinite=nonfinite, nonfinite_every=every,
              ckpt_every=2, log_every=2)
    jf.configure("train.step:nan:step=2")
    ref, ref_recs = _run_ref(mesh, tmp_path, ckpt_dir=str(tmp_path / "r"),
                             **kw)
    tf.configure("train.step:nan:step=2")
    got, got_recs = _run_port(tmp_path, ckpt_dir=str(tmp_path / "p"), **kw)
    assert _shape(got_recs) == _shape(ref_recs)
    assert tc.available_steps(str(tmp_path / "p")) == jc.available_steps(
        str(tmp_path / "r"))
    warn = [r for r in got_recs if r["mode"] == "nonfinite"]
    assert len(warn) == 1 and warn[0]["metrics"]["step"] == 2.0
    if nonfinite == "halt":
        assert not np.isfinite(got["loss"])
        assert got_recs[-1]["verdict"] == "FAILURE"
        assert any("halted at step 2" in n for n in got_recs[-1]["notes"])
        # nothing past the halt is committed
        assert tc.available_steps(str(tmp_path / "p")) == [2]
    else:
        assert np.isfinite(got["loss"])
        assert got_recs[-1]["verdict"] == "SUCCESS"
        assert tc.available_steps(str(tmp_path / "p")) == [2, 4]


def test_skip_step_reverts_exactly_the_poisoned_step(tmp_path):
    """skip-step keeps the pre-step params, consumes the batch and
    advances the step: the run equals one that skipped that update."""
    tf.configure("train.step:nan:step=1")
    got, _ = _run_port(tmp_path, steps=2, nonfinite="skip-step")
    tf.configure("")
    once, _ = _run_port(tmp_path, steps=1)
    for k, v in got["state"]["params"].items():
        assert torch.equal(v, once["state"]["params"][k]), k
    assert int(got["state"]["step"]) == 2


def test_thinned_check_is_forced_before_checkpoint(tmp_path):
    tf.configure("train.step:nan:step=1")
    out, recs = _run_port(tmp_path, steps=4, nonfinite_every=4,
                          ckpt_every=2, ckpt_dir=str(tmp_path / "ck"))
    assert recs[-1]["verdict"] == "FAILURE"
    assert tc.available_steps(str(tmp_path / "ck")) == []


@pytest.mark.parametrize("kw,match", [
    (dict(nonfinite="wish-harder"), "nonfinite"),
    (dict(nonfinite="skip-step", nonfinite_every=4), "nonfinite_every=1"),
    (dict(data="files"), "data source"),
    (dict(attn="pallas"), "attn"),
    (dict(optimizer="adamw"), "optimizer"),
])
def test_bad_config_raises(tmp_path, kw, match):
    with pytest.raises(ValueError, match=match):
        _run_port(tmp_path, steps=1, **kw)


@pytest.mark.parametrize("kw", [dict(optimizer="zero-sgd"),
                                dict(optimizer="zero-adam"), dict(moe=True),
                                dict(remat=True, remat_policy="dots")])
def test_unported_options_refused(tmp_path, kw):
    # the ZeRO optimizers, moe and the dots policy are ported now: each
    # trains, its final Record SUCCESS
    out, recs = _run_port(tmp_path, steps=2, **kw)
    assert np.isfinite(out["loss"])
    assert recs[-1]["verdict"] == "SUCCESS" and recs[-1]["mode"] == (
        kw.get("optimizer", "sgd"))


def test_kernel_path_equals_dense(tmp_path):
    """attn="kernel" on CPU tensors runs the plain K3/K4; 4 steps at
    depth 2 agree with the dense path within rtol 1e-4 / atol 1e-6."""
    dense, _ = _run_port(tmp_path, steps=4, depth=2, attn="dense")
    kern, _ = _run_port(tmp_path, steps=4, depth=2, attn="kernel")
    np.testing.assert_allclose(kern["loss"], dense["loss"], rtol=1e-4)
    for k, v in kern["state"]["params"].items():
        np.testing.assert_allclose(v.numpy(),
                                   dense["state"]["params"][k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_xla_reads_as_dense(tmp_path):
    a, _ = _run_port(tmp_path, steps=2, attn="xla")
    b, _ = _run_port(tmp_path, steps=2, attn="dense")
    _bit_equal(a["state"], b["state"])


def test_log_every_emits_step_records(tmp_path):
    _, recs = _run_port(tmp_path, steps=4, log_every=2)
    steps = [r for r in recs if r["pattern"] == "train_step"]
    assert [int(r["metrics"]["step"]) for r in steps] == [2, 4]
    final = recs[-1]
    assert final["pattern"] == "train"
    assert set(final["metrics"]) == {"steps_per_s", "tokens_per_s",
                                     "model_tflops_per_s", "resumed_from",
                                     "final_loss"}
    assert final["metrics"]["steps_per_s"] > 0


def _train_flags(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {a.dest for a in sub.choices["train"]._actions
            if a.dest != "help"}


def test_cli_takes_or_refuses_every_reference_train_flag():
    ref = _train_flags(jcli.build_parser())
    port = _train_flags(tcli.build_parser())
    assert port - ref == {"device"}
    assert ref <= port
    assert {f.name for f in dataclasses.fields(ttl.TrainLoopConfig)} == (
        port - set(tcli._MESH_FLAGS) - {"device"})


@pytest.mark.parametrize("argv", [
    ["--devices", "x"], ["--dp", "two"], ["--tp", "1.5"],
    ["--moe", "maybe"], ["--remat_policy", "dots", "--remat", "perhaps"],
    ["--attn", "pallas"], ["--data", "files"], ["--nonfinite", "maybe"],
])
def test_cli_refusals(argv):
    with pytest.raises(SystemExit) as e:
        tcli.main(["train", "--device", "cpu", *argv])
    assert e.value.code == 2


def test_cli_train_then_ckpt(tmp_path, capsys):
    root = str(tmp_path / "ck")
    argv = ["train", "--device", "cpu", "--embed", "32", "--heads", "4",
            "--head_dim", "8", "--seq", "32", "--batch", "2", "--steps", "4",
            "--ckpt_dir", root, "--ckpt_every", "2", "--attn", "kernel",
            "--data", "native"]
    assert tcli.main(argv) == 0
    out = capsys.readouterr().out
    assert "## sgd | steps=4 resume_from=0 | SUCCESS" in out
    assert tcli.main(["ckpt", root]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "step_2: 0.05 MB, 1 process(es), 5 leaves",
        "step_4: 0.05 MB, 1 process(es), 5 leaves",
        "latest: step_4",
    ]
    # a halted run exits nonzero: the exit code is the verdict
    tf.configure("train.step:nan:step=1")
    assert tcli.main(argv[:15] + ["--nonfinite_every", "1"]) == 1
