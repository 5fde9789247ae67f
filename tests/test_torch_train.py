"""The port's one-device train step against the JAX package's.

The reference's ``make_train_step`` runs on a (1, 1, 1) CPU mesh; the
port's on CPU tensors, from the same params (made by the reference,
handed over as numpy) and the same input.  On the CPU the reference's
``forward_shard`` takes ``attention_reference`` for both of its attn
values (transformer.py:350 and :359: the fused path is TPU-only), so
one reference step serves as the oracle for both port paths: "dense"
(attention_reference) and "kernel" (the flash kernels' plain versions,
K3 forward and K4 backward).  Float32 throughout; loss rtol 1e-5,
updated params (lr 1e-2) rtol 1e-5 / atol 1e-6."""

import argparse
import ast
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_patterns import cli as jcli
from tpu_patterns.models import transformer as jtr
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch.convert import block_params_from_jax, params_to_numpy
from tpu_patterns_torch.models import flagship as tfl
from tpu_patterns_torch.models import transformer as ttr

B, L, E = 2, 32, 32
LR = 1e-2
BASE = dict(embed=E, heads=4, head_dim=16, mlp_mult=2, dtype="float32")
# name -> extra config: depth 1 and 2, GQA with RoPE, remat full
CONFIGS = {
    "d1": dict(depth=1),
    "d2": dict(depth=2),
    "gqa_rope": dict(depth=2, kv_heads=2, rope=True),
    "remat": dict(depth=2, remat=True),
}


def _x():
    return np.random.RandomState(3).randn(B, L, E).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(params as numpy, new params as numpy, loss) of one reference
    step; ``attn="pallas"`` takes attention_reference on the CPU."""
    jcfg = jtr.ModelConfig(**BASE, **CONFIGS[name], attn="pallas",
                           block_q=16, block_k=16)
    params = jtr.init_params(jax.random.key(5), jcfg)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))
    step, _ = jtr.make_train_step(mesh, jcfg, lr=LR)
    sx = jax.device_put(jnp.asarray(_x()),
                        NamedSharding(mesh, P("dp", "sp", None)))
    new, loss = step(jtr.shard_params(params, mesh, jcfg), sx)
    flat = {k: np.asarray(v) for k, v in params.items()}
    return flat, {k: np.asarray(v) for k, v in new.items()}, float(loss)


@pytest.mark.parametrize("attn", ["dense", "kernel"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_step_matches_reference(name, attn):
    flat, want_new, want_loss = _reference(name)
    cfg = ttr.ModelConfig(**BASE, **CONFIGS[name], attn=attn, block_q=16,
                          block_k=16)
    params = block_params_from_jax(flat, cfg)
    step = ttr.make_train_step(cfg, lr=LR)
    new, loss = step(params, torch.from_numpy(_x()))
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = params_to_numpy(new, cfg)
    assert set(got) == set(want_new)
    for k in got:
        np.testing.assert_allclose(got[k], want_new[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert step.calls == 1


def test_forward_no_grad_kernel_matches_reference_forward():
    """forward_shard without a gradient (the kernel path's K2) against
    the reference's forward_shard, one block."""
    flat, _, _ = _reference("d1")
    cfg = ttr.ModelConfig(**BASE, attn="kernel", block_q=16, block_k=16)
    jcfg = jtr.ModelConfig(**BASE, block_q=16, block_k=16)
    want = jtr.forward_shard({k: jnp.asarray(v) for k, v in flat.items()},
                             jnp.asarray(_x()), jcfg)
    params = block_params_from_jax(flat, cfg)
    with torch.no_grad():
        got = ttr.forward_shard({k: p[0] for k, p in params.items()},
                                torch.from_numpy(_x()), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)


@pytest.mark.parametrize("kw", [
    dict(), dict(causal=False), dict(kv_heads=2), dict(remat=True),
    dict(depth=3, remat=True, remat_policy="dots"),
])
def test_flagship_flops_match_reference(kw):
    j = jtr.FlagshipConfig(**kw)
    t = tfl.FlagshipConfig(**kw)
    assert tfl.flagship_flops(t) == jtr.flagship_flops(j)


def _reference_metric_keys() -> set[str]:
    """The literal keys of the reference run_flagship's metrics dict
    (its ``**mem`` spread is the compiled-memory analysis, absent on the
    CPU)."""
    tree = ast.parse(inspect.getsource(jtr.run_flagship))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "Record":
            for kw in node.keywords:
                if kw.arg == "metrics":
                    return {k.value for k in kw.value.keys if k is not None}
    raise AssertionError("no Record(metrics=...) in the reference")


def test_run_flagship_cpu_record():
    cfg = tfl.FlagshipConfig(embed=E, heads=4, head_dim=16, seq=L, batch=B,
                             dtype="float32", block_q=16, block_k=16,
                             depth=2, reps=2, warmup=1, device="cpu")
    rec, = tfl.run_flagship(cfg)
    assert rec.verdict.value == "SUCCESS", rec.notes
    assert set(rec.metrics) == _reference_metric_keys()
    assert rec.metrics["checksum_ok"] == 1.0
    assert rec.metrics["flops"] == tfl.flagship_flops(cfg)
    assert rec.config["device_kind"] == "cpu"
    # one memory-free gate step pair + warmup 1 + reps 2 chains of 2
    assert rec.config["train_steps"] == 2 + (1 + 2) * 2


@pytest.mark.parametrize("kw,err", [
    (dict(attn_layout="striped"), NotImplementedError),
    (dict(remat_policy="dots"), NotImplementedError),
    (dict(moe=True), NotImplementedError),
    (dict(attn="pallas"), ValueError),
    (dict(attn_grid="sparse"), ValueError),
])
def test_model_config_refuses_unported(kw, err):
    with pytest.raises(err):
        ttr.ModelConfig(**kw)


def _flagship_flags(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {a.dest for a in sub.choices["flagship"]._actions
            if a.dest != "help"}


def test_cli_takes_or_refuses_every_reference_flagship_flag():
    """Each flag of the reference's ``flagship`` is a port flag or is
    refused with a message; the port adds only ``--device``; unported
    values are refused too."""
    ref = _flagship_flags(jcli.build_parser())
    port = _flagship_flags(tcli.build_parser())
    assert port - ref == {"device"}
    assert ref <= port
    assert {f.name for f in dataclasses.fields(tfl.FlagshipConfig)} == (
        port - set(tcli._NOT_PORTED_FLAGSHIP))
    for argv in (["--devices", "1"], ["--dp", "1"], ["--tp", "1"],
                 ["--attn", "pallas"], ["--moe", "true"],
                 ["--optimizer", "zero-adam"], ["--attn_layout", "striped"],
                 ["--remat_policy", "dots"]):
        with pytest.raises(SystemExit):
            tcli.main(["flagship", "--device", "cpu", *argv])


def test_flagship_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tfl.run_flagship(tfl.FlagshipConfig()),
                 lambda: tcli.main(["flagship"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
