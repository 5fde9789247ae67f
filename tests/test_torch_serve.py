"""The port's continuous-batching engine against the JAX package's.

One trace, one set of weights (made by the reference, handed over as
numpy): the reference ``ServeEngine`` on a (1, 1, 1) CPU mesh and the
port's ``ServeEngine`` on the CPU must retire identical per-request ids
with equal scheduler stats and no leaked block, for MHA and GQA, float32
and int8 pools, a pool small enough to defer, and both port attention
paths (the dense gather and the kernel's plain version)."""

import argparse
import ast
import functools
import inspect

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from tpu_patterns import cli as jcli
from tpu_patterns.models.lm import init_lm_params as j_init_lm_params
from tpu_patterns.models.transformer import ModelConfig as JModelConfig
from tpu_patterns.serve import engine as jengine
from tpu_patterns.serve import Request as JRequest
from tpu_patterns.serve import ServeEngine as JServeEngine
from tpu_patterns.serve import make_paged_lm_decoder as j_make_decoder
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch.convert import params_from_jax
from tpu_patterns_torch.models.transformer import ModelConfig
from tpu_patterns_torch.serve.engine import (
    Request,
    ServeConfig,
    ServeEngine,
    run_serve,
)
from tpu_patterns_torch.serve.paged import make_paged_lm_decoder

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

VOCAB = 64
MODEL = dict(embed=64, heads=8, head_dim=8, dtype="float32", depth=2,
             rope=True)
# name -> (kv_heads, cache_int8, n_blocks): 17 blocks never defer for
# this trace; 7 blocks force deferrals (a request needs up to 4)
CONFIGS = {
    "mha_f32": (0, False, 17),
    "gqa_f32": (2, False, 17),
    "gqa_int8": (2, True, 17),
    "mha_defer": (0, False, 7),
}


def _trace():
    rng = np.random.RandomState(11)
    return [
        (i, rng.randint(0, VOCAB, size=rng.randint(3, 21)).tolist())
        for i in range(6)
    ]


@functools.lru_cache(maxsize=None)
def _flat(kv_heads):
    jcfg = JModelConfig(**MODEL, kv_heads=kv_heads)
    return {
        k: np.asarray(v)
        for k, v in j_init_lm_params(jax.random.key(0), jcfg, VOCAB).items()
    }


@functools.lru_cache(maxsize=None)
def _reference(name):
    kv_heads, int8, n_blocks = CONFIGS[name]
    devices = jax.devices()
    mesh = Mesh(np.array(devices[:1]).reshape(1, 1, 1), ("dp", "sp", "tp"))
    jcfg = JModelConfig(**MODEL, kv_heads=kv_heads)
    dec = j_make_decoder(
        mesh, jcfg, VOCAB, n_blocks=n_blocks, block_len=8, max_len=40,
        cache_int8=int8, attn="dense",
    )
    params = dec.stack_params(_flat(kv_heads))
    eng = JServeEngine(dec, params, slots=4)
    out = eng.run([JRequest(rid=i, tokens=t, n_gen=6) for i, t in _trace()])
    assert not eng.failed and eng.leaked_blocks() == 0
    return out, {k: eng.stats[k] for k in ("steps", "deferrals", "tokens")}


def _port(name, attn, slots=4):
    kv_heads, int8, n_blocks = CONFIGS[name]
    cfg = ModelConfig(**MODEL, kv_heads=kv_heads)
    dec = make_paged_lm_decoder(
        cfg, VOCAB, n_blocks=n_blocks, block_len=8, max_len=40,
        cache_int8=int8, attn=attn, device="cpu",
    )
    params = dec.stack_params(params_from_jax(_flat(kv_heads), cfg))
    eng = ServeEngine(dec, params, slots=slots)
    out = eng.run([Request(rid=i, tokens=t, n_gen=6) for i, t in _trace()])
    assert eng.leaked_blocks() == 0 and not eng.active and not eng.queue
    return out, eng


@pytest.mark.parametrize("attn", ["dense", "kernel"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_matches_reference(name, attn):
    want_out, want_stats = _reference(name)
    out, eng = _port(name, attn)
    assert out == want_out
    assert {k: eng.stats[k] for k in want_stats} == want_stats
    if name == "mha_defer":
        assert eng.stats["deferrals"] > 0


def test_continuous_equals_sequential():
    cont, _ = _port("gqa_int8", "kernel", slots=4)
    seq, eng = _port("gqa_int8", "kernel", slots=1)
    assert cont == seq
    assert eng.stats["steps"] > 0


def _reference_metric_keys():
    """The metric keys of the reference ``run_serve`` Record, read from
    its source (the dict literal passed as ``metrics=``)."""
    tree = ast.parse(inspect.getsource(jengine.run_serve))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == (
            "Record"
        ):
            for kw in node.keywords:
                if kw.arg == "metrics":
                    return {k.value for k in kw.value.keys}
    raise AssertionError("no Record(metrics=...) in the reference run_serve")


def test_run_serve_cpu_record():
    # the speedup gate compares two short wall-clock runs: on a loaded
    # CPU host that is a race, so it is off here (min_speedup 0) and held
    # on the card by chip_smoke.py's serve legs
    cfg = ServeConfig(
        vocab=VOCAB, embed=32, heads=4, head_dim=8, depth=1, requests=16,
        min_prompt=4, max_prompt=24, gen=6, slots=8, block_len=8,
        min_speedup=0.0, device="cpu",
    )
    rec, = run_serve(cfg)
    assert rec.verdict.value == "SUCCESS", rec.notes
    assert set(rec.metrics) == _reference_metric_keys()
    assert rec.metrics["speedup"] > 0
    assert rec.metrics["exact"] == 1.0
    assert rec.metrics["cache_MB"] < rec.metrics["dense_cache_MB"]
    assert rec.metrics["alias_MB"] == rec.metrics["cache_MB"]


def _serve_flags(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {a.dest for a in sub.choices["serve"]._actions
            if a.dest != "help"}


def test_cli_takes_or_refuses_every_reference_serve_flag():
    """Each flag of the reference's ``serve`` is a port flag, parsed as
    the reference parses it (the disaggregated split's two, refused until
    it was ported, included); the port adds only ``--device``."""
    ref = _serve_flags(jcli.build_parser())
    port = _serve_flags(tcli.build_parser())
    assert port - ref == {"device"}
    assert ref <= port
    # speculative decoding and prefix sharing are taken
    args = tcli.build_parser().parse_args(
        ["serve", "--spec_k", "4", "--min_accepted", "1.5",
         "--prefix_share", "true", "--shared_prefix", "16",
         "--min_block_savings", "0.25"])
    assert (args.spec_k, args.min_accepted, args.prefix_share,
            args.shared_prefix, args.min_block_savings) == (
        4, 1.5, True, 16, 0.25)
    # the load generator's bridge and the burn monitor's flags are taken
    moved = {"scenario": "chat:requests=4", "time_scale": "0.5",
             "burn_mitigation": "spec_off", "slo_fast_s": "30",
             "slo_slow_s": "120", "slo_budget": "0.2",
             "burn_multiplier": "3"}
    argv = ["serve"]
    for name, value in moved.items():
        argv += [f"--{name}", value]
    args = tcli.build_parser().parse_args(argv)
    assert (args.scenario, args.time_scale, args.burn_mitigation,
            args.slo_fast_s, args.slo_slow_s, args.slo_budget,
            args.burn_multiplier) == ("chat:requests=4", 0.5, "spec_off",
                                      30.0, 120.0, 0.2, 3.0)
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["serve", "--burn_mitigation", "x"])
    # the replica fleet's flags, the disaggregated split's included, are
    # taken and parse as the reference's
    fleet = {"replicas": "2", "replica_policy": "round_robin",
             "route_blocks": "3", "min_replica_speedup": "0",
             "replica_watchdog_s": "30", "replica_dir": "w",
             "prefix_store": "st", "elastic_reserve": "1",
             "scale_out_occupancy": "1.1", "scale_in_occupancy": "0.1",
             "scale_sustain_s": "0.2", "scale_cooldown_s": "0.5",
             "min_live_replicas": "1", "disagg": "1:1",
             "min_ttft_improvement": "1.05"}
    argv = ["serve"]
    for name, value in fleet.items():
        argv += [f"--{name}", value]
    got = vars(tcli.build_parser().parse_args(argv))
    want = vars(jcli.build_parser().parse_args(argv))
    assert {k: got[k] for k in fleet} == {k: want[k] for k in fleet}


def test_cli_takes_or_refuses_every_reference_loadgen_flag():
    """Each flag of the reference's ``loadgen`` is a port flag, the mesh
    flags included (a dp other than 1 then refused with the reference's
    message); the port adds only ``--device``."""
    def flags(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {a.dest for a in sub.choices["loadgen"]._actions
                if a.dest != "help"}

    ref = flags(jcli.build_parser())
    port = flags(tcli.build_parser())
    assert port - ref == {"device"}
    assert ref <= port
    args = tcli.build_parser().parse_args(
        ["loadgen", "--devices", "4", "--dp", "1", "--tp", "2"])
    assert (args.devices, args.dp, args.tp) == (4, 1, 2)
    with pytest.raises(SystemExit, match="loadgen requires --dp 1"):
        tcli.main(["loadgen", "--device", "cpu", "--dp", "2"])
