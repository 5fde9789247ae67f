"""tpu_patterns_torch stands alone: no JAX, nothing of tpu_patterns, no
``tabulate`` or ``optax`` (the machine with the card has neither), and
no quiet CPU run when CUDA is missing."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "tpu_patterns", "tabulate", "optax")


def _port_sources():
    return sorted((ROOT / "tpu_patterns_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"
    ]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_import_pulls_no_jax():
    code = (
        "import sys\n"
        "import tpu_patterns_torch.serve.engine, tpu_patterns_torch.cli\n"
        "import tpu_patterns_torch.concurrency\n"
        "import tpu_patterns_torch.miniapps, tpu_patterns_torch.comm.ring\n"
        "import tpu_patterns_torch.miniapps.apps.allreduce.pallas\n"
        "import tpu_patterns_torch.interop, tpu_patterns_torch.interop.kernel\n"
        "import tpu_patterns_torch.faults, tpu_patterns_torch.io\n"
        "import tpu_patterns_torch.ckpt, tpu_patterns_torch.models.train_loop\n"
        "import tpu_patterns_torch.topo, tpu_patterns_torch.topo.native\n"
        "import tpu_patterns_torch.comm.p2p, tpu_patterns_torch.core.config\n"
        "import tpu_patterns_torch.comm.hierarchical\n"
        "import tpu_patterns_torch.loadgen, tpu_patterns_torch.obs\n"
        "import tpu_patterns_torch.loadgen.runner\n"
        "import tpu_patterns_torch.obs.slo, tpu_patterns_torch.obs.cost\n"
        "import tpu_patterns_torch.models.prng\n"
        "import tpu_patterns_torch.models.decode, tpu_patterns_torch.models.lm\n"
        "import tpu_patterns_torch.serve.kvtier\n"
        "import tpu_patterns_torch.obs.spans, tpu_patterns_torch.obs.live\n"
        "import tpu_patterns_torch.obs.watchdog, tpu_patterns_torch.obs.export\n"
        "import tpu_patterns_torch.obs.decisions, tpu_patterns_torch.rt\n"
        "import tpu_patterns_torch.core.profile, tpu_patterns_torch.core.doctor\n"
        "import tpu_patterns_torch.core.ratchet, tpu_patterns_torch.perf\n"
        "import tpu_patterns_torch.perf.analytic, tpu_patterns_torch.perf.registry\n"
        "import tpu_patterns_torch.perf.baseline, tpu_patterns_torch.perf.history\n"
        "import tpu_patterns_torch.perf.report, tpu_patterns_torch.perf.provenance\n"
        "import tpu_patterns_torch.longctx.pattern\n"
        "import tpu_patterns_torch.longctx.ring_attention\n"
        "import tpu_patterns_torch.longctx.ulysses\n"
        "import tpu_patterns_torch.serve.replica\n"
        "import tpu_patterns_torch.serve.router, tpu_patterns_torch.serve.store\n"
        "import tpu_patterns_torch.serve.elastic, tpu_patterns_torch.obs.fleet\n"
        "import tpu_patterns_torch.exec.proc, tpu_patterns_torch.exec\n"
        "import tpu_patterns_torch.sweep, tpu_patterns_torch.exec.worker\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpu_patterns', 'tabulate')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from tpu_patterns_torch import cli
    from tpu_patterns_torch.comm.mesh import RankMesh, default_mesh
    from tpu_patterns_torch.comm.hierarchical import run_hierarchical
    from tpu_patterns_torch.comm.onesided import OneSidedConfig, run_onesided
    from tpu_patterns_torch.comm.p2p import run_p2p
    from tpu_patterns_torch.loadgen import LoadGenConfig, run_loadgen
    from tpu_patterns_torch.longctx.pattern import LongCtxConfig, run_longctx
    from tpu_patterns_torch.concurrency import (
        ConcurrencyConfig,
        run_concurrency,
    )
    from tpu_patterns_torch.miniapps import framework
    from tpu_patterns_torch.miniapps.apps.allreduce import (
        AllreduceConfig,
        run_allreduce,
    )
    from tpu_patterns_torch.models.decode import DecodeConfig, run_decode
    from tpu_patterns_torch.models.lm import LMConfig, init_lm_params, run_lm
    from tpu_patterns_torch.models.train_loop import TrainLoopConfig, train
    from tpu_patterns_torch.models.transformer import ModelConfig
    from tpu_patterns_torch.perf.registry import PerfConfig, capture
    from tpu_patterns_torch.runtime import resolve_device
    from tpu_patterns_torch.serve.engine import ServeConfig, run_serve
    from tpu_patterns_torch.serve.paged import make_paged_lm_decoder
    from tpu_patterns_torch.topo import bootstrap, discover, make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(embed=16, heads=2, head_dim=8)
    for call in (
        lambda: resolve_device(),
        lambda: resolve_device("cuda"),
        lambda: init_lm_params(0, cfg, 32),
        lambda: make_paged_lm_decoder(cfg, 32, n_blocks=4, block_len=8,
                                      max_len=16),
        lambda: run_serve(ServeConfig()),
        lambda: cli.main(["serve"]),
        lambda: run_onesided(OneSidedConfig(count=2048)),
        lambda: cli.main(["p2p", "--transport", "one_sided"]),
        lambda: cli.main(["p2p"]),
        lambda: run_concurrency(),
        lambda: run_concurrency(ConcurrencyConfig(backend="pallas",
                                                  mode="dma_overlap",
                                                  commands=("C D2D",))),
        lambda: cli.main(["concurrency"]),
        lambda: cli.main(["concurrency", "--backend", "pallas", "--mode",
                          "dma_serial", "--commands", "C D2D"]),
        lambda: default_mesh(4),
        lambda: framework.default_mesh(),
        lambda: framework.run_all(),
        lambda: run_allreduce(RankMesh(("cuda",) * 4), AllreduceConfig()),
        lambda: run_onesided(OneSidedConfig(count=2048),
                             mesh=RankMesh(("cuda:0", "cuda:0"))),
        lambda: cli.main(["allreduce", "--devices", "4"]),
        lambda: cli.main(["allreduce", "--variant", "pallas"]),
        lambda: cli.main(["miniapps"]),
        lambda: cli.main(["p2p", "--transport", "one_sided", "--devices",
                          "4"]),
        lambda: cli.main(["interop"]),
        lambda: run_longctx(cfg=LongCtxConfig()),
        lambda: cli.main(["longctx"]),
        lambda: cli.main(["longctx", "--devices", "4", "--strategy",
                          "ring_pallas"]),
        lambda: train(TrainLoopConfig()),
        lambda: train(TrainLoopConfig(attn="kernel", data="native")),
        lambda: cli.main(["train"]),
        lambda: discover(),
        lambda: make_mesh(2),
        lambda: make_mesh(4, "spread", "visible"),
        lambda: bootstrap(),
        lambda: run_p2p(RankMesh(("cuda:0", "cuda:0"))),
        lambda: run_hierarchical(RankMesh(("cuda:0",) * 4)),
        lambda: cli.main(["p2p", "--devices", "2"]),
        lambda: cli.main(["hier", "--devices", "4"]),
        lambda: cli.main(["hier"]),
        lambda: cli.main(["topo"]),
        lambda: cli.main(["topo", "1"]),
        lambda: run_loadgen(LoadGenConfig()),
        lambda: cli.main(["loadgen"]),
        lambda: cli.main(["serve", "--scenario", "chat"]),
        lambda: make_paged_lm_decoder(cfg, 32, n_blocks=4, block_len=8,
                                      max_len=16, sampling=True),
        lambda: run_decode(DecodeConfig()),
        lambda: cli.main(["decode"]),
        lambda: run_lm(LMConfig()),
        lambda: cli.main(["lm"]),
        lambda: cli.main(["perf", "report", "--no-history"]),
        lambda: capture(PerfConfig()),
        lambda: run_serve(ServeConfig(replicas=2)),
        lambda: cli.main(["serve", "--replicas", "2"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"
    assert init_lm_params(0, cfg, 32, "cpu")["wemb"].device.type == "cpu"


def test_unported_options_are_refused():
    from tpu_patterns_torch import cli
    from tpu_patterns_torch.models.decode import DecodeConfig, model_config

    # the mixture decodes since ROADMAP step 8c (decode and lm across
    # ranks), and serve and loadgen take the mesh since step 8d (the
    # sharded serve)
    assert model_config(DecodeConfig(moe=True)).moe
    for argv in (["serve", "--tp", "2"], ["loadgen", "--devices", "2"]):
        cli.build_parser().parse_args(argv)
    for argv in (["serve", "--paged_attn", "pallas"],
                 ["allreduce", "--placement", "diagonal"],
                 ["p2p", "--bidirectional", "maybe"],
                 ["p2p", "--mechanism", "affinity"],
                 ["p2p", "--placement", "diagonal"],
                 ["hier", "--placement", "spread"],
                 ["p2p", "--put-kernel", "pallas"]):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(argv)
    # the replica fleet parses since ROADMAP step 9a, its disaggregated
    # split since step 9b
    assert cli.build_parser().parse_args(
        ["serve", "--replicas", "2"]).replicas == 2
    args = cli.build_parser().parse_args(
        ["serve", "--disagg", "1:1", "--min_ttft_improvement", "1.05"])
    assert (args.disagg, args.min_ttft_improvement) == ("1:1", 1.05)


def test_diagnostics_subcommands_parse():
    from tpu_patterns_torch import cli

    parser = cli.build_parser()
    a = parser.parse_args(["doctor", "--device", "cpu", "--deep", "false",
                           "--probe_timeout", "5"])
    assert (a.cmd, a.device, a.deep, a.probe_timeout) == ("doctor", "cpu",
                                                          False, 5)
    assert parser.parse_args(["doctor"]).device == "cuda"
    a = parser.parse_args(["profilecheck", "d", "--snapshot-out", "s.json",
                           "--rates-jsonl", "r.jsonl"])
    assert (a.profile_dir, a.snapshot_out, a.rates_jsonl) == (
        "d", "s.json", "r.jsonl")
    a = parser.parse_args(["--enable_profiling", "--profile_dir", "p",
                           "perf", "diff", "--include", "serve.step",
                           "--measured_tol", "-1", "--dtype", "bfloat16"])
    assert (a.enable_profiling, a.profile_dir, a.perf_cmd, a.include,
            a.measured_tol, a.dtype, a.device) == (
        True, "p", "diff", "serve.step", -1.0, "bfloat16", "cuda")
    a = parser.parse_args(["obs", "summarize", "--profile-dir", "p"])
    assert a.obs_profile_dir == "p" and a.profile_dir == "results/profile"


def test_diagnostics_refusals():
    import contextlib
    import io

    from tpu_patterns_torch import cli

    for argv in (["perf", "report", "--include", "disagg.streams",
                  "--device", "cpu", "--no-history"],
                 ["perf", "diff", "--include", "disagg.streams",
                  "--device", "cpu", "--no-history"],
                 ["doctor", "--workers", "maybe", "--device", "cpu"],
                 ["perf", "report", "--devices", "4"],
                 ["perf", "report", "--tp", "2"]):
        with pytest.raises(SystemExit) as e, \
                contextlib.redirect_stderr(io.StringIO()):
            cli.main(argv)
        assert e.value.code not in (0, None), argv


def test_put_kernel_choices_are_the_librarys():
    from tpu_patterns_torch import cli
    from tpu_patterns_torch.comm.onesided import KERNELS

    parser = cli.build_parser()
    for k in KERNELS:
        args = parser.parse_args(["p2p", "--transport", "one_sided",
                                  "--put-kernel", k])
        assert args.put_kernel == k


def test_chip_smoke_needs_a_card(tmp_path):
    """Without a CUDA device the smoke prints no result and exits
    nonzero, in the checkout and as a lone copy."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
