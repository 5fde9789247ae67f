"""tpu_patterns_torch stands alone: no JAX, nothing of tpu_patterns, and
no quiet CPU run when CUDA is missing."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "tpu_patterns")


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
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpu_patterns')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from tpu_patterns_torch import cli
    from tpu_patterns_torch.comm.onesided import OneSidedConfig, run_onesided
    from tpu_patterns_torch.concurrency import (
        ConcurrencyConfig,
        run_concurrency,
    )
    from tpu_patterns_torch.models.lm import init_lm_params
    from tpu_patterns_torch.models.transformer import ModelConfig
    from tpu_patterns_torch.runtime import resolve_device
    from tpu_patterns_torch.serve.engine import ServeConfig, run_serve
    from tpu_patterns_torch.serve.paged import make_paged_lm_decoder

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
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"
    assert init_lm_params(0, cfg, 32, "cpu")["wemb"].device.type == "cpu"


def test_unported_options_are_refused():
    from tpu_patterns_torch import cli
    from tpu_patterns_torch.models.transformer import ModelConfig

    with pytest.raises(NotImplementedError, match="moe"):
        ModelConfig(moe=True)
    for argv in (["serve", "--spec_k", "2"], ["serve", "--prefix_share"],
                 ["serve", "--paged_attn", "pallas"],
                 ["p2p", "--devices", "2"], ["p2p", "--bidirectional", "0"],
                 ["p2p", "--placement", "spread"],
                 ["p2p", "--put-kernel", "pallas"]):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(argv)


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
