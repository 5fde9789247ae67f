"""The ``python -m tpu_patterns_torch`` command line.

    python -m tpu_patterns_torch serve --device cuda --embed 1024 \
        --head_dim 128 --depth 4 --dtype bfloat16 --vocab 2048 \
        --min_prompt 64 --max_prompt 512 --gen 64
    python -m tpu_patterns_torch loadgen --device cuda \
        --scenarios chat,chat-sampled --chaos loadgen.arrive:error:count=1
    python -m tpu_patterns_torch serve --device cuda --scenario chat
    python -m tpu_patterns_torch serve --device cuda --kv_host_tier true \
        --session_dir sess
    python -m tpu_patterns_torch serve --device cuda --snapshot_dir snap
    python -m tpu_patterns_torch serve --device cuda --snapshot_dir snap \
        --resume true --ids_out ids.json
    python -m tpu_patterns_torch loadgen --device cuda --kv_host_tier true \
        --preempt bulk --scenarios chat:bulk_fraction=0.5:working_set_mult=2
    python -m tpu_patterns_torch serve --device cuda --devices 4 --tp 2
    python -m tpu_patterns_torch loadgen --device cuda --devices 4 --tp 2
    python -m tpu_patterns_torch flagship --device cuda
    python -m tpu_patterns_torch p2p --transport one_sided --device cuda
    python -m tpu_patterns_torch concurrency --device cuda \
        --backend xla --mode concurrent --commands "C C"
    python -m tpu_patterns_torch allreduce --device cuda --devices 4 \
        --variant pallas --algorithm ring_opt
    python -m tpu_patterns_torch miniapps --device cuda --devices 4
    python -m tpu_patterns_torch p2p --transport one_sided --devices 4
    python -m tpu_patterns_torch p2p --devices 2 --placement spread
    python -m tpu_patterns_torch hier --devices 4 --dcn 2
    python -m tpu_patterns_torch topo [N]
    python -m tpu_patterns_torch interop --device cuda
    python -m tpu_patterns_torch longctx --device cuda --devices 4 \
        --strategy ring_pallas --grad true
    python -m tpu_patterns_torch overlap --devices 4
    python -m tpu_patterns_torch pipeline --devices 4 --schedule both
    python -m tpu_patterns_torch moe --devices 4 --capacity_factor 1.0
    python -m tpu_patterns_torch train --device cuda --attn kernel \
        --ckpt_dir ckpts --ckpt_every 2 --steps 8
    python -m tpu_patterns_torch ckpt ckpts --leaves
    python -m tpu_patterns_torch decode --device cuda --kv_heads 2 \
        --rope true --cache_int8 true
    python -m tpu_patterns_torch lm --device cuda --temperature 0.8 \
        --top_k 16
    python -m tpu_patterns_torch --obs-dir obs --obs-dump serve \
        --device cuda --watchdog_s 30 --obs_http 9100
    python -m tpu_patterns_torch --obs-dir obs obs summarize
    python -m tpu_patterns_torch --obs-dir obs obs summarize \
        --profile-dir results/profile
    python -m tpu_patterns_torch --enable_profiling \
        --profile_dir results/profile flagship --device cuda
    python -m tpu_patterns_torch profilecheck results/profile \
        --snapshot-out op_names.json --rates-jsonl records.jsonl
    python -m tpu_patterns_torch doctor --device cuda
    python -m tpu_patterns_torch perf report --device cuda
    python -m tpu_patterns_torch perf update-baseline --device cpu
    python -m tpu_patterns_torch perf diff --device cpu
    python -m tpu_patterns_torch --obs-dir obs obs export \
        --chrome-trace trace.json --prom
    python -m tpu_patterns_torch obs watch http://127.0.0.1:9100
    python -m tpu_patterns_torch --obs-dir obs obs cost
    python -m tpu_patterns_torch sweep measured --out results/measured
    python -m tpu_patterns_torch sweep all --quick --jobs 0 --resume
    python -m tpu_patterns_torch sweep summarize --out results/measured
    python -m tpu_patterns_torch report results/measured/*.log

One flag per field of the subcommand's config
(:class:`~tpu_patterns_torch.serve.engine.ServeConfig`,
:class:`~tpu_patterns_torch.loadgen.runner.LoadGenConfig`,
:class:`~tpu_patterns_torch.models.flagship.FlagshipConfig`,
:class:`~tpu_patterns_torch.models.train_loop.TrainLoopConfig`,
:class:`~tpu_patterns_torch.models.decode.DecodeConfig`,
:class:`~tpu_patterns_torch.models.lm.LMConfig`), named as
in ``tpu-patterns serve`` / ``loadgen`` / ``flagship`` / ``train`` /
``decode`` / ``lm``, whose
default is
the field's unless ``TPU_PATTERNS_<FIELD>`` is set (``core/config.py``:
CLI > environment > default); ``loadgen`` and ``serve --scenario`` check
the scenario and chaos specs, and ``serve`` its flag combinations,
before the model is built;
``--paged_attn``
and ``--attn`` take ``kernel|dense`` (``train`` also the JAX package's
``xla``, read as ``dense``) and ``--device`` names the device.
``ckpt DIR [--leaves]`` prints a checkpoint directory's steps (and leaf
table) in the lines of ``tpu-patterns ckpt``.
``p2p`` takes the flags of ``tpu-patterns p2p``
(:class:`~tpu_patterns_torch.comm.p2p.P2PConfig`, ``--transport``:
``two_sided``, the pair exchange, or ``one_sided``, the put; ``--put-kernel``,
``--chunks``, ``--block-rows``, ``--devices``, ``--placement``,
``--mechanism``); ``hier`` those of ``tpu-patterns hier``
(:class:`~tpu_patterns_torch.comm.hierarchical.HierConfig`,
``--devices``); ``topo [N]`` prints the fabric probe's lines;
``concurrency`` those of ``tpu-patterns concurrency``
(:class:`~tpu_patterns_torch.concurrency.harness.ConcurrencyConfig`,
repeatable ``--commands``, ``--no_tuning``); ``allreduce`` and
``miniapps`` those of ``tpu-patterns allreduce`` (with ``--placement``
and ``--mechanism``) and ``miniapps``;
``interop`` (the native C++ round trips, no flag of the reference's) only
``--device``.
``longctx`` takes the flags of ``tpu-patterns longctx``
(:class:`~tpu_patterns_torch.longctx.pattern.LongCtxConfig`,
``--strategy`` ring|ring_pallas|ring_striped|ulysses|ulysses_pallas|
flash|both, ``--devices``, ``--placement``, ``--mechanism``): the
sequence-parallel strategies over a rank mesh, ``both`` folding
``flash`` in at one rank.
``overlap`` takes the flags of ``tpu-patterns overlap``
(:class:`~tpu_patterns_torch.parallel.overlap.OverlapConfig`,
``--devices``, ``--placement``, ``--mechanism``), ``pipeline`` those of
``tpu-patterns pipeline``
(:class:`~tpu_patterns_torch.parallel.pipeline.PipelineConfig`,
``--schedule`` gpipe|1f1b|both, ``--devices``; an ``n_micro`` that the
rank count does not divide writes a SKIPPED Record) and ``moe`` those of
``tpu-patterns moe`` (:class:`~tpu_patterns_torch.parallel.moe.MoEConfig`,
repeatable ``--capacity_factor``, ``--devices``): the parallelism
patterns over a rank mesh.
``obs ACTION`` reads the obs plane's dumps as ``tpu-patterns obs`` does:
``summarize`` (the span table), ``export --chrome-trace OUT.json``
and/or ``--prom``, ``watch URL`` (poll a live ``--obs_http`` plane) and
``cost [DIR]``; ``summarize --profile-dir DIR`` joins the spans with a
Kineto trace's device breakdown (``core/profile.py``); ``fleet [DIR]``
(the merged summary and a Chrome trace with a lane set a process),
``journey <jid|rid>`` and ``explain <jid|rid>`` (or ``--action KIND``)
read the merged timeline of a fleet's dumps (``obs/fleet.py``).
``serve --replicas N`` runs N engine processes behind the prefix-aware
router (``serve/replica.py``), with its fleet flags; ``--disagg P:D``
splits them into P prefill and D decode replicas and banks the disagg
A/B Record (``--min_ttft_improvement`` its TTFT gate).  ``serve`` takes
every flag of the reference's.  The
global ``--enable_profiling`` runs any subcommand under torch.profiler
(CPU and CUDA activity), exports the Kineto trace under
``--profile_dir`` and banks a ``profile_breakdown`` Record of where the
device time went (none, with a progress line, when the trace holds no
device event).  ``profilecheck DIR`` snapshots a trace's device op
names, gates the share of busy time the classifier books as ``other``
and cross-checks a Record stream's ``tflops_hw``; ``doctor`` runs the
deadline-bounded health probes (``core/doctor.py``; ``--workers true``
also spawns a warm worker, times its ready handshake and a ping); ``perf report|diff|update-baseline|prune-stale`` captures the
executable registry (``perf/registry.py``), banks the snapshot and
renders or gates it against ``perf/baseline.json``, exiting 1 on a new
regression.  The global ``--obs-dir`` sets where dumps land and
``--obs-dump`` writes ``spans.jsonl``, ``metrics.jsonl`` and (after a
serve or loadgen run) ``cost.jsonl`` there when the run ends; an
uncaught exception or SIGTERM dumps the flight recorder to
``crash.jsonl``.
``sweep SUITE`` runs a suite's cells (``sweep.py``, the JAX package's
suites and cell names), each a ``python -m tpu_patterns_torch`` child in
its own process group, with a resumable state file under ``--out``
(``--resume``, ``--name``, ``--cell-timeout``, ``--jobs`` with the
executor of ``exec/``, ``--no-warm-workers``); ``sweep promote`` and
``sweep summarize`` fold or tabulate a finished run.  ``report PATH...``
tabulates logs and JSONL of either package (≙ parse.py).
A ``--device`` flag defaults to ``TPU_PATTERNS_DEVICE`` when set, as the
config fields' ``device`` does.
``--devices N`` is the rank count (≙ ``mpirun -n N``, 0 = one rank per
card): the ranks of a rank mesh (``comm/mesh.py``) are placed over the
visible cards, several to a card when there are fewer cards.  A
flag (or a value) of the JAX package's subcommand that this package does
not support yet is refused with a message, never ignored.  Prints the
``## mode | commands | VERDICT`` markers, appends JSON-lines Records with
``--jsonl``, and exits nonzero iff a verdict is FAILURE.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from tpu_patterns_torch.core.config import _coerce, add_config_args
from tpu_patterns_torch.core.results import ResultWriter

# the model commands' mesh flags: `flagship`, `train`, `decode`, `lm`,
# `serve` and `loadgen` take them (the last two refuse a dp other than 1)
_MESH_FLAGS = ("devices", "dp", "tp")


def _bool(s: str) -> bool:
    v = s.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {s!r}")


def _coerce_strict(field_type, raw: str):
    """``core/config.py``'s coercion, except that a word that is no
    boolean is refused rather than read as False."""
    return _bool(raw) if field_type is bool else _coerce(field_type, raw)


# the P2PConfig fields that the one-sided put's config shares
_P2P_FIELDS = ("count", "dtype", "reps", "warmup", "min_bandwidth", "seed")

_CHOICES = {
    "paged_attn": ("kernel", "dense"),
    "burn_mitigation": ("off", "shed", "spec_off"),
    "attn": ("kernel", "dense"),
    "attn_grid": ("dense", "compact"),
    "attn_layout": ("contiguous", "striped"),
    "device": ("cuda", "cpu"),
}


def _device_default() -> str:
    """The default of a ``--device`` flag that no config field carries:
    ``TPU_PATTERNS_DEVICE`` when set (the config tier's variable for
    every ``device`` field), else ``cuda``."""
    import os

    dev = os.environ.get("TPU_PATTERNS_DEVICE", "cuda")
    if dev not in _CHOICES["device"]:
        raise ValueError(
            f"TPU_PATTERNS_DEVICE={dev!r}: not one of {_CHOICES['device']}")
    return dev


def _add_config_flags(p: argparse.ArgumentParser, cls, skip=()) -> None:
    """One ``--<field>`` per dataclass field of ``cls`` not in ``skip``
    (default: ``TPU_PATTERNS_<FIELD>`` when set, else the field's)."""
    add_config_args(p, cls, skip=skip, choices=_CHOICES,
                    coerce=_coerce_strict)


def _add_model_mesh_flags(p: argparse.ArgumentParser) -> None:
    """``--devices --dp --tp`` of the reference's model commands: sp is
    the rest (``_mesh3d_from_args``)."""
    p.add_argument("--devices", type=int, default=0,
                   help="ranks (0 = one per card); sp = devices / (dp*tp)")
    p.add_argument("--dp", type=int, default=1, help="data-parallel ranks")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel (and expert) ranks")


def _mesh3d(args):
    """The dp x sp x tp mesh of the model commands: ``--dp`` and
    ``--tp`` fixed, the rest of ``--devices`` ranks on sp (0 = one rank a
    card); ranks that dp*tp does not divide are an error."""
    from tpu_patterns_torch.comm.mesh import model_mesh

    try:
        return model_mesh(args.devices, args.dp, args.tp,
                          device=args.device)
    except ValueError as e:
        raise SystemExit(f"error: {e}") from e


def _add_mesh_args(p: argparse.ArgumentParser) -> None:
    from tpu_patterns_torch.topo.placement import Mechanism, PlacementMode

    p.add_argument("--devices", type=int, default=0,
                   help="ranks (0 = one per card) — ≙ mpirun -n N")
    p.add_argument("--placement", choices=[m.value for m in PlacementMode],
                   default="compact", help="rank->device order")
    p.add_argument("--mechanism", choices=[m.value for m in Mechanism],
                   default="mesh",
                   help="ordering (mesh ≙ affinity mask) vs subset "
                   "(visible ≙ selector)")
    p.add_argument("--device", choices=_CHOICES["device"],
                   default=_device_default())


def _mesh(args):
    from tpu_patterns_torch.topo.placement import make_mesh

    return make_mesh(args.devices, args.placement, args.mechanism,
                     args.device)


def build_parser() -> argparse.ArgumentParser:
    from tpu_patterns_torch.loadgen.runner import LoadGenConfig
    from tpu_patterns_torch.models.decode import DecodeConfig
    from tpu_patterns_torch.models.flagship import FlagshipConfig
    from tpu_patterns_torch.models.lm import LMConfig
    from tpu_patterns_torch.models.train_loop import TrainLoopConfig
    from tpu_patterns_torch.serve.engine import ServeConfig

    parser = argparse.ArgumentParser(
        prog="python -m tpu_patterns_torch",
        description=__doc__.splitlines()[0],
    )
    parser.add_argument("--jsonl", default=None,
                        help="append JSONL records here")
    parser.add_argument(
        "--enable_profiling", action="store_true",
        help="run the subcommand under torch.profiler (CPU and CUDA "
        "activity) and bank a profile_breakdown Record of where the "
        "device time went (≙ the reference's --enable_profiling queue "
        "property)",
    )
    parser.add_argument(
        "--profile_dir", default="results/profile",
        help="Kineto trace output directory for --enable_profiling",
    )
    parser.add_argument(
        "--obs-dir", default=None,
        help="directory for obs dumps (watchdog/crash/spans/metrics); "
        "default $TPU_PATTERNS_OBS_DIR, else results/obs",
    )
    parser.add_argument(
        "--obs-dump", action="store_true",
        help="dump the flight recorder (spans.jsonl) and metrics "
        "(metrics.jsonl) under the obs dir when the run finishes — the "
        "ring records always; this flag exports it",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser(
        "serve",
        help="continuous-batching serve engine over a paged KV cache "
        "with the fused paged-attention kernel",
    )
    _add_config_flags(sv, ServeConfig)
    _add_model_mesh_flags(sv)
    lg = sub.add_parser(
        "loadgen",
        help="trace-driven load generator over the serve engine: seeded "
        "arrival processes + scenario presets (chat, rag, "
        "batch-summarize, agentic, chat-sampled), TTFT/TPOT/e2e "
        "percentiles, goodput-under-SLO verdicts, optional chaos twin",
    )
    _add_config_flags(lg, LoadGenConfig)
    _add_model_mesh_flags(lg)
    fl = sub.add_parser(
        "flagship",
        help="PatternFormer train-step benchmark (fwd+bwd+SGD) with the "
        "fused flash-attention kernels",
    )
    _add_config_flags(fl, FlagshipConfig)
    _add_model_mesh_flags(fl)
    tr = sub.add_parser(
        "train",
        help="resumable training loop with atomic checkpoints "
        "(--ckpt_dir/--ckpt_every/--resume)",
    )
    _add_config_flags(tr, TrainLoopConfig)
    _add_model_mesh_flags(tr)
    tr.add_argument("--device", choices=_CHOICES["device"],
                    default=_device_default())
    dc = sub.add_parser(
        "decode",
        help="autoregressive decode over a dense KV cache (the "
        "long-context inference pattern): prefill, then timed "
        "self-feeding generation, gated by teacher forcing",
    )
    _add_config_flags(dc, DecodeConfig)
    _add_model_mesh_flags(dc)
    lmp = sub.add_parser(
        "lm",
        help="token-level LM: embedding, cross-entropy and argmax; train "
        "then generate (greedy or Gumbel-max sampled), one measured "
        "pattern",
    )
    _add_config_flags(lmp, LMConfig)
    _add_model_mesh_flags(lmp)
    ck = sub.add_parser(
        "ckpt",
        help="inspect a checkpoint directory: committed steps, sizes, "
        "leaf table (read-only)",
    )
    ck.add_argument("dir", help="checkpoint root (the train --ckpt_dir)")
    ck.add_argument("--leaves", action="store_true",
                    help="print the per-leaf table")
    _add_p2p_flags(sub.add_parser(
        "p2p",
        help="pair-exchange bandwidth over a rank mesh (two_sided), or the "
        "one-sided put with the CUDA put kernels (one_sided)",
    ))
    _add_hier_flags(sub.add_parser(
        "hier",
        help="hierarchical allreduce (inner tier, then outer) against the "
        "flat one over a rank mesh",
    ))
    _add_concurrency_flags(sub.add_parser(
        "concurrency",
        help="serial-vs-concurrent harness: device commands on CUDA "
        "streams (the busy-wait kernel) or in one copy-and-compute kernel",
    ))
    _add_allreduce_flags(sub.add_parser(
        "allreduce",
        help="ring-allreduce miniapp over a rank mesh (pallas: the "
        "accumulate kernel)",
    ))
    m = sub.add_parser("miniapps", help="run every typed variant (≙ ctest)")
    m.add_argument("--devices", type=int, default=0,
                   help="ranks (0 = 4, the default world)")
    m.add_argument("--elements", type=int, default=0,
                   help="0 = app default")
    m.add_argument("--reps", type=int, default=3)
    m.add_argument("--device", choices=_CHOICES["device"],
                   default=_device_default())
    t = sub.add_parser("topo", help="fabric probe (≙ ./topology [N])")
    t.add_argument("n", nargs="?", type=int, default=None)
    t.add_argument("--device", choices=_CHOICES["device"],
                   default=_device_default())
    lc = sub.add_parser(
        "longctx", help="sequence-parallel attention (ring vs Ulysses) "
        "over a rank mesh, with the fused flash kernels")
    from tpu_patterns_torch.longctx.pattern import LongCtxConfig

    _add_config_flags(lc, LongCtxConfig, skip=("strategies", "device"))
    lc.add_argument(
        "--strategy", choices=LONGCTX_STRATEGIES, default="both",
        help="manual-ring vs library-collective lineage; ring_pallas = "
        "the flash kernels a ring step, ring_striped = load-balanced "
        "causal layout, flash = the fused kernels on one rank")
    _add_mesh_args(lc)
    _add_parallel_parsers(sub)
    i = sub.add_parser("interop", help="native C++ round-trip proofs")
    i.add_argument("--device", choices=_CHOICES["device"],
                   default=_device_default(),
                   help="device of the offload round trips (the native "
                   "ones run on CPU tensors)")
    _add_obs_flags(sub.add_parser(
        "obs",
        help="observability layer: summarize recorded spans, export "
        "Chrome traces (Perfetto-openable) and Prometheus metrics, poll "
        "a live plane, roll up the cost book",
    ))
    _add_perf_flags(sub.add_parser(
        "perf",
        help="performance observatory: capture analytic + measured cost "
        "per ported entry point, bank one snapshot per run, and ratchet "
        "the trajectory against the committed perf/baseline.json",
    ))
    dr = sub.add_parser(
        "doctor",
        help="deadline-bounded runtime health probes (backend init / tiny "
        "op / real compute / native modules) — names the broken layer "
        "instead of hanging",
    )
    from tpu_patterns_torch.core.doctor import DoctorConfig

    _add_config_flags(dr, DoctorConfig)
    pc = sub.add_parser(
        "profilecheck",
        help="validate a captured trace: real-op-name fixture snapshot, "
        "unclassified-time gate, and tflops_hw-vs-compute-time crosscheck",
    )
    pc.add_argument("profile_dir", help="Kineto trace directory")
    pc.add_argument(
        "--snapshot-out", default=None,
        help="write the {op name -> count/duration/category} fixture here",
    )
    pc.add_argument(
        "--rates-jsonl", default=None,
        help="Record stream holding a tflops_hw rate to cross-check "
        "against the breakdown's compute time",
    )
    _add_sweep_flags(sub.add_parser(
        "sweep", help="config-matrix sweeps (≙ run*.sh)"))
    r = sub.add_parser("report", help="tabulate logs (≙ parse.py)")
    r.add_argument("paths", nargs="+")
    return parser


def _add_sweep_flags(s: argparse.ArgumentParser) -> None:
    """The flags of ``tpu-patterns sweep``."""
    from tpu_patterns_torch.sweep import DEFAULT_CELL_TIMEOUT, SUITES

    s.add_argument(
        "suite",
        choices=(*SUITES, "all", "promote", "summarize"),
        help="a sweep suite; 'promote' folds a finished tune run (--out "
        "points at its directory) into the one-sided put's defaults "
        "(comm/tuned.json); 'summarize' prints a markdown table of "
        "whatever cells have records under --out",
    )
    s.add_argument("--out", default="results", help="log/JSONL directory")
    s.add_argument(
        "--gates-dir", default=None,
        help="with 'promote': fold this finished `sweep gates` run into "
        "the committed grad-gate width (longctx/gates_fit.json) instead "
        "of promoting tune knobs",
    )
    s.add_argument(
        "--flash-dir", default=None,
        help="with 'promote': fold this measured run's flagship "
        "block-shape win (a lever cell beating the base beyond noise, "
        "converged timings both sides) into the flash defaults "
        "(longctx/flash_tuned.json)",
    )
    s.add_argument("--quick", action="store_true", help="tiny workloads")
    s.add_argument(
        "--resume", action="store_true",
        help="skip cells already completed in a previous (interrupted) run",
    )
    s.add_argument(
        "--cell-timeout", type=float, default=DEFAULT_CELL_TIMEOUT,
        help="per-cell subprocess deadline in seconds; <= 0 disables it "
        "(a timed-out cell is not completed: --resume retries it)",
    )
    s.add_argument(
        "--jobs", type=int, default=1,
        help="concurrent engine width for host-parallel cells: 1 = the "
        "serial engine (default), 0 = auto (one per core, capped), N = "
        "N-wide; device-exclusive and env-isolated cells always drain "
        "serially",
    )
    s.add_argument(
        "--no-warm-workers", action="store_true",
        help="run every cell as a fresh subprocess even under --jobs "
        "(warm workers skip the interpreter start, torch's import and "
        "the device warm-up a cell, for host-parallel cells)",
    )
    s.add_argument(
        "--name", action="append", metavar="CELL",
        help="run only the named cell(s); repeatable (unknown names "
        "fail loudly, never silently drop coverage)",
    )


def _add_parallel_parsers(sub) -> None:
    """``overlap``, ``pipeline`` and ``moe`` with the reference's flags
    (``tpu_patterns/cli.py``), ``--device`` added."""
    from tpu_patterns_torch.parallel.moe import MoEConfig
    from tpu_patterns_torch.parallel.overlap import OverlapConfig
    from tpu_patterns_torch.parallel.pipeline import PipelineConfig

    ov = sub.add_parser(
        "overlap",
        help="collective matmul: decomposed ring all-gather/"
        "reduce-scatter matmuls vs the library collective baseline",
    )
    _add_config_flags(ov, OverlapConfig, skip=("device",))
    _add_mesh_args(ov)
    pl = sub.add_parser(
        "pipeline",
        help="GPipe vs 1F1B schedule benchmark (bubble + memory)")
    _add_config_flags(pl, PipelineConfig, skip=("schedules", "device"))
    pl.add_argument("--schedule", choices=("gpipe", "1f1b", "both"),
                    default="both")
    pl.add_argument("--devices", type=int, default=0,
                    help="ranks (0 = one per card)")
    pl.add_argument("--device", choices=_CHOICES["device"],
                    default=_device_default())
    mo = sub.add_parser(
        "moe",
        help="expert-parallel dispatch benchmark (capacity regimes)")
    _add_config_flags(mo, MoEConfig, skip=("capacity_factors", "device"))
    mo.add_argument("--capacity_factor", type=float, action="append",
                    help="repeatable; 0 = exact (C = T); default 0, 2.0, "
                    "1.0")
    mo.add_argument("--devices", type=int, default=0,
                    help="ranks (0 = one per card)")
    mo.add_argument("--device", choices=_CHOICES["device"],
                    default=_device_default())


def _add_perf_flags(pf: argparse.ArgumentParser) -> None:
    """The reference's ``perf`` flags (``tpu_patterns/cli.py``); its
    mesh flags take 1 only, as the port's entry points run on one
    device."""
    from tpu_patterns_torch.perf.registry import PerfConfig

    pf.add_argument(
        "perf_cmd",
        choices=("report", "diff", "update-baseline", "prune-stale"),
        help="report: capture + render roofline/trajectory; diff: "
        "capture + gate vs the baseline (exit 1 on NEW regressions, "
        "named per-executable); update-baseline: capture + re-pin "
        "(per-entry justifications survive); prune-stale: NO capture — "
        "drop entries whose executable left the registry",
    )
    _add_config_flags(pf, PerfConfig)
    pf.add_argument(
        "--baseline", default=None,
        help="baseline path (default: the committed "
        "tpu_patterns_torch/perf/baseline.json)",
    )
    pf.add_argument("--perf-dir", default=None,
                    help="history store directory (default "
                    "results/perf_torch)")
    pf.add_argument("--no-history", action="store_true",
                    help="do not append this capture to the history store")
    pf.add_argument(
        "--measured_tol", type=float, default=0.0,
        help="override the measured-class tolerance band for this diff "
        "(relative; 0 keeps the class default, perf/baseline.py CLASSES; "
        "negative makes measured entries informational for this diff)",
    )
    for flag in ("--devices", "--dp", "--tp"):
        pf.add_argument(flag, type=int, choices=(1,), default=1,
                        help="one device (the mesh flags take 1 only)")


# ``obs`` actions that read the merged fleet timeline (obs/fleet.py)
_OBS_FLEET_ACTIONS = ("fleet", "journey", "explain")


def _add_obs_flags(ob: argparse.ArgumentParser) -> None:
    """The reference's ``obs`` flags (``tpu_patterns/cli.py``)."""
    ob.add_argument(
        "action",
        choices=("summarize", "export", "fleet", "journey", "watch",
                 "cost", "explain"),
        help="summarize = per-span table; export = --chrome-trace / "
        "--prom; watch <url> = poll a live --obs_http plane (/healthz + "
        "/metrics) into a one-line-per-interval view; cost <dir> = "
        "per-request/class/scenario attribution table with identity "
        "verdicts (+ cost_rollup.jsonl); fleet <dir> = merge the "
        "parent's dumps and every replica-*/ dir into one timeline "
        "(summary + Chrome trace); journey <jid|rid> = one request's "
        "cross-process story; explain <jid|rid> = its decisions (or "
        "--action KIND fleet-wide)",
    )
    ob.add_argument(
        "target", nargs="?", default=None,
        help="fleet/cost: the obs dir to read (default --obs-dir); "
        "journey/explain: the journey id (j...) or request id; watch: the "
        "plane URL (http://127.0.0.1:PORT)",
    )
    ob.add_argument("--action", dest="filter_action", default=None,
                    metavar="KIND",
                    help="explain: filter to one decision kind")
    ob.add_argument("--interval", type=float, default=1.0,
                    help="watch: seconds between polls (default 1.0)")
    ob.add_argument(
        "--count", type=int, default=0,
        help="watch: stop after N successful polls (0 = poll until the "
        "plane goes away — the watched run finishing exits 0)",
    )
    ob.add_argument(
        "--input", default=None,
        help="one specific dump file (default: spans.jsonl + crash.jsonl "
        "+ hang_*.jsonl under the obs dir)",
    )
    ob.add_argument("--chrome-trace", default=None, metavar="OUT.json",
                    help="write Chrome trace_event JSON here")
    ob.add_argument("--prom", action="store_true",
                    help="print the dumped metrics in Prometheus text "
                    "format")
    ob.add_argument(
        "--profile-dir", dest="obs_profile_dir", default=None,
        help="Kineto trace dir: join host spans with the device busy-time "
        "breakdown (host vs SMs vs NCCL vs copies)",
    )


def _obs(args, writer: ResultWriter) -> None:
    """Read the obs layer's dumps: span summaries, Chrome-trace and
    Prometheus export, the live plane's poller and the cost rollup, as
    ``tpu-patterns obs`` does (``tpu_patterns/cli.py``)."""
    import glob
    import json
    import os

    from tpu_patterns_torch import obs
    from tpu_patterns_torch.obs import cost as obs_cost
    from tpu_patterns_torch.obs import export as obs_export
    from tpu_patterns_torch.obs import live as obs_live
    from tpu_patterns_torch.obs import metrics as obs_metrics

    obs_dir = args.obs_dir or obs.run_dir()
    if args.action in _OBS_FLEET_ACTIONS:
        _obs_fleet(args, obs_dir, writer)
        return
    if args.action == "watch":
        if not args.target:
            raise SystemExit(
                "obs watch: pass the plane URL (http://127.0.0.1:PORT — "
                "start one with `serve --obs_http PORT`)"
            )
        rc = obs_live.watch(args.target, interval_s=args.interval,
                            count=args.count)
        if rc:
            raise SystemExit(rc)
        return
    if args.action == "cost":
        cost_dir = args.target or obs_dir
        metas, reqs = obs_cost.load_dir(cost_dir)
        if not metas:
            raise SystemExit(
                f"no cost.jsonl under {cost_dir} — run a serve/loadgen "
                "pattern with --obs-dump first"
            )
        print(obs_cost.cost_table(metas, reqs))
        out = os.path.join(cost_dir, "cost_rollup.jsonl")
        with open(out, "w") as f:
            for key in ("priority", "scenario", "replica"):
                for k, g in sorted(obs_cost.rollup(reqs, key).items()):
                    f.write(json.dumps(
                        {"kind": "cost_rollup", "by": key, "key": k, **g}
                    ) + "\n")
        writer.progress(f"merged cost rollup -> {out}")
        return
    if args.input:
        span_files = [args.input]
    else:
        span_files = [
            p for p in (os.path.join(obs_dir, "spans.jsonl"),
                        os.path.join(obs_dir, "crash.jsonl"))
            if os.path.exists(p)
        ] + sorted(glob.glob(os.path.join(obs_dir, "hang_*.jsonl")))
    entries: list[dict] = []
    for p in span_files:
        entries.extend(obs_export.load_entries(p))
    # hang/crash dumps and an end-of-run spans.jsonl overlap (one ring,
    # dumped at different moments): summaries must not double-count
    entries = obs_export.dedupe_entries(entries)
    if args.action == "summarize":
        if not entries:
            raise SystemExit(
                f"no obs dumps under {obs_dir} — run a pattern with "
                "--obs-dump (or wait for a watchdog/crash dump) first"
            )
        writer.progress(f"{len(entries)} entries from {len(span_files)} "
                        f"dump(s) under {obs_dir}")
        if args.obs_profile_dir:
            print(obs_export.host_device_join(entries,
                                              args.obs_profile_dir))
        else:
            print(obs_export.summarize(entries))
        return
    # action == "export"
    if not args.chrome_trace and not args.prom:
        raise SystemExit(
            "obs export: pass --chrome-trace OUT.json and/or --prom"
        )
    if args.chrome_trace:
        if not entries:
            raise SystemExit(f"no obs dumps under {obs_dir} to export")
        out = obs_export.write_chrome_trace(entries, args.chrome_trace)
        writer.progress(f"chrome trace ({len(entries)} events) -> {out} "
                        "(open in Perfetto / chrome://tracing)")
    if args.prom:
        mpath = os.path.join(obs_dir, "metrics.jsonl")
        if not os.path.exists(mpath):
            raise SystemExit(
                f"no {mpath} — run a pattern with --obs-dump first"
            )
        with open(mpath) as f:
            print(obs_metrics.registry_from_jsonl(f).to_prom_text(), end="")


def _obs_fleet(args, obs_dir: str, writer: ResultWriter) -> None:
    """``obs fleet|journey|explain`` over the merged fleet timeline (the
    parent's dumps and every ``replica-*/`` dir), as the reference's."""
    import os

    from tpu_patterns_torch.obs import decisions as obs_decisions
    from tpu_patterns_torch.obs import export as obs_export
    from tpu_patterns_torch.obs import fleet as obs_fleet

    if args.action == "fleet":
        fleet_dir = args.target or obs_dir
        merged, procs = obs_fleet.merge_fleet(fleet_dir)
        if not merged:
            raise SystemExit(
                f"no fleet dumps under {fleet_dir} — run `serve --replicas "
                "N --obs-dump` (replica dirs land under "
                "<obs_dir>/replica-<id>/) first"
            )
        n_replicas = sum(1 for p in procs if p != obs_fleet.ROUTER_PID)
        writer.progress(
            f"{len(merged)} merged entries from {len(procs)} process(es) "
            f"({n_replicas} replica(s)) under {fleet_dir}"
        )
        print(obs_export.summarize(merged))
        out = args.chrome_trace or os.path.join(fleet_dir,
                                                "fleet_trace.json")
        obs_export.write_chrome_trace(merged, out, process_names=procs)
        writer.progress(
            f"fleet chrome trace ({n_replicas} replica lanes + router) -> "
            f"{out} (open in Perfetto / chrome://tracing)"
        )
        writer.progress(
            f"{len(obs_fleet.journeys(merged))} journey(s) stitched; "
            "inspect one with: python -m tpu_patterns_torch obs journey "
            "<jid|rid>"
        )
        return
    if args.action == "journey":
        if not args.target:
            raise SystemExit(
                "obs journey: pass a journey id (j...) or a request id"
            )
        merged, _ = obs_fleet.merge_fleet(obs_dir)
        if not merged:
            raise SystemExit(f"no fleet dumps under {obs_dir}")
        print(obs_fleet.journey_table(merged, args.target))
        return
    # explain: one request's (or one action's) decisions on the merged
    # timeline, with their rationale and the signals read at the time
    if not args.target and not args.filter_action:
        raise SystemExit(
            "obs explain: pass a request/journey id, or filter fleet-wide "
            f"with --action ({'|'.join(obs_decisions.ACTIONS)})"
        )
    if args.filter_action and args.filter_action not in obs_decisions.ACTIONS:
        raise SystemExit(
            f"obs explain: unknown --action {args.filter_action!r} (want "
            f"one of {sorted(obs_decisions.ACTIONS)})"
        )
    merged, _ = obs_fleet.merge_fleet(obs_dir)
    if not merged:
        raise SystemExit(f"no fleet dumps under {obs_dir}")
    print(obs_decisions.explain_table(merged, key=args.target,
                                      action=args.filter_action))


def _add_allreduce_flags(p: argparse.ArgumentParser) -> None:
    from tpu_patterns_torch.miniapps.apps.allreduce import AllreduceConfig

    _add_config_flags(p, AllreduceConfig)
    p.add_argument("--variant", choices=("xla", "pallas"), default="xla")
    _add_mesh_args(p)


def _world_skip(writer: ResultWriter, pattern: str, mode: str, n: int,
                reason: str) -> None:
    """World-size constraints unmet: a SKIPPED Record, as the
    reference writes."""
    from tpu_patterns_torch.core.results import Record, Verdict

    writer.record(Record(pattern=pattern, mode=mode,
                         commands=f"devices={n}", verdict=Verdict.SKIPPED,
                         notes=[reason]))


def _ranks(devices: int, device: str) -> int:
    """``--devices``: 0 means one rank per card (one on the CPU)."""
    import torch

    from tpu_patterns_torch.runtime import resolve_device

    dev = resolve_device(device)
    return devices or (torch.cuda.device_count() if dev.type == "cuda"
                       else 1)


def _allreduce(args, writer: ResultWriter) -> None:
    from tpu_patterns_torch.miniapps.framework import get_variant

    spec = get_variant("allreduce", args.variant)
    mode = f"{args.variant}:{args.algorithm}"
    n = _ranks(args.devices, args.device)
    if args.require_even_ge4 and (n < 4 or n % 2):
        _world_skip(
            writer, "allreduce", mode, n,
            f"allreduce needs an even world >= 4, have {n} "
            "(--require_even_ge4 false to override)",
        )
        return
    if args.algorithm == "ring_opt" and args.elements % n:
        _world_skip(
            writer, "allreduce", mode, n,
            f"ring_opt needs elements % world == 0 ({args.elements} % {n})",
        )
        return
    spec.run(
        mesh=_mesh(args),
        dtype=args.dtype,
        writer=writer,
        elements=args.elements,
        algorithm=args.algorithm,
        mem_kind=args.mem_kind,
        reps=args.reps,
        warmup=args.warmup,
        tol=args.tol,
        require_even_ge4=args.require_even_ge4,
    )


LONGCTX_STRATEGIES = ("ring", "ring_pallas", "ring_striped", "ulysses",
                      "ulysses_pallas", "flash", "both")


def _longctx(args, writer: ResultWriter) -> None:
    """``tpu-patterns longctx`` (``tpu_patterns/cli.py:268-323``): the
    world-size skips, then :func:`run_longctx` over the rank mesh."""
    from tpu_patterns_torch.longctx.pattern import LongCtxConfig, run_longctx

    n = _ranks(args.devices, args.device)
    if args.strategy == "both":
        # on one rank, fold the fused kernels in so the agreement Record
        # cross-checks them against the plain lineages
        strategies = ("ring", "ulysses") + (("flash",) if n == 1 else ())
    else:
        strategies = (args.strategy,)
    if args.seq % n:
        _world_skip(writer, "longctx", args.strategy, n,
                    f"seq {args.seq} not divisible by sp={n}")
        return
    if any(s.startswith("ulysses") for s in strategies) and args.heads % n:
        if args.strategy != "both":
            _world_skip(writer, "longctx", args.strategy, n,
                        f"heads {args.heads} not divisible by sp={n} "
                        "(ulysses)")
            return
        # only the ulysses family needs heads % sp: the rest still run
        strategies = tuple(s for s in strategies
                           if not s.startswith("ulysses"))
        writer.progress(
            f"dropping ulysses: heads {args.heads} not divisible by sp={n}")
    if "flash" in strategies and n != 1:
        _world_skip(writer, "longctx", args.strategy, n,
                    f"flash strategy is single-device, have {n} "
                    "(use --devices 1)")
        return
    cfg = LongCtxConfig(**{f.name: getattr(args, f.name)
                           for f in dataclasses.fields(LongCtxConfig)
                           if f.name != "strategies"},
                        strategies=strategies)
    run_longctx(_mesh(args), cfg, writer)


def _overlap(args, writer: ResultWriter) -> None:
    from tpu_patterns_torch.parallel.overlap import OverlapConfig, run_overlap

    run_overlap(_mesh(args), _config(OverlapConfig, args), writer)


def _pipeline(args, writer: ResultWriter) -> None:
    """``tpu-patterns pipeline`` (``tpu_patterns/cli.py:687-713``): the
    ``n_micro % pp`` world skip, then :func:`run_pipeline` over
    ``--devices`` ranks."""
    from tpu_patterns_torch.comm.mesh import default_mesh
    from tpu_patterns_torch.parallel.pipeline import (
        PipelineConfig,
        run_pipeline,
    )

    n = _ranks(args.devices, args.device)
    schedules = (("gpipe", "1f1b") if args.schedule == "both"
                 else (args.schedule,))
    cfg = PipelineConfig(schedules=schedules, **{
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(PipelineConfig)
        if f.name != "schedules"})
    if cfg.n_micro % n:
        _world_skip(writer, "pipeline", args.schedule, n,
                    f"n_micro {cfg.n_micro} not divisible by pp={n}")
        return
    run_pipeline(default_mesh(n, args.device), cfg, writer)


def _moe(args, writer: ResultWriter) -> None:
    from tpu_patterns_torch.comm.mesh import default_mesh
    from tpu_patterns_torch.parallel.moe import MoEConfig, run_moe

    kw = {f.name: getattr(args, f.name) for f in dataclasses.fields(MoEConfig)
          if f.name != "capacity_factors"}
    if args.capacity_factor:
        kw["capacity_factors"] = tuple(args.capacity_factor)
    run_moe(default_mesh(_ranks(args.devices, args.device), args.device),
            MoEConfig(**kw), writer)


def _miniapps(args, writer: ResultWriter) -> None:
    """Every typed variant once (≙ ctest).  The world defaults to
    ``DEFAULT_NP`` ranks whatever the card count: the rank mesh places
    several on a card (the reference takes at most its device count)."""
    from tpu_patterns_torch.miniapps.framework import (
        DEFAULT_NP,
        default_mesh,
        run_all,
    )

    n = args.devices or DEFAULT_NP
    overrides = {}
    if args.elements:
        overrides["elements"] = args.elements
    if n < 4 or n % 2:
        overrides["require_even_ge4"] = False  # reduced mesh: keep apps runnable
    run_all(writer=writer, mesh=default_mesh(n, args.device), reps=args.reps,
            **overrides)


def _interop(args, writer: ResultWriter) -> None:
    """Native-interop round trips (≙ running the two interop binaries),
    with the reference's Records (``tpu_patterns/cli.py:778-850``): the
    typed and raw depths on CPU tensors (mode ``native``), then the host
    offload depths on the run's device (mode ``offload:gpu`` on the
    card, ``offload:cpu`` with ``--device cpu``)."""
    import torch

    from tpu_patterns_torch.core.results import Record, Verdict
    from tpu_patterns_torch.interop import calls, native
    from tpu_patterns_torch.runtime import resolve_device

    dev = resolve_device(args.device)
    if not native.available():
        writer.record(Record(
            pattern="interop", mode="native", verdict=Verdict.SKIPPED,
            notes=[f"native module unavailable: {native.build_error()}"]))
        return

    def record(mode: str, checks: dict[str, bool]) -> None:
        for name, ok in checks.items():
            writer.record(Record(
                pattern="interop", mode=mode, commands=name,
                verdict=Verdict.SUCCESS if ok else Verdict.FAILURE))

    x = torch.arange(256, dtype=torch.float32)
    y = torch.ones(256, dtype=torch.float32)
    record("native", {
        "clock": int(calls.ffi_clock_ns()[0]) > 0,
        "checksum": int(calls.ffi_checksum(x)[0]) == 255 * 256 // 2,
        "saxpy": torch.allclose(calls.ffi_saxpy(2.0, x, y), 2.0 * x + y),
        "raw_info": int(calls.raw_info(x)[3]) == 1,  # one tensor
    })

    dx, dy = x.to(dev), y.to(dev)
    want = (2.0 * x + y).to(dev)
    checks = {
        "offload_checksum": int(calls.offload_checksum(dx)[0])
        == 255 * 256 // 2,
        "offload_saxpy": torch.allclose(calls.offload_saxpy(2.0, dx, dy),
                                        want),
    }
    if calls.supports_host_callbacks(str(dev)):
        prog = torch.compile(lambda a, b: calls.host_saxpy(2.0, a, b),
                             fullgraph=True, backend="aot_eager")
        checks["host_callback_saxpy"] = torch.allclose(prog(dx, dy), want)
    record(f"offload:{'gpu' if dev.type == 'cuda' else 'cpu'}", checks)


def _add_concurrency_flags(p: argparse.ArgumentParser) -> None:
    from tpu_patterns_torch.concurrency.harness import ConcurrencyConfig

    p.add_argument(
        "--backend", choices=("xla", "pallas"), default="xla",
        help="xla: each command its own work, the compute C a launch of the "
        "busy-wait kernel (K6), copies copy_ calls, on one stream (serial), "
        "a stream each (concurrent) or dispatched with a device wait after "
        "each (dispatch_serial) or after all (dispatch_async); pallas: each "
        "group one launch of the copy-and-compute kernel (K7), D2D copies "
        "and computes in one kernel (dma_serial, dma_overlap)",
    )
    p.add_argument("--mode", default="concurrent")
    p.add_argument(
        "--commands", action="append", metavar='"C H2D"',
        help="command group; repeatable (default: \"C C\")",
    )
    _add_config_flags(p, ConcurrencyConfig,
                      skip=("backend", "mode", "commands"))
    p.add_argument("--no_tuning", action="store_true",
                   help="skip auto-tune")


def _concurrency(args, writer: ResultWriter) -> None:
    from tpu_patterns_torch.concurrency.harness import (
        ConcurrencyConfig,
        run_concurrency,
    )

    cfg = ConcurrencyConfig(
        backend=args.backend,
        mode=args.mode,
        commands=tuple(args.commands or ["C C"]),
        reps=args.reps,
        warmup=args.warmup,
        auto_tune=args.auto_tune and not args.no_tuning,
        min_bandwidth=args.min_bandwidth,
        tripcount=args.tripcount,
        elements=args.elements,
        copy_elements=args.copy_elements,
        device=args.device,
    )
    run_concurrency(cfg, writer)


def _add_p2p_flags(p: argparse.ArgumentParser) -> None:
    from tpu_patterns_torch.comm.onesided import KERNELS
    from tpu_patterns_torch.comm.p2p import P2PConfig

    _add_config_flags(p, P2PConfig)
    p.add_argument(
        "--transport", choices=("two_sided", "one_sided"),
        default="two_sided",
        help="two_sided: the pair exchange (even ranks to odd, then both "
        "ways), which needs an even rank count >= 2; one_sided: the "
        "one-device put, or the ring put over more ranks",
    )
    p.add_argument(
        "--put-kernel", choices=KERNELS, default="auto",
        help="one_sided copy schedule: the CUDA kernels streamed (K8b), "
        "multi (K8c), mono (K8a) and inplace (K8d), or xla, the contrast, "
        "which runs torch.roll by one row; auto measures streamed, multi, "
        "xla and inplace, then picks",
    )
    p.add_argument("--chunks", type=int, default=None,
                   help="multi and inplace: chunks in flight (default: "
                   "comm/tuned.json, else 8)")
    p.add_argument("--block-rows", type=int, default=None,
                   help="streamed: rows per shared-memory stage (default: "
                   "comm/tuned.json, else 1024)")
    _add_mesh_args(p)


def _p2p(args, writer: ResultWriter) -> None:
    """``tpu-patterns p2p``: the pair exchange over the placed ranks
    (the reference's SKIPPED Record on an odd count or fewer than 2), or
    the one-sided put (the local put on one rank, the ring put over
    more)."""
    from tpu_patterns_torch.comm.onesided import OneSidedConfig, run_onesided
    from tpu_patterns_torch.comm.p2p import P2PConfig, run_p2p

    n = _ranks(args.devices, args.device)
    if args.transport == "two_sided" and (n < 2 or n % 2):
        _world_skip(writer, "p2p", "two_sided", n,
                    f"p2p needs an even device count >= 2, have {n}")
        return
    mesh = _mesh(args)
    fields = {k: getattr(args, k) for k in _P2P_FIELDS}
    if args.transport == "two_sided":
        run_p2p(mesh, P2PConfig(bidirectional=args.bidirectional, **fields),
                writer)
        return
    tuned = {k: v for k, v in (("chunks", args.chunks),
                               ("block_rows", args.block_rows))
             if v is not None}
    run_onesided(OneSidedConfig(kernel=args.put_kernel, **tuned, **fields),
                 writer, mesh=mesh)


def _add_hier_flags(p: argparse.ArgumentParser) -> None:
    from tpu_patterns_torch.comm.hierarchical import HierConfig

    _add_config_flags(p, HierConfig)
    # no placement flags: the (dcn, ici) split is the placement
    p.add_argument("--devices", type=int, default=0,
                   help="ranks (0 = one per card)")
    p.add_argument("--device", choices=_CHOICES["device"],
                   default=_device_default())


def _hier(args, writer: ResultWriter) -> None:
    """``tpu-patterns hier`` with the reference's world checks, except
    that ranks may share a card (``--devices`` counts ranks)."""
    from tpu_patterns_torch.comm.hierarchical import (
        HierConfig,
        detect_hierarchy,
        run_hierarchical,
    )
    from tpu_patterns_torch.comm.mesh import default_mesh

    n = _ranks(args.devices, args.device)
    mesh = default_mesh(n, args.device)
    if args.dcn == 0:
        # an unequal grouping is a world-shape constraint: a skip
        try:
            detect_hierarchy(list(mesh.devices))
        except ValueError as e:
            _world_skip(writer, "hierarchical", "hier", n, str(e))
            return
    elif args.dcn < 1 or n % args.dcn or n // args.dcn < 2:
        _world_skip(writer, "hierarchical", "hier", n,
                    f"need dcn|{n} and ici >= 2, have dcn={args.dcn}")
        return
    run_hierarchical(mesh, _config(HierConfig, args), writer)


def _topo(args) -> None:
    """The fabric probe, in the lines of ``tpu-patterns topo``
    (``tpu_patterns/cli.py:752-775``)."""
    from tpu_patterns_torch.comm.hierarchical import detect_hierarchy
    from tpu_patterns_torch.topo.placement import PlacementMode, order_devices
    from tpu_patterns_torch.topo.topology import discover, local_devices

    devices = local_devices(args.device)
    topo = discover(devices)
    if args.n is not None:
        print(topo.entry(args.n))
        return
    print(topo.describe())
    for mode in PlacementMode:
        print(f"placement {mode.value}: {order_devices(topo, mode)}")
    try:
        n_groups, _ = detect_hierarchy(devices)
        print(f"hierarchy: {n_groups} slice group(s) "
              f"({len(devices)} devices)")
    except ValueError as e:
        print(f"hierarchy: irregular ({e})")


def _train(args, writer: ResultWriter) -> None:
    from tpu_patterns_torch.models.train_loop import TrainLoopConfig, train

    train(_config(TrainLoopConfig, args), writer, mesh=_mesh3d(args))


def _model_pattern(args, writer: ResultWriter) -> None:
    """``decode`` or ``lm`` over the ``--devices/--dp/--tp`` mesh."""
    from tpu_patterns_torch.models import decode, lm

    cls, run = {
        "decode": (decode.DecodeConfig, decode.run_decode),
        "lm": (lm.LMConfig, lm.run_lm),
    }[args.cmd]
    run(_config(cls, args), writer, mesh=_mesh3d(args))


def _ckpt(args) -> None:
    """Inspect a checkpoint directory (read-only, manifest-driven), in
    the lines of ``tpu-patterns ckpt`` (``tpu_patterns/cli.py:657``)."""
    from tpu_patterns_torch import ckpt

    info = ckpt.describe(args.dir)
    if not info["steps"]:
        print(f"no committed checkpoints under {info['root']}")
        return
    for s in info["steps"]:
        print(
            f"step_{s['step']}: {s['bytes'] / 1e6:.2f} MB, "
            f"{s['process_count']} process(es), {len(s['leaves'])} leaves"
        )
        if args.leaves:
            for leaf in s["leaves"]:
                # merged axes render as a+b, replicated dims as '-'
                parts = [
                    "+".join(e) if isinstance(e, list) else
                    ("-" if e is None else str(e))
                    for e in leaf["spec"]
                ]
                spec = ",".join(parts) or "-"
                print(f"  {leaf['key']}: {tuple(leaf['shape'])} "
                      f"{leaf['dtype']} spec=({spec})")
    print(f"latest: step_{info['steps'][-1]['step']}")


def _config(cls, args):
    return cls(**{f.name: getattr(args, f.name)
                  for f in dataclasses.fields(cls)})


def _checked(what: str, check) -> None:
    """Run a parse-time ``check``; a ValueError (a typo'd scenario or
    chaos spec, an unported field) exits with one line, before the
    model is built."""
    try:
        check()
    except ValueError as e:
        raise SystemExit(f"error: {what}: {e}") from e


def _serve(args, writer: ResultWriter) -> None:
    from tpu_patterns_torch.loadgen.runner import validate_config
    from tpu_patterns_torch.serve.engine import (
        ServeConfig,
        _refuse_unsupported,
        _run_scenario_config,
        run_serve,
    )

    if args.dp != 1:
        # the pool is shared state over sp x tp; batch rows are
        # scheduler slots, not a data axis (data-parallel serving is the
        # replica fleet)
        raise SystemExit(
            "error: serve requires --dp 1 (fold devices into sp); for "
            "data-parallel serving use --replicas N — N engine "
            "replicas behind the prefix-aware router"
        )
    cfg = _config(ServeConfig, args)
    _checked("serve", lambda: _refuse_unsupported(cfg))
    if cfg.scenario:
        _checked("serve --scenario",
                 lambda: validate_config(_run_scenario_config(cfg)))
    run_serve(cfg, writer, mesh=_mesh3d(args))


def _loadgen(args, writer: ResultWriter) -> None:
    from tpu_patterns_torch.loadgen.runner import (
        LoadGenConfig,
        run_loadgen,
        validate_config,
    )

    if args.dp != 1:
        raise SystemExit(
            "error: loadgen requires --dp 1 (fold devices into sp)")
    cfg = _config(LoadGenConfig, args)
    _checked("loadgen", lambda: validate_config(cfg))
    run_loadgen(cfg, writer, mesh=_mesh3d(args))


def _perf(args, writer: ResultWriter) -> None:
    """The performance observatory, as ``tpu-patterns perf`` runs it:
    capture the executable registry, bank the snapshot, then report /
    diff against the baseline / re-pin.  The diff's verdict Records are
    per executable, so a regression is named where it lives."""
    from tpu_patterns_torch.core import ratchet
    from tpu_patterns_torch.core.results import Record, Verdict
    from tpu_patterns_torch.perf import baseline as perf_baseline
    from tpu_patterns_torch.perf import history as perf_history
    from tpu_patterns_torch.perf import registry as perf_registry
    from tpu_patterns_torch.perf import report as perf_report

    bl_path = args.baseline or perf_baseline.default_baseline_path()
    if args.perf_cmd == "prune-stale":
        # no capture: staleness is registry truth (an entry whose
        # executable left the registry); surviving entries keep their
        # values and justifications byte for byte
        old = perf_baseline.load_baseline(bl_path)
        keep = {
            fp for fp, e in old.items()
            if e.get("executable") in perf_registry.EXECUTABLES
        }
        kept, dropped = ratchet.prune_stale(
            bl_path, keep, version=perf_baseline.BASELINE_VERSION,
        )
        for e in dropped:
            writer.progress(
                f"pruned stale entry: {e.get('executable')}."
                f"{e.get('metric')} {e.get('fingerprint')}"
            )
        writer.record(Record(
            pattern="perf", mode="prune-stale", commands=bl_path,
            metrics={"entries": float(kept), "dropped": float(len(dropped))},
        ))
        return
    cfg = _config(perf_registry.PerfConfig, args)
    if args.perf_cmd == "update-baseline" and cfg.include:
        raise SystemExit(
            "error: --update-baseline needs the FULL registry (no "
            "--include filter): a partial re-pin would drop the other "
            "executables' entries"
        )
    _checked("perf", lambda: perf_registry._selected(cfg))
    snap = perf_registry.capture(cfg, writer)
    if not args.no_history:
        path = perf_history.append_snapshot(snap, args.perf_dir)
        writer.progress(f"snapshot appended -> {path}")

    if args.perf_cmd == "report":
        timeline = perf_history.build_timeline(args.perf_dir)
        print(perf_report.render(snap, timeline))
        writer.record(Record(
            pattern="perf", mode="report",
            commands=f"{len(snap['executables'])} executables",
            metrics={
                "executables": float(len(snap["executables"])),
                "history_snapshots": float(len(timeline["snapshots"])),
                "bench_rounds": float(len(timeline["bench_rounds"])),
                "records_ingested": float(len(timeline["records"])),
            },
        ))
        return

    old = perf_baseline.load_baseline(bl_path)
    if args.perf_cmd == "update-baseline":
        n = perf_baseline.save_baseline(bl_path, snap, old)
        writer.record(Record(pattern="perf", mode="update-baseline",
                             commands=bl_path,
                             metrics={"entries": float(n)}))
        return

    tolerances = None
    if args.measured_tol < 0:
        tolerances = {"measured": None}  # informational this run
        writer.progress("measured entries informational for this diff "
                        "(--measured_tol < 0)")
    elif args.measured_tol:
        tolerances = {"measured": args.measured_tol}
    diff = perf_baseline.diff_snapshot(snap, old, tolerances=tolerances)
    by_exec: dict[str, list] = {}
    for f in diff.regressions:
        by_exec.setdefault(f.executable, []).append(f)
    for name in sorted(snap["executables"]):
        regs = by_exec.get(name, [])
        writer.record(Record(
            pattern="perf", mode=name, commands="perf diff",
            metrics={
                "regressions": float(len(regs)),
                "step_ms": snap["executables"][name].get("step_ms", -1.0),
            },
            verdict=Verdict.FAILURE if regs else Verdict.SUCCESS,
            notes=[f.message() for f in regs],
        ))
    for f in diff.improvements:
        writer.progress(f"improvement: {f.message()}")
    for s in diff.unbaselined:
        writer.progress(f"unbaselined (run perf update-baseline): {s}")
    for s in diff.skipped:
        writer.progress(f"skipped (foreign mesh fingerprint): {s}")
    for e in diff.stale:
        writer.progress(
            f"stale baseline entry: {e['executable']}.{e['metric']} "
            f"{e['fingerprint']} — update-baseline to drop it"
        )
    writer.record(Record(
        pattern="perf", mode="diff", commands=bl_path,
        metrics={
            "checked": float(diff.checked),
            "regressions": float(len(diff.regressions)),
            "improvements": float(len(diff.improvements)),
            "unbaselined": float(len(diff.unbaselined)),
            "skipped": float(len(diff.skipped)),
            "stale": float(len(diff.stale)),
        },
        verdict=Verdict.FAILURE if diff.regressions else Verdict.SUCCESS,
        notes=[f.message() for f in diff.regressions[:10]],
    ))


def _doctor(args, parser, writer: ResultWriter) -> None:
    """The health probes (``--workers true`` adds the warm worker's)."""
    from tpu_patterns_torch.core.doctor import DoctorConfig, run_doctor

    try:
        run_doctor(_config(DoctorConfig, args), writer)
    except ValueError as e:  # refused before any probe runs
        parser.error(str(e))


def _rate_records(path: str) -> list:
    """The JSON Records of a stream that carry a ``tflops_hw`` rate
    (marker lines carry no metrics)."""
    import json

    from tpu_patterns_torch.core.results import Record

    out = []
    with open(path) as f:
        for line in f:
            if not line.startswith("{"):
                continue
            try:
                rec = Record.from_json(line)
            except (json.JSONDecodeError, TypeError, ValueError):
                continue
            if "tflops_hw" in rec.metrics:
                out.append(rec)
    return out


def _profilecheck(args, writer: ResultWriter) -> None:
    """Validate a captured trace, as ``tpu-patterns profilecheck`` does:
    snapshot its device op names (the classifier fixture), gate on the
    share of busy time booked as ``other``, and — when
    ``--rates-jsonl`` names a Record stream with a ``tflops_hw`` rate —
    cross-check that rate against the breakdown's compute time."""
    import json

    from tpu_patterns_torch.core import profile as profile_mod
    from tpu_patterns_torch.core.results import Record, Verdict
    from tpu_patterns_torch.runtime import chip_peak_tflops

    names = profile_mod.op_name_snapshot(args.profile_dir)
    if names is None:
        writer.record(Record(
            pattern="profilecheck", mode="profile_ops",
            commands=args.profile_dir, verdict=Verdict.SKIPPED,
            notes=["no device plane under the trace dir"],
        ))
        return
    if args.snapshot_out:
        with open(args.snapshot_out, "w") as f:
            json.dump(names, f, indent=1, sort_keys=True)
        writer.progress(f"op-name fixture written to {args.snapshot_out}")
    total_ps = sum(d["duration_ps"] for d in names.values()) or 1
    other_ps = sum(d["duration_ps"] for d in names.values()
                   if d["category"] == "other")
    frac_other = other_ps / total_ps
    rec = Record(
        pattern="profilecheck", mode="profile_ops",
        commands=args.profile_dir,
        metrics={"unique_names": float(len(names)),
                 "frac_other_time": round(frac_other, 4)},
        # an unclassified hot op silently skews every breakdown fraction
        verdict=Verdict.SUCCESS if frac_other <= 0.2 else Verdict.WARNING,
    )
    if frac_other > 0.2:
        worst = sorted(
            (n for n, d in names.items() if d["category"] == "other"),
            key=lambda n: -names[n]["duration_ps"],
        )[:5]
        rec.notes.append(
            f"{frac_other:.0%} of busy time unclassified; top: {worst}"
        )
    writer.record(rec)
    if not args.rates_jsonl:
        return
    bd = profile_mod.breakdown(args.profile_dir)
    rate_recs = _rate_records(args.rates_jsonl)
    if bd is None or not rate_recs:
        writer.record(Record(
            pattern="profilecheck", mode="profile_crosscheck",
            commands=args.rates_jsonl, verdict=Verdict.SKIPPED,
            notes=["no breakdown or no tflops_hw record to check"],
        ))
        return
    r = rate_recs[-1]  # newest rate in the stream
    # dtype-aware ceiling on the card that banked the rate (None off it)
    peak = None
    if r.config.get("device", "cuda") != "cpu":
        import torch

        if torch.cuda.is_available():
            peak = chip_peak_tflops(r.config.get("dtype"))
    cc = profile_mod.crosscheck_rate(
        r.metrics["tflops_hw"], bd, peak,
        n_chips=int(bd.get("n_device_planes", 1)),
    )
    coherent = cc.get("coherent")
    rec = Record(
        pattern="profilecheck", mode="profile_crosscheck",
        commands=f"{r.mode} | {r.commands}",
        metrics={k: round(v, 4) for k, v in cc.items()},
        verdict=Verdict.SUCCESS if coherent != 0.0 else Verdict.FAILURE,
    )
    if coherent == 0.0:
        if "implied_mxu_tflops" in cc:
            rec.notes.append(
                f"implied on-compute rate {cc['implied_mxu_tflops']:.1f} "
                f"TFLOP/s exceeds {cc['peak_bound_tflops']:.1f} — FLOP "
                "count or classifier accounting is wrong"
            )
        else:
            rec.notes.append(
                "positive tflops_hw with ZERO classified compute time — "
                "the classifier books every hot op outside 'compute'"
            )
    writer.record(rec)


def _sweep(args, writer: ResultWriter) -> int:
    """``sweep``: run a suite, summarize a directory, or promote a run,
    with the reference's refusals (``tpu_patterns/cli.py``)."""
    from tpu_patterns_torch import sweep

    if args.gates_dir and args.suite != "promote":
        raise SystemExit("--gates-dir applies to 'sweep promote' only")
    if args.flash_dir and args.suite != "promote":
        raise SystemExit("--flash-dir applies to 'sweep promote' only")
    if args.suite in ("promote", "summarize") and (
        args.jobs != 1 or args.no_warm_workers or args.name
    ):
        # promote and summarize run no cells: engine flags are no-ops
        raise SystemExit(
            "--jobs/--no-warm-workers/--name do not apply to "
            f"'sweep {args.suite}'"
        )
    if args.jobs < 0:
        raise SystemExit("--jobs must be >= 0 (0 = auto, 1 = serial)")
    if args.suite == "summarize":
        if args.quick or args.resume:
            raise SystemExit(
                "--quick/--resume do not apply to 'sweep summarize'"
            )
        print(sweep.summarize_sweep(args.out))
        return 0
    if args.suite == "promote":
        picked = [d for d in (args.gates_dir, args.flash_dir) if d]
        if picked and args.out != "results":
            raise SystemExit(
                "pass EXACTLY ONE of --out (tune), --gates-dir (gate "
                "width), or --flash-dir (flash blocks)"
            )
        if len(picked) > 1:
            raise SystemExit(
                "pass EXACTLY ONE of --gates-dir or --flash-dir"
            )
        if args.gates_dir:
            fit = sweep.promote_gates(args.gates_dir)
            print(f"# promoted gates fit: {fit}")
        elif args.flash_dir:
            tuned = sweep.promote_flash(args.flash_dir)
            print(f"# flash promotion: {tuned}")
        else:
            tuned = sweep.promote_tuned(args.out)
            print(f"# promoted {tuned}")
        return 0
    try:
        rc = sweep.run_sweep(
            args.suite, out_dir=args.out, quick=args.quick,
            resume=args.resume, cell_timeout=args.cell_timeout,
            names=args.name, jobs=args.jobs,
            warm_workers=not args.no_warm_workers,
        )
    except ValueError as e:
        # usage errors (unknown --name cells, empty matches) read as one
        # line at the CLI boundary, not a traceback
        raise SystemExit(f"error: {e}") from e
    if args.suite == "gates":
        fit = sweep.fit_gates(args.out)
        print(f"# gates fit: {fit}")
        if any(c["defect"] for c in fit["configs"].values()):
            rc = 1  # clean code over the gate = kernel defect, not noise
    elif args.suite == "runtime":
        # flag a sweep whose knobs all measured inert
        writer.record(sweep.check_runtime_bite(args.out))
    return rc


def _report(args) -> None:
    """``report``: the tables of ``tpu-patterns report`` over logs and
    JSONL of either package; grad records from before the FLOP-
    accounting fix that are not marked superseded are refused (exit 2)."""
    from tpu_patterns_torch.core.results import (
        parse_log,
        prefer_refined,
        stale_grad_records,
        tabulate_records,
    )

    lines: list[str] = []
    for path in args.paths:
        with open(path) as f:
            lines.extend(f.readlines())
    records = parse_log(lines)
    stale = stale_grad_records(records)
    if stale:
        for r in stale:
            print(
                f"# REFUSED: {r.mode} | {r.commands} predates the grad "
                "accounting fix and is not marked superseded",
                file=sys.stderr,
            )
        raise SystemExit(2)
    # a refined measurement supersedes its first-pass quick twin
    print(tabulate_records(prefer_refined(records)))


def _dispatch(args, parser, writer: ResultWriter) -> None:
    from tpu_patterns_torch.models.flagship import (
        FlagshipConfig,
        run_flagship,
    )

    if args.cmd == "obs":
        _obs(args, writer)
    elif args.cmd == "serve":
        _serve(args, writer)
    elif args.cmd == "loadgen":
        _loadgen(args, writer)
    elif args.cmd == "p2p":
        _p2p(args, writer)
    elif args.cmd == "hier":
        _hier(args, writer)
    elif args.cmd == "topo":
        _topo(args)
    elif args.cmd == "concurrency":
        _concurrency(args, writer)
    elif args.cmd == "allreduce":
        _allreduce(args, writer)
    elif args.cmd == "miniapps":
        _miniapps(args, writer)
    elif args.cmd == "interop":
        _interop(args, writer)
    elif args.cmd == "longctx":
        _longctx(args, writer)
    elif args.cmd == "overlap":
        _overlap(args, writer)
    elif args.cmd == "pipeline":
        _pipeline(args, writer)
    elif args.cmd == "moe":
        _moe(args, writer)
    elif args.cmd == "train":
        _train(args, writer)
    elif args.cmd == "ckpt":
        _ckpt(args)
    elif args.cmd in ("decode", "lm"):
        _model_pattern(args, writer)
    elif args.cmd == "perf":
        _perf(args, writer)
    elif args.cmd == "doctor":
        _doctor(args, parser, writer)
    elif args.cmd == "profilecheck":
        _profilecheck(args, writer)
    elif args.cmd == "report":
        _report(args)
    else:
        run_flagship(_config(FlagshipConfig, args), writer,
                     mesh=_mesh3d(args))


def _profiled(args, parser, writer: ResultWriter) -> None:
    """Run the subcommand under torch.profiler, export the Kineto trace
    under ``--profile_dir``, and bank its ``profile_breakdown`` Record.
    An unparsable trace, or one with no device event, gives a progress
    line and no Record; the pattern's own verdict stands either way."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_patterns_torch.core import profile as profile_mod
    from tpu_patterns_torch.core.results import Record, Verdict

    os.makedirs(args.profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        _dispatch(args, parser, writer)
    path = os.path.join(args.profile_dir,
                        f"{args.cmd}_{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    writer.progress(f"profile trace written to {path}")
    try:
        planes = profile_mod.parse_trace(path)
        bd = profile_mod.breakdown_of(planes)
    except (OSError, ValueError, KeyError, TypeError) as e:
        # a truncated/corrupt trace: the run itself succeeded
        writer.progress(f"trace unparsable ({type(e).__name__}: {e})")
        bd = None
    if bd is None:
        writer.progress("no device plane in the trace (host-only run?) — "
                        "no breakdown Record")
        return
    # the run's device ops by name and launch count: the Record names
    # the kernels the run went through
    ops = {n: d["count"] for n, d in profile_mod.op_names(planes).items()}
    writer.record(Record(
        pattern=args.cmd, mode="profile_breakdown", commands=path,
        metrics={k: round(v, 4) for k, v in bd.items()},
        config={"device_ops": ops},
        verdict=Verdict.SUCCESS,
    ))


def main(argv: list[str] | None = None) -> int:
    import os

    from tpu_patterns_torch import faults, obs
    from tpu_patterns_torch.perf import provenance

    parser = build_parser()
    args = parser.parse_args(argv)
    # one CLI invocation = one run: every Record this run banks carries
    # a fresh run_id (a warm worker calls main() once a cell)
    provenance.new_run()
    if args.obs_dir:
        obs.configure(args.obs_dir)
    if args.cmd != "obs":  # the reader must not dump over what it reads
        obs.install_crash_handlers()
    # fault site: a whole CLI run (one sweep cell) crashing or hanging
    # before dispatch; the sweep's retry and quarantine recover.  Cells
    # are matchable by name: the sweep exports TPU_PATTERNS_CELL.
    faults.inject(
        "cell.run",
        cmd=args.cmd,
        cell=os.environ.get("TPU_PATTERNS_CELL", ""),
    )
    writer = ResultWriter(jsonl_path=args.jsonl)
    if args.cmd == "sweep":
        for flag, why in (
            (args.jsonl, "--jsonl does not apply to sweep (each cell "
             "writes <name>.jsonl under --out)"),
            (args.enable_profiling, "--enable_profiling does not apply to "
             "sweep (cells are subprocesses; profile an individual pattern "
             "run instead)"),
            (args.obs_dump, "--obs-dump does not apply to sweep (cells are "
             "subprocesses with their own recorders; pass it to an "
             "individual pattern run)"),
        ):
            if flag:
                raise SystemExit(f"error: {why}")
        return _sweep(args, writer)
    if args.enable_profiling:
        _profiled(args, parser, writer)
    else:
        _dispatch(args, parser, writer)
    if args.obs_dump and args.cmd != "obs":
        from tpu_patterns_torch.obs import cost as _cost

        writer.progress(f"obs spans -> {obs.dump(reason='end_of_run')}")
        writer.progress(f"obs metrics -> {obs.dump_metrics()}")
        if _cost.books():  # serve/loadgen paths register engine books
            writer.progress(f"obs cost -> {obs.dump_cost()}")
    return writer.exit_code


if __name__ == "__main__":
    sys.exit(main())
