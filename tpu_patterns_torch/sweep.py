"""Config-matrix sweeps: every suite's cells on the port's CLI.

The port's counterpart of ``tpu_patterns/sweep.py`` (≙ p2p/run.sh and
concurency/run_{omp,sycl}.sh, with parse.py's tables).  Each cell is one
subprocess invocation of ``python -m tpu_patterns_torch`` (a fresh
process is a fresh CUDA context, as a fresh ``mpirun`` is a fresh
runtime); the cell's env context is written into its log as
``export K=V`` lines (the lines ``core/results.parse_log`` keys tables
by), and every cell appends JSONL Records for ``report``.

The suites and their cell names are the JAX package's: a cell's name is
its identity in the state file, ``--name``, ``report`` and the promotion
helpers.  Their argv is the reference's, translated where the port's
flags take other words (:data:`ARGV_TRANSLATION`: the attention
back-ends ``xla``/``pallas`` are ``dense``/``kernel`` here) and where a
quick shape's head_dim is under what the ported kernels take
(:data:`MIN_HEAD_DIM`), and where a cell sets mesh axes but no
``--devices`` (:func:`translate_argv` holds the three rules).  The
``runtime`` suite's knobs are the CUDA and PyTorch runtime's, not
libtpu's, and its configs are named for what they toggle
(:data:`RUNTIME_ENV_CONFIGS`).

The sweep writes only under ``--out``; it reads no archived Records of
the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
from typing import Mapping, Sequence

# the package whose CLI the cells run; it also leads every state-file
# signature (see _spec_sig)
PACKAGE = "tpu_patterns_torch"

# Name suffix of a first-pass (reps-cut breadth tier) twin cell; the
# base cell name is `name.removesuffix(FIRST_PASS_SUFFIX)`.
FIRST_PASS_SUFFIX = ".fp"

# The JAX package's suite argv -> the port's: (flag, reference value) ->
# port value.  Cell names keep the reference's words.
ARGV_TRANSLATION: dict[tuple[str, str], str] = {
    ("--attn", "xla"): "dense",
    ("--attn", "pallas"): "kernel",
    ("--paged_attn", "pallas"): "kernel",
}

# The least head_dim every ported attention kernel takes (the flash
# kernels K2-K4 take 64 or 128, the paged kernel K1 32 to 256).  The
# reference's quick shapes (head_dim 8 or 32) run on its CPU simulator;
# here a quick cell runs on the card, so its head_dim is raised to this
# and its ``--embed`` by the same factor (the head count stays).
MIN_HEAD_DIM = 64


def translate_argv(argv: Sequence[str]) -> tuple[str, ...]:
    """A JAX-package cell's argv as the port's CLI takes it: the words
    of :data:`ARGV_TRANSLATION`, a head_dim under :data:`MIN_HEAD_DIM`
    raised to it with ``--embed`` scaled alike, and ``--devices`` the
    product of the mesh axes where the cell names axes but no ranks."""
    out = list(argv)
    for i in range(len(out) - 1):
        port = ARGV_TRANSLATION.get((out[i], out[i + 1]))
        if port is not None:
            out[i + 1] = port
    if "--head_dim" in out:
        i = out.index("--head_dim") + 1
        factor = MIN_HEAD_DIM // int(out[i])
        if factor > 1:
            out[i] = str(MIN_HEAD_DIM)
            if "--embed" in out:
                j = out.index("--embed") + 1
                out[j] = str(int(out[j]) * factor)
    # the reference's --devices 0 is every device of its 8-device CPU
    # mesh, the port's one rank a card: a cell that sets mesh axes and
    # no --devices asks for the ranks they need
    axes = [int(out[out.index(f) + 1]) for f in ("--dp", "--sp", "--tp")
            if f in out]
    if axes and "--devices" not in out:
        out += ["--devices", str(math.prod(axes))]
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One cell of a sweep matrix: a CLI invocation + env context."""

    name: str
    argv: tuple[str, ...]  # CLI args after the program name
    env: tuple[tuple[str, str], ...] = ()  # extra env (the swept knobs)

    def with_env(self, **kv: str) -> "SweepSpec":
        return dataclasses.replace(self, env=self.env + tuple(kv.items()))


# Framework-internal measurement-mode configs.  Each is tagged via
# TPU_PATTERNS_SWEEP_CONFIG so results.context_env() keys report tables
# by it.
CONCURRENCY_ENV_CONFIGS: dict[str, dict[str, str]] = {
    "default": {},
    "direct_timing": {"TPU_PATTERNS_TIMING": "direct"},
    "amortized_timing": {"TPU_PATTERNS_TIMING": "amortized"},
}

# Runtime-knob configs (≙ run_omp.sh:14-18 / run_sycl.sh:13-16, whose
# env sweeps toggle the GPU runtime's immediate command lists and copy
# engines): each entry toggles the CUDA driver's or PyTorch's behavior,
# read when the process starts or makes its CUDA context, so every cell
# runs in a fresh subprocess (exec/classify.py: ENV_ISOLATED).
# name -> (env, the targets the knob bites on).  The JAX package's table
# holds libtpu and JAX knobs, which do nothing on a GPU.
RUNTIME_ENV_CONFIGS: dict[str, tuple[dict[str, str], frozenset]] = {
    "default": ({}, frozenset({"concurrency", "flagship"})),
    # every launch synchronous: no two commands overlap, and the host
    # waits out each kernel (the concurrency modes lose their overlap,
    # the train step its launch-ahead)
    "launch_blocking": (
        {"CUDA_LAUNCH_BLOCKING": "1"},
        frozenset({"concurrency", "flagship"}),
    ),
    # one hardware work queue for all streams: independent streams
    # serialize behind each other's launches
    "one_hw_queue": (
        {"CUDA_DEVICE_MAX_CONNECTIONS": "1"},
        frozenset({"concurrency", "flagship"}),
    ),
    # PyTorch's caching allocator off: every tensor is a cudaMalloc and
    # a cudaFree (synchronizing) of its own
    "no_caching_allocator": (
        {"PYTORCH_NO_CUDA_MEMORY_CACHING": "1"},
        frozenset({"concurrency", "flagship"}),
    ),
    # every module of the CUDA libraries loaded at context creation
    # rather than at first use: exposes the start costs the lazy default
    # spreads over the first launches
    "eager_module_loading": (
        {"CUDA_MODULE_LOADING": "EAGER"},
        frozenset({"concurrency"}),
    ),
    # cuBLAS may run float32 products in TF32: a speed/accuracy knob for
    # every float32 matmul of the train step (the quick tier's flagship
    # is float32; the full tier's bfloat16 step is inert to it)
    "tf32_cublas_override": (
        {"TORCH_ALLOW_TF32_CUBLAS_OVERRIDE": "1"},
        frozenset({"flagship"}),
    ),
}


def runtime_specs(quick: bool = False) -> list[SweepSpec]:
    """Runtime-knob sweep: RUNTIME_ENV_CONFIGS x {three concurrency
    modes, the flagship train step through the flash kernels}.  The
    report (keyed by the runtime.<config> tag) shows one table a
    config: the reference's per-env-config tables (parse.py)."""
    conc = (
        ("--elements", "4096", "--copy_elements", "16384",
         "--tripcount", "64", "--reps", "2")
        if quick
        else ("--reps", "10")
    )
    flag = QUICK_FLAGSHIP if quick else (
        "--seq", "4096", "--batch", "2", "--reps", "5", "--attn", "kernel"
    )
    conc_modes = (
        ("xla", "concurrent", "C H2D"),
        ("xla", "dispatch_async", "C C"),
        ("pallas", "dma_overlap", "C C"),
    )
    specs = []
    for cfg_name, (env, targets) in RUNTIME_ENV_CONFIGS.items():
        tag = {"TPU_PATTERNS_SWEEP_CONFIG": f"runtime.{cfg_name}"}
        if "concurrency" in targets:
            for backend, mode, mix in conc_modes:
                specs.append(
                    SweepSpec(
                        name=f"runtime.{cfg_name}.{backend}.{mode}",
                        argv=(
                            "concurrency", "--backend", backend,
                            "--mode", mode, "--commands", mix, *conc,
                        ),
                        env=tuple({**env, **tag}.items()),
                    )
                )
        if "flagship" in targets:
            specs.append(
                SweepSpec(
                    name=f"runtime.{cfg_name}.flagship",
                    argv=("flagship", *flag),
                    env=tuple({**env, **tag}.items()),
                )
            )
    return specs


# The five command mixes of run_omp.sh:9, with the M (pageable host)
# mixes routed through the dispatch modes and the copy-and-compute
# kernel restricted to device work.
XLA_INPROGRAM_MIXES = ("C C", "C H2D", "C D2H", "H2D D2H")
XLA_DISPATCH_MIXES = ("C M2D", "C D2M", "M2D D2M")
PALLAS_MIXES = ("C C", "C D2D", "C C D2D")


def p2p_specs(quick: bool = False) -> list[SweepSpec]:
    """≙ run.sh:9-21: modes x mechanisms x transports x rank counts."""
    from tpu_patterns_torch.topo.placement import Mechanism, PlacementMode

    # 0 = one rank a card (≙ the 12-rank run)
    sizes = [2] if quick else [2, 0]
    count = ["--count", "65536", "--reps", "2"] if quick else []
    specs = []
    for mode in PlacementMode:
        for mech in Mechanism:
            for transport in ("two_sided", "one_sided"):
                for n in sizes:
                    specs.append(
                        SweepSpec(
                            name=(f"p2p.{mode.value}.{mech.value}."
                                  f"{transport}.n{n or 'all'}"),
                            argv=(
                                "p2p",
                                "--transport", transport,
                                "--placement", mode.value,
                                "--mechanism", mech.value,
                                "--devices", str(n),
                                *count,
                            ),
                            # table key: cells differing only in placement x
                            # mechanism would collide in the report otherwise
                            env=(
                                (
                                    "TPU_PATTERNS_SWEEP_CONFIG",
                                    f"p2p.{mode.value}.{mech.value}",
                                ),
                            ),
                        )
                    )
    return specs


def concurrency_specs(quick: bool = False) -> list[SweepSpec]:
    """≙ run_omp.sh / run_sycl.sh: env configs x backend modes x mixes."""
    small = (
        ("--tripcount", "200", "--elements", "256",
         "--copy_elements", "16384", "--reps", "2")
        if quick
        else ()
    )
    matrix: list[tuple[str, str, tuple[str, ...]]] = []
    for mode in ("serial", "concurrent"):
        matrix.append(("xla", mode, XLA_INPROGRAM_MIXES))
    for mode in ("dispatch_serial", "dispatch_async"):
        matrix.append(("xla", mode, XLA_DISPATCH_MIXES))
    for mode in ("dma_serial", "dma_overlap"):
        matrix.append(("pallas", mode, PALLAS_MIXES))
    configs = {"default": {}} if quick else CONCURRENCY_ENV_CONFIGS
    specs = []
    for cfg_name, env in configs.items():
        for backend, mode, mixes in matrix:
            argv: list[str] = ["concurrency", "--backend", backend,
                               "--mode", mode]
            for mix in mixes:
                argv += ["--commands", mix]
            argv += list(small)
            specs.append(
                SweepSpec(
                    name=f"concurrency.{cfg_name}.{backend}.{mode}",
                    argv=tuple(argv),
                    env=tuple(
                        {**env, "TPU_PATTERNS_SWEEP_CONFIG": cfg_name}.items()
                    ),
                )
            )
    return specs


def allreduce_specs(quick: bool = False) -> list[SweepSpec]:
    """Variant x algorithm x allocator matrix (≙ the miniapp build matrix
    with the -a/-H/-D/-S runtime flags)."""
    from tpu_patterns_torch.miniapps.framework import discover

    elements = ["--elements", "4096", "--reps", "2"] if quick else []
    kinds = ("D",) if quick else ("D", "H", "S")
    specs = []
    for spec in discover():
        if spec.app != "allreduce":
            continue
        dtypes = spec.dtypes[:1] if quick else spec.dtypes
        for dtype in dtypes:
            for alg in spec.axes.get("algorithm", ("ring",)):
                for kind in kinds:
                    specs.append(
                        SweepSpec(
                            name=(f"allreduce.{spec.variant}.{dtype}."
                                  f"{alg}.{kind}"),
                            argv=(
                                "allreduce",
                                "--variant", spec.variant,
                                "--dtype", dtype,
                                "--algorithm", alg,
                                "--mem_kind", kind,
                                *elements,
                            ),
                            # one table for the matrix: the records' mode
                            # and commands columns tell every cell apart
                            env=(("TPU_PATTERNS_SWEEP_CONFIG", "allreduce"),),
                        )
                    )
    return specs


# Quick workloads shared by the suite matrices and their `measured`
# twins, so the shapes cannot drift apart; their attention shapes are the
# reference's raised to MIN_HEAD_DIM (translate_argv).
QUICK_LONGCTX = ("--seq", "256", "--head_dim", "64", "--reps", "2")
QUICK_FLAGSHIP = (
    "--embed", "512", "--head_dim", "64", "--seq", "128", "--batch", "2",
    "--dtype", "float32", "--reps", "2",
)
QUICK_DECODE = (
    "--prefill", "16", "--gen", "8", "--batch", "2", "--embed", "512",
    "--head_dim", "64", "--depth", "1", "--dtype", "float32",
    "--reps", "2", "--warmup", "1",
)
QUICK_SERVE = (
    "--vocab", "64", "--embed", "512", "--head_dim", "64", "--depth", "1",
    "--requests", "6", "--min_prompt", "4", "--max_prompt", "16",
    "--gen", "6", "--slots", "4", "--block_len", "8",
)


def longctx_specs(quick: bool = False) -> list[SweepSpec]:
    """Strategy x causal x dtype matrix over the full rank world, plus
    the one-rank kernel-vs-dense agreement cell."""
    small = QUICK_LONGCTX if quick else (
        "--seq", "4096", "--head_dim", "128", "--dtype", "bfloat16",
    )
    specs = []
    for strategy in ("ring", "ulysses"):
        for causal in ("true", "false") if not quick else ("true",):
            specs.append(
                SweepSpec(
                    name=f"longctx.{strategy}.causal_{causal}",
                    argv=(
                        "longctx", "--strategy", strategy,
                        "--causal", causal, *small,
                    ),
                    env=(("TPU_PATTERNS_SWEEP_CONFIG", "longctx"),),
                )
            )
    # the kernel-vs-dense agreement cell (flash folds in at --devices 1)
    specs.append(
        SweepSpec(
            name="longctx.agreement.1dev",
            argv=("longctx", "--devices", "1", *small),
            env=(("TPU_PATTERNS_SWEEP_CONFIG", "longctx"),),
        )
    )
    # backward cells: fwd+bwd measured with gradient gates
    for strategy in ("ring", "ring_pallas", "ulysses", "ulysses_pallas"):
        specs.append(
            SweepSpec(
                name=f"longctx.grad.{strategy}",
                argv=(
                    "longctx", "--strategy", strategy, "--grad", "true",
                    *small,
                ),
                env=(("TPU_PATTERNS_SWEEP_CONFIG", "longctx.grad"),),
            )
        )
    specs.append(
        SweepSpec(
            name="longctx.grad.flash.1dev",
            argv=(
                "longctx", "--devices", "1", "--strategy", "flash",
                "--grad", "true", *small,
            ),
            env=(("TPU_PATTERNS_SWEEP_CONFIG", "longctx.grad"),),
        )
    )
    return specs


def parallel_specs(quick: bool = False) -> list[SweepSpec]:
    """Schedules x feeds (pipeline) and capacity regimes (moe), decode,
    lm and the collective matmul over the rank mesh, and the flagship
    train-step contrasts."""
    specs = []
    pipe_small = (
        ("--n_micro", "8", "--dim", "64", "--batch", "2", "--reps", "2")
        if quick
        else ("--n_micro", "8",)
    )
    for sched in ("gpipe", "1f1b"):
        for sharded in ("true", "false"):
            specs.append(
                SweepSpec(
                    name=f"pipeline.{sched}.sharded_{sharded}",
                    argv=(
                        "pipeline", "--schedule", sched,
                        "--micro_sharded", sharded, *pipe_small,
                    ),
                    env=(("TPU_PATTERNS_SWEEP_CONFIG", "pipeline"),),
                )
            )
    moe_small = (
        ("--tokens", "64", "--reps", "2") if quick else ("--tokens", "512")
    )
    specs.append(
        SweepSpec(
            name="moe.capacity",
            argv=(
                "moe", "--capacity_factor", "0", "--capacity_factor", "2.0",
                "--capacity_factor", "1.0", *moe_small,
            ),
            env=(("TPU_PATTERNS_SWEEP_CONFIG", "moe"),),
        )
    )
    decode_small = (
        QUICK_DECODE
        if quick
        else ("--prefill", "4096", "--gen", "64", "--batch", "4",
              "--depth", "2")
    )
    specs.append(
        SweepSpec(
            name="decode.kv_cache",
            argv=("decode", *decode_small),
            env=(("TPU_PATTERNS_SWEEP_CONFIG", "decode"),),
        )
    )
    # the layout x feature matrix over a real sp axis: striped placement
    # and expert routing differ from the base cell only when sp/tp > 1
    specs.append(
        SweepSpec(
            name="decode.kv_cache_striped",
            argv=("decode", "--layout", "striped", *decode_small),
            env=(("TPU_PATTERNS_SWEEP_CONFIG", "decode"),),
        )
    )
    specs.append(
        SweepSpec(
            name="decode.kv_cache_moe",
            # --tp 2: experts ride the tp axis (one a rank)
            argv=("decode", "--moe", "true", "--tp", "2", *decode_small,
                  "--devices", "2"),
            env=(("TPU_PATTERNS_SWEEP_CONFIG", "decode"),),
        )
    )
    lm_small = (
        ("--vocab", "64", "--embed", "512", "--head_dim", "64",
         "--seq", "32", "--steps", "5", "--gen", "8")
        if quick
        else ("--vocab", "2048", "--seq", "512", "--steps", "30",
              "--gen", "64")
    )
    specs.append(
        SweepSpec(
            name="lm.vocab_parallel",
            argv=("lm", *lm_small),
            env=(("TPU_PATTERNS_SWEEP_CONFIG", "lm"),),
        )
    )
    overlap_small = (
        ("--rows", "16", "--contract", "64", "--cols", "32",
         "--dtype", "float32", "--reps", "2", "--warmup", "1")
        if quick
        else ("--rows", "512", "--contract", "4096", "--cols", "2048")
    )
    specs.append(
        SweepSpec(
            name="overlap.collective_matmul",
            argv=("overlap", *overlap_small),
            env=(("TPU_PATTERNS_SWEEP_CONFIG", "overlap"),),
        )
    )
    flag_small = QUICK_FLAGSHIP if quick else ("--seq", "4096", "--batch", "2")
    for attn in ("xla", "pallas"):
        specs.append(
            SweepSpec(
                name=f"flagship.{attn}",
                argv=("flagship", "--attn", ARGV_TRANSLATION["--attn", attn],
                      *flag_small),
                env=(("TPU_PATTERNS_SWEEP_CONFIG", "flagship"),),
            )
        )
    # sharded-optimizer contrast: ZeRO-1 adam inside the grad reduction
    specs.append(
        SweepSpec(
            name="flagship.zero_adam",
            argv=(
                "flagship", "--attn", "dense", "--optimizer", "zero-adam",
                *flag_small,
            ),
            env=(("TPU_PATTERNS_SWEEP_CONFIG", "flagship"),),
        )
    )
    # remat contrast at depth
    for remat in ("false", "true"):
        specs.append(
            SweepSpec(
                name=f"flagship.deep.remat_{remat}",
                argv=(
                    "flagship", "--attn", "dense", "--depth", "4",
                    "--remat", remat, *flag_small,
                ),
                env=(("TPU_PATTERNS_SWEEP_CONFIG", "flagship"),),
            )
        )
    return specs


def serve_specs(quick: bool = False) -> list[SweepSpec]:
    """Continuous-batching serve matrix: the base engine cell, the int8
    pool, a GQA pool, copy-on-write prefix sharing, speculative decode,
    the fused paged-attention kernel (K1) and the kv host tier under
    load, each with the engine's full verdict set."""
    small = QUICK_SERVE if quick else (
        "--requests", "24", "--max_prompt", "96", "--gen", "32",
        "--slots", "8", "--block_len", "16", "--embed", "256",
        "--vocab", "1024",
    )
    # the quick prefix cell's own geometry: 8 requests x 75% shared, two
    # full shared blocks of 8 (QUICK_SERVE's prompts hold only one)
    prefix_small = small if not quick else (
        "--vocab", "64", "--embed", "512", "--head_dim", "64", "--depth",
        "1", "--requests", "8", "--min_prompt", "4", "--max_prompt",
        "24", "--gen", "6", "--slots", "8", "--block_len", "8",
        "--shared_prefix", "16",
    )
    # the kv-tier cell owns its trace through the scenario spec; only
    # the model and pool dims ride the flags
    kv_dims = (
        ("--vocab", "64", "--embed", "512", "--head_dim", "64",
         "--depth", "1", "--slots", "4", "--block_len", "8")
        if quick
        else ("--embed", "256", "--vocab", "1024", "--slots", "8",
              "--block_len", "8")
    )
    env = (("TPU_PATTERNS_SWEEP_CONFIG", "serve"),)
    return [
        SweepSpec(name="serve.continuous", argv=("serve", *small), env=env),
        SweepSpec(
            name="serve.int8_pool",
            argv=("serve", "--cache_int8", "true", *small),
            env=env,
        ),
        SweepSpec(
            name="serve.gqa_pool",
            argv=("serve", "--kv_heads", "2", *small),
            env=env,
        ),
        SweepSpec(
            name="serve.prefix_share",
            argv=("serve", *prefix_small, "--prefix_share", "true"),
            env=env,
        ),
        SweepSpec(
            name="serve.spec_decode",
            argv=("serve", *small, "--spec_k", "4"),
            env=env,
        ),
        # the fused paged-attention kernel (K1) on the base cell's trace
        # and dims: serve.pallas_attn vs serve.continuous is a direct A/B
        SweepSpec(
            name="serve.pallas_attn",
            argv=("serve", *small, "--paged_attn", "kernel"),
            env=env,
        ),
        # the tiered KV cache under load: the pool sized under the
        # concurrent working set (every request needs exactly 5 blocks)
        SweepSpec(
            name="serve.kv_tier",
            argv=(
                "serve", *kv_dims, "--kv_host_tier", "true",
                "--time_scale", "0.02",
                "--scenario",
                "chat:requests=16:min_prompt=26:mean_prompt=28"
                ":max_prompt=30:min_gen=8:mean_gen=9:max_gen=10"
                ":prefix_groups=1:shared_prefix=16"
                ":working_set_mult=1.4"
                ":slo_ttft_ms=60000:slo_tpot_ms=20000",
            ),
            env=env,
        ),
    ]


def loadgen_specs(quick: bool = False) -> list[SweepSpec]:
    """Trace-driven SLO matrix: one cell a scenario preset (chat, rag,
    batch-summarize, agentic) through the same engine, plus a chaos cell
    re-serving the chat schedule with transient decode faults."""
    env = (("TPU_PATTERNS_SWEEP_CONFIG", "loadgen"),)
    if quick:
        shape = (
            "--vocab", "64", "--embed", "512", "--head_dim", "64",
            "--depth", "1", "--slots", "4", "--block_len", "8",
            "--time_scale", "0.02",
            "--slo_ttft_ms", "60000", "--slo_tpot_ms", "20000",
        )
        scen = {
            "chat": "chat:requests=6:min_prompt=4:mean_prompt=8"
                    ":max_prompt=16:min_gen=2:mean_gen=4:max_gen=6",
            "rag": "rag:requests=5:min_prompt=12:mean_prompt=20"
                   ":max_prompt=24:min_gen=2:mean_gen=3:max_gen=4",
            "batch_summarize": "batch-summarize:requests=5:min_prompt=8"
                               ":mean_prompt=16:max_prompt=24:min_gen=3"
                               ":mean_gen=5:max_gen=8",
            "agentic": "agentic:requests=8:min_prompt=3:mean_prompt=6"
                       ":max_prompt=12:min_gen=2:mean_gen=3:max_gen=5",
        }
    else:
        shape = (
            "--time_scale", "0.05",
            "--slo_ttft_ms", "30000", "--slo_tpot_ms", "5000",
        )
        scen = {
            "chat": "chat",
            "rag": "rag",
            "batch_summarize": "batch-summarize",
            "agentic": "agentic",
        }
    specs = [
        SweepSpec(
            name=f"loadgen.{cell}",
            argv=("loadgen", "--scenarios", spec, *shape),
            env=env,
        )
        for cell, spec in scen.items()
    ]
    # chaos under load: two separated transient decode faults (one retry
    # each, never two in a row, so no quarantine)
    specs.append(
        SweepSpec(
            name="loadgen.chaos_chat",
            argv=(
                "loadgen", "--scenarios", scen["chat"], *shape,
                "--chaos",
                "serve.step:error:count=1,serve.step:error:after=6:count=1",
                "--chaos_p99_mult", "50",
            ),
            env=env,
        )
    )
    return specs


def hier_specs(quick: bool = False) -> list[SweepSpec]:
    """Hierarchy matrix: outer (dcn) axis size x dtype, the flat-vs-
    hierarchical contrast at each split."""
    count = ("--count", "4096", "--reps", "2") if quick else ()
    specs = []
    for dcn in (2, 4):
        for dtype in ("float32",) if quick else ("float32", "int32"):
            specs.append(
                SweepSpec(
                    name=f"hier.dcn{dcn}.{dtype}",
                    argv=("hier", "--dcn", str(dcn), "--dtype", dtype, *count),
                )
            )
    return specs


def measured_specs(quick: bool = False) -> list[SweepSpec]:
    """The headline-record matrix in one resumable command
    (``python -m tpu_patterns_torch sweep measured --out DIR``): the
    one-sided put, interop, the concurrency matrix, the flash kernels,
    the flagship step and its levers, decode and lm, each on one card.
    Its Records land under ``--out`` only."""
    env = (("TPU_PATTERNS_SWEEP_CONFIG", "measured"),)
    if quick:  # the same argv surface at small workloads
        onesided = ("--count", "65536", "--reps", "2")
        flash = QUICK_LONGCTX
        # the "long" twin doubles seq so cell names stay distinct
        flash_long = ("--seq", "512") + QUICK_LONGCTX[2:]
        flagship = QUICK_FLAGSHIP
        flagship_long = QUICK_FLAGSHIP[:6] + (
            "--batch", "1", "--dtype", "float32", "--reps", "2",
        )
        conc = (
            "--elements", "4096", "--copy_elements", "16384",
            "--tripcount", "64", "--reps", "2",
        )
    else:
        onesided = ("--reps", "10")
        flash = ("--seq", "4096", "--reps", "5")
        flash_long = ("--seq", "8192", "--reps", "5")
        flagship = ("--seq", "4096", "--batch", "2", "--reps", "5")
        flagship_long = ("--seq", "8192", "--batch", "1", "--reps", "5")
        conc = ("--reps", "10",)
    specs = [
        SweepSpec(
            name="measured.onesided_hbm",
            argv=(
                "p2p", "--transport", "one_sided", "--devices", "1",
                *onesided,
            ),
            env=env,
        ),
        SweepSpec(name="measured.interop", argv=("interop",), env=env),
    ]
    # the concurrency matrix: overlap wins only against transfers and
    # dispatch, so compute+compute cells read FAILURE by design (resume
    # treats a completed FAILURE as a result, not a retry)
    for backend, mode, mix in (
        ("xla", "concurrent", "C C"),
        ("xla", "concurrent", "C H2D"),
        ("xla", "concurrent", "H2D D2H"),
        ("xla", "dispatch_async", "C C"),
        ("xla", "dispatch_async", "C H2D"),
        ("pallas", "dma_overlap", "C C"),
    ):
        specs.append(
            SweepSpec(
                name=(
                    f"measured.concurrency.{backend}.{mode}."
                    f"{mix.replace(' ', '_')}"
                ),
                argv=(
                    "concurrency", "--backend", backend, "--mode", mode,
                    "--commands", mix, *conc,
                ),
                env=env,
            )
        )
    # flash is the one-rank fused kernel: --devices 1, or a multi-rank
    # world SKIPs the cell
    for causal, args in (
        ("true", flash),
        ("true", flash_long),
        ("false", flash_long),
    ):
        seq = args[args.index("--seq") + 1]
        specs.append(
            SweepSpec(
                name=f"measured.flash_bf16_L{seq}_causal_{causal}",
                argv=(
                    "longctx", "--devices", "1", "--strategy", "flash",
                    "--dtype", "bfloat16", "--causal", causal, *args,
                ),
                env=env,
            )
        )
    specs.append(
        SweepSpec(
            name="measured.flash_bf16_grad",
            argv=(
                "longctx", "--devices", "1", "--strategy", "flash",
                "--dtype", "bfloat16", "--causal", "true", "--grad", "true",
                *flash,
            ),
            env=env,
        )
    )
    # flash tile-shape lever cells
    for name, bq, bk, grad in (
        ("fwd_bq512_bk2048", "512", "2048", None),
        ("fwd_bq512_bk1024", "512", "1024", None),
        ("grad_bq1024_bk512", "1024", "512", "true"),
    ):
        specs.append(
            SweepSpec(
                name=f"measured.flash_blocks.{name}",
                argv=(
                    "longctx", "--devices", "1", "--strategy", "flash",
                    "--dtype", "bfloat16", "--causal", "true",
                    "--block_q", bq, "--block_k", bk,
                    *(("--grad", grad) if grad else ()),
                    *flash,
                ),
                env=env,
            )
        )
    # ...and the same lever at the flagship level, paired against
    # measured.flagship_pallas (promote_flash reads the pair)
    specs.append(
        SweepSpec(
            name="measured.flagship.pallas_bq512_bk1024",
            argv=(
                "flagship", "--attn", "kernel",
                "--block_q", "512", "--block_k", "1024", *flagship,
            ),
            env=env,
        )
    )
    # the causal grid compaction, paired against the dense-grid cells
    for args in (flash, flash_long):
        seq = args[args.index("--seq") + 1]
        specs.append(
            SweepSpec(
                name=f"measured.flash_compact_L{seq}",
                argv=(
                    "longctx", "--devices", "1", "--strategy", "flash",
                    "--dtype", "bfloat16", "--causal", "true",
                    "--causal_grid", "compact", *args,
                ),
                env=env,
            )
        )
    specs.append(
        SweepSpec(
            name="measured.flash_compact_grad",
            argv=(
                "longctx", "--devices", "1", "--strategy", "flash",
                "--dtype", "bfloat16", "--causal", "true", "--grad",
                "true", "--causal_grid", "compact", *flash,
            ),
            env=env,
        )
    )
    specs.append(
        SweepSpec(
            name="measured.flagship_pallas_compact",
            # one rank: run_flagship refuses the compact grid at sp > 1
            argv=(
                "flagship", "--attn", "kernel", "--devices", "1",
                "--attn_grid", "compact", *flagship,
            ),
            env=env,
        )
    )
    specs.append(
        SweepSpec(
            name="measured.flagship.pallas_compact_bq512_bk1024",
            argv=(
                "flagship", "--attn", "kernel", "--devices", "1",
                "--attn_grid", "compact",
                "--block_q", "512", "--block_k", "1024", *flagship,
            ),
            env=env,
        )
    )
    for variant, extra, sizes in (
        ("xla", (), flagship),
        ("pallas", (), flagship),
        ("xla_L8192", (), flagship_long),
        ("pallas_L8192", (), flagship_long),
        ("zero_adam", ("--optimizer", "zero-adam"), flagship),
        ("pallas_remat", ("--remat", "true"), flagship),
        ("pallas_remat_dots",
         ("--remat", "true", "--remat_policy", "dots"), flagship),
        ("pallas_depth4", ("--depth", "4"), flagship),
        ("pallas_gqa2", ("--kv_heads", "2"), flagship),
        ("pallas_rope", ("--rope", "true"), flagship),
    ):
        attn = "kernel" if variant.startswith("pallas") else "dense"
        specs.append(
            SweepSpec(
                name=f"measured.flagship_{variant}",
                argv=("flagship", "--attn", attn, *extra, *sizes),
                env=env,
            )
        )
    # long-context decode throughput on one card
    decode_args = (
        QUICK_DECODE
        if quick
        else ("--prefill", "8192", "--gen", "128", "--batch", "4",
              "--depth", "4")
    )
    specs.append(
        SweepSpec(
            name="measured.decode_kv_cache",
            argv=("decode", "--devices", "1", *decode_args),
            env=env,
        )
    )
    specs.append(
        SweepSpec(
            name="measured.decode_kv_cache_gqa",
            argv=("decode", "--devices", "1", "--kv_heads", "2",
                  *decode_args),
            env=env,
        )
    )
    specs.append(
        SweepSpec(
            name="measured.decode_kv_cache_int8",
            argv=("decode", "--devices", "1", "--cache_int8", "true",
                  *decode_args),
            env=env,
        )
    )
    lm_args = (
        ("--vocab", "64", "--embed", "512", "--head_dim", "64",
         "--seq", "32", "--steps", "5", "--gen", "8")
        if quick
        else ("--vocab", "4096", "--embed", "512", "--seq", "1024",
              "--steps", "20", "--gen", "64", "--dtype", "bfloat16")
    )
    specs.append(
        SweepSpec(
            name="measured.lm_vocab_parallel",
            argv=("lm", "--devices", "1", *lm_args),
            env=env,
        )
    )
    # Per-cell config tags: distinct cells can emit records with
    # identical (pattern, mode, commands) keys, so the report tables and
    # the first-pass supersede logic key by the CELL.
    specs = [
        dataclasses.replace(s, env=(("TPU_PATTERNS_SWEEP_CONFIG", s.name),))
        for s in specs
    ]
    # Bank the highest-value cells first (--resume keeps whatever landed
    # before an interruption): the flagship headline pair leads, then its
    # lever cells, the flash matrix, decode and lm, concurrency, and the
    # rest.  The sort is stable, so in-group order stays as built.
    headline = {"measured.flagship_pallas", "measured.flagship_xla"}
    order = (
        ("measured.flagship", 1),
        ("measured.flash", 2),
        ("measured.decode", 3),
        ("measured.lm", 3),
        ("measured.concurrency", 4),
    )

    def _prio(s: SweepSpec) -> int:
        base = s.name.removesuffix(FIRST_PASS_SUFFIX)
        if base in headline:
            return 0
        return next(
            (p for prefix, p in order if base.startswith(prefix)), 5
        )

    specs.sort(key=_prio)
    if quick:
        return specs
    # Two-phase ordering: phase 1 (the ``.fp`` twins, same priority
    # order) runs every cell at full size with the repetition count cut
    # to the least that still gives a min-over-reps number; phase 2 is
    # the refined matrix.  fp records carry TPU_PATTERNS_SWEEP_TIER=
    # first_pass, so ``report`` drops a twin once its refined record
    # exists (results.prefer_refined).
    first_pass = []
    for s in specs:
        argv = list(s.argv)
        for flag, fast in (("--reps", "2"), ("--steps", "5")):
            if flag in argv:
                i = argv.index(flag)
                if int(argv[i + 1]) > int(fast):
                    argv[i + 1] = fast
        if tuple(argv) == s.argv:
            # repetition already minimal: the refined cell IS the first
            # pass; a twin would re-run the identical workload
            continue
        first_pass.append(
            dataclasses.replace(
                s,
                name=s.name + FIRST_PASS_SUFFIX,
                argv=tuple(argv),
                env=s.env + (("TPU_PATTERNS_SWEEP_TIER", "first_pass"),),
            )
        )
    return first_pass + specs


def tune_specs(quick: bool = False) -> list[SweepSpec]:
    """Copy-schedule search for the one-card put: chunks in flight for
    the multi kernel (K8c) x rows a stage for the streamed kernel (K8b).
    ``sweep promote`` writes the winners to ``comm/tuned.json``."""
    base = ("p2p", "--transport", "one_sided", "--devices", "1")
    # the quick count keeps count/512 >= 2048 rows, so the three
    # block-size cells stay distinct configurations
    size = ("--count", "1048576", "--reps", "2") if quick else ("--reps", "5")
    specs = []
    for chunks in (4, 8, 16, 32, 64):
        name = f"tune.multi.chunks{chunks}"
        specs.append(
            SweepSpec(
                name=name,
                argv=(
                    *base, "--put-kernel", "multi",
                    "--chunks", str(chunks), *size,
                ),
                # a per-cell tag: the records' mode and commands are the
                # same across cells, so the report keys rows by this
                env=(("TPU_PATTERNS_SWEEP_CONFIG", name),),
            )
        )
    for rows in (512, 1024, 2048):
        name = f"tune.streamed.rows{rows}"
        specs.append(
            SweepSpec(
                name=name,
                argv=(
                    *base, "--put-kernel", "streamed",
                    "--block-rows", str(rows), *size,
                ),
                env=(("TPU_PATTERNS_SWEEP_CONFIG", name),),
            )
        )
    return specs


def asymptote_specs(quick: bool = False) -> list[SweepSpec]:
    """The copy rate's asymptote: (a) the multi schedule over a 16x span
    of buffer sizes (a kernel-limited rate moves with size, a memory-
    limited one is flat once past the caches); (b) chunk counts between
    tune's; (c) the in-place schedule (K8d), half the live footprint."""
    base = ("p2p", "--transport", "one_sided", "--devices", "1")
    reps = ("--reps", "2") if quick else ("--reps", "5")
    specs = []
    # 47/94/189/377/755 MB of f32; the default full-size cell (no
    # --count) is 40 units = 188.7 MB
    unit = 65536 if quick else 1179648 * 10

    def size_label(mult: int) -> str:
        # from the buffer's bytes, so multi and inplace cells at one
        # --count carry one size tag; kB under 10 MB
        nbytes = unit * mult * 4
        if nbytes < 10_000_000:
            return f"size{nbytes // 1000}KB"
        return f"size{round(nbytes / 1e6)}MB"

    for mult in (1, 2) if quick else (1, 2, 4, 8, 16):
        name = f"asymptote.multi.{size_label(mult)}"
        specs.append(
            SweepSpec(
                name=name,
                argv=(*base, "--put-kernel", "multi",
                      "--count", str(unit * mult), *reps),
                env=(("TPU_PATTERNS_SWEEP_CONFIG", name),),
            )
        )
    for chunks in (6,) if quick else (6, 10, 12):
        name = f"asymptote.multi.chunks{chunks}"
        specs.append(
            SweepSpec(
                name=name,
                argv=(*base, "--put-kernel", "multi",
                      "--chunks", str(chunks),
                      *(("--count", str(unit)) if quick else ()), *reps),
                env=(("TPU_PATTERNS_SWEEP_CONFIG", name),),
            )
        )
    inplace_cells = [("chunks8", ("--count", str(unit)) if quick else ())]
    if not quick:  # the aliased schedule at the far end too
        inplace_cells.append((size_label(16), ("--count", str(unit * 16))))
    for tag, extra in inplace_cells:
        name = f"asymptote.inplace.{tag}"
        specs.append(
            SweepSpec(
                name=name,
                argv=(*base, "--put-kernel", "inplace", *extra, *reps),
                env=(("TPU_PATTERNS_SWEEP_CONFIG", name),),
            )
        )
    return specs


def gates_specs(quick: bool = False) -> list[SweepSpec]:
    """Grad-gate refit matrix: each grad config runs N consecutive
    times, and ``fit_gates`` turns the violation spread into a
    recommended gate width (``sweep promote --gates-dir`` commits it to
    ``longctx/gates_fit.json``)."""
    runs = 2 if quick else 10
    size = ("--seq", "1024", "--reps", "1") if quick else (
        "--seq", "4096", "--reps", "3"
    )
    configs = [
        ("flash_bf16_causal", ("--strategy", "flash", "--dtype", "bfloat16")),
        ("flash_f32_causal", ("--strategy", "flash", "--dtype", "float32")),
    ]
    if not quick:
        configs.append(
            (
                "flash_bf16_noncausal",
                ("--strategy", "flash", "--dtype", "bfloat16",
                 "--causal", "false"),
            )
        )
        configs.append(
            (
                "flash_bf16_compact",
                ("--strategy", "flash", "--dtype", "bfloat16",
                 "--causal_grid", "compact"),
            )
        )
    specs = []
    for cname, flags in configs:
        for r in range(runs):
            name = f"gates.{cname}.r{r}"
            specs.append(
                SweepSpec(
                    name=name,
                    argv=(
                        "longctx", "--devices", "1", "--grad", "true",
                        *flags, *size,
                    ),
                    env=(("TPU_PATTERNS_SWEEP_CONFIG", f"gates.{cname}"),),
                )
            )
    return specs


def fit_gates(out_dir: str) -> dict:
    """Refit the grad gate width from a completed ``sweep gates`` run.

    Reads every ``gates.*.jsonl``, groups the ``*_grad`` records by
    config, and reports per config the run count, the violation spread
    and the recommended width in eps units,
    ``ceil(max(gate_width_needed_eps) * 1.5)`` floored at 2 (records
    without that metric contribute ``violation * gate_width_eps``).  A
    max violation > 1 on clean code is a kernel defect, not gate noise.
    Writes ``gates_fit.json`` into ``out_dir`` and returns the dict;
    raises when the dir holds no grad records."""
    import glob
    import json
    import math

    from tpu_patterns_torch.core.results import parse_log
    from tpu_patterns_torch.longctx.pattern import _gate_width_eps

    by_cfg: dict[str, list[tuple[float, float]]] = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "gates.*.jsonl"))):
        cfg_name = os.path.basename(path)[: -len(".jsonl")].rsplit(".", 1)[0]
        with open(path) as f:
            for rec in parse_log(f.readlines()):
                if (rec.mode.endswith("_grad")
                        and "gate_violation" in rec.metrics):
                    v = rec.metrics["gate_violation"]
                    needed = rec.metrics.get(
                        "gate_width_needed_eps",
                        v * rec.metrics.get("gate_width_eps", 8.0),
                    )
                    by_cfg.setdefault(cfg_name, []).append((v, needed))
    if not by_cfg:
        raise FileNotFoundError(
            f"fit_gates: no completed grad records under {out_dir}"
        )
    fit: dict[str, dict] = {}
    for cfg_name, runs in sorted(by_cfg.items()):
        violations = [v for v, _ in runs]
        vmax, vmin = max(violations), min(violations)
        eps_max = max(needed for _, needed in runs)
        fit[cfg_name] = {
            "runs": len(runs),
            "violation_min": vmin,
            "violation_max": vmax,
            "recommended_width_eps": max(2, math.ceil(eps_max * 1.5)),
            "defect": vmax > 1.0,  # clean code over the gate = kernel bug
            "gate_loose_10x": vmax < 0.1,
        }
    out = {
        # informational: the width live at fit time
        "current_width_eps": _gate_width_eps(),
        "configs": fit,
        "recommended_width_eps": max(
            c["recommended_width_eps"] for c in fit.values()
        ),
    }
    with open(os.path.join(out_dir, "gates_fit.json"), "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    return out


def check_runtime_bite(out_dir: str, platform: str | None = None):
    """Post-pass over a completed ``sweep runtime`` run: at least one
    knob config must measure differently from ``default`` by more than
    a noise band, or the sweep is flagged (a misspelled knob is ignored
    by the runtime that reads it, and a no-op sweep must not pass for
    coverage).

    Groups records by target (cell name minus the config segment),
    takes each record's headline metric, and compares every config
    against the default's.  One ``runtime_bite`` Record: SUCCESS when
    some config moved some target by > 2%, WARNING when every knob
    measured inert on the card, SKIPPED when the cells ran on the CPU
    (the knobs act on the CUDA runtime, which a CPU run never starts).
    ``platform`` defaults to ``exec.detect_platform()``, which makes no
    CUDA context in this process; the JAX package reads ``"tpu"`` here.
    """
    import glob

    from tpu_patterns_torch.core.results import Record, Verdict, parse_log

    if platform is None:
        from tpu_patterns_torch.exec.classify import detect_platform

        platform = detect_platform()
    NOISE = 0.02
    # target -> config -> headline metric value
    values: dict[str, dict[str, float]] = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "runtime.*.jsonl"))):
        cell = os.path.basename(path)[: -len(".jsonl")]
        _, cfg_name, target = cell.split(".", 2)  # runtime.<config>.<target>
        with open(path) as f:
            for rec in parse_log(f.readlines()):
                if not rec.metrics:
                    continue
                metric, value = next(iter(rec.metrics.items()))
                values.setdefault(f"{target}:{metric}", {})[cfg_name] = value
    moved: dict[str, float] = {}
    for target, per_cfg in values.items():
        base = per_cfg.get("default")
        if base is None or base == 0:
            continue
        for cfg_name, v in per_cfg.items():
            if cfg_name == "default":
                continue
            rel = abs(v - base) / abs(base)
            if rel > moved.get(target, 0.0):
                moved[target] = rel
    biting = {t: r for t, r in moved.items() if r > NOISE}
    if platform != "cuda":
        verdict, note = Verdict.SKIPPED, (
            "records came from a CPU run: the knobs act on the CUDA "
            "runtime, which the cells never started"
        )
    elif biting:
        verdict, note = Verdict.SUCCESS, ""
    else:
        verdict, note = Verdict.WARNING, (
            "every runtime knob measured within the noise band of "
            "default — knobs may be silently ignored (typo?)"
        )
    rec = Record(
        pattern="sweep",
        mode="runtime_bite",
        commands=f"{len(values)} targets x {NOISE:.0%} noise",
        metrics={
            "targets": float(len(values)),
            "biting_targets": float(len(biting)),
            "max_rel_move": max(moved.values(), default=0.0),
        },
        verdict=verdict,
    )
    if note:
        rec.notes.append(note)
    return rec


def _write_json_atomic(dest: str, obj: dict, fsync: bool = False) -> None:
    """tmp + rename: a killed promotion must not leave a truncated file."""
    import json

    tmp = dest + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write("\n")
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, dest)


def promote_tuned(tune_dir: str, dest: str | None = None) -> dict:
    """Fold a ``sweep tune`` run into the one-sided put's defaults.

    Reads every ``tune.*.jsonl`` under ``tune_dir``, takes the best
    SUCCESS ``bandwidth_GBps`` a kernel family (multi: its chunks;
    streamed: its block rows), and writes the winners to ``dest``
    (default: the port's ``comm/tuned.json``, which ``OneSidedConfig``
    reads each time a config is built).  Returns the promoted dict;
    raises FileNotFoundError when the dir holds no completed tune cells.
    """
    import glob
    import json
    import re

    best: dict[str, tuple[float, int]] = {}  # family -> (gbps, knob)
    for path in sorted(glob.glob(os.path.join(tune_dir, "tune.*.jsonl"))):
        m = re.match(r"tune\.(multi|streamed)\.(?:chunks|rows)(\d+)$",
                     os.path.basename(path)[: -len(".jsonl")])
        if not m:
            continue
        family, knob = m.group(1), int(m.group(2))
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                rec = json.loads(line)
                gbps = rec.get("metrics", {}).get("bandwidth_GBps")
                # only SUCCESS cells may become defaults, however fast a
                # FAILURE cell ran
                if gbps is None or rec.get("verdict") != "SUCCESS":
                    continue
                if family not in best or gbps > best[family][0]:
                    best[family] = (gbps, knob)
    if not best:
        raise FileNotFoundError(
            f"no completed tune.*.jsonl cells with bandwidth under {tune_dir}"
        )
    tuned: dict = {"source": os.path.abspath(tune_dir)}
    if "multi" in best:
        tuned["chunks"] = best["multi"][1]
        tuned["multi_GBps"] = best["multi"][0]
    if "streamed" in best:
        tuned["block_rows"] = best["streamed"][1]
        tuned["streamed_GBps"] = best["streamed"][0]
    if dest is None:
        from tpu_patterns_torch.comm import onesided

        dest = onesided.TUNED_PATH
    _write_json_atomic(dest, tuned)
    return tuned


# flagship block-shape lever cells -> the (block_q, block_k) they pin;
# promote_flash compares each against the base cell
_FLASH_LEVER_CELLS = {
    "measured.flagship.pallas_bq512_bk1024": (512, 1024),
}
_FLASH_BASE_CELL = "measured.flagship_pallas"
# a lever must beat the base by more than run-to-run noise
_FLASH_PROMOTE_MARGIN = 1.02


def _flagship_cell_tflops(
    measured_dir: str, cell: str
) -> tuple[float, str] | None:
    """(tflops, tier) of a measured flagship cell: the refined record,
    else its first-pass twin; None without a converged SUCCESS record."""
    import json

    for name, tier in ((cell, "refined"),
                       (cell + FIRST_PASS_SUFFIX, "first_pass")):
        try:
            with open(os.path.join(measured_dir, name + ".jsonl")) as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            if not line.strip():
                continue
            rec = json.loads(line)
            m = rec.get("metrics", {})
            if (
                rec.get("verdict") == "SUCCESS"
                and m.get("tflops")
                and m.get("timing_converged", 1.0) != 0.0
            ):
                return float(m["tflops"]), tier
    return None


def promote_flash(measured_dir: str, dest: str | None = None) -> dict:
    """Fold a measured flagship block-shape win into the flash defaults
    (``longctx/flash_tuned.json``, read by ``longctx/tuning.py``).

    Promotes only when a lever cell beat the base cell by more than
    ``_FLASH_PROMOTE_MARGIN`` with converged timings on both sides and in
    the same tier; returns ``{"promoted": False, ...}`` without writing
    when the base stands.  Raises FileNotFoundError when the pair has no
    usable records.  The compact causal grid is never promoted: it is
    the one-rank path only.
    """
    base = _flagship_cell_tflops(measured_dir, _FLASH_BASE_CELL)
    levers = {
        cell: (_flagship_cell_tflops(measured_dir, cell), shape)
        for cell, shape in _FLASH_LEVER_CELLS.items()
    }
    present = {c: (r, s) for c, (r, s) in levers.items() if r is not None}
    if base is None or not present:
        raise FileNotFoundError(
            f"no converged flagship base+lever cell pair under "
            f"{measured_dir} (base: {base}, levers: "
            f"{sorted(_FLASH_LEVER_CELLS)})"
        )
    (base_tflops, base_tier) = base
    best_cell, ((lever_tflops, lever_tier), shape) = max(
        present.items(), key=lambda kv: kv[1][0][0]
    )
    out = {
        "source": os.path.abspath(measured_dir),
        "base_cell": _FLASH_BASE_CELL,
        "base_tflops": base_tflops,
        "base_tier": base_tier,
        "lever_cell": best_cell,
        "lever_tflops": lever_tflops,
        "lever_tier": lever_tier,
    }
    if base_tier != lever_tier:
        # a reps=2 number against a reps=10 one: the tier bias alone can
        # clear the margin
        return {**out, "promoted": False, "reason": "tier mismatch"}
    if lever_tflops <= _FLASH_PROMOTE_MARGIN * base_tflops:
        return {**out, "promoted": False, "reason": "within noise margin"}
    if dest is None:
        from tpu_patterns_torch.longctx.tuning import FLASH_TUNED_PATH

        dest = FLASH_TUNED_PATH
    tuned = {**out, "promoted": True,
             "block_q": shape[0], "block_k": shape[1]}
    _write_json_atomic(dest, tuned, fsync=True)
    return tuned


def promote_gates(gates_dir: str, dest: str | None = None) -> dict:
    """Fold a clean ``sweep gates`` refit into the committed grad-gate
    width (``longctx/gates_fit.json``, read by
    ``longctx/pattern._gate_width_eps``).  Refuses a fit with any
    defect-flagged config (clean code over the gate is a kernel bug to
    fix, not a width to widen); raises FileNotFoundError when no
    ``gates_fit.json`` exists under ``gates_dir``."""
    import json

    with open(os.path.join(gates_dir, "gates_fit.json")) as f:
        fit = json.load(f)
    bad = sorted(n for n, c in fit["configs"].items() if c.get("defect"))
    if bad:
        raise ValueError(
            f"refusing to promote a defect-flagged gates fit: {bad} — "
            "a clean run over the current gate is a kernel defect"
        )
    if dest is None:
        from tpu_patterns_torch.longctx.pattern import GATES_FIT_PATH

        dest = GATES_FIT_PATH
    out = dict(fit, source=os.path.abspath(gates_dir))
    _write_json_atomic(dest, out)
    return out


SUITES = {
    "p2p": p2p_specs,
    "hier": hier_specs,
    "measured": measured_specs,
    "tune": tune_specs,
    "asymptote": asymptote_specs,
    "gates": gates_specs,
    "concurrency": concurrency_specs,
    "runtime": runtime_specs,
    "allreduce": allreduce_specs,
    "longctx": longctx_specs,
    "parallel": parallel_specs,
    "serve": serve_specs,
    "loadgen": loadgen_specs,
}


def specs_for(suite: str, quick: bool = False) -> list[SweepSpec]:
    if suite == "all":
        return [s for name in SUITES for s in SUITES[name](quick)]
    return SUITES[suite](quick)


def suite_complete(out_dir: str, suite: str, quick: bool = False) -> bool:
    """True iff every cell of ``suite`` reached a verdict in ``out_dir``
    (SUCCESS or an honest FAILURE, not a timeout, a crash or never run)
    under the current spec signature, the match resume requires."""
    state = load_sweep_state(out_dir, suite)
    return all(
        s.name in state
        and state[s.name]["completed"]
        and state[s.name]["sig"] == _spec_sig(s, None)
        for s in specs_for(suite, quick)
    )


# Primary-metric preference for the summary: first key present wins.
_SUMMARY_METRICS = (
    "tflops_hw", "tflops", "bandwidth_GBps", "speedup", "tokens_per_s",
    "gen_tokens_per_s", "train_steps_per_s", "bubble_fraction", "step_ms",
    "min_time_us",
)


def summarize_sweep(out_dir: str) -> str:
    """Markdown summary of whatever suite cells have records in
    ``out_dir``: one row a record (refined superseding first-pass twins,
    ``results.prefer_refined``), the primary metric chosen by family,
    integrity flags inline.  Bf16 flagship cells get an MFU table
    against the dense bf16 peak of the card their records name; the
    asymptote's size cells get the copy rate's curve over buffer size.
    """
    from tpu_patterns_torch.core.results import (
        Verdict,
        integrity_flags,
        parse_log,
        prefer_refined,
        stale_grad_records,
    )

    lines = [f"# Sweep summary: `{out_dir}`", ""]
    found_any = False
    asym_sizes: list[tuple[float, float]] = []  # (MB, GB/s) SUCCESS cells
    best_hbm: tuple[float, str] | None = None
    flagship_cells: dict[str, tuple[float, str, str]] = {}
    for suite in SUITES:
        # both tiers' cell names: a --quick run banks under different
        # names; the completion ratio counts against the full tier only
        full_specs = specs_for(suite)
        full_names = {s.name for s in full_specs}
        specs = full_specs + [
            s for s in specs_for(suite, quick=True)
            if s.name not in full_names
        ]
        cell_records = []
        done = 0
        quick_extras = 0
        for spec in specs:
            rec_lines: list[str] = []
            for ext in (".log", ".jsonl"):
                path = os.path.join(out_dir, spec.name + ext)
                try:
                    with open(path) as f:
                        rec_lines.extend(f.readlines())
                except OSError:
                    continue
            recs = [r for r in parse_log(rec_lines) if not r.superseded]
            if recs:
                if spec.name in full_names:
                    done += 1
                else:
                    quick_extras += 1
                cell_records.extend((spec.name, r) for r in recs)
        if not cell_records:
            continue
        found_any = True
        # the refusal `report` enforces: grad rates from before the
        # FLOP-accounting fix never reach a table
        refused = {
            id(r) for r in stale_grad_records(r for _, r in cell_records)
        }
        kept = prefer_refined(
            r for _, r in cell_records if id(r) not in refused
        )
        kept_ids = {id(r) for r in kept}
        lines.append(
            f"## {suite} ({done}/{len(full_specs)} cells with records"
            + (f", +{quick_extras} quick-tier" if quick_extras else "")
            + ")"
        )
        if refused:
            lines.append(
                f"(refused {len(refused)} grad record(s) from before the "
                "FLOP-accounting fix that are not marked superseded)"
            )
        lines.append("")
        lines.append("| cell | mode | metric | value | verdict |")
        lines.append("|---|---|---|---|---|")
        for name, r in cell_records:
            if id(r) not in kept_ids:
                continue
            key = next(
                (k for k in _SUMMARY_METRICS if k in r.metrics),
                next(iter(r.metrics), None),
            )
            value = f"{r.metrics[key]:.4g}" if key else "—"
            flags = integrity_flags(r)
            tier = r.env.get("TPU_PATTERNS_SWEEP_TIER", "")
            verdict = r.verdict.value + (
                f" [{','.join(flags)}]" if flags else ""
            ) + (f" ({tier})" if tier else "")
            lines.append(
                f"| {name} | {r.mode} | {key or '—'} | {value} | {verdict} |"
            )
            if (
                suite == "measured"
                and name.removesuffix(FIRST_PASS_SUFFIX).startswith(
                    "measured.flagship"
                )
                and r.verdict is Verdict.SUCCESS
                and r.metrics.get("tflops")
                and "bfloat16" in r.commands  # MFU is against bf16 peak
                and r.metrics.get("timing_converged", 1.0) != 0.0
            ):
                flagship_cells[name] = (
                    r.metrics["tflops"], tier or "refined",
                    r.config.get("device_kind", ""),
                )
            gbps = r.metrics.get("bandwidth_GBps")
            if (
                suite == "asymptote"
                and gbps
                and r.verdict is Verdict.SUCCESS
                # a buffer small enough for the caches validates
                # plumbing only: gate on the bytes the record moved
                and r.metrics.get("bytes_per_put", 0.0) >= 10_000_000
            ):
                if best_hbm is None or gbps > best_hbm[0]:
                    best_hbm = (gbps, name)
                if ".multi.size" in name:
                    try:
                        asym_sizes.append(
                            (float(name.rsplit(".size", 1)[1][:-2]), gbps)
                        )
                    except ValueError:
                        pass
        lines.append("")
    if flagship_cells:
        lines.extend(_mfu_lines(flagship_cells))
    if asym_sizes:
        asym_sizes.sort()
        rates = [g for _, g in asym_sizes]
        spread = (max(rates) - min(rates)) / max(rates)
        lines.append("## Copy-rate asymptote")
        lines.append("")
        curve = ", ".join(f"{mb:g} MB: {g:.1f}" for mb, g in asym_sizes)
        lines.append(f"- size curve (GB/s): {curve}")
        if len(asym_sizes) >= 3 and spread <= 0.05:
            lines.append(
                f"- flat within {spread:.1%} across a "
                f"{asym_sizes[-1][0] / asym_sizes[0][0]:.0f}x buffer-size "
                "span ⇒ the rate tracks the card's memory, not the kernel"
            )
        elif len(asym_sizes) >= 3:
            lines.append(
                f"- moves {spread:.1%} across buffer sizes ⇒ the rate is "
                "kernel-limited at some sizes"
            )
        else:
            lines.append("- fewer than 3 size points: no asymptote verdict")
        if best_hbm is not None:
            lines.append(
                f"- best schedule: {best_hbm[1]} at {best_hbm[0]:.1f} GB/s"
            )
        lines.append("")
    if not found_any:
        lines.append("(no cell records found)")
    return "\n".join(lines)


def _mfu_lines(flagship_cells: dict[str, tuple[float, str, str]]) -> list:
    """The flagship MFU table against the dense bf16 peak of the card
    the records name (``runtime.DEVICE_SPECS``).  Records that name no
    known card get no MFU: no peak is assumed."""
    from tpu_patterns_torch.runtime import match_device_spec

    kinds = {k for _, _, k in flagship_cells.values() if k}
    kind = sorted(kinds)[0] if kinds else ""
    spec = match_device_spec(kind) if kind else None
    if spec is None:
        return [
            "## Flagship MFU analysis",
            "",
            f"- no MFU: the records name no card of the spec table "
            f"({kind or 'no device_kind'})",
            "",
        ]
    peak = spec["bf16_tflops"]
    lines = [f"## Flagship MFU analysis (vs the {kind} {peak:g} TFLOP/s "
             "dense bf16 peak)"]
    if len(kinds) > 1:
        lines.append(
            f"(WARNING: records span several cards {sorted(kinds)}; "
            "MFU shown against the first)"
        )
    base = flagship_cells.get(_FLASH_BASE_CELL) or flagship_cells.get(
        _FLASH_BASE_CELL + FIRST_PASS_SUFFIX
    )
    lines += ["", "| cell | TFLOP/s | MFU | vs base | tier |",
              "|---|---|---|---|---|"]
    for name, (tf, tier, _k) in sorted(
        flagship_cells.items(), key=lambda kv: -kv[1][0]
    ):
        delta = (
            f"{tf / base[0] - 1:+.1%}"
            if base and base[1] == tier  # compare within a tier
            else "—"
        )
        lines.append(
            f"| {name} | {tf:.1f} | {tf / peak:.1%} | {delta} | {tier} |"
        )
    best_name, (best_tf, _, _k) = max(
        flagship_cells.items(), key=lambda kv: kv[1][0]
    )
    lines += ["", f"- best cell {best_name} at {best_tf / peak:.1%} MFU", ""]
    return lines


# One shared default for run_spec, run_sweep, and the CLI flag; <= 0
# means "no deadline".
DEFAULT_CELL_TIMEOUT = 1800.0


def cell_completed(
    rc: int, timed_out: bool, output: str, jsonl_path: str
) -> bool:
    """Whether a cell's run COMPLETED: the measurement reached a verdict,
    even a FAILURE one (an honest verdict is a result), as opposed to a
    timeout or crash, which left none and re-runs on ``--resume``.
    Shared by the subprocess path (:func:`run_spec`) and the warm-worker
    path (exec/scheduler.py).  rc < 0 is a signal kill: never
    completed, even if some records were flushed before it."""
    has_records = False
    try:
        with open(jsonl_path) as f:
            has_records = any(line.strip() for line in f)
    except OSError:
        pass
    return not timed_out and (
        rc == 0
        or (
            rc > 0
            and has_records
            and "Traceback (most recent call last)" not in output
        )
    )


def run_spec(
    spec: SweepSpec,
    out_dir: str,
    base_env: Mapping[str, str] | None = None,
    timeout: float = DEFAULT_CELL_TIMEOUT,
) -> tuple[int, bool]:
    """Run one cell: ``python -m tpu_patterns_torch --jsonl <name>.jsonl
    <argv>`` with its output in ``<name>.log`` (≙ ``|& tee -a $log``,
    run_omp.sh:26).  Returns ``(rc, completed)``, see
    :func:`cell_completed`.

    The child runs in its own process group and a timeout SIGKILLs the
    whole group (exec/proc.py), kernel builds' ninja and nvcc included,
    so nothing it started holds the card into the next cell."""
    from tpu_patterns_torch.exec.proc import run_command

    os.makedirs(out_dir, exist_ok=True)
    log_path = os.path.join(out_dir, f"{spec.name}.log")
    jsonl_path = os.path.join(out_dir, f"{spec.name}.jsonl")
    if os.path.exists(jsonl_path):
        # ResultWriter appends; a stale cell's records must not leak
        os.unlink(jsonl_path)
    env = dict(base_env if base_env is not None else os.environ)
    env.update(dict(spec.env))
    # the cell's CLI process can be targeted by name at the `cell.run`
    # fault site (faults/injector.py match predicates)
    env["TPU_PATTERNS_CELL"] = spec.name
    stdout, rc, timed_out = run_command(
        [sys.executable, "-m", PACKAGE, "--jsonl", jsonl_path, *spec.argv],
        env=env,
        timeout=timeout,  # <= 0: no deadline
    )
    if timed_out:
        stdout += f"\n## {spec.name} | timeout | FAILURE\n"
    with open(log_path, "w") as f:
        # export-context lines first: parse_log keys the table rows by them
        for k, v in spec.env:
            f.write(f"export {k}={v}\n")
        f.write(stdout)
    return rc, cell_completed(rc, timed_out, stdout, jsonl_path)


def _state_path(out_dir: str, suite: str) -> str:
    # ONE state file per out_dir, not per suite argument: cell names are
    # suite-prefixed and unique, and 'sweep all' / 'sweep p2p' share
    # history (a stale 'all' entry must not skip a cell whose latest
    # per-suite run failed)
    del suite
    return os.path.join(out_dir, "sweep-state.jsonl")


# ambient env that shapes a cell's workload or runtime: the framework
# tier, the CUDA runtime and PyTorch's knobs
_SIG_ENV_PREFIXES = ("TPU_PATTERNS_", "CUDA_", "PYTORCH_", "TORCH_", "NCCL_")


def _spec_sig(spec: SweepSpec,
              base_env: Mapping[str, str] | None = None) -> str:
    """Workload fingerprint: a state entry satisfies only a cell whose
    argv, spec env AND workload-shaping ambient env match (a --quick
    pass must not satisfy a full-size resume, nor a CPU pass under
    ``TPU_PATTERNS_DEVICE=cpu`` a resume on the card).  PATH-class noise
    is not fingerprinted.  The package name leads the signature, so a
    state file of the JAX package's sweep never satisfies a cell here,
    and one of this package never satisfies the JAX package's
    (``suite_complete`` and ``--resume`` included)."""
    import json

    from tpu_patterns_torch.core import results

    env = os.environ if base_env is None else base_env
    ambient = sorted(
        (k, v) for k, v in env.items()
        if k.startswith(_SIG_ENV_PREFIXES) or k in results._CONTEXT_ENV_VARS
    )
    return json.dumps([PACKAGE, list(spec.argv), list(spec.env), ambient])


def _migrate_legacy_state(out_dir: str) -> None:
    """One-time fold of legacy per-suite ``<suite>.sweep-state.jsonl``
    files into the unified state file, keeping the newest record a cell
    by its ``ts`` (a stale legacy pass must not shadow a newer failure).
    Legacy files that were read are deleted afterwards."""
    import glob
    import json

    unified = _state_path(out_dir, "")
    legacy = sorted(
        p
        for p in glob.glob(os.path.join(out_dir, "*.sweep-state.jsonl"))
        if os.path.basename(p) != os.path.basename(unified)
    )
    if not legacy:
        return
    best: dict[str, dict] = {}

    def ts_of(rec: dict) -> float:
        try:
            return float(rec.get("ts", 0) or 0)
        except (TypeError, ValueError):  # hand-edited/null ts: treat as old
            return 0.0

    def absorb(path: str) -> bool:
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            return False  # unreadable: its records are NOT folded in
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "cell" in rec:
                c = str(rec["cell"])
                if c not in best or ts_of(rec) >= ts_of(best[c]):
                    best[c] = rec
        return True

    absorbed = [p for p in legacy if absorb(p)]
    absorb(unified)  # >= keeps unified entries on equal-ts ties
    tmp = unified + ".tmp"
    with open(tmp, "w") as f:
        for rec in best.values():
            f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, unified)
    # delete ONLY what was folded in: an unreadable legacy file keeps its
    # records until a later migration can read them
    for p in absorbed:
        try:
            os.unlink(p)
        except OSError:
            pass


def load_sweep_state(out_dir: str, suite: str = "") -> dict[str, dict]:
    """Per-cell {rc, sig, completed} from a previous (possibly
    interrupted) run.  Records without the ``completed`` field count as
    completed iff they passed."""
    import json

    state: dict[str, dict] = {}
    try:
        with open(_state_path(out_dir, suite)) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # a torn write from a killed run
                if isinstance(rec, dict) and "cell" in rec:
                    rc = int(rec.get("rc", 1))
                    state[str(rec["cell"])] = {
                        "rc": rc,
                        "sig": rec.get("sig", ""),
                        "completed": bool(rec.get("completed", rc == 0)),
                    }
    except OSError:
        pass
    return state


def _record_cell(
    out_dir: str, suite: str, cell: str, rc: int, sig: str, completed: bool
) -> None:
    import json

    from tpu_patterns_torch.core.timing import wall_time_s

    rec = {
        "cell": cell, "rc": rc, "sig": sig, "completed": completed,
        "ts": wall_time_s(),
    }
    # ONE unbuffered O_APPEND write a record: the concurrent engine
    # checkpoints from several pool threads at once, and a single
    # os.write to an O_APPEND fd is atomic on local filesystems
    line = (json.dumps(rec) + "\n").encode()
    fd = os.open(
        _state_path(out_dir, suite),
        os.O_WRONLY | os.O_APPEND | os.O_CREAT,
        0o644,
    )
    try:
        os.write(fd, line)
        os.fsync(fd)  # survive the very crash resume exists for
    finally:
        os.close(fd)


def _forget_cells(out_dir: str, suite: str, cells: set[str]) -> None:
    """Drop state entries for ``cells`` only: a fresh (non-resume) run of
    a names-filtered subset keeps the history of the rest."""
    import json

    path = _state_path(out_dir, suite)
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return
    kept = []
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn writes are dropped on rewrite
        if isinstance(rec, dict) and str(rec.get("cell")) not in cells:
            kept.append(line)
    # atomic rewrite: a crash mid-rewrite must not truncate the history
    # of the unselected cells
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.writelines(kept)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def run_sweep(
    suite: str,
    out_dir: str = "results",
    quick: bool = False,
    names: Sequence[str] | None = None,
    base_env: Mapping[str, str] | None = None,
    resume: bool = False,
    cell_timeout: float = DEFAULT_CELL_TIMEOUT,
    jobs: int = 1,
    warm_workers: bool = True,
) -> int:
    """Run a suite's matrix; print the tabulated report; return the
    aggregated exit code (any FAILURE -> 1).

    ``resume=True`` skips cells the state file records as COMPLETED
    under the current signature (SUCCESS or an honest FAILURE) and
    re-runs only cells that timed out, crashed or never ran; skipped
    cells still count their recorded rc in the exit code, and their
    logs stay on disk for the report.

    ``jobs`` selects the engine: 1 (default) is the serial path, each
    cell a fresh subprocess under ``faults.run_cell_attempts``; 0 = auto
    width, N > 1 = the concurrent engine (exec/), which fans
    host-parallel cells out N-wide behind warm workers while
    device-exclusive cells drain serially, and banks its ``engine``
    Record in ``sweep-engine.jsonl``.  ``warm_workers=False`` keeps the
    subprocess path for every cell.  Either engine checkpoints a cell as
    it finishes, so resume reads the same.
    """
    from tpu_patterns_torch.core.results import (
        parse_log,
        prefer_refined,
        tabulate_records,
    )

    specs = specs_for(suite, quick)
    if names is not None:
        wanted = set(names)
        specs = [s for s in specs if s.name in wanted]
        missing = wanted - {s.name for s in specs}
        if missing:
            raise ValueError(
                f"sweep {suite!r}: unknown cell name(s) {sorted(missing)}"
            )
    if not specs:
        raise ValueError(f"sweep {suite!r} matched no specs")
    os.makedirs(out_dir, exist_ok=True)
    _migrate_legacy_state(out_dir)
    done = load_sweep_state(out_dir, suite) if resume else {}
    if not resume:  # fresh run: forget history for the selected cells only
        _forget_cells(out_dir, suite, {s.name for s in specs})
    rc = 0
    pending: list[SweepSpec] = []
    sigs: dict[str, str] = {}
    for spec in specs:
        prev = done.get(spec.name)
        sigs[spec.name] = sig = _spec_sig(spec, base_env)
        # a completed cell (even a FAILURE verdict) is a result: skip it
        # but carry its rc into the aggregate
        if prev and prev["completed"] and prev["sig"] == sig:
            word = "passed" if prev["rc"] == 0 else "completed (FAILURE)"
            print(f"# sweep cell: {spec.name} (resume: already {word})",
                  flush=True)
            if prev["rc"] != 0:
                rc = 1
            continue
        pending.append(spec)
    if pending and jobs != 1:
        from tpu_patterns_torch import exec as exec_mod
        from tpu_patterns_torch.core.results import ResultWriter

        agg = {"rc": rc}

        def on_result(res) -> None:
            # checkpoint each cell AS IT FINISHES (pool threads too)
            _record_cell(
                out_dir, suite, res.spec.name, res.rc,
                sigs[res.spec.name], res.completed,
            )
            if res.rc != 0:  # incl. negative (signal-killed) returncodes
                agg["rc"] = 1

        _, engine_rec = exec_mod.run_cells(
            pending,
            out_dir,
            jobs=jobs,
            suite=suite,
            warm_workers=warm_workers,
            cell_timeout=cell_timeout,
            base_env=base_env,
            on_result=on_result,
        )
        rc = agg["rc"]
        # the engine's serial-vs-concurrent verdict, banked beside its
        # cells; it never sets the suite's exit code
        ResultWriter(
            jsonl_path=os.path.join(out_dir, "sweep-engine.jsonl")
        ).record(engine_rec)
    else:
        from tpu_patterns_torch import obs
        from tpu_patterns_torch.faults import (
            cell_retry_policy,
            run_cell_attempts,
        )

        retry_policy = cell_retry_policy()
        for spec in pending:
            print(f"# sweep cell: {spec.name}", flush=True)
            # the subprocess has its own deadline; the span's is a
            # backstop 60 s past it (a try), so a cell whose timeout
            # machinery wedges is still diagnosed live by the watchdog
            with obs.span(
                "sweep.cell",
                deadline_s=(
                    (cell_timeout + 60) * retry_policy.max_attempts
                    if cell_timeout > 0
                    else None
                ),
                suite=suite,
                cell=spec.name,
            ):
                cell_rc, completed, attempts, quarantined = (
                    run_cell_attempts(
                        lambda attempt: run_spec(
                            spec, out_dir, base_env=base_env,
                            timeout=cell_timeout,
                        ),
                        policy=retry_policy,
                        cell=spec.name,
                        progress=lambda m: print(f"# {m}", flush=True),
                    )
                )
            obs.counter(
                "tpu_patterns_sweep_cells_total",
                suite=suite,
                status="completed" if completed else "aborted",
            ).inc()
            _record_cell(
                out_dir, suite, spec.name, cell_rc, sigs[spec.name], completed
            )
            print(
                f"# -> exit {cell_rc}"
                + (f" (attempts={attempts})" if attempts > 1 else "")
                + (" QUARANTINED" if quarantined else ""),
                flush=True,
            )
            if cell_rc != 0:  # incl. negative (signal-killed) returncodes
                rc = 1
    # the schedule's own vitals beside its cells: the retry, quarantine
    # and spawn-failure counters live in THIS process's registry
    from tpu_patterns_torch import obs

    try:
        obs.dump_metrics(os.path.join(out_dir, "sweep-metrics.jsonl"))
    except OSError:
        pass  # a full disk must not turn a finished sweep into a crash
    # parse a cell at a time: a cell's export lines must not leak into
    # the next cell's marker-only records
    records = []
    for spec in specs:
        lines: list[str] = []
        for ext in (".log", ".jsonl"):
            path = os.path.join(out_dir, spec.name + ext)
            if os.path.exists(path):
                with open(path) as f:
                    lines.extend(f.readlines())
        records.extend(parse_log(lines))
    print(tabulate_records(prefer_refined(records)))
    return rc
