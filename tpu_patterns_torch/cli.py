"""The ``python -m tpu_patterns_torch`` command line.

    python -m tpu_patterns_torch serve --device cuda --embed 1024 \
        --head_dim 128 --depth 4 --dtype bfloat16 --vocab 2048 \
        --min_prompt 64 --max_prompt 512 --gen 64
    python -m tpu_patterns_torch flagship --device cuda
    python -m tpu_patterns_torch p2p --transport one_sided --device cuda
    python -m tpu_patterns_torch concurrency --device cuda \
        --backend xla --mode concurrent --commands "C C"
    python -m tpu_patterns_torch allreduce --device cuda --devices 4 \
        --variant pallas --algorithm ring_opt
    python -m tpu_patterns_torch miniapps --device cuda --devices 4
    python -m tpu_patterns_torch p2p --transport one_sided --devices 4
    python -m tpu_patterns_torch interop --device cuda
    python -m tpu_patterns_torch train --device cuda --attn kernel \
        --ckpt_dir ckpts --ckpt_every 2 --steps 8
    python -m tpu_patterns_torch ckpt ckpts --leaves

One flag per field of the subcommand's config
(:class:`~tpu_patterns_torch.serve.engine.ServeConfig`,
:class:`~tpu_patterns_torch.models.flagship.FlagshipConfig`,
:class:`~tpu_patterns_torch.models.train_loop.TrainLoopConfig`), named as
in ``tpu-patterns serve`` / ``flagship`` / ``train``; ``--paged_attn``
and ``--attn`` take ``kernel|dense`` (``train`` also the JAX package's
``xla``, read as ``dense``) and ``--device`` names the device.
``ckpt DIR [--leaves]`` prints a checkpoint directory's steps (and leaf
table) in the lines of ``tpu-patterns ckpt``.
``p2p`` takes the flags of ``tpu-patterns p2p`` that the one-sided
put uses (:class:`~tpu_patterns_torch.comm.onesided.OneSidedConfig`,
``--transport``, ``--put-kernel``, ``--chunks``, ``--block-rows``,
``--devices``);
``concurrency`` those of ``tpu-patterns concurrency``
(:class:`~tpu_patterns_torch.concurrency.harness.ConcurrencyConfig`,
repeatable ``--commands``, ``--no_tuning``); ``allreduce`` and
``miniapps`` those of ``tpu-patterns allreduce`` and ``miniapps``;
``interop`` (the native C++ round trips, no flag of the reference's) only
``--device``.
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
import typing

from tpu_patterns_torch.core.results import ResultWriter

# `tpu-patterns <cmd>` flags whose machinery is not ported yet (the
# mesh flags of `flagship` and `train`)
_NOT_PORTED_FLAGSHIP = ("devices", "dp", "tp")
_NOT_PORTED = (
    "devices", "dp", "tp", "watchdog_s", "snapshot_dir", "resume",
    "ids_out", "kv_host_tier", "session_dir", "host_tier_blocks",
    "min_tier_speedup", "prefix_store", "scenario", "time_scale",
    "obs_http", "burn_mitigation", "slo_fast_s", "slo_slow_s",
    "slo_budget", "burn_multiplier", "preempt", "replicas",
    "replica_policy", "route_blocks", "min_replica_speedup",
    "replica_watchdog_s", "replica_dir", "elastic_reserve",
    "scale_out_occupancy", "scale_in_occupancy", "scale_sustain_s",
    "scale_cooldown_s", "min_live_replicas", "disagg",
    "min_ttft_improvement",
)


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(
            f"{option_string} is a `tpu-patterns {parser.prog.split()[-1]}`"
            " flag that tpu_patterns_torch does not support yet "
            "(ROADMAP.md)"
        )


def _bool(s: str) -> bool:
    v = s.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {s!r}")


def _opt_int(s: str) -> int | None:
    return None if s.strip().lower() in ("", "none") else int(s)


# `tpu-patterns p2p` flags of the placement (topo/) and the pair exchange
_NOT_PORTED_P2P = ("placement", "mechanism", "bidirectional")
_NOT_PORTED_MESH = ("placement", "mechanism")
_P2P_FIELDS = ("count", "dtype", "reps", "warmup", "min_bandwidth", "seed")

_CHOICES = {
    "paged_attn": ("kernel", "dense"),
    "attn": ("kernel", "dense"),
    "attn_grid": ("dense", "compact"),
    "device": ("cuda", "cpu"),
}


def _add_config_flags(p: argparse.ArgumentParser, cls, not_ported,
                      skip=()) -> None:
    """One ``--<field>`` per dataclass field of ``cls`` not in ``skip``,
    and a refusing flag for each name in ``not_ported``."""
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        if f.name in skip:
            continue
        ftype = hints[f.name]
        kw: dict = {"default": f.default}
        if ftype is bool:
            kw.update(type=_bool, metavar="BOOL")
        elif ftype == (int | None):
            kw.update(type=_opt_int, metavar="INT|none")
        else:
            kw["type"] = ftype
        if f.name in _CHOICES or "choices" in f.metadata:
            kw["choices"] = f.metadata.get("choices", _CHOICES.get(f.name))
        p.add_argument("--" + f.name, **kw, help=f"(default: {f.default})")
    for name in not_ported:
        p.add_argument("--" + name, nargs="?", action=_NotPorted,
                       help=argparse.SUPPRESS)


def build_parser() -> argparse.ArgumentParser:
    from tpu_patterns_torch.models.flagship import FlagshipConfig
    from tpu_patterns_torch.models.train_loop import TrainLoopConfig
    from tpu_patterns_torch.serve.engine import ServeConfig

    parser = argparse.ArgumentParser(
        prog="python -m tpu_patterns_torch",
        description=__doc__.splitlines()[0],
    )
    parser.add_argument("--jsonl", default=None,
                        help="append JSONL records here")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser(
        "serve",
        help="continuous-batching serve engine over a paged KV cache "
        "with the fused paged-attention kernel",
    )
    _add_config_flags(sv, ServeConfig, _NOT_PORTED)
    fl = sub.add_parser(
        "flagship",
        help="PatternFormer train-step benchmark (fwd+bwd+SGD) with the "
        "fused flash-attention kernels",
    )
    _add_config_flags(fl, FlagshipConfig, _NOT_PORTED_FLAGSHIP)
    tr = sub.add_parser(
        "train",
        help="resumable training loop with atomic checkpoints "
        "(--ckpt_dir/--ckpt_every/--resume)",
    )
    _add_config_flags(tr, TrainLoopConfig, _NOT_PORTED_FLAGSHIP)
    tr.add_argument("--device", choices=_CHOICES["device"], default="cuda")
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
        help="one-sided put bandwidth on one device (the local put) with "
        "the CUDA put kernels",
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
    m.add_argument("--device", choices=_CHOICES["device"], default="cuda")
    i = sub.add_parser("interop", help="native C++ round-trip proofs")
    i.add_argument("--device", choices=_CHOICES["device"], default="cuda",
                   help="device of the offload round trips (the native "
                   "ones run on CPU tensors)")
    return parser


def _add_allreduce_flags(p: argparse.ArgumentParser) -> None:
    from tpu_patterns_torch.miniapps.apps.allreduce import AllreduceConfig

    _add_config_flags(p, AllreduceConfig, _NOT_PORTED_MESH)
    p.add_argument("--variant", choices=("xla", "pallas"), default="xla")
    p.add_argument("--devices", type=int, default=0,
                   help="ranks (0 = one per card) — ≙ mpirun -n N")
    p.add_argument("--device", choices=_CHOICES["device"], default="cuda")


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
    from tpu_patterns_torch.comm.mesh import default_mesh
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
        mesh=default_mesh(n, args.device),
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
    _add_config_flags(p, ConcurrencyConfig, (),
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
    from tpu_patterns_torch.comm.onesided import KERNELS, OneSidedConfig

    hints = typing.get_type_hints(OneSidedConfig)
    for f in dataclasses.fields(OneSidedConfig):
        if f.name in _P2P_FIELDS:
            p.add_argument("--" + f.name, type=hints[f.name],
                           default=f.default, help=f"(default: {f.default})")
    p.add_argument(
        "--transport", choices=("two_sided", "one_sided"),
        default="two_sided",
        help="one_sided: the one-device put; two_sided: the pair exchange, "
        "which needs an even device count >= 2 and is not ported",
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
    p.add_argument("--devices", type=int, default=0,
                   help="ranks (0 = one per card) — ≙ mpirun -n N; with "
                   "more than one, one_sided runs the ring put (K9)")
    p.add_argument("--device", choices=_CHOICES["device"], default="cuda")
    for name in _NOT_PORTED_P2P:
        p.add_argument("--" + name, nargs="?", action=_NotPorted,
                       help=argparse.SUPPRESS)


def _p2p(args, parser, writer: ResultWriter) -> None:
    """``tpu-patterns p2p``: the one-sided put (the local put on one
    rank, the ring put over more), or the reference's SKIPPED Record for
    the pair exchange."""
    from tpu_patterns_torch.comm.mesh import default_mesh
    from tpu_patterns_torch.comm.onesided import OneSidedConfig, run_onesided

    n = _ranks(args.devices, args.device)
    if args.transport == "two_sided":
        if n >= 2 and n % 2 == 0:
            parser.error("p2p --transport two_sided on more than one device "
                         "is not supported yet (ROADMAP.md)")
        _world_skip(writer, "p2p", "two_sided", n,
                    f"p2p needs an even device count >= 2, have {n}")
        return
    tuned = {k: v for k, v in (("chunks", args.chunks),
                               ("block_rows", args.block_rows))
             if v is not None}
    cfg = OneSidedConfig(kernel=args.put_kernel, **tuned,
                         **{k: getattr(args, k) for k in _P2P_FIELDS})
    run_onesided(cfg, writer, mesh=default_mesh(n, args.device))


def _train(args, parser, writer: ResultWriter) -> None:
    from tpu_patterns_torch.models.train_loop import (
        TrainLoopConfig,
        train,
        unported,
    )

    cfg = _config(TrainLoopConfig, args)
    why = unported(cfg)
    if why:
        parser.error(f"train: {why}")
    train(cfg, writer, device=args.device)


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


def main(argv: list[str] | None = None) -> int:
    from tpu_patterns_torch.models.flagship import (
        FlagshipConfig,
        run_flagship,
        unported,
    )
    from tpu_patterns_torch.serve.engine import ServeConfig, run_serve

    parser = build_parser()
    args = parser.parse_args(argv)
    writer = ResultWriter(jsonl_path=args.jsonl)
    if args.cmd == "serve":
        run_serve(_config(ServeConfig, args), writer)
    elif args.cmd == "p2p":
        _p2p(args, parser, writer)
    elif args.cmd == "concurrency":
        _concurrency(args, writer)
    elif args.cmd == "allreduce":
        _allreduce(args, writer)
    elif args.cmd == "miniapps":
        _miniapps(args, writer)
    elif args.cmd == "interop":
        _interop(args, writer)
    elif args.cmd == "train":
        _train(args, parser, writer)
    elif args.cmd == "ckpt":
        _ckpt(args)
    else:
        cfg = _config(FlagshipConfig, args)
        why = unported(cfg)
        if why:
            parser.error(f"flagship: {why}")
        run_flagship(cfg, writer)
    return writer.exit_code


if __name__ == "__main__":
    sys.exit(main())
