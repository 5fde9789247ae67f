"""The ``python -m tpu_patterns_torch`` command line.

    python -m tpu_patterns_torch serve --device cuda --embed 1024 \
        --head_dim 128 --depth 4 --dtype bfloat16 --vocab 2048 \
        --min_prompt 64 --max_prompt 512 --gen 64
    python -m tpu_patterns_torch flagship --device cuda
    python -m tpu_patterns_torch p2p --transport one_sided --device cuda

One flag per field of the subcommand's config
(:class:`~tpu_patterns_torch.serve.engine.ServeConfig`,
:class:`~tpu_patterns_torch.models.flagship.FlagshipConfig`), named as in
``tpu-patterns serve`` / ``tpu-patterns flagship``; ``--paged_attn`` and
``--attn`` take ``kernel|dense`` and ``--device`` names the device.
``p2p`` takes the flags of ``tpu-patterns p2p`` that the one-device
put uses (:class:`~tpu_patterns_torch.comm.onesided.OneSidedConfig`,
``--transport``, ``--put-kernel``, ``--chunks``, ``--block-rows``).  A
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

# `tpu-patterns <cmd>` flags whose machinery is not ported yet
_NOT_PORTED_FLAGSHIP = ("devices", "dp", "tp")
_NOT_PORTED = (
    "devices", "dp", "tp", "watchdog_s", "prefix_share", "shared_prefix",
    "min_block_savings", "spec_k", "min_accepted", "snapshot_dir",
    "resume", "ids_out", "kv_host_tier", "session_dir", "host_tier_blocks",
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


# `tpu-patterns p2p` flags of the mesh and the pair exchange
_NOT_PORTED_P2P = ("devices", "placement", "mechanism", "bidirectional")
_P2P_FIELDS = ("count", "dtype", "reps", "warmup", "min_bandwidth", "seed")

_CHOICES = {
    "paged_attn": ("kernel", "dense"),
    "attn": ("kernel", "dense"),
    "attn_grid": ("dense", "compact"),
    "device": ("cuda", "cpu"),
}


def _add_config_flags(p: argparse.ArgumentParser, cls, not_ported) -> None:
    """One ``--<field>`` per dataclass field of ``cls``, and a refusing
    flag for each name in ``not_ported``."""
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        ftype = hints[f.name]
        kw: dict = {"default": f.default}
        if ftype is bool:
            kw.update(type=_bool, metavar="BOOL")
        elif ftype == (int | None):
            kw.update(type=_opt_int, metavar="INT|none")
        else:
            kw["type"] = ftype
        if f.name in _CHOICES:
            kw["choices"] = _CHOICES[f.name]
        p.add_argument("--" + f.name, **kw, help=f"(default: {f.default})")
    for name in not_ported:
        p.add_argument("--" + name, nargs="?", action=_NotPorted,
                       help=argparse.SUPPRESS)


def build_parser() -> argparse.ArgumentParser:
    from tpu_patterns_torch.models.flagship import FlagshipConfig
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
    _add_p2p_flags(sub.add_parser(
        "p2p",
        help="one-sided put bandwidth on one device (the local put) with "
        "the CUDA put kernels",
    ))
    return parser


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
    p.add_argument("--device", choices=_CHOICES["device"], default="cuda")
    for name in _NOT_PORTED_P2P:
        p.add_argument("--" + name, nargs="?", action=_NotPorted,
                       help=argparse.SUPPRESS)


def _p2p(args, parser, writer: ResultWriter) -> None:
    """``tpu-patterns p2p`` on one device: the one-sided local put, or
    the reference's SKIPPED Record for the pair exchange."""
    import torch

    from tpu_patterns_torch.comm.onesided import OneSidedConfig, run_onesided
    from tpu_patterns_torch.core.results import Record, Verdict
    from tpu_patterns_torch.runtime import resolve_device

    dev = resolve_device(args.device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if args.transport == "two_sided":
        if n >= 2 and n % 2 == 0:
            parser.error("p2p --transport two_sided on more than one device "
                         "is not supported yet (ROADMAP.md)")
        writer.record(Record(
            pattern="p2p", mode="two_sided", commands=f"devices={n}",
            verdict=Verdict.SKIPPED,
            notes=[f"p2p needs an even device count >= 2, have {n}"],
        ))
        return
    tuned = {k: v for k, v in (("chunks", args.chunks),
                               ("block_rows", args.block_rows))
             if v is not None}
    cfg = OneSidedConfig(kernel=args.put_kernel, **tuned,
                         **{k: getattr(args, k) for k in _P2P_FIELDS})
    if n > 1:
        writer.progress(f"{n} devices: the put runs on {dev} alone (the "
                        "ring put across devices is not ported)")
    run_onesided(cfg, writer, dev)


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
    else:
        cfg = _config(FlagshipConfig, args)
        why = unported(cfg)
        if why:
            parser.error(f"flagship: {why}")
        run_flagship(cfg, writer)
    return writer.exit_code


if __name__ == "__main__":
    sys.exit(main())
