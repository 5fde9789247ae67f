"""The ``python -m tpu_patterns_torch`` command line.

    python -m tpu_patterns_torch serve --device cuda --embed 1024 \
        --head_dim 128 --depth 4 --dtype bfloat16 --vocab 2048 \
        --min_prompt 64 --max_prompt 512 --gen 64

One flag per :class:`~tpu_patterns_torch.serve.engine.ServeConfig` field,
named as in ``tpu-patterns serve``; ``--paged_attn`` takes
``kernel|dense`` and ``--device`` names the device.  A flag of the JAX
package's ``serve`` that this package does not support yet is refused
with a message, never ignored.  Prints the ``## mode | commands |
VERDICT`` markers, appends JSON-lines Records with ``--jsonl``, and
exits nonzero iff a verdict is FAILURE.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import typing

from tpu_patterns_torch.core.results import ResultWriter

# `tpu-patterns serve` flags whose machinery is not ported yet
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
            f"{option_string} is a `tpu-patterns serve` flag that "
            "tpu_patterns_torch does not support yet (ROADMAP.md, slice A)"
        )


def _bool(s: str) -> bool:
    v = s.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {s!r}")


def build_parser() -> argparse.ArgumentParser:
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
    hints = typing.get_type_hints(ServeConfig)
    for f in dataclasses.fields(ServeConfig):
        ftype = hints[f.name]
        kw: dict = {"default": f.default}
        if ftype is bool:
            kw.update(type=_bool, metavar="BOOL")
        else:
            kw["type"] = ftype
        if f.name == "paged_attn":
            kw["choices"] = ("kernel", "dense")
        if f.name == "device":
            kw["choices"] = ("cuda", "cpu")
        sv.add_argument("--" + f.name, **kw,
                        help=f"(default: {f.default})")
    for name in _NOT_PORTED:
        sv.add_argument("--" + name, nargs="?", action=_NotPorted,
                        help=argparse.SUPPRESS)
    return parser


def main(argv: list[str] | None = None) -> int:
    from tpu_patterns_torch.serve.engine import ServeConfig, run_serve

    args = build_parser().parse_args(argv)
    writer = ResultWriter(jsonl_path=args.jsonl)
    cfg = ServeConfig(
        **{f.name: getattr(args, f.name)
           for f in dataclasses.fields(ServeConfig)}
    )
    run_serve(cfg, writer)
    return writer.exit_code


if __name__ == "__main__":
    sys.exit(main())
