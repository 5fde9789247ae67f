"""The concurrency harness: auto-tune, serial baseline, verdict.

Counterpart of ``tpu_patterns/concurrency/harness.py``, close to
verbatim: parse a mode plus repeated ``--commands`` groups, auto-tune
workloads so every command takes equal time via a linear rescale after a
serial probe, measure a serial reference giving per-command minima and
the max theoretical speedup, run the requested mode, and give a
SUCCESS/FAILURE verdict: FAILURE when the measured speedup is >30% off
the theoretical maximum (``TOL_SPEEDUP``) or a transfer's bandwidth is
below ``--min_bandwidth``; the process exit code aggregates failures.
Times come from :func:`~tpu_patterns_torch.core.timing.measure_chain`
(CUDA events on the card), which reads no chain lengths, so the
reference's ``chain_lengths`` knob is gone.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_patterns_torch.concurrency.backends import get_backend
from tpu_patterns_torch.concurrency.commands import Command, parse_group
from tpu_patterns_torch.core import timing
from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict
from tpu_patterns_torch.runtime import resolve_device

TOL_SPEEDUP = 0.3


@dataclasses.dataclass
class ConcurrencyConfig:
    backend: str = "xla"
    mode: str = "concurrent"
    commands: tuple[str, ...] = ("C C",)  # one string per group
    reps: int = 5
    warmup: int = 1
    auto_tune: bool = True  # the tuning pass (on unless --no_tuning)
    min_bandwidth: float = -1.0  # GB/s floor for copy commands; <0 disables
    tripcount: int = 40_000  # default compute knob
    elements: int = 1024  # compute buffer elements
    copy_elements: int = 1 << 22  # copy buffer elements (16 MiB float32)
    device: str = "cuda"  # "cpu" only when asked


def _apply_defaults(cmds: list[Command], cfg: ConcurrencyConfig) -> list[Command]:
    """Fill every command's knobs from the config."""
    out = []
    for c in cmds:
        c = dataclasses.replace(
            c,
            tripcount=cfg.tripcount,
            elements=cfg.elements,
            copy_elements=cfg.copy_elements,
        )
        out.append(c)
    return out


def _solo_key(cmd: Command) -> tuple:
    return (cmd.text, cmd.tripcount, cmd.elements, cmd.copy_elements)


def _measure_solo(
    backend,
    cmd: Command,
    cfg: ConcurrencyConfig,
    cache: dict[tuple, tuple[float, int, bool]] | None = None,
) -> tuple[float, int, bool]:
    """Per-command (time alone [ns], bytes per iteration, converged).
    Cached by workload so the tuning probe and the serial reference don't
    re-measure the unchanged slowest command."""
    key = _solo_key(cmd)
    if cache is not None and key in cache:
        return cache[key]
    dev = resolve_device(cfg.device)
    built = backend.build([cmd], backend.solo_mode(cfg.mode), dev)
    m = timing.measure_chain(built.build_chain, reps=cfg.reps,
                             warmup=cfg.warmup, device=dev)
    out = (m.per_op_ns, built.cmd_bytes[0], m.converged)
    if cache is not None:
        cache[key] = out
    return out


def auto_tune(
    backend,
    cmds: list[Command],
    cfg: ConcurrencyConfig,
    writer: ResultWriter,
    solo_cache: dict[tuple, tuple[float, int, bool]] | None = None,
) -> list[Command]:
    """Linear workload rescale so all commands take ~equal time
    (time proportional to the knob)."""
    uniq: dict[str, Command] = {}
    for c in cmds:
        uniq.setdefault(c.text, c)
    times = {t: _measure_solo(backend, c, cfg, solo_cache)[0] for t, c in uniq.items()}
    target = max(times.values())
    writer.progress(
        "auto-tune: "
        + ", ".join(f"{t}={ns / 1e3:.0f}us" for t, ns in times.items())
        + f" -> target {target / 1e3:.0f}us"
    )
    factors = {t: target / ns for t, ns in times.items()}
    tuned = [c.scaled(factors[c.text]) for c in cmds]
    capped = [
        c.text
        for c, f in zip(tuned, (factors[c.text] for c in tuned))
        if f > 1
        and (
            (c.kind == "compute" and c.tripcount >= Command.MAX_TRIPCOUNT)
            or (c.kind == "copy" and c.copy_elements >= Command.MAX_COPY_ELEMENTS)
        )
    ]
    if capped:
        writer.progress(
            f"auto-tune: {sorted(set(capped))} hit workload caps; commands "
            "stay unbalanced (theoretical speedup accounts for it)"
        )
    return tuned


def run_group(
    backend_name: str,
    group: str,
    cfg: ConcurrencyConfig,
    writer: ResultWriter,
) -> Record:
    """One command group through the full harness pipeline."""
    dev = resolve_device(cfg.device)
    backend = get_backend(backend_name)
    cmds = _apply_defaults(parse_group(group), cfg)
    backend.validate(cfg.mode, cmds)

    solo_cache: dict[tuple, tuple[float, int, bool]] = {}
    if cfg.auto_tune:
        cmds = auto_tune(backend, cmds, cfg, writer, solo_cache)

    # Serial reference: per-command minima, measured once per unique
    # workload (identical commands share one workload after tuning, and
    # the tuning probe of the unchanged slowest command is reused).
    for c in cmds:
        _measure_solo(backend, c, cfg, solo_cache)
    solo_ns = [solo_cache[_solo_key(c)][0] for c in cmds]
    solo_bytes = [solo_cache[_solo_key(c)][1] for c in cmds]
    solo_converged = all(solo_cache[_solo_key(c)][2] for c in cmds)
    serial_total_ns = sum(solo_ns)
    # Max theoretical speedup: perfect overlap leaves the slowest command.
    theoretical = serial_total_ns / max(solo_ns)
    imbalance = (max(solo_ns) - min(solo_ns)) / max(solo_ns)
    if imbalance > TOL_SPEEDUP:
        writer.progress(
            f"WARNING: unbalanced commands (spread {imbalance:.0%}); "
            "speedup verdict may be pessimistic"
        )

    # The measured mode.
    built = backend.build(cmds, cfg.mode, dev)
    m = timing.measure_chain(built.build_chain, reps=cfg.reps,
                             warmup=cfg.warmup, device=dev)
    speedup = serial_total_ns / m.per_op_ns
    ok_speedup = speedup >= theoretical / (1.0 + TOL_SPEEDUP)

    # Bandwidth floor per copy command from its solo time.
    notes = []
    ok_bw = True
    for c, ns, nbytes in zip(cmds, solo_ns, solo_bytes):
        if c.kind == "copy":
            gbps = nbytes / ns
            if 0 <= cfg.min_bandwidth and gbps < cfg.min_bandwidth:
                ok_bw = False
                notes.append(
                    f"{c.text}: {gbps:.2f} GB/s below floor {cfg.min_bandwidth}"
                )

    verdict = Verdict.SUCCESS if (ok_speedup and ok_bw) else Verdict.FAILURE
    if not ok_speedup:
        notes.append(
            f"speedup {speedup:.2f} < theoretical {theoretical:.2f} / "
            f"{1 + TOL_SPEEDUP}"
        )
    writer.metric(f"{cfg.mode} [{group}] speedup", speedup,
                  f"(theoretical {theoretical:.2f})")
    rec = Record(
        pattern="concurrency",
        mode=f"{backend_name}:{cfg.mode}",
        commands=group,
        metrics={
            "speedup": speedup,
            "theoretical_speedup": theoretical,
            "serial_total_us": serial_total_ns / 1e3,
            "mode_us": m.per_op_ns / 1e3,
            "bytes_per_iter": float(built.n_bytes_per_iter),
            "timing_converged": float(solo_converged and m.converged),
        },
        config={"device_kind": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                # each command's knobs as measured, after auto-tune
                "tuned": [{"text": c.text, "tripcount": c.tripcount,
                           "elements": c.elements,
                           "copy_elements": c.copy_elements} for c in cmds]},
        verdict=verdict,
        notes=notes,
    )
    if not (solo_converged and m.converged):
        rec.notes.append(timing.noise_bound_note("speedup"))
    return writer.record(rec)


def run_concurrency(
    cfg: ConcurrencyConfig | None = None, writer: ResultWriter | None = None
) -> list[Record]:
    """All groups, each through :func:`run_group`."""
    cfg = cfg or ConcurrencyConfig()
    resolve_device(cfg.device)
    writer = writer or ResultWriter()
    return [run_group(cfg.backend, g, cfg, writer) for g in cfg.commands]
