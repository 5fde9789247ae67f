"""Result records, verdict markers and the log readers of ``report``.

Every run prints ``# ...`` progress lines and one
``## <mode> | <commands> | <VERDICT>`` marker per Record, and can append
the Record as a JSON line.  The keys are those of
``tpu_patterns/core/results.py``, so one report reads the Records of
both packages.  The reader half (:func:`parse_log`,
:func:`prefer_refined`, :func:`stale_grad_records`,
:func:`integrity_flags`, :func:`tabulate_records`) is the JAX package's,
with the tables drawn by ``obs/table.py`` in place of ``tabulate``.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import re
import sys
from typing import Any, Iterable, TextIO

from tpu_patterns_torch.core.timing import wall_time_s


class Verdict(enum.Enum):
    SUCCESS = "SUCCESS"
    FAILURE = "FAILURE"
    WARNING = "WARNING"
    SKIPPED = "SKIPPED"

    def __bool__(self) -> bool:  # truthy iff the run passed
        return self is not Verdict.FAILURE


@dataclasses.dataclass
class Record:
    """One result: pattern x mode x workload -> metrics + verdict."""

    pattern: str
    mode: str
    commands: str = ""
    metrics: dict[str, float] = dataclasses.field(default_factory=dict)
    verdict: Verdict = Verdict.SUCCESS
    config: dict[str, Any] = dataclasses.field(default_factory=dict)
    env: dict[str, str] = dataclasses.field(default_factory=dict)
    timestamp: float = dataclasses.field(default_factory=wall_time_s)
    notes: list[str] = dataclasses.field(default_factory=list)
    run: dict[str, str] = dataclasses.field(default_factory=dict)
    superseded: bool = False

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["verdict"] = self.verdict.value
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "Record":
        d = json.loads(line)
        d["verdict"] = Verdict(d.get("verdict", "SUCCESS"))
        return cls(**d)


_CONTEXT_ENV_VARS = (
    "CUDA_VISIBLE_DEVICES",
    "NVIDIA_TF32_OVERRIDE",
    "TPU_PATTERNS_SWEEP_CONFIG",
    "TPU_PATTERNS_SWEEP_TIER",
)

PACKAGE = "tpu_patterns_torch"


def context_env() -> dict[str, str]:
    return {k: os.environ[k] for k in _CONTEXT_ENV_VARS if k in os.environ}


class ResultWriter:
    """Prints markers to ``stream`` and appends JSONL to ``jsonl_path``.

    Marker grammar:
        ``# <progress text>``
        ``## <mode> | <commands> | <SUCCESS|FAILURE|WARNING|SKIPPED>``
    """

    def __init__(
        self,
        jsonl_path: str | os.PathLike | None = None,
        stream: TextIO | None = None,
    ):
        self.jsonl_path = os.fspath(jsonl_path) if jsonl_path else None
        self.stream = stream if stream is not None else sys.stdout
        self._failures = 0
        if self.jsonl_path:
            d = os.path.dirname(self.jsonl_path)
            if d:
                os.makedirs(d, exist_ok=True)

    def progress(self, text: str) -> None:
        print(f"# {text}", file=self.stream, flush=True)

    def metric(self, name: str, value: float, unit: str) -> None:
        print(f"{name}: {value:.6g} {unit}", file=self.stream, flush=True)

    def record(self, rec: Record) -> Record:
        if not rec.env:
            rec.env = context_env()
        if not rec.run:
            # the JAX package's provenance keys (run_id, git_sha,
            # mesh_fp), and ``package`` beside them, which names the
            # package that banked the Record (perf/history.py joins on
            # it); lazy: stamping must not pull perf/ in at import
            from tpu_patterns_torch.perf.provenance import stamp_dict

            rec.run = {**stamp_dict(), "package": PACKAGE}
        if rec.verdict is Verdict.FAILURE:
            self._failures += 1
        if not rec.commands:
            rec.commands = rec.pattern
        print(
            f"## {rec.mode} | {rec.commands} | {rec.verdict.value}",
            file=self.stream,
            flush=True,
        )
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(rec.to_json() + "\n")
        return rec

    @property
    def exit_code(self) -> int:
        return 1 if self._failures else 0


# Commit epoch of the JAX package's flash-grad FLOP-accounting fix: grad
# Records older than this are provenance, never results, unless marked
# superseded (``report`` refuses them).  The same instant here, so one
# archive reads the same in both packages.
GRAD_ACCOUNTING_FIX_TS = 1785446857.0


def stale_grad_records(records: Iterable[Record]) -> list[Record]:
    """Grad records that predate the accounting fix and are not marked
    superseded: the rows ``report`` must refuse."""
    return [
        r
        for r in records
        if r.mode.endswith("_grad")
        and r.timestamp < GRAD_ACCOUNTING_FIX_TS
        and not r.superseded
    ]


def prefer_refined(records: Iterable[Record]) -> list[Record]:
    """Drop first-pass-tier records shadowed by a refined record.

    The measured sweep banks every cell at the least repetition count
    first (``TPU_PATTERNS_SWEEP_TIER=first_pass`` in the env context),
    then refines it.  The supersede key is the sweep cell (both tiers
    carry the cell name as ``TPU_PATTERNS_SWEEP_CONFIG``) with the
    record's (pattern, mode), not its ``commands``: lm prints its step
    count there, sibling lever cells print identical surfaces, and a
    cell cut short may have flushed only some of its records.  Records
    without a cell tag key by (pattern, mode, commands).  An unshadowed
    first-pass record still tabulates.
    """
    records = list(records)  # may be a generator; it is walked twice

    def key(r: Record) -> tuple:
        cell = r.env.get("TPU_PATTERNS_SWEEP_CONFIG")
        if cell:
            return ("cell", cell, r.pattern, r.mode)
        return ("record", r.pattern, r.mode, r.commands)

    def is_fp(r: Record) -> bool:
        return r.env.get("TPU_PATTERNS_SWEEP_TIER") == "first_pass"

    refined = {key(r) for r in records if not is_fp(r)}
    return [r for r in records if not is_fp(r) or key(r) not in refined]


_VERDICT_RE = re.compile(
    r"^##\s*(?P<mode>[^|]+?)\s*\|\s*(?P<commands>[^|]+?)\s*\|\s*"
    r"(?P<verdict>SUCCESS|FAILURE|WARNING|SKIPPED)\s*$"
)
_EXPORT_RE = re.compile(
    r"^\+*\s*export\s+(?P<key>[A-Za-z_][A-Za-z0-9_]*)=(?P<val>.*)$"
)


def parse_log(lines: Iterable[str]) -> list[Record]:
    """Parse a mixed log: JSONL records, ``##`` markers, ``export`` context.

    ``export`` lines set the env context of the markers after them, and
    each ``##`` marker yields one record.  JSON lines are parsed
    directly and shadow marker lines with the same (mode, commands)
    anywhere in the input, so the order in which a cell's log and JSONL
    are joined does not matter.
    """
    lines = [ln.rstrip("\n") for ln in lines]
    records: list[Record] = []
    seen: set[tuple[str, str]] = set()
    json_records: dict[int, Record] = {}
    for i, line in enumerate(lines):
        if line.startswith("{"):
            try:
                rec = Record.from_json(line)
            except (json.JSONDecodeError, TypeError, ValueError):
                continue
            json_records[i] = rec
            seen.add((rec.mode, rec.commands))
    env: dict[str, str] = {}
    for i, line in enumerate(lines):
        if i in json_records:
            records.append(json_records[i])
            continue
        m = _EXPORT_RE.match(line)
        if m:
            env[m.group("key")] = m.group("val").strip("\"'")
            continue
        m = _VERDICT_RE.match(line)
        if m:
            if (m.group("mode"), m.group("commands")) in seen:
                continue
            records.append(Record(
                pattern="",
                mode=m.group("mode"),
                commands=m.group("commands"),
                verdict=Verdict(m.group("verdict")),
                env=dict(env),
            ))
    return records


# zero-valued gate metric -> the tag every table renderer shows
_INTEGRITY_FLAG_TAGS = (
    ("timing_converged", "NOISE-BOUND"),
    ("hbm_plausible", "NOT-HBM"),
    ("ici_plausible", "NOT-ICI"),
)


def integrity_flags(rec: Record) -> list[str]:
    """Human-readable tags for every failed integrity gate on a record."""
    return [
        tag
        for key, tag in _INTEGRITY_FLAG_TAGS
        if rec.metrics.get(key, 1.0) == 0.0
    ]


def tabulate_records(records: list[Record]) -> str:
    """Render records as one table an env context: rows are commands,
    columns modes, each cell the verdict with the first metric."""
    from tpu_patterns_torch.obs.table import markdown_table

    by_env: dict[str, dict[str, dict[str, str]]] = {}
    for rec in records:
        env_key = ", ".join(
            f"{k}={v}" for k, v in sorted(rec.env.items())
        ) or "(default env)"
        cell = rec.verdict.value
        if rec.metrics:
            name, value = next(iter(rec.metrics.items()))
            cell = f"{rec.verdict.value} ({name}={value:.4g})"
        flags = integrity_flags(rec)
        if flags:
            cell = f"{cell} [{','.join(flags)}]"
        if rec.superseded:
            cell = f"SUPERSEDED [{cell}]"
        by_env.setdefault(env_key, {}).setdefault(
            rec.commands, {})[rec.mode] = cell
    chunks = []
    for env_key, rows in by_env.items():
        modes = sorted({m for cells in rows.values() for m in cells})
        table = [
            [cmds] + [cells.get(m, "") for m in modes]
            for cmds, cells in rows.items()
        ]
        chunks.append(env_key)
        chunks.append(markdown_table(table, ["commands"] + modes))
        chunks.append("")
    return "\n".join(chunks)
