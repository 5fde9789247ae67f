"""The perf-trajectory store: snapshots over time, on one timeline.

Counterpart of ``tpu_patterns/perf/history.py``.  ``append_snapshot``
banks one normalized capture (``perf/registry.py``) a run as a JSON line
under ``results/perf_torch/history.jsonl``, a store of this package's
own: the JAX package's ``results/perf`` holds the other package's
snapshots, and the two histories never mix.  ``build_timeline`` joins
the snapshots with the Records banked under ``results/`` whose ``run``
stamp names this package (``core/results.py`` stamps ``package``).

One difference from the JAX package: the timeline does not ingest the
committed ``BENCH_r*.json``, ``MULTICHIP_r*.json`` or ``docs/measured/``
archives.  Those are the JAX package's TPU rounds, and no TPU number
belongs in this package's report; ``bench_rounds`` is always empty.
"""

from __future__ import annotations

import glob
import json
import os

from tpu_patterns_torch.core.results import PACKAGE
from tpu_patterns_torch.core.timing import wall_time_s

DEFAULT_DIR = os.path.join("results", "perf_torch")
HISTORY_FILE = "history.jsonl"


def history_path(perf_dir: str | None = None) -> str:
    return os.path.join(perf_dir or DEFAULT_DIR, HISTORY_FILE)


def append_snapshot(snapshot: dict, perf_dir: str | None = None) -> str:
    """Bank one snapshot; one atomic O_APPEND write like every record
    stream (a concurrent run must not interleave half-lines)."""
    path = history_path(perf_dir)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    line = json.dumps(snapshot, sort_keys=True) + "\n"
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line.encode())
    finally:
        os.close(fd)
    return path


def load_history(perf_dir: str | None = None) -> list[dict]:
    path = history_path(perf_dir)
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                snap = json.loads(line)
            except json.JSONDecodeError:
                continue  # a torn tail line must not hide the history
            if isinstance(snap, dict) and "executables" in snap:
                out.append(snap)
    return out


def load_result_records(results_dir: str = "results") -> list[dict]:
    """Every Record of this package banked under ``results_dir``: JSONL
    lines that carry the Record surface (pattern/mode/verdict) and a
    ``run`` stamp naming this package.  Metrics dumps, span rings and
    the JAX package's Records live in the same tree and are skipped,
    not errors."""
    rows = []
    for path in sorted(
        glob.glob(os.path.join(results_dir, "**", "*.jsonl"),
                  recursive=True)
    ):
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not (
                isinstance(d, dict) and "pattern" in d and "mode" in d
                and "verdict" in d
            ):
                continue
            run = d.get("run") or {}
            if not isinstance(run, dict) or run.get("package") != PACKAGE:
                continue
            rows.append({
                "kind": "record",
                "file": os.path.relpath(path, results_dir),
                "ts": float(d.get("timestamp", 0.0)),
                "pattern": d["pattern"],
                "mode": d["mode"],
                "verdict": d["verdict"],
                "metrics": d.get("metrics", {}),
                "run": run,
            })
    rows.sort(key=lambda r: r["ts"])
    return rows


def build_timeline(
    perf_dir: str | None = None,
    results_dir: str = "results",
) -> dict:
    """Everything the trajectory knows, grouped by source: this
    package's snapshots and Records (no TPU rounds: ``bench_rounds``
    stays empty)."""
    return {
        "built_ts": wall_time_s(),
        "bench_rounds": [],
        "records": load_result_records(results_dir),
        "snapshots": load_history(perf_dir),
    }
