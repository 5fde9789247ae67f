"""Result records and verdict markers, with the JAX package's keys.

Every run prints ``# ...`` progress lines and one
``## <mode> | <commands> | <VERDICT>`` marker per Record, and can append
the Record as a JSON line.  The keys are those of
``tpu_patterns/core/results.py``, so one report reads the Records of
both packages.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import sys
import uuid
from typing import Any, TextIO

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

# one id per process: Records of one run join on it
_RUN_ID = uuid.uuid4().hex[:12]


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

    def record(self, rec: Record) -> Record:
        if not rec.env:
            rec.env = context_env()
        if not rec.run:
            rec.run = {"run_id": _RUN_ID, "package": "tpu_patterns_torch"}
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
