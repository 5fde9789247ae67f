"""Flight recorder: a fixed-size ring buffer of recent span/event entries.

The port's copy of ``tpu_patterns/obs/recorder.py``, stamping dumps on
the port's native clock (``core/timing.py``).

A stdout protocol scraped after the run (core/results.py) shows a hang
or an outage only *after* the run died.  The flight recorder keeps the last N
observability entries IN the process so that the moment something wedges
(watchdog, crash handler, operator request) the recent history can be
written out: what ran, in what order, how long each region took, right up
to the entry that never closed.

Design constraints:
* default-on: appends must be cheap enough to leave enabled everywhere
  (``collections.deque(maxlen=N).append`` — O(1), GIL-atomic, no lock on
  the hot path);
* export only on demand: nothing touches the filesystem until ``dump()``;
* crash-surviving: ``dump()`` is safe to call from signal handlers,
  excepthooks, and the watchdog thread (append-only file writes, no
  allocation-heavy formatting beyond ``json.dumps``).
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Any, Iterable


DEFAULT_CAPACITY = int(os.environ.get("TPU_PATTERNS_OBS_RING", "4096"))


def default_run_dir() -> str:
    """Where on-crash/watchdog dumps land unless ``set_run_dir`` said
    otherwise: the same ``results/`` root every runner writes JSONL to."""
    return os.environ.get(
        "TPU_PATTERNS_OBS_DIR", os.path.join("results", "obs")
    )


class FlightRecorder:
    """Bounded in-memory history of observability entries (dicts)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._dropped = 0
        self._lock = threading.Lock()  # dumps/clears only, never appends
        # taps: bounded side-queues fed by append (obs/fleet.py's span
        # shipper drains one at iteration boundaries).  Almost always
        # empty, so the hot path pays one truthiness check.
        self._taps: list[collections.deque] = []

    def append(self, entry: dict) -> None:
        # deque.append with maxlen is atomic under the GIL; counting the
        # drop needs len() + append to be one unit only for the *counter*,
        # which is advisory — an off-by-a-few dropped count under heavy
        # cross-thread append is acceptable, a hot-path lock is not.
        if len(self._ring) == self.capacity:
            self._dropped += 1
        self._ring.append(entry)
        if self._taps:
            for t in self._taps:
                t.append(entry)

    def open_tap(self, capacity: int = 65536) -> collections.deque:
        """Register a bounded side-queue every future ``append`` also
        lands in — the span-shipping source for fleet observability.
        A tap that overflows drops oldest-first (deque maxlen); the ring
        and the on-disk dumps still hold the full history."""
        tap: collections.deque = collections.deque(maxlen=capacity)
        with self._lock:
            self._taps.append(tap)
        return tap

    def close_tap(self, tap: collections.deque) -> None:
        with self._lock:
            if tap in self._taps:
                self._taps.remove(tap)

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def dropped(self) -> int:
        return self._dropped

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0

    def dump(
        self,
        path: str,
        open_spans: Iterable[Any] = (),
        reason: str = "on_demand",
    ) -> str:
        """Write the ring (plus still-open spans) as JSONL to ``path``.

        First line is a meta header (reason, pid, capacity, dropped
        count); then one line per still-open span (the hung one rides
        here), then the ring oldest-first.  Returns ``path``.
        """
        from tpu_patterns_torch.core import timing

        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        entries = self.snapshot()
        with open(path, "w") as f:
            f.write(json.dumps({
                "kind": "meta",
                "reason": reason,
                "pid": os.getpid(),
                "capacity": self.capacity,
                "entries": len(entries),
                "dropped": self._dropped,
                "wall_ts": timing.wall_time_s(),
                "clock_ns": timing.clock_ns(),
            }) + "\n")
            for sp in open_spans:
                f.write(json.dumps(sp.open_entry()) + "\n")
            for e in entries:
                f.write(json.dumps(e) + "\n")
            f.flush()
            os.fsync(f.fileno())  # the dump exists because something is
            # dying; it must survive whatever happens next
        return path


_GLOBAL = FlightRecorder()
_RUN_DIR: str | None = None


def get() -> FlightRecorder:
    return _GLOBAL


def set_run_dir(path: str | None) -> None:
    global _RUN_DIR
    _RUN_DIR = path


def run_dir() -> str:
    return _RUN_DIR or default_run_dir()
