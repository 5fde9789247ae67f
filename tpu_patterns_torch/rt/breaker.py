"""Circuit breaker: closed -> open -> half-open, one shared semantics.

The port's copy of ``tpu_patterns/rt/breaker.py``, on the port's clock.

The warm-worker pool's state machine (``exec/workers.py``):
``threshold`` consecutive failures OPEN the breaker; after
``TPU_PATTERNS_BREAKER_COOLDOWN_S`` (default 30) it goes HALF-OPEN and
exactly ONE caller is admitted to probe; probe success CLOSES it,
probe failure re-opens it for another cool-down.  One bad minute must
not disable a recovery path for the whole night — and one flapping
resource must not be probed by every caller at once.

The same object now guards three things: warm-worker spawn
(exec/workers.py), replica health as seen by the router
(serve/replica.py: repeated request failures / protocol errors open
the breaker and quarantine the replica), and — opt-in — a serve
engine's own decode path (serve/engine.py: consecutive whole-step
quarantines trip the engine so a sick replica STOPS and hands its
queue back instead of failing every remaining request).

Callers drive it with four verbs:

  admit()    -> "closed" | "open" | "probe".  "probe" CLAIMS the single
               half-open slot; the caller MUST settle it with
               ``success()`` / ``failure(probe=True)`` /
               ``abort_probe()`` or half-open recovery latches shut.
  success()  resets the failure streak and closes the breaker.
  failure()  extends the streak; returns True when the breaker is (re)
               opened.  ``probe=True`` marks a failed half-open probe
               (re-opens immediately, streak length irrelevant).
  abort_probe()  the exception path: un-latch the probe slot and
               restart the cool-down clock without booking a verdict.
"""

from __future__ import annotations

import os
import threading

from tpu_patterns_torch.core.timing import clock_ns

# open-breaker cool-down before a half-open probe is allowed — ONE env
# var for every breaker in the tree (workers, replicas, engines)
BREAKER_COOLDOWN_S = float(
    os.environ.get("TPU_PATTERNS_BREAKER_COOLDOWN_S", "30")
)


class Breaker:
    """The closed/open/half-open state machine (module docstring).

    ``gauge`` names an obs gauge kept at 1.0 while open, 0.0 while
    closed (labels ride along) — the self-healing trail must be
    visible, not inferred.
    """

    def __init__(
        self,
        *,
        threshold: int = 2,
        cooldown_s: float | None = None,
        gauge: str = "",
        **gauge_labels: str,
    ):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.cooldown_s = (
            BREAKER_COOLDOWN_S if cooldown_s is None else float(cooldown_s)
        )
        self._gauge = gauge
        self._gauge_labels = dict(gauge_labels)
        self._lock = threading.Lock()
        self.failures = 0
        self.opened = False
        self.opened_ns = 0
        self.probing = False

    def _set_gauge(self, v: float) -> None:
        if not self._gauge:
            return
        from tpu_patterns_torch import obs

        obs.gauge(self._gauge, **self._gauge_labels).set(v)

    def admit(self) -> str:
        """Decide one attempt: "closed" (go), "open" (fall back), or
        "probe" (go, and you carry the half-open verdict)."""
        with self._lock:
            if not self.opened:
                return "closed"
            cooled = (
                clock_ns() - self.opened_ns
            ) / 1e9 >= self.cooldown_s
            if not cooled or self.probing:
                return "open"
            self.probing = True
            return "probe"

    def success(self) -> None:
        with self._lock:
            self.failures = 0
            self.opened = False
            self.probing = False
        self._set_gauge(0.0)

    def failure(self, probe: bool = False) -> bool:
        """Book one failure; True iff the breaker is now open."""
        with self._lock:
            self.failures += 1
            if probe:
                # failed half-open probe: re-open for another cool-down
                self.probing = False
                self.opened = True
                self.opened_ns = clock_ns()
            elif not self.opened and self.failures >= self.threshold:
                self.opened = True
                self.opened_ns = clock_ns()
            opened = self.opened
        self._set_gauge(1.0 if opened else 0.0)
        return opened

    def abort_probe(self) -> None:
        """An exception escaped the probe attempt: un-latch the probe
        slot (or half-open recovery is disabled for good) and restart
        the cool-down clock."""
        with self._lock:
            self.probing = False
            self.opened_ns = clock_ns()

    def reopen_at(self, opened_ns: int) -> None:
        """Backdate the open timestamp (tests age the cool-down; the
        worker pool exposes this as its legacy ``_opened_ns`` knob)."""
        with self._lock:
            self.opened_ns = int(opened_ns)
