"""Spans: a context-manager tracing API on the ``timing.clock_ns`` clock.

The port's copy of ``tpu_patterns/obs/spans.py``.  The clock is the
port's native ``CLOCK_MONOTONIC`` (``core/timing.py``), as the JAX
package's is; a span edge reads it once, takes the open-table lock and
(at exit) appends to the ring and observes one histogram.

    with obs.span("p2p.pair_exchange", bytes=n):
        ...

Thread-safe and nestable: each thread keeps its own span stack (parents
are per-thread, exactly Chrome's trace model where ``tid`` scopes the
nesting), completed spans land in the flight recorder ring, and spans
opened with a ``deadline_s`` register with the hang watchdog
(obs/watchdog.py) so a region that never closes is *diagnosed live*
instead of post-mortem.

Disabled mode (``TPU_PATTERNS_OBS=0``) returns one shared no-op context
manager — no allocation, no clock read, no ring append — so the
min-over-reps timing discipline pays nothing when observability is off.
"""

from __future__ import annotations

import itertools
import os
import threading

from tpu_patterns_torch.core.timing import clock_ns
from tpu_patterns_torch.obs import recorder

_ENABLED = os.environ.get("TPU_PATTERNS_OBS", "1").lower() not in (
    "0", "false", "off", "no",
)

# Default deadline for collective/barrier spans (the motivating hang
# case: a dead device tunnel wedges INSIDE a barrier with the GIL held).
# 0 disables deadlines entirely.
_COLLECTIVE_DEADLINE_S = float(
    os.environ.get("TPU_PATTERNS_WATCHDOG_S", "300")
)

_local = threading.local()
_ids = itertools.count(1)
_OPEN: dict[int, "Span"] = {}
_OPEN_LOCK = threading.Lock()


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Test/operator hook; the env var is the normal switch."""
    global _ENABLED
    _ENABLED = bool(on)


def collective_deadline_s() -> float | None:
    """Deadline runner code attaches to barrier/collective spans; None
    when watchdog deadlines are disabled (TPU_PATTERNS_WATCHDOG_S=0)."""
    return _COLLECTIVE_DEADLINE_S if _COLLECTIVE_DEADLINE_S > 0 else None


def set_collective_deadline_s(seconds: float) -> None:
    global _COLLECTIVE_DEADLINE_S
    _COLLECTIVE_DEADLINE_S = seconds


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """One open region.  Use via :func:`span`, not directly."""

    __slots__ = (
        "name", "attrs", "deadline_ns", "span_id", "parent_id", "depth",
        "t0_ns", "tid", "thread", "fired",
    )

    def __init__(self, name: str, deadline_s: float | None, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.deadline_ns = (
            int(deadline_s * 1e9) if deadline_s else None
        )
        self.span_id = next(_ids)
        self.parent_id = 0
        self.depth = 0
        self.t0_ns = 0
        self.tid = 0
        self.thread = ""
        self.fired = False  # watchdog already reported this span

    def __enter__(self) -> "Span":
        st = _stack()
        if st:
            self.parent_id = st[-1].span_id
            self.depth = st[-1].depth + 1
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.thread = t.name
        st.append(self)
        # the clock read comes BEFORE the open-table insert: the watchdog
        # thread may poll the instant the span becomes visible, and an
        # unset t0 would read as an elapsed time of the whole clock epoch
        self.t0_ns = clock_ns()
        with _OPEN_LOCK:
            _OPEN[self.span_id] = self
        if self.deadline_ns is not None:
            from tpu_patterns_torch.obs import watchdog

            watchdog.ensure_started()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = clock_ns() - self.t0_ns
        with _OPEN_LOCK:
            _OPEN.pop(self.span_id, None)
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        else:  # exited out of order (generator-held span): best effort
            try:
                st.remove(self)
            except ValueError:
                pass
        entry = self._entry(dur)
        if exc_type is not None:
            entry["error"] = exc_type.__name__
        recorder.get().append(entry)
        from tpu_patterns_torch.obs import metrics

        metrics.default().histogram(
            "tpu_patterns_span_duration_ns", span=self.name
        ).observe(dur)

    def _entry(self, dur_ns: int) -> dict:
        return {
            "kind": "span",
            "name": self.name,
            "t0_ns": self.t0_ns,
            "dur_ns": dur_ns,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "depth": self.depth,
            "tid": self.tid,
            "thread": self.thread,
            "attrs": self.attrs,
        }

    def open_entry(self) -> dict:
        """Dump representation of a span still in flight."""
        e = self._entry(clock_ns() - self.t0_ns)
        e["open"] = True
        if self.deadline_ns is not None:
            e["deadline_ns"] = self.deadline_ns
        return e

    def elapsed_ns(self) -> int:
        return clock_ns() - self.t0_ns


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return None


_NOOP = _NoopSpan()


def span(name: str, deadline_s: float | None = None, **attrs):
    """Open a traced region.  ``deadline_s`` arms the hang watchdog: if
    the region is still open after that many seconds, the flight recorder
    and all-thread stacks are dumped and a WARNING Record is emitted."""
    if not _ENABLED:
        return _NOOP
    return Span(name, deadline_s, attrs)


def complete_span(
    name: str, t0_ns: int, dur_ns: int, *, tid: int | None = None, **attrs
) -> None:
    """Record an already-timed region directly into the flight recorder.

    The context-manager :func:`span` can only trace a region that nests
    inside one Python frame; a REQUEST's lifecycle (queued -> prefill ->
    decode) spreads across many scheduler iterations, so the engine
    reconstructs it from host timestamps it already holds and books the
    phases here at retire time.  ``tid`` picks the Chrome-trace lane —
    serve/engine.py gives every request its own lane, which is what
    turns the trace export into a per-request timeline
    (docs/observability.md)."""
    if not _ENABLED:
        return
    t = threading.current_thread()
    recorder.get().append({
        "kind": "span",
        "name": name,
        "t0_ns": int(t0_ns),
        "dur_ns": max(int(dur_ns), 0),
        "span_id": next(_ids),
        "parent_id": 0,
        "depth": 0,
        "tid": tid if tid is not None else (t.ident or 0),
        "thread": t.name,
        "attrs": attrs,
    })
    from tpu_patterns_torch.obs import metrics

    metrics.default().histogram(
        "tpu_patterns_span_duration_ns", span=name
    ).observe(int(dur_ns))


def event(name: str, **attrs) -> None:
    """Record an instantaneous event into the flight recorder."""
    if not _ENABLED:
        return
    t = threading.current_thread()
    st = _stack()
    recorder.get().append({
        "kind": "event",
        "name": name,
        "t0_ns": clock_ns(),
        "dur_ns": 0,
        "span_id": 0,
        "parent_id": st[-1].span_id if st else 0,
        "depth": (st[-1].depth + 1) if st else 0,
        "tid": t.ident or 0,
        "thread": t.name,
        "attrs": attrs,
    })


def open_spans() -> list[Span]:
    """Snapshot of every span currently in flight (all threads)."""
    with _OPEN_LOCK:
        return list(_OPEN.values())
