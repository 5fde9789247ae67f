"""Hang watchdog: live diagnosis of spans that never close.

The port's copy of ``tpu_patterns/obs/watchdog.py``.  The watchdog's
thread reads every thread's Python stack through
``sys._current_frames`` and never touches CUDA, so it diagnoses a main
thread that sits in a device synchronize as it does one in a sleep.

A post-mortem of a hung collective or a dead link is written after it
has already killed the run.  The watchdog turns that into live
diagnosis: a daemon thread wakes periodically, and when
any open span has outlived its declared deadline (collectives and
multihost barriers are the motivating case — ``timing.device_barrier``,
``comm/*``), it

  1. dumps the flight recorder (including the hung span, marked open)
     to ``<run_dir>/hang_<span>_<pid>.jsonl``,
  2. dumps all-thread Python stacks to the matching ``*_stacks.txt``
     (the hang itself usually sits in native code holding the GIL — the
     *other* threads' stacks say what the process was doing around it),
  3. emits a ``WARNING`` Record (stdout marker + ``watchdog.jsonl``), so
     the hang is a first-class row in the same stream every measurement
     writes.

Each span fires at most once.  The thread is started lazily by the first
span opened with a deadline and never blocks process exit (daemon).

Besides open spans, the watchdog also covers work that has not STARTED:
:func:`watch_queued` registers a queued-but-not-running item (a sweep
cell waiting behind a wedged pool) with its own deadline — a span can
only diagnose a hang inside running code, but an engine whose queue
stops draining hangs with no span open at all.  The scheduler disarms
each watch the moment its cell starts (the cell's own span takes over).
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import traceback

from tpu_patterns_torch.obs import recorder

_POLL_S = float(os.environ.get("TPU_PATTERNS_WATCHDOG_POLL_S", "0.5"))

_thread: threading.Thread | None = None
_started = threading.Lock()
_fired_paths: list[str] = []  # dump paths, newest last (tests/doctor read)

_QUEUE_LOCK = threading.Lock()
_QUEUE: dict[int, "QueueWatch"] = {}
_queue_ids = itertools.count(1)


class QueueWatch:
    """One queued-but-not-started item under watchdog cover.

    ``done()`` disarms it (idempotent) — call it when the item starts
    (its running span takes over) or will never run (schedule torn
    down).  Fires at most once, like spans.
    """

    __slots__ = ("name", "attrs", "t0_ns", "deadline_ns", "fired", "_id")

    def __init__(self, name: str, deadline_s: float, attrs: dict):
        from tpu_patterns_torch.core.timing import clock_ns

        self.name = name
        self.attrs = attrs
        self.t0_ns = clock_ns()
        self.deadline_ns = int(deadline_s * 1e9)
        self.fired = False
        self._id = next(_queue_ids)

    def elapsed_ns(self) -> int:
        from tpu_patterns_torch.core.timing import clock_ns

        return clock_ns() - self.t0_ns

    def done(self) -> None:
        # disarm UNDER the lock the fire path claims with: a cell that
        # starts right at its deadline must not draw a spurious "queue
        # stopped draining" dump from a racing poll iteration
        with _QUEUE_LOCK:
            self.fired = True
            _QUEUE.pop(self._id, None)


def watch_queued(name: str, deadline_s: float, **attrs) -> QueueWatch:
    """Arm a deadline for an item that is QUEUED, not running.  Returns
    the handle to disarm via ``.done()``.  ``deadline_s`` <= 0 returns a
    pre-disarmed no-op handle (mirrors span deadline semantics)."""
    w = QueueWatch(name, deadline_s, attrs)
    if deadline_s > 0:
        with _QUEUE_LOCK:
            _QUEUE[w._id] = w
        ensure_started()
    return w


def ensure_started() -> None:
    global _thread
    if _thread is not None and _thread.is_alive():
        return
    with _started:
        if _thread is not None and _thread.is_alive():
            return
        _thread = threading.Thread(
            target=_run, name="tpu-patterns-watchdog", daemon=True
        )
        _thread.start()


def _run() -> None:
    from tpu_patterns_torch.obs import spans

    while True:
        try:
            for sp in spans.open_spans():
                if (
                    sp.deadline_ns is not None
                    and not sp.fired
                    and sp.t0_ns  # enter may still be mid-flight
                    and sp.elapsed_ns() > sp.deadline_ns
                ):
                    sp.fired = True
                    _fire(sp)
            with _QUEUE_LOCK:
                queued = list(_QUEUE.values())
            for w in queued:
                if w.fired or w.elapsed_ns() <= w.deadline_ns:
                    continue
                with _QUEUE_LOCK:
                    # claim atomically against done(): only a watch
                    # still registered AND unfired may fire
                    if w._id not in _QUEUE or w.fired:
                        continue
                    w.fired = True
                _fire_queued(w)
        except Exception:
            # the watchdog must never take the process down; a broken
            # poll iteration is worth infinitely less than the run
            traceback.print_exc(file=sys.stderr)
        _sleep(_POLL_S)


def _sleep(s: float) -> None:
    threading.Event().wait(s)


def dump_all_stacks(path: str) -> str:
    """Write every thread's Python stack to ``path`` (thread names
    resolved via threading.enumerate)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        for tid, frame in sys._current_frames().items():
            f.write(f"--- thread {names.get(tid, '?')} (tid={tid}) ---\n")
            f.write("".join(traceback.format_stack(frame)))
            f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    return path


def _safe_name(name: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in name)


def _fire(sp) -> None:
    from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict
    from tpu_patterns_torch.obs import spans

    out_dir = recorder.run_dir()
    base = os.path.join(
        out_dir, f"hang_{_safe_name(sp.name)}_{os.getpid()}"
    )
    elapsed_s = sp.elapsed_ns() / 1e9
    ring_path = recorder.get().dump(
        base + ".jsonl",
        open_spans=spans.open_spans(),
        reason=f"watchdog: span {sp.name!r} open {elapsed_s:.1f}s, "
        f"deadline {sp.deadline_ns / 1e9:.1f}s",
    )
    stacks_path = dump_all_stacks(base + "_stacks.txt")
    writer = ResultWriter(
        jsonl_path=os.path.join(out_dir, "watchdog.jsonl"),
        stream=sys.stderr,  # the hang may be wedging stdout's consumer;
        # stderr markers still reach the log tee
    )
    writer.record(Record(
        pattern="obs",
        mode="watchdog",
        commands=sp.name,
        metrics={
            "elapsed_s": round(elapsed_s, 3),
            "deadline_s": round(sp.deadline_ns / 1e9, 3),
            "open_spans": float(len(spans.open_spans())),
        },
        verdict=Verdict.WARNING,
        notes=[
            f"span {sp.name!r} (attrs={sp.attrs}) exceeded its "
            f"{sp.deadline_ns / 1e9:.1f}s deadline on thread "
            f"{sp.thread!r}",
            f"flight recorder: {ring_path}",
            f"thread stacks: {stacks_path}",
        ],
    ))
    # publish LAST: fired_dumps() is the "the watchdog fired" signal
    # watchers poll, and the ring + stacks + Record must all exist by
    # the time it becomes visible
    _fired_paths.append(ring_path)


def _fire_queued(w: QueueWatch) -> None:
    """A queued item never started inside its deadline: the QUEUE is
    wedged (no span to blame) — dump the ring + thread stacks (what IS
    the process doing instead of starting it?) and emit the same
    WARNING Record shape the span path uses."""
    from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict
    from tpu_patterns_torch.obs import spans

    out_dir = recorder.run_dir()
    base = os.path.join(
        out_dir, f"hang_queued_{_safe_name(w.name)}_{os.getpid()}"
    )
    elapsed_s = w.elapsed_ns() / 1e9
    ring_path = recorder.get().dump(
        base + ".jsonl",
        open_spans=spans.open_spans(),
        reason=f"watchdog: {w.name!r} queued {elapsed_s:.1f}s without "
        f"starting, deadline {w.deadline_ns / 1e9:.1f}s",
    )
    stacks_path = dump_all_stacks(base + "_stacks.txt")
    writer = ResultWriter(
        jsonl_path=os.path.join(out_dir, "watchdog.jsonl"),
        stream=sys.stderr,
    )
    writer.record(Record(
        pattern="obs",
        mode="watchdog_queued",
        commands=w.name,
        metrics={
            "elapsed_s": round(elapsed_s, 3),
            "deadline_s": round(w.deadline_ns / 1e9, 3),
            "queued": float(len(_QUEUE)),
        },
        verdict=Verdict.WARNING,
        notes=[
            f"{w.name!r} (attrs={w.attrs}) was still QUEUED "
            f"{elapsed_s:.1f}s after scheduling — the work queue ahead "
            "of it stopped draining",
            f"flight recorder: {ring_path}",
            f"thread stacks: {stacks_path}",
        ],
    ))
    _fired_paths.append(ring_path)  # publish last (same contract as _fire)


def fired_dumps() -> list[str]:
    """Dump paths produced by this process's watchdog, oldest first."""
    return list(_fired_paths)


def find_dumps(out_dir: str | None = None) -> list[str]:
    """Hang dumps under a run directory, newest last — the doctor's
    watchdog probe scans these to fold live hang evidence into its
    layer-by-layer report."""
    import glob

    out_dir = out_dir or recorder.run_dir()
    return sorted(
        glob.glob(os.path.join(out_dir, "hang_*.jsonl")),
        key=lambda p: os.path.getmtime(p),
    )
