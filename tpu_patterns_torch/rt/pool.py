"""LeasePool + LeaseTable: bounded resource leasing, one implementation.

The port's copy of ``tpu_patterns/rt/pool.py``.

:class:`LeasePool` is the lease/release/recycle accounting the
warm-worker pool grew, with the resource type abstracted
out.  Items are anything the ``_spawn`` hook returns; an item MAY
implement the liveness protocol (``alive()`` / ``kill()`` /
``shutdown()`` / ``expired``) — warm workers do — and an item that
implements none of it (the serve engine's integer scheduler slots) is
treated as always-alive, never-expired, free to discard.

Accounting semantics (pinned by the sweep-engine Record and tests):
a lease served from the free list is a reuse HIT; a fresh spawn's
first lease is a MISS (it paid the init, though possibly concurrently
with other work); a release with ``reusable=False`` — or of an expired
or dead item — RECYCLES it (kill + count).

The attached :class:`~tpu_patterns.rt.breaker.Breaker` (optional)
guards the spawn path: when open, ``lease()`` returns None instantly
instead of paying a spawn/ready deadline per call, and exactly one
caller per cool-down probes a fresh spawn (half-open).  Metric names
are caller-supplied so exec and serve keep their own namespaces over
the one implementation.

:class:`LeaseTable` is the other half the replica router needs: a
thread-safe ``key -> meta`` ledger of in-flight work.  Fail-over is an
accounting identity — quarantining a replica must release EVERY lease
it held (the property the rt tests pin), or requests leak silently.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from tpu_patterns_torch.rt.breaker import Breaker


def _alive(item) -> bool:
    f = getattr(item, "alive", None)
    return True if f is None else bool(f())


def _kill(item) -> None:
    f = getattr(item, "kill", None)
    if f is not None:
        f()


def _shutdown(item) -> None:
    f = getattr(item, "shutdown", None)
    if f is not None:
        f()
    else:
        _kill(item)


def _expired(item) -> bool:
    return bool(getattr(item, "expired", False))


class LeasePool:
    """Bounded lease/release pool over live resources.

    ``size`` bounds the retained free list; ``max_leased`` (optional)
    additionally bounds concurrently-leased items — the serve engine's
    scheduler slots use that form, the worker pool leaves it unbounded
    (its schedule width is bounded by the caller's thread count).
    """

    def __init__(
        self,
        size: int,
        *,
        max_leased: int | None = None,
        spawn: Callable[[], Any] | None = None,
        breaker: Breaker | None = None,
        fallback_counter: str = "",
        spawn_failure_counter: str = "",
    ):
        self.size = max(1, int(size))
        self.max_leased = max_leased
        self.breaker = breaker
        self._spawn_fn = spawn
        self._fallback_counter = fallback_counter
        self._spawn_failure_counter = spawn_failure_counter
        self._lock = threading.Lock()
        self._free: list = []
        self._leased: set = set()
        self.hits = 0
        self.misses = 0
        self.recycled = 0

    # -- hooks -----------------------------------------------------------

    def _spawn(self):
        """Build one fresh item; None = spawn failed (books a breaker
        failure).  Subclasses override; plain pools pass ``spawn=``."""
        if self._spawn_fn is None:
            raise NotImplementedError(
                "LeasePool needs a spawn= callable or a _spawn override"
            )
        return self._spawn_fn()

    def _count_fallback(self, reason: str) -> None:
        if not self._fallback_counter:
            return
        from tpu_patterns_torch import obs

        obs.counter(self._fallback_counter, reason=reason).inc()

    def _count_spawn_failure(self) -> None:
        if not self._spawn_failure_counter:
            return
        from tpu_patterns_torch import obs

        obs.counter(self._spawn_failure_counter).inc()

    # -- the lease cycle -------------------------------------------------

    def lease(self):
        """A live item, or None when none can be had right now (breaker
        open, spawn failed, or ``max_leased`` reached) — the caller
        falls back or defers."""
        probe = False
        with self._lock:
            while self._free:
                item = self._free.pop()
                if _alive(item):
                    self.hits += 1
                    self._leased.add(item)
                    return item
                _kill(item)
            if (
                self.max_leased is not None
                and len(self._leased) >= self.max_leased
            ):
                return None
            if self.breaker is not None:
                state = self.breaker.admit()
                if state == "open":
                    self.misses += 1
                    self._count_fallback("breaker_open")
                    return None
                probe = state == "probe"
        try:
            item = self._spawn()
        except BaseException:
            # an exception escaping _spawn must not leave the half-open
            # probe latched — that would disable recovery for good
            if probe:
                self.breaker.abort_probe()
            raise
        if item is None:
            with self._lock:
                self.misses += 1
            if self.breaker is not None:
                self.breaker.failure(probe=probe)
            self._count_spawn_failure()
            self._count_fallback("spawn_failed")
            return None
        with self._lock:
            # a fresh item's first lease still skipped nothing: count
            # the cold init it paid (concurrently, but paid)
            self.misses += 1
            self._leased.add(item)
        if self.breaker is not None:
            self.breaker.success()
        return item

    def release(self, item, reusable: bool) -> None:
        with self._lock:
            self._leased.discard(item)
        if not reusable or _expired(item) or not _alive(item):
            # the recycle counter is pool state like hits/misses and
            # release() runs on every scheduler thread: take the lock
            with self._lock:
                self.recycled += 1
            _kill(item)
            return
        with self._lock:  # decide under the lock, act outside it: a
            # shutdown's bounded waits must not stall every other
            # lease/release on the pool
            keep = len(self._free) < self.size
            if keep:
                self._free.append(item)
        if not keep:
            _shutdown(item)

    def shutdown(self) -> None:
        with self._lock:
            items, self._free = self._free, []
            leased, self._leased = set(self._leased), set()
        # items still out at teardown are wedged or mid-abort: the
        # hammer (no polite drain) so they cannot hang teardown
        for item in leased:
            _kill(item)
        for item in items:
            _shutdown(item)

    # -- accounting ------------------------------------------------------

    def outstanding(self) -> int:
        with self._lock:
            return len(self._leased)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "leases": float(total),
            "reuse_hits": float(self.hits),
            "recycled": float(self.recycled),
            "hit_rate": (self.hits / total) if total else 0.0,
        }


class LeaseTable:
    """Thread-safe ``key -> meta`` ledger of in-flight work items.

    The replica manager acquires one lease per dispatched request and
    settles it on the terminal message (done / failed) — so when a
    replica dies or is quarantined, ``release_all()`` IS the set of
    requests that must be rerouted, and an empty table after fail-over
    is the no-leak invariant the property tests pin.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._held: dict = {}

    def acquire(self, key, meta=None) -> None:
        with self._lock:
            if key in self._held:
                raise ValueError(f"lease {key!r} already held")
            self._held[key] = meta

    def release(self, key):
        """Settle one lease; returns its meta (None when not held —
        a late message after fail-over already rerouted the work)."""
        with self._lock:
            return self._held.pop(key, None)

    def release_all(self) -> dict:
        with self._lock:
            held, self._held = self._held, {}
            return held

    def held(self) -> list:
        with self._lock:
            return list(self._held)

    def snapshot(self) -> dict:
        """A point-in-time ``{key: meta}`` copy — the live telemetry
        plane's /statusz reads the in-flight table through this so a
        scrape never iterates a dict the scheduler is mutating."""
        with self._lock:
            return dict(self._held)

    def __len__(self) -> int:
        with self._lock:
            return len(self._held)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._held
