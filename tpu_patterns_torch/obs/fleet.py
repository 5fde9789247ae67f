"""Fleet observability: span shipping, merged timelines, request journeys.

The port's copy of ``tpu_patterns/obs/fleet.py``.  Each replica process
keeps its own flight recorder and metrics registry, so without this
module the parent's Chrome trace would show only the router, and a
request that was routed, failed and rerouted would leave three
disconnected per-process fragments.  This module is the multi-process
half of obs/:

  child side   :class:`ObsShipper` — drains a flight-recorder tap and
               the child registry's counter/gauge deltas into bounded
               ``{"op": "obs", ...}`` batches the replica protocol
               ships to the parent at iteration boundaries
               (serve/replica.py).  Histograms stay in the child's own
               dump (``<obs_dir>/replica-<id>/metrics.jsonl``).
  parent side  :class:`FleetObs` — absorbs shipped batches: entries are
               appended (torn-line tolerant, like every dump) to
               ``<obs_dir>/replica-<id>/shipped.jsonl``, cumulative
               counter/gauge values merge into ``tpu_patterns_fleet_*``
               series in the parent registry, and the parent-side
               mirror counters are reconciled against the shipped truth
               (assert equal; mirrors only stand in for a child that
               died before its first ship).
  offline      :func:`merge_fleet` — one timeline from the parent's
               dumps plus every ``replica-*/`` dir: per-process clocks
               aligned via each dump's (wall_ts, clock_ns) meta pair,
               entries deduped per process (a child's own dump and the
               shipped copy of the same spans collapse), tagged with
               ``pid``/``replica`` so obs/export.py renders one lane
               set per process.
  journeys     a fleet-unique journey id (:func:`new_journey_id`) is
               stamped at route time and propagated through
               submit/reroute; every entry carrying a ``jid`` attr is a
               journey anchor, rendered as Chrome flow events
               (``ph: s/t/f``) so a rerouted request reads as ONE
               arrow: router -> replica A (failed) -> replica B (done).

``python -m tpu_patterns_torch obs fleet <dir>``, ``obs journey
<jid|rid>`` and ``obs explain`` are the CLI front ends.
"""

from __future__ import annotations

import glob
import itertools
import json
import os
import threading

from tpu_patterns_torch import obs
from tpu_patterns_torch.core.timing import clock_ns, wall_time_s
from tpu_patterns_torch.obs.export import (  # noqa: F401
    JOURNEY_EVENTS,
    JOURNEY_SPANS,
    journeys,
)
from tpu_patterns_torch.obs.table import markdown_table

# one merged trace = one pid per process: replicas use their numeric id,
# the parent (router/scheduler lanes) sits far above any plausible fleet
ROUTER_PID = 1_000_000

# the journey anchors (JOURNEY_EVENTS, JOURNEY_SPANS) and their grouping
# (journeys) live in obs/export.py, which renders their flow arrows

_journey_seq = itertools.count(1)


def new_journey_id() -> str:
    """A fleet-unique journey id: the stamping process's pid plus a
    monotone sequence — unique across every fleet leg a run serves and
    across restarts (two parents cannot share a pid concurrently)."""
    return f"j{os.getpid():x}-{next(_journey_seq)}"


def fleet_name(name: str) -> str:
    """Map a child-registry series onto the fleet namespace:
    ``tpu_patterns_serve_tokens_total`` ->
    ``tpu_patterns_fleet_serve_tokens_total`` — same suffix rules, so
    counters keep their ``_total`` and the dashboard glob is
    ``tpu_patterns_fleet_*``."""
    prefix = "tpu_patterns_"
    if not name.startswith(prefix):
        raise ValueError(
            f"shipped metric {name!r} lacks the {prefix!r} prefix — "
            "child registries only hold the one namespace"
        )
    return prefix + "fleet_" + name[len(prefix):]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# -- child side ------------------------------------------------------------


class ObsShipper:
    """Builds the child's ``obs`` protocol messages.

    Entries come from a flight-recorder tap (everything appended since
    the last batch, bounded both in tap capacity and per-batch size so
    a chatty child can never starve ``done``/``hb`` traffic); metrics
    are cumulative counter/gauge values re-shipped only when they
    changed.  Each batch carries a (wall_ts, clock_ns) pair so the
    parent can align this process's monotonic clock with everyone
    else's.
    """

    def __init__(self, max_batch: int = 256, tap_capacity: int = 65536):
        from tpu_patterns_torch.obs import recorder

        self.max_batch = max_batch
        self._tap = recorder.get().open_tap(capacity=tap_capacity)
        self._sent: dict[tuple, float] = {}

    def close(self) -> None:
        from tpu_patterns_torch.obs import recorder

        recorder.get().close_tap(self._tap)

    def _metric_updates(self) -> list[dict]:
        out: list[dict] = []
        for m in obs.metrics_registry().metrics():
            if not hasattr(m, "value"):
                continue  # histograms ride the child's own metrics dump
            key = (m.kind, m.name, _label_key(m.labels))
            v = float(m.value)
            if self._sent.get(key) != v:
                self._sent[key] = v
                out.append({
                    "metric": m.name, "type": m.kind,
                    "labels": dict(m.labels), "value": v,
                })
        return out

    def batch(self) -> dict | None:
        """The next ``obs`` message, or None when nothing changed.
        At most ``max_batch`` entries ship per call; the rest stay in
        the tap for the next iteration boundary."""
        entries: list[dict] = []
        while self._tap and len(entries) < self.max_batch:
            entries.append(self._tap.popleft())
        metrics = self._metric_updates()
        if not entries and not metrics:
            return None
        return {
            "op": "obs",
            "entries": entries,
            "metrics": metrics,
            "backlog": len(self._tap),
            "clock": {"wall_ts": wall_time_s(), "clock_ns": clock_ns()},
        }

    def drain(self, max_batches: int = 64):
        """Final flush: yield batches until the tap and the metric
        deltas are empty (bounded — a dying child must not linger)."""
        for _ in range(max_batches):
            b = self.batch()
            if b is None:
                return
            yield b


# -- parent side -----------------------------------------------------------


class FleetObs:
    """Parent-side sink for shipped obs batches (one per fleet).

    ``obs_base`` is the directory ``replica-<id>/`` subdirs live under
    (None = in-memory only, the unit-test mode: metrics merge, entries
    are kept but not persisted).
    """

    def __init__(self, obs_base: str | None):
        self.obs_base = obs_base
        self._lock = threading.Lock()
        self._files: dict[str, object] = {}
        # per-replica cumulative totals as SHIPPED (the truth the
        # mirrors reconcile against): {replica: {(kind, name, labels):
        # value}} — kept here, not read back from the global registry,
        # so two fleet legs in one process can't pollute each other
        self.shipped_totals: dict[str, dict[tuple, float]] = {}
        self.shipped: set[str] = set()  # replicas with >= 1 obs batch
        # parent-side mirror bookings (a child's counters die with its
        # process) — a reconciliation ledger:
        # {replica: {(name, labels): count}}
        self.mirrors: dict[str, dict[tuple, float]] = {}
        self.mismatches: list[str] = []

    def replica_dir(self, replica: str) -> str:
        if self.obs_base is None:
            raise ValueError("FleetObs has no obs_base (in-memory mode)")
        return os.path.join(self.obs_base, f"replica-{replica}")

    def reset_base(self) -> None:
        """Claim the ``replica-*`` namespace under ``obs_base`` for
        THIS fleet: drop every stale per-replica dir a previous run
        left behind (the default obs dir is fixed, never timestamped —
        without this, ``merge_fleet`` would stitch last run's shipped
        spans and ghost replicas into this run's timeline)."""
        import shutil

        if self.obs_base is None:
            return
        for d in glob.glob(os.path.join(self.obs_base, "replica-*")):
            if os.path.isdir(d):
                shutil.rmtree(d, ignore_errors=True)

    def _file(self, replica: str):
        with self._lock:
            f = self._files.get(replica)
            if f is None:
                d = self.replica_dir(replica)
                os.makedirs(d, exist_ok=True)
                f = self._files[replica] = open(
                    os.path.join(d, "shipped.jsonl"), "a"
                )
            return f

    def close(self) -> None:
        with self._lock:
            for f in self._files.values():
                try:
                    f.close()
                except OSError:
                    pass
            self._files.clear()

    def absorb(self, replica: str, msg: dict) -> None:
        """One shipped batch: persist entries, merge metric deltas into
        the ``tpu_patterns_fleet_*`` series, note the clock offset."""
        replica = str(replica)
        self.shipped.add(replica)
        # the batch's (wall_ts, clock_ns) pair persists in the meta
        # line below — merge_fleet aligns clocks offline from there
        clock = msg.get("clock") or {}
        entries = msg.get("entries") or []
        if entries:
            if self.obs_base is not None:
                f = self._file(replica)
                f.write(json.dumps({
                    "kind": "meta", "reason": "shipped",
                    "replica": replica, **clock,
                }) + "\n")
                for e in entries:
                    f.write(json.dumps(e) + "\n")
                f.flush()
        totals = self.shipped_totals.setdefault(replica, {})
        for m in msg.get("metrics") or []:
            name = m.get("metric", "")
            kind = m.get("type", "")
            labels = dict(m.get("labels") or {})
            labels.setdefault("replica", replica)
            v = float(m.get("value", 0.0))
            key = (kind, name, _label_key(labels))
            prev = totals.get(key, 0.0)
            totals[key] = v
            if kind == "counter":
                delta = v - prev
                if delta > 0:
                    obs.counter(fleet_name(name), **labels).inc(delta)
            elif kind == "gauge":
                obs.gauge(fleet_name(name), **labels).set(v)

    def mirror(self, replica: str, name: str, **labels) -> None:
        """Book a parent-side mirror of a child-owned counter (the
        fallback for counters that die with the child's process)
        AND remember it for reconciliation against the shipped truth."""
        replica = str(replica)
        obs.counter(name, replica=replica, **labels).inc()
        led = self.mirrors.setdefault(replica, {})
        key = (name, _label_key({**labels, "replica": replica}))
        led[key] = led.get(key, 0.0) + 1.0

    def reconcile(self) -> list[str]:
        """Settle mirrors against shipped truth.

        For every replica that shipped at least once, each mirror count
        must EQUAL the shipped cumulative value of the same series
        (mismatches are returned and surface in the fleet Record).  A
        replica that died before its first ship keeps its mirrors as
        the fallback: they are promoted into the fleet series so
        ``tpu_patterns_fleet_*`` totals stay complete.
        """
        notes: list[str] = []
        for replica, led in sorted(self.mirrors.items()):
            totals = self.shipped_totals.setdefault(replica, {})
            for (name, lk), count in sorted(led.items()):
                if replica in self.shipped:
                    shipped_v = totals.get(("counter", name, lk), 0.0)
                    if shipped_v != count:
                        notes.append(
                            f"replica {replica}: shipped "
                            f"{name}{dict(lk)} = {shipped_v:g} != "
                            f"parent mirror {count:g}"
                        )
                else:
                    # dead before first ship: the mirror IS the record
                    totals[("counter", name, lk)] = count
                    obs.counter(fleet_name(name), **dict(lk)).inc(count)
        self.mismatches = notes
        return notes

    def total(self, name: str, **labels) -> float:
        """Fleet-wide cumulative total of a child counter/gauge series
        (post-:meth:`reconcile` this includes mirror fallbacks) —
        ``rt.metric_total`` semantics over the SHIPPED ledger, immune
        to other fleets sharing the parent's process registry."""
        want = {str(k): str(v) for k, v in labels.items()}
        out = 0.0
        for totals in self.shipped_totals.values():
            for (_, n, lk), v in totals.items():
                if n != name:
                    continue
                have = dict(lk)
                if all(have.get(k) == v2 for k, v2 in want.items()):
                    out += v
        return out


# -- offline merge ---------------------------------------------------------


def _load_source(paths: list[str]) -> tuple[list[dict], int | None]:
    """Read one PROCESS's dumps: entries in file order plus the clock
    offset (wall ns - monotonic ns) from the first meta line carrying
    both clocks.  Torn lines tolerated, like every dump reader."""
    entries: list[dict] = []
    offset: int | None = None
    for path in paths:
        try:
            f = open(path)
        except OSError:
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(e, dict):
                    continue
                kind = e.get("kind")
                if kind == "meta":
                    if (
                        offset is None
                        and "wall_ts" in e
                        and "clock_ns" in e
                    ):
                        offset = int(
                            float(e["wall_ts"]) * 1e9 - e["clock_ns"]
                        )
                elif kind in ("span", "event"):
                    entries.append(e)
    return entries, offset


def _dump_paths(d: str) -> list[str]:
    return [
        p
        for p in (
            os.path.join(d, "spans.jsonl"),
            os.path.join(d, "crash.jsonl"),
            os.path.join(d, "shipped.jsonl"),
        )
        if os.path.exists(p)
    ] + sorted(glob.glob(os.path.join(d, "hang_*.jsonl")))


def replica_pid(replica: str) -> int:
    """The merged trace's pid for a replica: its numeric id where it
    has one (the issue contract: pid == replica id), else a stable
    small hash clear of :data:`ROUTER_PID`."""
    try:
        return int(replica)
    except ValueError:
        return sum(replica.encode()) % 65536


def merge_fleet(
    obs_dir: str,
) -> tuple[list[dict], dict[int, str]]:
    """Merge the parent's dumps and every ``replica-*/`` dir under
    ``obs_dir`` into ONE entry list on ONE clock.

    Per process: dedupe first (a child's own dump and the shipped copy
    of the same ring overlap — closed-beats-open survives the merge),
    then align its monotonic timestamps onto the wall clock via the
    dump meta's (wall_ts, clock_ns) pair, then tag every entry with the
    process's ``pid``/``replica`` so obs/export.py renders one lane set
    per process.  Returns (entries, {pid: process label}); timestamps
    are rebased so the earliest entry sits at t=0.
    """
    from tpu_patterns_torch.obs import export

    sources: list[tuple[str, list[str]]] = [("", _dump_paths(obs_dir))]
    for d in sorted(glob.glob(os.path.join(obs_dir, "replica-*"))):
        if os.path.isdir(d):
            label = os.path.basename(d)[len("replica-"):]
            sources.append((label, _dump_paths(d)))

    merged: list[dict] = []
    process_names: dict[int, str] = {}
    for label, paths in sources:
        raw, offset = _load_source(paths)
        if not raw:
            continue
        pid = ROUTER_PID if label == "" else replica_pid(label)
        process_names[pid] = "router" if label == "" else (
            f"replica {label}"
        )
        for e in export.dedupe_entries(raw):
            e2 = dict(e)
            e2["t0_ns"] = int(e.get("t0_ns", 0)) + (offset or 0)
            e2["pid"] = pid
            if label:
                e2["replica"] = label
            merged.append(e2)
    if merged:
        base = min(e["t0_ns"] for e in merged)
        for e in merged:
            e["t0_ns"] -= base
        merged.sort(key=lambda e: e["t0_ns"])
    return merged, process_names


# -- journeys --------------------------------------------------------------


def resolve_journey(entries: list[dict], key: str) -> str | None:
    """``key`` is a jid (exact) or a rid: map it to the journey id."""
    js = journeys(entries)
    if key in js:
        return key
    for jid, anchors in js.items():
        for e in anchors:
            attrs = e.get("attrs") or {}
            if str(attrs.get("rid")) == str(key):
                return jid
    return None


def journey_table(entries: list[dict], key: str) -> str:
    """One request's full cross-process story as a markdown table:
    every entry carrying the journey id, time-ordered, with the process
    it happened on — route -> fail@replica-1 -> reroute ->
    done@replica-0 reads top to bottom."""
    jid = resolve_journey(entries, key)
    if jid is None:
        return f"no journey matching {key!r} in the merged dumps"
    rows = []
    story = [
        e for e in entries
        if (e.get("attrs") or {}).get("jid") == jid
    ]
    story.sort(key=lambda e: e.get("t0_ns", 0))
    t_base = story[0].get("t0_ns", 0) if story else 0
    for e in story:
        attrs = dict(e.get("attrs") or {})
        attrs.pop("jid", None)
        where = e.get("replica") or (
            "router" if e.get("pid") == ROUTER_PID else ""
        )
        if where and where != "router":
            where = f"replica {where}"
        rows.append([
            f"{(e.get('t0_ns', 0) - t_base) / 1e6:.3f}",
            where,
            e.get("kind", "?"),
            e.get("name", "?"),
            f"{e.get('dur_ns', 0) / 1e6:.3f}",
            " ".join(
                f"{k}={v}" for k, v in sorted(attrs.items())
            ),
        ])
    table = markdown_table(
        rows, ["t ms", "process", "kind", "name", "dur ms", "attrs"]
    )
    return f"journey {jid}\n\n{table}"
