"""Exporters: Chrome trace_event JSON, span summaries, host/device join.

The port's copy of ``tpu_patterns/obs/export.py``.  Two differences: the
journey index the Chrome trace's flow arrows read (``journeys``) lives
here (``obs/fleet.py`` imports it), and ``host_device_join`` reads a Kineto trace through
``core/profile.py`` and names the card's engines (SMs, NCCL, copy
engines).  The summary table is the port's own fixed-width rendering
(``obs/table.py``).

The flight recorder's entries are plain dicts; this module turns a dump
(or the live ring) into

* a Chrome ``trace_event`` JSON file — open any run in Perfetto /
  chrome://tracing: spans become complete ("ph": "X") events with
  microsecond timestamps, nested per thread exactly as they ran;
* a per-span-name summary table (count / total / mean / max), the
  ``tpu-patterns obs summarize`` product;
* a host+device join against ``core/profile.py``'s device-plane busy
  categories, so ONE report answers "where did the step go: host, SMs
  (compute), NCCL (collective), or copies (dma)".
"""

from __future__ import annotations

import json
import os
from typing import Iterable

from tpu_patterns_torch.obs.table import markdown_table

# entries that anchor a journey's flow arrows (``tpu_patterns/obs/
# fleet.py``): the router's decisions and the per-request lifecycle
# edges
JOURNEY_EVENTS = (
    "journey.route", "journey.reroute", "journey.admit",
    "journey.handoff",
)
JOURNEY_SPANS = ("req.queued", "req.retired", "req.failed")


def load_entries(path: str) -> list[dict]:
    """Read one dump (spans.jsonl / hang_*.jsonl) back into entry dicts;
    meta header lines are skipped, torn trailing lines tolerated (dumps
    are written by dying processes)."""
    entries: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except ValueError:
                continue
            if isinstance(e, dict) and e.get("kind") in ("span", "event"):
                entries.append(e)
    return entries


def dedupe_entries(entries: Iterable[dict]) -> list[dict]:
    """Drop repeats across overlapping dumps of the same ring.

    A run where the watchdog fired AND --obs-dump exported at end of run
    wrote the same entries twice (hang_*.jsonl then spans.jsonl) — and
    the hung span twice more, once open and once closed.  The fleet
    merge (obs/fleet.py) adds a third overlap: a replica's own dir dump
    and the shipped copy of the same ring.  Identity is (pid, replica,
    span_id, t0_ns, tid, name) — the process tags keep two replicas'
    same-numbered spans apart (span ids and monotonic clocks restart
    per process); the closed form of a span wins over its still-open
    snapshot.  First-seen order is preserved.
    """
    best: dict[tuple, dict] = {}
    order: list[tuple] = []
    for e in entries:
        key = (e.get("pid"), e.get("replica"), e.get("span_id"),
               e.get("t0_ns"), e.get("tid"), e.get("name"))
        prev = best.get(key)
        if prev is None:
            best[key] = e
            order.append(key)
        elif prev.get("open") and not e.get("open"):
            best[key] = e
    return [best[k] for k in order]


def chrome_trace(
    entries: Iterable[dict],
    process_names: dict[int, str] | None = None,
) -> dict:
    """trace_event JSON object format: spans -> "X" (complete) events,
    events -> "i" (instant); ts/dur in microseconds per the schema.

    Entries whose attrs carry a request id (the serve engine's
    per-request lifecycle spans) get their lane named ``req <rid>`` via
    thread_name metadata — qualified ``req <rid> @r<k>`` when the entry
    carries a replica id, because every replica restarts rids at 0 and
    a merged fleet trace would otherwise overlay different requests
    onto one label.  Lanes are keyed (pid, tid): fleet-merged entries
    (obs/fleet.py) carry their own ``pid`` per process, single-process
    dumps fall back to this process's pid.  ``process_names`` adds
    process_name metadata rows (the fleet merge passes
    {pid: "replica <k>" / "router"}).

    Entries carrying a ``jid`` attr on the journey anchor names
    (obs/fleet.py) additionally emit Chrome FLOW events (``ph`` s/t/f,
    one shared id per journey), so a request that was routed, failed on
    one replica, and rerouted to another renders as one arrow across
    the process lanes."""
    trace_events = []
    default_pid = os.getpid()
    lanes: dict[tuple, str] = {}
    entries = list(entries)
    for e in entries:
        attrs = e.get("attrs") or {}
        # only lifecycle SPANS name a lane: scheduler-thread EVENTS
        # (serve.defer, serve.quarantine, fault.injected, ...) also
        # carry rid attrs but live on the real thread's lane, which
        # must keep its thread identity
        if (
            e.get("kind") == "span"
            and "rid" in attrs
            and e.get("tid") is not None
        ):
            label = f"req {attrs['rid']}"
            rep = attrs.get("replica") or e.get("replica")
            if rep not in (None, ""):
                label += f" @r{rep}"
            if attrs.get("scenario"):
                label += f" [{attrs['scenario']}]"
            lanes.setdefault((e.get("pid", default_pid), e["tid"]), label)
    for e in entries:
        ev = {
            "name": e.get("name", "?"),
            "cat": "tpu_patterns" + (",open" if e.get("open") else ""),
            "ph": "X" if e.get("kind") == "span" else "i",
            "ts": e.get("t0_ns", 0) / 1e3,
            "pid": e.get("pid", default_pid),
            "tid": e.get("tid", 0),
            "args": dict(e.get("attrs") or {}),
        }
        if e.get("kind") == "span":
            ev["dur"] = e.get("dur_ns", 0) / 1e3
        else:
            ev["s"] = "t"  # instant scope: thread
        trace_events.append(ev)
    # journey flows: one s -> t... -> f chain per jid across its anchors
    for jid, anchors in sorted(journeys(entries).items()):
        if len(anchors) < 2:
            continue
        for i, a in enumerate(anchors):
            ph = "s" if i == 0 else ("f" if i == len(anchors) - 1 else "t")
            flow = {
                "name": "journey",
                "cat": "journey",
                "ph": ph,
                "id": jid,
                "ts": a.get("t0_ns", 0) / 1e3,
                "pid": a.get("pid", default_pid),
                "tid": a.get("tid", 0),
            }
            if ph == "f":
                flow["bp"] = "e"  # bind to the enclosing slice
            trace_events.append(flow)
    trace_events.sort(key=lambda ev: ev["ts"])
    meta = [
        {
            "name": "process_name", "ph": "M", "ts": 0.0, "pid": pid,
            "tid": 0, "args": {"name": label},
        }
        for pid, label in sorted((process_names or {}).items())
    ] + [
        {
            "name": "thread_name", "ph": "M", "ts": 0.0, "pid": pid,
            "tid": tid, "args": {"name": label},
        }
        for (pid, tid), label in sorted(lanes.items())
    ]
    return {"traceEvents": meta + trace_events, "displayTimeUnit": "ms"}


def write_chrome_trace(
    entries: Iterable[dict],
    out_path: str,
    process_names: dict[int, str] | None = None,
) -> str:
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(chrome_trace(entries, process_names=process_names), f)
    return out_path


def span_stats(entries: Iterable[dict]) -> dict[str, dict]:
    """Per span name: count, total/mean/max duration (ms), still-open
    count — the summarize table's rows."""
    stats: dict[str, dict] = {}
    for e in entries:
        if e.get("kind") != "span":
            continue
        s = stats.setdefault(
            e.get("name", "?"),
            {"count": 0, "total_ms": 0.0, "max_ms": 0.0, "open": 0,
             "errors": 0},
        )
        dur_ms = e.get("dur_ns", 0) / 1e6
        s["count"] += 1
        s["total_ms"] += dur_ms
        s["max_ms"] = max(s["max_ms"], dur_ms)
        if e.get("open"):
            s["open"] += 1
        if e.get("error"):
            s["errors"] += 1
    for s in stats.values():
        s["mean_ms"] = s["total_ms"] / s["count"] if s["count"] else 0.0
    return stats


def summarize(entries: list[dict]) -> str:
    """Markdown table of span stats, longest total first."""
    stats = span_stats(entries)
    n_events = sum(1 for e in entries if e.get("kind") == "event")
    rows = [
        [
            name,
            s["count"],
            f"{s['total_ms']:.3f}",
            f"{s['mean_ms']:.3f}",
            f"{s['max_ms']:.3f}",
            s["open"] or "",
            s["errors"] or "",
        ]
        for name, s in sorted(
            stats.items(), key=lambda kv: -kv[1]["total_ms"]
        )
    ]
    table = markdown_table(
        rows,
        headers=["span", "count", "total ms", "mean ms", "max ms",
                 "open", "errors"],
    )
    return f"{table}\n\n{len(entries)} entries ({n_events} events)"


def host_device_join(entries: list[dict], profile_dir: str) -> str:
    """Join host spans with the device breakdown of a captured trace
    (``core/profile.py``): one report answering "where did the step
    go"."""
    from tpu_patterns_torch.core import profile as profile_mod

    lines = [summarize(entries), ""]
    bd = profile_mod.breakdown(profile_dir)
    if bd is None:
        lines.append(
            f"(no device plane under {profile_dir} — host spans only)"
        )
        return "\n".join(lines)
    host_ms = sum(
        e.get("dur_ns", 0) / 1e6
        for e in entries
        if e.get("kind") == "span" and e.get("depth", 0) == 0
    )
    lines.append("device plane (core/profile.py breakdown):")
    lines.append(
        f"  host (top-level spans): {host_ms:.3f} ms wall"
    )
    for cat, engine in (
        ("compute", "SMs"), ("collective", "NCCL/NVLink"),
        ("dma", "copy/memset"), ("infeed_outfeed", "host xfer"),
        ("other", "?"),
    ):
        ms = bd.get(f"{cat}_ms", 0.0)
        frac = bd.get(f"{cat}_frac")
        lines.append(
            f"  {engine + ' (' + cat + ')':24s} {ms:10.3f} ms"
            + (f"  ({frac:.1%} of busy)" if frac is not None else "")
        )
    lines.append(
        f"  device busy {bd.get('busy_ms', 0.0):.3f} ms / wall "
        f"{bd.get('wall_ms', 0.0):.3f} ms / idle "
        f"{bd.get('idle_ms', 0.0):.3f} ms"
    )
    return "\n".join(lines)


def journeys(entries: list[dict]) -> dict[str, list[dict]]:
    """Group journey anchors by jid, time-ordered: the flow-event
    source of :func:`chrome_trace` (``tpu_patterns/obs/fleet.py``)."""
    out: dict[str, list[dict]] = {}
    for e in entries:
        attrs = e.get("attrs") or {}
        jid = attrs.get("jid")
        if not jid:
            continue
        name = e.get("name", "")
        if e.get("kind") == "event" and name in JOURNEY_EVENTS:
            out.setdefault(str(jid), []).append(e)
        elif e.get("kind") == "span" and name in JOURNEY_SPANS:
            out.setdefault(str(jid), []).append(e)
    for anchors in out.values():
        anchors.sort(key=lambda e: e.get("t0_ns", 0))
    return out
