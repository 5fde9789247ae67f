"""Metrics registry: counters, gauges, histograms; JSONL + Prometheus text.

The port's copy of ``tpu_patterns/obs/metrics.py``.  One difference:
the run-provenance stamp (run id, git SHA, mesh fingerprint) comes from
the reference's ``perf/provenance.py``, which is not ported, so a live
registry's stamp is empty (``# RUN`` with no pairs); a registry read
back from a dump keeps the dump's.

Dependency-free (no prometheus_client — the container bakes nothing in,
and the text exposition format is 20 lines).  Metrics are keyed by
(name, sorted labels); the span layer feeds a duration histogram per span
name, runners add their own gauges (loss, throughput) and counters
(steps, sweep cells).  Export is pull-only: ``to_prom_text()`` renders
the registry for a scrape-style consumer, ``to_jsonl()`` appends to the
same JSONL discipline every Record stream uses, and ``parse_prom_text``
and ``registry_from_jsonl`` read both back (the round trips the tests
pin; ``obs export --prom`` renders a dumped run's registry).
"""

from __future__ import annotations

import json
import math
import re
import threading
from typing import Iterable


# Span durations are nanoseconds: exponential decades from 1 µs to 1000 s.
DEFAULT_BUCKETS: tuple[float, ...] = tuple(
    float(10 ** e) for e in range(3, 13)
)


def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, labels: dict[str, str], help: str = ""):
        self.name = name
        self.labels = dict(labels)
        self.help = help
        self._lock = threading.Lock()


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, labels, help=""):
        super().__init__(name, labels, help)
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += v


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, labels, help=""):
        super().__init__(name, labels, help)
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, labels, help="", buckets=None):
        super().__init__(name, labels, help)
        bs = tuple(sorted(buckets or DEFAULT_BUCKETS))
        if not bs or bs[-1] != math.inf:
            bs = bs + (math.inf,)
        self.buckets = bs
        # counts is per-bucket, NON-cumulative
        self.counts = [0] * len(bs)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        with self._lock:
            self.sum += v
            self.count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    break

    def snapshot(self) -> tuple[list[tuple[float, int]], float, int]:
        """(cumulative pairs, sum, count) under ONE lock acquisition —
        a concurrent scrape must never render a ``_count`` that
        disagrees with ``bucket{le="+Inf"}`` (the exposition invariant;
        reading them in separate steps races with ``observe``)."""
        out, acc = [], 0
        with self._lock:
            for b, c in zip(self.buckets, self.counts):
                acc += c
                out.append((b, acc))
            return out, self.sum, self.count

    def cumulative(self) -> list[tuple[float, int]]:
        """(le, cumulative count) pairs — the Prometheus exposition shape."""
        return self.snapshot()[0]


class Registry:
    def __init__(self):
        self._metrics: dict[tuple, _Metric] = {}
        self._lock = threading.Lock()
        # the provenance of the metrics IN this registry: None = live
        # (stamped at export time), set by registry_from_jsonl so a past
        # run's dump keeps its own stamp when exported again
        self.run_stamp: dict[str, str] | None = None

    def _get(self, cls, name: str, help: str, labels: dict, **kw):
        key = (cls.kind, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, labels, help=help, **kw)
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(
        self, name: str, help: str = "", buckets=None, **labels
    ) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def _stamp(self) -> dict[str, str]:
        if self.run_stamp is not None:
            return self.run_stamp
        return {}  # the live stamp waits for perf/provenance.py

    # -- export ----------------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4 — the one renderer
        behind BOTH consumers: the ``--obs-dump`` file path
        (``obs export --prom``) and the live ``/metrics`` scrape
        (obs/live.py), so dump and scrape are byte-identical for the
        same registry state (pinned by tests).

        Race-free against writer threads: the metric LIST is
        snapshotted under the registry lock (:meth:`metrics`), each
        histogram's cumulative view under its own metric lock, and
        counter/gauge value reads are single attribute loads published
        under their metric locks — a concurrent scrape may land
        between two increments but never tears a sample or loses a
        count (the N-writers-vs-M-scrapers test pins totals lossless).

        The first line is a run-provenance comment (``# RUN k=v ...``)
        — comments are ignored by every exposition parser, so the stamp
        rides along without breaking round-trips.
        """
        by_name: dict[str, list[_Metric]] = {}
        for m in self.metrics():
            by_name.setdefault(m.name, []).append(m)
        lines: list[str] = [_run_stamp_comment(self._stamp())]
        for name in sorted(by_name):
            group = by_name[name]
            if group[0].help:
                lines.append(f"# HELP {name} {group[0].help}")
            lines.append(f"# TYPE {name} {group[0].kind}")
            for m in group:
                if isinstance(m, Histogram):
                    pairs, h_sum, h_count = m.snapshot()
                    for le, acc in pairs:
                        lines.append(
                            f"{name}_bucket"
                            f"{_prom_labels(m.labels, le=_prom_float(le))}"
                            f" {acc}"
                        )
                    lines.append(
                        f"{name}_sum{_prom_labels(m.labels)} {_num(h_sum)}"
                    )
                    lines.append(
                        f"{name}_count{_prom_labels(m.labels)} {h_count}"
                    )
                else:
                    lines.append(
                        f"{name}{_prom_labels(m.labels)} {_num(m.value)}"
                    )
        return "\n".join(lines) + "\n"

    def to_prom_text(self) -> str:
        """Alias of :meth:`render` — the pre-PR-15 name every dump
        path calls; kept so dump and scrape visibly share one
        implementation."""
        return self.render()

    def to_jsonl(self) -> str:
        """One JSON object per metric — the suite's JSONL discipline.

        The first line is a run-provenance object (``{"type": "run",
        ...}``): a reader skips unknown types, so the stamp makes dumps
        joinable across runs without breaking replay.
        """
        from tpu_patterns_torch.core import timing

        ts = timing.wall_time_s()
        lines = [json.dumps(
            {"type": "run", "ts": ts, **self._stamp()}, sort_keys=True
        )]
        for m in self.metrics():
            d: dict = {
                "metric": m.name, "type": m.kind, "labels": m.labels,
                "ts": ts,
            }
            if isinstance(m, Histogram):
                pairs, h_sum, h_count = m.snapshot()
                d["sum"] = h_sum
                d["count"] = h_count
                d["buckets"] = [
                    [_prom_float(le), acc] for le, acc in pairs
                ]
            else:
                d["value"] = m.value
            lines.append(json.dumps(d, sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")


def _run_stamp_comment(stamp: dict[str, str]) -> str:
    """``# RUN run_id=... git_sha=... mesh_fp=...`` — the provenance
    stamp in comment form (exposition parsers skip ``#`` lines)."""
    kv = " ".join(f"{k}={v}" for k, v in sorted(stamp.items()))
    return f"# RUN {kv}"


def _num(v: float) -> str:
    # Prometheus spells non-finite samples NaN/+Inf/-Inf — and a NaN
    # train loss is exactly the run these exports exist to diagnose, so
    # rendering must not crash on it (int(nan) raises)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if v != int(v) else str(int(v))


def _prom_float(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    return _num(v)


def _prom_labels(labels: dict[str, str], **extra: str) -> str:
    items = list(sorted(labels.items())) + list(extra.items())
    if not items:
        return ""
    body = ",".join(
        '{}="{}"'.format(
            k, str(v).replace("\\", "\\\\").replace('"', '\\"')
        )
        for k, v in items
    )
    return "{" + body + "}"


_DEFAULT = Registry()


def default() -> Registry:
    return _DEFAULT


def counter(name: str, help: str = "", **labels) -> Counter:
    return _DEFAULT.counter(name, help, **labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    return _DEFAULT.gauge(name, help, **labels)


def histogram(name: str, help: str = "", buckets=None, **labels) -> Histogram:
    return _DEFAULT.histogram(name, help, buckets=buckets, **labels)


_SAMPLE_RE = re.compile(
    r"^(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)\s*$"
)
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prom_text(text: str) -> dict[tuple, float]:
    """Parse exposition text into {(name, ((label, value), ...)): value}.

    The inverse of :meth:`Registry.to_prom_text` for plain samples
    (histogram series come back as their ``_bucket``/``_sum``/``_count``
    component samples) — enough for round-trip tests and ``obs watch``.
    """
    out: dict[tuple, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable prometheus sample: {line!r}")
        labels = tuple(
            (k, v.replace('\\"', '"').replace("\\\\", "\\"))
            for k, v in _LABEL_RE.findall(m.group("labels") or "")
        )
        raw = m.group("value")
        val = math.inf if raw == "+Inf" else float(raw)
        out[(m.group("name"), labels)] = val
    return out


def registry_from_jsonl(lines: Iterable[str]) -> Registry:
    """Rebuild a Registry from :meth:`Registry.to_jsonl` output — the
    CLI's ``obs export --prom`` renders a *dumped* run's metrics, which
    necessarily lives in a different process from the run."""
    reg = Registry()
    for line in lines:
        line = line.strip()
        if not line:
            continue
        d = json.loads(line)
        labels = d.get("labels", {})
        kind = d.get("type")
        if kind == "run":
            # keep the DUMPED run's provenance
            reg.run_stamp = {
                k: str(d[k])
                for k in ("run_id", "git_sha", "mesh_fp")
                if k in d
            }
            continue
        if kind == "counter":
            reg.counter(d["metric"], **labels).inc(d["value"])
        elif kind == "gauge":
            reg.gauge(d["metric"], **labels).set(d["value"])
        elif kind == "histogram":
            pairs = [
                (math.inf if le == "+Inf" else float(le), int(acc))
                for le, acc in d.get("buckets", [])
            ]
            finite = [le for le, _ in pairs if le != math.inf]
            h = reg.histogram(d["metric"], buckets=finite, **labels)
            prev = 0
            for i, (_, acc) in enumerate(pairs):
                h.counts[i] = acc - prev  # de-cumulate
                prev = acc
            h.sum = float(d.get("sum", 0.0))
            h.count = int(d.get("count", 0))
    return reg
