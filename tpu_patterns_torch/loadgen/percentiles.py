"""Streaming percentile estimator: exact small, bounded-error large.

A copy of ``tpu_patterns/loadgen/percentiles.py``.

The SLO verdicts need p50/p95/p99 over per-request latencies without
holding an unbounded sample list in a long-running serve loop.  This
sketch keeps every observation (weight 1) until ``max_samples``, so at
CI/test scale the quantiles are EXACT — bit-equal to
``numpy.quantile(..., method="linear")`` — and beyond the cap it
compacts deterministically: sort, then merge adjacent pairs into the
heavier member carrying both weights.  Values in the buffer are always
values that were actually observed (no synthetic averages), min/max are
tracked exactly, and the rank error of one compaction is bounded by the
largest merged weight — more than enough resolution for a p99 over
thousands of requests with the default 2048-sample buffer.

Compaction uses NO randomness, so two runs that observe the same series
hold bit-identical state (the loadgen replay contract).  Sketches merge
(``a.merge(b)``) by buffer concatenation + re-compaction, so per-worker
estimators can fold into one report.
"""

from __future__ import annotations

import math


class StreamingPercentiles:
    """Mergeable quantile sketch over a bounded (value, weight) buffer."""

    def __init__(self, max_samples: int = 2048):
        if max_samples < 8:
            raise ValueError(f"max_samples must be >= 8, got {max_samples}")
        self.max_samples = max_samples
        self._vw: list[tuple[float, float]] = []  # (value, weight)
        self.count = 0
        self.total = 0.0
        self._min = math.inf
        self._max = -math.inf

    def __len__(self) -> int:
        return self.count

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            raise ValueError("cannot observe NaN")
        self._vw.append((v, 1.0))
        self.count += 1
        self.total += v
        self._min = min(self._min, v)
        self._max = max(self._max, v)
        if len(self._vw) > self.max_samples:
            self._compact()

    def _compact(self) -> None:
        """Halve the buffer: merge adjacent sorted pairs into whichever
        member is heavier (ties keep the lower value — deterministic),
        summing the weights.  Total weight is preserved exactly."""
        self._vw.sort()
        out: list[tuple[float, float]] = []
        it = iter(self._vw)
        for a in it:
            b = next(it, None)
            if b is None:
                out.append(a)
            elif b[1] > a[1]:
                out.append((b[0], a[1] + b[1]))
            else:
                out.append((a[0], a[1] + b[1]))
        self._vw = out

    def merge(self, other: "StreamingPercentiles") -> "StreamingPercentiles":
        """Fold ``other`` into this sketch (other is left untouched)."""
        self._vw.extend(other._vw)
        self.count += other.count
        self.total += other.total
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        while len(self._vw) > self.max_samples:
            self._compact()
        return self

    def quantile(self, q: float) -> float | None:
        """Linear-interpolated quantile over the weighted multiset —
        with all weights 1 this IS numpy's default ``method="linear"``.
        Returns None on an empty series (the caller renders that as a
        missing stat, never a fake zero)."""
        if not self._vw:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile wants q in [0, 1], got {q}")
        if q == 0.0:
            return self._min
        if q == 1.0:
            return self._max
        vw = sorted(self._vw)
        w_total = sum(w for _, w in vw)
        # each sample of weight w occupies w consecutive ranks of the
        # expanded multiset [0, W); interpolate at rank q * (W - 1)
        pos = q * (w_total - 1.0)
        lo_rank = math.floor(pos)
        frac = pos - lo_rank

        def value_at(rank: float) -> float:
            acc = 0.0
            for v, w in vw:
                acc += w
                if rank < acc:
                    return v
            return vw[-1][0]

        lo = value_at(lo_rank)
        if frac == 0.0:
            return lo
        return lo + (value_at(lo_rank + 1) - lo) * frac

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def summary(self) -> dict[str, float]:
        """The Record-ready stat block; empty series -> empty dict."""
        if not self.count:
            return {}
        return {
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "mean": self.mean,
            "max": self._max,
            "count": float(self.count),
        }
