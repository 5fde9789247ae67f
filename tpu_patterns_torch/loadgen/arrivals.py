"""Seeded arrival processes: offsets (virtual seconds) for N requests.

A copy of ``tpu_patterns/loadgen/arrivals.py``.

Each process is a pure function of ``(n, rate_rps, rng)`` where ``rng``
is a caller-owned ``random.Random(seed)`` — no draw ever touches a
process-global RNG, so a scenario replays bit-identically (pinned by
a replay test).

Offsets are nondecreasing and start at the first inter-arrival gap, so
``offset / rate`` math never divides by zero and a trace's wall-clock
span is ``offsets[-1]`` virtual seconds before time scaling.
"""

from __future__ import annotations

import math
import random


def poisson(n: int, rate_rps: float, rng: random.Random) -> list[float]:
    """Memoryless arrivals: i.i.d. exponential gaps at ``rate_rps`` —
    the open-traffic baseline (chat users acting independently)."""
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(rate_rps)
        out.append(t)
    return out


def bursty(
    n: int,
    rate_rps: float,
    rng: random.Random,
    burstiness: float = 6.0,
    p_switch: float = 0.2,
) -> list[float]:
    """Markov-modulated Poisson: a two-state chain (burst / lull) flips
    with probability ``p_switch`` per arrival; the burst state runs
    ``burstiness``x hotter than the lull, normalized so the LONG-RUN
    mean rate stays ``rate_rps``.  This is agentic/tool-call traffic:
    quiet, then a volley."""
    if burstiness < 1.0:
        raise ValueError(f"burstiness must be >= 1, got {burstiness}")
    # the chain flips per ARRIVAL, so the states host equal arrival
    # counts but UNequal time (1/rate per arrival): the long-run rate
    # is the HARMONIC mean 2/(1/hi + 1/lo), not the arithmetic one —
    # solve 2*B*lo/(1+B) == rate with hi == B*lo (an arithmetic-mean
    # normalization under-delivers ~2x at burstiness 6)
    lo = rate_rps * (1.0 + burstiness) / (2.0 * burstiness)
    hi = burstiness * lo
    hot = False
    t, out = 0.0, []
    for _ in range(n):
        if rng.random() < p_switch:
            hot = not hot
        t += rng.expovariate(hi if hot else lo)
        out.append(t)
    return out


def diurnal(
    n: int,
    rate_rps: float,
    rng: random.Random,
    ramp: float = 3.0,
) -> list[float]:
    """A load ramp: the instantaneous rate climbs linearly from
    ``rate / ramp`` to ``rate * ramp`` across the trace (one rising
    edge of the day), normalized so the LONG-RUN mean rate is
    ``rate_rps``.  Gaps are exponential at the current rate — the
    thinning-free approximation is fine at trace scale, and what
    matters for the scheduler is the shape: sparse head, saturated
    tail."""
    if ramp < 1.0:
        raise ValueError(f"ramp must be >= 1, got {ramp}")
    lo, hi = rate_rps / ramp, rate_rps * ramp
    rates = [
        lo + (hi - lo) * (i / max(n - 1, 1)) for i in range(n)
    ]
    # expected span is sum(1/r_i); rescale so it equals n/rate — the
    # same harmonic-vs-arithmetic correction the bursty process needs
    corr = rate_rps * sum(1.0 / r for r in rates) / n
    t, out = 0.0, []
    for r in rates:
        t += rng.expovariate(r * corr)
        out.append(t)
    return out


ARRIVAL_PROCESSES = {
    "poisson": poisson,
    "bursty": bursty,
    "diurnal": diurnal,
}


def arrival_offsets(
    process: str, n: int, rate_rps: float, rng: random.Random
) -> list[float]:
    """Dispatch by name; unknown processes fail loudly at build time."""
    if process not in ARRIVAL_PROCESSES:
        raise ValueError(
            f"unknown arrival process {process!r} "
            f"(want one of {sorted(ARRIVAL_PROCESSES)})"
        )
    if n < 1:
        raise ValueError(f"need at least one arrival, got n={n}")
    if not (rate_rps > 0 and math.isfinite(rate_rps)):
        raise ValueError(f"rate_rps must be finite and > 0, got {rate_rps}")
    return ARRIVAL_PROCESSES[process](n, rate_rps, rng)
