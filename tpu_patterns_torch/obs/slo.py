"""SLO burn-rate monitor: rolling dual-window good/bad-token accounting.

The port's copy of ``tpu_patterns/obs/slo.py``, on the port's clock.

The loadgen runner judges SLOs *post-mortem*: percentiles and
goodput are computed after the last request retired.  This module is
the live half — the question "are you burning your SLO error budget
RIGHT NOW?" answered while the serve loop runs, the way production
alerting does it (multi-window burn-rate alerts):

  * every finalized request books its generated tokens as GOOD (met
    its deadline — the loadgen deadline semantics already stamped on
    ``Request.deadline_ms``) or BAD (missed, or failed),
  * tokens land in a bucketed ring on the monotonic ``clock_ns`` (the
    house clock — never wall time, so replays are deterministic the
    same way the KV tier's LRU stamps are clock-free),
  * two rolling windows read the ring: a FAST window (default 1m)
    that reacts, and a SLOW window (default 5m) that contextualizes,
  * burn rate = (bad-token fraction in the window) / ``budget``: 1.0
    means burning exactly the allowed error budget, above means the
    budget dies early.

When the fast window's burn exceeds ``multiplier`` the monitor fires
ONCE (per episode): a watchdog-style WARNING Record (``slo.jsonl``
under the obs run dir + stderr marker), a flight-recorder event, and
the ``tpu_patterns_slo_burn_rate`` gauge — and flips ``mitigating()``
True, which the serve engine's opt-in degradation ladder
(``--burn_mitigation shed|spec_off``, serve/engine.py) consumes.  The
episode ends when the fast window recovers (burn back at/below
``recover``): buckets age out, so recovery needs no new traffic.

The monitor also publishes LIVE tail latency — TTFT/TPOT p50/p95/p99
from the loadgen streaming percentile sketch — as gauges, so a
``/metrics`` scrape (obs/live.py) shows p99 mid-run instead of after
the autopsy.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading

from tpu_patterns_torch.core.timing import clock_ns

# ring resolution: the slow window is always covered by this many
# buckets, so window math is O(1)-ish regardless of window length
N_BUCKETS = 256


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """Burn-rate knobs (the ``serve``/``loadgen`` CLI flags map here).

    ``budget`` is the allowed bad-token fraction (0.1 = 10% of tokens
    may come from deadline-missing requests before burn hits 1.0);
    ``multiplier`` is the fast-window burn that trips mitigation;
    ``recover`` is the burn at/below which the episode ends.
    """

    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    budget: float = 0.1
    multiplier: float = 2.0
    recover: float = 1.0

    def __post_init__(self):
        if not 0 < self.fast_window_s <= self.slow_window_s:
            raise ValueError(
                f"want 0 < fast_window_s <= slow_window_s, got "
                f"({self.fast_window_s}, {self.slow_window_s})"
            )
        if not 0 < self.budget <= 1:
            raise ValueError(
                f"budget is a token fraction in (0, 1], got {self.budget}"
            )
        if self.multiplier <= 0:
            raise ValueError(
                f"multiplier must be > 0, got {self.multiplier}"
            )
        if not 0 < self.recover <= self.multiplier:
            raise ValueError(
                f"want 0 < recover <= multiplier, got "
                f"({self.recover}, {self.multiplier})"
            )


class SloMonitor:
    """The in-process monitor one :class:`~tpu_patterns_torch.serve.engine.
    ServeEngine` owns (always on — with no deadlines in the trace every
    token is good and the monitor is inert).

    Thread contract: ``observe``/``mitigating`` run on the scheduler
    thread; ``snapshot`` may be called from the HTTP plane's threads —
    all state transitions happen under one lock, Record/event emission
    happens outside it.
    """

    def __init__(self, cfg: SloConfig | None = None, *, replica: str = ""):
        # lazy: loadgen imports serve.engine, which imports this module
        # — pulling the sketch in at module import time would cycle
        from tpu_patterns_torch.loadgen.percentiles import (
            StreamingPercentiles,
        )

        self.cfg = cfg or SloConfig()
        self.replica = replica
        self._lock = threading.Lock()
        self._t0 = clock_ns()
        self._bucket_ns = max(
            int(self.cfg.slow_window_s * 1e9 / N_BUCKETS), 1
        )
        self._fast_k = max(
            1, round(self.cfg.fast_window_s * 1e9 / self._bucket_ns)
        )
        self._good = [0.0] * N_BUCKETS
        self._bad = [0.0] * N_BUCKETS
        self._head = 0
        self._last_pub = -1
        self._mitigating = False
        self.fires = 0
        self.good_total = 0.0
        self.bad_total = 0.0
        self.ttft = StreamingPercentiles()
        self.tpot = StreamingPercentiles()
        # per-priority-class live tails + goodput split: {priority:
        # {"ttft": sketch, "tpot": sketch, "good": float, "bad": float}}
        # — keyed lazily so a class-free trace stays one flat pair of
        # sketches
        self.by_class: dict[str, dict] = {}

    # -- ring ------------------------------------------------------------

    def _advance(self, now_ns: int) -> None:
        idx = (now_ns - self._t0) // self._bucket_ns
        if idx <= self._head:
            return
        step = min(idx - self._head, N_BUCKETS)
        for i in range(1, step + 1):
            slot = (self._head + i) % N_BUCKETS
            self._good[slot] = self._bad[slot] = 0.0
        self._head = idx

    def _window(self, k: int) -> tuple[float, float]:
        """(good, bad) token totals over the most recent ``k`` buckets."""
        g = b = 0.0
        for i in range(min(k, N_BUCKETS, self._head + 1)):
            slot = (self._head - i) % N_BUCKETS
            g += self._good[slot]
            b += self._bad[slot]
        return g, b

    def _burn(self, g: float, b: float) -> float:
        tot = g + b
        return (b / tot) / self.cfg.budget if tot > 0 else 0.0

    # -- the feed --------------------------------------------------------

    def observe(
        self,
        *,
        tokens: int,
        met: bool,
        ttft_ms: float | None = None,
        tpot_ms: float | None = None,
        priority: str = "",
    ) -> None:
        """Book one finalized request: its generated tokens against the
        deadline verdict, its latencies into the live sketches (the
        flat ones and, when the request carries a ``priority`` class,
        that class's keyed pair too)."""
        from tpu_patterns_torch.loadgen.percentiles import (
            StreamingPercentiles,
        )

        fired = recovered = False
        with self._lock:
            self._advance(clock_ns())
            slot = self._head % N_BUCKETS
            cls = None
            if priority:
                cls = self.by_class.setdefault(priority, {
                    "ttft": StreamingPercentiles(),
                    "tpot": StreamingPercentiles(),
                    "good": 0.0, "bad": 0.0,
                })
            if met:
                self._good[slot] += tokens
                self.good_total += tokens
                if cls is not None:
                    cls["good"] += tokens
            else:
                self._bad[slot] += tokens
                self.bad_total += tokens
                if cls is not None:
                    cls["bad"] += tokens
            if ttft_ms is not None:
                self.ttft.observe(ttft_ms)
                if cls is not None:
                    cls["ttft"].observe(ttft_ms)
            if tpot_ms is not None:
                self.tpot.observe(tpot_ms)
                if cls is not None:
                    cls["tpot"].observe(tpot_ms)
            gf, bf = self._window(self._fast_k)
            gs, bs = self._window(N_BUCKETS)
            burn_fast, burn_slow = self._burn(gf, bf), self._burn(gs, bs)
            if not self._mitigating and burn_fast > self.cfg.multiplier:
                self._mitigating = True
                self.fires += 1
                fired = True
            elif self._mitigating and burn_fast <= self.cfg.recover:
                self._mitigating = False
                recovered = True
            publish_pcts = fired or self._head != self._last_pub
            self._last_pub = self._head
        self._publish(burn_fast, burn_slow, pcts=publish_pcts)
        if fired:
            self._fire(burn_fast, burn_slow, gf, bf)
        if recovered:
            self._recover(burn_fast)

    def mitigating(self) -> bool:
        """Is a burn episode active right now?  Buckets age out on the
        clock, so an episode ends without new observations — the window
        recovering is what re-opens admission."""
        with self._lock:
            if not self._mitigating:
                return False
            self._advance(clock_ns())
            gf, bf = self._window(self._fast_k)
            if self._burn(gf, bf) <= self.cfg.recover:
                self._mitigating = False
            else:
                return True
            burn_fast = self._burn(gf, bf)
        self._recover(burn_fast)
        return False

    # -- export ----------------------------------------------------------

    def _publish(
        self, burn_fast: float, burn_slow: float, *, pcts: bool
    ) -> None:
        from tpu_patterns_torch import obs

        obs.gauge("tpu_patterns_slo_burn_rate", window="fast").set(
            burn_fast
        )
        obs.gauge("tpu_patterns_slo_burn_rate", window="slow").set(
            burn_slow
        )
        if not pcts:
            return
        for key, sk in (("ttft", self.ttft), ("tpot", self.tpot)):
            if not sk.count:
                continue
            for q, label in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                obs.gauge(
                    f"tpu_patterns_slo_live_{key}_{label}_ms"
                ).set(sk.quantile(q))
        # per-class tails ride the SAME series names with a priority
        # label — the unlabeled gauges above keep their exact keys
        # (test_live pins them), the labeled ones add the breakdown
        for cls, d in self.by_class.items():
            for key in ("ttft", "tpot"):
                sk = d[key]
                if not sk.count:
                    continue
                for q, label in (
                    (0.5, "p50"), (0.95, "p95"), (0.99, "p99")
                ):
                    obs.gauge(
                        f"tpu_patterns_slo_live_{key}_{label}_ms",
                        priority=cls,
                    ).set(sk.quantile(q))

    def _fire(
        self, burn_fast: float, burn_slow: float, good: float, bad: float
    ) -> None:
        """The watchdog-style WARNING trail: Record + ring event +
        counter, best-effort — a logging failure must never take the
        scheduler thread down with it."""
        try:
            from tpu_patterns_torch import obs
            from tpu_patterns_torch.core.results import (
                Record,
                ResultWriter,
                Verdict,
            )

            obs.counter("tpu_patterns_slo_burn_warnings_total").inc()
            obs.event(
                "slo.burn", burn_fast=f"{burn_fast:.3f}",
                burn_slow=f"{burn_slow:.3f}", replica=self.replica,
            )
            ResultWriter(
                jsonl_path=os.path.join(obs.run_dir(), "slo.jsonl"),
                stream=sys.stderr,
            ).record(Record(
                pattern="obs",
                mode="slo_burn",
                commands=(
                    f"fast {self.cfg.fast_window_s:g}s / "
                    f"slow {self.cfg.slow_window_s:g}s"
                ),
                metrics={
                    "burn_rate_fast": round(burn_fast, 4),
                    "burn_rate_slow": round(burn_slow, 4),
                    "good_tokens_fast": good,
                    "bad_tokens_fast": bad,
                    "budget": self.cfg.budget,
                    "multiplier": self.cfg.multiplier,
                },
                verdict=Verdict.WARNING,
                notes=[
                    f"fast-window burn {burn_fast:.2f}x the error "
                    f"budget exceeds the {self.cfg.multiplier:g}x "
                    "multiplier — the SLO budget is dying early"
                    + (f" (replica {self.replica})" if self.replica else ""),
                ],
            ))
        except Exception:  # the trail is best-effort: never alters serving
            pass

    def _recover(self, burn_fast: float) -> None:
        try:
            from tpu_patterns_torch import obs

            obs.event(
                "slo.recovered", burn_fast=f"{burn_fast:.3f}",
                replica=self.replica,
            )
        except Exception:  # same contract as the fire trail
            pass

    def snapshot(self) -> dict:
        """The ``/healthz`` block: burns, episode state, live tails."""
        with self._lock:
            self._advance(clock_ns())
            gf, bf = self._window(self._fast_k)
            gs, bs = self._window(N_BUCKETS)
            return {
                "burn_rate_fast": round(self._burn(gf, bf), 4),
                "burn_rate_slow": round(self._burn(gs, bs), 4),
                "mitigating": self._mitigating
                and self._burn(gf, bf) > self.cfg.recover,
                "fires": self.fires,
                "good_tokens": self.good_total,
                "bad_tokens": self.bad_total,
                "budget": self.cfg.budget,
                "multiplier": self.cfg.multiplier,
                "ttft_p99_ms": self.ttft.quantile(0.99),
                "tpot_p99_ms": self.tpot.quantile(0.99),
                "by_class": {
                    cls: {
                        "good_tokens": d["good"],
                        "bad_tokens": d["bad"],
                        "ttft_p99_ms": d["ttft"].quantile(0.99),
                        "tpot_p99_ms": d["tpot"].quantile(0.99),
                    }
                    for cls, d in self.by_class.items()
                },
            }
