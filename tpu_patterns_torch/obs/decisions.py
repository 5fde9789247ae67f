"""obs/decisions.py — the scheduler decision ledger: WHY, not just how
many.

The port's copy of ``tpu_patterns/obs/decisions.py``; ``explain_table``
renders with the port's own fixed-width table (``obs/table.py``); ``obs
explain`` hands it the fleet's merged timeline (``obs/fleet.py``).

Every control-plane action the serve stack takes — defer, evict, shed,
preempt, scale out/in, breaker trip, reroute — already increments a
counter somewhere.  Counters answer "how many"; an operator staring at
a shed spike needs "why THIS request, right then".  The ledger books
one structured event per action carrying the inputs that drove the
decision (free-list depth, burn rates, occupancy, queue depth at
decision time) plus a human rationale string.

Transport is the flight recorder: each booking lands an
``obs.event("decision.<action>", ...)`` in the flight recorder, so a
replica's decisions ship to the parent over the obs pipe and
``merge_fleet`` places them on the fleet timeline as instants — the
ledger needs no pipe of its own.  ``tpu-patterns obs explain`` filters
the merged timeline down to one request's (or one action's) story.

Coverage is gated by IDENTITY, the house style for accounting
(done+failed+shed == scheduled, leaked_blocks == 0): every booking
increments ``tpu_patterns_decision_events_total{action=...}`` by the
same count, at the same call site, as the pre-existing counter for
that action — so ``decision_events_total{action=defer} ==
serve_deferrals_total`` (and so on per action) is checkable offline
from any metrics dump.  A divergence means a decision happened that
the ledger never explained.

Booking is FAIL-OPEN behind the ``obs.cost_book`` fault site: an
injected (or real) booking error skips the record and the counter
together — the ledger stays internally consistent — and the scheduler
action itself proceeds untouched.  Observability must never block the
control plane it observes.
"""

from __future__ import annotations

from tpu_patterns_torch import faults
from tpu_patterns_torch.core.timing import clock_ns

# the closed action vocabulary — a typo'd action would silently open a
# ledger-vs-counter identity gap, so book() rejects anything else
ACTIONS = (
    "defer", "evict", "shed", "preempt",
    "scale_out", "scale_in", "breaker", "reroute", "handoff",
    "prewarm",
)

# per action: the existing counter the ledger must stay in identity
# with (docs/observability.md "Cost attribution & decision audit");
# scale_out/scale_in share one labeled series
COUNTER_IDENTITIES = {
    "defer": "tpu_patterns_serve_deferrals_total",
    "evict": "tpu_patterns_serve_kv_evictions_total",
    "shed": "tpu_patterns_serve_shed_total",
    "preempt": "tpu_patterns_serve_preempted_total",
    "scale_out": "tpu_patterns_fleet_scale_events_total",
    "scale_in": "tpu_patterns_fleet_scale_events_total",
    "breaker": "tpu_patterns_replica_breaker_trips_total",
    "reroute": "tpu_patterns_router_reroutes_total",
    "handoff": "tpu_patterns_disagg_transfers_total",
    "prewarm": "tpu_patterns_fleet_prewarms_total",
}


class DecisionLedger:
    """In-process decision log + the ``decision.*`` event emitter.

    One ledger per decision-making component (the serve engine owns
    one; the replica manager owns one for fleet-level actions).  The
    in-memory list serves /costz-style live snapshots and tests; the
    durable/cross-process copy is the event stream in the flight
    recorder."""

    def __init__(self, replica: str = ""):
        self.replica = replica
        self.events: list[dict] = []

    def book(
        self,
        action: str,
        *,
        rid: int | None = None,
        jid: str = "",
        count: int = 1,
        rationale: str = "",
        **inputs,
    ) -> None:
        """Record one decision.  ``count`` keeps counter identity for
        wave-granular actions (one evict WAVE books count=len(wave),
        matching the existing per-block counter).  ``inputs`` are the
        signal values read at decision time — they ride the event
        stringified, exactly as observed."""
        from tpu_patterns_torch import obs

        if action not in ACTIONS:
            raise ValueError(
                f"unknown decision action {action!r} "
                f"(want one of {sorted(ACTIONS)})"
            )
        try:
            # fail OPEN: a booking fault drops the record AND its
            # counter together (internal identity intact) and never
            # propagates into the scheduler path that called us
            faults.inject(
                "obs.cost_book",
                rid=-1 if rid is None else int(rid),
                replica=self.replica,
            )
        except faults.InjectedFault:
            return
        self.events.append({
            "action": action,
            "t_ns": clock_ns(),
            "rid": rid,
            "jid": jid,
            "replica": self.replica,
            "count": int(count),
            "rationale": rationale,
            "inputs": dict(inputs),
        })
        obs.counter(
            "tpu_patterns_decision_events_total", action=action
        ).inc(count)
        attrs = {k: str(v) for k, v in inputs.items()}
        if rid is not None:
            attrs["rid"] = str(rid)
        if jid:
            attrs["jid"] = jid
        if rationale:
            attrs["rationale"] = rationale
        if count != 1:
            attrs["count"] = str(count)
        obs.event(f"decision.{action}", **attrs)

    def count(self, action: str | None = None) -> int:
        """Booked decision count (Σ count), optionally per action —
        what the identity gates compare against metric totals."""
        return sum(
            e["count"] for e in self.events
            if action is None or e["action"] == action
        )


# -- querying the merged fleet timeline ------------------------------------

# timeline entries worth including in a request's explain story beyond
# the decision instants themselves: the journey anchors and lifecycle
# spans, plus the serve-side action events that carry
# a rid (the decision's effect, next to its cause)
_STORY_EVENTS = (
    "journey.route", "journey.reroute", "journey.admit",
    "journey.handoff",
    "serve.defer", "serve.shed", "serve.preempted", "serve.quarantine",
    "serve.cow_copy", "replica.reroute",
)
_STORY_SPANS = (
    "req.queued", "req.prefill", "req.first_token", "req.decode",
    "req.retired", "req.failed",
)


def _matches_key(e: dict, key: str) -> bool:
    attrs = e.get("attrs") or {}
    return str(attrs.get("rid")) == str(key) or (
        str(attrs.get("jid")) == str(key)
    )


def decision_entries(
    entries: list[dict],
    key: str | None = None,
    action: str | None = None,
) -> list[dict]:
    """Filter merged fleet entries (obs/fleet.py ``merge_fleet``) down
    to the explain story: all ``decision.*`` instants matching the
    filters, plus — when a specific request is asked about — its
    journey anchors and lifecycle spans, so the decisions read in the
    context of what they did to the request."""
    out = []
    for e in entries:
        name = e.get("name", "")
        if name.startswith("decision."):
            if action is not None and name != f"decision.{action}":
                continue
            if key is not None and not _matches_key(e, key):
                continue
            out.append(e)
        elif key is not None and action is None:
            if name in _STORY_EVENTS or name in _STORY_SPANS:
                if _matches_key(e, key):
                    out.append(e)
    out.sort(key=lambda e: e.get("t0_ns", 0))
    return out


def explain_table(
    entries: list[dict],
    key: str | None = None,
    action: str | None = None,
) -> str:
    """The ``obs explain`` rendering: one time-ordered markdown table
    of the filtered story.  ``key`` is a rid or jid; ``action`` limits
    to one decision kind fleet-wide (``--action evict``)."""
    from tpu_patterns_torch.obs.table import markdown_table

    story = decision_entries(entries, key=key, action=action)
    if not story:
        what = (
            f"decisions for {key!r}" if key is not None
            else f"decision.{action} events" if action else "decisions"
        )
        return f"no {what} in the merged dumps"
    t_base = story[0].get("t0_ns", 0)
    rows = []
    for e in story:
        attrs = dict(e.get("attrs") or {})
        rationale = attrs.pop("rationale", "")
        where = e.get("replica") or ""
        if where:
            where = f"replica {where}"
        rows.append([
            f"{(e.get('t0_ns', 0) - t_base) / 1e6:.3f}",
            where,
            e.get("name", "?"),
            rationale,
            " ".join(f"{k}={v}" for k, v in sorted(attrs.items())),
        ])
    head = (
        f"story for {key}" if key is not None
        else f"decision.{action} fleet-wide" if action
        else "all decisions"
    )
    table = markdown_table(
        rows, headers=["t ms", "process", "event", "rationale", "inputs"],
    )
    return f"{head}\n\n{table}"
