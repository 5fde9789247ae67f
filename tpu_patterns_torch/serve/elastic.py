"""Elastic fleet policy: when to scale out, when to scale in.

The port's copy of ``tpu_patterns/serve/elastic.py`` (pure Python: the
same decisions from the same signals).

The decision half of the self-sizing fleet, kept PURE so it unit-tests
without a mesh, a process, or a clock of its own: the ReplicaManager
(serve/replica.py) feeds it fleet-scope signals it already owns —
lease occupancy (in-flight leases per live replica slot, the parent's
ledgered view of every child's queue + active set), pending arrivals,
and the live replica count — and the policy answers ``"out"``,
``"in"``, or ``None``.

Mechanically the fleet pre-partitions N + R disjoint placement slices
(topo/placement.py) and constructs the router's consistent-hash ring
over ALL N + R ids with the R reserves quarantined: scale-out is
``ring.restore`` (only the reserve's own arc remaps — the surviving
caches keep their prefix affinity, the ring's membership property) and
scale-in is the existing drain-to-snapshot path with the replica's
session cache banked via its per-replica session dir, so its warm
prefixes survive the shrink and a later scale-out on the same slice
resumes them.

Hysteresis is built in three ways, because a flapping fleet is worse
than a mis-sized one:

  * separate high/low waters (``out_occupancy`` > ``in_occupancy``),
  * a sustain window — the signal must HOLD past its water for
    ``sustain_s`` before the policy acts (one bursty poll never
    scales),
  * a cooldown — after any action the policy stays quiet for
    ``cooldown_s`` (the fleet must observe the new size before
    resizing again).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Policy knobs (CLI: the ``scale_*`` serve flags)."""

    reserve: int  # R reserved slices the fleet may grow into
    out_occupancy: float = 1.25  # leases/slot high water (scale out)
    in_occupancy: float = 0.25  # leases/slot low water (scale in)
    sustain_s: float = 0.5  # signal must hold this long to act
    cooldown_s: float = 2.0  # min gap between scale actions
    min_live: int = 1  # scale-in floor

    def __post_init__(self):
        if self.reserve < 0:
            raise ValueError(
                f"reserve must be >= 0, got {self.reserve}"
            )
        if not 0 <= self.in_occupancy < self.out_occupancy:
            raise ValueError(
                "want 0 <= in_occupancy < out_occupancy, got "
                f"({self.in_occupancy}, {self.out_occupancy})"
            )
        if self.sustain_s < 0 or self.cooldown_s < 0:
            raise ValueError(
                "sustain_s and cooldown_s must be >= 0, got "
                f"({self.sustain_s}, {self.cooldown_s})"
            )
        if self.min_live < 1:
            raise ValueError(
                f"min_live must be >= 1, got {self.min_live}"
            )


@dataclasses.dataclass(frozen=True)
class FleetSignals:
    """One poll of the parent-side view the policy decides from."""

    leases: int  # in-flight leases across live replicas (queued+active)
    pending: int  # arrivals due but not yet dispatched
    live: int  # ready replicas (routable)
    spare: int  # reserve slices still available to grow into
    slots: int  # per-replica active-set ceiling (child_cfg["slots"])

    def occupancy(self) -> float:
        """In-flight work per live replica SLOT — > 1 means every live
        replica has more work ledgered against it than its active set
        can hold (the rest queues child-side)."""
        denom = max(self.live, 1) * max(self.slots, 1)
        return (self.leases + self.pending) / denom


class ElasticPolicy:
    """The scale state machine.  Feed :meth:`decide` monotonic time
    plus the current :class:`FleetSignals`; it returns ``"out"``,
    ``"in"``, or ``None``.  The caller performs the action (spawn /
    drain) and the cooldown starts from the decision — an aborted
    action (fault site, spawn failure) still consumes the cooldown, so
    a failing scale path cannot spin."""

    def __init__(self, cfg: ElasticConfig):
        self.cfg = cfg
        self._over_since: float | None = None
        self._under_since: float | None = None
        self._last_action_t: float | None = None
        self.decisions: list[tuple[float, str]] = []

    def _cooling(self, now: float) -> bool:
        return (
            self._last_action_t is not None
            and now - self._last_action_t < self.cfg.cooldown_s
        )

    def decide(self, now: float, sig: FleetSignals) -> str | None:
        occ = sig.occupancy()
        # sustain windows track regardless of cooldown: a burst that
        # started during cooldown still counts its full duration
        if occ > self.cfg.out_occupancy:
            self._over_since = (
                now if self._over_since is None else self._over_since
            )
        else:
            self._over_since = None
        if occ < self.cfg.in_occupancy:
            self._under_since = (
                now if self._under_since is None else self._under_since
            )
        else:
            self._under_since = None
        if self._cooling(now):
            return None
        if (
            self._over_since is not None
            and now - self._over_since >= self.cfg.sustain_s
            and sig.spare > 0
        ):
            self._last_action_t = now
            self._over_since = None
            self.decisions.append((now, "out"))
            return "out"
        if (
            self._under_since is not None
            and now - self._under_since >= self.cfg.sustain_s
            and sig.live > self.cfg.min_live
            and sig.leases + sig.pending
            <= (sig.live - 1) * max(sig.slots, 1)
        ):
            # the shrink must FIT: the survivors' slots must cover the
            # in-flight work, or the drain would immediately re-queue
            # pressure the policy just created
            self._last_action_t = now
            self._under_since = None
            self.decisions.append((now, "in"))
            return "in"
        return None
