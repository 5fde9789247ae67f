"""Prefix-aware request router: consistent hashing on radix block keys.

The port's copy of ``tpu_patterns/serve/router.py`` (no tensors: the
same ring, fingerprints and policies, so the same prompts reach the same
replicas in both packages).

The front door of the replica fleet.  The prefix cache makes a
single engine remember shared prompt prefixes at block granularity —
an N-replica fleet only keeps that win if requests sharing a prefix
LAND ON THE SAME REPLICA, so the router's hash key is exactly the
radix index's edge scheme (serve/prefix.py): the prompt's first
``route_blocks`` whole-block token tuples.  Two prompts agreeing on
their first ``route_blocks * block_len`` tokens hash identically and
ride to the replica already holding those blocks; prompts diverging
inside the first block scatter, which is correct — they share nothing
aliasable.

Placement is a consistent-hash ring (``vnodes`` seeded points per
replica, SHA-256 — Python's builtin ``hash`` is salted per process and
would re-shuffle the fleet every restart): removing a dead replica
remaps ONLY its arc to the next survivors, so a fail-over does not
reshuffle the prefix->replica affinity the surviving caches spent the
whole run building.  ``round_robin`` is the affinity-blind baseline
the routing-comparison Record measures against.

Every decision passes the ``router.route`` fault site (ctx: rid,
replica) and books ``tpu_patterns_router_*`` metrics: routed requests
per replica, prefix-affinity hits (a fingerprint seen before, sent to
the same live replica again), and reroutes (fail-over or a faulted
primary choice).
"""

from __future__ import annotations

import bisect
import hashlib
import threading

from tpu_patterns_torch import faults, obs


def prefix_fingerprint(
    tokens: list[int], block_len: int, route_blocks: int = 2
) -> str:
    """The routing key: SHA-256 over the prompt's first
    ``route_blocks`` WHOLE-block token tuples (the radix index's edge
    keys).  A prompt shorter than one block keys on its raw tokens —
    identical short prompts still co-locate."""
    if block_len < 1:
        raise ValueError(f"block_len must be >= 1, got {block_len}")
    if route_blocks < 1:
        raise ValueError(f"route_blocks must be >= 1, got {route_blocks}")
    n_full = len(tokens) // block_len
    if n_full == 0:
        key = ("short", tuple(tokens))
    else:
        key = tuple(
            tuple(tokens[j * block_len : (j + 1) * block_len])
            for j in range(min(n_full, route_blocks))
        )
    return hashlib.sha256(repr(key).encode()).hexdigest()


def _point(label: str) -> int:
    return int.from_bytes(
        hashlib.sha256(label.encode()).digest()[:8], "big"
    )


class ConsistentHashRing:
    """``vnodes`` points per node on a 64-bit ring; lookup walks
    clockwise to the first point owned by a LIVE node."""

    def __init__(self, nodes: list[str], vnodes: int = 64):
        if not nodes:
            raise ValueError("ring needs at least one node")
        self._points: list[tuple[int, str]] = sorted(
            (_point(f"{node}#{v}"), node)
            for node in nodes
            for v in range(vnodes)
        )
        self._live = set(nodes)

    def remove(self, node: str) -> None:
        self._live.discard(node)

    def restore(self, node: str) -> None:
        self._live.add(node)

    def live(self) -> set[str]:
        return set(self._live)

    def lookup(self, fingerprint: str, exclude: set | None = None):
        """The live node owning ``fingerprint``'s arc (skipping
        ``exclude``), or None when nobody is left."""
        ok = self._live - (exclude or set())
        if not ok:
            return None
        n = len(self._points)
        start = bisect.bisect_left(
            self._points, (_point(fingerprint), "")
        )
        for i in range(n):
            _, node = self._points[(start + i) % n]
            if node in ok:
                return node
        return None


class Router:
    """Routing policy over a replica fleet; thread-safe.

    ``policy="prefix"`` consistent-hashes the prompt's block-granular
    prefix fingerprint; ``"round_robin"`` deals over the live set in
    rid-independent rotation.  ``route()`` raises
    :class:`faults.InjectedFault` when the router.route site fires an
    ``error`` — the caller falls back via :meth:`fallback` (counted as
    a reroute, like any fail-over rerouting).
    """

    POLICIES = ("prefix", "round_robin")

    def __init__(
        self,
        replicas: list[str],
        *,
        block_len: int,
        policy: str = "prefix",
        route_blocks: int = 2,
        vnodes: int = 64,
    ):
        if policy not in self.POLICIES:
            raise ValueError(
                f"unknown router policy {policy!r} "
                f"(want one of {self.POLICIES})"
            )
        self.policy = policy
        self.block_len = block_len
        self.route_blocks = route_blocks
        self.ring = ConsistentHashRing(list(replicas), vnodes=vnodes)
        self._lock = threading.Lock()
        self._rr = 0
        # fingerprint -> replica it last routed to (live at the time):
        # a repeat fingerprint landing on the same live replica is a
        # prefix-affinity HIT — the router-side view of the engine's
        # prefix_hit_blocks
        self._seen: dict[str, str] = {}
        self.routed = 0
        self.prefix_hits = 0
        self.reroutes = 0

    def quarantine(self, replica: str) -> None:
        """Take ``replica`` out of rotation (breaker open / dead)."""
        self.ring.remove(replica)

    def restore(self, replica: str) -> None:
        """Put ``replica`` back in rotation (elastic scale-out of a
        reserved slice): its vnodes were fixed at construction, so only
        its OWN arc remaps back — every other replica's prefix affinity
        is untouched (the ring's membership property, in reverse)."""
        self.ring.restore(replica)

    def live(self) -> set[str]:
        return self.ring.live()

    def _pick(self, tokens: list[int], exclude: set | None):
        if self.policy == "round_robin":
            ok = sorted(self.ring.live() - (exclude or set()))
            if not ok:
                return None
            with self._lock:
                node = ok[self._rr % len(ok)]
                self._rr += 1
            return node
        fp = prefix_fingerprint(
            tokens, self.block_len, self.route_blocks
        )
        node = self.ring.lookup(fp, exclude=exclude)
        if node is None:
            return None
        with self._lock:
            if self._seen.get(fp) == node:
                self.prefix_hits += 1
                hit = True
            else:
                self._seen[fp] = node
                hit = False
        if hit:
            obs.counter(
                "tpu_patterns_router_prefix_hits_total",
                replica=str(node),
            ).inc()
        return node

    def route(self, rid: int, tokens: list[int], exclude=None) -> str:
        """The replica for ``rid``; raises RuntimeError when no live
        replica remains (the fleet is gone, not one request)."""
        target = self._pick(tokens, exclude)
        if target is None:
            raise RuntimeError(
                f"router: no live replica for request {rid} "
                f"(live={sorted(self.ring.live())}, "
                f"exclude={sorted(exclude or set())})"
            )
        # fault site: AFTER the decision, BEFORE the dispatch — an
        # ``error`` fails this choice (the manager reroutes via
        # fallback), a ``sleep`` stalls the front door
        faults.inject("router.route", rid=rid, replica=target)
        with self._lock:
            self.routed += 1
        obs.counter(
            "tpu_patterns_router_routed_total",
            replica=str(target), mode=self.policy,
        ).inc()
        return target

    def fallback(self, rid: int, tokens: list[int], exclude=None) -> str:
        """A reroute: the primary choice failed (fault or dead
        replica) — pick again among the remaining live set, counted."""
        target = self._pick(tokens, exclude)
        if target is None:
            raise RuntimeError(
                f"router: no live replica left to reroute request {rid}"
            )
        with self._lock:
            self.routed += 1
            self.reroutes += 1
        obs.counter(
            "tpu_patterns_router_reroutes_total", replica=str(target)
        ).inc()
        obs.counter(
            "tpu_patterns_router_routed_total",
            replica=str(target), mode=self.policy,
        ).inc()
        return target
