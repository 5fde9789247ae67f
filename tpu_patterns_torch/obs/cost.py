"""obs/cost.py — per-request device-time and KV block-second
attribution, with identities that close EXACTLY.

The port's copy of ``tpu_patterns/obs/cost.py``, on the port's clock
and fault sites; the ``obs cost`` table is the port's own fixed-width
rendering (``obs/table.py``) of the same rows.

Two resources dominate a serving fleet's bill: device time (the
compiled prefill/decode calls) and KV pool residency (block-seconds).
This module attributes both to the requests that consumed them, and —
in the house style where every accounting is an identity gate
(done+failed+shed == scheduled, leaked_blocks == 0) — every total
closes exactly, by construction, in integer nanoseconds:

  device time   each decode wave's measured wall (the same clock_ns
                delta ``tpu_patterns_serve_decode_wall_ms`` observes)
                is split equal-share across the wave's active rows:
                ``share = wall // n`` with the remainder distributed
                one ns each to the first ``wall % n`` rows, so
                Σ attributed == Σ measured regardless of wave count or
                summation order.  Prefill walls split the same way
                across the wave's bucket occupants.

  block-seconds the pool integral is a step function of the allocated
                count sampled on ``clock_ns`` at every scheduler
                iteration: each tick books ``alloc·dt`` busy and
                ``(pool-alloc)·dt`` free, so busy + free ==
                pool × elapsed always — the conservation gate.
                Per-request residency integrates each row's table size
                over its admitted lifetime (block-REFERENCE-seconds: a
                CoW-shared block books to every holder, and retained
                cache blocks book to nobody, so the per-request sum is
                reported against the pool integral as a signed
                ``residual_block_ns``, not forced to match it).

Booking is FAIL-OPEN behind the ``obs.cost_book`` fault site: an
injected (or real) booking error skips that booking whole — totals and
attributions move together, so the internal identities still hold —
and never propagates into the scheduler.  Cost accounting must not be
able to take down the engine it bills.

Rollups (request → priority class → scenario → replica) serve the
``obs cost <dir>`` table, the ``/costz`` live endpoint (obs/live.py)
and the per-run ``cost.jsonl`` dump next to ``metrics.jsonl``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os

from tpu_patterns_torch import faults
from tpu_patterns_torch.core.timing import clock_ns


@dataclasses.dataclass
class _ReqCost:
    rid: int
    scenario: str = ""
    priority: str = ""
    decode_ns: int = 0
    prefill_ns: int = 0
    block_ns: int = 0
    decode_steps: int = 0
    prefill_waves: int = 0


class CostBook:
    """One engine run's attribution ledger.  ``start()`` opens the
    accounting window (the run loop), ``tick()`` advances the pool
    integral, ``book_decode``/``book_prefill`` apportion measured
    walls, ``hold``/``drop`` bound each request's residency."""

    def __init__(self, pool_blocks: int, replica: str = ""):
        self.pool_blocks = max(int(pool_blocks), 0)
        self.replica = replica
        self.started = False
        self.t0_ns = 0
        self._last_ns = 0
        self._last_alloc = 0
        # pool integral (integer block·ns) — busy + free == pool ×
        # (last_tick - t0) at every instant, by construction
        self.busy_block_ns = 0
        self.free_block_ns = 0
        # measured totals and their attribution residue (a wave with no
        # rows can't happen in the engine, but the identity must not
        # depend on that)
        self.decode_wall_ns = 0
        self.prefill_wall_ns = 0
        self.unattributed_decode_ns = 0
        self.unattributed_prefill_ns = 0
        self.requests: dict[int, _ReqCost] = {}
        # rid -> (blocks held, last settle ns)
        self._holding: dict[int, tuple[int, int]] = {}
        # rid -> block_ns already exported to the metric counter (a
        # preempted leg drops, resumes and drops again: the counter
        # gets the DELTA each time, never the first leg twice)
        self._block_exported: dict[int, int] = {}

    # -- lifecycle -------------------------------------------------------

    def start(self, allocated: int = 0) -> None:
        """Open the accounting window (idempotent — a resumed run
        keeps its original t0 so elapsed covers the whole serve)."""
        if self.started:
            return
        self.started = True
        now = clock_ns()
        self.t0_ns = self._last_ns = now
        self._last_alloc = int(allocated)

    def tick(self, allocated: int) -> None:
        """Advance the pool step-function integral to now.  Called once
        per scheduler iteration (next to the occupancy gauge) — between
        ticks the allocated count was exactly ``_last_alloc``, because
        allocation only changes inside the iteration that ticks."""
        if not self.started:
            return
        now = clock_ns()
        dt = now - self._last_ns
        self.busy_block_ns += self._last_alloc * dt
        self.free_block_ns += (self.pool_blocks - self._last_alloc) * dt
        self._last_ns = now
        self._last_alloc = int(allocated)

    def close(self, allocated: int) -> None:
        """Final tick + settle every still-held residency (breaker
        stop, preemption: rows can outlive the loop)."""
        self.tick(allocated)
        for rid in list(self._holding):
            self._settle(rid, self._last_ns)

    # -- device-time attribution -----------------------------------------

    def _req(self, rid: int, scenario: str, priority: str) -> _ReqCost:
        r = self.requests.get(rid)
        if r is None:
            r = self.requests[rid] = _ReqCost(
                rid=rid, scenario=scenario, priority=priority
            )
        return r

    def _book_wall(
        self, kind: str, wall_ns: int,
        rows: list[tuple[int, str, str]],
    ) -> None:
        from tpu_patterns_torch import obs

        try:
            # fail OPEN: skip the WHOLE booking (total and shares move
            # together — internal identity intact) and never raise into
            # the scheduler
            faults.inject(
                "obs.cost_book", rows=len(rows), replica=self.replica
            )
        except faults.InjectedFault:
            return
        wall_ns = max(int(wall_ns), 0)
        if kind == "decode":
            self.decode_wall_ns += wall_ns
        else:
            self.prefill_wall_ns += wall_ns
        n = len(rows)
        if n == 0:
            if kind == "decode":
                self.unattributed_decode_ns += wall_ns
            else:
                self.unattributed_prefill_ns += wall_ns
            return
        share, rem = divmod(wall_ns, n)
        for i, (rid, scenario, priority) in enumerate(rows):
            got = share + (1 if i < rem else 0)
            r = self._req(rid, scenario, priority)
            if kind == "decode":
                r.decode_ns += got
                r.decode_steps += 1
            else:
                r.prefill_ns += got
                r.prefill_waves += 1
            obs.counter(
                f"tpu_patterns_cost_{kind}_ns_total",
                priority=priority or "interactive",
            ).inc(got)

    def book_decode(
        self, wall_ns: int, rows: list[tuple[int, str, str]]
    ) -> None:
        """Apportion one decode wave's measured wall across its active
        rows ((rid, scenario, priority) tuples, captured BEFORE the
        dispatch — a quarantined wave empties ``active`` but its rows
        still consumed the device)."""
        self._book_wall("decode", wall_ns, rows)

    def book_prefill(
        self, wall_ns: int, rows: list[tuple[int, str, str]]
    ) -> None:
        self._book_wall("prefill", wall_ns, rows)

    # -- per-request residency -------------------------------------------

    def _settle(self, rid: int, now: int) -> None:
        n, last = self._holding[rid]
        if now > last:
            self.requests[rid].block_ns += n * (now - last)
            self._holding[rid] = (n, now)

    def hold(
        self, rid: int, blocks: int, scenario: str, priority: str
    ) -> None:
        """Request ``rid`` now references ``blocks`` pool blocks (its
        table size at admission — re-admission of a preempted leg
        settles the gap and continues on the same row)."""
        try:
            faults.inject(
                "obs.cost_book", rid=int(rid), replica=self.replica
            )
        except faults.InjectedFault:
            return
        now = clock_ns()
        self._req(rid, scenario, priority)
        if rid in self._holding:
            self._settle(rid, now)
        self._holding[rid] = (int(blocks), now)

    def drop(self, rid: int) -> None:
        """Request ``rid`` released its table (retire / quarantine /
        preempt-park)."""
        if rid not in self._holding:
            return  # hold was skipped (fault) or never admitted
        from tpu_patterns_torch import obs

        self._settle(rid, clock_ns())
        self._holding.pop(rid)
        r = self.requests[rid]
        delta = r.block_ns - self._block_exported.get(rid, 0)
        self._block_exported[rid] = r.block_ns
        obs.counter(
            "tpu_patterns_cost_block_ns_total",
            priority=r.priority or "interactive",
        ).inc(delta)

    # -- identities & rollups --------------------------------------------

    def snapshot(self) -> dict:
        """The book as one dict: totals, the three identity verdicts,
        class/scenario rollups and per-request rows — the /costz body
        and the ``cost.jsonl`` meta line."""
        # extend the pool integral to now without changing the
        # allocated count (conservation holds across the extension)
        if self.started:
            self.tick(self._last_alloc)
            for rid in list(self._holding):
                self._settle(rid, self._last_ns)
        elapsed = self._last_ns - self.t0_ns
        att_dec = sum(r.decode_ns for r in self.requests.values())
        att_pre = sum(r.prefill_ns for r in self.requests.values())
        att_blk = sum(r.block_ns for r in self.requests.values())
        snap = {
            "replica": self.replica,
            "pool_blocks": self.pool_blocks,
            "elapsed_ns": elapsed,
            "decode_wall_ns": self.decode_wall_ns,
            "prefill_wall_ns": self.prefill_wall_ns,
            "attributed_decode_ns": att_dec,
            "attributed_prefill_ns": att_pre,
            "unattributed_decode_ns": self.unattributed_decode_ns,
            "unattributed_prefill_ns": self.unattributed_prefill_ns,
            "busy_block_ns": self.busy_block_ns,
            "free_block_ns": self.free_block_ns,
            "attributed_block_ns": att_blk,
            # signed by design: CoW sharing double-books (negative),
            # the retained cache books to nobody (positive)
            "residual_block_ns": self.busy_block_ns - att_blk,
            "decode_identity_ok": (
                att_dec + self.unattributed_decode_ns
                == self.decode_wall_ns
            ),
            "prefill_identity_ok": (
                att_pre + self.unattributed_prefill_ns
                == self.prefill_wall_ns
            ),
            "conservation_ok": (
                self.busy_block_ns + self.free_block_ns
                == self.pool_blocks * elapsed
            ),
            "requests": [
                dataclasses.asdict(r)
                for r in sorted(
                    self.requests.values(),
                    key=lambda r: -(r.decode_ns + r.prefill_ns),
                )
            ],
        }
        snap["by_priority"] = rollup(snap["requests"], "priority")
        snap["by_scenario"] = rollup(snap["requests"], "scenario")
        return snap

    def to_jsonl(self) -> str:
        """One ``meta`` line (totals + identities, requests elided) then
        one line per request — the shape ``load_dir`` merges."""
        snap = self.snapshot()
        reqs = snap.pop("requests")
        snap.pop("by_priority")
        snap.pop("by_scenario")
        lines = [json.dumps({"kind": "cost_meta", **snap})]
        for r in reqs:
            lines.append(json.dumps({
                "kind": "cost_req", "replica": self.replica, **r
            }))
        return "\n".join(lines) + "\n"


def rollup(request_rows: list[dict], key: str) -> dict[str, dict]:
    """Aggregate per-request rows by one key (priority | scenario |
    replica): request count and the three resource sums."""
    out: dict[str, dict] = {}
    for r in request_rows:
        k = str(r.get(key) or "") or "-"
        g = out.setdefault(k, {
            "requests": 0, "decode_ns": 0, "prefill_ns": 0,
            "block_ns": 0,
        })
        g["requests"] += 1
        g["decode_ns"] += r["decode_ns"]
        g["prefill_ns"] += r["prefill_ns"]
        g["block_ns"] += r["block_ns"]
    return out


# -- per-process registry & persistence ------------------------------------

_BOOKS: list[CostBook] = []


def register(book: CostBook) -> CostBook:
    _BOOKS.append(book)
    return book


def books() -> list[CostBook]:
    return list(_BOOKS)


def dump_all(path: str) -> str:
    """Write every registered book's JSONL to ``path`` (the
    ``obs.dump_cost`` backend — rides the same dump sites as
    ``metrics.jsonl`` so replica children leave their cost next to
    their metrics)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        for b in _BOOKS:
            f.write(b.to_jsonl())
    return path


def load_dir(obs_dir: str) -> tuple[list[dict], list[dict]]:
    """Read ``cost.jsonl`` from ``obs_dir`` and every ``replica-*/``
    under it; returns (meta lines, request lines) with replica dirs
    tagged — the ``obs cost`` merge."""
    paths = sorted(glob.glob(os.path.join(obs_dir, "cost.jsonl")))
    for d in sorted(glob.glob(os.path.join(obs_dir, "replica-*"))):
        paths.extend(
            sorted(glob.glob(os.path.join(d, "cost.jsonl")))
        )
    metas, reqs = [], []
    for p in paths:
        label = ""
        parent = os.path.basename(os.path.dirname(p))
        if parent.startswith("replica-"):
            label = parent[len("replica-"):]
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                e = json.loads(line)
                if label and not e.get("replica"):
                    e["replica"] = label
                if e.get("kind") == "cost_meta":
                    metas.append(e)
                elif e.get("kind") == "cost_req":
                    reqs.append(e)
    return metas, reqs


def _ms(ns: float) -> str:
    return f"{ns / 1e6:.2f}"


def _blk_s(ns: float) -> str:
    return f"{ns / 1e9:.3f}"


def cost_table(
    metas: list[dict], reqs: list[dict], top: int = 8
) -> str:
    """The ``obs cost`` rendering: identity verdicts, then the
    priority/scenario/replica rollups, then the top requests by
    attributed device time."""
    from tpu_patterns_torch.obs.table import markdown_table

    if not metas:
        return "no cost.jsonl in the obs dir — run with --obs-dump"
    lines = []
    for m in metas:
        who = f"replica {m['replica']}" if m.get("replica") else "engine"
        ok = (
            m["decode_identity_ok"] and m["prefill_identity_ok"]
            and m["conservation_ok"]
        )
        lines.append(
            f"{who}: identities {'OK' if ok else 'BROKEN'} "
            f"(decode {_ms(m['decode_wall_ns'])} ms attributed exactly, "
            f"pool {m['pool_blocks']} blocks x "
            f"{m['elapsed_ns'] / 1e9:.3f} s closes, "
            f"busy {_blk_s(m['busy_block_ns'])} block-s)"
        )
    sections = []
    for key in ("priority", "scenario", "replica"):
        groups = rollup(reqs, key)
        rows = [
            [k, g["requests"], _ms(g["decode_ns"]),
             _ms(g["prefill_ns"]), _blk_s(g["block_ns"])]
            for k, g in sorted(
                groups.items(), key=lambda kv: -kv[1]["decode_ns"]
            )
        ]
        sections.append(f"by {key}\n\n" + markdown_table(
            rows,
            headers=[key, "reqs", "decode ms", "prefill ms", "block-s"],
        ))
    top_rows = sorted(
        reqs, key=lambda r: -(r["decode_ns"] + r["prefill_ns"])
    )[:top]
    sections.append("top requests by device time\n\n" + markdown_table(
        [
            [r["rid"], r.get("replica") or "-", r.get("priority") or "-",
             r.get("scenario") or "-", _ms(r["decode_ns"]),
             _ms(r["prefill_ns"]), _blk_s(r["block_ns"]),
             r["decode_steps"]]
            for r in top_rows
        ],
        headers=["rid", "replica", "class", "scenario", "decode ms",
                 "prefill ms", "block-s", "steps"],
    ))
    return "\n".join(lines) + "\n\n" + "\n\n".join(sections)
