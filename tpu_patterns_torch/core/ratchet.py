"""The ratchet-baseline core, copied from ``tpu_patterns/core/ratchet.py``.

A *ratchet baseline* is a committed JSON file pinning the accepted
current state of some fingerprinted debt (here the performance metrics
of ``perf/baseline.json``).  A gate fails only on entries NOT in the
baseline (the ratchet: things can only get cleaner/faster),
``update-baseline`` re-pins, and hand-written per-entry
``justification`` strings survive every re-pin because they are triage
notes, not tool output.  This module holds the file format, the version
gate, the justification survival and the NEW-vs-baselined-vs-stale
split; what a *fingerprint* hashes and what makes an entry a
*violation* stay with the consumer (``perf/baseline.py``).

File shape (one per consumer, committed)::

    {"version": N, "entries": [{"fingerprint": "...",
                                "justification": "...", ...}, ...]}

Entries are plain dicts; the only keys this module interprets are
``fingerprint`` (the identity) and ``justification`` (the survivor).
"""

from __future__ import annotations

import json
import os
from typing import Iterable


def load_entries(path: str, *, version: int) -> dict[str, dict]:
    """Baseline entries keyed by fingerprint ({} when the file is absent).

    A version mismatch raises — a silently-misread baseline would either
    fail CI on long-accepted debt or pass new debt as baselined.
    """
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    if data.get("version") != version:
        raise ValueError(
            f"{path}: baseline version {data.get('version')!r} != "
            f"{version} — regenerate with --update-baseline"
        )
    return {e["fingerprint"]: e for e in data.get("entries", [])}


def preserve_justifications(
    entries: Iterable[dict], old: dict[str, dict]
) -> list[dict]:
    """Carry per-entry ``justification`` strings across a re-pin (matched
    by fingerprint).  An entry that already spells its own justification
    keeps it; one without inherits the old entry's (or "")."""
    out = []
    for e in entries:
        e = dict(e)
        if not e.get("justification"):
            e["justification"] = old.get(e["fingerprint"], {}).get(
                "justification", ""
            )
        out.append(e)
    return out


def save_entries(
    path: str, entries: list[dict], *, version: int
) -> int:
    """Write the baseline file (caller orders + shapes the entries;
    justification survival via :func:`preserve_justifications`).
    Returns the entry count."""
    with open(path, "w") as f:
        json.dump(
            {"version": version, "entries": entries},
            f,
            indent=1,
            sort_keys=True,
        )
        f.write("\n")
    return len(entries)


def prune_stale(
    path: str,
    seen: Iterable[str],
    *,
    version: int,
    stale_filter=None,
) -> tuple[int, list[dict]]:
    """Drop stale entries (fingerprints ``seen`` no longer produces) from
    the committed baseline WITHOUT re-pinning the survivors.

    The gap this closes: ``--update-baseline`` re-pins everything — it
    drops stale debt but also accepts whatever is NEW right now, and (for
    value-carrying baselines like perf) overwrites every pinned value.
    Pruning is the surgical half: fixed debt leaves the ledger, surviving
    entries keep their values AND justifications byte-for-byte, and new
    findings keep gating.  ``stale_filter`` restricts which entries a
    partial run may declare fixed (same contract as ``split_entries``).

    Returns ``(surviving_count, dropped_entries)``.  A missing baseline
    file prunes nothing.
    """
    baseline = load_entries(path, version=version)
    if not baseline:
        return 0, []
    _new, _pinned, stale = split_entries(
        seen, baseline, stale_filter=stale_filter
    )
    if not stale:
        return len(baseline), []
    dropped_fps = {e["fingerprint"] for e in stale}
    # dict preserves the file's entry order: survivors keep their slot so
    # a prune diffs as pure deletions
    survivors = [
        e for fp, e in baseline.items() if fp not in dropped_fps
    ]
    save_entries(path, survivors, version=version)
    return len(survivors), stale


def split_entries(
    seen: Iterable[str],
    baseline: dict[str, dict],
    *,
    stale_filter=None,
) -> tuple[set[str], set[str], list[dict]]:
    """The ratchet split: (new, baselined, stale).

    ``seen`` are the fingerprints the current run produced.  ``new`` are
    seen-but-unpinned (the gate), ``baselined`` are seen-and-pinned
    (visible, not fatal), ``stale`` are baseline entries nothing matched
    (fixed debt, reported and dropped at the next re-pin).
    ``stale_filter(entry) -> bool`` restricts which baseline entries may
    be declared stale — a partial run must not report unexercised
    entries' debt as fixed.
    """
    seen = set(seen)
    new = seen - set(baseline)
    pinned = seen & set(baseline)
    stale = [
        e
        for fp, e in sorted(baseline.items())
        if fp not in seen and (stale_filter is None or stale_filter(e))
    ]
    return new, pinned, stale
