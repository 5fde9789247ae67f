"""The perf ratchet: a committed baseline with noise-aware bands.

Counterpart of ``tpu_patterns/perf/baseline.py``, the same code: one
committed file of fingerprinted entries (``perf/baseline.json`` of this
package), ``perf diff`` fails only on NEW regressions, and
``update-baseline`` re-pins, keeping hand-written per-entry
justifications (``core/ratchet.py``).  What is perf-specific:

* an entry pins a VALUE per (executable, metric), and a *regression* is
  the current value leaving the entry's tolerance band;
* metrics carry a **class** that sets the band and where it applies:

  ===========  ========================================  ==============
  class        metrics                                   gating
  ===========  ========================================  ==============
  analytic     analytic_flops, analytic_hbm_bytes,       everywhere,
               the kv tier's exact byte and count books  ±0.1%
  compiled     xla_flops, xla_bytes_accessed,            ±5%, within a
               argument/output/temp/alias_bytes          matching mesh
                                                         fingerprint
  measured     step_ms                                   +200% (worse
                                                         only), mesh-fp
                                                         matched;
                                                         ``perf diff
                                                         --measured_tol``
                                                         overrides it
  compile      compile_s, cached_compile_s, cache_hit    never
  derived      achieved_*, intensity, mfu                never
  ===========  ========================================  ==============

  The ``compiled`` and ``compile`` classes are the compiler's own
  figures in the JAX package (XLA's ``cost_analysis`` and
  ``memory_analysis``).  Eager torch has no such figures, so this
  package's captures carry none of those metrics and never fill them
  with stand-ins; the classes stay so that the two packages' baselines
  read alike.

* both directions gate for ``analytic``: an analytic FLOP count
  silently *dropping* usually means work went missing from the measured
  program.

A fingerprint is ``sha1(executable|metric|capture-shape)`` where the
capture shape folds in every PerfConfig field that changes what is
measured (model dims, trace shape, seed, device — NOT the measurement
policy ``k``/``inner``/``include``) plus the mesh shape.  A changed
capture shape reads as unbaselined+stale (re-pin deliberately), never as
a false regression against numbers measured under another shape.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

from tpu_patterns_torch.core import ratchet

BASELINE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class MetricClass:
    name: str
    rel_tol: float | None  # None = never gates (informational)
    both_directions: bool = False  # False = only larger-is-worse gates
    machine_bound: bool = True  # gate only within a matching mesh_fp


CLASSES = {
    "analytic": MetricClass(
        "analytic", rel_tol=0.001, both_directions=True,
        machine_bound=False,
    ),
    "compiled": MetricClass(
        "compiled", rel_tol=0.05, both_directions=True,
    ),
    "measured": MetricClass("measured", rel_tol=2.0),
    "compile": MetricClass("compile", rel_tol=None),
    "derived": MetricClass("derived", rel_tol=None),
}

METRIC_CLASS = {
    "analytic_flops": "analytic",
    "analytic_hbm_bytes": "analytic",
    "xla_flops": "compiled",
    "xla_bytes_accessed": "compiled",
    "argument_bytes": "compiled",
    "output_bytes": "compiled",
    "temp_bytes": "compiled",
    "alias_bytes": "compiled",
    "step_ms": "measured",
    # KV-tier offload accounting (perf/registry.py _capture_kv_tier):
    # exact host-side byte/count bookkeeping at a fixed deterministic
    # trace — analytic-banded so a thrashing regression (evict traffic
    # exploding at the same trace) gates everywhere, both directions
    "kv_evict_bytes": "analytic",
    "kv_onload_bytes": "analytic",
    "kv_evictions": "analytic",
    "kv_onload_hits": "analytic",
    # fleet prefix-store round-trip (perf/registry.py
    # _capture_prefix_store): publish/fetch traffic at the fixed
    # deterministic trace — analytic-banded so a thundering-herd
    # regression (every replica republishing or refetching the same
    # blocks) fails perf diff like a FLOP-count drift would
    "store_publish_bytes": "analytic",
    "store_fetch_bytes": "analytic",
    "store_hits": "analytic",
    # disagg KV-block wire (perf/registry.py _capture_disagg_stream):
    # the shipped-payload byte floor is closed-form from the block
    # shape (analytic: ratcheted everywhere), the wire wall clock is
    # machine-bound like every other timed core
    "transfer_bytes": "analytic",
    "transfer_ms": "measured",
    "compile_s": "compile",
    "cached_compile_s": "compile",
    "cache_hit": "compile",
    "achieved_gflops": "derived",
    "achieved_gbps": "derived",
    "intensity_flops_per_byte": "derived",
    "mfu": "derived",
}


def metric_class(metric: str) -> MetricClass:
    return CLASSES[METRIC_CLASS.get(metric, "derived")]


# PerfConfig fields that tune HOW we measure, not WHAT — excluded from
# the identity so raising k for a quieter median never churns the
# baseline
_POLICY_FIELDS = ("k", "inner", "include")


def config_fingerprint(snapshot: dict) -> str:
    """Identity of the capture shape: config minus measurement policy,
    plus the mesh shape the executables compiled for."""
    shape = {
        k: v
        for k, v in sorted(snapshot.get("config", {}).items())
        if k not in _POLICY_FIELDS
    }
    shape["_mesh"] = sorted(
        snapshot.get("mesh", {}).get("shape", {}).items()
    )
    return hashlib.sha1(
        json.dumps(shape, sort_keys=True).encode()
    ).hexdigest()[:12]


def fingerprint(executable: str, metric: str, cfg_fp: str) -> str:
    return hashlib.sha1(
        f"{executable}|{metric}|{cfg_fp}".encode()
    ).hexdigest()[:16]


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: str | None = None) -> dict[str, dict]:
    return ratchet.load_entries(
        path or default_baseline_path(), version=BASELINE_VERSION
    )


def save_baseline(
    path: str | None, snapshot: dict, old: dict[str, dict]
) -> int:
    """Re-pin to the snapshot's gateable metrics.  Informational classes
    (compile/derived) are pinned too — they document the trajectory —
    but carry their class so diff never gates them.  Justifications
    survive by fingerprint (core/ratchet.py)."""
    mesh_fp = snapshot.get("run", {}).get("mesh_fp", "")
    cfg_fp = config_fingerprint(snapshot)
    entries = []
    for name in sorted(snapshot.get("executables", {})):
        metrics = snapshot["executables"][name]
        for metric in sorted(metrics):
            cls = metric_class(metric)
            entries.append({
                "fingerprint": fingerprint(name, metric, cfg_fp),
                "executable": name,
                "metric": metric,
                "class": cls.name,
                "config": cfg_fp,
                "value": float(metrics[metric]),
                "machine": mesh_fp if cls.machine_bound else "",
                "justification": "",
            })
    return ratchet.save_entries(
        path or default_baseline_path(),
        ratchet.preserve_justifications(entries, old),
        version=BASELINE_VERSION,
    )


@dataclasses.dataclass
class PerfFinding:
    """One band violation (or near-miss note) from a diff."""

    executable: str
    metric: str
    cls: str
    baseline_value: float
    current_value: float
    rel_delta: float  # (cur - base) / |base|

    def message(self) -> str:
        return (
            f"{self.executable}.{self.metric} [{self.cls}]: "
            f"{self.baseline_value:.6g} -> {self.current_value:.6g} "
            f"({self.rel_delta:+.1%})"
        )


@dataclasses.dataclass
class PerfDiff:
    regressions: list[PerfFinding]  # outside the band -> the gate
    improvements: list[PerfFinding]  # outside the band the GOOD way
    unbaselined: list[str]  # "<executable>.<metric>" never pinned
    skipped: list[str]  # machine-bound entries on a foreign mesh_fp
    stale: list[dict]  # pinned entries the snapshot no longer produces
    checked: int

    @property
    def exit_code(self) -> int:
        return 1 if self.regressions else 0


def diff_snapshot(
    snapshot: dict,
    baseline: dict[str, dict],
    tolerances: dict[str, float] | None = None,
) -> PerfDiff:
    """Compare a capture against the committed baseline.

    The ratchet contract: only band-leaving *regressions* fail.  A
    metric the baseline never pinned is reported (someone added an
    executable — pin it deliberately), a machine-bound entry from a
    different mesh fingerprint is skipped visibly, a pinned entry the
    capture no longer produces is stale (renamed/removed executable —
    re-pin to drop it).  ``tolerances`` overrides the class bands by
    class name (e.g. ``{"measured": 0.5}`` on a quiet dedicated box).
    """
    tolerances = tolerances or {}
    mesh_fp = snapshot.get("run", {}).get("mesh_fp", "")
    cfg_fp = config_fingerprint(snapshot)
    regressions: list[PerfFinding] = []
    improvements: list[PerfFinding] = []
    unbaselined: list[str] = []
    skipped: list[str] = []
    checked = 0
    seen: set[str] = set()
    for name in sorted(snapshot.get("executables", {})):
        metrics = snapshot["executables"][name]
        for metric in sorted(metrics):
            fp = fingerprint(name, metric, cfg_fp)
            seen.add(fp)
            cls = metric_class(metric)
            entry = baseline.get(fp)
            tol = tolerances.get(cls.name, cls.rel_tol)
            if entry is None:
                if tol is not None:
                    unbaselined.append(f"{name}.{metric}")
                continue
            if tol is None:
                continue
            if cls.machine_bound and entry.get("machine") != mesh_fp:
                skipped.append(f"{name}.{metric}")
                continue
            checked += 1
            base = float(entry["value"])
            cur = float(metrics[metric])
            denom = abs(base) if base != 0 else 1.0
            delta = (cur - base) / denom
            f = PerfFinding(
                executable=name, metric=metric, cls=cls.name,
                baseline_value=base, current_value=cur, rel_delta=delta,
            )
            if delta > tol:
                regressions.append(f)
            elif cls.both_directions and delta < -tol:
                regressions.append(f)
            elif not cls.both_directions and delta < -min(tol, 0.5):
                # informational: a relative delta is bounded below by
                # -100%, so a wide gate band (measured: 2.0) would make
                # improvements unreportable — cap the good-news
                # threshold at 50%
                improvements.append(f)
    # fingerprints can only be declared stale by a capture that RAN
    # their executable — an --include subset must not report the rest
    # of the registry as removed (same contract as a --rules lint run)
    ran = set(snapshot.get("executables", {}))
    _new, _pinned, stale = ratchet.split_entries(
        seen, baseline,
        stale_filter=lambda e: e.get("executable") in ran,
    )
    regressions.sort(key=lambda f: -abs(f.rel_delta))
    return PerfDiff(
        regressions=regressions,
        improvements=improvements,
        unbaselined=unbaselined,
        skipped=skipped,
        stale=stale,
        checked=checked,
    )
