"""Render the perf report: roofline table + trajectory.

Counterpart of ``tpu_patterns/perf/report.py``, the same tables.  Two
sections:

* **Executables** — one row per registry entry from the fresh snapshot:
  analytic GFLOPs, measured step time, achieved GFLOP/s and GB/s
  against the analytic traffic floor, arithmetic intensity, MFU where
  the card's datasheet peak is known (a CPU run prints "—" there rather
  than a number against no peak), compile time and cache evidence (eager
  torch has neither: "—").  On the card the header names the card and
  its power limit as ``nvidia-smi`` prints them.
* **Trajectory** — the longitudinal view from ``perf/history.py``:
  per-executable step_ms across banked snapshots (joinable by run_id/git
  SHA) and this package's Records under ``results/``.
"""

from __future__ import annotations


def _fmt(v: float | None, spec: str = ".3g") -> str:
    if v is None:
        return "—"
    return format(v, spec)


def render_snapshot(snapshot: dict) -> str:
    run = snapshot.get("run", {})
    mesh = snapshot.get("mesh", {})
    lines = [
        "## perfwatch snapshot",
        "",
        f"- run {run.get('run_id', '?')} @ {run.get('git_sha', '?')} "
        f"(mesh_fp {run.get('mesh_fp', '?')})",
        f"- mesh {mesh.get('shape', {})} on "
        f"{mesh.get('devices', '?')}x {mesh.get('platform', '?')}",
        *([f"- card {mesh['card']}"] if mesh.get("card") else []),
        "",
        "| executable | GFLOP | step ms | GFLOP/s | GB/s(floor) | "
        "flops/byte | mfu | compile s | cache |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for name in sorted(snapshot.get("executables", {})):
        m = snapshot["executables"][name]
        flops = m.get("analytic_flops")
        cache = m.get("cache_hit")
        lines.append(
            "| {} | {} | {} | {} | {} | {} | {} | {} | {} |".format(
                name,
                _fmt(flops / 1e9 if flops else None),
                _fmt(m.get("step_ms"), ".4g"),
                _fmt(m.get("achieved_gflops")),
                _fmt(m.get("achieved_gbps")),
                _fmt(m.get("intensity_flops_per_byte")),
                _fmt(m.get("mfu"), ".2%") if "mfu" in m else "—",
                _fmt(m.get("compile_s")),
                "hit" if cache == 1.0 else
                ("miss" if cache == 0.0 else "—"),
            )
        )
    lines.append("")
    return "\n".join(lines)


def render_trajectory(timeline: dict) -> str:
    lines = ["## perf trajectory", ""]

    snaps = timeline.get("snapshots", [])
    if snaps:
        lines.append(f"### snapshots ({len(snaps)} banked runs)")
        lines.append("")
        names = sorted({
            n for s in snaps for n in s.get("executables", {})
        })
        lines.append("| executable | step_ms over runs (old -> new) |")
        lines.append("|---|---|")
        for n in names:
            series = []
            for s in snaps:
                v = s.get("executables", {}).get(n, {}).get("step_ms")
                series.append("·" if v is None else f"{v:.3g}")
            lines.append(f"| {n} | {' '.join(series)} |")
        runs = [
            f"{s.get('run', {}).get('run_id', '?')}"
            f"@{s.get('run', {}).get('git_sha', '?')}"
            for s in snaps
        ]
        lines.append("")
        lines.append(f"runs: {', '.join(runs)}")
        lines.append("")

    records = timeline.get("records", [])
    if records:
        stamped = sum(1 for r in records if r.get("run"))
        run_ids = {
            r["run"].get("run_id") for r in records if r.get("run")
        }
        by_pattern: dict[str, int] = {}
        for r in records:
            by_pattern[r["pattern"]] = by_pattern.get(r["pattern"], 0) + 1
        lines.append(
            f"### results/ records: {len(records)} total, {stamped} "
            f"run-stamped across {len(run_ids)} distinct runs"
        )
        lines.append("")
        for pat in sorted(by_pattern):
            lines.append(f"- {pat}: {by_pattern[pat]}")
        lines.append("")

    if len(lines) == 2:
        lines.append(
            "(no history yet — run `python -m tpu_patterns_torch perf "
            "report`)"
        )
        lines.append("")
    return "\n".join(lines)


def render(snapshot: dict, timeline: dict) -> str:
    return render_snapshot(snapshot) + "\n" + render_trajectory(timeline)
