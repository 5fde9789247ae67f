"""Read the device traces the suite records: torch.profiler's Kineto
trace in place of the JAX package's xplane.

Counterpart of ``tpu_patterns/core/profile.py``, which parses the
``*.xplane.pb`` files ``jax.profiler.trace`` writes.  Here the trace is
the Chrome-trace JSON Kineto writes (``prof.export_chrome_trace``,
``*.pt.trace.json``), or the in-memory Kineto results of a
``torch.profiler.profile`` that was not exported.  Both readers give the
reference's shape: planes of lines of timed events, a plane one CUDA
device and a line one stream.  The device events are Kineto's
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` activities; their times
(microseconds with fractional nanoseconds in the JSON, nanoseconds in
memory) are held as integer picoseconds, as ``XEvent.duration_ps``
holds them.

:func:`classify` books each event into

    compute | collective | dma | infeed_outfeed | other

by the reference's XLA rules, with the CUDA vocabulary checked first
(:data:`_CUDA_RULES`), and :func:`breakdown_planes` turns planes into
the reference's Record metrics.  One departure: on a GPU each stream is
its own line and events on different streams overlap, so a plane's busy
time is the **union** of its intervals over every stream, not the sum
of its events (which would exceed the wall and clamp idle to a wrong
0).  Category times still sum over events, so ``<cat>_frac`` keeps the
reference's denominator.  On a plane of one stream with no overlap the
two agree, and so do the results.
"""

from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
import re

# Kineto's activity types (the JSON's ``cat``) that ran on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class XEvent:
    name: str
    offset_ps: int
    duration_ps: int


@dataclasses.dataclass
class XLine:
    name: str
    events: list
    timestamp_ns: int = 0  # event offsets are relative to this


@dataclasses.dataclass
class XPlane:
    name: str
    lines: list


def _planes(events) -> list[XPlane]:
    """Group ``(device, stream, name, start_ps, dur_ps)`` into planes
    (one a device, ``/device:cuda:<i>``) of lines (one a stream), each
    line's events in start order."""
    by_dev: dict[int, dict[int, list[XEvent]]] = {}
    for dev, stream, name, start_ps, dur_ps in events:
        by_dev.setdefault(dev, {}).setdefault(stream, []).append(
            XEvent(name, start_ps, dur_ps)
        )
    planes = []
    for dev in sorted(by_dev):
        lines = []
        for stream in sorted(by_dev[dev]):
            evs = sorted(by_dev[dev][stream], key=lambda e: e.offset_ps)
            lines.append(XLine(f"stream {stream}", evs))
        planes.append(XPlane(f"/device:cuda:{dev}", lines))
    return planes


def _us_to_ps(us) -> int:
    # Kineto prints microseconds with three decimals: whole nanoseconds
    return int(round(float(us) * 1000.0)) * 1000


def parse_trace(path: str) -> list[XPlane]:
    """Parse one Kineto Chrome-trace file (``.json`` or ``.json.gz``)
    into device planes of stream lines.  Host events are dropped; a
    trace with no device event gives no plane."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    out = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if str(ev.get("cat", "")).lower() not in DEVICE_CATEGORIES:
            continue
        args = ev.get("args") or {}
        out.append((
            int(args.get("device", ev.get("pid", 0))),
            int(args.get("stream", ev.get("tid", 0))),
            str(ev.get("name", "")),
            _us_to_ps(ev.get("ts", 0)),
            _us_to_ps(ev.get("dur", 0)),
        ))
    return _planes(out)


def _is_device_event(e) -> bool:
    """Whether an in-memory Kineto event is a kernel, copy or memset: a
    CUDA device event that is no user annotation (a record_function
    range drawn on the device's timeline)."""
    import torch

    annotation = getattr(e, "is_user_annotation", None)
    return (e.device_type() == torch.autograd.DeviceType.CUDA
            and e.duration_ns() > 0
            and not (annotation is not None and annotation()))


def planes_from_profile(prof) -> list[XPlane]:
    """The device planes of a finished ``torch.profiler.profile``, read
    from its in-memory Kineto results (no export needed)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if not _is_device_event(e):
            continue
        out.append((
            int(e.device_index()), int(e.device_resource_id()), e.name(),
            int(e.start_ns()) * 1000, int(e.duration_ns()) * 1000,
        ))
    return _planes(out)


# ---------------------------------------------------------------------------
# Classification: op and kernel names -> where the time went
# ---------------------------------------------------------------------------

# The CUDA vocabulary, checked before the reference's rules and matched
# as plain substrings of the lowercased name: kernel symbols glue their
# words together (``ampere_sgemm_128x64_nn``, ``nvjet_hsh_...``,
# ``vectorized_elementwise_kernel``), so the reference's rule of no
# letter on either side of a token would book every cuBLAS GEMM under
# ``other``.
_CUDA_RULES: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("collective", ("nccl", "memcpy ptop")),
    ("infeed_outfeed", ("memcpy htod", "memcpy dtoh", "memcpy htoh")),
    ("dma", ("memcpy dtod", "memset")),
    ("compute", (
        # the port's hand-written kernels (K1-K10), by their symbols
        "paged_attention", "flash_fwd", "flash_bwd", "accumulate_",
        "busy_wait", "dma_compute", "local_put", "ring_put", "add_one_",
        # cuBLAS / cuBLASLt / CUTLASS GEMMs and GEMVs
        "gemm", "gemv", "nvjet", "cutlass", "cublas", "xmma",
        # ATen's and CUB's device kernels (elementwise, reduce, index,
        # softmax, sort, scan, cat, copy kernels)
        "at::native", "at_cuda_detail", "cub::", "elementwise",
        "reduce_kernel", "softmax",
    )),
)

# The reference's token rules in priority order (first hit wins), for
# XLA's HLO names (``tpu_patterns/core/profile.py``), kept as they are:
# a name no CUDA rule takes is booked as the reference books it.
_RULES: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("collective", (
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute", "collective-broadcast", "send", "recv",
        "psum", "ppermute",
    )),
    ("infeed_outfeed", ("infeed", "outfeed", "host-transfer")),
    ("compute", ("fusion", "dynamic-update-slice", "transpose")),
    ("dma", ("copy", "dma", "memset")),
    ("compute", ("custom-call", "custom_call", "mosaic", "pallas")),
    ("compute", (
        "dot", "conv", "matmul", "fma", "loop", "scan", "while",
        "reduce", "select", "add", "multiply", "exp", "iota", "broadcast",
        "compare", "scatter", "gather", "rsqrt", "subtract", "divide",
    )),
)

_TOKEN_RE: dict[str, "re.Pattern[str]"] = {}


def _token_matches(token: str, low: str) -> bool:
    pat = _TOKEN_RE.get(token)
    if pat is None:
        pat = re.compile(
            "(?<![a-z])" + re.escape(token) + "(?![a-z])"
        )
        _TOKEN_RE[token] = pat
    return pat.search(low) is not None


def classify(name: str) -> str:
    low = name.lower()
    for category, keys in _CUDA_RULES:
        if any(k in low for k in keys):
            return category
    for category, keys in _RULES:
        if any(_token_matches(k, low) for k in keys):
            return category
    return "other"


_DEVICE_PLANE_MARKERS = ("/device:cuda",)
# lines that re-aggregate the same ops (steps, modules, scopes) — summing
# them alongside the op line would double-count (the reference's list)
_SKIP_LINES = ("step", "module", "scope", "framework", "source")


def device_planes(planes: list) -> list:
    return [
        p for p in planes
        if any(m in p.name.lower() for m in _DEVICE_PLANE_MARKERS)
    ]


def union_ps(intervals) -> int:
    """Length of the union of ``(start, end)`` intervals."""
    total, hi = 0, None
    for s, e in sorted(intervals):
        if hi is None or s > hi:
            total += e - s
            hi = e
        elif e > hi:
            total += e - hi
            hi = e
    return total


def breakdown_planes(planes: list) -> dict[str, float]:
    """Aggregate device-plane events into per-category busy ms + idle.

    Per plane (= per card): wall = the span from the earliest event
    start to the latest event end over its stream lines; busy = the
    union of its events' intervals over every stream; idle = wall -
    busy.  Across planes, category and busy times SUM (total card-time)
    and idle SUMS PER PLANE, as in the reference."""
    cats = {"compute": 0, "collective": 0, "dma": 0, "infeed_outfeed": 0,
            "other": 0}
    busy_ps = idle_ps = wall_ps = 0
    for plane in planes:
        spans = []
        for line in plane.lines:
            lname = line.name.lower()
            if any(s in lname for s in _SKIP_LINES):
                continue
            base = line.timestamp_ns * 1000  # offsets are line-relative
            for ev in line.events:
                cats[classify(ev.name)] += ev.duration_ps
                s = base + ev.offset_ps
                spans.append((s, s + ev.duration_ps))
        p_wall = (max(e for _, e in spans) - min(s for s, _ in spans)
                  if spans else 0)
        p_busy = union_ps(spans)
        busy_ps += p_busy
        idle_ps += max(0, p_wall - p_busy)
        wall_ps = max(wall_ps, p_wall)
    cat_ps = sum(cats.values())
    out = {f"{k}_ms": v / 1e9 for k, v in cats.items()}
    out["busy_ms"] = busy_ps / 1e9
    out["wall_ms"] = wall_ps / 1e9
    out["idle_ms"] = idle_ps / 1e9
    if cat_ps:
        for k, v in cats.items():
            out[f"{k}_frac"] = round(v / cat_ps, 4)
    return out


def breakdown_of(planes: list) -> dict[str, float] | None:
    """:func:`breakdown_planes` of the device planes among ``planes``
    with ``n_device_planes``, or None when no device event exists."""
    planes = device_planes(planes)
    if not any(ln.events for p in planes for ln in p.lines):
        return None
    out = breakdown_planes(planes)
    out["n_device_planes"] = float(len(planes))
    return out


def newest_trace(trace_dir: str) -> str | None:
    """The newest Kineto trace file under ``trace_dir``, or None."""
    files = [
        p
        for pat in ("*.json", "*.json.gz")
        for p in glob.glob(os.path.join(trace_dir, "**", pat),
                           recursive=True)
    ]
    return max(files, key=os.path.getmtime) if files else None


def breakdown(trace_dir: str) -> dict[str, float] | None:
    """Per-category time breakdown of the NEWEST trace under a trace
    directory, or None when no trace file or no device event exists
    (host-only traces explain nothing about the card and must not
    masquerade as a device breakdown)."""
    path = newest_trace(trace_dir)
    if path is None:
        return None
    return breakdown_of(parse_trace(path))


def op_name_snapshot(trace_dir: str) -> dict | None:
    """Unique device op names of the newest trace, with count, total
    duration, and the category :func:`classify` books them under.  None
    when the dir has no device event.  ``profilecheck`` gates on the
    share of busy time falling into ``other``, and the card's snapshots
    are committed as classifier fixtures."""
    path = newest_trace(trace_dir)
    if path is None:
        return None
    return op_names(parse_trace(path)) or None


def op_names(planes: list) -> dict[str, dict]:
    """Unique device op names of ``planes`` (count, total duration,
    category), stream lines of the skipped kinds left out."""
    names: dict[str, dict] = {}
    for plane in device_planes(planes):
        for line in plane.lines:
            if any(s in line.name.lower() for s in _SKIP_LINES):
                continue
            for ev in line.events:
                d = names.setdefault(
                    ev.name,
                    {"count": 0, "duration_ps": 0,
                     "category": classify(ev.name)},
                )
                d["count"] += 1
                d["duration_ps"] += ev.duration_ps
    return names


def crosscheck_rate(
    tflops_hw: float,
    bd: dict[str, float],
    peak_tflops: float | None,
    n_chips: int = 1,
) -> dict[str, float]:
    """Do the wall-clock FLOP accounting and the profile's measured
    compute time cohere?  The implied on-compute rate ``tflops_hw /
    compute_frac_of_wall`` must fit under the participating cards' peak
    (with 10% tolerance for trace skew); above it, either the FLOP
    count overcounts or the classifier books compute time elsewhere."""
    busy = bd.get("busy_ms", 0.0)
    wall = bd.get("wall_ms", 0.0)
    # compute share of WALL, not of busy: idle wall still elapsed, and
    # the rate under test divided by wall time
    compute_frac_of_wall = (
        min(1.0, bd.get("compute_ms", 0.0) / wall) if wall else 0.0
    )
    out = {
        "tflops_hw": tflops_hw,
        "compute_frac_of_wall": compute_frac_of_wall,
        "busy_ms": busy,
        "wall_ms": wall,
    }
    if compute_frac_of_wall > 0:
        implied = tflops_hw / compute_frac_of_wall
        out["implied_mxu_tflops"] = implied
        if peak_tflops is not None:
            bound = 1.1 * peak_tflops * n_chips
            out["peak_bound_tflops"] = bound
            out["coherent"] = float(implied <= bound)
    elif tflops_hw > 0:
        # a positive FLOP rate with ZERO classified compute time is the
        # maximal incoherence this check exists for
        out["coherent"] = 0.0
    return out
