"""Failure detection: deadline-bounded health probes of the runtime.

Counterpart of ``tpu_patterns/core/doctor.py``.  The suite's
measurements die in characteristic ways: a card that hangs inside the
CUDA context's creation (no Python timeout fires), one that passes a
tiny op and then stalls on real work, a missing toolchain that disables
the native modules.  Every probe runs in a child (``sys.executable -c``,
importing ``torch`` only) under a hard deadline, so the doctor itself
can never hang, and the report names the layer that broke — backend
init, tiny op, real compute, native build — instead of a generic
timeout.

``DoctorConfig.device`` (default ``cuda``) names the device the probes
run on.  A box with no card reports ``backend_init`` failed and a
FAILURE Record; the doctor never probes the CPU in its place.  The warm
workers the JAX package's ``--workers`` probes live in ``exec/``, which
is not ported: asking for them is refused.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

from tpu_patterns_torch.core.timing import wall_time_s

# The doctor's own durations: the package's clock is the native module's
# (core/timing.py), one of the layers probed here, so a broken toolchain
# must not take the doctor down with it
clock_ns = time.perf_counter_ns

WORKERS_NOT_PORTED = (
    "doctor --workers: the warm workers live in exec/, which is not "
    "ported yet (ROADMAP.md Queue 1 step 10)"
)


@dataclasses.dataclass
class DoctorConfig:
    """CLI ``doctor`` subcommand."""

    probe_timeout: int = 60  # per-probe deadline (s)
    # escalate to a real-workload probe (a matmul large enough to catch
    # the passes-preflight-then-hangs failure mode)
    deep: bool = True
    deep_timeout: int = 120
    # the JAX package's warm-worker probe: refused (not ported)
    workers: bool = False
    # watch mode: coalesce consecutive failing polls into ONE open/close
    # episode entry in this JSONL file instead of a line per poll
    watch_jsonl: str = ""
    # hang dumps younger than this count as live evidence in the
    # watchdog probe (healthy runtime + recent dump -> WARNING verdict)
    watchdog_window_s: float = 3600.0
    device: str = "cuda"  # "cpu" probes the CPU (the tests)


# Probe scripts run in children: each prints ONE json line on success.
# They import torch only: the probe must still run when the package
# itself is what broke.
_PRELUDE = """
import json, time
import torch
DEV = @DEVICE@
_clock_ns = time.perf_counter_ns
def _sync():
    if DEV == "cuda":
        torch.cuda.synchronize()
"""

_PROBE_INIT = _PRELUDE + """
t0 = _clock_ns()
if DEV == "cuda":
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is false")
    torch.zeros(1, device=DEV)
    _sync()
    info = {"platform": "gpu",
            "device_kind": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count()}
else:
    info = {"platform": "cpu", "device_kind": "cpu", "device_count": 1}
info["init_s"] = round((_clock_ns() - t0) / 1e9, 2)
print(json.dumps(info))
"""

_PROBE_TINY = _PRELUDE + """
x = torch.ones((256, 256), dtype=torch.float32, device=DEV)
t0 = _clock_ns()
y = x @ x
_sync()
compile_s = (_clock_ns() - t0) / 1e9
t0 = _clock_ns()
for _ in range(3):
    y = x @ x
_sync()
print(json.dumps({
    "compile_s": round(compile_s, 2),
    "warm_3x_ms": round((_clock_ns() - t0) / 1e6, 2),
}))
"""

_PROBE_DEEP = _PRELUDE + """
# large enough that a half-alive card stalls here, small enough to be
# cheap on a healthy one (~0.07 TFLOP + 16 MB in, 32 MB out)
x = torch.ones((4096, 2048), dtype=torch.bfloat16, device=DEV)
t0 = _clock_ns()
y = x @ x.T
_sync()
s = float(y[0, 0].float())
print(json.dumps({
    "deep_s": round((_clock_ns() - t0) / 1e9, 2),
    "checksum_ok": s == 2048.0,
}))
"""


def _probe(script: str, timeout: int) -> dict:
    """Run one probe in a SIGKILL-able child; classify the outcome."""
    t0 = clock_ns()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", script],
            capture_output=True,
            text=True,
            timeout=timeout,
            env=dict(os.environ),
        )
    except subprocess.TimeoutExpired:
        return {
            "ok": False,
            "error": f"hang (killed after {timeout}s)",
            "elapsed_s": round((clock_ns() - t0) / 1e9, 1),
        }
    if proc.returncode != 0:
        tail = (proc.stderr or "").strip().splitlines()
        return {
            "ok": False,
            "error": f"rc={proc.returncode}: {tail[-1][:200] if tail else ''}",
            "elapsed_s": round((clock_ns() - t0) / 1e9, 1),
        }
    for line in reversed((proc.stdout or "").strip().splitlines()):
        try:
            out = json.loads(line)
            break
        except ValueError:
            continue
    else:
        return {"ok": False, "error": "no parseable probe output"}
    out["ok"] = True
    out["elapsed_s"] = round((clock_ns() - t0) / 1e9, 1)
    return out


def run_doctor(cfg: DoctorConfig, writer) -> list:
    """Layered health report; verdict FAILURE iff a layer is broken.

    Layers (each subsumes the previous): backend init -> tiny op ->
    real-workload compute (``deep``) -> native modules (the g++-built
    interop module and loader).  The first broken layer names the
    failure; later device layers are skipped (their result would be
    noise)."""
    from tpu_patterns_torch.core.results import Record, Verdict

    if cfg.workers:
        raise ValueError(WORKERS_NOT_PORTED)
    if cfg.device not in ("cuda", "cpu"):
        raise ValueError(
            f"unsupported device {cfg.device!r}: want cuda or cpu")
    checks: dict[str, dict] = {}
    broken: str | None = None

    for name, script, deadline, gated in (
        ("backend_init", _PROBE_INIT, cfg.probe_timeout, True),
        ("tiny_op", _PROBE_TINY, cfg.probe_timeout, True),
        ("deep_compute", _PROBE_DEEP, cfg.deep_timeout, cfg.deep),
    ):
        if not gated or broken is not None:
            if gated and broken is not None:
                checks[name] = {"ok": False, "error": f"skipped: {broken}"}
            continue
        checks[name] = _probe(script.replace("@DEVICE@", repr(cfg.device)),
                              deadline)
        if checks[name].get("checksum_ok") is False:
            # completed but computed GARBAGE: never certify a runtime
            # that returns wrong answers
            checks[name]["ok"] = False
            checks[name]["error"] = "checksum mismatch (wrong results)"
        if not checks[name]["ok"]:
            broken = f"{name} failed"

    # native modules never touch the device: always probed, each once
    # (a broken toolchain fails its build again on every call)
    from tpu_patterns_torch.interop import native
    from tpu_patterns_torch.io import loader as io_loader

    ffi_ok = native.available()
    checks["native_ffi"] = {
        "ok": ffi_ok,
        **({} if ffi_ok else {"error": str(native.build_error())}),
    }
    loader_ok = io_loader.native_available()
    checks["native_loader"] = {
        "ok": loader_ok,
        **({} if loader_ok else {"error": str(io_loader.build_error())}),
    }

    # watchdog probe: the obs layer's live hang evidence folded into the
    # health report (a runtime can pass every probe NOW yet have wedged
    # ten minutes ago)
    from tpu_patterns_torch import obs

    recent_dumps = []
    try:
        now = wall_time_s()
        recent_dumps = [
            p
            for p in obs.find_dumps()
            if now - os.path.getmtime(p) <= cfg.watchdog_window_s
        ]
    except OSError:
        pass  # a dump deleted mid-scan must not fail the doctor
    checks["watchdog"] = {"ok": True, "recent_dumps": len(recent_dumps)}

    for name, c in checks.items():
        status = "ok" if c.get("ok") else f"FAILED ({c.get('error', '?')})"
        detail = " ".join(
            f"{k}={c[k]}"
            for k in ("platform", "device_kind", "device_count", "init_s",
                      "compile_s", "warm_3x_ms", "deep_s", "spawn_s",
                      "ping_ms", "recent_dumps")
            if k in c
        )
        print(
            f"# doctor {name}: {status}" + (f" [{detail}]" if detail else ""),
            file=writer.stream,
            flush=True,
        )

    healthy = all(c.get("ok") for c in checks.values())
    metrics: dict[str, float] = {}
    for name, c in checks.items():
        metrics[f"{name}_ok"] = 1.0 if c.get("ok") else 0.0
        for k in ("init_s", "compile_s", "warm_3x_ms", "deep_s", "elapsed_s",
                  "spawn_s", "ping_ms", "recent_dumps"):
            if k in c:
                metrics[f"{name}_{k}"] = float(c[k])
    # broken layer -> FAILURE; healthy but recent hang evidence ->
    # WARNING (the runtime IS up, but someone should read the dump)
    verdict = (
        Verdict.FAILURE
        if not healthy
        else (Verdict.WARNING if recent_dumps else Verdict.SUCCESS)
    )
    rec = Record(
        pattern="doctor",
        mode=str(checks.get("backend_init", {}).get("device_kind", "down")),
        commands=f"probe_timeout={cfg.probe_timeout}s deep={cfg.deep}",
        metrics=metrics,
        verdict=verdict,
        notes=[
            f"{name}: {c['error']}"
            for name, c in checks.items()
            if not c.get("ok") and "error" in c
        ]
        + [f"watchdog hang dump: {p}" for p in recent_dumps],
    )
    writer.record(rec)
    if cfg.watch_jsonl:
        action = record_watch_poll(cfg.watch_jsonl, rec)
        print(
            f"# doctor watch: episode {action} -> {cfg.watch_jsonl}",
            file=writer.stream,
            flush=True,
        )
    return [rec]


# ---------------------------------------------------------------------------
# Watch mode: per-EPISODE outage records, not per-poll.  Consecutive
# failing polls with the same broken-layer signature update ONE open
# episode entry in place (poll count + last-seen time); the first healthy
# poll closes it.  The file stays JSONL of Record-shaped objects.
# ---------------------------------------------------------------------------


def _failure_signature(rec) -> str:
    """Which layers are broken — the identity of an outage episode."""
    failing = sorted(
        k[: -len("_ok")]
        for k, v in rec.metrics.items()
        if k.endswith("_ok") and v == 0.0
    )
    return ",".join(failing) or "unknown"


def record_watch_poll(jsonl_path: str, rec) -> str:
    """Fold one doctor poll into the episode log; returns the action
    taken: ``opened`` (new failing episode), ``extended`` (same episode,
    count bumped in place), ``closed`` (healthy poll closed the open
    episode), or ``recorded`` (healthy poll, nothing open)."""
    from tpu_patterns_torch.core.results import Verdict

    d = os.path.dirname(jsonl_path)
    if d:
        os.makedirs(d, exist_ok=True)
    last = _read_last_entry(jsonl_path)
    last_is_open = (
        isinstance(last, dict)
        and last.get("pattern") == "doctor_episode"
        and last.get("metrics", {}).get("open") == 1.0
    )
    now = wall_time_s()
    failing = rec.verdict is Verdict.FAILURE

    if failing:
        sig = _failure_signature(rec)
        if last_is_open and last.get("mode") == sig:
            _mutate_last(jsonl_path, _extend(last, now))
            return "extended"
        episode = json.loads(rec.to_json())
        episode["pattern"] = "doctor_episode"
        episode["mode"] = sig
        episode["commands"] = f"episode:{sig}"
        episode["metrics"] = dict(
            rec.metrics, polls=1.0, opened_ts=now, last_ts=now, open=1.0
        )
        ep_line = json.dumps(episode, sort_keys=True) + "\n"
        if last_is_open:  # different signature: close it, open anew
            _close(last, now)
            _mutate_last(jsonl_path, last, append=ep_line)
        else:  # nothing to mutate: plain O(1) append
            _append(jsonl_path, ep_line)
        return "opened"

    if last_is_open:
        _close(last, now)
        _mutate_last(jsonl_path, last, append=rec.to_json() + "\n")
        return "closed"
    _append(jsonl_path, rec.to_json() + "\n")  # the common healthy poll
    return "recorded"


def _extend(episode: dict, now: float) -> dict:
    episode["metrics"]["polls"] += 1.0
    episode["metrics"]["last_ts"] = now
    return episode


def _close(episode: dict, now: float) -> None:
    episode["metrics"]["open"] = 0.0
    episode["metrics"]["closed_ts"] = now
    m = episode["metrics"]
    episode.setdefault("notes", []).append(
        f"episode closed after {m['polls']:.0f} poll(s), "
        f"{m['closed_ts'] - m['opened_ts']:.0f}s"
    )


def _read_last_entry(path: str) -> dict | None:
    """Parse the file's last line without reading the whole file (the
    healthy-watch common case is a multi-day append-only log)."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - 65536))
            tail = f.read().decode("utf-8", "replace")
    except OSError:
        return None
    for line in reversed(tail.strip().splitlines()):
        if line.strip():
            try:
                return json.loads(line)
            except ValueError:
                return None  # torn write: treat as no open episode
    return None


def _append(path: str, line: str) -> None:
    with open(path, "a") as f:
        f.write(line)
        f.flush()
        os.fsync(f.fileno())


def _mutate_last(path: str, entry: dict, append: str = "") -> None:
    """Replace the file's last line with ``entry`` (plus optional
    appended lines) via atomic whole-file rewrite — only episode
    boundaries and extensions pay this; plain polls use :func:`_append`.
    A kill mid-update must not tear the log (tmp+replace)."""
    try:
        with open(path) as f:
            lines = [ln for ln in f.readlines() if ln.strip()]
    except OSError:
        lines = []
    if lines:
        lines[-1] = json.dumps(entry, sort_keys=True) + "\n"
    else:
        lines = [json.dumps(entry, sort_keys=True) + "\n"]
    if append:
        lines.append(append)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.writelines(lines)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
