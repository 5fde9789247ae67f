"""Live telemetry plane: /metrics, /healthz, /statusz over stdlib HTTP.

The port's copy of ``tpu_patterns/obs/live.py``, the replica fleet's
view included: a fleet parent attaches its manager (``attach_fleet``),
and /healthz and /statusz answer with one lane per replica.

Everything the obs stack had before this module is post-hoc — spans,
flight-recorder rings, fleet merges, perfwatch all answer "what
happened" after the run.  This is the layer that answers "are you
healthy, and are you burning your SLO budget?" WHILE a serve run is in
flight, the reference suite's measure-while-it-runs discipline applied
to the serving plane:

  /metrics   the default metrics Registry in Prometheus text form,
             snapshotted race-free against writer threads via
             :meth:`Registry.render` — byte-identical to what
             ``--obs-dump`` + ``obs export --prom`` would produce for
             the same state, so scrape and dump are one truth
  /healthz   JSON health verdict (ok | degraded | unhealthy): breaker
             state (rt.Breaker), watchdog recent fires, free-list /
             retained-tier occupancy, active rows, deferrals, and the
             SLO burn-rate monitor's episode state.  HTTP 200 for
             ok/degraded, 503 for unhealthy — a probe needs no JSON
             parser to decide
  /statusz   the per-request in-flight table: one row per rid from the
             engine's rt.LeaseTable with lifecycle timestamps (age,
             TTFT, tokens out of budget), resumed legs flagged with
             their banked token counts and parked (preempted, queued)
             rows listed; on a replica-fleet parent, one LANE per
             replica aggregated from the parent's lease ledgers + the
             shipped obs stream
  /costz     the attribution plane live (obs/cost.py): measured
             decode/prefill walls apportioned per request with the
             identity verdicts, the pool block-second integral, and
             the priority/scenario rollups — "who is paying for this
             device" answered mid-run

The server is a daemon thread on stdlib ``http.server`` (the container
bakes nothing in) bound to 127.0.0.1, opt-in via ``serve --obs_http
PORT`` (0 picks a free port, announced on stdout).  Handlers only READ
engine state — the scheduler thread is never blocked, and a scrape
failure answers 503 through the ``obs.scrape`` fault site instead of
crashing anything.  ``python -m tpu_patterns_torch obs watch URL`` polls the endpoints
into a one-line-per-interval terminal view.
"""

from __future__ import annotations

import json
import sys
import threading
import time

from tpu_patterns_torch.core.timing import clock_ns

ENDPOINTS = ("/metrics", "/healthz", "/statusz", "/costz")

# -- the current scrape target --------------------------------------------
#
# The plane outlives any one engine (A/B measured patterns build several
# per run), so engines announce themselves: ServeEngine.run attaches at
# loop entry and detaches at exit, the replica parent attaches its
# manager for the fleet view.  One process, one current target of each
# kind — the same shape as the default metrics registry.

_TARGET_LOCK = threading.Lock()
_ENGINE = None
_FLEET = None
# watchdog fired_dumps() length at the moment the current target
# attached: "recent-fire status" means fires during THIS run — a hang
# diagnosed in an earlier leg of the same process must not mark a
# later healthy engine degraded forever
_FIRES_AT_ATTACH = 0


def _fired_count() -> int:
    from tpu_patterns_torch import obs

    return len(obs.fired_dumps())


def attach_engine(engine) -> None:
    global _ENGINE, _FIRES_AT_ATTACH
    fires = _fired_count()
    with _TARGET_LOCK:
        _ENGINE = engine
        _FIRES_AT_ATTACH = fires


def detach_engine(engine) -> None:
    """Detach iff ``engine`` is still the current one (legs are
    sequential; a stale detach must not clobber a newer attach)."""
    global _ENGINE
    with _TARGET_LOCK:
        if _ENGINE is engine:
            _ENGINE = None


def current_engine():
    with _TARGET_LOCK:
        return _ENGINE


def attach_fleet(manager) -> None:
    global _FLEET, _FIRES_AT_ATTACH
    fires = _fired_count()
    with _TARGET_LOCK:
        _FLEET = manager
        _FIRES_AT_ATTACH = fires


def detach_fleet(manager) -> None:
    global _FLEET
    with _TARGET_LOCK:
        if _FLEET is manager:
            _FLEET = None


def current_fleet():
    with _TARGET_LOCK:
        return _FLEET


# -- snapshots -------------------------------------------------------------


def _engine_health(eng) -> dict:
    breaker = eng.breaker
    tier = eng.tier
    allocatable = eng.layout.n_blocks - 1
    return {
        "replica": eng.replica or None,
        "breaker": None if breaker is None else {
            "open": bool(breaker.opened),
            "failures": int(breaker.failures),
            "tripped": bool(eng.breaker_tripped),
        },
        "pool": {
            "free_blocks": len(eng.free),
            "allocatable_blocks": allocatable,
            "retained_blocks": len(eng.retained),
            "occupancy": round(eng._occupancy(), 4),
            "host_tier_blocks": len(tier) if tier is not None else None,
        },
        "active_rows": len(eng.active),
        "queued": len(eng.queue),
        "deferrals": int(eng.stats["deferrals"]),
        "sheds": int(eng.stats["sheds"]),
        "tier_fallbacks": int(eng.stats["tier_fallbacks"]),
        "done": len(eng.done),
        "failed": len(eng.failed),
    }


def _fleet_health(mgr) -> dict:
    lanes = {}
    for h in mgr.handles.values():
        lanes[h.id] = {
            "state": h.state,
            "alive": bool(h.alive()),
            "breaker_open": bool(h.breaker.opened),
            "leases": len(h.leases),
            "obs_stalled": bool(getattr(h, "obs_stalled", False)),
        }
    return {"replicas": lanes}


def health_snapshot() -> dict:
    """The /healthz body.  Verdict ladder: ``unhealthy`` when the
    decode path is gone (engine breaker open/tripped, or every fleet
    replica dead); ``degraded`` when serving continues impaired (burn
    mitigation active, watchdog fired, quarantined requests, tier
    fallbacks, a sick replica); ``ok`` otherwise — an idle plane with
    nothing attached is ok, not an error."""
    from tpu_patterns_torch import obs

    with _TARGET_LOCK:
        eng, fleet = _ENGINE, _FLEET
        fires_baseline = _FIRES_AT_ATTACH
    out: dict = {"verdict": "ok", "pid_clock_ns": clock_ns()}
    unhealthy = degraded = False
    fired = obs.fired_dumps()
    # only fires SINCE the current target attached degrade the verdict
    # (the total and newest dump names stay visible either way)
    recent = max(0, len(fired) - fires_baseline)
    out["watchdog"] = {
        "fired": recent,
        "fired_total": len(fired),
        "dumps": [p.rsplit("/", 1)[-1] for p in fired[-3:]],
    }
    if recent:
        degraded = True
    if eng is not None:
        out["engine"] = _engine_health(eng)
        out["slo"] = eng.slo.snapshot()
        if eng.breaker_tripped or (
            eng.breaker is not None and eng.breaker.opened
        ):
            unhealthy = True
        if (
            out["slo"]["mitigating"]
            or eng.failed
            or eng.stats["tier_fallbacks"]
        ):
            degraded = True
    else:
        out["engine"] = None
    if fleet is not None:
        out["fleet"] = _fleet_health(fleet)
        lanes = out["fleet"]["replicas"].values()
        if lanes and not any(
            l["alive"] and l["state"] in ("spawning", "ready")
            for l in lanes
        ):
            unhealthy = True
        if any(
            l["state"] in ("quarantined", "drained", "dead")
            or l["breaker_open"] or l["obs_stalled"]
            for l in lanes
        ):
            degraded = True
    out["verdict"] = (
        "unhealthy" if unhealthy else "degraded" if degraded else "ok"
    )
    return out


def _engine_status(eng) -> dict:
    now = clock_ns()
    rows = []
    for rid, slot in sorted(eng.inflight.snapshot().items()):
        # a resumed leg (preempted earlier, re-admitted) carries its
        # banked partial output: the table counts those tokens so
        # "generated" plus "banked" reads as the client-visible stream
        banked = len(eng.preempted_partial.get(rid, ()))
        rows.append({
            "rid": rid,
            "scenario": slot.scenario or None,
            "priority": slot.priority or None,
            "jid": slot.jid or None,
            "prompt_tokens": slot.lens,
            "generated": len(slot.out),
            "banked": banked or None,
            "resumed": rid in eng.preempted_rids or None,
            "n_gen": slot.n_gen,
            "age_ms": round((now - slot.t_submit_ns) / 1e6, 3),
            "ttft_ms": (
                round((slot.t_first_ns - slot.t_submit_ns) / 1e6, 3)
                if slot.t_first_ns else None
            ),
            "deadline_ms": slot.deadline_ms or None,
        })
    recent = [
        {"rid": rid, **{
            k: lc[k]
            for k in ("status", "scenario", "n_out", "ttft_ms", "e2e_ms",
                      "met")
        }, "priority": lc.get("priority")}
        for rid, lc in list(eng.lifecycle.items())[-8:]
    ]
    # parked rows: preempted mid-flight, banked partial output, waiting
    # in the queue as forced sessions — flagged here so the in-flight
    # table never silently loses a request the scheduler parked
    parked = [
        {
            "rid": r.rid,
            "banked": len(eng.preempted_partial.get(r.rid, ())),
            "remaining": r.n_gen,
        }
        for r, _ in eng.queue
        if r.rid in eng.preempted_partial
    ]
    return {
        "replica": eng.replica or None,
        "requests": rows,
        "queued": [r.rid for r, _ in eng.queue],
        "parked": parked,
        "done": len(eng.done),
        "failed": len(eng.failed),
        "shed": len(eng.shed),
        "recent": recent,
    }


def _fleet_status(mgr) -> dict:
    """One lane per replica: the parent's lease ledger (which rids are
    in flight WHERE) joined with the shipped obs stream's per-replica
    counter truth (obs/fleet.py) — the fleet statusz needs no RPC to
    the children, everything is already at the parent."""
    fleet_obs = getattr(mgr, "fleet_obs", None)
    lanes = []
    for h in mgr.handles.values():
        shipped = {}
        if fleet_obs is not None:
            totals = fleet_obs.shipped_totals.get(h.id, {})
            for (_, name, lk), v in totals.items():
                if name in (
                    "tpu_patterns_serve_requests_total",
                    "tpu_patterns_serve_tokens_total",
                    "tpu_patterns_serve_quarantined_total",
                ):
                    short = name[len("tpu_patterns_serve_"):-len("_total")]
                    shipped[short] = shipped.get(short, 0.0) + v
        lanes.append({
            "replica": h.id,
            "state": h.state,
            "inflight": sorted(h.leases.held()),
            "breaker_open": bool(h.breaker.opened),
            "last_msg_age_s": round(
                (clock_ns() - h.last_msg_ns) / 1e9, 3
            ),
            "obs_stalled": bool(getattr(h, "obs_stalled", False)),
            "shipped": shipped,
        })
    return {"replicas": lanes}


def status_snapshot() -> dict:
    eng, fleet = current_engine(), current_fleet()
    out: dict = {}
    out["engine"] = _engine_status(eng) if eng is not None else None
    if fleet is not None:
        out["fleet"] = _fleet_status(fleet)
    return out


def cost_snapshot(max_requests: int = 32) -> dict:
    """The /costz body: the attached engine's cost book (obs/cost.py)
    with the per-request list capped for scrape size — the full list
    lands in ``cost.jsonl`` at dump time.  A replica-fleet parent
    answers for its OWN engine only; the children's books dump next to
    their metrics and merge offline via ``obs cost``."""
    eng = current_engine()
    if eng is None:
        return {"engine": None}
    snap = eng.cost.snapshot()
    n = len(snap["requests"])
    if n > max_requests:
        snap["requests"] = snap["requests"][:max_requests]
        snap["requests_elided"] = n - max_requests
    # decision-ledger coverage rides along: per-action booked counts,
    # so a /costz scrape can spot a ledger-vs-counter identity gap live
    snap["decisions"] = {
        a: eng.decisions.count(a)
        for a in sorted({e["action"] for e in eng.decisions.events})
    }
    return {"engine": snap}


# -- the server ------------------------------------------------------------


class ObsHttp:
    """The opt-in HTTP plane: daemon-threaded stdlib server bound to
    127.0.0.1 serving /metrics, /healthz, /statusz.  ``port`` 0 binds an
    ephemeral port; :meth:`start` returns the bound port."""

    def __init__(self, port: int, *, host: str = "127.0.0.1",
                 registry=None):
        self.host = host
        self.port = int(port)
        self._registry = registry  # None -> the default obs registry
        self._httpd = None
        self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def registry(self):
        if self._registry is not None:
            return self._registry
        from tpu_patterns_torch.obs import metrics

        return metrics.default()

    def start(self) -> int:
        from http.server import ThreadingHTTPServer

        if self._httpd is not None:
            return self.port
        httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        httpd.daemon_threads = True
        httpd.plane = self
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(
            target=httpd.serve_forever,
            name="tpu-patterns-obs-http",
            daemon=True,
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        self._thread = None


def _make_handler():
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        # stdlib default logs every request to stderr; scrapes arrive
        # once a second and must not flood the run's log tee
        def log_message(self, fmt, *args):  # pragma: no cover - silence
            pass

        def _respond(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib handler contract)
            from tpu_patterns_torch import faults, obs

            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            endpoint = (
                path.lstrip("/") if path in ENDPOINTS else "other"
            )
            ctype = "application/json"
            try:
                # fault site: a scrape that errors answers 503 — the
                # plane is an OBSERVER, a broken scrape must never
                # crash (or even slow) the scheduler thread it watches
                faults.inject("obs.scrape", endpoint=endpoint)
                if path == "/metrics":
                    body = self.server.plane.registry().render().encode()
                    code = 200
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/healthz":
                    health = health_snapshot()
                    code = 503 if health["verdict"] == "unhealthy" else 200
                    body = json.dumps(health, sort_keys=True).encode()
                elif path == "/statusz":
                    code = 200
                    body = json.dumps(
                        status_snapshot(), sort_keys=True
                    ).encode()
                elif path == "/costz":
                    code = 200
                    body = json.dumps(
                        cost_snapshot(), sort_keys=True
                    ).encode()
                else:
                    code = 404
                    body = json.dumps({
                        "error": f"unknown path {path!r}",
                        "endpoints": list(ENDPOINTS),
                    }).encode()
            except Exception as e:  # scrape failure -> 503, never a crash
                code = 503
                body = json.dumps({"error": str(e)}).encode()
            # count BEFORE responding: a consumer that reads the reply
            # then scrapes /metrics must already see its own request in
            # the counter (and accounting never depends on the client
            # still listening)
            try:
                obs.counter(
                    "tpu_patterns_obs_http_requests_total",
                    endpoint=endpoint, status=str(code),
                ).inc()
            except Exception:
                pass
            try:
                self._respond(code, body, ctype)
            except OSError:
                pass  # client hung up: nothing to answer

    return Handler


_Handler = _make_handler()


# -- obs watch -------------------------------------------------------------


def _http_get(url: str, timeout_s: float = 5.0) -> tuple[int, str]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        # 503 (unhealthy / injected scrape fault) still carries a body
        return e.code, e.read().decode()


def _sample(samples: dict, name: str, **labels) -> float | None:
    key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
    return samples.get(key)


def _fmt(v: float | None, unit: str = "", nd: int = 1) -> str:
    if v is None:
        return "-"
    return f"{v:.{nd}f}{unit}" if v != int(v) else f"{int(v)}{unit}"


def _watch_line(n: int, health: dict, samples: dict) -> str:
    eng = health.get("engine") or {}
    pool = eng.get("pool") or {}
    slo = health.get("slo") or {}
    parts = [
        f"[{n:4d}]",
        f"{health.get('verdict', '?'):9s}",
        f"act={_fmt(eng.get('active_rows'))}",
        f"q={_fmt(eng.get('queued'))}",
        f"free={_fmt(pool.get('free_blocks'))}"
        f"/{_fmt(pool.get('allocatable_blocks'))}",
        f"burn={_fmt(slo.get('burn_rate_fast'), nd=2)}",
        f"ttft_p99={_fmt(_sample(samples, 'tpu_patterns_slo_live_ttft_p99_ms'), 'ms')}",
        f"tpot_p99={_fmt(_sample(samples, 'tpu_patterns_slo_live_tpot_p99_ms'), 'ms')}",
        f"tok={_fmt(_sample(samples, 'tpu_patterns_serve_tokens_total'), nd=0)}",
        f"shed={_fmt(_sample(samples, 'tpu_patterns_serve_shed_total'), nd=0)}",
        f"defer={_fmt(_sample(samples, 'tpu_patterns_serve_deferrals_total'), nd=0)}",
    ]
    # per-class tails: the priority-labeled live gauges appear
    # once a classed request finalizes — columns show up only when the
    # trace actually carries that class, keeping class-free lines short
    for cls, tag in (("interactive", "int"), ("bulk", "bulk")):
        v = _sample(
            samples, "tpu_patterns_slo_live_ttft_p99_ms", priority=cls
        )
        if v is not None:
            parts.append(f"{tag}_ttft_p99={_fmt(v, 'ms')}")
        v = _sample(
            samples, "tpu_patterns_slo_live_tpot_p99_ms", priority=cls
        )
        if v is not None:
            parts.append(f"{tag}_tpot_p99={_fmt(v, 'ms')}")
    if "fleet" in health:
        lanes = health["fleet"]["replicas"]
        live = sum(
            1 for l in lanes.values()
            if l["alive"] and l["state"] in ("spawning", "ready")
        )
        parts.append(f"replicas={live}/{len(lanes)}")
    return " ".join(parts)


def watch(
    url: str,
    *,
    interval_s: float = 1.0,
    count: int = 0,
    out=None,
) -> int:
    """``python -m tpu_patterns_torch obs watch URL``: poll /healthz + /metrics into a
    one-line-per-interval terminal view.  ``count`` 0 polls until the
    plane goes away (the watched run finishing is a clean exit, 0, as
    long as at least one poll succeeded); ``count`` N stops after N
    successful polls.  Returns the process exit code."""
    from tpu_patterns_torch.obs import metrics

    out = out or sys.stdout
    url = url.rstrip("/")
    if "://" not in url:
        url = "http://" + url
    polls = ok_polls = 0
    while True:
        polls += 1
        try:
            h_code, h_body = _http_get(url + "/healthz")
            m_code, m_body = _http_get(url + "/metrics")
            health = json.loads(h_body) if h_code in (200, 503) else {}
            samples = (
                metrics.parse_prom_text(m_body) if m_code == 200 else {}
            )
        except (OSError, ValueError) as e:
            if ok_polls:
                print(
                    f"[{polls:4d}] plane gone after {ok_polls} poll(s) "
                    f"({e}) — the watched run finished",
                    file=out,
                )
                return 0
            print(f"watch: no plane at {url} ({e})", file=out)
            return 1
        ok_polls += 1
        print(_watch_line(polls, health, samples), file=out)
        try:
            out.flush()
        except (OSError, ValueError):
            pass
        if count and ok_polls >= count:
            return 0
        time.sleep(interval_s)
