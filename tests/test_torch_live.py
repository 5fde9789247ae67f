"""The port's live telemetry plane (``obs/live.py``) against the JAX
package's.

Each package's plane is started on port 0 (an ephemeral port of
127.0.0.1) and scraped over HTTP in the middle of a serve run, from the
engine's own arrival source, so the run is attached: ``/healthz``,
``/metrics``, ``/statusz`` and ``/costz`` answer with the reference's
keys, the metrics parse as Prometheus text, ``obs watch`` reads the
plane, an injected scrape fault answers 503 in both, and stopping the
plane frees the port."""

import io
import json
import re
import socket
import urllib.error
import urllib.request

import pytest

from tpu_patterns import faults as jfaults
from tpu_patterns import obs as jobs
from tpu_patterns.obs import live as jlive
from tpu_patterns_torch import faults as tfaults
from tpu_patterns_torch import obs as tobs
from tpu_patterns_torch.obs import live as tlive
from tpu_patterns_torch.obs import metrics as tmetrics

from test_torch_recovery import PKGS, _policy, _trace
from test_torch_tier_engine import _port, _ref

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

ENDPOINTS = ("/healthz", "/metrics", "/statusz", "/costz")
LIVE = {"ref": jlive, "port": tlive}


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    for pkg in (jfaults, tfaults):
        pkg.configure(None)
    for o, name in ((jobs, "ref"), (tobs, "port")):
        o.configure(str(tmp_path / name))
    yield
    for pkg in (jfaults, tfaults):
        pkg.configure(None)
    for o in (jobs, tobs):
        o.configure(None)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _keys(obj, prefix=""):
    """Every key path of a JSON body (list items share one path)."""
    out = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.add(prefix + k)
            out |= _keys(v, prefix + k + ".")
    elif isinstance(obj, list):
        for v in obj:
            out |= _keys(v, prefix + "[].")
    return out


def _scrape_mid_run(which, spec=None, after=3, **kw):
    """Serve a trace through ``which`` package's engine with its plane
    up; on the source's ``after``-th poll (the run attached, rows in
    flight) scrape every endpoint and run ``obs watch`` once (the
    port's).  Returns the scrapes, the watch output and the engine."""
    Eng, Req, faults, obs, _ = PKGS[which]
    live = LIVE[which]
    dec, params = (_ref if which == "ref" else _port)(13)
    plane = live.ObsHttp(0)
    port = plane.start()
    assert port > 0
    reqs = _trace(Req, 6, n_gen=4)
    polls, scrapes, watch_out = [0], {}, io.StringIO()

    def source(idle):
        polls[0] += 1
        if polls[0] == 1:
            return reqs
        if polls[0] == after:
            for path in ENDPOINTS:
                scrapes[path] = _get(port, path)
            if which == "port":
                scrapes["watch_rc"] = tlive.watch(
                    f"127.0.0.1:{port}", count=1, out=watch_out)
            return None
        return []

    faults.configure(spec)
    try:
        eng = Eng(dec, params, slots=2, retry_policy=_policy(faults), **kw)
        eng.run([], source=source)
    finally:
        faults.configure(None)
        plane.stop()
    assert live.current_engine() is None  # detached at run exit
    return scrapes, watch_out.getvalue(), eng, port


@pytest.fixture(scope="module")
def scraped():
    return {w: _scrape_mid_run(w) for w in PKGS}


def test_healthz_answers_mid_run_with_the_references_keys(scraped):
    got = {}
    for w, (scrapes, _, eng, _) in scraped.items():
        code, body = scrapes["/healthz"]
        h = json.loads(body)
        got[w] = (code, _keys(h), h["verdict"], h["engine"]["active_rows"],
                  h["engine"]["breaker"], h["engine"]["failed"])
    assert got["port"] == got["ref"]
    code, _, verdict, active, breaker, failed = got["port"]
    assert code == 200 and verdict == "ok" and active == 2
    assert breaker is None and failed == 0


def test_statusz_and_costz_answer_mid_run_with_the_references_keys(scraped):
    for path in ("/statusz", "/costz"):
        keys = {}
        for w, (scrapes, _, _, _) in scraped.items():
            code, body = scrapes[path]
            assert code == 200
            keys[w] = _keys(json.loads(body))
        assert keys["port"] == keys["ref"], path
    status = json.loads(scraped["port"][0]["/statusz"][1])["engine"]
    assert [r["rid"] for r in status["requests"]] == [0, 1]
    assert status["queued"] == [2, 3, 4, 5]
    ref = json.loads(scraped["ref"][0]["/statusz"][1])["engine"]
    assert [{k: v for k, v in r.items() if k not in ("age_ms", "ttft_ms")}
            for r in status["requests"]] == [
        {k: v for k, v in r.items() if k not in ("age_ms", "ttft_ms")}
        for r in ref["requests"]]


def test_metrics_answer_mid_run_as_prometheus_text(scraped):
    code, body = scraped["port"][0]["/metrics"]
    assert code == 200
    samples = tmetrics.parse_prom_text(body)
    names = {name for name, _ in samples}
    assert "tpu_patterns_serve_tokens_total" in names
    assert "tpu_patterns_serve_queue_wait_ms_count" in names
    assert samples[("tpu_patterns_serve_tokens_total", ())] > 0


def test_obs_watch_reads_the_plane(scraped):
    scrapes, out, _, _ = scraped["port"]
    assert scrapes["watch_rc"] == 0
    (line,) = out.splitlines()
    assert re.match(r"\[\s*1\] ok ", line), line
    assert "act=2" in line and "q=4" in line


def test_stopped_plane_frees_its_port(scraped):
    port = scraped["port"][3]
    with socket.socket() as s:
        # no listener holds it any more (closed connections may linger
        # in TIME_WAIT, which SO_REUSEADDR allows, as the plane does)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
    out = io.StringIO()
    assert tlive.watch(f"http://127.0.0.1:{port}", count=1, out=out) == 1
    assert "no plane at" in out.getvalue()


def test_quarantines_degrade_and_an_open_breaker_is_unhealthy():
    """A deterministic step fault quarantines mid-run: /healthz reads
    degraded (and, with the breaker tripped, unhealthy: 503), as the
    reference's does."""
    got = {}
    for w in PKGS:
        scrapes, _, eng, _ = _scrape_mid_run(
            w, spec="serve.step:error:count=99", after=4)
        code, body = scrapes["/healthz"]
        got[w] = (code, json.loads(body)["verdict"], sorted(eng.failed))
    assert got["port"] == got["ref"] and got["port"][1] == "degraded"
    for w, (Eng, Req, faults, obs, rt) in PKGS.items():
        dec, params = (_ref if w == "ref" else _port)(13)
        eng = Eng(dec, params, slots=2, retry_policy=_policy(faults),
                  breaker=rt.Breaker(threshold=1, cooldown_s=3600.0))
        faults.configure("serve.step:error:count=99")
        try:
            eng.run(_trace(Req, 4, n_gen=4))
        finally:
            faults.configure(None)
        live = LIVE[w]
        live.attach_engine(eng)
        try:
            h = live.health_snapshot()
        finally:
            live.detach_engine(eng)
        got[w] = (h["verdict"], h["engine"]["breaker"], h["engine"]["queued"])
    assert got["port"] == got["ref"]
    assert got["port"] == ("unhealthy", {"open": True, "failures": 1,
                                         "tripped": True}, 2)


@pytest.mark.parametrize("path", ["/metrics", "/healthz", "/nope"])
def test_scrape_fault_answers_503_and_unknown_paths_404(path):
    codes = {}
    for w, (_, _, faults, obs, _) in PKGS.items():
        plane = LIVE[w].ObsHttp(0)
        port = plane.start()
        try:
            faults.configure("obs.scrape:error:count=1")
            first = _get(port, path)
            faults.configure(None)
            second = _get(port, path)
        finally:
            plane.stop()
        codes[w] = (first[0], second[0], json.loads(first[1]).keys()
                    if first[0] == 503 else None)
    assert codes["port"] == codes["ref"]
    want_second = 404 if path == "/nope" else 200
    assert codes["port"][:2] == (503, want_second)


def test_idle_plane_is_ok_with_no_engine():
    plane = tlive.ObsHttp(0)
    port = plane.start()
    try:
        code, body = _get(port, "/healthz")
        status = json.loads(_get(port, "/statusz")[1])
        cost = json.loads(_get(port, "/costz")[1])
    finally:
        plane.stop()
    h = json.loads(body)
    assert code == 200 and h["verdict"] == "ok" and h["engine"] is None
    assert status == {"engine": None} and cost == {"engine": None}
