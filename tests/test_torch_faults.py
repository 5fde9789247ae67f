"""The port's fault injector and retry policy against the JAX package's.

The same spec text goes through both packages' ``parse_spec``; the same
seeded ``p=``/``after=``/``count=`` spec fires on the same ordinals of
the same calls; the retry policies give the same backoff schedules and
the same retry, quarantine and re-raise behavior, booking the same
retry and quarantine counters; a firing leaves the same ``fault.injected``
event and ``faults.jsonl`` line.  The port knows only the sites it has
(``train.step``, ``ckpt.save``, ``ckpt.restore``, ``loadgen.arrive``,
``obs.cost_book``, ``obs.scrape``, the serve engine's prefill,
decode-step, kv-tier and preemption sites, ``error`` included at
``serve.prefill``, ``serve.step`` and ``serve.verify``, the replica
fleet's, the prefix store's and the disaggregated handoff's): a spec
naming any other site (the sweep's, the warm workers') is refused at
parse time, where the JAX package takes it."""

import dataclasses

import pytest

from tpu_patterns import faults as jf
from tpu_patterns_torch import faults as tf

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

# the replica fleet's sites, the prefix store's and the disaggregated
# handoff's
FLEET_SITES = {"router.route", "replica.spawn", "replica.drain",
               "replica.obs_ship", "fleet.scale_out", "fleet.scale_in",
               "store.publish", "store.fetch", "store.prewarm",
               "disagg.transfer", "disagg.adopt"}
PORT_SITES = {"train.step", "ckpt.save", "ckpt.restore", "loadgen.arrive",
              "obs.cost_book", "obs.scrape", "serve.evict", "serve.onload",
              "serve.preempt", "serve.shed", "serve.prefill", "serve.step",
              "serve.verify"} | FLEET_SITES

SPECS = [
    "train.step:nan",
    "train.step:nan:step=2",
    "ckpt.save:error:after=1:count=2",
    "ckpt.restore:sleep:delay_s=0.5:p=0.25",
    "ckpt.save:crash:rc=7:proc=0",
    "ckpt.save:kill, train.step:preempt:count=3",
    " ckpt.restore:hang:step=4:after=0 ,",
    "train.step:error:p=0.5:after=2:count=10:step=3",
    "serve.step:error:count=1,serve.step:error:after=6:count=1",
    "serve.verify:error:after=2:count=99",
    "serve.prefill:error:count=99:rows=2",
    "obs.scrape:error:endpoint=metrics",
    "",
]

BAD = [
    "siteonly",
    "train.step:frobnicate",  # unknown action
    "ckpt.save:error:notkv",
    "train.steps:nan",  # typo'd site would inject nothing
    "ckpt.save:error:cout=1",  # typo'd key would match nothing
    "ckpt.save:error:count=x",
    "ckpt.save:error:p=half",
]


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in (jf, tf):
        pkg.configure("")
    yield
    for pkg in (jf, tf):
        pkg.configure(None)


def test_port_knows_exactly_its_sites():
    assert tf.KNOWN_SITES == PORT_SITES
    assert PORT_SITES <= jf.KNOWN_SITES
    assert tf.MATCH_KEYS == jf.MATCH_KEYS
    assert tf.injector.ACTIONS == jf.injector.ACTIONS


@pytest.mark.parametrize("text", SPECS)
def test_parse_spec_matches_reference(text):
    got = [dataclasses.asdict(s) for s in tf.parse_spec(text)]
    want = [dataclasses.asdict(s) for s in jf.parse_spec(text)]
    assert got == want


@pytest.mark.parametrize("text", BAD)
def test_malformed_specs_raise_in_both(text):
    with pytest.raises(ValueError) as want:
        jf.parse_spec(text)
    with pytest.raises(ValueError) as got:
        tf.parse_spec(text)
    # the same complaint up to the site list
    assert str(got.value).split(" (want")[0] == str(want.value).split(
        " (want")[0]


@pytest.mark.parametrize("site", sorted(jf.KNOWN_SITES - PORT_SITES))
def test_unported_sites_are_refused(site):
    assert jf.parse_spec(f"{site}:error")
    with pytest.raises(ValueError, match="unknown site"):
        tf.parse_spec(f"{site}:error")


def test_disagg_sites_are_refused_naming_step_9b():
    """Refused, naming their step, until the disaggregated handoff was
    ported; now each parses, with its match keys, as the reference's,
    and a refusal names only step 10's sites."""
    for site in ("disagg.transfer", "disagg.adopt"):
        text = f"{site}:error:count=2:rid=3:replica=0:blocks=4"
        got = [dataclasses.asdict(s) for s in tf.parse_spec(text)]
        assert got == [dataclasses.asdict(s) for s in jf.parse_spec(text)]
    with pytest.raises(ValueError, match="step 10"):
        tf.parse_spec("cell.run:error")


@pytest.mark.parametrize("site", sorted(FLEET_SITES))
def test_fleet_sites_parse_as_the_reference(site):
    """Refused before the fleet was ported; now each parses, with its
    match keys, as the JAX package parses it."""
    key = "fingerprint=ab12" if site.startswith("store.") else "replica=1"
    text = f"{site}:error:after=1:count=2:{key}"
    got = [dataclasses.asdict(s) for s in tf.parse_spec(text)]
    want = [dataclasses.asdict(s) for s in jf.parse_spec(text)]
    assert got == want


def _firings(pkg, spec, calls):
    """Which of ``calls`` (ctx dicts at train.step) fire under ``spec``."""
    pkg.configure(None)  # fresh in-process ordinals
    pkg.configure(spec)
    fired = []
    for ctx in calls:
        try:
            fired.append(pkg.inject("train.step", **ctx) is not None)
        except pkg.InjectedFault:
            fired.append(True)
    return fired


@pytest.mark.parametrize("seed", ["0", "7", "12345"])
@pytest.mark.parametrize("spec", [
    "train.step:nan:p=0.5:after=2:count=10",
    "train.step:error:p=0.3:count=99",
    "train.step:nan:after=3:count=4",
    "train.step:error:step=3:count=2",
])
def test_same_spec_fires_on_same_ordinals(spec, seed, monkeypatch):
    monkeypatch.setenv(jf.injector.ENV_SEED, seed)
    calls = [{"step": t % 5} for t in range(30)]
    want = _firings(jf, spec, calls)
    got = _firings(tf, spec, calls)
    assert got == want
    assert got == _firings(tf, spec, calls)  # replays bit-identically
    assert any(got)


def test_inactive_is_a_noop():
    assert not tf.active()
    assert tf.inject("train.step", step=3) is None


def test_injected_fault_is_an_oserror():
    assert issubclass(tf.InjectedFault, OSError)


def test_state_dir_shares_ordinals_across_registries(tmp_path, monkeypatch):
    monkeypatch.setenv(tf.ENV_STATE, str(tmp_path))
    tf.configure("ckpt.save:error:count=1")
    with pytest.raises(tf.InjectedFault):
        tf.inject("ckpt.save")
    tf.configure(None)
    tf.configure("ckpt.save:error:count=1")  # a "new process"
    assert tf.inject("ckpt.save") is None


def test_env_spec_is_read(monkeypatch):
    tf.configure(None)
    monkeypatch.setenv(tf.ENV_SPEC, "train.step:nan:step=1")
    assert tf.active()
    assert tf.inject("train.step", step=0) is None
    assert tf.inject("train.step", step=1).action == "nan"


def test_firing_logs_a_warning_record_on_stderr(capsys):
    tf.configure("ckpt.restore:error")
    with pytest.raises(tf.InjectedFault):
        tf.inject("ckpt.restore", step=1)
    err = capsys.readouterr().err
    assert "## ckpt.restore | error | WARNING" in err


@pytest.mark.parametrize("kw", [
    dict(seed=7),
    dict(seed=3, backoff_base_s=0.1, backoff_max_s=0.5, jitter_frac=0.5),
    dict(jitter_frac=0.0, backoff_base_s=0.1, backoff_max_s=0.5),
    dict(seed=11, backoff_mult=3.0, max_attempts=5),
])
def test_backoff_schedules_match(kw):
    got = [tf.RetryPolicy(**kw).backoff_s(a) for a in range(1, 8)]
    want = [jf.RetryPolicy(**kw).backoff_s(a) for a in range(1, 8)]
    assert got == want


def test_unseeded_jitter_is_bounded():
    p = tf.RetryPolicy(backoff_base_s=0.1, jitter_frac=0.25)
    assert all(0.075 <= p.backoff_s(1) <= 0.125 for _ in range(20))


def test_ckpt_policy_matches(monkeypatch):
    assert dataclasses.asdict(tf.ckpt_retry_policy()) == dataclasses.asdict(
        jf.ckpt_retry_policy())
    monkeypatch.setenv("TPU_PATTERNS_CKPT_ATTEMPTS", "4")
    assert tf.ckpt_retry_policy().max_attempts == 4
    assert dataclasses.asdict(tf.ckpt_retry_policy()) == dataclasses.asdict(
        jf.ckpt_retry_policy())


def _failing(errors):
    """fn() raising each of ``errors`` in turn, then returning "ok"."""
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= len(errors):
            raise errors[len(calls) - 1]
        return "ok"

    return fn, calls


@pytest.mark.parametrize("errors,attempts,outcome", [
    ([], 2, "ok"),
    ([OSError("blip")], 2, "ok"),
    ([OSError("a"), OSError("a")], 3, "Quarantined"),
    ([OSError("a"), OSError("b")], 2, "OSError"),
    ([OSError("a"), OSError("b"), OSError("c")], 3, "OSError"),
    ([ValueError("bug")], 3, "ValueError"),
])
def test_call_with_retry_matches(errors, attempts, outcome):
    results = []
    for pkg in (jf, tf):
        fn, calls = _failing(errors)
        sleeps = []
        policy = pkg.RetryPolicy(max_attempts=attempts, seed=5)
        try:
            res = pkg.call_with_retry(fn, policy=policy, site="ckpt.save",
                                      sleep=sleeps.append)
        except Exception as e:  # noqa: BLE001 - compared across packages
            res = type(e).__name__
        results.append((res, len(calls), sleeps))
    assert results[0] == results[1]
    assert results[1][0] == outcome


def test_firing_leaves_the_references_event_and_jsonl(tmp_path):
    """Each package books one ``fault.injected`` event (site, action and
    the ctx stringified) and appends one WARNING Record to
    ``faults.jsonl`` under its obs run dir."""
    import json

    from tpu_patterns import obs as jobs
    from tpu_patterns_torch import obs as tobs

    got = {}
    for name, pkg, o in (("ref", jf, jobs), ("port", tf, tobs)):
        run = tmp_path / name
        o.configure(str(run))
        o.flight_recorder().clear()
        try:
            pkg.configure("serve.step:error")
            with pytest.raises(pkg.InjectedFault):
                pkg.inject("serve.step", step=3, replica="")
        finally:
            o.configure(None)
        ev = [e for e in o.flight_recorder().snapshot()
              if e["name"] == "fault.injected"]
        recs = [json.loads(ln) for ln in open(run / "faults.jsonl")]
        got[name] = (
            [(e["kind"], e["attrs"]) for e in ev],
            [(r["pattern"], r["mode"], r["commands"], r["verdict"],
              r["notes"]) for r in recs],
        )
    assert got["port"] == got["ref"]
    assert got["port"][0] == [("event", {"site": "serve.step",
                                         "action": "error", "step": "3",
                                         "replica": ""})]


@pytest.mark.parametrize("errors,attempts", [
    ([OSError("blip")], 2),
    ([OSError("a"), OSError("a")], 3),
    ([OSError("a"), OSError("b")], 2),
])
def test_retry_and_quarantine_counters_match(errors, attempts):
    """``call_with_retry`` books ``tpu_patterns_faults_retries_total``
    and ``..._quarantined_total`` at its site by the same counts in
    both packages."""
    from tpu_patterns import obs as jobs
    from tpu_patterns_torch import obs as tobs

    moved = []
    for pkg, o in ((jf, jobs), (tf, tobs)):
        names = ("tpu_patterns_faults_retries_total",
                 "tpu_patterns_faults_quarantined_total")
        before = [o.counter(n, site="serve.step").value for n in names]
        fn, _ = _failing(errors)
        try:
            pkg.call_with_retry(fn, policy=pkg.RetryPolicy(
                max_attempts=attempts, backoff_base_s=0.0, jitter_frac=0.0),
                site="serve.step", sleep=lambda s: None)
        except Exception:  # noqa: BLE001 - the outcome is compared above
            pass
        moved.append([o.counter(n, site="serve.step").value - b
                      for n, b in zip(names, before)])
    assert moved[0] == moved[1]
    assert sum(moved[1]) >= 1
