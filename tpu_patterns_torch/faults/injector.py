"""Deterministic fault injection: named sites, seeded firing, env spec.

Counterpart of ``tpu_patterns/faults/injector.py``, with the same spec
grammar, ordinals, state directory and seeded ``p=`` draw.  Code declares
named fault sites (``inject("ckpt.save", step=4)``), and a spec --
``TPU_PATTERNS_FAULTS`` in the environment, or :func:`configure` in
tests -- decides which sites fire, when, and how.  With no spec set,
``inject`` is a near-free no-op, so sites are safe on hot paths.

Spec grammar (comma-separated specs)::

    TPU_PATTERNS_FAULTS = spec[,spec...]
    spec   = site ":" action [":" key "=" value]*
    action = error    raise InjectedFault (an OSError: retry paths see a
                      transient I/O failure)
             crash    os._exit(rc)  (default rc 41)
             kill     SIGKILL this process
             hang     sleep delay_s (default 30)
             sleep    same as hang; reads as "slow I/O" at ckpt sites
             nan      no side effect; the SITE interprets it (the train
                      loop poisons its loss)
             preempt  raise SIGTERM in this process
    keys   = count=N    fire on N matched calls (default 1)
             after=N    skip the first N matched calls (default 0)
             delay_s=F  hang/sleep duration
             rc=N       crash exit code
             p=F        fire with probability F, seeded (default 1.0)
             <match>=V  match predicate (one of MATCH_KEYS): fires only
                        when the inject() call's ctx has
                        str(ctx[key]) == V; unknown sites, actions and
                        keys all raise at parse time

Matched calls are counted per spec (the ordinal), and ``after``/
``count`` window the ordinals that fire.  ``TPU_PATTERNS_FAULTS_STATE``
names a directory that shares ordinals across processes (a file counter
under flock).  ``p=`` draws from a generator seeded by
(``TPU_PATTERNS_FAULTS_SEED``, site, ordinal), so a chaos run replays
bit-identically under the same seed.

Every firing is logged BEFORE the action: a ``fault.injected``
flight-recorder event, a WARNING Record (``faults.jsonl`` under the obs
run dir, markers on stderr) and one on the
``tpu_patterns_faults_injected_total`` counter (labelled by site and
action).
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import sys
import time

ENV_SPEC = "TPU_PATTERNS_FAULTS"
ENV_STATE = "TPU_PATTERNS_FAULTS_STATE"
ENV_SEED = "TPU_PATTERNS_FAULTS_SEED"

ACTIONS = frozenset(
    {"error", "crash", "kill", "hang", "sleep", "nan", "preempt"}
)

# every inject() call site in the package: a spec naming anything else
# is a typo that would silently inject nothing, so parse_spec rejects it
KNOWN_SITES = frozenset({
    # cli.py main(), before dispatch (ctx cmd, cell: the sweep exports
    # TPU_PATTERNS_CELL into each cell's env): a whole CLI run, one sweep
    # cell, crashing or hanging; the sweep's run_cell_attempts recovers
    "cell.run",
    # exec/worker.py, before the warm worker's ready handshake (ctx pid):
    # the pool's ready deadline and breaker recover
    "worker.ready",
    "ckpt.save",  # ckpt/checkpoint.py, after the shards, before the manifest
    "ckpt.restore",  # ckpt/checkpoint.py, before the shard reads
    "train.step",  # models/train_loop.py, per step (``nan`` poisons loss)
    # loadgen/runner.py, per released arrival (ctx rid, scenario): an
    # ``error`` drops the arrival, ``sleep``/``hang`` delays it
    "loadgen.arrive",
    # obs/cost.py, per booking: fails OPEN (an error skips the booking)
    "obs.cost_book",
    # serve/engine.py's host KV tier: evict fires before the device->host
    # block copy, onload before the host->device copy, each inside its
    # retry (a deterministic failure falls back: discard or prefill
    # fresh); preempt and shed fail OPEN (an error aborts the preemption
    # or the shed, the row runs or admits as if no rung had fired)
    "serve.evict", "serve.onload", "serve.preempt", "serve.shed",
    # serve/engine.py, before each prefill's, decode step's and verify
    # step's launch (nothing mutated yet): ``error`` retries under the
    # serve policy and quarantines exactly the wave's rows on
    # exhaustion; ``preempt`` raises SIGTERM, the step completes and the
    # loop snapshots at its iteration boundary; ``sleep``/``hang`` stall
    "serve.prefill", "serve.step", "serve.verify",
    # obs/live.py, per HTTP request to the live plane: any error answers
    # 503, never crashing (or blocking) the scheduler it observes
    "obs.scrape",
    # the replica fleet (serve/router.py, serve/replica.py): route fires
    # after the ring's decision and before the dispatch (an ``error``
    # falls back to another live replica, counted as a reroute); spawn
    # before the child's fork (retried under the replica policy); drain
    # before a drain or checkpoint request (an ``error`` is treated as an
    # unresponsive replica: killed and settled); obs_ship in the child
    # before each obs batch (an ``error`` drops that batch)
    "router.route", "replica.spawn", "replica.drain", "replica.obs_ship",
    # serve/replica.py's elastic controller, before a scale-out spawn or
    # a scale-in drain (an ``error`` aborts that action; the cooldown is
    # spent all the same)
    "fleet.scale_out", "fleet.scale_in",
    # the fleet prefix store (serve/store.py via serve/engine.py):
    # publish fires before the tmp + os.replace commit, fetch before an
    # admission-miss store read, prewarm before a scale-out pre-fetch;
    # each degrades to fresh prefill on a deterministic failure
    "store.publish", "store.fetch", "store.prewarm",
    # the disaggregated handoff (serve/engine.py, roles prefill and
    # decode; ctx rid, replica, blocks): transfer fires before the gather
    # of a finished prefill's blocks, adopt before the onload of a shipped
    # payload; an ``error`` retries, exhaustion degrades to a re-prefill
    # on the decode side, and a ``kill`` leaves no partial spool file
    "disagg.transfer", "disagg.adopt",
})

# the match keys of the spec grammar (the JAX package's set; the sites
# here pass, at cell.run ``cmd`` and ``cell``, at worker.ready ``pid``,
# elsewhere ``step``, at ckpt.save ``proc``, at loadgen.arrive ``rid`` and
# ``scenario``, at obs.cost_book ``rows`` or ``rid`` and ``replica``, at
# the serve.* sites ``rid``, ``rows``, ``step`` and ``replica``, at
# obs.scrape ``endpoint``, at the fleet's sites ``replica`` (router.route
# also ``rid``), at the store.* sites ``fingerprint`` and at the
# disagg.* sites ``rid``, ``replica`` and ``blocks``)
MATCH_KEYS = frozenset({
    "pid", "cmd", "cell", "step", "proc", "rows", "rid", "scenario",
    "replica", "blocks", "endpoint", "fingerprint",
})


class InjectedFault(OSError):
    """An ``error``-action firing.  Subclasses OSError so every I/O
    retry path treats an injected fault exactly like a transient I/O
    failure."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed spec: where to fire, what to do, which calls match."""

    site: str
    action: str
    count: int = 1
    after: int = 0
    delay_s: float = 30.0
    rc: int = 41
    p: float = 1.0
    match: tuple[tuple[str, str], ...] = ()


def parse_spec(text: str) -> list[FaultSpec]:
    """Parse the ``TPU_PATTERNS_FAULTS`` grammar; malformed specs raise."""
    specs: list[FaultSpec] = []
    for chunk in text.split(","):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = chunk.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"fault spec {chunk!r}: want site:action[:key=value]*"
            )
        site, action = parts[0].strip(), parts[1].strip()
        if site not in KNOWN_SITES:
            raise ValueError(
                f"fault spec {chunk!r}: unknown site {site!r} "
                f"(want one of {sorted(KNOWN_SITES)})"
            )
        if action not in ACTIONS:
            raise ValueError(
                f"fault spec {chunk!r}: unknown action {action!r} "
                f"(want one of {sorted(ACTIONS)})"
            )
        kw: dict = {}
        match: list[tuple[str, str]] = []
        for part in parts[2:]:
            if "=" not in part:
                raise ValueError(f"fault spec {chunk!r}: {part!r} is not k=v")
            k, v = part.split("=", 1)
            k = k.strip()
            if k == "count":
                kw["count"] = int(v)
            elif k == "after":
                kw["after"] = int(v)
            elif k == "delay_s":
                kw["delay_s"] = float(v)
            elif k == "rc":
                kw["rc"] = int(v)
            elif k == "p":
                kw["p"] = float(v)
            elif k in MATCH_KEYS:
                match.append((k, v.strip()))
            else:
                raise ValueError(
                    f"fault spec {chunk!r}: unknown key {k!r} (options: "
                    f"count/after/delay_s/rc/p or a match key from "
                    f"{sorted(MATCH_KEYS)})"
                )
        specs.append(
            FaultSpec(site=site, action=action, match=tuple(match), **kw)
        )
    return specs


class _Registry:
    def __init__(self, raw: str):
        self.raw = raw
        self.specs = parse_spec(raw)
        self.counts = [0] * len(self.specs)  # in-process match ordinals


_registry_cache: _Registry | None = None
_override: str | None = None


def configure(spec: str | None) -> None:
    """Set (or with None, clear) an explicit spec overriding the env --
    the test-side twin of exporting ``TPU_PATTERNS_FAULTS``."""
    global _override, _registry_cache
    _override = spec
    _registry_cache = None


def _get_registry() -> _Registry:
    global _registry_cache
    raw = _override if _override is not None else os.environ.get(ENV_SPEC, "")
    if _registry_cache is None or _registry_cache.raw != raw:
        _registry_cache = _Registry(raw)
    return _registry_cache


def active() -> bool:
    """Whether any fault spec is configured (cheap hot-path guard)."""
    return bool(
        _override if _override is not None else os.environ.get(ENV_SPEC)
    )


def _next_ordinal(reg: _Registry, idx: int) -> int:
    """The 0-based ordinal of this matched call for spec ``idx``:
    file-backed (flock'd read-increment-write) when a state dir is set,
    so ordinals are shared across every process of a chaos run."""
    state_dir = os.environ.get(ENV_STATE, "")
    if not state_dir:
        n = reg.counts[idx]
        reg.counts[idx] = n + 1
        return n
    import fcntl

    os.makedirs(state_dir, exist_ok=True)
    path = os.path.join(state_dir, f"fault{idx}.n")
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        raw = os.read(fd, 64)
        n = int(raw) if raw.strip() else 0
        os.lseek(fd, 0, os.SEEK_SET)
        os.ftruncate(fd, 0)
        os.write(fd, str(n + 1).encode())
        return n
    finally:
        os.close(fd)  # releases the lock


def _chance(spec: FaultSpec, ordinal: int) -> bool:
    seed = int(os.environ.get(ENV_SEED, "0"))
    return random.Random(f"{seed}:{spec.site}:{ordinal}").random() < spec.p


def _log_firing(spec: FaultSpec, ctx: dict) -> None:
    """WARNING Record + ring event + counter, BEFORE the action (a crash
    firing must still leave its trail).  Logging failures never mask or
    alter the injected behavior."""
    try:
        from tpu_patterns_torch import obs
        from tpu_patterns_torch.core.results import (
            Record,
            ResultWriter,
            Verdict,
        )

        obs.counter(
            "tpu_patterns_faults_injected_total",
            site=spec.site,
            action=spec.action,
        ).inc()
        obs.event("fault.injected", site=spec.site, action=spec.action, **{
            k: str(v) for k, v in ctx.items()
        })
        writer = ResultWriter(
            jsonl_path=os.path.join(obs.run_dir(), "faults.jsonl"),
            stream=sys.stderr,  # the action may be about to kill stdout
        )
        writer.record(Record(
            pattern="faults",
            mode=spec.site,
            commands=spec.action,
            metrics={"pid": float(os.getpid())},
            verdict=Verdict.WARNING,
            notes=[
                f"injected {spec.action!r} at site {spec.site!r} "
                f"(ctx={ctx!r})"
            ],
        ))
    except Exception:  # the module's contract: logging never masks the fault
        pass


def _act(spec: FaultSpec) -> FaultSpec:
    if spec.action == "error":
        raise InjectedFault(
            f"injected fault at {spec.site} (transient I/O)"
        )
    if spec.action == "crash":
        os._exit(spec.rc)
    if spec.action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    if spec.action in ("hang", "sleep"):
        time.sleep(spec.delay_s)  # the injected hang IS this sleep
    elif spec.action == "preempt":
        signal.raise_signal(signal.SIGTERM)
    # "nan" (and post-sleep/preempt): the call site interprets the spec
    return spec


def inject(site: str, **ctx) -> FaultSpec | None:
    """Consult the registry at a named fault site.

    Returns None when nothing fires.  A firing logs itself, then acts per
    the spec's action: ``error`` raises :class:`InjectedFault`;
    ``crash``/``kill`` never return; ``hang``/``sleep`` block then return
    the spec; ``nan``/``preempt`` return the spec for the site to
    interpret.
    """
    if not active():
        return None
    reg = _get_registry()
    for idx, spec in enumerate(reg.specs):
        if spec.site != site:
            continue
        if any(str(ctx.get(k)) != v for k, v in spec.match):
            continue
        ordinal = _next_ordinal(reg, idx)
        if ordinal < spec.after or ordinal >= spec.after + spec.count:
            continue
        if spec.p < 1.0 and not _chance(spec, ordinal):
            continue
        _log_firing(spec, ctx)
        return _act(spec)
    return None
