"""Multi-replica serving: N engine processes behind the prefix router.

The port's copy of ``tpu_patterns/serve/replica.py``.  One engine is one
failure domain: any fault that quarantines it takes everything down with
it.  This module runs ``--replicas N``
:class:`~tpu_patterns_torch.serve.engine.ServeEngine` instances, each in
its OWN process on a disjoint slice of the run's ranks
(``topo/placement.py::partition_devices``), fronted by the prefix-aware
router (``serve/router.py``) and settled through the shared runtime core
(``rt/``): one :class:`rt.LeaseTable` of in-flight requests per replica,
one :class:`rt.Breaker` per replica in the parent, and one inside each
child engine.  Each child's decode and verify steps launch the paged
attention kernel (``serve/csrc/paged_attention.cu``) on its own card, or
run its plain version when the fleet runs on the CPU; a child that was
asked for CUDA and finds no card fails its spawn.  Several replicas may
share one card, as the ranks of a rank mesh do: each child is a process
with its own CUDA context, and the contexts time-slice the card.

Protocol (line JSON; fd 1 is claimed for the protocol before torch is
imported, chatter goes to stderr, ``replica-<id>.log``):

  parent -> child : {"op":"init", replica, devices, sp, tp, cfg, role,
                     spool_dir, snapshot_dir, session_dir, warm,
                     obs_dir}
                    (first line; ``devices`` the slice's rank devices)
                    {"op":"req", rid, tokens, n_gen[, deadline_ms,
                     jid, scenario, priority, sampling fields]}
                    {"op":"adopt", m} | {"op":"prewarm", paths}
                    {"op":"fin"} | {"op":"drain"} |
                    {"op":"checkpoint"} | {"op":"shutdown"}
  child -> parent : {"ready": true, pid, replica, platform}
                    {"op":"first", rid} | {"op":"handoff", rid, m}
                    {"op":"done", rid, ids} |
                    {"op":"failed", rid, reason} | {"op":"shed", rid,
                     reason} | {"op":"hb", steps, tokens}
                    {"op":"obs", entries, metrics, backlog, clock}
                    {"op":"checkpointed", step}
                    {"op":"drained"|"quarantined", pending,
                     snapshot_step, stats}
                    {"op":"fin", stats}

Observability is multi-process too (``obs/fleet.py``): each child opens
its flight recorder against ``<obs_dir>/replica-<id>/`` and also streams
span/event/counter deltas to the parent at iteration boundaries over
the same pipe (bounded batches behind the ``replica.obs_ship`` site).
The parent persists shipped entries beside the child's own dumps,
merges child counters into ``tpu_patterns_fleet_*`` series, stamps a
fleet-unique journey id on every request at route time, and watchdogs
the obs channel: a replica whose heartbeat arrives but whose obs batches
stall past the deadline draws a ``watchdog_obs_stall`` WARNING.

The fail-over state machine:

  * a replica whose parent-side breaker OPENS (consecutive request
    failures) is QUARANTINED: out of the ring, then ``drain`` — the
    child stops at its next iteration boundary, snapshots, and hands
    back its pending rids;
  * a replica that DIES (SIGKILL, OOM, protocol EOF) or HANGS (no
    message inside the watchdog deadline while holding leases) is
    killed and settled from the parent's lease ledger alone, and the
    survivors are told to ``checkpoint``;
  * either way every released lease REROUTES (budget: one reroute a
    request) via the router's consistent ring, so only the lost
    replica's arc remaps.

Accounting is an identity: ``done + failed + rerouted (+ shed) ==
scheduled`` and ``leaked_blocks == 0`` across the fleet, with every
completed request's ids equal to its per-request dense decode.

The disaggregated split (``--disagg P:D``, ``roles``): admission routes
over a ring of the P prefill replicas only.  A prefill child prefills,
spools each request's prompt blocks under ``<work_dir>/spool`` and sends
the manifest up (``handoff``); the parent moves the lease to a decode
replica (plain rotation over the live ones), books the decision and
forwards the manifest (``adopt``); the decode child adopts the blocks
and decodes through the paged kernel.  A decode replica that dies holding
adopted rows fails over like any other: its rows reroute through the
prefill ring.  Every child sends ``first`` when a request's first token
reaches its host, so the parent stamps TTFT on its own clock for the
split fleet and the unified one alike (the disagg A/B Record).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import queue
import subprocess
import sys
import threading

import numpy as np

from tpu_patterns_torch import faults, obs, rt
from tpu_patterns_torch.core.timing import clock_ns
from tpu_patterns_torch.obs.fleet import FleetObs, new_journey_id
from tpu_patterns_torch.serve.elastic import (
    ElasticConfig,
    ElasticPolicy,
    FleetSignals,
)
from tpu_patterns_torch.serve.engine import Request
from tpu_patterns_torch.serve.router import Router

# the port's own flag: a port parent never starts a JAX child
ENV_FLAG = "_TPU_PATTERNS_TORCH_REPLICA"
# replica init = interpreter + torch import + device init + warm-up
READY_TIMEOUT_S = float(
    os.environ.get("TPU_PATTERNS_REPLICA_READY_S", "600")
)
_HB_NS = int(0.5e9)  # child heartbeat cadence


class ReplicaError(RuntimeError):
    """A replica died or broke protocol — the parent fails it over."""


# -- child side ------------------------------------------------------------


class _StdinSource:
    """The child engine's arrival source: requests stream in over stdin
    (a reader thread feeds the queue), completions and heartbeats stream
    back out — called once per scheduler iteration on the engine loop
    thread, so every send happens at a consistent iteration boundary."""

    def __init__(self, lines, engine, send, *, shipper=None,
                 dump_obs: bool = False):
        self._engine = engine
        self._send = send
        self._q: queue.Queue = queue.Queue()
        self.fin = False
        self.closed = False  # shutdown/EOF seen: the parent is done
        self.drain_requested = False
        self._reported_done: set[int] = set()
        self._reported_failed: set[int] = set()
        self._reported_shed: set[int] = set()
        self._reported_first: set[int] = set()
        self._reported_handoff: set[int] = set()
        self._last_hb_ns = 0
        # span/counter deltas ship at iteration boundaries; dump_obs banks
        # ring + metrics into the per-replica obs dir at checkpoint/exit
        # so a SIGKILLed child's partial history still merges from disk
        self._shipper = shipper
        self.dump_obs = dump_obs
        t = threading.Thread(target=self._read, args=(lines,), daemon=True)
        t.start()

    def _read(self, lines) -> None:
        for line in lines:
            if not line.strip():
                continue
            try:
                self._q.put(json.loads(line))
            except ValueError:
                self._q.put({"op": "_garbled"})
                return
        self._q.put({"op": "_eof"})

    def report(self) -> None:
        """Stream newly terminal requests and a bounded-rate heartbeat."""
        eng = self._engine
        # first-token instants ship before terminal buckets: the parent
        # clocks TTFT at receipt, and a request whose done lands in the
        # same batch must not read a first token after its last
        for rid in list(eng.first_ns):
            if rid not in self._reported_first:
                self._reported_first.add(rid)
                self._send({"op": "first", "rid": rid})
        # disagg handoffs (prefill role): the manifest goes up, so the
        # parent moves the lease and picks a decode replica to adopt it
        for rid in list(eng.handoffs):
            if rid not in self._reported_handoff:
                self._reported_handoff.add(rid)
                self._send({"op": "handoff", "rid": rid,
                            "m": eng.handoffs[rid]})
        for rid in list(eng.done):
            if rid not in self._reported_done:
                self._reported_done.add(rid)
                self._send({"op": "done", "rid": rid, "ids": eng.done[rid]})
        for rid in list(eng.failed):
            if rid not in self._reported_failed:
                self._reported_failed.add(rid)
                self._send({"op": "failed", "rid": rid,
                            "reason": eng.failed[rid]})
        # burn-ladder sheds are terminal child-side: the parent releases
        # the lease and the fleet identity still closes
        for rid in list(eng.shed):
            if rid not in self._reported_shed:
                self._reported_shed.add(rid)
                self._send({"op": "shed", "rid": rid,
                            "reason": eng.shed[rid]})
        now = clock_ns()
        if now - self._last_hb_ns >= _HB_NS:
            self._last_hb_ns = now
            self._send({"op": "hb", "steps": eng.stats["steps"],
                        "tokens": eng.stats["tokens"]})
        # obs shipping LAST: control traffic always goes first, and the
        # batch is bounded, so a chatty obs stream cannot starve it
        self._ship_obs()

    def _ship_obs(self) -> None:
        if self._shipper is None:
            return
        try:
            # the obs channel's site: an ``error`` drops this boundary's
            # batch (the parent's obs watchdog makes the stall visible)
            faults.inject("replica.obs_ship", replica=self._engine.replica)
            batch = self._shipper.batch()
            if batch is not None:
                self._send(batch)
        except faults.InjectedFault:
            pass  # suppressed batch: the ring and the child dir hold it

    def ship_tail(self, max_batches: int = 64) -> None:
        """Final flush before a terminal message: everything still in
        the tap plus the last metric deltas (bounded)."""
        if self._shipper is None:
            return
        try:
            faults.inject("replica.obs_ship", replica=self._engine.replica)
            for batch in self._shipper.drain(max_batches=max_batches):
                self._send(batch)
        except faults.InjectedFault:
            pass

    def __call__(self, idle: bool = False):
        self.report()
        batch = []
        block = idle and not self.fin
        while True:
            try:
                msg = (self._q.get(timeout=0.05) if block
                       else self._q.get_nowait())
            except queue.Empty:
                break
            block = False
            op = msg.get("op")
            if op == "req":
                batch.append(Request(
                    rid=int(msg["rid"]),
                    tokens=[int(t) for t in msg["tokens"]],
                    n_gen=int(msg["n_gen"]),
                    deadline_ms=float(msg.get("deadline_ms", 0.0)),
                    scenario=str(msg.get("scenario", "")),
                    jid=str(msg.get("jid", "")),
                    priority=str(msg.get("priority", "interactive")),
                    # per-request sampling rides the wire: a sampled
                    # request must not decode greedy in a child
                    temperature=float(msg.get("temperature", 0.0)),
                    top_k=int(msg.get("top_k", 0)),
                    top_p=float(msg.get("top_p", 1.0)),
                    seed=int(msg.get("seed", 0)),
                    gen_offset=int(msg.get("gen_offset", 0)),
                ))
            elif op == "adopt":
                # disagg: a handoff manifest the parent routed here, queued
                # for _admit_adopts at the next iteration head
                self._engine.adopt_queue.append(dict(msg["m"]))
            elif op == "prewarm":
                # scale-out pre-warm: fetch this replica's ring-arc store
                # prefixes into the host tier between engine iterations
                # (a failure is a cold start, never a torn block)
                self._engine.prewarm_paths(list(msg.get("paths", [])))
            elif op == "fin":
                self.fin = True
            elif op == "drain":
                # stop at the next iteration boundary through the
                # engine's preemption machinery: finish the step,
                # snapshot, return
                self.drain_requested = True
                self._engine._preempt.set()
            elif op == "checkpoint":
                # a precautionary snapshot (a sibling just died): the
                # source runs between iterations, so state is consistent
                if self._engine.snapshot_dir:
                    self._engine.snapshot()
                obs.counter(
                    "tpu_patterns_replica_drains_total",
                    replica=self._engine.replica, mode="checkpoint",
                ).inc()
                if self.dump_obs:
                    # bank ring + registry beside the snapshot: a later
                    # SIGKILL still leaves everything up to here on disk
                    obs.dump(reason="checkpoint")
                    obs.dump_metrics()
                    obs.dump_cost()
                self._send({"op": "checkpointed",
                            "step": self._engine.stats["steps"]})
            elif op in ("shutdown", "_eof", "_garbled"):
                # the parent is gone or done with us: stop taking work
                self.fin = True
                self.closed = True
        eng = self._engine
        if (self.fin and not batch and not eng.queue and not eng.active
                and not eng.adopt_queue):
            return None  # exhausted: the engine loop may exit
        return batch

    def wait_shutdown(self, timeout_s: float = 60.0) -> None:
        """Linger for the parent's shutdown op through the reader
        thread's queue (that thread still owns stdin)."""
        if self.closed:
            return
        deadline = clock_ns() + int(timeout_s * 1e9)
        while clock_ns() < deadline:
            try:
                msg = self._q.get(timeout=1.0)
            except queue.Empty:
                continue
            if msg.get("op") in ("shutdown", "drain", "_eof", "_garbled"):
                return


def _child_stats(eng) -> dict:
    from tpu_patterns_torch.serve.paged_kernel import paged_block

    return {
        "steps": eng.stats["steps"],
        "tokens": eng.stats["tokens"],
        "prefix_hit_blocks": eng.stats["prefix_hit_blocks"],
        "cow_copies": eng.stats["cow_copies"],
        "deferrals": eng.stats["deferrals"],
        "peak_blocks": eng.stats["peak_blocks"],
        "done": len(eng.done),
        "failed": len(eng.failed),
        "sheds": len(eng.shed),
        "preempted": eng.stats["preempted"],
        "preempted_resumed": eng.stats["preempted_resumed"],
        "handoffs": eng.stats["handoffs"],
        "handoff_recomputes": eng.stats["handoff_recomputes"],
        "transfer_bytes": eng.stats["transfer_bytes"],
        "adopts": eng.stats["adopts"],
        "adopted_blocks": eng.stats["adopted_blocks"],
        "adopt_recomputes": eng.stats["adopt_recomputes"],
        "store_publishes": eng.stats["store_publishes"],
        "store_publish_bytes": eng.stats["store_publish_bytes"],
        "store_hits": eng.stats["store_hits"],
        "store_fetch_bytes": eng.stats["store_fetch_bytes"],
        "store_prewarmed": eng.stats["store_prewarmed"],
        "store_fallbacks": eng.stats["store_fallbacks"],
        # per-rid fresh full prompt blocks (JSON keys are strings): the
        # warm-failover gate sums these over the REROUTED rids
        "fresh_full_blocks_by_rid": {
            str(rid): n for rid, n in eng.fresh_by_rid.items()
        },
        "leaked_blocks": eng.leaked_blocks(),
        # the paged kernel's launches in this child since its warm-up (0
        # on the CPU, where the plain version runs, and in a prefill-role
        # child, whose decoder runs the dense path)
        "paged_block_launches": paged_block.launches,
    }


def _child_engine(init: dict):
    """Build the child's engine on the slice ``init`` names and warm it
    on the parent's warm trace; returns (engine, platform)."""
    import torch

    from tpu_patterns_torch.comm.mesh import NamedMesh, RankMesh
    from tpu_patterns_torch.models.lm import init_lm_params
    from tpu_patterns_torch.models.transformer import ModelConfig
    from tpu_patterns_torch.obs.slo import SloConfig
    from tpu_patterns_torch.runtime import resolve_device
    from tpu_patterns_torch.serve.engine import ServeEngine
    from tpu_patterns_torch.serve.paged import make_paged_lm_decoder
    from tpu_patterns_torch.serve.paged_kernel import paged_block

    replica = str(init["replica"])
    cfg = init["cfg"]
    # raises on a CUDA request without a card: the spawn fails, nothing
    # falls back to the CPU
    dev = resolve_device(cfg["device"])
    devices = [torch.device(d) for d in init["devices"]]
    if any(d.type != dev.type for d in devices):
        raise ValueError(f"slice {init['devices']} is not on {dev.type}")
    if dev.type == "cuda":
        torch.cuda.set_device(devices[0])
    sp, tp = int(init["sp"]), int(init["tp"])
    mesh = NamedMesh(RankMesh(tuple(devices)), ("dp", "sp", "tp"),
                     (1, sp, tp))
    mcfg = ModelConfig(
        embed=cfg["embed"], heads=cfg["heads"], head_dim=cfg["head_dim"],
        mlp_mult=cfg["mlp_mult"], dtype=cfg["dtype"], depth=cfg["depth"],
        kv_heads=cfg["kv_heads"], rope=cfg["rope"],
    )
    role = str(init.get("role") or "")
    decoder = make_paged_lm_decoder(
        mcfg, cfg["vocab"], n_blocks=cfg["n_blocks"],
        block_len=cfg["block_len"], max_len=cfg["max_len"],
        cache_int8=cfg["cache_int8"],
        # a prefill-only pool never runs the decode/verify loop, so it
        # takes the dense path: the decode kernel is not its to launch
        attn="dense" if role == "prefill" else cfg["paged_attn"],
        # greedy rows through a sampling decoder stay bit-identical
        sampling=bool(cfg.get("sampling", False)),
        device=devices[0], mesh=mesh,
    )
    # the SAME seed in every replica: identical weights, so a rerouted
    # request decodes to the same ids anywhere
    params = decoder.stack_params(
        init_lm_params(cfg["seed"], mcfg, cfg["vocab"], devices[0])
    )
    tiered = bool(cfg.get("kv_host_tier"))

    def make_engine(warming: bool = False):
        return ServeEngine(
            decoder, params, slots=cfg["slots"],
            watchdog_s=cfg["watchdog_s"],
            snapshot_dir=None if warming else init.get("snapshot_dir"),
            prefix_share=cfg["prefix_share"], spec_k=cfg["spec_k"],
            kv_host_tier=tiered,
            host_tier_blocks=cfg.get("host_tier_blocks", 0),
            # a drained replica banks its warm prefixes in its session
            # dir; the warm-up engine must not
            session_dir=None if warming else init.get("session_dir"),
            fingerprint=(
                {k: cfg[k] for k in (
                    "vocab", "embed", "heads", "head_dim", "mlp_mult",
                    "depth", "dtype", "rope", "kv_heads", "cache_int8",
                    "block_len", "seed",
                )} if tiered else None
            ),
            preempt=cfg.get("preempt", "off"),
            burn_mitigation=cfg.get("burn_mitigation", "off"),
            slo=SloConfig(
                fast_window_s=cfg.get("slo_fast_s", 60.0),
                slow_window_s=cfg.get("slo_slow_s", 300.0),
                budget=cfg.get("slo_budget", 0.1),
                multiplier=cfg.get("burn_multiplier", 2.0),
            ),
            breaker=rt.Breaker(
                threshold=2, gauge="tpu_patterns_replica_breaker_open",
                replica=replica,
            ),
            replica=replica,
            # the warm-up engine neither publishes its throwaway traffic
            # nor fetches real blocks into an engine about to be dropped
            prefix_store=(None if warming
                          else (cfg.get("prefix_store") or None)),
            # the warm-up engine serves its trace to the end itself: a
            # prefill role would spool the warm requests instead
            role="" if warming else role,
            spool_dir=None if warming else init.get("spool_dir"),
        )

    # warm-up: serve the parent's warm trace through a throwaway engine
    # (library loads, allocator and kernel caches) before "ready", so the
    # scaling Record measures serving
    warm = init.get("warm") or []
    if warm:
        weng = make_engine(warming=True)
        # infrastructure, not serving: a chaos spec neither fires here
        # nor has its ordinals consumed here
        faults.configure("")
        try:
            weng.run([Request(rid=i, tokens=list(t), n_gen=int(g))
                      for i, (t, g) in enumerate(warm)])
        finally:
            faults.configure(None)
        # nor may its spans and counters pollute the serving obs: the
        # shipped serve_* totals must reproduce the front door's ledger
        obs.flight_recorder().clear()
        obs.metrics_registry().clear()
    paged_block.launches = 0  # count the serving run's launches only
    return make_engine(), ("gpu" if dev.type == "cuda" else "cpu")


def replica_main(proto_fd: int | None = None) -> int:
    """Child entry (``_TPU_PATTERNS_TORCH_REPLICA=1``, dispatched by
    ``__main__.py`` before the CLI import, which passes the protocol fd
    it claimed before torch was imported): build the engine on the
    assigned slice, warm it, then serve stdin."""
    if proto_fd is None:
        # claim the protocol channel; stray prints land on stderr
        proto_fd = os.dup(1)
        os.dup2(2, 1)
    proto_out = os.fdopen(proto_fd, "w")

    def send(obj: dict) -> None:
        proto_out.write(json.dumps(obj) + "\n")
        proto_out.flush()

    init = json.loads(sys.stdin.readline())
    replica = str(init["replica"])
    # this child's flight-recorder dumps, crash dumps and metrics land in
    # <obs_dir>/replica-<id>/, where the fleet merge finds them even if
    # the process dies
    obs_dir = init.get("obs_dir") or None
    if obs_dir:
        obs.configure(obs_dir)
        obs.install_crash_handlers()
    try:
        eng, platform = _child_engine(init)
    except Exception as e:  # init must answer, not hang the parent
        send({"ready": False, "error": f"{type(e).__name__}: {e}"})
        return 1
    send({"ready": True, "pid": os.getpid(), "replica": replica,
          "platform": platform})
    from tpu_patterns_torch.obs import fleet as obs_fleet

    source = _StdinSource(sys.stdin, eng, send,
                          shipper=obs_fleet.ObsShipper(),
                          dump_obs=bool(obs_dir))
    eng.run([], source=source)
    source.report()  # flush the tail
    source.ship_tail()
    if obs_dir:
        obs.dump(reason="end_of_run")
        obs.dump_metrics()
        obs.dump_cost()
    pending = [r.rid for r, _ in eng.queue] + [s.rid for s in eng.active]
    if eng.breaker_tripped:
        # a sick engine: bank what it holds, hand the rest back
        step = -1
        if eng.snapshot_dir:
            eng.snapshot()
            step = eng.stats["steps"]
        send({
            "op": "quarantined", "pending": pending,
            "snapshot_step": step, "stats": _child_stats(eng),
            "reason": "engine breaker open "
                      "(consecutive decode-wave failures)",
        })
    elif source.drain_requested:
        send({
            "op": "drained", "pending": pending,
            "snapshot_step": (eng.preempted_at
                              if eng.preempted_at is not None else -1),
            "stats": _child_stats(eng),
        })
    else:
        send({"op": "fin", "stats": _child_stats(eng)})
    # linger for the shutdown op (or EOF) so the parent reads the last
    # message before the pipe closes
    source.wait_shutdown()
    return 0


# -- parent side -----------------------------------------------------------


class ReplicaHandle:
    """Parent-side view of one replica process: the protocol pipe, the
    in-flight lease ledger, and the health breaker."""

    def __init__(self, replica_id: str, proc, inbox: queue.Queue):
        self.id = replica_id
        self.proc = proc
        self.state = "spawning"  # ready|quarantined|drained|dead|done
        self.leases = rt.LeaseTable()
        self.breaker = rt.Breaker(
            threshold=2, gauge="tpu_patterns_replica_breaker_open",
            replica=replica_id,
        )
        self.last_msg_ns = clock_ns()
        # the obs-channel watchdog's clock: any hb proves the child
        # alive, only obs batches prove the shipping healthy
        self.last_obs_ns = clock_ns()
        self.obs_stalled = False  # the stall WARNING fires once a replica
        self.stats: dict = {}
        self.tentative_failed: dict[int, str] = {}
        self.snapshotted = False
        self._reader = threading.Thread(target=self._read, args=(inbox,),
                                        daemon=True)
        self._reader.start()

    def _read(self, inbox: queue.Queue) -> None:
        try:
            for line in self.proc.stdout:
                if not line.strip():
                    continue
                try:
                    inbox.put((self.id, json.loads(line)))
                except ValueError:
                    inbox.put((self.id, {"op": "_garbled"}))
                    return
        except (ValueError, OSError):
            pass
        inbox.put((self.id, {"op": "_eof"}))

    def send(self, obj: dict) -> None:
        try:
            self.proc.stdin.write(json.dumps(obj) + "\n")
            self.proc.stdin.flush()
        except (BrokenPipeError, OSError, ValueError) as e:
            raise ReplicaError(f"replica {self.id}: pipe closed: {e}") from e

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        from tpu_patterns_torch.exec import proc as _proc

        _proc.kill_process_group(self.proc)
        try:
            self.proc.wait(timeout=10)
        except (OSError, subprocess.TimeoutExpired):
            pass  # already reaped, or wedged in D-state
        for f in (self.proc.stdin, self.proc.stdout):
            close = getattr(f, "close", None)
            try:
                if close is not None:
                    close()
            except OSError:
                pass


@dataclasses.dataclass
class FleetResult:
    """One fleet run, settled: every scheduled rid is in exactly one
    terminal bucket (``done`` holds ids for rerouted completions too —
    ``rerouted`` marks which rids took the detour)."""

    scheduled: int = 0
    done: dict[int, list[int]] = dataclasses.field(default_factory=dict)
    failed: dict[int, str] = dataclasses.field(default_factory=dict)
    # burn-ladder sheds are a terminal bucket fleet-wide
    shed: dict[int, str] = dataclasses.field(default_factory=dict)
    rerouted: set[int] = dataclasses.field(default_factory=set)
    # elastic controller actions: (t_s on the fleet clock, "out"|"in",
    # replica id), also booked as tpu_patterns_fleet_scale_events_total
    scale_events: list[tuple[float, str, str]] = dataclasses.field(
        default_factory=list
    )
    requests_by_rid: dict[int, Request] = dataclasses.field(
        default_factory=dict
    )
    t_done_ns: dict[int, int] = dataclasses.field(default_factory=dict)
    # front-door first-token instants, stamped on the PARENT clock when a
    # child's ``first`` op arrives: the TTFT ledger the disagg A/B gates
    # (the same measurement for a unified and a split fleet)
    t_first_ns: dict[int, int] = dataclasses.field(default_factory=dict)
    # rids that crossed the prefill->decode wire (recompute degradations
    # included: they crossed as manifests)
    handoff_rids: set[int] = dataclasses.field(default_factory=set)
    arrival_ms: dict[int, float] = dataclasses.field(default_factory=dict)
    t0_ns: int = 0
    wall_s: float = 0.0
    drains: int = 0
    spawn_retries: int = 0
    replica_stats: dict[str, dict] = dataclasses.field(
        default_factory=dict
    )
    router_routed: int = 0
    router_prefix_hits: int = 0
    router_reroutes: int = 0
    # fleet observability settlement (obs/fleet.py)
    shipped_done: float = 0.0
    shipped_failed: float = 0.0
    mirror_mismatches: list[str] = dataclasses.field(default_factory=list)
    obs_stalls: int = 0

    def covered(self) -> bool:
        buckets = (set(self.done), set(self.failed), set(self.shed))
        union = set().union(*buckets)
        return union == set(range(self.scheduled)) and sum(
            len(b) for b in buckets
        ) == len(union)

    def _stat(self, key: str) -> int:
        """``key`` summed over every engine that reported (a SIGKILLed
        replica's pool died with its process: nothing to count)."""
        return int(sum(s.get(key, 0) for s in self.replica_stats.values()))

    def leaked_blocks(self) -> int:
        return self._stat("leaked_blocks")

    def prefix_hit_blocks(self) -> int:
        return self._stat("prefix_hit_blocks")

    def tokens(self) -> int:
        return sum(len(ids) for ids in self.done.values())

    def preempted(self) -> int:
        return self._stat("preempted")

    def preempted_resumed(self) -> int:
        return self._stat("preempted_resumed")

    def handoffs(self) -> int:
        """Prefill->decode handoffs (recompute degradations included)."""
        return self._stat("handoffs")

    def adopts(self) -> int:
        return self._stat("adopts")

    def adopted_blocks(self) -> int:
        return self._stat("adopted_blocks")

    def transfer_bytes(self) -> int:
        return self._stat("transfer_bytes")

    def disagg_recomputes(self) -> int:
        """Handoffs that degraded to a re-prefill on either side of the
        wire: bounded recompute, never a torn block."""
        return self._stat("handoff_recomputes") + self._stat(
            "adopt_recomputes")

    def store_publishes(self) -> int:
        return self._stat("store_publishes")

    def store_publish_bytes(self) -> int:
        return self._stat("store_publish_bytes")

    def store_hits(self) -> int:
        return self._stat("store_hits")

    def store_fetch_bytes(self) -> int:
        return self._stat("store_fetch_bytes")

    def store_prewarmed(self) -> int:
        return self._stat("store_prewarmed")

    def store_fallbacks(self) -> int:
        return self._stat("store_fallbacks")

    def paged_block_launches(self) -> dict[str, int]:
        """The paged kernel's launches by replica, as each reported."""
        return {r: int(s.get("paged_block_launches", 0))
                for r, s in sorted(self.replica_stats.items())}

    def rerouted_fresh_blocks(self) -> int:
        """Fresh full prompt blocks the REROUTED requests prefilled after
        fail-over: with the fleet store on, this drops strictly below the
        private-tier baseline."""
        total = 0
        for s in self.replica_stats.values():
            by_rid = s.get("fresh_full_blocks_by_rid", {})
            total += sum(int(n) for rid, n in by_rid.items()
                         if int(rid) in self.rerouted)
        return total

    def scale_outs(self) -> int:
        return sum(1 for _, a, _ in self.scale_events if a == "out")

    def scale_ins(self) -> int:
        return sum(1 for _, a, _ in self.scale_events if a == "in")

    def counts(self) -> dict:
        """The identity the Records gate: done + failed + shed + rerouted
        == scheduled (the direct outcomes; a rerouted rid lands in
        ``rerouted`` whatever its second act was)."""
        return {
            "done": len(set(self.done) - self.rerouted),
            "failed": len(set(self.failed) - self.rerouted),
            "shed": len(set(self.shed) - self.rerouted),
            "rerouted": len(self.rerouted),
            "done_total": len(self.done),
            "failed_total": len(self.failed),
            "shed_total": len(self.shed),
        }


def _child_env(base_env: dict) -> dict:
    """The child's environment: the port's flag, and this tree's package
    first on the path, so a child imports the parent's package (the
    checkout the parent runs from), not another on the path."""
    import tpu_patterns_torch

    root = os.path.dirname(
        os.path.dirname(os.path.abspath(tpu_patterns_torch.__file__))
    )
    path = base_env.get("PYTHONPATH", "")
    return {**base_env, ENV_FLAG: "1",
            "PYTHONPATH": root + (os.pathsep + path if path else "")}


class ReplicaManager:
    """Spawns, routes to, watches, drains and settles a replica fleet
    (the module docstring has the fail-over state machine)."""

    # how many store blocks a pre-warm ships to one newcomer: enough for
    # its arc's hot prefixes, few enough not to crowd out its first
    # routed requests
    PREWARM_CAP = 64

    def __init__(
        self,
        n: int,
        *,
        base_env: dict,
        work_dir: str,
        child_cfg: dict,
        device_slices: list[list[str]],
        sp: int,
        tp: int,
        policy: str = "prefix",
        route_blocks: int = 2,
        vnodes: int = 64,
        watchdog_s: float = 120.0,
        obs_watchdog_s: float | None = None,
        obs_base: str | None = None,
        warm: list | None = None,
        retry_policy=None,
        elastic: ElasticConfig | None = None,
        roles: dict[str, str] | None = None,
    ):
        if n < 1:
            raise ValueError(f"replicas must be >= 1, got {n}")
        # the disaggregated fleet: replica id -> "prefill" | "decode".
        # Admission routes over the prefill ring only; decode replicas take
        # work only through handoff adoption
        self.roles = dict(roles or {})
        if self.roles:
            if elastic is not None:
                raise ValueError(
                    "disagg and elastic are mutually exclusive: the scale "
                    "controller reasons about one homogeneous pool of "
                    "slots"
                )
            by_role = {"prefill": [], "decode": []}
            for r in range(n):
                role = self.roles.get(str(r), "")
                if role not in by_role:
                    raise ValueError(
                        f"replica {r}: role must be prefill | decode, got "
                        f"{role!r}"
                    )
                by_role[role].append(str(r))
            if not by_role["prefill"] or not by_role["decode"]:
                raise ValueError(
                    "disagg needs at least one prefill and one decode "
                    f"replica, got {len(by_role['prefill'])}:"
                    f"{len(by_role['decode'])}"
                )
        # the handoff target's cursor: plain rotation over the live decode
        # replicas (adopted tables are all fresh: no affinity to keep)
        self._decode_rr = 0
        # the elastic fleet: the ring is built over ALL n + reserve ids up
        # front with the reserves quarantined — scale-out is ring.restore
        # (only the reserve's own arc remaps), scale-in the drain path
        self.elastic: ElasticPolicy | None = None
        self._spare: list[int] = []
        n_total = n
        if elastic is not None and elastic.reserve > 0:
            self.elastic = ElasticPolicy(elastic)
            n_total = n + elastic.reserve
            self._spare = list(range(n, n_total))
        if len(device_slices) < n_total:
            raise ValueError(
                f"{n} replicas + {n_total - n} reserve(s) need {n_total} "
                f"device slices, got {len(device_slices)}"
            )
        self.n = n
        self.base_env = dict(base_env)
        self.work_dir = work_dir
        self.child_cfg = dict(child_cfg)
        self.device_slices = [list(s) for s in device_slices[:n_total]]
        self.sp, self.tp = sp, tp
        self.watchdog_s = watchdog_s
        self.warm = warm or []
        self.retry_policy = retry_policy or rt.RetryPolicy(
            max_attempts=2, backoff_base_s=0.1
        )
        self.router = Router(
            [str(r) for r in range(n_total)
             if not self.roles or self.roles.get(str(r)) == "prefill"],
            block_len=int(child_cfg["block_len"]), policy=policy,
            route_blocks=route_blocks, vnodes=vnodes,
        )
        for r in self._spare:
            # reserved slices are ring members but not routable until the
            # elastic controller spawns them
            self.router.quarantine(str(r))
        # the fleet's decision ledger: scale out/in, reroutes and
        # pre-warms, with the signals that drove them
        from tpu_patterns_torch.obs.decisions import DecisionLedger

        self.decisions = DecisionLedger()
        self.inbox: queue.Queue = queue.Queue()
        self.handles: dict[str, ReplicaHandle] = {}
        self.spawn_retries = 0
        self.drains = 0
        # shipped batches land here; obs_base None = in memory only. The
        # obs watchdog defaults to the liveness deadline
        self.obs_watchdog_s = (watchdog_s if obs_watchdog_s is None
                               else obs_watchdog_s)
        self.fleet_obs = FleetObs(obs_base)
        self.obs_stalls = 0

    # -- lifecycle -------------------------------------------------------

    def _popen(self, r: int):
        """Fork replica ``r``'s process: ``python -m tpu_patterns_torch``
        under the port's flag, stderr to ``replica-<r>.log``."""
        from tpu_patterns_torch.exec import proc as _proc

        stderr_path = os.path.join(self.work_dir, f"replica-{r}.log")
        with open(stderr_path, "ab") as stderr_f:
            return _proc.popen_in_group(
                [*_proc.python_argv(), "-m", "tpu_patterns_torch"],
                env=_child_env(self.base_env),
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=stderr_f, text=True,
            )

    def _spawn_one(self, r: int) -> ReplicaHandle:
        rid = str(r)
        os.makedirs(self.work_dir, exist_ok=True)
        spool_dir = None
        if self.roles:
            # the handoff spool: prefill children write payloads here (tmp
            # + atomic rename), decode children adopt and unlink them
            spool_dir = os.path.join(self.work_dir, "spool")
            os.makedirs(spool_dir, exist_ok=True)
        attempts = {"n": 0}

        def attempt():
            attempts["n"] += 1
            # before the fork: an ``error`` is a failed exec, retried
            # under the replica policy
            faults.inject("replica.spawn", replica=rid)
            return self._popen(r)

        proc = faults.call_with_retry(
            attempt, policy=self.retry_policy, site="replica.spawn",
            retry_on=(OSError,),
        )
        self.spawn_retries += attempts["n"] - 1
        obs.counter("tpu_patterns_replica_spawns_total", replica=rid).inc()
        handle = ReplicaHandle(rid, proc, self.inbox)
        handle.send({
            "op": "init", "replica": rid,
            "devices": self.device_slices[r],
            "sp": self.sp, "tp": self.tp,
            "cfg": self.child_cfg,
            "role": self.roles.get(rid, ""),
            "spool_dir": spool_dir,
            "snapshot_dir": os.path.join(self.work_dir,
                                         f"replica-{rid}-snap"),
            # the per-replica session bank (kv tier only): a drained
            # replica commits its warm prefixes here, a later spawn on the
            # same slice id resumes them
            "session_dir": (
                os.path.join(self.work_dir, f"replica-{rid}-sessions")
                if self.child_cfg.get("kv_host_tier") else None
            ),
            "warm": self.warm,
            "obs_dir": (self.fleet_obs.replica_dir(rid)
                        if self.fleet_obs.obs_base is not None else None),
        })
        return handle

    def spawn_all(self) -> None:
        """Spawn every replica, then await all ready handshakes: the N
        inits (torch import, device init, warm-up) run in parallel."""
        # this fleet owns the replica-* namespace under its obs base
        self.fleet_obs.reset_base()
        for r in range(self.n):
            self.handles[str(r)] = self._spawn_one(r)
        waiting = set(self.handles)
        deadline = clock_ns() + int(READY_TIMEOUT_S * 1e9)
        while waiting:
            timeout = max(0.05, (deadline - clock_ns()) / 1e9)
            try:
                rid, msg = self.inbox.get(timeout=timeout)
            except queue.Empty:
                raise ReplicaError(
                    f"replica(s) {sorted(waiting)} not ready within "
                    f"{READY_TIMEOUT_S:.0f}s — see "
                    f"{self.work_dir}/replica-*.log"
                ) from None
            if msg.get("ready") is True and rid in waiting:
                self.handles[rid].state = "ready"
                self.handles[rid].last_msg_ns = clock_ns()
                waiting.discard(rid)
            elif msg.get("ready") is False or msg.get("op") == "_eof":
                raise ReplicaError(
                    f"replica {rid} failed init: "
                    f"{msg.get('error', 'died before ready')} — see "
                    f"{self.work_dir}/replica-{rid}.log"
                )

    def shutdown(self) -> None:
        for h in self.handles.values():
            try:
                h.send({"op": "shutdown"})
            except ReplicaError:
                pass  # already dead: the kill below settles it
        for h in self.handles.values():
            h.kill()
        self.fleet_obs.close()

    # -- fail-over -------------------------------------------------------

    def _live(self) -> list[ReplicaHandle]:
        return [h for h in self.handles.values() if h.state == "ready"]

    def _settle_leases(self, h: ReplicaHandle, res: FleetResult) -> None:
        """Release EVERY lease the replica held and reroute it, plus every
        row it tentatively failed while going down."""
        redo = dict(h.leases.release_all())
        for rid in h.tentative_failed:
            redo.setdefault(rid, None)
        h.tentative_failed = {}
        for rid, meta in sorted(redo.items()):
            self._reroute(rid, meta if isinstance(meta, Request) else None,
                          res)

    def _reroute(self, rid: int, req, res: FleetResult) -> None:
        if req is None:
            req = res.requests_by_rid.get(rid)
        if (req is None or rid in res.done or rid in res.failed
                or rid in res.shed):
            return
        if rid in res.rerouted:
            # the reroute budget is spent: a request that failed over
            # twice is deterministically broken, not unlucky
            res.failed[rid] = (
                "rerouted replica failed too — reroute budget spent"
            )
            return
        res.rerouted.add(rid)
        try:
            target = self.router.fallback(rid, req.tokens)
        except RuntimeError as e:
            res.failed[rid] = str(e)
            return
        # one decision per fallback pick (the identity with
        # tpu_patterns_router_reroutes_total)
        self.decisions.book(
            "reroute", rid=rid, jid=req.jid,
            rationale="replica lost the request mid-flight; rerouted to "
                      "the ring fallback",
            target=target, live=len(self._live()),
        )
        h = self.handles[target]
        if h.state != "ready":
            res.failed[rid] = (
                f"no serving replica left to reroute to (survivor "
                f"{target} already finished)"
            )
            return
        try:
            h.leases.acquire(rid, meta=req)
            h.send(_req_msg(req))
        except ReplicaError:
            self._replica_down(h, "send failed mid-reroute", res)
        obs.event("replica.reroute", rid=str(rid), replica=target,
                  jid=req.jid)
        if req.jid:
            # the journey anchor of the reroute leg
            obs.event("journey.reroute", jid=req.jid, rid=str(rid),
                      replica=target)

    def _quarantine(self, h: ReplicaHandle, res: FleetResult) -> None:
        """The parent-side breaker opened on ``h``: out of the ring, then
        DRAIN — or, if it will not even take the drain, the hammer."""
        if h.state != "ready":
            return
        h.state = "quarantined"
        self.router.quarantine(h.id)
        obs.counter("tpu_patterns_replica_quarantines_total",
                    replica=h.id).inc()
        obs.event("replica.quarantine", replica=h.id)
        try:
            # an ``error`` here is an unresponsive replica: like death
            faults.inject("replica.drain", replica=h.id)
            h.send({"op": "drain"})
        except (faults.InjectedFault, ReplicaError):
            h.state = "dead"
            h.kill()
            self._settle_leases(h, res)
            return
        # the rows it already failed reroute now; rows in flight keep
        # their leases until the drained handback (or EOF) settles them
        redo = dict(h.tentative_failed)
        h.tentative_failed = {}
        for rid in sorted(redo):
            self._reroute(rid, None, res)

    def _replica_down(self, h: ReplicaHandle, why: str,
                      res: FleetResult) -> None:
        """An unexpected death (or hang): kill the group, settle its
        ledger, and have the survivors checkpoint."""
        if h.state in ("dead", "drained"):
            return
        h.state = "dead"
        self.router.quarantine(h.id)
        h.kill()
        obs.counter("tpu_patterns_replica_failovers_total",
                    replica=h.id).inc()
        obs.event("replica.down", replica=h.id, why=why)
        self._settle_leases(h, res)
        for s in list(self._live()):
            try:
                faults.inject("replica.drain", replica=s.id)
                s.send({"op": "checkpoint"})
            except (faults.InjectedFault, ReplicaError):
                self._replica_down(s, "checkpoint request failed", res)

    # -- elastic scaling -------------------------------------------------

    def _elastic_tick(self, now_s: float, res: FleetResult) -> None:
        """One poll of the scale policy: the parent's lease ledger IS the
        occupancy signal (queued + active work per live replica slot)."""
        if self.elastic is None:
            return
        sig = FleetSignals(
            leases=sum(len(h.leases) for h in self.handles.values()),
            pending=0,  # the fleet loop dispatches due arrivals first
            live=len(self._live()),
            spare=len(self._spare),
            slots=int(self.child_cfg["slots"]),
        )
        action = self.elastic.decide(now_s, sig)
        if action == "out":
            self._scale_out(now_s, res, sig)
        elif action == "in":
            self._scale_in(now_s, res, sig)

    def _scale_inputs(self, sig: FleetSignals | None) -> dict:
        """The occupancy window's values that drove a scale decision."""
        if sig is None:
            return {}
        out = {
            "occupancy": round(sig.occupancy(), 4),
            "leases": sig.leases, "live": sig.live,
            "spare": sig.spare, "slots": sig.slots,
        }
        if self.elastic is not None:
            cfg = self.elastic.cfg
            out["out_occupancy"] = cfg.out_occupancy
            out["in_occupancy"] = cfg.in_occupancy
            out["sustain_s"] = cfg.sustain_s
        return out

    def _scale_out(self, now_s: float, res: FleetResult,
                   sig: FleetSignals | None = None) -> None:
        """Spawn a replica on the next reserved slice.  This only forks
        and sends init: the child joins the ring when its ready handshake
        lands in :meth:`_handle`, warmed up."""
        r = self._spare[0]
        rid = str(r)
        try:
            # an ``error`` aborts this attempt; the policy re-decides
            # after its cooldown
            faults.inject("fleet.scale_out", replica=rid)
        except faults.InjectedFault:
            return
        try:
            handle = self._spawn_one(r)
        except (faults.Quarantined, OSError):
            return  # spawn retries exhausted; the slice stays reserved
        self._spare.pop(0)
        self.handles[rid] = handle
        res.scale_events.append((round(now_s, 3), "out", rid))
        obs.counter("tpu_patterns_fleet_scale_events_total",
                    action="out", replica=rid).inc()
        obs.event("fleet.scale_out", replica=rid)
        self.decisions.book(
            "scale_out",
            rationale="sustained occupancy above the scale-out threshold; "
                      "spawning on the reserved slice",
            target=rid, **self._scale_inputs(sig),
        )

    def _scale_in(self, now_s: float, res: FleetResult,
                  sig: FleetSignals | None = None) -> None:
        """Drain the COLDEST live replica (fewest leases; ties retire
        elastic spawns first) through the drain-to-snapshot path: its
        in-flight leases reroute on the handback and its session bank
        keeps its warm prefixes."""
        live = self._live()
        if not live:
            return
        h = min(live, key=lambda x: (len(x.leases), -int(x.id)))
        try:
            faults.inject("fleet.scale_in", replica=h.id)
        except faults.InjectedFault:
            return
        res.scale_events.append((round(now_s, 3), "in", h.id))
        obs.counter("tpu_patterns_fleet_scale_events_total",
                    action="in", replica=h.id).inc()
        obs.event("fleet.scale_in", replica=h.id)
        self.decisions.book(
            "scale_in",
            rationale="sustained occupancy below the scale-in threshold; "
                      "draining the coldest live replica",
            target=h.id, **self._scale_inputs(sig),
        )
        h.state = "quarantined"  # drains like one; the handback settles
        self.router.quarantine(h.id)
        try:
            faults.inject("replica.drain", replica=h.id)
            h.send({"op": "drain"})
        except (faults.InjectedFault, ReplicaError):
            h.state = "dead"
            h.kill()
            self._settle_leases(h, res)

    # -- the fleet loop --------------------------------------------------

    def serve(self, timed: list[tuple[float, Request]]) -> FleetResult:
        """Serve ``timed`` [(arrival_s, request)] to settlement: every rid
        ends in done, failed or shed, whatever the replicas do."""
        from tpu_patterns_torch.obs import live as obs_live

        res = FleetResult(scheduled=len(timed),
                          requests_by_rid={r.rid: r for _, r in timed})
        pending = collections.deque(
            sorted(timed, key=lambda ar: (ar[0], ar[1].rid))
        )
        # while the fleet serves, /healthz and /statusz answer with one
        # lane per replica
        obs_live.attach_fleet(self)
        res.t0_ns = t0 = clock_ns()

        def outstanding() -> int:
            return sum(len(h.leases) for h in self.handles.values())

        try:
            while pending or outstanding():
                now_s = (clock_ns() - t0) / 1e9
                while pending and pending[0][0] <= now_s:
                    _, req = pending.popleft()
                    self._dispatch(req, res)
                self._elastic_tick(now_s, res)
                if not pending and not outstanding():
                    break
                wait = 0.25
                if pending:
                    wait = min(wait,
                               max(pending[0][0] - now_s, 0.0) + 1e-3)
                try:
                    rid, msg = self.inbox.get(timeout=wait)
                except queue.Empty:
                    self._check_watchdogs(res)
                    continue
                self._handle(rid, msg, res)
                if not self.router.live() and not self._spare and (
                    pending or outstanding()
                ):
                    # the whole fleet is gone: settle what remains as
                    # failed so the identity still closes
                    for r in res.requests_by_rid:
                        if (r not in res.done and r not in res.failed
                                and r not in res.shed):
                            res.failed[r] = "no live replica left"
                    pending.clear()
                    break
        finally:
            obs_live.detach_fleet(self)
        self._finish(res)
        res.wall_s = (clock_ns() - t0) / 1e9
        res.drains = self.drains
        res.spawn_retries = self.spawn_retries
        res.router_routed = self.router.routed
        res.router_prefix_hits = self.router.prefix_hits
        res.router_reroutes = self.router.reroutes
        # mirrors reconcile against the shipped truth, and the shipped
        # child metrics must reproduce the front door's accounting
        res.mirror_mismatches = self.fleet_obs.reconcile()
        res.shipped_done = self.fleet_obs.total(
            "tpu_patterns_serve_requests_total"
        )
        res.shipped_failed = self.fleet_obs.total(
            "tpu_patterns_serve_quarantined_total"
        )
        res.obs_stalls = self.obs_stalls
        return res

    def _send_prewarm(self, h: ReplicaHandle, res: FleetResult) -> None:
        """Ship a just-joined replica its ring arc's hottest fleet-store
        prefixes: the parent picks PATHS (the store directory scanned,
        the paths whose router fingerprint lands on ``h``'s arc, hottest
        first by commit stamp, closed over their ancestors) and sends one
        ``prewarm`` op; the child fetches and validates the bytes."""
        from tpu_patterns_torch.serve.router import prefix_fingerprint
        from tpu_patterns_torch.serve.store import scan

        entries = scan(self.child_cfg["prefix_store"])
        bl = self.router.block_len
        stamp = dict(entries)
        mine = [
            (path, st) for path, st in entries
            if self.router.ring.lookup(prefix_fingerprint(
                list(path), bl, self.router.route_blocks)) == h.id
        ]
        picked: set[tuple[int, ...]] = set()
        for path, _ in sorted(mine, key=lambda e: -e[1]):
            if len(picked) >= self.PREWARM_CAP:
                break
            # ancestor closure: a child block adopts only once every
            # ancestor has
            for k in range(bl, len(path) + 1, bl):
                if path[:k] in stamp:
                    picked.add(path[:k])
        if not picked:
            return
        paths = sorted(picked, key=lambda p: (len(p), p))
        try:
            h.send({"op": "prewarm", "paths": [list(p) for p in paths]})
        except ReplicaError:
            self._replica_down(h, "send failed", res)
            return
        obs.event("fleet.prewarm", replica=h.id, blocks=len(paths))
        obs.counter("tpu_patterns_fleet_prewarms_total").inc()
        self.decisions.book(
            "prewarm",
            rationale="scale-out replica joined the ring; shipping its "
                      "arc's hottest fleet-store prefixes so its first "
                      "routed requests land warm",
            target=h.id, blocks=len(paths),
        )

    def _dispatch(self, req: Request, res: FleetResult) -> None:
        # the journey id is stamped at ROUTE time and rides the request
        # through submit and any reroute
        if not req.jid:
            req.jid = new_journey_id()
        try:
            target = self.router.route(req.rid, req.tokens)
        except faults.InjectedFault:
            # the routing decision itself faulted: fall back to any live
            # replica, counted as a reroute
            try:
                target = self.router.fallback(req.rid, req.tokens)
            except RuntimeError as e:
                res.failed[req.rid] = str(e)
                return
            self.decisions.book(
                "reroute", rid=req.rid, jid=req.jid,
                rationale="primary route choice faulted at the router; "
                          "fell back to a live replica",
                target=target, live=len(self._live()),
            )
        except RuntimeError as e:
            res.failed[req.rid] = str(e)
            return
        obs.event("journey.route", jid=req.jid, rid=str(req.rid),
                  replica=target)
        h = self.handles[target]
        try:
            h.leases.acquire(req.rid, meta=req)
            h.send(_req_msg(req))
        except ReplicaError:
            self._replica_down(h, "send failed", res)

    def _handle(self, rid: str, msg: dict, res: FleetResult) -> None:
        h = self.handles.get(rid)
        if h is None:
            return
        h.last_msg_ns = clock_ns()
        if msg.get("ready") is True:
            if h.state == "spawning":
                # a late (elastic) spawn came up mid-run: NOW it joins
                # the ring, only its own reserved arc remapping to it
                h.state = "ready"
                self.router.restore(h.id)
                obs.event("fleet.scale_ready", replica=h.id)
                if self.child_cfg.get("prefix_store"):
                    self._send_prewarm(h, res)
            return
        if msg.get("ready") is False:
            # a late spawn failed init: it holds no leases
            h.state = "dead"
            h.kill()
            return
        op = msg.get("op")
        if op == "obs":
            h.last_obs_ns = clock_ns()
            self.fleet_obs.absorb(h.id, msg)
            return
        if op == "done":
            r = int(msg["rid"])
            h.leases.release(r)
            if r not in res.done and r not in res.failed:
                res.done[r] = [int(t) for t in msg["ids"]]
                res.t_done_ns[r] = clock_ns()
            h.breaker.success()
        elif op == "first":
            # front-door TTFT is stamped here, on the parent's clock: the
            # same measurement for a unified and a split fleet, and a
            # re-prefilled first token does not move it
            res.t_first_ns.setdefault(int(msg["rid"]), clock_ns())
        elif op == "handoff":
            self._adopt_handoff(h, msg, res)
        elif op == "shed":
            # the child's burn ladder shed this admission: terminal, and
            # mitigation working, not replica sickness (breaker untouched)
            r = int(msg["rid"])
            h.leases.release(r)
            if (r not in res.done and r not in res.failed
                    and r not in res.shed):
                res.shed[r] = str(msg.get("reason", "shed"))
        elif op == "failed":
            r = int(msg["rid"])
            h.leases.release(r)
            if h.state != "ready":
                # a known-sick replica's failures reroute, not finalize
                self._reroute(r, None, res)
                return
            # hold the verdict: if this replica turns out sick its
            # failures reroute instead; they finalize only once it proves
            # healthy (run end) or the reroute budget is spent
            h.tentative_failed[r] = str(msg.get("reason", "failed"))
            if h.breaker.failure():
                self._quarantine(h, res)
        elif op in ("drained", "quarantined"):
            if (msg.get("snapshot_step") is not None
                    and msg.get("snapshot_step", -1) >= 0):
                h.snapshotted = True
                self.drains += 1
                obs.counter("tpu_patterns_replica_drains_total",
                            replica=h.id, mode="drain").inc()
            if op == "quarantined":
                # the parent-side mirror of the child's breaker-trip
                # counter, reconciled against the shipped truth
                self.fleet_obs.mirror(
                    h.id, "tpu_patterns_replica_breaker_trips_total"
                )
            h.stats = msg.get("stats") or {}
            res.replica_stats[h.id] = h.stats
            if h.state == "ready":
                # the child self-quarantined before the parent's breaker
                # saw enough failures
                self.router.quarantine(h.id)
            h.state = "drained"
            self._settle_leases(h, res)
        elif op == "checkpointed":
            h.snapshotted = True
            self.drains += 1
            self.fleet_obs.mirror(
                h.id, "tpu_patterns_replica_drains_total",
                mode="checkpoint",
            )
        elif op == "fin":
            h.stats = msg.get("stats") or {}
            res.replica_stats[h.id] = h.stats
            h.state = "done"
        elif op in ("_eof", "_garbled"):
            if h.state in ("done", "drained"):
                return
            self._replica_down(h, op.strip("_"), res)
        # hb: the timestamp update above is the point

    # -- the disaggregated handoff ---------------------------------------

    def _pick_decode(self) -> ReplicaHandle | None:
        """Round-robin over the live decode replicas: they are not on the
        prefix ring (they take no admissions), and adopted blocks seed
        each one's own prefix index instead."""
        live = sorted((h for h in self._live()
                       if self.roles.get(h.id) == "decode"),
                      key=lambda h: int(h.id))
        if not live:
            return None
        pick = live[self._decode_rr % len(live)]
        self._decode_rr += 1
        return pick

    def _adopt_handoff(self, h: ReplicaHandle, msg: dict,
                       res: FleetResult) -> None:
        """A prefill replica finished its half of ``rid``: move the lease
        to a decode replica and forward the manifest.  The transfer itself
        happened child-side (the spool file); the parent is the control
        plane: it picks the adopter, keeps the lease table leak-free and
        books why."""
        r = int(msg["rid"])
        m = dict(msg["m"])
        h.leases.release(r)
        h.breaker.success()  # the prefill leg served its half
        if r in res.done or r in res.failed or r in res.shed:
            return
        res.handoff_rids.add(r)
        d = self._pick_decode()
        recompute = bool(m.get("recompute"))
        # one transfers tick a handoff decision (degradations included);
        # the payload series count real shipped blocks and bytes only
        obs.counter("tpu_patterns_disagg_transfers_total").inc()
        if not recompute:
            obs.counter("tpu_patterns_disagg_adopted_blocks_total").inc(
                int(m.get("blocks", 0)))
            obs.counter("tpu_patterns_disagg_transfer_bytes_total").inc(
                int(m.get("nbytes", 0)))
        self.decisions.book(
            "handoff", rid=r, jid=str(m.get("jid", "")),
            rationale=(
                "prefill transfer degraded; decode pool re-prefills from "
                "the prompt" if recompute else
                "prefill complete; KV blocks shipped to the decode pool "
                "over the block stream"
            ),
            src=h.id, dst=d.id if d else "",
            blocks=int(m.get("blocks", 0)),
            nbytes=int(m.get("nbytes", 0)),
            recompute=recompute,
            decode_live=0 if d is None else 1,
        )
        if d is None:
            res.failed[r] = "no live decode replica left to adopt"
            return
        obs.event("journey.handoff", jid=str(m.get("jid", "")),
                  rid=str(r), src=h.id, replica=d.id)
        try:
            d.leases.acquire(r, meta=res.requests_by_rid.get(r))
            d.send({"op": "adopt", "m": m})
        except ReplicaError:
            # the adopter died at the send: standard fail-over settles its
            # leases (this rid included) back through the prefill ring
            self._replica_down(d, "send failed at adopt", res)

    def _check_watchdogs(self, res: FleetResult) -> None:
        now = clock_ns()
        watchdog_ns = int(self.watchdog_s * 1e9)
        obs_watchdog_ns = int(self.obs_watchdog_s * 1e9)
        for h in list(self.handles.values()):
            if h.state != "ready":
                continue
            if not h.alive():
                self._replica_down(h, "process exited", res)
            elif len(h.leases) and now - h.last_msg_ns > watchdog_ns:
                self._replica_down(h, "watchdog: no heartbeat", res)
            elif (len(h.leases) and not h.obs_stalled
                  and obs_watchdog_ns > 0
                  and now - h.last_obs_ns > obs_watchdog_ns):
                # heartbeats arrive but obs batches stopped: the fleet
                # timeline is going blind on this replica — WARN once
                self._obs_stall(h, now)

    def _obs_stall(self, h: ReplicaHandle, now: int) -> None:
        from tpu_patterns_torch.core.results import (
            Record,
            ResultWriter,
            Verdict,
        )

        h.obs_stalled = True
        self.obs_stalls += 1
        stalled_s = (now - h.last_obs_ns) / 1e9
        obs.counter("tpu_patterns_replica_obs_stalls_total",
                    replica=h.id).inc()
        obs.event("replica.obs_stall", replica=h.id)
        ResultWriter(
            jsonl_path=os.path.join(obs.run_dir(), "watchdog.jsonl"),
            stream=sys.stderr,
        ).record(Record(
            pattern="obs",
            mode="watchdog_obs_stall",
            commands=f"replica {h.id}",
            metrics={
                "stalled_s": round(stalled_s, 3),
                "deadline_s": round(self.obs_watchdog_s, 3),
                "leases": float(len(h.leases)),
            },
            verdict=Verdict.WARNING,
            notes=[
                f"replica {h.id} heartbeats are arriving but no obs batch "
                f"landed for {stalled_s:.1f}s (deadline "
                f"{self.obs_watchdog_s:.1f}s) while it holds "
                f"{len(h.leases)} lease(s) — the fleet timeline is blind "
                "on this replica; its own dumps under replica-*/ remain "
                "the fallback",
            ],
        ))

    def _finalize_tentative(self, res: FleetResult) -> None:
        """Failures on replicas that stayed healthy are genuine request
        failures: finalize them so the identity closes."""
        for h in self.handles.values():
            for rid, reason in h.tentative_failed.items():
                if (rid not in res.done and rid not in res.failed
                        and rid not in res.shed):
                    res.failed[rid] = reason
            h.tentative_failed = {}

    def _finish(self, res: FleetResult) -> None:
        """All leases settled: collect final stats from live replicas and
        any drain handbacks still in flight, then finalize."""
        waiting = set()
        for h in self._live():
            try:
                h.send({"op": "fin"})
                waiting.add(h.id)
            except ReplicaError:
                self._replica_down(h, "send failed at fin", res)
        # a quarantined replica's drained message may still be in flight:
        # its stats (leaked_blocks) must land before the verdict
        waiting |= {h.id for h in self.handles.values()
                    if h.state == "quarantined"}
        deadline = clock_ns() + int(60e9)
        while waiting and clock_ns() < deadline:
            try:
                rid, msg = self.inbox.get(timeout=1.0)
            except queue.Empty:
                for r in list(waiting):
                    if not self.handles[r].alive():
                        self._replica_down(self.handles[r],
                                           "died before fin", res)
                        waiting.discard(r)
                continue
            self._handle(rid, msg, res)
            h = self.handles.get(rid)
            if h is not None and h.state in ("done", "dead", "drained"):
                waiting.discard(rid)
        self._finalize_tentative(res)


def _req_msg(req: Request) -> dict:
    return {
        "op": "req", "rid": req.rid, "tokens": list(req.tokens),
        "n_gen": req.n_gen, "deadline_ms": req.deadline_ms,
        "scenario": req.scenario, "jid": req.jid,
        "priority": req.priority,
        # the sampling identity must cross the pipe
        "temperature": req.temperature, "top_k": req.top_k,
        "top_p": req.top_p, "seed": req.seed,
        "gen_offset": req.gen_offset,
    }


# -- measured patterns -----------------------------------------------------


def _goodput(res: FleetResult, priority: str | None = None) -> float:
    """Router-side goodput under SLO: the fraction of generated tokens
    from requests whose scheduled-arrival -> last-token wall time met
    their deadline (0-deadline requests always meet it), measured at the
    FRONT DOOR.  ``priority`` restricts the sample to one class."""
    reqs = {rid: r for rid, r in res.requests_by_rid.items()
            if priority is None or r.priority == priority}
    total = sum(r.n_gen for r in reqs.values())
    if not total:
        return 0.0
    good = 0
    for rid, ids in res.done.items():
        req = reqs.get(rid)
        if req is None:
            continue
        if req.deadline_ms <= 0:
            good += len(ids)
            continue
        e2e_ms = ((res.t_done_ns[rid] - res.t0_ns) / 1e6
                  - res.arrival_ms.get(rid, 0.0))
        if e2e_ms <= req.deadline_ms:
            good += len(ids)
    return good / total


def _slices(n_total: int, mesh, tp: int) -> tuple[list[list[str]], int]:
    """``n_total`` disjoint equal slices of the mesh's ranks
    (``partition_devices`` over the ranks), each as its ranks' device
    names; returns (slices, ranks a slice)."""
    import types

    from tpu_patterns_torch.topo import placement, topology

    per = mesh.size // n_total
    if per < 1 or per % tp:
        raise ValueError(
            f"{mesh.size} ranks / {n_total} replica slice(s) = {per} per "
            f"replica, which must be a positive multiple of tp={tp}"
        )
    platform = "gpu" if mesh.on_cuda else "cpu"
    topo = topology.discover([
        types.SimpleNamespace(id=r, process_index=0, platform=platform)
        for r in range(mesh.size)
    ])
    groups = placement.partition_devices(n_total, topo,
                                         devices_per_group=per)
    return [[str(mesh.devices[r]) for r in g] for g in groups], per


@dataclasses.dataclass
class FleetPlan:
    """What every fleet leg of one ``serve --replicas`` run shares: the
    timed trace, the children's config and warm trace, the rank slices
    and the oracle's lengths (:func:`fleet_plan`)."""

    timed: list  # [(arrival_s, Request)]
    spec: object | None  # the scenario, or None on the plain trace
    child_cfg: dict
    warm: list  # [[tokens, n_gen]] a throwaway engine serves per child
    slices: list[list[str]]  # each slice's rank devices
    per: int  # ranks a slice
    child_sp: int
    tp: int
    device: object  # the parent's device (the oracle's)
    oracle_prompt: int
    oracle_gen: int


def fleet_plan(cfg, mesh=None, writer=None) -> FleetPlan:
    """The plan of ``cfg``'s fleet over ``mesh`` (the run's dp-1 rank
    mesh; default one rank on ``cfg.device``): each of the replicas and
    reserves takes an equal slice of its ranks, sp x tp with tp the
    mesh's; the trace is the scenario's schedule, else the shared chat
    trace under ``prefix_share``, else ``random_trace``."""
    from tpu_patterns_torch.comm.mesh import model_mesh
    from tpu_patterns_torch.serve.engine import (
        _refuse_fleet,
        random_trace,
        shared_trace,
    )

    _refuse_fleet(cfg)
    if mesh is None:
        mesh = model_mesh(1, device=cfg.device)
    if mesh.dim("dp") != 1:
        raise ValueError("serve --replicas requires --dp 1: the replicas "
                         "are the data-parallel axis")
    tp = mesh.dim("tp")
    # the elastic fleet pre-partitions n + reserve disjoint slices: every
    # replica gets the same slice size, so the A/B compares fleets of
    # equal per-replica shape
    slices, per = _slices(int(cfg.replicas) + int(cfg.elastic_reserve),
                          mesh, tp)
    dev = mesh.devices[0]
    prefix_share = cfg.prefix_share
    spec = None
    if cfg.scenario:
        from tpu_patterns_torch.loadgen.scenarios import (
            build_schedule,
            parse_scenario,
        )

        spec = parse_scenario(cfg.scenario)
        schedule = build_schedule(spec, vocab=cfg.vocab, seed=cfg.seed,
                                  time_scale=cfg.time_scale)
        timed = [(tr.arrival_s, tr.request) for tr in schedule]
        oracle_prompt, oracle_gen = spec.max_prompt, spec.max_gen
        if not prefix_share:
            # the routing comparison is ABOUT the prefix cache
            prefix_share = True
            if writer is not None:
                writer.progress(
                    "serve --replicas --scenario: enabling --prefix_share "
                    "(the routing-comparison Record measures cache hits)"
                )
    else:
        # the shared-prefix chat trace under --prefix_share: reroutes land
        # on a sibling whose fresh-prefill count the store must cut
        trace = shared_trace(cfg)[0] if prefix_share else random_trace(cfg)
        timed = [(0.0, r) for r in trace]
        oracle_prompt, oracle_gen = cfg.max_prompt, cfg.gen
    max_len = oracle_prompt + oracle_gen
    per_row = -(-max_len // cfg.block_len)
    child_cfg = {
        "vocab": cfg.vocab, "embed": cfg.embed, "heads": cfg.heads,
        "head_dim": cfg.head_dim, "mlp_mult": cfg.mlp_mult,
        "depth": cfg.depth, "dtype": cfg.dtype, "rope": cfg.rope,
        "kv_heads": cfg.kv_heads, "cache_int8": cfg.cache_int8,
        "paged_attn": cfg.paged_attn, "device": dev.type,
        "slots": cfg.slots, "block_len": cfg.block_len,
        "n_blocks": cfg.n_blocks or (cfg.slots * per_row + 1),
        "max_len": max_len, "seed": cfg.seed,
        "prefix_share": prefix_share, "spec_k": cfg.spec_k,
        "watchdog_s": cfg.watchdog_s,
        # the mitigation ladder and the tier/preemption knobs run per
        # replica: each child owns its burn windows and its host tier
        "burn_mitigation": cfg.burn_mitigation,
        "slo_fast_s": cfg.slo_fast_s, "slo_slow_s": cfg.slo_slow_s,
        "slo_budget": cfg.slo_budget,
        "burn_multiplier": cfg.burn_multiplier,
        "kv_host_tier": cfg.kv_host_tier,
        "host_tier_blocks": cfg.host_tier_blocks,
        "preempt": cfg.preempt,
        "prefix_store": cfg.prefix_store,
        # children build the sampling decoder iff a request samples
        "sampling": any(r.temperature > 0 for _, r in timed),
    }
    # warm every shape the trace will touch before timing: a slice of the
    # real trace, generation capped so the warm-up is cheap
    warm = [[list(r.tokens), min(r.n_gen, 4)]
            for _, r in timed[: min(len(timed), 2 * cfg.slots)]]
    return FleetPlan(timed, spec, child_cfg, warm, slices, per, per // tp,
                     tp, dev, oracle_prompt, oracle_gen)


def make_manager(plan: FleetPlan, cfg, n: int, policy: str, work_dir: str,
                 obs_base: str | None,
                 elastic: ElasticConfig | None = None,
                 roles: dict[str, str] | None = None) -> ReplicaManager:
    """A :class:`ReplicaManager` of ``n`` replicas for ``plan``."""
    return ReplicaManager(
        n, base_env=dict(os.environ), work_dir=work_dir,
        child_cfg=plan.child_cfg, device_slices=plan.slices,
        sp=plan.child_sp, tp=plan.tp, policy=policy,
        route_blocks=cfg.route_blocks or 2,
        watchdog_s=cfg.replica_watchdog_s, obs_base=obs_base,
        warm=plan.warm, elastic=elastic, roles=roles,
    )


def disagg_roles(n_pre: int, n_dec: int) -> dict[str, str]:
    """Replicas 0..P-1 prefill, the rest decode."""
    return {str(i): "prefill" if i < n_pre else "decode"
            for i in range(n_pre + n_dec)}


def _ttft_p99(res: FleetResult) -> float:
    """Front-door p99 time to first token over completed requests, in
    ms: the parent-clock first-token stamp less the request's scheduled
    arrival.  Child clock readings never cross the pipe: both A/B legs
    stamp at the parent's receipt of ``first``, so queueing, routing and
    the handoff are all inside."""
    waits = [(res.t_first_ns[rid] - res.t0_ns) / 1e6
             - res.arrival_ms.get(rid, 0.0)
             for rid in res.done if rid in res.t_first_ns]
    if not waits:
        return -1.0
    return float(np.percentile(np.asarray(waits), 99.0))


def run_replicas(cfg, writer, mesh=None) -> list:
    """The ``serve --replicas N`` measured patterns.

    Plain trace: the fleet serves ``engine.random_trace`` (the shared
    chat trace under ``prefix_share``) and banks the scaling/fail-over
    Record — the coverage identity, fleet-wide ``leaked_blocks == 0``,
    completed ids equal to the per-request dense decode on the parent's
    device, and (with ``min_replica_speedup`` > 0) aggregate tokens/s
    over N replicas >= the gate x ONE replica on the same slice size.

    With ``disagg`` ("P:D"): the disagg A/B Record — the fleet split into
    P prefill and D decode replicas (``roles``) against a unified fleet
    of N on the same schedule and slices: both legs covered, exact
    against one dense decode of the schedule and leak-free, at least one
    handoff, and with ``min_ttft_improvement`` > 0 the split fleet's
    front-door TTFT p99 (:func:`_ttft_p99`) at least that factor better.

    With ``scenario``: the same fleet serves the scenario schedule under
    BOTH router policies (the routing comparison: prefix-aware routing
    must beat round-robin on fleet-wide ``prefix_hit_blocks`` and
    front-door goodput); with ``elastic_reserve`` too, the elastic A/B
    (a fleet that may grow into the reserve against a static one).

    ``mesh`` is the run's dp-1 rank mesh (:func:`fleet_plan`).  Before
    the first spawn on the card the parent builds the kernels, so the
    children only load them.  On the card every child that served must
    have launched the paged kernel, and no prefill-role child may have,
    or the Record fails.
    """
    import tempfile

    from tpu_patterns_torch.core.results import Record, Verdict
    from tpu_patterns_torch.models.lm import init_lm_params
    from tpu_patterns_torch.serve.engine import (
        _oracle_expected,
        _serve_commands,
        disagg_split,
        model_config,
    )

    plan = fleet_plan(cfg, mesh, writer)
    n, reserve = int(cfg.replicas), int(cfg.elastic_reserve)
    roles = None
    if cfg.disagg:
        n_pre, n_dec = disagg_split(cfg)
        roles = disagg_roles(n_pre, n_dec)
    timed, spec, dev = plan.timed, plan.spec, plan.device
    child_sp, tp, per = plan.child_sp, plan.tp, plan.per
    mcfg = model_config(cfg)
    if dev.type == "cuda" and cfg.paged_attn == "kernel":
        # build before the first spawn: concurrent first builds would
        # contend on the build and eat the ready deadline
        from tpu_patterns_torch.kernels import build

        build.build_all()
    work_root = cfg.replica_dir or tempfile.mkdtemp(
        prefix="tpu_patterns_torch_replicas_"
    )

    def fleet(n_replicas: int, policy: str, tag: str, primary: bool = False,
              elastic: ElasticConfig | None = None,
              roles: dict[str, str] | None = None) -> FleetResult:
        # the PRIMARY leg's per-replica obs dirs live under the run's obs
        # dir, where `obs fleet` / `obs journey` merge them with the
        # parent's own dumps; the other legs keep theirs under the work
        # dir, so they cannot overwrite the measured fleet's timeline
        mgr = make_manager(
            plan, cfg, n_replicas, policy, os.path.join(work_root, tag),
            obs.run_dir() if primary
            else os.path.join(work_root, tag, "obs"),
            elastic=elastic, roles=roles,
        )
        writer.progress(
            f"fleet[{tag}]: spawning {n_replicas} replica(s) x {per} "
            f"rank(s) (sp{child_sp} x tp{tp}) on {dev.type}, "
            f"policy={policy}"
        )
        with obs.span("serve.fleet", replicas=n_replicas, policy=policy):
            # spawn_all inside the try: a failed startup still kills the
            # replicas that did spawn
            try:
                mgr.spawn_all()
                res = mgr.serve(timed)
            finally:
                mgr.shutdown()
        res.arrival_ms = {r.rid: a * 1e3 for a, r in timed}
        writer.progress(
            f"fleet[{tag}]: {res.counts()} in {res.wall_s:.2f}s "
            f"({res.tokens() / res.wall_s if res.wall_s else 0:.1f} "
            f"tok/s), paged kernel launches by replica "
            f"{res.paged_block_launches()}"
        )
        return res

    want_cache: dict = {}

    def oracle(reqs) -> dict:
        """The per-request dense decode on the parent's device, once."""
        todo = [r for r in reqs if r.rid not in want_cache]
        if todo:
            params = init_lm_params(cfg.seed, mcfg, cfg.vocab, dev)
            want_cache.update(_oracle_expected(
                mcfg, cfg.vocab, params, todo,
                max_prompt=plan.oracle_prompt, max_gen=plan.oracle_gen,
                cache_int8=cfg.cache_int8,
            ))
        return want_cache

    def exactness(res: FleetResult):
        reqs = [res.requests_by_rid[rid] for rid in sorted(res.done)]
        if not reqs:
            return 0.0, []
        want = oracle(reqs)
        bad = [r.rid for r in reqs if res.done[r.rid] != want[r.rid]]
        return (0.0 if bad else 1.0), bad

    def launch_notes(rec, *results, roles=None) -> None:
        """On the card every child that served must have launched the
        paged kernel, and a prefill-role child (``roles``, one dict a
        result) never: either breach fails the Record."""
        if dev.type != "cuda" or cfg.paged_attn != "kernel":
            return
        for r, role_of in zip(results, roles or [{}] * len(results)):
            by = r.paged_block_launches()
            idle = [k for k, v in by.items()
                    if v <= 0 and role_of.get(k) != "prefill"
                    and r.replica_stats[k].get("done", 0)]
            if idle:
                rec.verdict = Verdict.FAILURE
                rec.notes.append(
                    f"replica(s) {idle} served without a paged kernel "
                    "launch on the card"
                )
            busy = [k for k, v in by.items()
                    if v > 0 and role_of.get(k) == "prefill"]
            if busy:
                rec.verdict = Verdict.FAILURE
                rec.notes.append(
                    f"prefill replica(s) {busy} launched the paged kernel: "
                    "a prefill-only pool never decodes"
                )
        rec.config["paged_block_launches"] = [
            r.paged_block_launches() for r in results
        ]

    def missing(r: FleetResult) -> list[int]:
        return sorted(set(r.requests_by_rid) - set(r.done)
                      - set(r.failed) - set(r.shed))

    if roles is not None:
        # -- the disagg Record (the P:D split against unified) ----------
        # The same devices, schedule and slice a replica: a fleet split
        # into P prefill and D decode replicas against a unified fleet of
        # N.  Gates: both legs covered, exact and leak-free, at least one
        # handoff, and (with min_ttft_improvement > 0) the split fleet's
        # front-door TTFT p99 at least that factor better
        res_d = fleet(n, cfg.replica_policy, "disagg", primary=True,
                      roles=roles)
        res_u = fleet(n, cfg.replica_policy, "unified")
        # one dense decode of the schedule serves both legs
        oracle([r for _, r in timed])
        exact_d, bad_d = exactness(res_d)
        exact_u, bad_u = exactness(res_u)
        p99_d, p99_u = _ttft_p99(res_d), _ttft_p99(res_u)
        improvement = p99_u / p99_d if p99_d > 0 else 0.0
        counts_d, counts_u = res_d.counts(), res_u.counts()
        transfers = res_d.handoffs()
        ok = (
            res_d.covered() and res_u.covered()
            and exact_d == 1.0 and exact_u == 1.0
            and res_d.leaked_blocks() == 0 and res_u.leaked_blocks() == 0
            and transfers >= 1
        )
        if cfg.min_ttft_improvement > 0:
            ok = ok and improvement >= cfg.min_ttft_improvement
        rec = Record(
            pattern="serve",
            mode=(f"disagg_{spec.name if spec else 'trace'}_"
                  f"p{n_pre}d{n_dec}_sp{child_sp}"),
            commands=(f"{cfg.scenario or _serve_commands(cfg)} | "
                      f"{n_pre} prefill + {n_dec} decode x "
                      f"sp{child_sp}tp{tp} vs {n} unified"),
            metrics={
                "requests": float(len(timed)),
                "ttft_p99_ms_disagg": round(p99_d, 3),
                "ttft_p99_ms_unified": round(p99_u, 3),
                "ttft_improvement": round(improvement, 4),
                "transfers": float(transfers),
                "adopts": float(res_d.adopts()),
                "adopted_blocks": float(res_d.adopted_blocks()),
                "transfer_bytes": float(res_d.transfer_bytes()),
                "recomputes": float(res_d.disagg_recomputes()),
                "done_disagg": float(counts_d["done_total"]),
                "done_unified": float(counts_u["done_total"]),
                "failed": float(counts_d["failed_total"]
                                + counts_u["failed_total"]),
                "rerouted": float(counts_d["rerouted"]),
                "exact": float(exact_d == 1.0 and exact_u == 1.0),
                "covered": float(res_d.covered() and res_u.covered()),
                "leaked_blocks": float(res_d.leaked_blocks()
                                       + res_u.leaked_blocks()),
            },
            verdict=Verdict.SUCCESS if ok else Verdict.FAILURE,
            config={"device": str(dev)},
        )
        if transfers < 1:
            rec.notes.append(
                "no request crossed the prefill->decode wire — the split "
                "fleet never exercised the handoff path and the A/B is "
                "vacuous"
            )
        if 0 < improvement < cfg.min_ttft_improvement:
            rec.notes.append(
                f"TTFT p99 improvement {improvement:.3f}x < gate "
                f"{cfg.min_ttft_improvement:g}x ({p99_d:.1f}ms disagg vs "
                f"{p99_u:.1f}ms unified) — dedicating {n_pre} replica(s) "
                "to prefill did not pay on this schedule"
            )
        if cfg.min_ttft_improvement <= 0:
            rec.notes.append(
                "TTFT gate off (min_ttft_improvement 0): ttft_improvement "
                "is reported, not gated"
            )
        for tag, bad in (("disagg", bad_d), ("unified", bad_u)):
            if bad:
                rec.notes.append(
                    f"exactness FAILED on the {tag} leg for request(s) "
                    f"{bad[:8]}: ids diverged from dense decode (adopted "
                    "completions gate here too)"
                )
        for tag, r in (("disagg", res_d), ("unified", res_u)):
            if not r.covered():
                rec.notes.append(
                    f"coverage identity broken on the {tag} leg: "
                    f"request(s) {missing(r)[:8]} unaccounted"
                )
        if res_d.disagg_recomputes():
            rec.notes.append(
                f"{res_d.disagg_recomputes()} handoff(s) degraded to a "
                "re-prefill (transfer or adopt fault) — bounded "
                "recompute, completions still exact"
            )
        launch_notes(rec, res_d, res_u, roles=[roles, {}])
        writer.record(rec)
        return [rec]

    if spec is not None and reserve:
        # -- the elastic Record (diurnal-ramp A/B: elastic vs static) ---
        ecfg = ElasticConfig(
            reserve=reserve, out_occupancy=cfg.scale_out_occupancy,
            in_occupancy=cfg.scale_in_occupancy,
            sustain_s=cfg.scale_sustain_s, cooldown_s=cfg.scale_cooldown_s,
            min_live=cfg.min_live_replicas,
        )
        res_e = fleet(n, cfg.replica_policy, "elastic", primary=True,
                      elastic=ecfg)
        res_s = fleet(n, cfg.replica_policy, "static")
        exact_e, bad_e = exactness(res_e)
        exact_s, bad_s = exactness(res_s)
        good_e = _goodput(res_e, priority="interactive")
        good_s = _goodput(res_s, priority="interactive")
        outs, ins = res_e.scale_outs(), res_e.scale_ins()
        ok = (
            res_e.covered() and res_s.covered()
            and exact_e == 1.0 and exact_s == 1.0
            and res_e.leaked_blocks() == 0 and res_s.leaked_blocks() == 0
            and outs >= 1 and good_e >= good_s
        )
        counts_e, counts_s = res_e.counts(), res_s.counts()
        rec = Record(
            pattern="serve",
            mode=f"elastic_{spec.name}_r{n}p{reserve}_sp{child_sp}",
            commands=(
                f"{cfg.scenario} | {n}+{reserve} replicas x "
                f"sp{child_sp}tp{tp} preempt={cfg.preempt} "
                f"mitigation={cfg.burn_mitigation}"
            ),
            metrics={
                "requests": float(len(timed)),
                "goodput_interactive_elastic": round(good_e, 4),
                "goodput_interactive_static": round(good_s, 4),
                "goodput_elastic": round(_goodput(res_e), 4),
                "goodput_static": round(_goodput(res_s), 4),
                "scale_outs": float(outs),
                "scale_ins": float(ins),
                "preempted": float(res_e.preempted()),
                "preempted_resumed": float(res_e.preempted_resumed()),
                "shed_elastic": float(counts_e["shed_total"]),
                "shed_static": float(counts_s["shed_total"]),
                "done_elastic": float(counts_e["done_total"]),
                "done_static": float(counts_s["done_total"]),
                "failed": float(counts_e["failed_total"]
                                + counts_s["failed_total"]),
                "rerouted_elastic": float(counts_e["rerouted"]),
                "drains_elastic": float(res_e.drains),
                "exact": float(exact_e == 1.0 and exact_s == 1.0),
                "covered": float(res_e.covered() and res_s.covered()),
                "leaked_blocks": float(res_e.leaked_blocks()
                                       + res_s.leaked_blocks()),
            },
            verdict=Verdict.SUCCESS if ok else Verdict.FAILURE,
            config={"device": str(dev)},
        )
        if outs < 1:
            rec.notes.append(
                "the elastic fleet never scaled out — the ramp never "
                "sustained occupancy above the high water "
                f"({cfg.scale_out_occupancy:g} leases/slot for "
                f"{cfg.scale_sustain_s:g}s); the A/B is vacuous"
            )
        if good_e < good_s:
            rec.notes.append(
                f"interactive goodput {good_e:.3f} elastic < {good_s:.3f} "
                "static — growing the fleet did not pay"
            )
        for tag, bad in (("elastic", bad_e), ("static", bad_s)):
            if bad:
                rec.notes.append(
                    f"exactness FAILED on the {tag} leg for request(s) "
                    f"{bad[:8]}: ids diverged from dense decode "
                    "(preempted-and-resumed completions gate here too)"
                )
        for tag, r in (("elastic", res_e), ("static", res_s)):
            if not r.covered():
                rec.notes.append(
                    f"coverage identity broken on the {tag} leg: "
                    f"request(s) {missing(r)[:8]} unaccounted — done + "
                    "failed + shed + rerouted must equal scheduled"
                )
        for t_s, action, rid in res_e.scale_events[:12]:
            rec.notes.append(
                f"scale event @ {t_s:.2f}s: {action} replica {rid}"
            )
        launch_notes(rec, res_e, res_s)
        writer.record(rec)
        return [rec]

    if spec is not None:
        # -- the routing-comparison Record (both policies) ---------------
        res_p = fleet(n, "prefix", "prefix", primary=True)
        res_r = fleet(n, "round_robin", "rr")
        exact_p, bad_p = exactness(res_p)
        exact_r, bad_r = exactness(res_r)
        good_p, good_r = _goodput(res_p), _goodput(res_r)
        phb_p = res_p.prefix_hit_blocks()
        phb_r = res_r.prefix_hit_blocks()
        ok = (
            res_p.covered() and res_r.covered()
            and exact_p == 1.0 and exact_r == 1.0
            and res_p.leaked_blocks() == 0 and res_r.leaked_blocks() == 0
            and phb_p > phb_r and good_p >= good_r
        )
        rec = Record(
            pattern="serve",
            mode=f"router_{spec.name}_r{n}_sp{child_sp}",
            commands=f"{cfg.scenario} | {n} replicas x sp{child_sp}tp{tp}",
            metrics={
                "requests": float(len(timed)),
                "goodput_prefix": round(good_p, 4),
                "goodput_round_robin": round(good_r, 4),
                "prefix_hit_blocks_prefix": float(phb_p),
                "prefix_hit_blocks_round_robin": float(phb_r),
                "router_prefix_hits": float(res_p.router_prefix_hits),
                "exact": float(exact_p == 1.0 and exact_r == 1.0),
                "done_prefix": float(len(res_p.done)),
                "done_round_robin": float(len(res_r.done)),
                "failed": float(len(res_p.failed) + len(res_r.failed)),
                "reroutes": float(res_p.router_reroutes
                                  + res_r.router_reroutes),
                "leaked_blocks": float(res_p.leaked_blocks()
                                       + res_r.leaked_blocks()),
            },
            verdict=Verdict.SUCCESS if ok else Verdict.FAILURE,
            config={"device": str(dev)},
        )
        if not phb_p > phb_r:
            rec.notes.append(
                f"prefix-aware routing hit {phb_p} prefix blocks vs "
                f"round-robin's {phb_r} — affinity routing bought nothing "
                "on this trace"
            )
        if good_p < good_r:
            rec.notes.append(
                f"goodput {good_p:.3f} under prefix routing < {good_r:.3f} "
                "under round-robin"
            )
        for tag, bad in (("prefix", bad_p), ("round_robin", bad_r)):
            if bad:
                rec.notes.append(
                    f"exactness FAILED under {tag} routing for request(s) "
                    f"{bad[:8]}"
                )
        launch_notes(rec, res_p, res_r)
        writer.record(rec)
        return [rec]

    # -- the scaling / fail-over Record (plain trace) --------------------
    res_n = fleet(n, cfg.replica_policy, f"fleet{n}", primary=True)
    counts = res_n.counts()
    exact, bad = exactness(res_n)
    agg_tps = res_n.tokens() / res_n.wall_s if res_n.wall_s else 0.0
    single_tps, speedup = -1.0, -1.0
    legs = [res_n]
    if cfg.min_replica_speedup > 0 and n > 1:
        res_1 = fleet(1, cfg.replica_policy, "fleet1")
        legs.append(res_1)
        single_tps = res_1.tokens() / res_1.wall_s if res_1.wall_s else 0.0
        speedup = agg_tps / single_tps if single_tps > 0 else 0.0
    leaked = res_n.leaked_blocks()
    covered = res_n.covered()
    obs.gauge("tpu_patterns_replica_fleet_tokens_per_s").set(agg_tps)
    # the shipped child metrics must reproduce the front door's ledger:
    # every completion was counted by exactly one child engine
    fleet_consistent = res_n.shipped_done == float(len(res_n.done))
    ok = (covered and exact == 1.0 and leaked == 0
          and not res_n.mirror_mismatches and fleet_consistent)
    if speedup >= 0:
        ok = ok and speedup >= cfg.min_replica_speedup
    healed = bool(counts["rerouted"] or counts["failed"] or res_n.drains
                  or res_n.spawn_retries)
    verdict = Verdict.SUCCESS if ok else Verdict.FAILURE
    if ok and healed:
        verdict = Verdict.WARNING  # recovered, but not unscathed
    rec = Record(
        pattern="serve",
        mode=f"replicas{n}_sp{child_sp}_tp{tp}",
        commands=_serve_commands(cfg) + f" x{n} replicas",
        metrics={
            "scheduled": float(res_n.scheduled),
            "done": float(counts["done"]),
            "failed": float(counts["failed"]),
            "rerouted": float(counts["rerouted"]),
            "done_total": float(counts["done_total"]),
            "covered": float(covered),
            "exact": exact,
            "leaked_blocks": float(leaked),
            "aggregate_tokens_per_s": round(agg_tps, 1),
            "single_replica_tokens_per_s": round(single_tps, 1),
            "replica_speedup": round(speedup, 3),
            "reroutes": float(res_n.router_reroutes),
            "drains": float(res_n.drains),
            "spawn_retries": float(res_n.spawn_retries),
            "prefix_hit_blocks": float(res_n.prefix_hit_blocks()),
            # the fleet store's accounting (all 0 with it off): the
            # store A/B reads rerouted_fresh_blocks off this Record
            "rerouted_fresh_blocks": float(res_n.rerouted_fresh_blocks()),
            "store_publishes": float(res_n.store_publishes()),
            "store_publish_bytes": float(res_n.store_publish_bytes()),
            "store_hits": float(res_n.store_hits()),
            "store_fetch_bytes": float(res_n.store_fetch_bytes()),
            "store_prewarmed": float(res_n.store_prewarmed()),
            "store_fallbacks": float(res_n.store_fallbacks()),
            "tokens": float(res_n.tokens()),
            "fleet_shipped_done": float(res_n.shipped_done),
            "fleet_shipped_failed": float(res_n.shipped_failed),
            "fleet_consistent": float(fleet_consistent),
            "mirror_mismatches": float(len(res_n.mirror_mismatches)),
            "obs_stalls": float(res_n.obs_stalls),
        },
        verdict=verdict,
        config={"device": str(dev)},
    )
    if not covered:
        rec.notes.append(
            f"coverage identity broken: request(s) {missing(res_n)[:8]} "
            "neither completed nor failed — done + failed + rerouted "
            "must equal scheduled"
        )
    if bad:
        rec.notes.append(
            f"exactness FAILED for request(s) {bad[:8]}: ids diverged "
            "from per-request dense decode after fleet serving"
        )
    if leaked:
        rec.notes.append(
            f"{leaked} block(s) leaked fleet-wide — refcount bookkeeping "
            "broke in a surviving engine"
        )
    if 0 <= speedup < cfg.min_replica_speedup:
        rec.notes.append(
            f"aggregate speedup {speedup:.2f}x < "
            f"{cfg.min_replica_speedup}x gate over one replica on the "
            "same slice size"
        )
    if cfg.min_replica_speedup <= 0 and n > 1:
        rec.notes.append(
            "scaling gate off (min_replica_speedup 0): no one-replica "
            "baseline leg was run"
        )
    if not fleet_consistent:
        rec.notes.append(
            f"shipped child metrics claim {res_n.shipped_done:g} "
            f"completions but the front door settled {len(res_n.done)} — "
            "the obs channel and the control channel disagree"
        )
    for note in res_n.mirror_mismatches[:8]:
        rec.notes.append(f"mirror reconciliation: {note}")
    for rid in sorted(res_n.failed)[:8]:
        rec.notes.append(f"request {rid} FAILED: {res_n.failed[rid]}")
    launch_notes(rec, *legs)
    writer.record(rec)
    return [rec]
