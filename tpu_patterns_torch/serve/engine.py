"""Continuous-batching serve engine: iteration-level scheduling over the
paged pool.

Counterpart of the scheduler core of ``tpu_patterns/serve/engine.py``.
The host loop owns the request queue, the slot table and the block free
list.  Each iteration it

  1. RETIRES finished rows (each drops its table's block references; a
     block's last reference returns it to the free list),
  2. ADMITS queued requests FIFO into free slots, reserving each one's
     whole lifetime (``ceil((prompt + gen - 1) / block_len)`` blocks) at
     admission, and DEFERS (never OOMs) when the pool cannot cover the
     head of the queue,
  3. PREFILLS the newcomers as one bucketed call (ragged lens), and
  4. runs ONE decode step for the whole active set, each row at its own
     position, so a row admitted late decodes beside an early one; with
     ``spec_k`` > 0 the step is the speculative wide step (each row
     drafts up to ``spec_k`` tokens by prompt lookup and one call
     verifies them all).

With ``prefix_share`` admission is shared-aware: a prompt's whole-block
prefix already in the radix index (``serve/prefix.py``) aliases those
blocks (refcount + 1), a partial match at the boundary claims one fresh
block that copies the donor (CoW), and only the rest comes from the free
list.  Row counts and prompt lengths are bucketed to powers of two, as in
the JAX package, so the set of shapes the device sees stays small.

The engine also carries what the load generator (``loadgen/``) reads:
per-request sampling (``temperature``/``top_k``/``top_p``/``seed``/
``gen_offset`` through a decoder made with ``sampling=True``; the draw
for a request's n-th generated token is keyed ``(seed, gen_offset + n)``
and nothing else), submission backdated to a scheduled arrival, and the
per-request lifecycle (``self.lifecycle``: TTFT, TPOT, e2e and the
deadline verdict, from host stamps the loop already takes).  Every
finalized request feeds the SLO burn monitor (``obs/slo.py``), whose
mitigation ladder ``burn_mitigation`` (``shed``: shed admissions, bulk
first; ``spec_off``: plain decode instead of the wide step) acts while
a burn episode lasts, and the cost book (``obs/cost.py``) apportions
every measured prefill and decode wall and the pool's block-seconds.
``run(requests, source=...)`` polls an arrival source once an
iteration.

The memory-pressure and preemption-safety ladder is ported too.  The
host KV tier (``serve/kvtier.py``, ``kv_host_tier``) retains refcount-0
prefix blocks, evicts them to host memory when the free list runs dry
and pages them back on a prefix hit (alias -> evict -> defer), with an
optional session cache that survives a restart.  Priority preemption
(``preempt="bulk"``) parks a running bulk row in the tier for an
interactive admission or the burn ladder (shed bulk -> preempt bulk ->
shed the head) and resumes it bit-identical.  With ``snapshot_dir``,
SIGTERM/SIGINT (or an injected ``serve.step:preempt``) ends the loop at
its iteration boundary with a committed snapshot that
``restore_snapshot`` resumes.

The recovery path is the reference's: a prefill, decode step or verify
step runs inside ``faults.call_with_retry`` under ``retry_policy``
(sites ``serve.prefill``, ``serve.step``, ``serve.verify``, each fired
before anything is written), so a transient ``OSError`` retries from
the same state, and a deterministic one quarantines exactly the rows of
that wave (``_quarantine``: blocks back through the refcounts, a
per-request verdict in ``failed``) while the engine keeps serving
everyone else.  Any other error (a CUDA error is a ``RuntimeError``)
ends the run.  Slots are leased from an ``rt.LeasePool``, in-flight rows
held in an ``rt.LeaseTable``, and an opt-in ``rt.Breaker`` stops the
loop with the queue intact after consecutive whole-wave quarantines.
The obs plane records all of it: the ``serve.*`` spans (``serve.
step_outer`` covers injection and every retry), one Chrome-trace lane of
``req.*`` spans a request, the ``serve.*`` events with their decision-
ledger entries (``obs/decisions.py``), and the live plane's view
(``obs/live.py``) while ``run`` is in its loop.  ``watchdog_s`` puts a
deadline on every prefill, step and verify span.

The fleet's hooks are ported too: ``replica`` labels a fleet engine's
fault sites, spans and metrics, a request's ``jid`` (its fleet journey
id) rides its lifecycle spans, and ``prefix_store`` (needs the kv tier)
publishes every materialized full prefix block to the fleet prefix
store (``serve/store.py``) at iteration boundaries and consults it on an
admission miss before prefilling fresh; ``prewarm_paths`` fetches a
scale-out replica's ring arc into the tier.

So is the disaggregated prefill/decode handoff (``role``): a
``prefill`` engine ships each prefilled row's prompt blocks (the gather,
``PagedDecoder.stream`` over sp and back, one host copy, an atomically
spooled ``kv-<rid>.npz`` under ``spool_dir``) with a manifest in
``handoffs`` and frees them (``_handoff_wave``, the ``disagg.transfer``
site); a ``decode`` engine adopts the manifests the replica plane queues
in ``adopt_queue`` onto fresh blocks and decodes on, its first step
writing tok0's K/V where a unified engine would (``_admit_adopts``, the
``disagg.adopt`` site).  A transfer or adoption that fails past its
retries degrades to a local re-prefill with the same ids.  ``first_ns``
records each request's first-token stamp for the parent's TTFT.

``run_serve`` is the measured pattern: the same trace served continuous
(``slots`` wide) and sequential (one slot), gated on speedup, exactness
against the per-request dense decoder and the in-place pool; with
``prefix_share`` or ``spec_k`` it also emits the reference's
``prefix_share_*`` and ``spec_decode_*`` Records.  With ``snapshot_dir``
it is the preemptible one-pass run (``--resume`` continues it), with
``kv_host_tier`` the tier-against-defer race or (with ``session_dir``)
the session-cache run, and with ``scenario`` the load generator's SLO
pattern (``loadgen/runner.py``).  Each runs on one device or, with
``mesh``, over sp x tp ranks through the one ``serve/paged.py::
PagedDecoder``; the engine itself knows no ranks (the decoder owns the
pool's layout, its snapshot tree and its block copies, which move
blocks in the global layout) and reads the mesh from the decoder.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import signal
import sys
import threading

import numpy as np
import torch

from tpu_patterns_torch import ckpt, faults, obs, rt
from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict
from tpu_patterns_torch.core.timing import clock_ns
from tpu_patterns_torch.models.decode import kv_slot_bytes
from tpu_patterns_torch.models.lm import init_lm_params, make_lm_decoder
from tpu_patterns_torch.models.transformer import ModelConfig
from tpu_patterns_torch.obs.cost import CostBook
from tpu_patterns_torch.obs.cost import register as _register_cost
from tpu_patterns_torch.obs.decisions import DecisionLedger
from tpu_patterns_torch.obs.slo import SloConfig, SloMonitor
from tpu_patterns_torch.runtime import resolve_device
from tpu_patterns_torch.serve.paged import (
    TRASH_BLOCK,
    PagedDecoder,
    make_paged_lm_decoder,
)
from tpu_patterns_torch.serve.kvtier import HostTier
from tpu_patterns_torch.serve.paged_kernel import paged_block
from tpu_patterns_torch.serve.prefix import PrefixIndex
from tpu_patterns_torch.serve.store import (
    PrefixStore,
    block_fingerprint,
    leaf_from_numpy,
    leaf_to_numpy,
)

# the reference's snapshot format: 2 added refcounts, the prefix index
# and slot prompts; 3 the per-request sampling config and the
# generated-token key offset of queued and active rows
SNAPSHOT_FORMAT = 3


def _bucket(n: int, cap: int) -> int:
    """Next power of two >= n, clipped to cap."""
    return min(1 << max(0, n - 1).bit_length(), cap)


# Chrome-trace lane ids of the per-request lifecycle spans: far above any
# thread id's low bits, and a window of their own for each engine (rids
# restart at 0 in every engine of a process)
_REQ_LANE_BASE = 1_000_000
_ENGINE_SEQ = itertools.count()


@dataclasses.dataclass
class Request:
    rid: int
    tokens: list[int]  # prompt ids
    n_gen: int  # total tokens to generate (the first comes from prefill)
    # loadgen labels: the scenario rides into the lifecycle and the cost
    # book; the deadline is the submit -> last-token budget (0 = none)
    scenario: str = ""
    deadline_ms: float = 0.0
    # ``interactive`` or ``bulk``: burn-rate shedding takes bulk first
    priority: str = "interactive"
    # per-request sampling, honored by a decoder made with sampling=True
    # (temperature 0 = greedy, bit-identical to the unsampled cores).
    # The draw for the n-th generated token is keyed (seed, gen_offset +
    # n): ``gen_offset`` is the global index of the next token to
    # generate (0 for a fresh request)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    gen_offset: int = 0
    jid: str = ""  # fleet journey id (rides the lifecycle spans)


@dataclasses.dataclass
class _Slot:
    rid: int
    lens: int
    steps: int  # generated tokens already WRITTEN through the cache
    n_gen: int
    table: list[int]
    last_tok: int
    out: list[int]
    t_submit_ns: int
    prompt: list[int]  # kept live: drafter context
    write_from: int = 0  # prefix-share write fence (until its prefill)
    own_blocks: tuple[int, ...] = ()  # blocks this row newly indexed
    scenario: str = ""
    deadline_ms: float = 0.0
    priority: str = "interactive"
    temperature: float = 0.0  # per-request sampling (see Request)
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    gen_offset: int = 0  # global index of this row's next generated token
    # host clock_ns stamps: admission, first token on the host, latest
    # token on the host; the lifecycle's TTFT/TPOT/e2e come from these
    t_admit_ns: int = 0
    t_first_ns: int = 0
    t_last_ns: int = 0
    slot: int = -1  # the scheduler-slot lease token (rt.LeasePool)
    jid: str = ""  # fleet journey id (rides the lifecycle spans)


class ServeEngine:
    """Continuous-batching scheduler over a :class:`PagedDecoder`.

    ``slots`` bounds the active set (the decode bucket ceiling).  The
    decoder may be shared between engines; each engine owns its pool.
    ``prefix_share`` turns on copy-on-write prefix sharing, ``spec_k``
    speculative decoding with up to ``spec_k`` drafts a row a step.
    ``slo`` configures the burn monitor and ``burn_mitigation`` (``off``,
    ``shed``, ``spec_off``) the ladder it drives.

    ``kv_host_tier`` turns on the host KV tier (``serve/kvtier.py``;
    it implies the prefix index): refcount-0 prefix blocks are retained
    on the device, evicted to host memory when the free list runs dry
    (LRU by last reference, leaf-first) and paged back on a prefix hit.
    ``session_dir`` commits the tier so a restarted engine reloads it,
    ``host_tier_blocks`` bounds it (0 = unbounded).  ``preempt="bulk"``
    (needs the tier) lets interactive admissions and the burn ladder
    park a running bulk row in the tier and requeue it.
    ``snapshot_dir`` arms SIGTERM/SIGINT: the loop finishes its
    iteration, commits a snapshot there and returns;
    :meth:`restore_snapshot` loads it into a fresh engine.
    ``fingerprint`` is the config a snapshot or session must agree on.
    ``replica`` is a fleet engine's id (its fault sites' ``replica`` ctx
    and its obs labels); ``prefix_store`` (needs ``kv_host_tier``) names
    the fleet prefix store's directory.  ``role`` (``prefill`` or
    ``decode``; "" is unified) splits serving across two engines; a
    prefill engine spools its handoffs under ``spool_dir``.

    ``retry_policy`` (default ``faults.serve_retry_policy()``) governs the
    prefill, step and verify retries; ``breaker`` (an ``rt.Breaker``,
    off by default) stops the loop after its threshold of consecutive
    whole-wave quarantines; ``watchdog_s`` arms the hang watchdog on
    every prefill, step and verify span."""

    def __init__(self, decoder: PagedDecoder, params: dict, *, slots: int,
                 watchdog_s: float = 0.0, retry_policy=None,
                 breaker: rt.Breaker | None = None,
                 prefix_share: bool = False, spec_k: int = 0,
                 slo: SloConfig | None = None,
                 burn_mitigation: str = "off",
                 kv_host_tier: bool = False,
                 session_dir: str | None = None,
                 host_tier_blocks: int = 0,
                 preempt: str = "off",
                 snapshot_dir: str | None = None,
                 fingerprint: dict | None = None,
                 replica: str = "",
                 prefix_store: str | None = None,
                 role: str = "",
                 spool_dir: str | None = None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if role not in ("", "prefill", "decode"):
            raise ValueError(
                f"role must be '' | prefill | decode, got {role!r}"
            )
        if role == "prefill" and not spool_dir:
            raise ValueError(
                "role='prefill' requires spool_dir: the handoff wire "
                "spools KV payloads there for the decode pool"
            )
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if session_dir and not kv_host_tier:
            raise ValueError("session_dir requires kv_host_tier")
        if prefix_store and not kv_host_tier:
            raise ValueError(
                "prefix_store requires kv_host_tier: fetched blocks "
                "adopt through the host tier's onload path"
            )
        if prefix_store and role:
            raise ValueError(
                "prefix_store is incompatible with disaggregated "
                "roles: the handoff wire owns cross-engine KV movement"
            )
        if burn_mitigation not in ("off", "shed", "spec_off"):
            raise ValueError(
                f"burn_mitigation must be off | shed | spec_off, got "
                f"{burn_mitigation!r}"
            )
        if preempt not in ("off", "bulk"):
            raise ValueError(f"preempt must be off | bulk, got {preempt!r}")
        if preempt != "off" and not kv_host_tier:
            raise ValueError(
                "preempt requires kv_host_tier: a preempted row is "
                "forced through the evict path into the host tier"
            )
        self.decoder = decoder
        self.params = params
        self.slots = slots
        # the active-set ceiling is a leased resource: admission leases
        # one scheduler slot, retire, quarantine and preemption release it
        self.slot_pool = rt.LeasePool(
            slots, max_leased=slots, spawn=itertools.count().__next__
        )
        # the opt-in decode-health breaker: consecutive whole-wave
        # quarantines open it and the loop stops with the queue intact;
        # None keeps serving, quarantining wave by wave
        self.breaker = breaker
        self.breaker_tripped = False
        # the replica id the fault sites' ctx, the obs labels and the live
        # plane carry: one engine is "", the fleet labels its replicas
        self.replica = replica
        # disaggregated prefill/decode serving (``serve --disagg P:D``): a
        # ``prefill`` engine admits and prefills, then ships each row's
        # written blocks (gather -> the block stream -> an atomically
        # spooled file) and releases everything it held; a ``decode``
        # engine adopts those payloads onto fresh blocks and runs pure
        # decode.  "" is the unified engine
        self.role = role
        self.spool_dir = spool_dir
        # finished handoffs awaiting the replica report loop: {rid: wire
        # manifest} (tok0, sampling state, spool path, or recompute=True
        # when the transfer failed past its retries)
        self.handoffs: dict[int, dict] = {}
        # inbound handoffs (decode role): manifests the parent's ``adopt``
        # op queued, admitted FIFO by _admit_adopts each iteration
        self.adopt_queue: list[dict] = []
        # the first-token ledger: rid -> host stamp of its first token
        # (any role); the replica report loop ships a ``first`` op off it,
        # so the parent clocks TTFT on its own clock for a unified and a
        # disaggregated fleet alike
        self.first_ns: dict[int, int] = {}
        self.watchdog_s = watchdog_s
        self.layout = decoder.layout
        self.n_pages = decoder.n_pages
        self.pool = decoder.init_pool()
        # block 0 is the trash block: never handed out
        self.free = list(range(self.layout.n_blocks - 1, TRASH_BLOCK, -1))
        # per-block refcount: the live row tables mapping the block, so
        # sum(ref.values()) equals the live table references.  TRASH_BLOCK
        # never appears here.
        self.ref: dict[int, int] = {}
        # the kv tier's eviction and restore are index node transitions,
        # so the tier implies the index
        self.prefix_share = prefix_share or kv_host_tier
        self.index = (
            PrefixIndex(self.layout.block_len) if self.prefix_share else None
        )
        self._pending_cow: list[tuple[int, int]] = []  # (src, dst)
        self.fingerprint = dict(fingerprint or {})
        # the host KV tier: retained refcount-0 prefix blocks stay
        # allocated (a device-resident prefix cache), move to host
        # memory when the free list runs dry and page back on a hit
        self.tier: HostTier | None = None
        # the fleet prefix store: a shared atomic-commit directory every
        # replica publishes materialized full prefix blocks into (eagerly,
        # so a SIGKILLed replica's warm prefixes are already visible) and
        # consults on an admission miss before prefilling fresh
        self.store: PrefixStore | None = None
        # blocks awaiting publication with their path, captured when the
        # block materialized (block ids are reused: the publish wave drops
        # a pair whose block moved on)
        self._store_pending: list[tuple[int, tuple[int, ...]]] = []
        # paths this engine published or fetched: republishing is wasted
        self._store_published: set[tuple[int, ...]] = set()
        if kv_host_tier:
            leaf_meta = {
                name: ((shape[0], *shape[2:]), dt)
                for name, (shape, dt) in decoder._pool_leaves().items()
            }
            self.tier = HostTier(
                leaf_meta,
                block_len=self.layout.block_len,
                session_dir=session_dir, capacity_blocks=host_tier_blocks,
                fingerprint=self.fingerprint,
            )
            if prefix_store:
                self.store = PrefixStore(
                    prefix_store, leaf_meta,
                    block_len=self.layout.block_len,
                    fingerprint=self.fingerprint,
                )
        self.retry_policy = retry_policy or faults.serve_retry_policy()
        # retained blocks: {block: last-reference stamp}, the LRU order
        # (a counter, not a clock, so replays are deterministic)
        self.retained: dict[int, int] = {}
        self._lru_clock = itertools.count()
        # fresh full prompt blocks a request prefilled, by rid
        self.fresh_by_rid: dict[int, int] = {}
        self.spec_k = spec_k
        # the live SLO burn monitor: every finalized request books its
        # tokens good or bad against its deadline; with no deadlines it
        # is inert.  The ladder is opt-in: ``shed`` sheds admissions
        # (bulk first, then preempts running bulk under ``preempt``)
        # while a burn episode lasts, ``spec_off`` falls back from the
        # wide step to plain decode (same ids)
        self.slo = SloMonitor(slo, replica=replica)
        self.burn_mitigation = burn_mitigation
        # the cost book: measured prefill/decode walls apportioned over
        # the rows of each wave, and the pool's block-seconds; the
        # decision ledger: one entry a defer, evict, shed, preempt or
        # breaker trip with the signals read at decision time.  Both
        # fail open (the obs.cost_book site)
        self.cost = _register_cost(
            CostBook(self.layout.n_blocks - 1, replica=replica)
        )
        self.decisions = DecisionLedger(replica=replica)
        # admissions the burn ladder shed: {rid: reason}, a terminal
        # bucket like done, so the trace's accounting still closes
        self.shed: dict[int, str] = {}
        # priority preemption: a preempted bulk row's output so far
        # banks here until its resumed leg retires, and the stitched
        # stream equals an unpreempted one
        self.preempt = preempt
        self.preempted_partial: dict[int, list[int]] = {}
        # the first leg's first-token stamp: the TTFT the client saw
        self.preempted_first_ns: dict[int, int] = {}
        self.preempted_rids: set[int] = set()
        # the in-flight ledger: rid -> its _Slot, acquired at admission,
        # released at retire, quarantine or preemption (the live plane's
        # /statusz reads it)
        self.inflight = rt.LeaseTable()
        self.queue: list[tuple[Request, int]] = []  # (request, t_submit)
        self.active: list[_Slot] = []
        self.done: dict[int, list[int]] = {}
        # rows the recovery policy gave up on: {rid: reason}, a terminal
        # bucket like done, never dropped silently
        self.failed: dict[int, str] = {}
        self._lane_base = _REQ_LANE_BASE * (1 + next(_ENGINE_SEQ))
        # per-request lifecycle, written once at retirement: {rid:
        # {status, scenario, n_out, priority, submit/admit/first/last_ns,
        # ttft/tpot/e2e_ms, deadline_ms, met}}
        self.lifecycle: dict[int, dict] = {}
        self.stats = {
            "steps": 0, "prefills": 0, "deferrals": 0, "tokens": 0,
            "max_occupancy": 0.0, "queue_wait_ns": [], "peak_blocks": 0,
            "prefix_hit_blocks": 0, "cow_copies": 0, "spec_steps": 0,
            "spec_row_steps": 0, "spec_tokens": 0, "sheds": 0,
            # the kv tier (all 0 with it off); the *_ns are this port's:
            # host wall of the evictions' copies into the tier (device to
            # host, then into the store), of the session commits and of
            # the onload calls
            "evictions": 0, "evict_bytes": 0, "onload_hits": 0,
            "onload_bytes": 0, "tier_fallbacks": 0, "pressure_admits": 0,
            "session_loaded": 0, "prompt_fresh_full_blocks": 0,
            "retained_peak": 0, "evict_ns": 0, "commit_ns": 0,
            "onload_ns": 0,
            # preemption events, and preempted requests later retired
            "preempted": 0, "preempted_resumed": 0,
            # the fleet prefix store (all 0 with it off)
            "store_publishes": 0, "store_publish_bytes": 0,
            "store_hits": 0, "store_fetch_bytes": 0,
            "store_prewarmed": 0, "store_fallbacks": 0,
            # the disaggregated handoff (all 0 with role ""): handoffs and
            # transfer_bytes on the prefill side, adopts and
            # adopted_blocks on the decode side, and the re-prefill
            # degradations of each
            "handoffs": 0, "transfer_bytes": 0, "handoff_recomputes": 0,
            "adopts": 0, "adopted_blocks": 0, "adopt_recomputes": 0,
        }
        # SIGTERM/SIGINT (or an injected ``preempt``) sets the event; the
        # loop finishes its iteration, snapshots into snapshot_dir and
        # returns
        self.snapshot_dir = snapshot_dir or None
        self.preempted_at: int | None = None
        self._preempt = threading.Event()
        self._preempt_signum: int | None = None
        if self.tier is not None and session_dir:
            # the session cache: rebuild host-resident index nodes from
            # the latest committed tier, shallow-first (an orphaned chain
            # is dropped, never fabricated)
            for path, handle in self.tier.load_session():
                if self.index.add_host_path(path, handle):
                    self.stats["session_loaded"] += 1
                else:
                    self.tier.discard(handle)

    # -- bookkeeping -----------------------------------------------------

    def _blocks_needed(self, req: Request) -> int:
        # the highest written position is prompt + n_gen - 2 (the final
        # token is returned, its K/V never stored); n_gen == 1 still
        # reserves the prompt's blocks
        return self.layout.blocks_for(len(req.tokens) + max(req.n_gen - 1, 0))

    def submit(self, req: Request, t_submit_ns: int | None = None) -> None:
        """Queue ``req``.  ``t_submit_ns`` backdates the submission to
        the request's scheduled arrival (loadgen): lateness the engine
        caused by being busy when the arrival was due counts against
        TTFT and e2e instead of vanishing (coordinated omission)."""
        if not req.tokens or req.n_gen < 1:
            raise ValueError(f"request {req.rid}: empty prompt or n_gen < 1")
        need = self._blocks_needed(req)
        span = len(req.tokens) + req.n_gen - 1
        if need > self.layout.n_blocks - 1:
            raise ValueError(
                f"request {req.rid} needs {need} blocks; the pool only has "
                f"{self.layout.n_blocks - 1} allocatable"
            )
        if span > self.n_pages * self.layout.block_len:
            raise ValueError(
                f"request {req.rid}: {span} positions exceed the "
                f"{self.n_pages}-block table window"
            )
        self.queue.append(
            (req, clock_ns() if t_submit_ns is None else int(t_submit_ns))
        )

    def allocated_blocks(self) -> int:
        return self.layout.n_blocks - 1 - len(self.free)

    def _occupancy(self) -> float:
        return self.allocated_blocks() / (self.layout.n_blocks - 1)

    def leaked_blocks(self) -> int:
        """Allocated blocks that neither a live table references nor the
        tier retains: 0 unless the bookkeeping broke."""
        live = {b for s in self.active for b in s.table if b != TRASH_BLOCK}
        return self.allocated_blocks() - len(live) - len(self.retained)

    def pool_ptrs(self) -> dict[str, int]:
        """Device addresses of the pool leaves: unchanged across a run
        iff every prefill, step and onload updated the pool in place."""
        return self.decoder.pool_ptrs(self.pool)

    def _release_block(self, b: int) -> None:
        """Drop one table reference; the last one frees the block and
        (with sharing on) removes its index node, so the index never
        outlives the live shareable set.  With the kv tier on, a
        materialized indexed block is retained instead: it stays
        allocated and aliasable until pressure evicts it or a row
        references it again."""
        if b == TRASH_BLOCK:
            return
        n = self.ref.get(b, 0) - 1
        if n > 0:
            self.ref[b] = n
            return
        self.ref.pop(b, None)
        if self.tier is not None and self.index.is_materialized(b):
            self.retained[b] = next(self._lru_clock)
            self.stats["retained_peak"] = max(
                self.stats["retained_peak"], len(self.retained)
            )
            return
        if self.index is not None:
            self.index.remove_block(b)
        self.free.append(b)

    # -- the host KV tier (serve/kvtier.py) ------------------------------

    def _tier_fallback(self, op: str, err: Exception) -> None:
        """A tier operation failed after its retries: the caller takes
        the reference's degradation (discard, defer or prefill fresh)
        with the engine's state unchanged, and this leaves the trail: a
        ``serve.kv_tier_fallback`` event, a WARNING Record (``serve.jsonl``
        under the obs run dir, markers on stderr) and the fallbacks
        counter."""
        self.stats["tier_fallbacks"] += 1
        obs.counter("tpu_patterns_serve_kv_tier_fallbacks_total").inc()
        obs.event("serve.kv_tier_fallback", op=op, error=str(err))
        try:
            ResultWriter(
                jsonl_path=os.path.join(obs.run_dir(), "serve.jsonl"),
                stream=sys.stderr,
            ).record(Record(
                pattern="serve",
                mode="kv_tier_fallback",
                commands=op,
                metrics={"pid": float(os.getpid())},
                verdict=Verdict.WARNING,
                notes=[
                    f"kv tier {op} failed after retries ({err}); falling "
                    "back to the tierless path for this wave, device "
                    "state unchanged"
                ],
            ))
        except Exception:  # the trail is best-effort: a healed wave stays
            pass

    def _evict_wave(self, blocks: list[int], rid: int = -1) -> int:
        """Evict retained ``blocks`` (leaf-first-safe) to the host tier in
        one gather.  The order is the mid-evict contract: the blocking
        device->host copy (the pool read, not changed), then the session
        commit, and only then the state transition (node to host, block
        to the free list), so a crash anywhere leaves the device state
        or the previously committed host copy.  Returns the blocks
        evicted (0 on a fallback)."""
        if not blocks:
            return 0

        def attempt():
            # before the copy: nothing mutated, so an error retries
            faults.inject("serve.evict", rid=rid, rows=len(blocks),
                          replica=self.replica)
            out = self.decoder.gather_blocks(self.pool, blocks)
            host = {n: t.to("cpu") for n, t in out.items()}
            return [
                (b, {n: host[n][:, i] for n in host},
                 self.index.node_path(b))
                for i, b in enumerate(blocks)
            ]

        t0 = clock_ns()
        try:
            entries = faults.call_with_retry(
                attempt, policy=self.retry_policy, site="serve.evict"
            )
        except (OSError, faults.Quarantined) as e:
            self._tier_fallback("evict", e)
            return 0
        handles = [self.tier.put(data, path) for _, data, path in entries]
        t1 = clock_ns()
        self.stats["evict_ns"] += t1 - t0
        try:
            # commit before the transition: from here on the host copy
            # is durable, so freeing the device block cannot tear it
            self.tier.commit()
        except OSError as e:  # ckpt.save retried the transients already
            for h in handles:
                self.tier.discard(h)
            self._tier_fallback("evict-commit", e)
            return 0
        self.stats["commit_ns"] += clock_ns() - t1
        for (b, _, _), h in zip(entries, handles):
            self.index.evict_block(b, h)
            self.retained.pop(b, None)
            self.free.append(b)
        if self.store is not None:
            # the host bytes are in hand: publish the wave to the fleet
            # store beside the tier copy (a publish failure never touches
            # the eviction above)
            self._store_publish_entries(
                [(path, data) for _, data, path in entries], rid=rid
            )
        n_bytes = self.tier.block_nbytes() * len(entries)
        self.stats["evictions"] += len(entries)
        self.stats["evict_bytes"] += n_bytes
        obs.counter("tpu_patterns_serve_kv_evictions_total").inc(len(entries))
        # one ledger entry a wave, count = blocks evicted (the counter's
        # identity); free_before takes this wave's blocks back out
        self.decisions.book(
            "evict",
            rid=rid if rid >= 0 else None,
            count=len(entries),
            rationale="free list dry: evict cold retained blocks "
                      "(LRU by last reference, leaf-first) to host",
            victims=",".join(str(b) for b, _, _ in entries),
            free_before=len(self.free) - len(entries),
            retained=len(self.retained),
            host_blocks=len(self.tier),
        )
        obs.histogram("tpu_patterns_serve_kv_evict_bytes").observe(
            float(n_bytes)
        )
        obs.event(
            "serve.kv_evict", blocks=str(len(entries)),
            host_blocks=str(len(self.tier)),
        )
        # the host bound: forget the least-recently-stored blocks with
        # their subtrees; a forgotten prefix prefills again
        while self.tier.over_capacity():
            h = self.tier.oldest()
            for dropped in self.index.remove_handle(h):
                self.tier.discard(dropped)
            self.tier.discard(h)
        return len(entries)

    def _evict_candidates(self, protect: set[int]) -> list[int]:
        """Retained blocks that may evict now: LRU by last reference,
        leaf-first (no device-resident child), minus ``protect`` (the
        blocks an admission is about to alias) and minus pending CoW
        donors, which must keep their contents until ``_cow_copy``."""
        donors = {src for src, _ in self._pending_cow}
        return [
            b for b in sorted(self.retained, key=self.retained.get)
            if b not in protect and b not in donors
            and not self.index.has_resident_children(b)
        ]

    def _evict_for(self, k: int, protect: set[int], rid: int = -1) -> int:
        """Free >= ``k`` blocks by evicting cold retained blocks in
        leaf-first waves (evicting a leaf can make its parent eligible).
        A wave that fails after its retries discards those blocks
        instead (freed with no host copy, their nodes and host subtrees
        dropped): retained blocks are a cache of recomputable K/V, so
        the prefix just prefills again."""
        if self.tier is None or k <= 0:
            return 0
        freed = 0
        while freed < k:
            cands = self._evict_candidates(protect)
            if not cands:
                break
            wave = cands[: k - freed]
            done = self._evict_wave(wave, rid=rid)
            if not done:
                for b in wave:
                    self.retained.pop(b, None)
                    for h in self.index.drop_block_subtree(b):
                        self.tier.discard(h)
                    self.free.append(b)
                done = len(wave)
            freed += done
        return freed

    def _onload(self, handles: list[int], rid: int = -1) -> list[int]:
        """Page tier ``handles`` back onto fresh blocks in one scatter.
        Returns the blocks, device-resident and indexed again; after a
        failure past the retries, ``[]`` with the free list restored, and
        the caller prefills those positions instead."""
        if not handles:
            return []
        blocks = [self.free.pop() for _ in handles]

        def attempt():
            # before the copy: the targets hold garbage either way
            faults.inject("serve.onload", rid=rid, rows=len(handles),
                          replica=self.replica)
            vals = {
                n: torch.stack([self.tier.get(h)[n] for h in handles], 1)
                for n in self.tier.leaf_meta
            }
            self.decoder.onload_blocks(self.pool, vals, blocks)

        t0 = clock_ns()
        try:
            faults.call_with_retry(
                attempt, policy=self.retry_policy, site="serve.onload"
            )
        except (OSError, faults.Quarantined) as e:
            self.free.extend(blocks)
            self._tier_fallback("onload", e)
            return []
        self.stats["onload_ns"] += clock_ns() - t0
        for h, b in zip(handles, blocks):
            self.index.restore_block(h, b)
            self.tier.discard(h)
        n_bytes = self.tier.block_nbytes() * len(handles)
        self.stats["onload_hits"] += len(handles)
        self.stats["onload_bytes"] += n_bytes
        obs.counter("tpu_patterns_serve_kv_onload_hits_total").inc(
            len(handles)
        )
        obs.histogram("tpu_patterns_serve_kv_onload_bytes").observe(
            float(n_bytes)
        )
        obs.event(
            "serve.kv_onload", blocks=str(len(handles)),
            host_blocks=str(len(self.tier)),
        )
        return blocks

    # -- the fleet prefix store (serve/store.py) -------------------------

    def _store_fallback(self, op: str, err: Exception) -> None:
        """A store operation failed past its retries: degrade to fresh
        prefill (or skip the publication) for this wave, engine state
        unchanged, and leave the trail: a ``serve.store_fallback`` event,
        a WARNING Record (``serve.jsonl`` under the obs run dir, markers
        on stderr) and the fallbacks counter."""
        self.stats["store_fallbacks"] += 1
        obs.counter("tpu_patterns_store_fallbacks_total").inc()
        obs.event("serve.store_fallback", op=op, error=str(err))
        try:
            ResultWriter(
                jsonl_path=os.path.join(obs.run_dir(), "serve.jsonl"),
                stream=sys.stderr,
            ).record(Record(
                pattern="serve",
                mode="store_fallback",
                commands=op,
                metrics={"pid": float(os.getpid())},
                verdict=Verdict.WARNING,
                notes=[
                    f"prefix store {op} failed after retries ({err}); "
                    "degrading to fresh prefill for this wave — "
                    "engine state unchanged, never torn"
                ],
            ))
        except Exception:  # the trail is best-effort: a healed wave stays
            pass

    def _store_enqueue(self, blocks) -> None:
        """Queue newly materialized blocks for publication.  The path is
        captured now: block ids are recycled, and the publish wave checks
        the pair again before it gathers."""
        if self.store is None:
            return
        for b in blocks:
            path = self.index.node_path(b)
            if path and path not in self._store_published:
                self._store_pending.append((b, path))

    def _store_publish_entries(self, entries, rid: int = -1) -> int:
        """Commit host-side block payloads (``[(path, {leaf: CPU
        tensor})]``) under the ``store.publish`` site: tmp +
        ``os.replace`` a block.  Returns the blocks published; a failure
        past the retries skips the publication, local serving
        untouched."""
        todo = [
            (path, data) for path, data in entries
            if tuple(path) not in self._store_published
        ]
        if self.store is None or not todo:
            return 0

        def attempt():
            # before any file I/O: a retried publish rewrites the same
            # content under the same keys
            faults.inject(
                "store.publish", rid=rid, rows=len(todo),
                replica=self.replica,
                fingerprint=block_fingerprint(todo[0][0]),
            )
            return sum(self.store.publish(data, path) for path, data in todo)

        try:
            n_bytes = faults.call_with_retry(
                attempt, policy=self.retry_policy, site="store.publish"
            )
        except (OSError, faults.Quarantined) as e:
            self._store_fallback("publish", e)
            return 0
        for path, _ in todo:
            self._store_published.add(tuple(path))
        self.stats["store_publishes"] += len(todo)
        self.stats["store_publish_bytes"] += n_bytes
        obs.counter("tpu_patterns_store_publishes_total").inc(len(todo))
        obs.histogram("tpu_patterns_store_publish_bytes").observe(
            float(n_bytes)
        )
        obs.event("serve.store_publish", blocks=str(len(todo)),
                  replica=self.replica)
        return len(todo)

    def _store_publish_wave(self, limit: int = 8, rid: int = -1) -> int:
        """Publish up to ``limit`` pending materialized blocks in one
        gather (the pool is read, not changed), at an iteration boundary:
        a SIGKILLed replica cannot be asked for its warm set afterwards,
        so the set must already be in the store."""
        if self.store is None or not self._store_pending:
            return 0
        batch: list[tuple[int, tuple[int, ...]]] = []
        while self._store_pending and len(batch) < limit:
            b, path = self._store_pending.pop(0)
            # a stale pair: published meanwhile, evicted or freed, or the
            # block id recycled under another path
            if (path in self._store_published
                    or not self.index.is_materialized(b)
                    or self.index.node_path(b) != path):
                continue
            batch.append((b, path))
        if not batch:
            return 0
        out = self.decoder.gather_blocks(self.pool, [b for b, _ in batch])
        host = {n: t.to("cpu") for n, t in out.items()}
        return self._store_publish_entries(
            [(path, {n: host[n][:, i] for n in host})
             for i, (_, path) in enumerate(batch)],
            rid=rid,
        )

    def _store_flush(self) -> int:
        """Drain or run-end flush: the pending device-resident blocks and
        the host tier's resident set reach the store before the engine
        exits, so fail-over reroutes and restarts land warm."""
        if self.store is None:
            return 0
        n = 0
        while self._store_pending:
            done = self._store_publish_wave()
            if not done and self._store_pending:
                # a deterministic publish failure (or an all-stale tail):
                # drop the rest, the flush must not wedge the shutdown
                self._store_pending = []
                break
            n += done
        n += self._store_publish_entries([
            (self.tier.paths[h], self.tier.get(h))
            for h in sorted(self.tier.store)
        ])
        return n

    def _store_fetch(self, req: Request, need: int, covered: int
                     ) -> list[int]:
        """The admission-miss consult: extend the plan's coverage with
        store blocks, contiguously from ``covered`` full blocks deep.
        Each hit lands in the host tier and the index
        (``add_host_path``) and returns as a restore handle, which the
        caller onloads like a local tier hit.  A miss or failure stops
        the run: coverage stays a contiguous prefix, the rest prefills
        fresh."""
        out: list[int] = []
        if self.store is None:
            return out
        bl = self.layout.block_len
        for j in range(covered, min(need, len(req.tokens) // bl)):
            path = tuple(req.tokens[: (j + 1) * bl])

            def attempt(path=path):
                # before the read: nothing adopted yet, an error retries
                faults.inject(
                    "store.fetch", rid=req.rid, replica=self.replica,
                    fingerprint=block_fingerprint(path),
                )
                return self.store.fetch(path)

            try:
                data = faults.call_with_retry(
                    attempt, policy=self.retry_policy, site="store.fetch"
                )
            except (OSError, faults.Quarantined) as e:
                self._store_fallback("fetch", e)
                break
            except ValueError as e:
                # a foreign-config or corrupt entry, refused by the store
                self._store_fallback("fetch-validate", e)
                break
            if data is None:
                break  # a miss at depth j: no deeper entry can help
            h = self.tier.put(data, path)
            if not self.index.add_host_path(path, h):
                # a duplicate: the local copy wins
                self.tier.discard(h)
                break
            out.append(h)
            self._store_published.add(path)  # already in the store
            self.stats["store_hits"] += 1
            self.stats["store_fetch_bytes"] += self.store.block_nbytes()
            obs.counter("tpu_patterns_store_hits_total").inc()
            obs.histogram("tpu_patterns_store_fetch_bytes").observe(
                float(self.store.block_nbytes())
            )
        if out:
            obs.event("serve.store_fetch", rid=str(req.rid),
                      blocks=str(len(out)), replica=self.replica)
        return out

    def prewarm_paths(self, paths) -> int:
        """Scale-out pre-warm: fetch the ring arc's hottest prefixes from
        the store into the host tier, shallow-first (the first admission
        hit pages them onto the device).  A failure stops the walk: a
        cold replica is correct, only slower.  Returns the blocks
        fetched."""
        if self.store is None:
            return 0
        n = 0
        for path in sorted((tuple(int(t) for t in p) for p in paths),
                           key=lambda p: (len(p), p)):
            if not path or len(path) % self.layout.block_len:
                continue

            def attempt(path=path):
                faults.inject(
                    "store.prewarm", replica=self.replica,
                    fingerprint=block_fingerprint(path),
                )
                return self.store.fetch(path)

            try:
                data = faults.call_with_retry(
                    attempt, policy=self.retry_policy, site="store.prewarm"
                )
            except (OSError, faults.Quarantined) as e:
                self._store_fallback("prewarm", e)
                break
            except ValueError as e:
                self._store_fallback("prewarm-validate", e)
                break
            if data is None:
                continue
            h = self.tier.put(data, path)
            if not self.index.add_host_path(path, h):
                self.tier.discard(h)
                continue
            self._store_published.add(path)
            n += 1
        if n:
            self.stats["store_prewarmed"] += n
            obs.counter("tpu_patterns_store_prewarms_total").inc(n)
            obs.event("serve.store_prewarm", blocks=str(n),
                      replica=self.replica)
        return n

    def save_session(self) -> None:
        """Persist the session cache: evict every retained block to the
        tier in leaf-first waves and commit, so finished conversations'
        prefixes survive a restart.  No-op without a session dir."""
        if self.tier is None or not self.tier.session_dir:
            return
        while True:
            cands = self._evict_candidates(set())
            if not cands or not self._evict_wave(cands):
                break
        # a final commit even when nothing evicted: restores may have
        # drained the store since the last wave's commit
        try:
            self.tier.commit()
        except OSError as e:
            self._tier_fallback("session-commit", e)

    # -- retirement and the ladder's rungs -------------------------------

    def _retire(self) -> None:
        still = []
        for s in self.active:
            if len(s.out) >= s.n_gen:
                for b in s.table:
                    self._release_block(b)
                self.slot_pool.release(s.slot, reusable=True)
                self.inflight.release(s.rid)
                self.cost.drop(s.rid)
                if s.rid in self.preempted_partial:
                    # a resumed leg: its banked output goes in front, and
                    # the lifecycle sees the whole stream with the first
                    # leg's first token
                    s.out = self.preempted_partial.pop(s.rid) + s.out
                    s.t_first_ns = (
                        self.preempted_first_ns.pop(s.rid, None)
                        or s.t_first_ns
                    )
                    self.stats["preempted_resumed"] += 1
                self.done[s.rid] = s.out
                self._finalize_lifecycle(s, "done")
                obs.counter("tpu_patterns_serve_requests_total").inc()
            else:
                still.append(s)
        self.active = still

    def _finalize_lifecycle(self, s: _Slot, status: str) -> None:
        """Close out a request: its lifecycle entry, the burn monitor's
        booking, the TTFT/TPOT histograms and its queued/prefill/decode
        lifecycle spans (one Chrome-trace lane a request), all from host
        stamps the loop already took (no device sync)."""
        now = clock_ns()
        admit = s.t_admit_ns or now
        first = s.t_first_ns or now
        last = s.t_last_ns or first
        n_out = len(s.out)
        ttft_ms = (first - s.t_submit_ns) / 1e6 if s.t_first_ns else None
        tpot_ms = (
            (last - first) / (n_out - 1) / 1e6
            if s.t_first_ns and n_out > 1
            else None
        )
        e2e_ms = (last - s.t_submit_ns) / 1e6
        met = (
            status == "done"
            and (s.deadline_ms <= 0 or e2e_ms <= s.deadline_ms)
        )
        self.lifecycle[s.rid] = {
            "status": status, "scenario": s.scenario, "n_out": n_out,
            "priority": s.priority,
            "submit_ns": s.t_submit_ns, "admit_ns": s.t_admit_ns,
            "first_ns": s.t_first_ns, "last_ns": last,
            "ttft_ms": ttft_ms, "tpot_ms": tpot_ms, "e2e_ms": e2e_ms,
            "deadline_ms": s.deadline_ms, "met": met,
        }
        # a request that never finished books its whole budget as bad
        self.slo.observe(
            tokens=n_out if status == "done" else max(s.n_gen, 1),
            met=met, ttft_ms=ttft_ms, tpot_ms=tpot_ms,
            priority=s.priority,
        )
        if ttft_ms is not None:
            obs.histogram("tpu_patterns_serve_ttft_ms").observe(ttft_ms)
        if tpot_ms is not None:
            obs.histogram("tpu_patterns_serve_tpot_ms").observe(tpot_ms)
        # one lane a request in the Chrome trace: queued -> prefill
        # (admission to first token) -> decode, with first-token and
        # retirement instants (obs/export.py names the lane "req <rid>")
        lane = self._lane_base + s.rid
        attrs = {"rid": s.rid}
        if s.scenario:
            attrs["scenario"] = s.scenario
        # the fleet's identity: the replica id qualifies the merged trace's
        # lane (every replica restarts rids at 0) and the journey id makes
        # the lifecycle spans journey anchors
        if self.replica:
            attrs["replica"] = self.replica
        if s.jid:
            attrs["jid"] = s.jid
        if s.t_admit_ns:
            obs.complete_span(
                "req.queued", s.t_submit_ns, s.t_admit_ns - s.t_submit_ns,
                tid=lane, **attrs,
            )
        if s.t_admit_ns and s.t_first_ns:
            obs.complete_span(
                "req.prefill", admit, first - admit, tid=lane, **attrs
            )
        if s.t_first_ns:
            obs.complete_span(
                "req.first_token", first, 0, tid=lane, **attrs
            )
            obs.complete_span(
                "req.decode", first, last - first, tid=lane,
                tokens=n_out, **attrs,
            )
        obs.complete_span(
            "req.retired" if status == "done" else "req.failed",
            last, 0, tid=lane, **attrs,
        )

    def _shed_request(self, rid: int, reason: str,
                      priority: str = "interactive",
                      rung: str = "head") -> None:
        """Terminal shed bookkeeping of the burn ladder: counted, never
        dropped silently.  A shed resumed leg abandons its banked
        output.  ``rung`` names the ladder's rung that shed it (``bulk``:
        queued bulk first; ``head``: both earlier rungs exhausted)."""
        self.shed[rid] = reason
        self.preempted_partial.pop(rid, None)
        self.preempted_first_ns.pop(rid, None)
        self.stats["sheds"] += 1
        obs.counter("tpu_patterns_serve_shed_total", priority=priority).inc()
        obs.counter("tpu_patterns_decision_shed_rung_total", rung=rung).inc()
        obs.event("serve.shed", rid=str(rid), priority=priority)
        burn = self.slo.snapshot()
        self.decisions.book(
            "shed", rid=rid,
            rationale=reason, rung=rung, priority=priority,
            burn_fast=round(burn.get("burn_rate_fast", 0.0), 4),
            burn_slow=round(burn.get("burn_rate_slow", 0.0), 4),
            queue=len(self.queue), active=len(self.active),
        )

    def _preempt_victim(self) -> _Slot | None:
        """The bulk row to preempt next: the most recently admitted one
        (LIFO: the oldest has banked the most work), skipping finished
        rows and rows whose blocks ride a pending CoW copy."""
        pending = {b for pair in self._pending_cow for b in pair}
        for s in reversed(self.active):
            if s.priority != "bulk" or len(s.out) >= s.n_gen:
                continue
            if any(b in pending for b in s.table):
                continue
            return s
        return None

    def _preempt_slot(self, s: _Slot, protect=frozenset()) -> None:
        """Preempt running row ``s``: index its fully written blocks,
        release the row, force the now-retained blocks through the evict
        path into the host tier, and requeue the request as a forced
        session carrying its output so far.  Re-admission restores or
        aliases those blocks, so no full block is recomputed.
        ``protect`` blocks (an admission's alias set) stay on the
        device."""
        self.active.remove(s)
        # K/V is written for positions [0, lens + steps): the prompt and
        # every fed generated token; only those full blocks are indexed
        ctx = s.prompt + s.out
        n_kv = s.lens + s.steps
        self.index.materialize(self.index.insert(ctx[:n_kv], s.table))
        # the pressure signals at decision time, read before the release
        # frees the victim's blocks (the ledger carries what the
        # scheduler saw)
        free_at_decision = len(self.free)
        occ_at_decision = round(self._occupancy(), 4)
        for b in s.table:
            self._release_block(b)
        self.slot_pool.release(s.slot, reusable=True)
        self.inflight.release(s.rid)
        self.cost.drop(s.rid)
        # a block another row still references (or a protected one)
        # stays on the device and aliases on resume
        want = {b for b in s.table if b in self.retained} - set(protect)
        while want:
            wave = [b for b in self._evict_candidates(set(protect))
                    if b in want]
            if not wave or not self._evict_wave(wave, rid=s.rid):
                break
            want -= set(wave)
        self.preempted_partial[s.rid] = (
            self.preempted_partial.get(s.rid, []) + list(s.out)
        )
        if s.t_first_ns and s.rid not in self.preempted_first_ns:
            self.preempted_first_ns[s.rid] = s.t_first_ns
        self.preempted_rids.add(s.rid)
        # the remainder goes to the back of the queue with its original
        # submit time; the banked tokens keep their draw indices, so the
        # key sequence continues where the preempted stream stopped
        self.queue.append((
            Request(
                rid=s.rid, tokens=ctx, n_gen=s.n_gen - len(s.out),
                scenario=s.scenario, deadline_ms=s.deadline_ms,
                priority="bulk", temperature=s.temperature, top_k=s.top_k,
                top_p=s.top_p, seed=s.seed,
                gen_offset=s.gen_offset + len(s.out), jid=s.jid,
            ),
            s.t_submit_ns,
        ))
        self.stats["preempted"] += 1
        obs.counter("tpu_patterns_serve_preempted_total",
                    priority="bulk").inc()
        obs.event(
            "serve.preempted", rid=str(s.rid), replica=self.replica,
            banked=str(len(s.out)),
        )
        burn = self.slo.snapshot()
        self.decisions.book(
            "preempt", rid=s.rid, jid=s.jid,
            rationale="bulk victim parked to host tier (LIFO: least "
                      "banked decode work), remainder re-queued as "
                      "forced session",
            banked=len(s.out), free=free_at_decision,
            occupancy=occ_at_decision, queue=len(self.queue),
            burn_fast=round(burn.get("burn_rate_fast", 0.0), 4),
        )

    def _try_preempt(self, protect=frozenset()) -> bool:
        """One guarded preemption: pick a bulk victim and force it out.
        The ``serve.preempt`` site fails open: an injected error aborts
        the preemption (the victim runs on) and the caller degrades to
        its next rung."""
        if self.preempt != "bulk":
            return False
        victim = self._preempt_victim()
        if victim is None:
            return False
        try:
            faults.inject("serve.preempt", rid=victim.rid,
                          replica=self.replica)
        except faults.InjectedFault:
            return False
        self._preempt_slot(victim, protect=protect)
        return True

    def _admit(self) -> list[tuple[Request, _Slot]]:
        """Pull queued requests FIFO into free slots while blocks last; a
        head the pool cannot cover DEFERS (stays queued, one deferral
        counted) and ends admission, so later requests cannot starve
        it.

        With prefix sharing on, the prompt's indexed whole-block prefix
        aliases existing blocks (refcount + 1, no allocation), a partial
        boundary match claims one fresh block to copy the donor into,
        and only the rest draws on the free list.  With the kv tier the
        host-resident continuation of that prefix pages back onto fresh
        blocks, and a dry free list first evicts cold retained blocks
        (alias -> evict -> defer).

        Under ``preempt="bulk"`` an interactive head meeting a full
        active set, or a free list still short after eviction, preempts
        running bulk rows first.  While a burn episode is active under
        ``burn_mitigation="shed"``, the queue's first bulk request that
        is not a resumed leg is shed, else a running bulk row preempts,
        else the head is shed (the reference's ladder)."""
        admitted: list[tuple[Request, _Slot]] = []
        while self.queue:
            if self.burn_mitigation == "shed" and self.slo.mitigating():
                bi = next((i for i, (r, _) in enumerate(self.queue)
                           if r.priority == "bulk"
                           and r.rid not in self.preempted_partial), None)
                if bi is None and self._try_preempt():
                    continue
                shed_i = 0 if bi is None else bi
                req, _ = self.queue[shed_i]
                try:
                    faults.inject("serve.shed", rid=req.rid,
                                  replica=self.replica)
                except faults.InjectedFault:
                    pass  # fails open: the request admits as usual
                else:
                    self.queue.pop(shed_i)
                    self._shed_request(
                        req.rid,
                        "shed: slo burn-rate mitigation active"
                        + (" (bulk first)" if bi is not None else ""),
                        priority=req.priority,
                        rung="bulk" if bi is not None else "head",
                    )
                    continue
            # one scheduler slot a row (max_leased == slots): None means
            # the active set is full, which ends admission (width, not
            # pool pressure: no deferral)
            slot_tok = self.slot_pool.lease()
            if slot_tok is None:
                # an interactive head may free a slot by preempting a
                # running bulk row
                if (self.queue[0][0].priority == "interactive"
                        and self._try_preempt()):
                    slot_tok = self.slot_pool.lease()
                if slot_tok is None:
                    break
            req, t_submit = self.queue[0]
            need = self._blocks_needed(req)
            plan = (self.index.plan(req.tokens)
                    if self.index is not None else None)
            # the index never covers more than the prompt's blocks, but
            # aliasing more than the table holds would leak references
            aliased = list(plan.aliased)[:need] if plan else []
            restores = (list(plan.restores)[: need - len(aliased)]
                        if plan and self.tier is not None else [])
            if self.store is not None:
                # the fleet store consult: an admission miss extends its
                # coverage with blocks a sibling replica published; they
                # land in the tier and the index and ride the onload
                # below like a local restore (a miss or failure prefills
                # fresh, never a half-adopted block)
                restores += self._store_fetch(
                    req, need, len(aliased) + len(restores)
                )
            # restore targets and fresh blocks both draw on the free
            # list: a dry one evicts cold retained blocks first, sparing
            # the blocks this admission aliases and its CoW donor
            device_need = need - len(aliased)
            protect = set(aliased)
            if plan is not None and plan.donor is not None:
                protect.add(plan.donor)
            if device_need > len(self.free):
                self._evict_for(device_need - len(self.free), protect,
                                rid=req.rid)
            while (device_need > len(self.free)
                   and req.priority == "interactive"
                   and self._try_preempt(protect=protect)):
                self._evict_for(device_need - len(self.free), protect,
                                rid=req.rid)
            if device_need > len(self.free):
                self.slot_pool.release(slot_tok, reusable=True)
                self.stats["deferrals"] += 1
                obs.counter("tpu_patterns_serve_deferrals_total").inc()
                obs.event(
                    "serve.defer", rid=str(req.rid),
                    need=device_need, free=len(self.free),
                )
                self.decisions.book(
                    "defer", rid=req.rid, jid=req.jid,
                    rationale="pool pressure: fresh-block need exceeds "
                              "free list after evict/preempt rungs",
                    need=device_need, free=len(self.free),
                    queue=len(self.queue), active=len(self.active),
                    occupancy=round(self._occupancy(), 4),
                )
                break
            self.queue.pop(0)
            if aliased and need > len(self.free):
                # without its aliased blocks this request would not have
                # fit now: the admission the kv-tier Record counts
                self.stats["pressure_admits"] += 1
            # the tier's capacity drop may have forgotten some of the
            # restore run: keep its contiguous head, prefill the rest
            for i, h in enumerate(restores):
                if h not in self.tier.store:
                    restores = restores[:i]
                    break
            restored = self._onload(restores, rid=req.rid)
            fresh = [self.free.pop()
                     for _ in range(need - len(aliased) - len(restored))]
            table = aliased + restored + fresh
            for b in aliased + restored:
                self.ref[b] = self.ref.get(b, 0) + 1
                self.retained.pop(b, None)
            for b in fresh:
                self.ref[b] = 1
            covered = len(aliased) + len(restored)
            write_from = covered * self.layout.block_len
            # the donor lies below the deepest matched node: it covers
            # real positions only if every planned restore landed
            donor_ok = plan is not None and plan.donor is not None and (
                not plan.restores or len(restored) == len(plan.restores)
            )
            if donor_ok and fresh:
                # CoW: the boundary block copies the donor, then this row
                # overwrites its own tail from the split point
                self._pending_cow.append((plan.donor, fresh[0]))
                write_from += plan.donor_len
                self.stats["cow_copies"] += 1
                obs.counter("tpu_patterns_serve_cow_copies_total").inc()
                obs.event(
                    "serve.cow_copy", rid=str(req.rid),
                    donor=plan.donor, dst=fresh[0],
                )
            if covered:
                self.stats["prefix_hit_blocks"] += covered
                obs.counter(
                    "tpu_patterns_serve_prefix_hit_blocks_total"
                ).inc(covered)
            fresh_full = max(
                0, len(req.tokens) // self.layout.block_len - covered
            )
            self.stats["prompt_fresh_full_blocks"] += fresh_full
            self.fresh_by_rid[req.rid] = (
                self.fresh_by_rid.get(req.rid, 0) + fresh_full
            )
            own_blocks: tuple[int, ...] = ()
            if self.index is not None:
                own_blocks = tuple(self.index.insert(req.tokens, table))
            now = clock_ns()
            slot = _Slot(
                rid=req.rid, lens=len(req.tokens), steps=0, n_gen=req.n_gen,
                table=table, last_tok=-1, out=[], t_submit_ns=t_submit,
                prompt=list(req.tokens),
                write_from=min(write_from, len(req.tokens)),
                own_blocks=own_blocks,
                scenario=req.scenario, deadline_ms=req.deadline_ms,
                priority=req.priority, temperature=req.temperature,
                top_k=req.top_k, top_p=req.top_p, seed=req.seed,
                gen_offset=req.gen_offset, t_admit_ns=now, slot=slot_tok,
                jid=req.jid,
            )
            self.inflight.acquire(req.rid, slot)
            # the row's residency integral opens: it holds len(table)
            # block references until it retires
            self.cost.hold(req.rid, len(table), scenario=req.scenario,
                           priority=req.priority)
            if req.jid:
                # the journey anchor at admission: it ships at the next
                # iteration boundary, so even a replica SIGKILLed later has
                # placed the request on its leg (obs/fleet.py)
                obs.event("journey.admit", jid=req.jid, rid=str(req.rid),
                          replica=self.replica)
            self.stats["queue_wait_ns"].append(now - t_submit)
            obs.histogram("tpu_patterns_serve_queue_wait_ms").observe(
                (now - t_submit) / 1e6
            )
            admitted.append((req, slot))
        return admitted

    def _tables_array(self, slots: list[_Slot], rows: int) -> np.ndarray:
        t = np.full((rows, self.n_pages), TRASH_BLOCK, np.int32)
        for i, s in enumerate(slots):
            t[i, : len(s.table)] = s.table
        return t

    def _sampling_args(self, slots: list[_Slot], rows: int) -> tuple:
        """The sampling cores' per-row (seeds, gidx, temp, topk, topp):
        row i's next draw is keyed (seed, gen_offset + len(out)), the
        request's global generated-token index.  Empty when the decoder
        has no sampling cores."""
        if not self.decoder.sampling:
            return ()
        seeds = np.zeros((rows,), np.int32)
        gidx = np.zeros((rows,), np.int32)
        temp = np.zeros((rows,), np.float32)
        topk = np.zeros((rows,), np.int32)
        topp = np.ones((rows,), np.float32)
        for i, s in enumerate(slots):
            seeds[i] = s.seed
            gidx[i] = s.gen_offset + len(s.out)
            temp[i] = s.temperature
            topk[i] = s.top_k
            topp[i] = s.top_p
        return seeds, gidx, temp, topk, topp

    def _cow_copy(self) -> None:
        """Run the pending copy-on-write boundary copies in one call,
        padded to a power-of-two lane count with TRASH self-copies, and
        clear them: a retried prefill finds them done and copies
        nothing twice."""
        if not self._pending_cow:
            return
        n = _bucket(len(self._pending_cow), self.slots)
        src = np.full((n,), TRASH_BLOCK, np.int32)
        dst = np.full((n,), TRASH_BLOCK, np.int32)
        for i, (a, b) in enumerate(self._pending_cow):
            src[i], dst[i] = a, b
        self.decoder.copy_blocks(self.pool, src, dst)
        self._pending_cow = []

    def _prefill(self, admitted: list[tuple[Request, _Slot]]) -> None:
        reqs = [r for r, _ in admitted]
        slots = [s for _, s in admitted]
        lmax = max(len(r.tokens) for r in reqs)
        lpad = _bucket(lmax, self.n_pages * self.layout.block_len)
        rows = _bucket(len(reqs), self.slots)
        tokens = np.zeros((rows, lpad), np.int32)
        lens = np.zeros((rows,), np.int32)
        # the write fence: positions below it sit in shared blocks already
        start = np.zeros((rows,), np.int32)
        active = np.zeros((rows,), bool)
        for i, r in enumerate(reqs):
            tokens[i, : len(r.tokens)] = r.tokens
            lens[i] = len(r.tokens)
            start[i] = slots[i].write_from
            active[i] = True
        tables = self._tables_array(slots, rows)
        # before the CoW copies and the launch: nothing is written yet,
        # so an ``error`` here retries from the same state
        faults.inject("serve.prefill", rows=len(reqs), replica=self.replica)
        t0 = clock_ns()
        with obs.span("serve.prefill", deadline_s=self.watchdog_s or None,
                      rows=len(reqs), lpad=lpad):
            self._cow_copy()
            tok0 = self.decoder.prefill(
                self.params, self.pool, tokens, lens, start, tables, active,
                *self._sampling_args(slots, rows),
            )
            # the scheduler's one sync per call: ids must reach the host
            tok0 = tok0.cpu().numpy()
        t_tok = clock_ns()  # the wave's first tokens are on the host
        obs.histogram("tpu_patterns_serve_prefill_ms").observe(
            (t_tok - t0) / 1e6
        )
        # the wave's wall, split equal-share over its rows
        self.cost.book_prefill(
            t_tok - t0, [(r.rid, r.scenario, r.priority) for r in reqs]
        )
        for i, s in enumerate(slots):
            s.last_tok = int(tok0[i])
            s.out.append(s.last_tok)
            s.write_from = 0  # fence spent: the wave is on the device
            s.t_first_ns = s.t_last_ns = t_tok
            self.first_ns.setdefault(s.rid, t_tok)
            self.stats["tokens"] += 1
        if self.index is not None:
            for s in slots:
                self.index.materialize(list(s.own_blocks))
                # a prefilled full block is immutable (CoW): queue it for
                # the fleet store's next publish wave
                self._store_enqueue(s.own_blocks)
        obs.counter("tpu_patterns_serve_tokens_total").inc(len(slots))
        self.stats["prefills"] += 1
        self.active.extend(slots)

    # -- the disaggregated prefill/decode handoff -------------------------

    def _spool_path(self, rid: int) -> str:
        return os.path.join(self.spool_dir, f"kv-{rid}.npz")

    def _handoff_wave(self) -> None:
        """Prefill-role tail of an iteration: every active row has its
        first token and its prompt's K/V in the pool, so ship each one to
        the decode pool and release everything this engine held.

        The wire is the gather (the pool is read, not changed, so a retry
        starts from the same state) -> the block stream (``PagedDecoder.
        stream``: the payload pair-exchanged over sp and back, consumed on
        the way) -> one device->host copy of the shipped blocks -> an
        atomically spooled ``kv-<rid>.npz`` (tmp + ``os.replace``: a crash
        leaves the complete file or none), its leaves as the host tier
        stores them (a bfloat16 leaf as two-byte void members).  The
        ``disagg.transfer`` site fires before the gather; past its
        retries the handoff degrades to a no-payload manifest
        (``recompute``) and the decode pool prefills the prompt again,
        with the same ids.  Blocks go back through the retire ladder
        (:meth:`_release_block`), so with the kv tier on this replica's
        shipped prefixes stay retained as a prefix cache."""
        leaves = self.decoder._pool_leaves()
        for s in list(self.active):
            n_ship = self.layout.blocks_for(s.lens)
            path = self._spool_path(s.rid) if self.spool_dir else ""
            nbytes = 0
            recompute = not path

            def attempt(s=s, n_ship=n_ship, path=path):
                # before the gather: nothing spooled, nothing mutated, so
                # an ``error`` retries cleanly and a ``kill`` leaves no
                # partial spool file
                faults.inject("disagg.transfer", rid=s.rid,
                              replica=self.replica, blocks=n_ship)
                wire = self.decoder.stream(
                    self.decoder.gather_blocks(self.pool, s.table[:n_ship])
                )
                # the ship: every leaf's copy to the host queued, then the
                # one wait for all of them
                host = {n: t.to("cpu", non_blocking=True)
                        for n, t in wire.items()}
                self.decoder.sync()
                arrays = {n: leaf_to_numpy(t, leaves[n][1])
                          for n, t in host.items()}
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    np.savez(f, **arrays)
                os.replace(tmp, path)
                return sum(a.nbytes for a in arrays.values())

            if not recompute:
                try:
                    nbytes = faults.call_with_retry(
                        attempt, policy=self.retry_policy,
                        site="disagg.transfer",
                    )
                except (OSError, faults.Quarantined) as e:
                    recompute, path, nbytes = True, "", 0
                    self.stats["handoff_recomputes"] += 1
                    obs.event("disagg.transfer_degraded", rid=str(s.rid),
                              replica=self.replica, reason=str(e)[:120])
            self.handoffs[s.rid] = {
                "rid": s.rid, "jid": s.jid,
                "prompt": list(s.prompt), "n_gen": s.n_gen,
                "scenario": s.scenario, "deadline_ms": s.deadline_ms,
                "priority": s.priority,
                "temperature": s.temperature, "top_k": s.top_k,
                "top_p": s.top_p, "seed": s.seed,
                "gen_offset": s.gen_offset,
                "tok0": s.out[0],
                "t_submit_ns": s.t_submit_ns,
                "t_first_ns": s.t_first_ns,
                "path": path,
                "blocks": 0 if recompute else n_ship,
                "nbytes": nbytes,
                "recompute": recompute,
            }
            for b in s.table:
                self._release_block(b)
            self.slot_pool.release(s.slot, reusable=True)
            self.inflight.release(s.rid)
            self.cost.drop(s.rid)
            self.active.remove(s)
            self.stats["handoffs"] += 1
            self.stats["transfer_bytes"] += nbytes
            obs.event("serve.handoff", rid=str(s.rid), replica=self.replica,
                      blocks=str(0 if recompute else n_ship),
                      recompute=str(recompute))

    def _resubmit_adopt(self, msg: dict) -> None:
        """The recompute degradation: queue the handed-off request for a
        local prefill on this (decode) pool.  Greedy ids and the sampled
        keys ``(seed, gen_offset + n)`` depend only on the prompt and the
        request's own stream position, so the output equals the adopted
        path's: at worst recompute, never corruption."""
        self.stats["adopt_recomputes"] += 1
        self.submit(
            Request(
                rid=msg["rid"], tokens=list(msg["prompt"]),
                n_gen=msg["n_gen"], scenario=msg["scenario"],
                deadline_ms=msg["deadline_ms"], jid=msg["jid"],
                priority=msg["priority"],
                temperature=msg["temperature"], top_k=msg["top_k"],
                top_p=msg["top_p"], seed=msg["seed"],
                gen_offset=msg["gen_offset"],
            ),
            t_submit_ns=msg["t_submit_ns"],
        )

    def _admit_adopts(self) -> None:
        """Decode-role head of an iteration: adopt queued handoff
        payloads onto fresh blocks, FIFO, while slots and blocks last.

        Adoption reserves the request's whole lifetime rectangle (as
        admission does), onloads the shipped prompt blocks in one copy
        and seats a slot indistinguishable from one this engine
        prefilled: lens at the prompt boundary, steps 0, the shipped
        first token as ``last_tok``, so the first decode step writes
        tok0's K/V where the unified engine would.  The ``disagg.adopt``
        site fires before the onload (the targets came off the free list
        holding garbage, so an error retries and no adopted block is ever
        torn); past its retries the blocks go back and the request
        prefills locally (:meth:`_resubmit_adopt`)."""
        leaves = self.decoder._pool_leaves()
        while self.adopt_queue:
            msg = self.adopt_queue[0]
            if msg.get("recompute"):
                self.adopt_queue.pop(0)
                self._resubmit_adopt(msg)
                continue
            lens = len(msg["prompt"])
            need = self.layout.blocks_for(lens + max(msg["n_gen"] - 1, 0))
            if need > self.layout.n_blocks - 1:
                self.adopt_queue.pop(0)
                self.failed[msg["rid"]] = (
                    f"adopt needs {need} blocks; pool has "
                    f"{self.layout.n_blocks - 1}"
                )
                continue
            slot_tok = self.slot_pool.lease()
            if slot_tok is None:
                break  # the active set is full: adopt next iteration
            if need > len(self.free):
                self._evict_for(need - len(self.free), set(),
                                rid=msg["rid"])
            if need > len(self.free):
                self.slot_pool.release(slot_tok, reusable=True)
                self.stats["deferrals"] += 1
                obs.counter("tpu_patterns_serve_deferrals_total").inc()
                obs.event("serve.defer", rid=str(msg["rid"]), need=need,
                          free=len(self.free))
                self.decisions.book(
                    "defer", rid=msg["rid"], jid=msg["jid"],
                    rationale="pool pressure: adopted-block need "
                              "exceeds free list after evict rung",
                    need=need, free=len(self.free),
                    adopt_queue=len(self.adopt_queue),
                    active=len(self.active),
                )
                break  # FIFO: later adoptions must not starve this one
            self.adopt_queue.pop(0)
            blocks = [self.free.pop() for _ in range(need)]
            n_ship = msg["blocks"]

            def attempt(msg=msg, blocks=blocks, n_ship=n_ship):
                # before the read and the onload: the targets hold
                # garbage either way, so an ``error`` retries cleanly
                faults.inject("disagg.adopt", rid=msg["rid"],
                              replica=self.replica, blocks=n_ship)
                with np.load(msg["path"]) as data:
                    vals = {n: leaf_from_numpy(data[n], dt)
                            for n, (_, dt) in leaves.items()}
                self.decoder.onload_blocks(self.pool, vals, blocks[:n_ship])

            try:
                faults.call_with_retry(attempt, policy=self.retry_policy,
                                       site="disagg.adopt")
            except (OSError, faults.Quarantined) as e:
                self.free.extend(blocks)
                self.slot_pool.release(slot_tok, reusable=True)
                obs.event("disagg.adopt_degraded", rid=str(msg["rid"]),
                          replica=self.replica, reason=str(e)[:120])
                self._resubmit_adopt(msg)
                continue
            for b in blocks:
                self.ref[b] = 1
            own_blocks: tuple[int, ...] = ()
            if self.index is not None:
                own_blocks = tuple(
                    self.index.insert(list(msg["prompt"]), blocks)
                )
                self.index.materialize(list(own_blocks))
            s = _Slot(
                rid=msg["rid"], lens=lens, steps=0, n_gen=msg["n_gen"],
                table=blocks, last_tok=msg["tok0"], out=[msg["tok0"]],
                t_submit_ns=msg["t_submit_ns"],
                prompt=list(msg["prompt"]), write_from=0,
                own_blocks=own_blocks, scenario=msg["scenario"],
                deadline_ms=msg["deadline_ms"], jid=msg["jid"],
                priority=msg["priority"],
                temperature=msg["temperature"], top_k=msg["top_k"],
                top_p=msg["top_p"], seed=msg["seed"],
                gen_offset=msg["gen_offset"], t_admit_ns=clock_ns(),
                # the client saw its first token when the prefill replica
                # emitted it: TTFT and TPOT do not restart at adoption
                t_first_ns=msg["t_first_ns"],
                t_last_ns=msg["t_first_ns"],
                slot=slot_tok,
            )
            self.inflight.acquire(s.rid, s)
            self.cost.hold(s.rid, len(blocks), scenario=s.scenario,
                           priority=s.priority)
            if s.jid:
                obs.event("journey.admit", jid=s.jid, rid=str(s.rid),
                          replica=self.replica)
            self.active.append(s)
            self.stats["adopts"] += 1
            self.stats["adopted_blocks"] += n_ship
            obs.event("serve.adopt", rid=str(s.rid), replica=self.replica,
                      blocks=str(n_ship))
            if msg["path"]:
                try:
                    os.unlink(msg["path"])
                except OSError:
                    pass  # the spool dir is the run's scratch either way

    def _step(self) -> None:
        rows = _bucket(len(self.active), self.slots)
        tok = np.zeros((rows,), np.int32)
        lens = np.zeros((rows,), np.int32)
        steps = np.zeros((rows,), np.int32)
        active = np.zeros((rows,), bool)
        for i, s in enumerate(self.active):
            tok[i], lens[i], steps[i], active[i] = (
                s.last_tok, s.lens, s.steps, True
            )
        tables = self._tables_array(self.active, rows)
        # before the launch (nothing written yet, so ``error`` retries
        # from the same state); ``preempt`` raises SIGTERM, this step
        # still completes and the loop snapshots at its iteration boundary
        faults.inject("serve.step", step=self.stats["steps"],
                      replica=self.replica)
        t0 = clock_ns()
        with obs.span("serve.step", deadline_s=self.watchdog_s or None,
                      rows=len(self.active)):
            nxt = self.decoder.step(
                self.params, self.pool, tok, lens, steps, tables, active,
                *self._sampling_args(self.active, rows),
            )
            nxt = nxt.cpu().numpy()
        t_tok = clock_ns()
        obs.histogram("tpu_patterns_serve_step_ms").observe(
            (t_tok - t0) / 1e6
        )
        for i, s in enumerate(self.active):
            s.steps += 1  # the fed token's K/V is now in the pool
            s.last_tok = int(nxt[i])
            s.out.append(s.last_tok)
            s.t_last_ns = t_tok
            self.stats["tokens"] += 1
        obs.counter("tpu_patterns_serve_tokens_total").inc(len(self.active))
        self.stats["steps"] += 1

    @staticmethod
    def _draft(ctx: list[int], k: int) -> list[int]:
        """Prompt-lookup self-drafting: find the most recent earlier
        occurrence of the context's trailing n-gram (n = 3, 2, 1) and
        propose the tokens that followed it.  An unmatched context
        proposes nothing and the step degenerates to plain decode."""
        for n in (3, 2, 1):
            if len(ctx) <= n:
                continue
            pat = ctx[-n:]
            first = pat[0]
            for s in range(len(ctx) - n - 1, -1, -1):
                if ctx[s] == first and ctx[s : s + n] == pat:
                    # s + n <= len(ctx) - 1: at least one token follows
                    return ctx[s + n : s + n + k]
        return []

    def _verify_step(self) -> None:
        """The speculative wide step: draft up to ``spec_k`` tokens a
        row, verify them all (and the bonus position) in one call, and
        commit the longest accepted prefix.  Position i's output is the
        greedy id the plain step would emit after committing tokens
        0..i, so a draft survives exactly when it equals what the model
        would have said: committed ids equal plain decode's.  A sampling
        decoder draws position i with key (seed, gidx + i), the key the
        plain step would use after committing i tokens, so a sampled
        stream stays equal to plain decode's too."""
        w = self.spec_k + 1
        rows = _bucket(len(self.active), self.slots)
        toks = np.zeros((rows, w), np.int32)
        lens = np.zeros((rows,), np.int32)
        steps = np.zeros((rows,), np.int32)
        n_draft = np.zeros((rows,), np.int32)
        active = np.zeros((rows,), bool)
        drafts: list[list[int]] = []
        for i, s in enumerate(self.active):
            # the last generated token is returned, never fed, so at
            # most remaining - 1 drafts can ever be verified
            room = min(self.spec_k, s.n_gen - len(s.out) - 1)
            d = self._draft(s.prompt + s.out, room) if room > 0 else []
            drafts.append(d)
            toks[i, 0] = s.last_tok
            toks[i, 1 : 1 + len(d)] = d
            lens[i], steps[i] = s.lens, s.steps
            n_draft[i], active[i] = len(d), True
        tables = self._tables_array(self.active, rows)
        # before the launch, as serve.step (exhaustion quarantines the
        # active set with its shared blocks' refcounts released)
        faults.inject("serve.verify", step=self.stats["steps"],
                      rows=len(self.active), replica=self.replica)
        t0 = clock_ns()
        with obs.span("serve.verify", deadline_s=self.watchdog_s or None,
                      rows=len(self.active), width=w):
            out = self.decoder.verify(
                self.params, self.pool, toks, lens, steps, n_draft, tables,
                active, *self._sampling_args(self.active, rows),
            )
            out = out.cpu().numpy()
        t_tok = clock_ns()
        obs.histogram("tpu_patterns_serve_step_ms").observe(
            (t_tok - t0) / 1e6
        )
        committed = 0
        for i, s in enumerate(self.active):
            d = drafts[i]
            a = 0
            while a < len(d) and d[a] == int(out[i, a]):
                a += 1  # draft a + 1 matched the model's output a
            commit = [int(out[i, t]) for t in range(a + 1)]
            commit = commit[: s.n_gen - len(s.out)]
            s.out.extend(commit)
            s.steps += len(commit)  # their K/V is in the pool
            s.last_tok = s.out[-1]
            s.t_last_ns = t_tok
            committed += len(commit)
            self.stats["tokens"] += len(commit)
            obs.histogram(
                "tpu_patterns_serve_spec_accepted_tokens"
            ).observe(float(len(commit)))
        obs.counter("tpu_patterns_serve_tokens_total").inc(committed)
        self.stats["steps"] += 1
        self.stats["spec_steps"] += 1
        # per row: spec_tokens / spec_row_steps compares with plain
        # decode's exactly one token a row a step
        self.stats["spec_row_steps"] += len(self.active)
        self.stats["spec_tokens"] += committed

    # -- recovery --------------------------------------------------------

    def _quarantine(self, slots: list[_Slot], reason: str) -> None:
        """Give up on ``slots``: free their blocks through the refcounts
        (shared and retained ones included), release their slot and
        in-flight leases, record a per-request verdict and keep serving
        everyone else: one deterministic failure must not sink the
        batch."""
        self._pending_cow = []  # never copy into blocks being freed
        for s in slots:
            for b in s.table:
                self._release_block(b)
            self.slot_pool.release(s.slot, reusable=True)
            self.inflight.release(s.rid)
            self.cost.drop(s.rid)
            # a quarantined resumed leg is terminally failed: its banked
            # output goes, nothing dangles in the accounting
            self.preempted_partial.pop(s.rid, None)
            self.preempted_first_ns.pop(s.rid, None)
            self.failed[s.rid] = reason
            self._finalize_lifecycle(s, "failed")
            obs.counter("tpu_patterns_serve_quarantined_total").inc()
            obs.event("serve.quarantine", rid=str(s.rid), reason=reason)

    def _book_health(self, ok: bool, decode: bool = False) -> None:
        """Feed the opt-in decode-health breaker: a whole-wave
        quarantine (prefill or decode) is one failure, and only a served
        decode wave resets the streak (a step-sick engine still prefills
        fine; each step failure empties the active set, so a prefill
        always runs in between, and its success must not clear the
        streak).  When the breaker opens the loop stops at its next
        iteration boundary with the queue intact."""
        if self.breaker is None:
            return
        if ok:
            if decode:
                self.breaker.success()
        elif self.breaker.failure():
            self.breaker_tripped = True

    # -- snapshots -------------------------------------------------------

    def _on_preempt_signal(self, signum, frame) -> None:
        # async-signal-safe only: the handler interrupts the loop, which
        # may hold the metrics registry's (non-reentrant) lock, so no
        # obs call here: it sets the event and the loop does the
        # counting, the events and the snapshot at its iteration boundary
        self._preempt_signum = signum
        self._preempt.set()

    def _install_preempt_handlers(self):
        """Arm SIGTERM/SIGINT -> snapshot while the loop runs; returns
        the callback that restores the previous handlers.  A no-op off
        the main thread or without a snapshot_dir."""
        if not self.snapshot_dir:
            return lambda: None
        try:
            prev = {
                s: signal.signal(s, self._on_preempt_signal)
                for s in (signal.SIGTERM, signal.SIGINT)
            }
        except ValueError:  # not the main thread
            return lambda: None

        def restore():
            for s, h in prev.items():
                signal.signal(s, h)

        return restore

    def snapshot(self) -> str:
        """Commit the pool and the scheduler's state atomically under
        snapshot_dir: the pool (and the tier's blocks) through
        ``ckpt.save``, everything host-side the loop owns in the
        ``engine.json`` sidecar of the same commit (the reference's keys
        at format 3, the quarantined rows' verdicts in ``failed``)."""
        step = self.stats["steps"]
        state = {
            "format": SNAPSHOT_FORMAT,
            "fingerprint": self.fingerprint,
            "queue": [
                {"rid": r.rid, "tokens": r.tokens, "n_gen": r.n_gen,
                 "priority": r.priority, "temperature": r.temperature,
                 "top_k": r.top_k, "top_p": r.top_p, "seed": r.seed,
                 "gen_offset": r.gen_offset}
                for r, _ in self.queue
            ],
            "active": [
                {"rid": s.rid, "lens": s.lens, "steps": s.steps,
                 "n_gen": s.n_gen, "table": s.table,
                 "last_tok": s.last_tok, "out": s.out,
                 "prompt": s.prompt, "priority": s.priority,
                 "temperature": s.temperature, "top_k": s.top_k,
                 "top_p": s.top_p, "seed": s.seed,
                 "gen_offset": s.gen_offset}
                for s in self.active
            ],
            "free": list(self.free),
            "ref": {str(b): n for b, n in self.ref.items()},
            "index": (self.index.to_state()
                      if self.index is not None else None),
            "done": {str(k): v for k, v in self.done.items()},
            "failed": {str(k): v for k, v in self.failed.items()},
            "shed": {str(k): v for k, v in self.shed.items()},
            "preempted_partial": {
                str(k): v for k, v in self.preempted_partial.items()
            },
            "preempted_first_ns": {
                str(k): v for k, v in self.preempted_first_ns.items()
            },
            "preempted_rids": sorted(self.preempted_rids),
            "stats": {k: v for k, v in self.stats.items()
                      if k != "queue_wait_ns"},
        }
        tree = {"pool": self.decoder.pool_tree(self.pool)}
        if self.tier is not None:
            handles, arrays = self.tier.state_arrays()
            state["retained"] = {str(b): n for b, n in self.retained.items()}
            state["tier"] = {
                "handles": handles,
                "paths": {str(h): list(self.tier.paths[h]) for h in handles},
            }
            tree["tier"] = arrays
        path = ckpt.save(self.snapshot_dir, step, tree,
                         extras={"engine.json": json.dumps(state)})
        obs.event("serve.snapshot", step=str(step))
        return path

    def restore_snapshot(self) -> int:
        """Load the latest committed snapshot into this fresh engine (the
        pool copied into its buffers on the engine's device); returns
        the snapshot's decode-step counter.  A snapshot of another
        format or taken under another fingerprint raises, naming the
        keys that differ."""
        if not self.snapshot_dir:
            raise ValueError("engine has no snapshot_dir to restore from")
        step = ckpt.latest_step(self.snapshot_dir)
        if step is None:
            raise FileNotFoundError(
                f"no committed serve snapshot under {self.snapshot_dir}"
            )
        state = json.loads(
            ckpt.read_extra(self.snapshot_dir, "engine.json", step=step)
        )
        if state.get("format") != SNAPSHOT_FORMAT:
            raise ValueError(
                f"serve snapshot format {state.get('format')} != "
                f"{SNAPSHOT_FORMAT}"
            )
        if (self.fingerprint and state.get("fingerprint")
                and state["fingerprint"] != self.fingerprint):
            diff = {
                k for k in set(self.fingerprint) | set(state["fingerprint"])
                if self.fingerprint.get(k) != state["fingerprint"].get(k)
            }
            raise ValueError(
                "serve snapshot was taken under a different config "
                f"(mismatched: {sorted(diff)}): resume with the flags of "
                "the preempted run"
            )
        # the pool comes back into its own buffers below
        template = {"pool": self.decoder.pool_template(self.pool)}
        if self.tier is not None and state.get("tier") is not None:
            n_host = len(state["tier"]["handles"])
            template["tier"] = {
                name: torch.empty((n_host, *shape), dtype=dt)
                for name, (shape, dt) in self.tier.leaf_meta.items()
            }
        tree = ckpt.restore(self.snapshot_dir, template, step=step)
        self.decoder.load_pool(self.pool, tree["pool"])
        if "tier" in template:
            handles = [int(h) for h in state["tier"]["handles"]]
            paths = {h: tuple(state["tier"]["paths"][str(h)])
                     for h in handles}
            self.tier.load_arrays(handles, paths, tree["tier"])
        self.retained = {
            int(b): int(n) for b, n in (state.get("retained") or {}).items()
        }
        if self.retained:
            self._lru_clock = itertools.count(max(self.retained.values()) + 1)
        now = clock_ns()
        self.queue = [
            (Request(rid=q["rid"], tokens=list(q["tokens"]),
                     n_gen=q["n_gen"], priority=q["priority"],
                     temperature=q["temperature"], top_k=q["top_k"],
                     top_p=q["top_p"], seed=q["seed"],
                     gen_offset=q["gen_offset"]), now)
            for q in state["queue"]
        ]
        self.active = [
            _Slot(rid=a["rid"], lens=a["lens"], steps=a["steps"],
                  n_gen=a["n_gen"], table=list(a["table"]),
                  last_tok=a["last_tok"], out=list(a["out"]),
                  t_submit_ns=now, prompt=list(a["prompt"]),
                  priority=a["priority"], temperature=a["temperature"],
                  top_k=a["top_k"], top_p=a["top_p"], seed=a["seed"],
                  gen_offset=a["gen_offset"], slot=self.slot_pool.lease())
            for a in state["active"]
        ]
        for s in self.active:
            self.inflight.acquire(s.rid, s)
        self.free = list(state["free"])
        self.ref = {int(b): int(n) for b, n in state["ref"].items()}
        if self.index is not None and state.get("index") is not None:
            self.index = PrefixIndex.from_state(self.layout.block_len,
                                                state["index"])
        self.done = {int(k): v for k, v in state["done"].items()}
        self.failed = {int(k): v for k, v in state["failed"].items()}
        self.shed = {int(k): v for k, v in state["shed"].items()}
        self.preempted_partial = {
            int(k): list(v) for k, v in state["preempted_partial"].items()
        }
        self.preempted_first_ns = {
            int(k): int(v) for k, v in state["preempted_first_ns"].items()
        }
        self.preempted_rids = {int(r) for r in state["preempted_rids"]}
        for k, v in state["stats"].items():
            if k in self.stats:
                self.stats[k] = v
        obs.counter("tpu_patterns_serve_resumes_total").inc()
        obs.event("serve.resume", step=str(step))
        return step

    def _take_preemption(self) -> None:
        """Act on a pending preemption at an iteration boundary, on the
        loop's own thread: count it, stamp ``preempted_at`` and
        snapshot."""
        obs.counter("tpu_patterns_serve_preemptions_total").inc()
        obs.event("serve.preempt", signum=str(self._preempt_signum))
        self.preempted_at = self.stats["steps"]
        if self.snapshot_dir:
            self.snapshot()

    # -- the loop --------------------------------------------------------

    def run(self, requests: list[Request], *, source=None
            ) -> dict[int, list[int]]:
        """Serve ``requests`` to completion; returns {rid: generated ids}.

        An empty ``requests`` continues what the queue and the active
        set hold (the resume path after :meth:`restore_snapshot`).  If a
        preemption signal arrives the loop finishes its iteration,
        snapshots, sets ``preempted_at`` and returns the partial
        results.  With a session dir the tier is committed at the end.

        ``source`` streams arrivals in: a callable polled once an
        iteration as ``source(idle=...)``, returning newly arrived
        requests (``[]``: nothing yet, ``None``: exhausted).  Items are
        ``Request`` or ``(Request, t_submit_ns)``, the second backdating
        submission to the scheduled arrival.  With ``idle`` true the
        engine has nothing to run and the source owns the wait until its
        next arrival (``loadgen/runner.py``), so this loop never
        sleeps.  If the breaker opens, the loop stops at its iteration
        boundary with the queue and the verdicts intact."""
        from tpu_patterns_torch.obs import live as obs_live

        for r in requests:
            self.submit(r)
        restore_handlers = self._install_preempt_handlers()
        # while this loop runs, the live plane's /healthz, /statusz and
        # /costz answer from this engine
        obs_live.attach_engine(self)
        # the cost window covers exactly this loop
        self.cost.start(self.allocated_blocks())
        try:
            with obs.span("serve.run", requests=len(requests)):
                while True:
                    if source is not None:
                        batch = source(idle=not (self.queue or self.active
                                                 or self.adopt_queue))
                        if batch is None:
                            source = None
                        else:
                            for item in batch:
                                if isinstance(item, tuple):
                                    self.submit(item[0],
                                                t_submit_ns=item[1])
                                else:
                                    self.submit(item)
                    if not (self.queue or self.active or self.adopt_queue):
                        if self._preempt.is_set():
                            # idle until the next arrival: the signal
                            # does not wait for it
                            self._take_preemption()
                            break
                        if source is None:
                            break
                        continue
                    self._retire()
                    # sample the pool integral where retire frees blocks
                    # and admission takes them
                    self.cost.tick(self.allocated_blocks())
                    if self.role == "decode" and self.adopt_queue:
                        # shipped KV first: its prefill was paid on the
                        # other pool, so an adopted row joins this
                        # iteration's decode dispatch
                        self._admit_adopts()
                        self.cost.tick(self.allocated_blocks())
                    admitted = self._admit()
                    self.cost.tick(self.allocated_blocks())
                    if admitted:
                        self._prefill_wave(admitted)
                    if self.role == "prefill" and self.active:
                        # every active row has its first token: ship it
                        # and free its rectangle.  The wave drains the
                        # active set, so a prefill engine never decodes
                        self._handoff_wave()
                        self.cost.tick(self.allocated_blocks())
                    if self.active:
                        self._decode()
                    self.stats["peak_blocks"] = max(
                        self.stats["peak_blocks"], self.allocated_blocks()
                    )
                    occ = self._occupancy()
                    self.stats["max_occupancy"] = max(
                        self.stats["max_occupancy"], occ
                    )
                    obs.gauge("tpu_patterns_serve_pool_occupancy").set(occ)
                    obs.gauge("tpu_patterns_serve_active_rows").set(
                        len(self.active)
                    )
                    self.cost.tick(self.allocated_blocks())
                    # publish this iteration's newly materialized full
                    # blocks to the fleet store (a bounded wave): a
                    # replica SIGKILLed next iteration has already made
                    # its warm prefixes visible
                    self._store_publish_wave()
                    if self.breaker_tripped:
                        self._trip()
                        break
                    if self._preempt.is_set():
                        self._take_preemption()
                        break
            # drain or run end: pending and host-resident blocks reach
            # the fleet store before this engine exits
            self._store_flush()
            if self.tier is not None and self.tier.session_dir:
                # bank the session cache at the run's end
                self.save_session()
        finally:
            # the final pool tick settles every residency still held (a
            # breaker or preemption exit leaves rows holding blocks)
            self.cost.close(self.allocated_blocks())
            obs_live.detach_engine(self)
            restore_handlers()
        return dict(self.done)

    def _prefill_wave(self, admitted: list[tuple[Request, _Slot]]) -> None:
        """Prefill the admitted rows under the retry policy; a failure
        past its retries quarantines exactly those rows."""
        try:
            faults.call_with_retry(
                lambda: self._prefill(admitted),
                policy=self.retry_policy, site="serve.prefill",
            )
        except (OSError, faults.Quarantined) as e:
            self._quarantine([s for _, s in admitted],
                             f"prefill failed after retries: {e}")
            self._book_health(False)
        else:
            self._book_health(True)
            self._retire()  # n_gen == 1 finishes at prefill

    def _decode(self) -> None:
        """One decode dispatch for the active set under the retry
        policy; a failure past its retries quarantines the whole active
        set.  Its wall (injection and retries included) is booked to the
        cost book over the rows that rode it, and to the
        ``serve.step_outer`` span, which covers what ``serve.step`` /
        ``serve.verify`` (opened after the injection site) do not.
        Under ``spec_off`` an active burn episode falls back from the
        wide step to plain decode (the same ids, less work a step)."""
        use_spec = bool(self.spec_k) and not (
            self.burn_mitigation == "spec_off" and self.slo.mitigating()
        )
        step_fn, site = ((self._verify_step, "serve.verify") if use_spec
                         else (self._step, "serve.step"))
        # the wave's identity, taken before the dispatch: a quarantined
        # wave empties the active set, but its rows used the wall
        wave = [(s.rid, s.scenario, s.priority) for s in self.active]
        t0 = clock_ns()
        try:
            # the outer span carries the watchdog deadline too: a hang
            # injected at the site fires before serve.step opens
            with obs.span("serve.step_outer",
                          deadline_s=self.watchdog_s or None,
                          rows=len(self.active)):
                faults.call_with_retry(step_fn, policy=self.retry_policy,
                                       site=site)
        except (OSError, faults.Quarantined) as e:
            casualties, self.active = self.active, []
            self._quarantine(casualties,
                             f"decode step failed after retries: {e}")
            self._book_health(False, decode=True)
        else:
            self._book_health(True, decode=True)
        finally:
            wall_ns = clock_ns() - t0
            obs.histogram("tpu_patterns_serve_decode_wall_ms").observe(
                wall_ns / 1e6
            )
            self.cost.book_decode(wall_ns, wave)

    def _trip(self) -> None:
        """The breaker opened: count and explain the stop (the loop ends
        at this iteration boundary with the queue and verdicts
        intact)."""
        # a fleet engine labels the trip with its replica id: the series
        # ships to the parent and must match the parent's mirror key
        obs.counter(
            "tpu_patterns_replica_breaker_trips_total",
            **({"replica": self.replica} if self.replica else {}),
        ).inc()
        obs.event("serve.breaker_open", replica=self.replica,
                  queued=len(self.queue))
        self.decisions.book(
            "breaker",
            rationale="consecutive whole-wave decode quarantines opened "
                      "the health breaker; stopping at the iteration "
                      "boundary",
            queue=len(self.queue), active=len(self.active),
        )


@dataclasses.dataclass
class ServeConfig:
    """CLI ``serve`` subcommand: the continuous-batching measured pattern."""

    vocab: int = 512
    embed: int = 128
    heads: int = 8
    head_dim: int = 16
    mlp_mult: int = 4
    depth: int = 2
    dtype: str = "float32"
    rope: bool = True
    kv_heads: int = 0
    cache_int8: bool = False
    # decode attention: "kernel" runs the fused paged-attention kernel
    # (the plain torch version for CPU tensors), "dense" gathers the page
    # window and runs the dense masked attention
    paged_attn: str = "kernel"
    slots: int = 8  # active-set ceiling (decode bucket cap)
    block_len: int = 16  # pool block size in token slots
    n_blocks: int = 0  # pool blocks incl. trash; 0 = auto (~3/4 of dense)
    requests: int = 16
    min_prompt: int = 8
    max_prompt: int = 48
    gen: int = 16  # tokens generated per request
    min_speedup: float = 1.0  # continuous-vs-sequential gate
    watchdog_s: float = 0.0  # per-step watchdog deadline (0 = spans only)
    # prefix sharing (CoW radix cache): serve a shared-prefix trace with
    # block aliasing on vs off and gate the allocated-block saving
    prefix_share: bool = False
    shared_prefix: int = 0  # common prompt-prefix tokens; 0 = auto (3/4)
    min_block_savings: float = 0.3  # peak-block saving the Record gates
    # speculative decoding: draft spec_k tokens a row (prompt lookup) and
    # verify them in one wide step; 0 = plain one-token decode
    spec_k: int = 0
    min_accepted: float = 1.0  # accepted-tokens/step gate (plain = 1.0)
    seed: int = 0
    # preemption safety: with snapshot_dir set, SIGTERM/SIGINT mid-serve
    # finishes the current iteration, commits the engine's state there
    # and ends with a WARNING Record; --resume restores the latest
    # snapshot and continues, ids gated against the dense decode (this
    # path serves the trace once, no speedup race)
    snapshot_dir: str = ""
    resume: bool = False
    ids_out: str = ""  # write {rid: generated ids} JSON on completion
    # the host KV tier (serve/kvtier.py): retain refcount-0 prefix
    # blocks, evict them to host memory when the free list runs dry and
    # page them back on a prefix hit.  Plain runs bank the tier-against-
    # defer Record; --session_dir makes it the session-cache run, whose
    # tier survives a restart through ckpt/
    kv_host_tier: bool = False
    session_dir: str = ""
    host_tier_blocks: int = 0  # host-tier capacity in blocks (0 = unbounded)
    min_tier_speedup: float = 1.0  # tier-against-defer tokens/s gate
    # trace-driven load generation: a loadgen scenario spec ("chat",
    # "rag:requests=16", the loadgen/scenarios.py grammar).  Set, the run
    # is the SLO pattern of ``loadgen/runner.py`` on this model and pool:
    # the scenario owns the trace, so requests/min_prompt/max_prompt/gen
    # above are superseded (override them inside the spec)
    scenario: str = ""
    time_scale: float = 1.0  # compress scenario ARRIVALS onto the wall
    # the SLO burn monitor's ladder (obs/slo.py): off = observe only,
    # shed = shed admissions while a burn episode lasts, spec_off = plain
    # decode instead of the speculative wide step until it recovers
    burn_mitigation: str = "off"
    slo_fast_s: float = 60.0  # fast burn window (reacts)
    slo_slow_s: float = 300.0  # slow burn window (contextualizes)
    slo_budget: float = 0.1  # allowed bad-token fraction
    burn_multiplier: float = 2.0  # fast-window burn that trips the ladder
    # priority preemption (needs --kv_host_tier and --scenario): a
    # running bulk row under pressure parks in the host tier and resumes
    # bit-identical
    preempt: str = "off"  # off | bulk
    # the live telemetry plane (obs/live.py): PORT > 0 serves /metrics,
    # /healthz, /statusz and /costz on 127.0.0.1 for the whole run, 0
    # off; the ``obs watch URL`` subcommand polls it.  (The CLI's
    # ``--obs_http 0`` means an ephemeral port, as a plane's ``port``)
    obs_http: int = 0
    # the fleet prefix store (serve/store.py): a shared directory every
    # replica publishes materialized full prefix blocks into and consults
    # on an admission miss, so fail-over reroutes land warm and scale-out
    # replicas pre-warm their ring arc.  Needs --kv_host_tier and
    # --replicas; "" = off.  Incompatible with --disagg (the handoff
    # wire owns cross-engine KV movement there)
    prefix_store: str = ""
    # multi-replica serving (serve/replica.py): N engine processes, each
    # on its own slice of the ranks, behind the prefix-aware router
    # (serve/router.py); 0 = the single-engine paths.  With --scenario
    # the fleet serves the schedule under both router policies (the
    # routing comparison), with --elastic_reserve the elastic A/B
    replicas: int = 0
    replica_policy: str = "prefix"  # prefix | round_robin
    route_blocks: int = 0  # prefix-fingerprint depth in blocks (0 = 2)
    # the 1 -> N scaling gate: aggregate tokens/s over N replicas against
    # ONE replica on the same slice size; 0 skips the baseline leg
    min_replica_speedup: float = 1.8
    replica_watchdog_s: float = 120.0  # no-message deadline a replica
    replica_dir: str = ""  # fleet work dir (logs, snapshots, sessions)
    # the elastic fleet (serve/elastic.py): N + R slices up front, N
    # replicas started, the parent's policy scales out onto a reserved
    # slice when lease occupancy holds above the high water and in by
    # draining the coldest replica below the low water; 0 = static
    elastic_reserve: int = 0
    scale_out_occupancy: float = 1.25  # leases a slot, high water
    scale_in_occupancy: float = 0.25  # leases a slot, low water
    scale_sustain_s: float = 0.5  # the signal must hold this long
    scale_cooldown_s: float = 2.0  # least gap between scale actions
    min_live_replicas: int = 1  # the scale-in floor
    # disaggregated prefill/decode (serve/replica.py): "P:D" splits the
    # --replicas fleet into P prefill-only replicas (they admit, fill
    # paged blocks, then ship each request's KV blocks over the block
    # stream) and D decode-only replicas (they adopt shipped blocks into
    # their own pool and run pure decode).  The run becomes the disagg
    # A/B Record: the split fleet against a unified fleet of N replicas
    # at the same device count.  "" = off
    disagg: str = ""
    # the disagg A/B's TTFT p99 gate: the split fleet's front-door p99
    # must be at least this factor better than unified's (1.05 = 5%
    # better).  0 = report, do not gate
    min_ttft_improvement: float = 0.0
    device: str = "cuda"  # "cpu" runs the plain torch versions


def _slo_kwargs(cfg) -> dict:
    """The burn monitor's engine kwargs from a ServeConfig or a
    LoadGenConfig (both carry these field names), so every engine a
    measured pattern builds gets the same monitor config."""
    return {
        "burn_mitigation": cfg.burn_mitigation,
        "slo": SloConfig(
            fast_window_s=cfg.slo_fast_s,
            slow_window_s=cfg.slo_slow_s,
            budget=cfg.slo_budget,
            multiplier=cfg.burn_multiplier,
        ),
    }


def _auto_blocks(cfg: ServeConfig) -> int:
    """Default pool: ~3/4 of the dense ``slots x max_len`` rectangle (so
    the memory contrast is real and deferral is reachable), floored at
    one request's worst case + trash."""
    max_len = cfg.max_prompt + cfg.gen
    dense_blocks = cfg.slots * (-(-max_len // cfg.block_len))
    need_one = -(-max_len // cfg.block_len)
    return max(3 * dense_blocks // 4, need_one + 1) + 1  # +1: trash block


def random_trace(cfg: ServeConfig) -> list[Request]:
    """The canonical serve trace, deterministic from cfg (seed + 1) and
    drawn exactly as the JAX package draws it."""
    rng = np.random.RandomState(cfg.seed + 1)
    return [
        Request(
            rid=i,
            tokens=rng.randint(
                0, cfg.vocab,
                size=rng.randint(cfg.min_prompt, cfg.max_prompt + 1),
            ).tolist(),
            n_gen=cfg.gen,
        )
        for i in range(cfg.requests)
    ]


def shared_trace(cfg: ServeConfig, rng=None
                 ) -> tuple[list[Request], int]:
    """The chat-shaped trace of the prefix-share Record: every prompt
    opens with the same ``shared_prefix`` tokens (a system prompt) and
    ends with a short private suffix, drawn from ``rng`` (default: seed
    + 2) as the JAX package draws it.  Returns (requests, shared token
    count)."""
    rng = rng or np.random.RandomState(cfg.seed + 2)
    s_len = cfg.shared_prefix or max(1, (3 * cfg.max_prompt) // 4)
    if s_len >= cfg.max_prompt:
        raise ValueError(
            f"shared_prefix {s_len} leaves no room for a private "
            f"suffix under max_prompt {cfg.max_prompt}"
        )
    shared = rng.randint(0, cfg.vocab, size=s_len).tolist()
    reqs = [
        Request(
            rid=i,
            tokens=shared + rng.randint(
                0, cfg.vocab,
                size=rng.randint(1, cfg.max_prompt - s_len + 1),
            ).tolist(),
            n_gen=cfg.gen,
        )
        for i in range(cfg.requests)
    ]
    return reqs, s_len


def repetitive_trace(cfg: ServeConfig, rng=None) -> list[Request]:
    """Motif-tiled prompts of the spec-decode Record, the prompt-lookup
    drafter's home ground, drawn from ``rng`` (default: seed + 3) as the
    JAX package draws them."""
    rng = rng or np.random.RandomState(cfg.seed + 3)
    reqs = []
    for i in range(cfg.requests):
        motif = rng.randint(0, cfg.vocab, size=3).tolist()
        lp = int(rng.randint(cfg.min_prompt, cfg.max_prompt + 1))
        reqs.append(
            Request(rid=i, tokens=(motif * (lp // 3 + 1))[:lp],
                    n_gen=cfg.gen)
        )
    return reqs


def model_config(cfg: ServeConfig) -> ModelConfig:
    return ModelConfig(
        embed=cfg.embed, heads=cfg.heads, head_dim=cfg.head_dim,
        mlp_mult=cfg.mlp_mult, dtype=cfg.dtype, depth=cfg.depth,
        kv_heads=cfg.kv_heads, rope=cfg.rope,
    )


def _dense_expected(mcfg, cfg: ServeConfig, params, requests, mesh=None):
    """Per-request greedy ids from the dense batch-1 decoder: the
    engine-independent ground truth."""
    return _oracle_expected(
        mcfg, cfg.vocab, params, requests, max_prompt=cfg.max_prompt,
        max_gen=cfg.gen, cache_int8=cfg.cache_int8, mesh=mesh,
    )


def _oracle_expected(mcfg, vocab: int, params, requests, *, max_prompt: int,
                     max_gen: int, cache_int8: bool = False, mesh=None):
    """Per-request ground-truth ids from the dense batch-1 decoder:
    greedy rows by the argmax rollout, sampled rows (``temperature >
    0``) by the same ``sample_token_rows`` the serve cores run, keyed
    ``(request.seed, gen_offset + n)``.  No pool, no scheduler, no
    batching: the fixed-seed oracle of every exactness gate.  Over
    ``mesh`` (the serve decoder's; ``params`` its per-rank lists) it is
    the same-mesh dense decoder, the prompt and generation lengths
    padded up to a multiple of sp as the reference pads them."""
    sp = mesh.dim("sp") if mesh is not None else 1
    lpd = max_prompt + (-max_prompt % sp)
    gen_cap = max_gen + (-max_gen % sp)
    dpre, dgen = make_lm_decoder(mcfg, vocab, 1, lpd, gen_cap,
                                 cache_int8=cache_int8, mesh=mesh)
    want: dict[int, list[int]] = {}
    for r in requests:
        toks = torch.zeros((1, lpd), dtype=torch.int32)
        toks[0, : len(r.tokens)] = torch.as_tensor(r.tokens)
        lens = torch.tensor([len(r.tokens)], dtype=torch.int32)
        rows = None
        if r.temperature > 0:
            rows = ([r.seed], [r.gen_offset], [r.temperature], [r.top_k],
                    [r.top_p])
        if mesh is None:
            toks = toks.to(params["wemb"].device)
        else:  # each rank's sp shard of the prompt
            toks = mesh.shard(toks, ("dp", "sp"))
        cache, t0 = dpre(params, toks, lens, sample_rows=rows)
        out = [t0]
        if r.n_gen > 1:
            out.append(dgen(params, cache, t0, (lens, 0), r.n_gen - 1,
                            sample_rows=rows)[1])
        if mesh is not None:  # rank 0's copy: every rank's is the same
            out = [o[0] for o in out]
        want[r.rid] = [int(out[0][0])] + (out[1][0].tolist()
                                          if len(out) > 1 else [])
    return want


@dataclasses.dataclass
class ServeLegs:
    """One trace served continuous and sequential (each timed after a
    warm-up run through its own engine)."""

    out_cont: dict[int, list[int]]
    out_seq: dict[int, list[int]]
    cont_s: float
    seq_s: float
    engine: ServeEngine  # the timed continuous engine
    in_place: bool  # pool buffers unchanged across the timed run
    launches: int  # paged_block kernel launches of the timed continuous run


def timed_run(decoder: PagedDecoder, params: dict, trace: list[Request],
              slots: int, **engine_kw):
    """Serve ``trace`` once through a fresh engine (warm-up: library
    loads, allocator and kernel caches), then once more, timed, through
    another (``engine_kw``: ``prefix_share``, ``spec_k``), with the
    paged kernel's launch count set to 0 just before the timed run and
    read just after.  Returns (ids, wall s, the timed engine, whether
    its pool stayed in place, launches)."""
    ServeEngine(decoder, params, slots=slots, **engine_kw).run(
        [dataclasses.replace(r) for r in trace]
    )
    eng = ServeEngine(decoder, params, slots=slots, **engine_kw)
    ptrs = eng.pool_ptrs()
    decoder.sync()
    paged_block.launches = 0
    t0 = clock_ns()
    out = eng.run([dataclasses.replace(r) for r in trace])
    decoder.sync()
    wall_s = (clock_ns() - t0) / 1e9
    return out, wall_s, eng, ptrs == eng.pool_ptrs(), paged_block.launches


def serve_legs(decoder: PagedDecoder, params: dict, trace: list[Request],
               slots: int, **engine_kw) -> ServeLegs:
    with obs.span("serve.continuous", slots=slots):
        out_cont, cont_s, eng, in_place, launches = timed_run(
            decoder, params, trace, slots, **engine_kw)
    with obs.span("serve.sequential"):
        out_seq, seq_s, _, _, _ = timed_run(decoder, params, trace, 1,
                                            **engine_kw)
    return ServeLegs(out_cont, out_seq, cont_s, seq_s, eng, in_place,
                     launches)


def build_serve(cfg: ServeConfig, mesh=None):
    """(model config, decoder, params, trace) for ``cfg`` on its device
    (or over ``mesh``, sp x tp: params split over its ranks): weights
    from ``cfg.seed``, the trace from ``cfg.seed + 1``."""
    dev = resolve_device(cfg.device) if mesh is None else mesh.devices[0]
    mcfg = model_config(cfg)
    decoder = make_paged_lm_decoder(
        mcfg, cfg.vocab, n_blocks=cfg.n_blocks or _auto_blocks(cfg),
        block_len=cfg.block_len, max_len=cfg.max_prompt + cfg.gen,
        cache_int8=cfg.cache_int8, attn=cfg.paged_attn, device=dev,
        mesh=mesh,
    )
    params = decoder.stack_params(
        init_lm_params(cfg.seed, mcfg, cfg.vocab, dev)
    )
    return mcfg, decoder, params, random_trace(cfg)


def cache_mb(cfg: ServeConfig, decoder: PagedDecoder) -> tuple[float, float]:
    """(pool MB, dense ``slots x max_len`` rectangle MB) of KV cache, the
    pool's summed over every rank of a mesh (each holds its stripe and
    heads, nothing twice)."""
    mcfg = decoder.cfg
    dense = (
        cfg.depth * cfg.slots * (cfg.max_prompt + cfg.gen)
        * kv_slot_bytes(cfg.head_dim, mcfg.n_kv, mcfg.torch_dtype,
                        cfg.cache_int8)
    )
    return decoder.pool_nbytes() / 1e6, dense / 1e6


def _serve_commands(cfg: ServeConfig) -> str:
    return (
        f"req{cfg.requests} prompt{cfg.min_prompt}-{cfg.max_prompt} "
        f"gen{cfg.gen} V{cfg.vocab} depth{cfg.depth} {cfg.dtype}"
    )


def _first_divergence(writer, what, trace, got, want_ids) -> bool:
    """Whether every request's ids equal its dense decode; the first
    that does not is reported."""
    for r in trace:
        if got.get(r.rid) != want_ids[r.rid]:
            writer.progress(
                f"{what} exactness: request {r.rid} diverged from dense "
                f"decode (got {got.get(r.rid)}, want {want_ids[r.rid]})"
            )
            return False
    return True


def _sp_mode(decoder: PagedDecoder) -> str:
    """The Records' mode suffix: the sp of the decoder's pool."""
    return f"_sp{decoder.layout.sp}"


def _mesh_notes(decoder: PagedDecoder) -> list[str]:
    """What a Record says of ranks sharing a device (``RankMesh.note``)."""
    note = decoder.mesh and decoder.mesh.note("sp combines and tp sums")
    return [note] if note else []


def prefix_decoder(cfg: ServeConfig, mcfg, device, mesh=None
                   ) -> PagedDecoder:
    """The prefix-share Record's decoder: a pool covering every slot's
    whole lifetime, so sharing changes allocation and never deferral."""
    max_len = cfg.max_prompt + cfg.gen
    per_row = -(-max_len // cfg.block_len)
    return make_paged_lm_decoder(
        mcfg, cfg.vocab, n_blocks=cfg.slots * per_row + 1,
        block_len=cfg.block_len, max_len=max_len,
        cache_int8=cfg.cache_int8, attn=cfg.paged_attn, device=device,
        mesh=mesh,
    )


def _prefix_record(cfg: ServeConfig, writer: ResultWriter, mcfg, params,
                   main: PagedDecoder) -> Record:
    """Measured pattern: the same shared-prefix trace served with CoW
    block sharing on and off, through one decoder whose pool covers the
    whole non-shared demand (so the contrast is allocation, not
    deferral).  Gates: at least ``min_block_savings`` fewer peak
    allocated blocks, every request's ids equal to its per-request dense
    decode, shared ids equal to non-shared ones, and no leaked block."""
    decoder = prefix_decoder(cfg, mcfg, main.device, main.mesh)
    trace, s_len = shared_trace(cfg)

    def serve_once(share: bool):
        eng = ServeEngine(decoder, params, slots=cfg.slots,
                          watchdog_s=cfg.watchdog_s, prefix_share=share,
                          **_slo_kwargs(cfg))
        return eng.run([dataclasses.replace(r) for r in trace]), eng

    with obs.span("serve.prefix_share", requests=len(trace)):
        out_shared, eng_s = serve_once(True)
    with obs.span("serve.prefix_baseline"):
        out_plain, eng_p = serve_once(False)
    want_ids = _dense_expected(mcfg, cfg, params, trace, decoder.mesh)
    exact = out_shared == out_plain and _first_divergence(
        writer, "prefix-share", trace, out_shared, want_ids)

    peak_s = eng_s.stats["peak_blocks"]
    peak_p = eng_p.stats["peak_blocks"]
    savings = 1.0 - (peak_s / peak_p) if peak_p else 0.0
    block_mb = decoder.pool_nbytes() / decoder.layout.n_blocks / 1e6
    leaked = eng_s.leaked_blocks()
    ok = (exact and peak_s < peak_p and savings >= cfg.min_block_savings
          and leaked == 0 and not eng_s.failed and not eng_p.failed)
    rec = Record(
        pattern="serve",
        mode=f"prefix_share_req{cfg.requests}_bl{cfg.block_len}"
        + _sp_mode(decoder),
        commands=_serve_commands(cfg) + f" shared{s_len}",
        metrics={
            "exact": float(exact),
            "peak_blocks": float(peak_s),
            "nonshared_peak_blocks": float(peak_p),
            "block_savings": round(savings, 3),
            "prefix_pool_MB": round(peak_s * block_mb, 4),
            "nonshared_pool_MB": round(peak_p * block_mb, 4),
            "prefix_hit_blocks": float(eng_s.stats["prefix_hit_blocks"]),
            "cow_copies": float(eng_s.stats["cow_copies"]),
            "shared_tokens": float(s_len),
            "deferrals": float(eng_s.stats["deferrals"]),
            "leaked_blocks": float(leaked),
        },
        verdict=Verdict.SUCCESS if ok else Verdict.FAILURE,
        config={"device": str(decoder.device), "paged_attn": cfg.paged_attn},
    )
    if not exact:
        rec.notes.append(
            "exactness gate FAILED: prefix sharing changed a request's "
            "greedy ids vs per-request dense decode"
        )
    if not peak_s < peak_p or savings < cfg.min_block_savings:
        rec.notes.append(
            f"memory gate FAILED: peak {peak_s} vs non-shared {peak_p} "
            f"blocks ({savings:.0%} saved) < {cfg.min_block_savings:.0%} "
            "target on the shared-prefix trace"
        )
    if leaked:
        rec.notes.append(f"{leaked} block(s) leaked by the refcounts")
    rec.notes += _mesh_notes(decoder)
    writer.record(rec)
    return rec


def _spec_record(cfg: ServeConfig, writer: ResultWriter, mcfg, decoder,
                 params) -> Record:
    """Measured pattern: a repetitive trace decoded with prompt-lookup
    speculative decoding and with plain one-token decode through the
    same decoder.  Gates: accepted tokens per row-step >
    ``min_accepted`` (plain decode is exactly 1.0) and ids equal to both
    the plain engine's and the per-request dense decode."""
    trace = repetitive_trace(cfg)
    with obs.span("serve.spec_decode", k=cfg.spec_k):
        eng_spec = ServeEngine(decoder, params, slots=cfg.slots,
                               watchdog_s=cfg.watchdog_s, spec_k=cfg.spec_k,
                               **_slo_kwargs(cfg))
        out_spec = eng_spec.run([dataclasses.replace(r) for r in trace])
    with obs.span("serve.spec_baseline"):
        eng_plain = ServeEngine(decoder, params, slots=cfg.slots,
                                watchdog_s=cfg.watchdog_s,
                                **_slo_kwargs(cfg))
        out_plain = eng_plain.run([dataclasses.replace(r) for r in trace])
    want_ids = _dense_expected(mcfg, cfg, params, trace, decoder.mesh)
    exact = out_spec == out_plain and _first_divergence(
        writer, "spec-decode", trace, out_spec, want_ids)

    row_steps = eng_spec.stats["spec_row_steps"]
    accepted = eng_spec.stats["spec_tokens"] / row_steps if row_steps else 0.0
    obs.gauge("tpu_patterns_serve_accepted_tokens_per_step").set(accepted)
    ok = (exact and accepted > cfg.min_accepted
          and not eng_spec.failed and not eng_plain.failed)
    rec = Record(
        pattern="serve",
        mode=f"spec_decode_k{cfg.spec_k}" + _sp_mode(decoder),
        commands=_serve_commands(cfg),
        metrics={
            "exact": float(exact),
            "accepted_tokens_per_step": round(accepted, 3),
            "draft_k": float(cfg.spec_k),
            "decode_steps": float(eng_spec.stats["steps"]),
            "plain_decode_steps": float(eng_plain.stats["steps"]),
            "tokens": float(eng_spec.stats["tokens"]),
        },
        verdict=Verdict.SUCCESS if ok else Verdict.FAILURE,
        config={"device": str(decoder.device), "paged_attn": cfg.paged_attn},
    )
    if not exact:
        rec.notes.append(
            "exactness gate FAILED: speculative decoding changed a "
            "request's greedy ids vs plain/dense decode"
        )
    if not accepted > cfg.min_accepted:
        rec.notes.append(
            f"accepted-tokens/step {accepted:.2f} <= {cfg.min_accepted}:"
            " drafts were not worth a wide step on this trace"
        )
    rec.notes += _mesh_notes(decoder)
    writer.record(rec)
    return rec


def _serve_fingerprint(cfg: ServeConfig, n_blocks: int) -> dict:
    """The config a snapshot must agree on to resume: everything that
    shapes the pool, the trace or the token stream (the reference's
    exclusions; ``device`` stays in, so a snapshot taken on the card
    refuses to resume on the CPU)."""
    fp = dataclasses.asdict(cfg)
    for k in ("snapshot_dir", "resume", "ids_out", "watchdog_s", "min_speedup",
              "min_block_savings", "min_accepted", "session_dir",
              "host_tier_blocks", "min_tier_speedup",
              # the burn ladder never shapes the token stream (a shed
              # request is terminal bookkeeping, spec_off is
              # bit-identical), nor does preemption (resume is exact)
              "obs_http", "burn_mitigation", "slo_fast_s", "slo_slow_s",
              "slo_budget", "burn_multiplier", "preempt",
              # a gate threshold, not a trace shape (disagg stays in:
              # roles change which engine serves what)
              "min_ttft_improvement"):
        fp.pop(k)
    fp["n_blocks"] = n_blocks  # resolved, not the 0 = auto sentinel
    return fp


def _run_preemptible(cfg: ServeConfig, writer: ResultWriter, mcfg,
                     decoder: PagedDecoder, params, trace) -> list[Record]:
    """The preemption-safe serve path (``snapshot_dir``): serve the trace
    once under armed SIGTERM/SIGINT handlers.  Preempted: a committed
    snapshot and a WARNING Record.  Completed (fresh or ``resume``):
    every finished request's ids gated against the dense per-request
    decode, quarantined rows reported per request (a WARNING: recovered,
    not unscathed), and ``ids_out`` written."""
    eng = ServeEngine(
        decoder, params, slots=cfg.slots, watchdog_s=cfg.watchdog_s,
        snapshot_dir=cfg.snapshot_dir,
        fingerprint=_serve_fingerprint(cfg, decoder.layout.n_blocks),
        prefix_share=cfg.prefix_share, spec_k=cfg.spec_k,
        kv_host_tier=cfg.kv_host_tier, session_dir=cfg.session_dir or None,
        host_tier_blocks=cfg.host_tier_blocks, **_slo_kwargs(cfg),
    )
    resumed_from = None
    if cfg.resume:
        resumed_from = eng.restore_snapshot()
        writer.progress(
            f"serve resume: snapshot at decode step {resumed_from} "
            f"({len(eng.done)} done, {len(eng.active)} active, "
            f"{len(eng.queue)} queued)"
        )
        out = eng.run([])
    else:
        out = eng.run([dataclasses.replace(r) for r in trace])
    mode = (("resume" if cfg.resume else "preemptible")
            + f"_slots{cfg.slots}" + _sp_mode(decoder))
    config = {"device": str(decoder.device), "paged_attn": cfg.paged_attn}
    if eng.preempted_at is not None:
        rec = Record(
            pattern="serve", mode=mode, commands=_serve_commands(cfg),
            metrics={
                "preempted": 1.0,
                "snapshot_step": float(eng.preempted_at),
                "done_requests": float(len(eng.done)),
                "pending_requests": float(len(eng.queue) + len(eng.active)),
            },
            verdict=Verdict.WARNING,
            notes=[
                f"preempted at decode step {eng.preempted_at}; engine "
                f"state committed under {cfg.snapshot_dir}: rerun with "
                "--resume true to continue"
            ],
            config=config,
        )
        rec.notes += _mesh_notes(decoder)
        writer.record(rec)
        return [rec]
    if cfg.ids_out:
        with open(cfg.ids_out, "w") as f:
            json.dump({"done": {str(k): out[k] for k in sorted(out)},
                       "failed": {str(k): eng.failed[k]
                                  for k in sorted(eng.failed)}}, f)
    want_ids = _dense_expected(mcfg, cfg, params,
                               [r for r in trace if r.rid in out],
                               decoder.mesh)
    mismatched = [r.rid for r in trace
                  if r.rid in out and out[r.rid] != want_ids[r.rid]]
    unaccounted = [r.rid for r in trace
                   if r.rid not in out and r.rid not in eng.failed]
    leaked = eng.leaked_blocks()
    obs.gauge("tpu_patterns_serve_exact").set(float(not mismatched))
    verdict = Verdict.SUCCESS
    if mismatched or unaccounted or leaked:
        verdict = Verdict.FAILURE
    elif eng.failed:
        verdict = Verdict.WARNING  # recovered, but not unscathed
    rec = Record(
        pattern="serve", mode=mode, commands=_serve_commands(cfg),
        metrics={
            "exact": float(not mismatched),
            "done_requests": float(len(out)),
            "quarantined": float(len(eng.failed)),
            "resumed_from": float(
                resumed_from if resumed_from is not None else -1
            ),
            "decode_steps": float(eng.stats["steps"]),
            "tokens": float(eng.stats["tokens"]),
            "deferrals": float(eng.stats["deferrals"]),
            "leaked_blocks": float(leaked),
            "prefix_hit_blocks": float(eng.stats["prefix_hit_blocks"]),
            "cow_copies": float(eng.stats["cow_copies"]),
            "spec_steps": float(eng.stats["spec_steps"]),
            "spec_tokens": float(eng.stats["spec_tokens"]),
        },
        verdict=verdict,
        config=config,
    )
    if mismatched:
        rec.notes.append(
            f"exactness gate FAILED for request(s) {mismatched[:8]}: ids "
            "diverged from the dense per-request decode"
        )
    if unaccounted:
        rec.notes.append(
            f"request(s) {unaccounted[:8]} neither completed nor "
            "quarantined: scheduler bug"
        )
    if leaked:
        rec.notes.append(
            f"{leaked} allocated block(s) have no live table reference: "
            "refcount bookkeeping leaked"
        )
    for rid in sorted(eng.failed)[:8]:
        rec.notes.append(f"request {rid} QUARANTINED: {eng.failed[rid]}")
    if len(eng.failed) > 8:
        rec.notes.append(f"... and {len(eng.failed) - 8} more quarantined")
    rec.notes += _mesh_notes(decoder)
    writer.record(rec)
    return [rec]


def session_trace(cfg: ServeConfig) -> tuple[list[Request], int]:
    """The conversation-shaped chat trace of the kv-tier patterns, drawn
    from seed + 4 as the JAX package draws it: ``G`` users sharing one
    two-block system prompt, each with a private history growing a
    block a turn, submitted turn-major, so a turn-2 request arrives
    after its turn-1 wave retired and a tierless engine must prefill
    the history again.  Returns (requests, gen)."""
    bl = cfg.block_len
    if cfg.slots < 3:
        raise ValueError(
            "the kv-tier trace needs --slots >= 3 (the oversubscribed "
            f"pool geometry degenerates below that), got {cfg.slots}"
        )
    n_conv = max(cfg.slots + 2, cfg.requests // 2)
    gen = max(2, min(cfg.gen, bl))
    rng = np.random.RandomState(cfg.seed + 4)
    shared = rng.randint(0, cfg.vocab, size=2 * bl).tolist()
    convs = [rng.randint(0, cfg.vocab, size=2 * bl).tolist()
             for _ in range(n_conv)]
    reqs, rid = [], 0
    for turn in (1, 2):
        for g in range(n_conv):
            reqs.append(Request(rid=rid, tokens=shared + convs[g][: turn * bl],
                                n_gen=gen))
            rid += 1
    return reqs, gen


def _kv_tier_pool(cfg: ServeConfig, mcfg, device, mesh=None
                  ) -> PagedDecoder:
    """The oversubscribed pool of both kv-tier patterns: the shared
    prefix (2 blocks) plus ``slots`` turn-2 private working sets (3
    each), under the defer-only engine's turn-1 demand (``slots x 4``),
    so that engine defers on the session trace where the tier admits."""
    bl = cfg.block_len
    return make_paged_lm_decoder(
        mcfg, cfg.vocab, n_blocks=2 + 3 * cfg.slots + 1, block_len=bl,
        max_len=5 * bl, cache_int8=cfg.cache_int8, attn=cfg.paged_attn,
        device=device, mesh=mesh,
    )


def _kv_oracle_cfg(cfg: ServeConfig, gen: int) -> ServeConfig:
    """The dense oracle's shape for the session trace (prompts reach 4
    blocks whatever ``max_prompt`` says)."""
    return dataclasses.replace(cfg, max_prompt=4 * cfg.block_len, gen=gen)


def _kv_tier_record(cfg: ServeConfig, writer: ResultWriter, mcfg, params,
                    main: PagedDecoder) -> Record:
    """Measured pattern: the oversubscribed session trace served with the
    host KV tier on and by the defer-only engine, through pools of one
    size, each timed after a warm-up run.  Gates: the defer-only leg
    defers where the tier leg never does and admits at least once only
    because retained blocks aliased (``pressure_admits``); evictions
    and onload hits > 0; tokens/s above ``min_tier_speedup`` x the
    defer-only leg's; ids equal to the dense decode's and the defer-only
    leg's; no leaked block."""
    trace, gen = session_trace(cfg)
    decoder = _kv_tier_pool(cfg, mcfg, main.device, main.mesh)
    n_blocks = decoder.layout.n_blocks
    total_tokens = sum(r.n_gen for r in trace)

    def serve_once(tier: bool):
        def build():
            return ServeEngine(decoder, params, slots=cfg.slots,
                               watchdog_s=cfg.watchdog_s, kv_host_tier=tier,
                               host_tier_blocks=cfg.host_tier_blocks,
                               **_slo_kwargs(cfg))

        build().run([dataclasses.replace(r) for r in trace])  # warm-up
        eng = build()
        decoder.sync()
        t0 = clock_ns()
        out = eng.run([dataclasses.replace(r) for r in trace])
        decoder.sync()
        return out, (clock_ns() - t0) / 1e9, eng

    with obs.span("serve.kv_tier", requests=len(trace)):
        out_tier, tier_s, eng_t = serve_once(True)
    with obs.span("serve.kv_defer_baseline"):
        out_base, base_s, eng_b = serve_once(False)
    want_ids = _dense_expected(mcfg, _kv_oracle_cfg(cfg, gen), params, trace,
                               decoder.mesh)
    exact = out_tier == out_base and _first_divergence(
        writer, "kv-tier", trace, out_tier, want_ids)
    tier_tps = total_tokens / tier_s if tier_s > 0 else 0.0
    base_tps = total_tokens / base_s if base_s > 0 else 0.0
    speedup = tier_tps / base_tps if base_tps > 0 else 0.0
    st = eng_t.stats
    leaked = eng_t.leaked_blocks()
    ok = (exact and eng_b.stats["deferrals"] > 0 and st["deferrals"] == 0
          and st["pressure_admits"] > 0 and st["evictions"] > 0
          and st["onload_hits"] > 0 and np.isfinite(speedup)
          and speedup > cfg.min_tier_speedup and leaked == 0
          and not eng_t.failed and not eng_b.failed)
    rec = Record(
        pattern="serve",
        mode=f"kv_tier_slots{cfg.slots}_bl{cfg.block_len}"
        + _sp_mode(decoder),
        commands=(
            f"req{len(trace)} conv{len(trace) // 2}x2turns gen{gen} "
            f"pool{n_blocks} V{cfg.vocab} depth{cfg.depth} {cfg.dtype}"
        ),
        metrics={
            "exact": float(exact),
            "tokens_per_s": round(tier_tps, 1),
            "defer_tokens_per_s": round(base_tps, 1),
            "goodput_speedup": round(speedup, 3),
            "deferrals": float(st["deferrals"]),
            "defer_baseline_deferrals": float(eng_b.stats["deferrals"]),
            "pressure_admits": float(st["pressure_admits"]),
            "evictions": float(st["evictions"]),
            "evict_MB": round(st["evict_bytes"] / 1e6, 4),
            "onload_hits": float(st["onload_hits"]),
            "onload_MB": round(st["onload_bytes"] / 1e6, 4),
            "retained_peak": float(st["retained_peak"]),
            "tier_fallbacks": float(st["tier_fallbacks"]),
            "decode_steps": float(st["steps"]),
            "defer_decode_steps": float(eng_b.stats["steps"]),
            "leaked_blocks": float(leaked),
        },
        verdict=Verdict.SUCCESS if ok else Verdict.FAILURE,
        config={"device": str(decoder.device), "paged_attn": cfg.paged_attn,
                "evict_ms": st["evict_ns"] / 1e6,
                "commit_ms": st["commit_ns"] / 1e6,
                "onload_ms": st["onload_ns"] / 1e6},
    )
    if not exact:
        rec.notes.append(
            "exactness gate FAILED: evict/restore changed a request's "
            "greedy ids vs per-request dense decode"
        )
    if not eng_b.stats["deferrals"] > 0:
        rec.notes.append(
            "the defer-only baseline never deferred: the trace did not "
            "oversubscribe the pool, the contrast is vacuous"
        )
    if st["deferrals"] > 0 or st["pressure_admits"] == 0:
        rec.notes.append(
            f"admit-where-deferred gate FAILED: tier deferred "
            f"{st['deferrals']} time(s), pressure admits "
            f"{st['pressure_admits']}"
        )
    if st["evictions"] == 0 or st["onload_hits"] == 0:
        rec.notes.append(
            f"tier traffic gate FAILED: evictions {st['evictions']}, "
            f"onload hits {st['onload_hits']}: the trace never exercised "
            "the host tier"
        )
    if not speedup > cfg.min_tier_speedup:
        rec.notes.append(
            f"goodput {tier_tps:.1f} tok/s <= {cfg.min_tier_speedup}x the "
            f"defer-only baseline's {base_tps:.1f}: the ladder did not "
            "beat the cliff on this trace"
        )
    if leaked:
        rec.notes.append(f"{leaked} block(s) leaked through evict/restore")
    rec.notes += _mesh_notes(decoder)
    writer.record(rec)
    return rec


def _kv_session_record(cfg: ServeConfig, writer: ResultWriter, mcfg,
                       params, main: PagedDecoder) -> Record:
    """Measured pattern: one pass of the session trace with the tier and
    the session cache (``session_dir``) on, gated against the dense
    decode.  The Record carries what a restart is held to:
    ``session_loaded`` (host blocks adopted from the committed cache at
    start), ``onload_hits`` and ``prompt_fresh_full_blocks`` (0 on a
    resumed run: no history block prefilled again)."""
    trace, gen = session_trace(cfg)
    decoder = _kv_tier_pool(cfg, mcfg, main.device, main.mesh)
    n_blocks = decoder.layout.n_blocks
    eng = ServeEngine(
        decoder, params, slots=cfg.slots, watchdog_s=cfg.watchdog_s,
        kv_host_tier=True, session_dir=cfg.session_dir,
        host_tier_blocks=cfg.host_tier_blocks,
        fingerprint=_serve_fingerprint(cfg, n_blocks), **_slo_kwargs(cfg),
    )
    with obs.span("serve.kv_session", requests=len(trace)):
        out = eng.run([dataclasses.replace(r) for r in trace])
    want_ids = _dense_expected(mcfg, _kv_oracle_cfg(cfg, gen), params,
                               [r for r in trace if r.rid in out],
                               decoder.mesh)
    mismatched = [r.rid for r in trace
                  if r.rid in out and out[r.rid] != want_ids[r.rid]]
    unaccounted = [r.rid for r in trace
                   if r.rid not in out and r.rid not in eng.failed]
    st = eng.stats
    leaked = eng.leaked_blocks()
    verdict = Verdict.SUCCESS
    if mismatched or unaccounted or leaked:
        verdict = Verdict.FAILURE
    elif eng.failed or st["tier_fallbacks"]:
        verdict = Verdict.WARNING
    rec = Record(
        pattern="serve",
        mode=f"kv_session_slots{cfg.slots}_bl{cfg.block_len}"
        + _sp_mode(decoder),
        commands=(
            f"req{len(trace)} conv{len(trace) // 2}x2turns gen{gen} "
            f"pool{n_blocks} session={bool(cfg.session_dir)}"
        ),
        metrics={
            "exact": float(not mismatched),
            "done_requests": float(len(out)),
            "quarantined": float(len(eng.failed)),
            "session_loaded": float(st["session_loaded"]),
            "onload_hits": float(st["onload_hits"]),
            "evictions": float(st["evictions"]),
            "prompt_fresh_full_blocks": float(st["prompt_fresh_full_blocks"]),
            "pressure_admits": float(st["pressure_admits"]),
            "tier_fallbacks": float(st["tier_fallbacks"]),
            "deferrals": float(st["deferrals"]),
            "leaked_blocks": float(leaked),
        },
        verdict=verdict,
        config={"device": str(decoder.device), "paged_attn": cfg.paged_attn,
                "evict_ms": st["evict_ns"] / 1e6,
                "commit_ms": st["commit_ns"] / 1e6,
                "onload_ms": st["onload_ns"] / 1e6},
    )
    if mismatched:
        rec.notes.append(
            f"exactness gate FAILED for request(s) {mismatched[:8]}: ids "
            "diverged from the dense per-request decode (a restored block "
            "was not bit-identical?)"
        )
    if unaccounted:
        rec.notes.append(
            f"request(s) {unaccounted[:8]} neither completed nor "
            "quarantined: scheduler bug"
        )
    if leaked:
        rec.notes.append(f"{leaked} block(s) leaked through the tier")
    rec.notes += _mesh_notes(decoder)
    writer.record(rec)
    return rec


def _refuse_unsupported(cfg: ServeConfig) -> None:
    """The reference's refusals of flag combinations a path does not
    run, raised before the model is built."""
    if cfg.replicas:
        _refuse_fleet(cfg)
        return
    if cfg.prefix_store:
        raise ValueError(
            "serve --prefix_store runs through --replicas (the fleet "
            "store migrates KV across replicas); single-engine restart "
            "persistence is --session_dir"
        )
    if cfg.elastic_reserve:
        raise ValueError(
            "serve --elastic_reserve requires --replicas (the elastic "
            "fleet scales a replica fleet; there is nothing to scale on "
            "the single-engine paths)"
        )
    if cfg.disagg:
        raise ValueError(
            "serve --disagg splits a replica fleet into prefill and "
            "decode pools — it needs --replicas N with P+D == N"
        )
    if cfg.scenario:
        if cfg.snapshot_dir or cfg.resume or cfg.ids_out:
            raise ValueError(
                "serve --scenario is the SLO measured pattern; run "
                "preemption (--snapshot_dir/--resume/--ids_out) on the "
                "plain serve trace instead"
            )
        return
    if cfg.preempt != "off":
        raise ValueError(
            "serve --preempt runs through --scenario (a priority-tagged "
            "trace); the plain measured patterns have no priority "
            "classes to preempt"
        )
    if cfg.resume and not cfg.snapshot_dir:
        raise ValueError("serve --resume requires --snapshot_dir")
    if cfg.ids_out and not cfg.snapshot_dir:
        raise ValueError("serve --ids_out requires --snapshot_dir")
    if cfg.session_dir and not cfg.kv_host_tier:
        raise ValueError("serve --session_dir requires --kv_host_tier")


def _refuse_fleet(cfg: ServeConfig) -> None:
    """``serve --replicas``'s refusals (the reference's, from its CLI and
    its ``run_serve``), raised before any replica spawns."""
    from tpu_patterns_torch.serve.router import Router

    if cfg.replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {cfg.replicas}")
    if cfg.snapshot_dir or cfg.resume or cfg.ids_out:
        raise ValueError(
            "serve --replicas owns its snapshot dirs (one per replica "
            "under --replica_dir); run preemption via the single-engine "
            "trace instead"
        )
    if cfg.session_dir:
        raise ValueError(
            "serve --replicas owns its session dirs (one per replica "
            "under --replica_dir, banked on drain); run --session_dir "
            "through the single-engine path"
        )
    if cfg.replica_policy not in Router.POLICIES:
        raise ValueError(
            f"unknown replica_policy {cfg.replica_policy!r} (want one of "
            f"{Router.POLICIES})"
        )
    if cfg.preempt != "off" and not cfg.kv_host_tier:
        raise ValueError(
            "serve --preempt requires --kv_host_tier (a preempted row "
            "parks in the host tier)"
        )
    if cfg.prefix_store and not cfg.kv_host_tier:
        raise ValueError(
            "serve --prefix_store requires --kv_host_tier (fetched "
            "blocks adopt through the host tier)"
        )
    if cfg.prefix_store and cfg.disagg:
        raise ValueError(
            "serve --prefix_store is incompatible with --disagg: the "
            "handoff wire owns cross-engine KV movement there"
        )
    if cfg.prefix_store and cfg.scenario:
        raise ValueError(
            "serve --prefix_store is incompatible with --scenario: the "
            "routing-comparison A/B would leak warmth between its legs "
            "through the shared store"
        )
    if cfg.elastic_reserve and not cfg.scenario:
        raise ValueError(
            "serve --elastic_reserve needs --scenario: the elastic Record "
            "is the diurnal-ramp A/B, and priority classes ride the "
            "scenario schedule"
        )
    if cfg.disagg:
        disagg_split(cfg)


def disagg_split(cfg: ServeConfig) -> tuple[int, int]:
    """``--disagg P:D`` checked as the reference checks it: (P, D)."""
    if cfg.elastic_reserve:
        raise ValueError(
            "serve --disagg and --elastic_reserve are mutually exclusive: "
            "role assignment is static for this Record"
        )
    try:
        n_pre, n_dec = (int(x) for x in cfg.disagg.split(":"))
    except ValueError:
        raise ValueError(
            f"--disagg wants P:D (two integers), got {cfg.disagg!r}"
        ) from None
    if n_pre < 1 or n_dec < 1:
        raise ValueError(
            f"--disagg {cfg.disagg}: need at least one prefill and one "
            "decode replica"
        )
    if n_pre + n_dec != cfg.replicas:
        raise ValueError(
            f"--disagg {cfg.disagg}: P+D = {n_pre + n_dec} must equal "
            f"--replicas {cfg.replicas}"
        )
    return n_pre, n_dec


def run_serve(cfg: ServeConfig, writer: ResultWriter | None = None,
              mesh=None) -> list[Record]:
    """Measured pattern: serve one trace continuous (``slots`` wide) and
    sequential (one slot, same decoder), and gate

    * speedup: continuous tokens/s > ``min_speedup`` x sequential,
    * exactness: continuous ids equal sequential ids and every request's
      ids equal its per-request dense decode (``make_lm_decoder``),
    * memory: the pool is below the dense ``slots x max_len`` rectangle
      and its buffers are the same before and after the run (updated in
      place: ``alias_MB`` reports the pool bytes so updated, 0 if not).

    With ``prefix_share`` the ``prefix_share_*`` Record follows, with
    ``spec_k`` the ``spec_decode_*`` one (each on its own trace, as the
    JAX package draws it).  The JAX package emits only those two when
    either flag is set; this one serves the main trace first as well.

    With ``snapshot_dir`` the run is the preemptible one-pass instead
    (the shared trace under ``prefix_share``, the repetitive one under
    ``spec_k``; ``resume`` continues a committed snapshot), and with
    ``kv_host_tier`` the tier-against-defer race on the session trace
    (with ``session_dir``, the session-cache run), as in the JAX
    package.

    With ``scenario`` the run is the load generator's instead
    (``loadgen/runner.py::run_loadgen``) on this model and pool, one
    Record for the scenario.  The JAX package's bridge leaves
    ``paged_attn`` at the load generator's default; this one passes it.

    With ``obs_http`` the live plane (``obs/live.py``) serves the whole
    run on that port of 127.0.0.1; every engine the run builds attaches
    to it while its loop runs.

    With ``replicas`` the run is the replica fleet's instead
    (``serve/replica.py::run_replicas``): the scaling/fail-over Record,
    or with ``scenario`` the routing comparison, or with
    ``elastic_reserve`` the elastic A/B.

    With ``mesh`` (a ``comm/mesh.py::NamedMesh`` of sp x tp ranks, dp 1)
    every path serves through the :class:`PagedDecoder` over it, its
    exactness oracle is the same-mesh dense decoder, the modes say
    ``_sp{sp}`` and each Record notes ranks that share a device.  As the
    reference warns, an int8 pool at sp > 1 is held against a dense
    prefill that attends float k/v, so an id whose top two logits lie
    within the quantization error may flip there.
    """
    writer = writer or ResultWriter()
    _refuse_unsupported(cfg)
    if cfg.obs_http:
        from tpu_patterns_torch.obs.live import ObsHttp

        plane = ObsHttp(cfg.obs_http)
        port = plane.start()
        writer.progress(
            f"obs http plane live on http://127.0.0.1:{port} "
            "(/metrics /healthz /statusz; poll it with "
            f"`python -m tpu_patterns_torch obs watch "
            f"http://127.0.0.1:{port}`)"
        )
        try:
            return run_serve(dataclasses.replace(cfg, obs_http=0), writer,
                             mesh)
        finally:
            plane.stop()
    if cfg.replicas:
        # the replica fleet (serve/replica.py): N engine processes on
        # disjoint slices of the ranks behind the prefix-aware router
        from tpu_patterns_torch.serve.replica import run_replicas

        return run_replicas(cfg, writer, mesh)
    if cfg.scenario:
        return _run_scenario(cfg, writer, mesh)
    mcfg, decoder, params, trace = build_serve(cfg, mesh)
    if cfg.snapshot_dir:
        # a run that can be preempted anywhere has no speedup race; with
        # sharing or speculation asked for, it serves the trace their
        # Record would, so the resume is checked with shared blocks or
        # drafts in flight
        if cfg.prefix_share:
            trace, _ = shared_trace(cfg)
        elif cfg.spec_k:
            trace = repetitive_trace(cfg)
        return _run_preemptible(cfg, writer, mcfg, decoder, params, trace)
    if cfg.kv_host_tier:
        if cfg.session_dir:
            return [_kv_session_record(cfg, writer, mcfg, params, decoder)]
        return [_kv_tier_record(cfg, writer, mcfg, params, decoder)]
    total_tokens = sum(r.n_gen for r in trace)

    legs = serve_legs(decoder, params, trace, cfg.slots,
                      watchdog_s=cfg.watchdog_s, **_slo_kwargs(cfg))
    cont_tps = total_tokens / legs.cont_s if legs.cont_s > 0 else 0.0
    seq_tps = total_tokens / legs.seq_s if legs.seq_s > 0 else 0.0
    speedup = cont_tps / seq_tps if seq_tps > 0 else 0.0
    obs.gauge("tpu_patterns_serve_tokens_per_s", mode="continuous").set(
        cont_tps
    )
    obs.gauge("tpu_patterns_serve_tokens_per_s", mode="sequential").set(
        seq_tps
    )

    want_ids = _dense_expected(mcfg, cfg, params, trace, decoder.mesh)
    exact = legs.out_cont == legs.out_seq and _first_divergence(
        writer, "serve", trace, legs.out_cont, want_ids)

    pool_mb, dense_mb = cache_mb(cfg, decoder)
    mem_ok = pool_mb < dense_mb and legs.in_place
    eng = legs.engine
    waits = eng.stats["queue_wait_ns"]
    ok = exact and np.isfinite(speedup) and speedup > cfg.min_speedup and mem_ok
    rec = Record(
        pattern="serve",
        mode=f"slots{cfg.slots}_bl{cfg.block_len}" + _sp_mode(decoder)
        + (f"_gqa{cfg.kv_heads}" if cfg.kv_heads else "")
        + ("_int8" if cfg.cache_int8 else ""),
        commands=_serve_commands(cfg),
        metrics={
            "tokens_per_s": round(cont_tps, 1),
            "sequential_tokens_per_s": round(seq_tps, 1),
            "speedup": round(speedup, 3),
            "exact": float(exact),
            "pool_blocks": float(decoder.layout.n_blocks),
            "cache_MB": round(pool_mb, 4),
            "dense_cache_MB": round(dense_mb, 4),
            "alias_MB": round(pool_mb if legs.in_place else 0.0, 4),
            "max_pool_occupancy": round(eng.stats["max_occupancy"], 3),
            "deferrals": float(eng.stats["deferrals"]),
            "decode_steps": float(eng.stats["steps"]),
            "mean_queue_wait_ms": round(
                float(np.mean(waits)) / 1e6 if waits else 0.0, 3
            ),
        },
        verdict=Verdict.SUCCESS if ok else Verdict.FAILURE,
        config={"device": str(decoder.device), "paged_attn": cfg.paged_attn},
    )
    if not exact:
        rec.notes.append(
            "exactness gate FAILED: continuous batching changed a "
            "request's greedy ids vs per-request dense decode"
        )
    if not speedup > cfg.min_speedup:
        rec.notes.append(
            f"speedup {speedup:.2f} <= {cfg.min_speedup}: continuous "
            "batching did not beat sequential serving on this trace"
        )
    if not mem_ok:
        rec.notes.append(
            "memory gate FAILED: pool not updated in place or cache "
            "bytes not under the dense slots x max_len rectangle"
        )
    rec.notes += _mesh_notes(decoder)
    writer.record(rec)
    recs = [rec]
    if cfg.prefix_share:
        recs.append(_prefix_record(cfg, writer, mcfg, params, decoder))
    if cfg.spec_k:
        recs.append(_spec_record(cfg, writer, mcfg, decoder, params))
    return recs


def _run_scenario_config(cfg: ServeConfig):
    """``serve --scenario``'s LoadGenConfig: the model and pool knobs map
    one-to-one; the scenario owns the trace."""
    from tpu_patterns_torch.loadgen.runner import LoadGenConfig

    return LoadGenConfig(
        vocab=cfg.vocab, embed=cfg.embed, heads=cfg.heads,
        head_dim=cfg.head_dim, mlp_mult=cfg.mlp_mult, depth=cfg.depth,
        dtype=cfg.dtype, rope=cfg.rope, kv_heads=cfg.kv_heads,
        cache_int8=cfg.cache_int8, paged_attn=cfg.paged_attn,
        slots=cfg.slots, block_len=cfg.block_len, n_blocks=cfg.n_blocks,
        spec_k=cfg.spec_k, prefix_share=cfg.prefix_share,
        kv_host_tier=cfg.kv_host_tier, session_dir=cfg.session_dir,
        host_tier_blocks=cfg.host_tier_blocks, seed=cfg.seed,
        time_scale=cfg.time_scale, scenarios=(cfg.scenario,),
        burn_mitigation=cfg.burn_mitigation, slo_fast_s=cfg.slo_fast_s,
        slo_slow_s=cfg.slo_slow_s, slo_budget=cfg.slo_budget,
        burn_multiplier=cfg.burn_multiplier, preempt=cfg.preempt,
        watchdog_s=cfg.watchdog_s, device=cfg.device,
    )


def _run_scenario(cfg: ServeConfig, writer: ResultWriter, mesh=None
                  ) -> list[Record]:
    from tpu_patterns_torch.loadgen.runner import run_loadgen

    return run_loadgen(_run_scenario_config(cfg), writer, mesh)
