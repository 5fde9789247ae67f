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
iteration.  The kv tier, preemption, snapshots, the fleet store,
disaggregated handoff, the watchdog and the ``serve.*`` fault sites
with their retry and quarantine path are not ported (ROADMAP).

``run_serve`` is the measured pattern: the same trace served continuous
(``slots`` wide) and sequential (one slot), gated on speedup, exactness
against the per-request dense decoder and the in-place pool; with
``prefix_share`` or ``spec_k`` it also emits the reference's
``prefix_share_*`` and ``spec_decode_*`` Records.  With ``scenario`` it
is the load generator's SLO pattern instead (``loadgen/runner.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_patterns_torch import obs
from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict
from tpu_patterns_torch.core.timing import clock_ns, device_barrier
from tpu_patterns_torch.models.decode import kv_slot_bytes
from tpu_patterns_torch.models.lm import init_lm_params, make_lm_decoder
from tpu_patterns_torch.models.transformer import ModelConfig
from tpu_patterns_torch.obs.cost import CostBook
from tpu_patterns_torch.obs.cost import register as _register_cost
from tpu_patterns_torch.obs.slo import SloConfig, SloMonitor
from tpu_patterns_torch.runtime import resolve_device
from tpu_patterns_torch.serve.paged import (
    TRASH_BLOCK,
    PagedDecoder,
    make_paged_lm_decoder,
)
from tpu_patterns_torch.serve.paged_kernel import paged_block
from tpu_patterns_torch.serve.prefix import PrefixIndex


def _bucket(n: int, cap: int) -> int:
    """Next power of two >= n, clipped to cap."""
    return min(1 << max(0, n - 1).bit_length(), cap)


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


class ServeEngine:
    """Continuous-batching scheduler over a :class:`PagedDecoder`.

    ``slots`` bounds the active set (the decode bucket ceiling).  The
    decoder may be shared between engines; each engine owns its pool.
    ``prefix_share`` turns on copy-on-write prefix sharing, ``spec_k``
    speculative decoding with up to ``spec_k`` drafts a row a step.
    ``slo`` configures the burn monitor and ``burn_mitigation`` (``off``,
    ``shed``, ``spec_off``) the ladder it drives."""

    def __init__(self, decoder: PagedDecoder, params: dict, *, slots: int,
                 prefix_share: bool = False, spec_k: int = 0,
                 slo: SloConfig | None = None,
                 burn_mitigation: str = "off"):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if burn_mitigation not in ("off", "shed", "spec_off"):
            raise ValueError(
                f"burn_mitigation must be off | shed | spec_off, got "
                f"{burn_mitigation!r}"
            )
        self.decoder = decoder
        self.params = params
        self.slots = slots
        self.layout = decoder.layout
        self.n_pages = decoder.n_pages
        self.pool = decoder.init_pool()
        # block 0 is the trash block: never handed out
        self.free = list(range(self.layout.n_blocks - 1, TRASH_BLOCK, -1))
        # per-block refcount: the live row tables mapping the block, so
        # sum(ref.values()) equals the live table references.  TRASH_BLOCK
        # never appears here.
        self.ref: dict[int, int] = {}
        self.index = (
            PrefixIndex(self.layout.block_len) if prefix_share else None
        )
        self._pending_cow: list[tuple[int, int]] = []  # (src, dst)
        self.spec_k = spec_k
        # the live SLO burn monitor: every finalized request books its
        # tokens good or bad against its deadline; with no deadlines it
        # is inert.  The ladder is opt-in: ``shed`` sheds admissions
        # (bulk first) while a burn episode lasts, ``spec_off`` falls
        # back from the wide step to plain decode (same ids)
        self.slo = SloMonitor(slo)
        self.burn_mitigation = burn_mitigation
        # the cost book: measured prefill/decode walls apportioned over
        # the rows of each wave, and the pool's block-seconds
        self.cost = _register_cost(CostBook(self.layout.n_blocks - 1))
        # admissions the burn ladder shed: {rid: reason}, a terminal
        # bucket like done, so the trace's accounting still closes
        self.shed: dict[int, str] = {}
        self.queue: list[tuple[Request, int]] = []  # (request, t_submit)
        self.active: list[_Slot] = []
        self.done: dict[int, list[int]] = {}
        # per-request lifecycle, written once at retirement: {rid:
        # {status, scenario, n_out, priority, submit/admit/first/last_ns,
        # ttft/tpot/e2e_ms, deadline_ms, met}}
        self.lifecycle: dict[int, dict] = {}
        self.stats = {
            "steps": 0, "prefills": 0, "deferrals": 0, "tokens": 0,
            "max_occupancy": 0.0, "queue_wait_ns": [], "peak_blocks": 0,
            "prefix_hit_blocks": 0, "cow_copies": 0, "spec_steps": 0,
            "spec_row_steps": 0, "spec_tokens": 0, "sheds": 0,
        }

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
        """Allocated blocks no live table references: 0 unless the
        bookkeeping broke."""
        live = {b for s in self.active for b in s.table if b != TRASH_BLOCK}
        return self.allocated_blocks() - len(live)

    def pool_ptrs(self) -> dict[str, int]:
        """Device addresses of the pool leaves: unchanged across a run
        iff every prefill and step updated the pool in place."""
        return {n: t.data_ptr() for n, t in self.pool.items()}

    def _release_block(self, b: int) -> None:
        """Drop one table reference; the last one frees the block and
        (with sharing on) removes its index node, so the index never
        outlives the live shareable set."""
        if b == TRASH_BLOCK:
            return
        n = self.ref.get(b, 0) - 1
        if n > 0:
            self.ref[b] = n
            return
        self.ref.pop(b, None)
        if self.index is not None:
            self.index.remove_block(b)
        self.free.append(b)

    def _retire(self) -> None:
        still = []
        for s in self.active:
            if len(s.out) >= s.n_gen:
                for b in s.table:
                    self._release_block(b)
                self.cost.drop(s.rid)
                self.done[s.rid] = s.out
                self._finalize_lifecycle(s, "done")
                obs.counter("tpu_patterns_serve_requests_total").inc()
            else:
                still.append(s)
        self.active = still

    def _finalize_lifecycle(self, s: _Slot, status: str) -> None:
        """Close out a request: its lifecycle entry, the burn monitor's
        booking and the TTFT/TPOT histograms, all from host stamps the
        loop already took (no device sync).  The reference also writes
        the request's lifecycle spans here; the port has no spans yet."""
        now = clock_ns()
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

    def _shed_request(self, rid: int, reason: str,
                      priority: str = "interactive") -> None:
        """Terminal shed bookkeeping of the burn ladder: counted, never
        dropped silently."""
        self.shed[rid] = reason
        self.stats["sheds"] += 1
        obs.counter("tpu_patterns_serve_shed_total", priority=priority).inc()

    def _admit(self) -> list[tuple[Request, _Slot]]:
        """Pull queued requests FIFO into free slots while blocks last; a
        head the pool cannot cover DEFERS (stays queued, one deferral
        counted) and ends admission, so later requests cannot starve
        it.

        With prefix sharing on, the prompt's indexed whole-block prefix
        aliases existing blocks (refcount + 1, no allocation), a partial
        boundary match claims one fresh block to copy the donor into,
        and only the rest draws on the free list, so a shareable request
        admits where its full rectangle would have deferred.

        While a burn episode is active under ``burn_mitigation="shed"``,
        the queue's first bulk request is shed instead, or the head when
        none is bulk (the reference's ladder with preemption off)."""
        admitted: list[tuple[Request, _Slot]] = []
        while self.queue:
            if self.burn_mitigation == "shed" and self.slo.mitigating():
                bi = next((i for i, (r, _) in enumerate(self.queue)
                           if r.priority == "bulk"), None)
                req, _ = self.queue.pop(0 if bi is None else bi)
                self._shed_request(
                    req.rid,
                    "shed: slo burn-rate mitigation active"
                    + (" (bulk first)" if bi is not None else ""),
                    priority=req.priority,
                )
                continue
            if len(self.active) + len(admitted) >= self.slots:
                break
            req, t_submit = self.queue[0]
            need = self._blocks_needed(req)
            plan = (self.index.plan(req.tokens)
                    if self.index is not None else None)
            # the index never covers more than the prompt's blocks, but
            # aliasing more than the table holds would leak references
            aliased = list(plan.aliased)[:need] if plan else []
            if need - len(aliased) > len(self.free):
                self.stats["deferrals"] += 1
                obs.counter("tpu_patterns_serve_deferrals_total").inc()
                break
            self.queue.pop(0)
            fresh = [self.free.pop() for _ in range(need - len(aliased))]
            table = aliased + fresh
            for b in aliased:
                self.ref[b] = self.ref.get(b, 0) + 1
            for b in fresh:
                self.ref[b] = 1
            write_from = len(aliased) * self.layout.block_len
            if plan is not None and plan.donor is not None and fresh:
                # CoW: the boundary block copies the donor, then this row
                # overwrites its own tail from the split point
                self._pending_cow.append((plan.donor, fresh[0]))
                write_from += plan.donor_len
                self.stats["cow_copies"] += 1
                obs.counter("tpu_patterns_serve_cow_copies_total").inc()
            if aliased:
                self.stats["prefix_hit_blocks"] += len(aliased)
                obs.counter(
                    "tpu_patterns_serve_prefix_hit_blocks_total"
                ).inc(len(aliased))
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
                gen_offset=req.gen_offset, t_admit_ns=now,
            )
            # the row's residency integral opens: it holds len(table)
            # block references until it retires
            self.cost.hold(req.rid, len(table), scenario=req.scenario,
                           priority=req.priority)
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
        padded to a power-of-two lane count with TRASH self-copies."""
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
        t0 = clock_ns()
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
            self.stats["tokens"] += 1
        if self.index is not None:
            for s in slots:
                self.index.materialize(list(s.own_blocks))
        obs.counter("tpu_patterns_serve_tokens_total").inc(len(slots))
        self.stats["prefills"] += 1
        self.active.extend(slots)

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
        t0 = clock_ns()
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
        t0 = clock_ns()
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

    def run(self, requests: list[Request], *, source=None
            ) -> dict[int, list[int]]:
        """Serve ``requests`` to completion; returns {rid: generated ids}.

        ``source`` streams arrivals in: a callable polled once an
        iteration as ``source(idle=...)``, returning newly arrived
        requests (``[]``: nothing yet, ``None``: exhausted).  Items are
        ``Request`` or ``(Request, t_submit_ns)``, the second backdating
        submission to the scheduled arrival.  With ``idle`` true the
        engine has nothing to run and the source owns the wait until its
        next arrival (``loadgen/runner.py``), so this loop never
        sleeps."""
        for r in requests:
            self.submit(r)
        # the cost window covers exactly this loop
        self.cost.start(self.allocated_blocks())
        try:
            while True:
                if source is not None:
                    batch = source(idle=not (self.queue or self.active))
                    if batch is None:
                        source = None
                    else:
                        for item in batch:
                            if isinstance(item, tuple):
                                self.submit(item[0], t_submit_ns=item[1])
                            else:
                                self.submit(item)
                if not (self.queue or self.active):
                    if source is None:
                        break
                    continue
                self._retire()
                # sample the pool integral where retire frees blocks and
                # admission takes them
                self.cost.tick(self.allocated_blocks())
                admitted = self._admit()
                self.cost.tick(self.allocated_blocks())
                if admitted:
                    self._prefill(admitted)
                    self._retire()  # n_gen == 1 finishes at prefill
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
        finally:
            self.cost.close(self.allocated_blocks())
        return dict(self.done)

    def _decode(self) -> None:
        """One decode dispatch for the active set, its wall booked to the
        cost book over the rows that rode it.  Under ``spec_off`` an
        active burn episode falls back from the wide step to plain
        decode (the same ids, less work a step)."""
        use_spec = bool(self.spec_k) and not (
            self.burn_mitigation == "spec_off" and self.slo.mitigating()
        )
        wave = [(s.rid, s.scenario, s.priority) for s in self.active]
        t0 = clock_ns()
        if use_spec:
            self._verify_step()
        else:
            self._step()
        wall_ns = clock_ns() - t0
        obs.histogram("tpu_patterns_serve_decode_wall_ms").observe(
            wall_ns / 1e6
        )
        self.cost.book_decode(wall_ns, wave)


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


def _dense_expected(mcfg, cfg: ServeConfig, params, requests):
    """Per-request greedy ids from the dense batch-1 decoder: the
    engine-independent ground truth."""
    return _oracle_expected(
        mcfg, cfg.vocab, params, requests, max_prompt=cfg.max_prompt,
        max_gen=cfg.gen, cache_int8=cfg.cache_int8,
    )


def _oracle_expected(mcfg, vocab: int, params, requests, *, max_prompt: int,
                     max_gen: int, cache_int8: bool = False):
    """Per-request ground-truth ids from the dense batch-1 decoder:
    greedy rows by the argmax rollout, sampled rows (``temperature >
    0``) by the same ``sample_token_rows`` the serve cores run, keyed
    ``(request.seed, gen_offset + n)``.  No pool, no scheduler, no
    batching: the fixed-seed oracle of every exactness gate."""
    dev = params["wemb"].device
    dpre, dgen = make_lm_decoder(mcfg, vocab, 1, max_prompt, max_gen,
                                 cache_int8=cache_int8)
    want: dict[int, list[int]] = {}
    for r in requests:
        toks = torch.zeros((1, max_prompt), dtype=torch.int32)
        toks[0, : len(r.tokens)] = torch.as_tensor(r.tokens)
        lens = torch.tensor([len(r.tokens)], dtype=torch.int32)
        rows = None
        if r.temperature > 0:
            rows = ([r.seed], [r.gen_offset], [r.temperature], [r.top_k],
                    [r.top_p])
        cache, t0 = dpre(params, toks.to(dev), lens, sample_rows=rows)
        ids = [int(t0[0])]
        if r.n_gen > 1:
            _, gen_ids = dgen(params, cache, t0, (lens, 0), r.n_gen - 1,
                              sample_rows=rows)
            ids += gen_ids[0].tolist()
        want[r.rid] = ids
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
    device_barrier(decoder.device)
    paged_block.launches = 0
    t0 = clock_ns()
    out = eng.run([dataclasses.replace(r) for r in trace])
    device_barrier(decoder.device)
    wall_s = (clock_ns() - t0) / 1e9
    return out, wall_s, eng, ptrs == eng.pool_ptrs(), paged_block.launches


def serve_legs(decoder: PagedDecoder, params: dict, trace: list[Request],
               slots: int, **engine_kw) -> ServeLegs:
    out_cont, cont_s, eng, in_place, launches = timed_run(
        decoder, params, trace, slots, **engine_kw)
    out_seq, seq_s, _, _, _ = timed_run(decoder, params, trace, 1,
                                        **engine_kw)
    return ServeLegs(out_cont, out_seq, cont_s, seq_s, eng, in_place,
                     launches)


def build_serve(cfg: ServeConfig):
    """(model config, decoder, params, trace) for ``cfg`` on its device:
    weights from ``cfg.seed``, the trace from ``cfg.seed + 1``."""
    dev = resolve_device(cfg.device)
    mcfg = model_config(cfg)
    decoder = make_paged_lm_decoder(
        mcfg, cfg.vocab, n_blocks=cfg.n_blocks or _auto_blocks(cfg),
        block_len=cfg.block_len, max_len=cfg.max_prompt + cfg.gen,
        cache_int8=cfg.cache_int8, attn=cfg.paged_attn, device=dev,
    )
    params = decoder.stack_params(
        init_lm_params(cfg.seed, mcfg, cfg.vocab, dev)
    )
    return mcfg, decoder, params, random_trace(cfg)


def cache_mb(cfg: ServeConfig, decoder: PagedDecoder) -> tuple[float, float]:
    """(pool MB, dense ``slots x max_len`` rectangle MB) of KV cache."""
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


def prefix_decoder(cfg: ServeConfig, mcfg, device) -> PagedDecoder:
    """The prefix-share Record's decoder: a pool covering every slot's
    whole lifetime, so sharing changes allocation and never deferral."""
    max_len = cfg.max_prompt + cfg.gen
    per_row = -(-max_len // cfg.block_len)
    return make_paged_lm_decoder(
        mcfg, cfg.vocab, n_blocks=cfg.slots * per_row + 1,
        block_len=cfg.block_len, max_len=max_len,
        cache_int8=cfg.cache_int8, attn=cfg.paged_attn, device=device,
    )


def _prefix_record(cfg: ServeConfig, writer: ResultWriter, mcfg, params,
                   device) -> Record:
    """Measured pattern: the same shared-prefix trace served with CoW
    block sharing on and off, through one decoder whose pool covers the
    whole non-shared demand (so the contrast is allocation, not
    deferral).  Gates: at least ``min_block_savings`` fewer peak
    allocated blocks, every request's ids equal to its per-request dense
    decode, shared ids equal to non-shared ones, and no leaked block."""
    decoder = prefix_decoder(cfg, mcfg, device)
    trace, s_len = shared_trace(cfg)

    def serve_once(share: bool):
        eng = ServeEngine(decoder, params, slots=cfg.slots,
                          prefix_share=share, **_slo_kwargs(cfg))
        return eng.run([dataclasses.replace(r) for r in trace]), eng

    out_shared, eng_s = serve_once(True)
    out_plain, eng_p = serve_once(False)
    want_ids = _dense_expected(mcfg, cfg, params, trace)
    exact = out_shared == out_plain and _first_divergence(
        writer, "prefix-share", trace, out_shared, want_ids)

    peak_s = eng_s.stats["peak_blocks"]
    peak_p = eng_p.stats["peak_blocks"]
    savings = 1.0 - (peak_s / peak_p) if peak_p else 0.0
    block_mb = decoder.pool_nbytes() / decoder.layout.n_blocks / 1e6
    leaked = eng_s.leaked_blocks()
    ok = (exact and peak_s < peak_p and savings >= cfg.min_block_savings
          and leaked == 0)
    rec = Record(
        pattern="serve",
        mode=f"prefix_share_req{cfg.requests}_bl{cfg.block_len}_sp1",
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
    eng_spec = ServeEngine(decoder, params, slots=cfg.slots,
                           spec_k=cfg.spec_k, **_slo_kwargs(cfg))
    out_spec = eng_spec.run([dataclasses.replace(r) for r in trace])
    eng_plain = ServeEngine(decoder, params, slots=cfg.slots,
                            **_slo_kwargs(cfg))
    out_plain = eng_plain.run([dataclasses.replace(r) for r in trace])
    want_ids = _dense_expected(mcfg, cfg, params, trace)
    exact = out_spec == out_plain and _first_divergence(
        writer, "spec-decode", trace, out_spec, want_ids)

    row_steps = eng_spec.stats["spec_row_steps"]
    accepted = eng_spec.stats["spec_tokens"] / row_steps if row_steps else 0.0
    ok = exact and accepted > cfg.min_accepted
    rec = Record(
        pattern="serve",
        mode=f"spec_decode_k{cfg.spec_k}_sp1",
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
    writer.record(rec)
    return rec


def run_serve(cfg: ServeConfig, writer: ResultWriter | None = None
              ) -> list[Record]:
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

    With ``scenario`` the run is the load generator's instead
    (``loadgen/runner.py::run_loadgen``) on this model and pool, one
    Record for the scenario.  The JAX package's bridge leaves
    ``paged_attn`` at the load generator's default; this one passes it.
    """
    writer = writer or ResultWriter()
    if cfg.scenario:
        return _run_scenario(cfg, writer)
    mcfg, decoder, params, trace = build_serve(cfg)
    total_tokens = sum(r.n_gen for r in trace)

    legs = serve_legs(decoder, params, trace, cfg.slots, **_slo_kwargs(cfg))
    cont_tps = total_tokens / legs.cont_s if legs.cont_s > 0 else 0.0
    seq_tps = total_tokens / legs.seq_s if legs.seq_s > 0 else 0.0
    speedup = cont_tps / seq_tps if seq_tps > 0 else 0.0

    want_ids = _dense_expected(mcfg, cfg, params, trace)
    exact = legs.out_cont == legs.out_seq and _first_divergence(
        writer, "serve", trace, legs.out_cont, want_ids)

    pool_mb, dense_mb = cache_mb(cfg, decoder)
    mem_ok = pool_mb < dense_mb and legs.in_place
    eng = legs.engine
    waits = eng.stats["queue_wait_ns"]
    ok = exact and np.isfinite(speedup) and speedup > cfg.min_speedup and mem_ok
    rec = Record(
        pattern="serve",
        mode=f"slots{cfg.slots}_bl{cfg.block_len}_sp1"
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
    writer.record(rec)
    recs = [rec]
    if cfg.prefix_share:
        recs.append(_prefix_record(cfg, writer, mcfg, params,
                                   decoder.device))
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
        spec_k=cfg.spec_k, prefix_share=cfg.prefix_share, seed=cfg.seed,
        time_scale=cfg.time_scale, scenarios=(cfg.scenario,),
        burn_mitigation=cfg.burn_mitigation, slo_fast_s=cfg.slo_fast_s,
        slo_slow_s=cfg.slo_slow_s, slo_budget=cfg.slo_budget,
        burn_multiplier=cfg.burn_multiplier, device=cfg.device,
    )


def _run_scenario(cfg: ServeConfig, writer: ResultWriter) -> list[Record]:
    from tpu_patterns_torch.loadgen.runner import run_loadgen

    return run_loadgen(_run_scenario_config(cfg), writer)
