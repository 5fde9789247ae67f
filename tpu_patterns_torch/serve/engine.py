"""Continuous-batching serve engine: iteration-level scheduling over the
paged pool.

Counterpart of the scheduler core of ``tpu_patterns/serve/engine.py``.
The host loop owns the request queue, the slot table and the block free
list.  Each iteration it

  1. RETIRES finished rows (their blocks return to the free list),
  2. ADMITS queued requests FIFO into free slots, reserving each one's
     whole lifetime (``ceil((prompt + gen - 1) / block_len)`` blocks) at
     admission, and DEFERS (never OOMs) when the pool cannot cover the
     head of the queue,
  3. PREFILLS the newcomers as one bucketed call (ragged lens), and
  4. runs ONE decode step for the whole active set, each row at its own
     position, so a row admitted late decodes beside an early one.

Row counts and prompt lengths are bucketed to powers of two, as in the
JAX package, so the set of shapes the device sees stays small.

``run_serve`` is the measured pattern: the same trace served continuous
(``slots`` wide) and sequential (one slot), gated on speedup, exactness
against the per-request dense decoder and the in-place pool.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict
from tpu_patterns_torch.core.timing import clock_ns, device_barrier
from tpu_patterns_torch.models.decode import kv_slot_bytes
from tpu_patterns_torch.models.lm import init_lm_params, make_lm_decoder
from tpu_patterns_torch.models.transformer import ModelConfig
from tpu_patterns_torch.runtime import resolve_device
from tpu_patterns_torch.serve.paged import (
    TRASH_BLOCK,
    PagedDecoder,
    make_paged_lm_decoder,
)
from tpu_patterns_torch.serve.paged_kernel import paged_block


def _bucket(n: int, cap: int) -> int:
    """Next power of two >= n, clipped to cap."""
    return min(1 << max(0, n - 1).bit_length(), cap)


@dataclasses.dataclass
class Request:
    rid: int
    tokens: list[int]  # prompt ids
    n_gen: int  # total tokens to generate (the first comes from prefill)


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


class ServeEngine:
    """Continuous-batching scheduler over a :class:`PagedDecoder`.

    ``slots`` bounds the active set (the decode bucket ceiling).  The
    decoder may be shared between engines; each engine owns its pool."""

    def __init__(self, decoder: PagedDecoder, params: dict, *, slots: int):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.decoder = decoder
        self.params = params
        self.slots = slots
        self.layout = decoder.layout
        self.n_pages = decoder.n_pages
        self.pool = decoder.init_pool()
        # block 0 is the trash block: never handed out
        self.free = list(range(self.layout.n_blocks - 1, TRASH_BLOCK, -1))
        self.queue: list[tuple[Request, int]] = []  # (request, t_submit)
        self.active: list[_Slot] = []
        self.done: dict[int, list[int]] = {}
        self.stats = {
            "steps": 0, "deferrals": 0, "tokens": 0, "max_occupancy": 0.0,
            "queue_wait_ns": [],
        }

    # -- bookkeeping -----------------------------------------------------

    def _blocks_needed(self, req: Request) -> int:
        # the highest written position is prompt + n_gen - 2 (the final
        # token is returned, its K/V never stored); n_gen == 1 still
        # reserves the prompt's blocks
        return self.layout.blocks_for(len(req.tokens) + max(req.n_gen - 1, 0))

    def submit(self, req: Request, t_submit_ns: int | None = None) -> None:
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

    def _retire(self) -> None:
        still = []
        for s in self.active:
            if len(s.out) >= s.n_gen:
                # no prefix sharing: a table is the only owner of its
                # blocks, so retiring frees them all
                self.free.extend(s.table)
                self.done[s.rid] = s.out
            else:
                still.append(s)
        self.active = still

    def _admit(self) -> list[tuple[Request, _Slot]]:
        """Pull queued requests FIFO into free slots while blocks last; a
        head the pool cannot cover DEFERS (stays queued, one deferral
        counted) and ends admission, so later requests cannot starve
        it."""
        admitted: list[tuple[Request, _Slot]] = []
        while self.queue and len(self.active) + len(admitted) < self.slots:
            req, t_submit = self.queue[0]
            need = self._blocks_needed(req)
            if need > len(self.free):
                self.stats["deferrals"] += 1
                break
            self.queue.pop(0)
            table = [self.free.pop() for _ in range(need)]
            now = clock_ns()
            slot = _Slot(
                rid=req.rid, lens=len(req.tokens), steps=0, n_gen=req.n_gen,
                table=table, last_tok=-1, out=[], t_submit_ns=t_submit,
            )
            self.stats["queue_wait_ns"].append(now - t_submit)
            admitted.append((req, slot))
        return admitted

    def _tables_array(self, slots: list[_Slot], rows: int) -> np.ndarray:
        t = np.full((rows, self.n_pages), TRASH_BLOCK, np.int32)
        for i, s in enumerate(slots):
            t[i, : len(s.table)] = s.table
        return t

    def _prefill(self, admitted: list[tuple[Request, _Slot]]) -> None:
        reqs = [r for r, _ in admitted]
        slots = [s for _, s in admitted]
        lmax = max(len(r.tokens) for r in reqs)
        lpad = _bucket(lmax, self.n_pages * self.layout.block_len)
        rows = _bucket(len(reqs), self.slots)
        tokens = np.zeros((rows, lpad), np.int32)
        lens = np.zeros((rows,), np.int32)
        # the write fence: no prefix sharing, so every row writes its
        # whole prompt from position 0
        start = np.zeros((rows,), np.int32)
        active = np.zeros((rows,), bool)
        for i, r in enumerate(reqs):
            tokens[i, : len(r.tokens)] = r.tokens
            lens[i] = len(r.tokens)
            active[i] = True
        tables = self._tables_array(slots, rows)
        tok0 = self.decoder.prefill(
            self.params, self.pool, tokens, lens, start, tables, active
        )
        # the scheduler's one sync per call: ids must reach the host
        tok0 = tok0.cpu().numpy()
        for i, s in enumerate(slots):
            s.last_tok = int(tok0[i])
            s.out.append(s.last_tok)
            self.stats["tokens"] += 1
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
        nxt = self.decoder.step(
            self.params, self.pool, tok, lens, steps, tables, active
        )
        nxt = nxt.cpu().numpy()
        for i, s in enumerate(self.active):
            s.steps += 1  # the fed token's K/V is now in the pool
            s.last_tok = int(nxt[i])
            s.out.append(s.last_tok)
            self.stats["tokens"] += 1
        self.stats["steps"] += 1

    def run(self, requests: list[Request]) -> dict[int, list[int]]:
        """Serve ``requests`` to completion; returns {rid: generated ids}."""
        for r in requests:
            self.submit(r)
        while self.queue or self.active:
            self._retire()
            admitted = self._admit()
            if admitted:
                self._prefill(admitted)
                self._retire()  # n_gen == 1 finishes at prefill
            if self.active:
                self._step()
            self.stats["max_occupancy"] = max(
                self.stats["max_occupancy"], self._occupancy()
            )
        return dict(self.done)


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
    seed: int = 0
    device: str = "cuda"  # "cpu" runs the plain torch versions


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


def model_config(cfg: ServeConfig) -> ModelConfig:
    return ModelConfig(
        embed=cfg.embed, heads=cfg.heads, head_dim=cfg.head_dim,
        mlp_mult=cfg.mlp_mult, dtype=cfg.dtype, depth=cfg.depth,
        kv_heads=cfg.kv_heads, rope=cfg.rope,
    )


def _dense_expected(mcfg, cfg: ServeConfig, params, requests):
    """Per-request greedy ids from the dense batch-1 decoder: the
    engine-independent ground truth."""
    dev = params["wemb"].device
    dpre, dgen = make_lm_decoder(
        mcfg, cfg.vocab, 1, cfg.max_prompt, cfg.gen,
        cache_int8=cfg.cache_int8,
    )
    want: dict[int, list[int]] = {}
    for r in requests:
        toks = torch.zeros((1, cfg.max_prompt), dtype=torch.int32)
        toks[0, : len(r.tokens)] = torch.as_tensor(r.tokens)
        lens = torch.tensor([len(r.tokens)], dtype=torch.int32)
        cache, t0 = dpre(params, toks.to(dev), lens)
        ids = [int(t0[0])]
        if r.n_gen > 1:
            _, gen_ids = dgen(params, cache, t0, (lens, 0), r.n_gen - 1)
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


def serve_legs(decoder: PagedDecoder, params: dict, trace: list[Request],
               slots: int) -> ServeLegs:
    def timed_run(n_slots: int):
        ServeEngine(decoder, params, slots=n_slots).run(
            [dataclasses.replace(r) for r in trace]
        )  # warm-up: library loads, allocator and kernel caches
        eng = ServeEngine(decoder, params, slots=n_slots)
        ptrs = eng.pool_ptrs()
        device_barrier(decoder.device)
        paged_block.launches = 0
        t0 = clock_ns()
        out = eng.run([dataclasses.replace(r) for r in trace])
        device_barrier(decoder.device)
        wall_s = (clock_ns() - t0) / 1e9
        launches = paged_block.launches
        return out, wall_s, eng, ptrs == eng.pool_ptrs(), launches

    out_cont, cont_s, eng, in_place, launches = timed_run(slots)
    out_seq, seq_s, _, _, _ = timed_run(1)
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
    """
    writer = writer or ResultWriter()
    mcfg, decoder, params, trace = build_serve(cfg)
    total_tokens = sum(r.n_gen for r in trace)

    legs = serve_legs(decoder, params, trace, cfg.slots)
    cont_tps = total_tokens / legs.cont_s if legs.cont_s > 0 else 0.0
    seq_tps = total_tokens / legs.seq_s if legs.seq_s > 0 else 0.0
    speedup = cont_tps / seq_tps if seq_tps > 0 else 0.0

    want_ids = _dense_expected(mcfg, cfg, params, trace)
    exact = legs.out_cont == legs.out_seq
    for r in trace:
        if legs.out_cont.get(r.rid) != want_ids[r.rid]:
            exact = False
            writer.progress(
                f"serve exactness: request {r.rid} diverged from dense "
                f"decode (got {legs.out_cont.get(r.rid)}, "
                f"want {want_ids[r.rid]})"
            )
            break

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
    return [rec]
