"""The executable registry: one capture = one normalized perf snapshot.

Counterpart of the capture half of ``tpu_patterns/perf/registry.py``.
Every ported entry point the package serves traffic through is
registered here with (a) a function that constructs it at a small but
real config on the run's device, (b) its closed-form analytic cost
(``perf/analytic.py``), and (c) how it is *measured*: direct
median-of-k timed calls for the cores, and the engine-driven serve leg
for ``serve.step``, whose wall clock is read from the
``tpu_patterns_serve_decode_wall_ms`` histogram the scheduler loop feeds
(``serve/engine.py``), so injected faults and scheduler overhead are
inside the measured window.

Per executable the capture records:

* ``analytic_flops`` / ``analytic_hbm_bytes`` — device-independent
  model counts (metric class ``analytic``: ratcheted everywhere);
* ``step_ms`` — median over ``k`` reps of mean-per-call wall time, each
  rep ending in a device barrier (class ``measured``: noise-banded,
  machine-bound);
* derived ``achieved_gflops``/``achieved_gbps``/
  ``intensity_flops_per_byte``, and ``mfu`` where the card's datasheet
  peak is known (``runtime.chip_peak_tflops``) — the roofline position.
  On the card a reading past the datasheet (an ``mfu`` above 1.0, or
  GB/s past ``SPEC_PLAUSIBILITY_MARGIN`` x the memory rate) raises: it
  is an accounting or timing fault, never a result.

The JAX package's compiler figures (``cost_analysis``,
``memory_analysis``, compile times) have no counterpart in eager torch
and are not captured.  ``decoder.step_pallas``/``verify_pallas`` run the
paged-attention kernel K1 (``serve/paged_kernel.py``; on CPU tensors
its plain version) at the same shapes and floors as the dense legs.
``zero.step`` runs the ZeRO-adam train step (``models/zero_step.py``)
over two dp ranks on the one device, a real dp axis as the JAX
package's ``_train_mesh`` gives it.  ``serve.prefix_store`` is the
fleet prefix store's round trip (a publisher engine, then a cold
fetcher engine on the same trace, in one process).  ``disagg.stream``
is the disaggregated handoff's wire (``PagedDecoder.stream``) at one
request's worth of shipped blocks.  The JAX package's Tier C
``SpmdEntry`` registry serves its static analysis and is not part of
this module (ROADMAP.md Queue 1 step 10).

Every direct-timed rep runs inside an ``obs.span("perf.<name>")``.
"""

from __future__ import annotations

import dataclasses
import statistics
import subprocess

import numpy as np
import torch

from tpu_patterns_torch.core.timing import (
    clock_ns,
    device_barrier,
    wall_time_s,
)


@dataclasses.dataclass
class PerfConfig:
    """CLI ``perf`` subcommand (capture shape + measurement policy)."""

    vocab: int = 256
    embed: int = 64
    heads: int = 4
    head_dim: int = 16
    mlp_mult: int = 4
    depth: int = 2
    dtype: str = "float32"
    rope: bool = True
    kv_heads: int = 0
    cache_int8: bool = False
    # decode/serve shape
    slots: int = 4
    block_len: int = 16
    requests: int = 6
    min_prompt: int = 8
    max_prompt: int = 24
    gen: int = 8
    spec_width: int = 3  # drafted tokens per row in the verify capture
    # train shape
    batch: int = 8
    seq: int = 32
    # measurement policy: median of k reps, each rep averaging `inner`
    # back-to-back calls
    k: int = 5
    inner: int = 16
    # comma-separated subset of executable names ("" = the full
    # registry); unknown names fail loudly
    include: str = ""
    seed: int = 0
    device: str = "cuda"  # "cpu" runs the plain torch versions


# the JAX package's registry, in its order
EXECUTABLES = (
    "train.step",
    "zero.step",
    "decoder.prefill",
    "decoder.step",
    "decoder.verify",
    "decoder.step_pallas",
    "decoder.verify_pallas",
    "copy_blocks",
    "disagg.stream",
    "serve.step",
    "serve.kv_tier",
    "serve.prefix_store",
)


def _selected(cfg: PerfConfig) -> list[str]:
    if not cfg.include:
        return list(EXECUTABLES)
    names = [n.strip() for n in cfg.include.split(",") if n.strip()]
    unknown = sorted(set(names) - set(EXECUTABLES))
    if unknown:
        raise ValueError(
            f"unknown executable(s) {unknown} — registry: "
            f"{list(EXECUTABLES)}"
        )
    return names


def _median_ms(reps: list[float]) -> float:
    return statistics.median(reps)


def _timed_reps(name: str, fn, cfg: PerfConfig, dev) -> float:
    """Median-of-k of mean-per-call milliseconds.  Each rep runs inside
    a ``perf.<name>`` span and ends in a device barrier, so the time is
    the work's, not its enqueue's."""
    from tpu_patterns_torch import obs

    fn()  # warm: first launches, kernel builds, allocator growth
    device_barrier(dev)
    reps = []
    for _ in range(cfg.k):
        t0 = clock_ns()
        with obs.span(f"perf.{name}", inner=cfg.inner):
            for _ in range(cfg.inner):
                fn()
            device_barrier(dev)
        reps.append((clock_ns() - t0) / 1e6 / cfg.inner)
    return _median_ms(reps)


def _mcfg(cfg: PerfConfig):
    from tpu_patterns_torch.models.transformer import ModelConfig

    return ModelConfig(
        embed=cfg.embed, heads=cfg.heads, head_dim=cfg.head_dim,
        mlp_mult=cfg.mlp_mult, causal=True, dtype=cfg.dtype,
        depth=cfg.depth, kv_heads=cfg.kv_heads, rope=cfg.rope,
    )


# -- per-executable captures ----------------------------------------------


def _train_metrics(cfg: PerfConfig, mcfg) -> dict:
    from tpu_patterns_torch.perf import analytic

    return {
        "analytic_flops": analytic.train_step_flops(mcfg, cfg.batch,
                                                    cfg.seq),
        "analytic_hbm_bytes": analytic.train_step_hbm_bytes(
            mcfg, cfg.batch, cfg.seq
        ),
    }


def _capture_train(cfg: PerfConfig, dev) -> dict[str, dict]:
    from tpu_patterns_torch.models.transformer import (
        init_params,
        make_train_step,
    )

    mcfg = _mcfg(cfg)
    params = init_params(torch.Generator().manual_seed(cfg.seed), mcfg, dev)
    x = torch.zeros((cfg.batch, cfg.seq, cfg.embed), dtype=mcfg.torch_dtype,
                    device=dev)
    step = make_train_step(None, mcfg)
    state = {"p": params}

    def call():
        state["p"], loss = step(state["p"], x)
        return loss

    m = _train_metrics(cfg, mcfg)
    m["step_ms"] = _timed_reps("train.step", call, cfg, dev)
    return {"train.step": m}


def _capture_zero(cfg: PerfConfig, dev) -> dict[str, dict]:
    """zero.step: the ZeRO-adam step, donating its slices and moments,
    over a (2, 1, 1) mesh of two ranks on ``dev`` (the batch split over
    dp)."""
    from tpu_patterns_torch.comm.mesh import NamedMesh, RankMesh
    from tpu_patterns_torch.models.transformer import (
        init_params,
        shard_params,
    )
    from tpu_patterns_torch.models.zero_step import make_zero_train_step

    mcfg = _mcfg(cfg)
    mesh = NamedMesh(RankMesh((dev, dev)), ("dp", "sp", "tp"), (2, 1, 1))
    params = init_params(torch.Generator().manual_seed(cfg.seed), mcfg, dev)
    x = torch.zeros((cfg.batch, cfg.seq, cfg.embed), dtype=mcfg.torch_dtype,
                    device=dev)
    xs = mesh.shard(x, ("dp", "sp", None))
    step, init, _ = make_zero_train_step(mesh, mcfg, donate=True)
    shards, opt = init(shard_params(params, mesh, mcfg))

    def call():
        _, _, loss = step(shards, opt, xs)
        return loss

    m = _train_metrics(cfg, mcfg)
    m["step_ms"] = _timed_reps("zero.step", call, cfg, dev)
    return {"zero.step": m}


def decoder_for(cfg: PerfConfig, dev, attn: str = "dense"):
    """(decoder, params, model config) of the direct captures: exactly
    one private table window a slot plus the trash block, so the
    captures address blocks deterministically (:func:`tables_for`)."""
    from tpu_patterns_torch.models.lm import init_lm_params
    from tpu_patterns_torch.serve.paged import make_paged_lm_decoder

    mcfg = _mcfg(cfg)
    max_len = cfg.max_prompt + cfg.gen
    n_pages = -(-max_len // cfg.block_len)
    decoder = make_paged_lm_decoder(
        mcfg, cfg.vocab, n_blocks=cfg.slots * n_pages + 1,
        block_len=cfg.block_len, max_len=max_len,
        cache_int8=cfg.cache_int8, attn=attn, device=dev,
    )
    params = decoder.stack_params(
        init_lm_params(cfg.seed, mcfg, cfg.vocab, dev)
    )
    return decoder, params, mcfg


def tables_for(decoder, slots: int) -> np.ndarray:
    """Row i owns blocks [1 + i*n_pages, ...) — the deterministic layout
    the direct captures write through (block 0 stays TRASH)."""
    n_pages = decoder.n_pages
    return np.asarray(
        [[1 + i * n_pages + j for j in range(n_pages)]
         for i in range(slots)],
        np.int32,
    )


def core_inputs(cfg: PerfConfig, decoder) -> dict:
    """The direct captures' inputs, drawn from ``cfg.seed`` in the JAX
    package's order, on the decoder's device: every row at the full
    (padded) prompt for prefill, a one-token step and a verify of
    ``spec_width`` drafts at context ~= the prompt."""
    rng = np.random.RandomState(cfg.seed)
    slots, lpad = cfg.slots, cfg.max_prompt
    width = cfg.spec_width + 1
    host = {
        "tokens": rng.randint(0, cfg.vocab, size=(slots, lpad)),
        "lens": np.full((slots,), lpad),
        "start": np.zeros((slots,)),
        "tables": tables_for(decoder, slots),
        "tok": rng.randint(0, cfg.vocab, size=(slots,)),
        "steps": np.zeros((slots,)),
        "toks_w": rng.randint(0, cfg.vocab, size=(slots, width)),
        "n_draft": np.full((slots,), cfg.spec_width),
    }
    out = {k: torch.as_tensor(v.astype(np.int32), device=decoder.device)
           for k, v in host.items()}
    out["active"] = torch.ones((slots,), dtype=torch.bool,
                               device=decoder.device)
    return out


def _step_metrics(cfg: PerfConfig, mcfg) -> dict:
    from tpu_patterns_torch.perf import analytic

    return {
        "analytic_flops": analytic.step_flops(
            mcfg, cfg.vocab, cfg.slots, cfg.max_prompt
        ),
        "analytic_hbm_bytes": analytic.step_hbm_bytes(
            mcfg, cfg.vocab, cfg.slots, cfg.max_prompt, cfg.cache_int8
        ),
    }


def _verify_metrics(cfg: PerfConfig, mcfg) -> dict:
    from tpu_patterns_torch.perf import analytic

    width = cfg.spec_width + 1
    return {
        "analytic_flops": analytic.verify_flops(
            mcfg, cfg.vocab, cfg.slots, width, cfg.max_prompt
        ),
        "analytic_hbm_bytes": float(
            width * analytic.step_hbm_bytes(
                mcfg, cfg.vocab, cfg.slots, cfg.max_prompt, cfg.cache_int8
            )
            - (width - 1) * analytic.param_bytes(mcfg, cfg.vocab)
        ),  # params stream once for the whole wide step
    }


def _capture_decoder(cfg: PerfConfig, dev) -> dict[str, dict]:
    """decoder.prefill / decoder.step / decoder.verify / copy_blocks —
    direct-timed cores over one pool, updated in place."""
    from tpu_patterns_torch.perf import analytic

    decoder, params, mcfg = decoder_for(cfg, dev)
    a = core_inputs(cfg, decoder)
    pool = decoder.init_pool()
    out: dict[str, dict] = {}

    def call_prefill():
        return decoder.prefill(params, pool, a["tokens"], a["lens"],
                               a["start"], a["tables"], a["active"])

    m = {
        "analytic_flops": analytic.prefill_flops(
            mcfg, cfg.vocab, cfg.slots, cfg.max_prompt
        ),
        "analytic_hbm_bytes": analytic.prefill_hbm_bytes(
            mcfg, cfg.vocab, cfg.slots, cfg.max_prompt, cfg.cache_int8
        ),
    }
    m["step_ms"] = _timed_reps("decoder.prefill", call_prefill, cfg, dev)
    out["decoder.prefill"] = m

    def call_step():
        return decoder.step(params, pool, a["tok"], a["lens"], a["steps"],
                            a["tables"], a["active"])

    m = _step_metrics(cfg, mcfg)
    m["step_ms"] = _timed_reps("decoder.step", call_step, cfg, dev)
    out["decoder.step"] = m

    def call_verify():
        return decoder.verify(params, pool, a["toks_w"], a["lens"],
                              a["steps"], a["n_draft"], a["tables"],
                              a["active"])

    m = _verify_metrics(cfg, mcfg)
    m["step_ms"] = _timed_reps("decoder.verify", call_verify, cfg, dev)
    out["decoder.verify"] = m

    # CoW boundary copy: clone 2 physical blocks (all layers)
    n_copy = 2
    src = torch.tensor([1, 2], device=decoder.device)
    dst = torch.tensor([3, 4], device=decoder.device)

    def call_copy():
        decoder.copy_blocks(pool, src, dst)
        return pool["k"]

    copy_bytes = float(
        2 * n_copy * cfg.block_len
        * analytic.kv_token_bytes(mcfg, cfg.cache_int8)
    )  # read + write each copied slot across every layer
    m = {"analytic_flops": 0.0, "analytic_hbm_bytes": copy_bytes}
    m["step_ms"] = _timed_reps("copy_blocks", call_copy, cfg, dev)
    out["copy_blocks"] = m
    return out


def _capture_decoder_pallas(cfg: PerfConfig, dev) -> dict[str, dict]:
    """decoder.step_pallas / decoder.verify_pallas — the paged-attention
    kernel K1 timed at the SAME shapes and analytic floors as the dense
    legs, so ``perf diff`` reads the A/B off two ratcheted rows.  The
    pool is seeded by a prefill so the timed kernel reads live pages."""
    decoder, params, mcfg = decoder_for(cfg, dev, attn="kernel")
    a = core_inputs(cfg, decoder)
    pool = decoder.init_pool()
    decoder.prefill(params, pool, a["tokens"], a["lens"], a["start"],
                    a["tables"], a["active"])
    out: dict[str, dict] = {}

    def call_step():
        return decoder.step(params, pool, a["tok"], a["lens"], a["steps"],
                            a["tables"], a["active"])

    m = _step_metrics(cfg, mcfg)
    m["step_ms"] = _timed_reps("decoder.step_pallas", call_step, cfg, dev)
    out["decoder.step_pallas"] = m

    def call_verify():
        return decoder.verify(params, pool, a["toks_w"], a["lens"],
                              a["steps"], a["n_draft"], a["tables"],
                              a["active"])

    m = _verify_metrics(cfg, mcfg)
    m["step_ms"] = _timed_reps("decoder.verify_pallas", call_verify, cfg,
                               dev)
    out["decoder.verify_pallas"] = m
    return out


def _capture_disagg_stream(cfg: PerfConfig, dev) -> dict[str, dict]:
    """disagg.stream — the prefill->decode KV-block wire, direct-timed at
    one request's worth of shipped blocks (its whole table window).  The
    payload is gathered once from a prefilled pool (live KV, not init
    zeros), then the wire is timed rethreading its own output, as the
    handoff drives it.  The byte floor is the shipped payload
    (``transfer_bytes``, analytic); ``analytic_hbm_bytes`` counts the two
    hops' read and write traffic."""
    from tpu_patterns_torch.perf import analytic

    decoder, params, mcfg = decoder_for(cfg, dev)
    a = core_inputs(cfg, decoder)
    pool = decoder.init_pool()
    decoder.prefill(params, pool, a["tokens"], a["lens"], a["start"],
                    a["tables"], a["active"])
    n_ship = decoder.n_pages
    state = {"vals": decoder.gather_blocks(pool, a["tables"][0, :n_ship])}

    def call():
        state["vals"] = decoder.stream(state["vals"])
        return state["vals"]["k"]

    payload = float(n_ship * cfg.block_len
                    * analytic.kv_token_bytes(mcfg, cfg.cache_int8))
    ms = _timed_reps("disagg.stream", call, cfg, dev)
    return {"disagg.stream": {
        "analytic_flops": 0.0,
        # two hops, each reading and writing every payload byte
        "analytic_hbm_bytes": 4.0 * payload,
        "transfer_bytes": payload,
        "transfer_ms": ms,
        "step_ms": ms,
    }}


def _hist_state(name: str) -> tuple[float, int]:
    from tpu_patterns_torch import obs

    h = obs.histogram(name)
    return h.sum, h.count


def _engine_reps(cfg: PerfConfig, run_once) -> tuple[list[float], object]:
    """``k`` engine runs after one warm-up run: each run's mean decode
    wall a dispatch, read from the engine's own histogram."""
    run_once()  # warm every bucket the trace will hit
    reps, eng = [], None
    for _ in range(cfg.k):
        s0, c0 = _hist_state("tpu_patterns_serve_decode_wall_ms")
        eng = run_once()
        s1, c1 = _hist_state("tpu_patterns_serve_decode_wall_ms")
        if c1 > c0:
            reps.append((s1 - s0) / (c1 - c0))
    return reps, eng


def _capture_serve(cfg: PerfConfig, dev) -> dict[str, dict]:
    """The engine-driven leg: a real trace through ServeEngine on the
    serve path's attention (K1), wall a decode dispatch from the
    engine's ``tpu_patterns_serve_decode_wall_ms`` histogram — fault
    injection and scheduler overhead are inside the window, which is
    what lets a ``serve.step`` sleep fault show up in ``perf diff``."""
    from tpu_patterns_torch.perf import analytic
    from tpu_patterns_torch.serve.engine import Request, ServeEngine

    decoder, params, mcfg = decoder_for(cfg, dev, attn="kernel")
    rng = np.random.RandomState(cfg.seed + 1)
    trace = [
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

    def run_once():
        eng = ServeEngine(decoder, params, slots=cfg.slots)
        eng.run([dataclasses.replace(r) for r in trace])
        return eng

    reps, _ = _engine_reps(cfg, run_once)
    # mean served context: prompts average (min+max)/2, generation adds
    # gen/2 on average over a request's lifetime
    ctx = (cfg.min_prompt + cfg.max_prompt) // 2 + cfg.gen // 2
    return {"serve.step": {
        "analytic_flops": analytic.step_flops(
            mcfg, cfg.vocab, cfg.slots, ctx
        ),
        "analytic_hbm_bytes": analytic.step_hbm_bytes(
            mcfg, cfg.vocab, cfg.slots, ctx, cfg.cache_int8
        ),
        "step_ms": _median_ms(reps) if reps else -1.0,
    }}


def _capture_kv_tier(cfg: PerfConfig, dev) -> dict[str, dict]:
    """The tiered-KV offload leg: the deterministic conversation trace
    (``serve/engine.py::session_trace``, no wall-clock arrivals, so the
    eviction/onload schedule is a pure function of the trace) served
    through the kv-tier patterns' pool with the host tier on.  Books the
    offload traffic itself (exact host-side accounting, ratcheted in the
    ``analytic`` class) plus the measured decode wall clock.  The pool
    evicts only where the trace's ``max(slots + 2, requests // 2)``
    conversations outgrow it: at the defaults (4 slots, 6 requests) it
    does, at 8 slots only from 22 requests on; the evictions are booked,
    so a capture that offloads nothing reads 0 there."""
    from tpu_patterns_torch.models.lm import init_lm_params
    from tpu_patterns_torch.serve.engine import (
        ServeConfig,
        ServeEngine,
        _kv_tier_pool,
        session_trace,
    )

    scfg = ServeConfig(
        vocab=cfg.vocab, embed=cfg.embed, heads=cfg.heads,
        head_dim=cfg.head_dim, mlp_mult=cfg.mlp_mult, depth=cfg.depth,
        dtype=cfg.dtype, rope=cfg.rope, kv_heads=cfg.kv_heads,
        cache_int8=cfg.cache_int8, slots=cfg.slots,
        block_len=cfg.block_len, requests=cfg.requests, gen=cfg.gen,
        seed=cfg.seed, device=str(dev),
    )
    trace, _gen = session_trace(scfg)
    mcfg = _mcfg(cfg)
    decoder = _kv_tier_pool(scfg, mcfg, dev)
    params = decoder.stack_params(
        init_lm_params(cfg.seed, mcfg, cfg.vocab, dev)
    )

    def run_once():
        eng = ServeEngine(decoder, params, slots=scfg.slots,
                          kv_host_tier=True)
        eng.run([dataclasses.replace(r) for r in trace])
        return eng

    reps, eng = _engine_reps(cfg, run_once)
    st = eng.stats
    return {"serve.kv_tier": {
        "kv_evict_bytes": float(st["evict_bytes"]),
        "kv_onload_bytes": float(st["onload_bytes"]),
        "kv_evictions": float(st["evictions"]),
        "kv_onload_hits": float(st["onload_hits"]),
        "step_ms": _median_ms(reps) if reps else -1.0,
    }}


def _capture_prefix_store(cfg: PerfConfig, dev) -> dict[str, dict]:
    """The fleet prefix store's round trip: a publisher engine serves the
    deterministic session trace with the store attached (every retained
    or evicted full block commits), then a cold fetcher engine serves the
    SAME trace against the warm store, its admission misses fetching
    instead of prefilling.  ``store_publish_bytes``,
    ``store_fetch_bytes`` and ``store_hits`` are exact host-side
    accounting at the fixed trace (the ``analytic`` class, so a republish
    or refetch storm fails ``perf diff``), beside the measured decode
    wall of the warm fetcher."""
    import shutil
    import tempfile

    from tpu_patterns_torch.models.lm import init_lm_params
    from tpu_patterns_torch.serve.engine import (
        ServeConfig,
        ServeEngine,
        _kv_tier_pool,
        session_trace,
    )

    scfg = ServeConfig(
        vocab=cfg.vocab, embed=cfg.embed, heads=cfg.heads,
        head_dim=cfg.head_dim, mlp_mult=cfg.mlp_mult, depth=cfg.depth,
        dtype=cfg.dtype, rope=cfg.rope, kv_heads=cfg.kv_heads,
        cache_int8=cfg.cache_int8, slots=cfg.slots,
        block_len=cfg.block_len, requests=cfg.requests, gen=cfg.gen,
        seed=cfg.seed, device=str(dev),
    )
    trace, _gen = session_trace(scfg)
    mcfg = _mcfg(cfg)
    decoder = _kv_tier_pool(scfg, mcfg, dev)
    params = decoder.stack_params(
        init_lm_params(cfg.seed, mcfg, cfg.vocab, dev)
    )
    store_dir = tempfile.mkdtemp(prefix="tpu_patterns_torch_perf_store_")
    try:
        pub = ServeEngine(decoder, params, slots=scfg.slots,
                          kv_host_tier=True, prefix_store=store_dir)
        pub.run([dataclasses.replace(r) for r in trace])

        def run_once():
            eng = ServeEngine(decoder, params, slots=scfg.slots,
                              kv_host_tier=True, prefix_store=store_dir)
            eng.run([dataclasses.replace(r) for r in trace])
            return eng

        reps, eng = _engine_reps(cfg, run_once)
        st = eng.stats
        return {"serve.prefix_store": {
            "store_publish_bytes": float(pub.stats["store_publish_bytes"]),
            "store_fetch_bytes": float(st["store_fetch_bytes"]),
            "store_hits": float(st["store_hits"]),
            "step_ms": _median_ms(reps) if reps else -1.0,
        }}
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


# -- the snapshot ----------------------------------------------------------


def _derive(metrics: dict[str, float], dtype: str, dev) -> None:
    """Roofline position in place: achieved rates from analytic counts
    over the measured step, MFU where the card's peak is known (looked
    up at the CAPTURE dtype).  On the card a rate past the datasheet
    raises: the accounting or the timing is wrong."""
    from tpu_patterns_torch.runtime import (
        SPEC_PLAUSIBILITY_MARGIN,
        chip_hbm_gbps,
        chip_peak_tflops,
    )

    ms = metrics.get("step_ms", 0.0)
    if ms <= 0:
        return
    s = ms / 1e3
    flops = metrics.get("analytic_flops", 0.0)
    byts = metrics.get("analytic_hbm_bytes", 0.0)
    if flops > 0:
        metrics["achieved_gflops"] = flops / s / 1e9
    if byts > 0:
        metrics["achieved_gbps"] = byts / s / 1e9
    if flops > 0 and byts > 0:
        metrics["intensity_flops_per_byte"] = flops / byts
    peak = chip_peak_tflops(dtype, dev)
    if peak is not None and flops > 0:
        metrics["mfu"] = (flops / s / 1e12) / peak
        if metrics["mfu"] > 1.0:
            raise RuntimeError(
                f"mfu {metrics['mfu']:.3f} > 1.0 against the {dtype} "
                f"peak {peak} TFLOP/s: an accounting or timing fault"
            )
    hbm = chip_hbm_gbps(dev)
    gbps = metrics.get("achieved_gbps")
    if hbm is not None and gbps is not None \
            and gbps > SPEC_PLAUSIBILITY_MARGIN * hbm:
        raise RuntimeError(
            f"achieved {gbps:.1f} GB/s > {SPEC_PLAUSIBILITY_MARGIN} x "
            f"{hbm} GB/s: an accounting or timing fault"
        )


def card_line(dev) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (the device
    name alone where nvidia-smi cannot be run); "" on the CPU."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return ""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out.splitlines()[0] if out else torch.cuda.get_device_name(idx)


_CAPTURES = (
    # (the names one capture fills, the function, its progress line)
    (("train.step",), _capture_train, "train.step"),
    (("zero.step",), _capture_zero, "zero.step (ZeRO-adam over dp=2)"),
    (("decoder.prefill", "decoder.step", "decoder.verify", "copy_blocks"),
     _capture_decoder, "decoder prefill/step/verify + copy_blocks"),
    (("decoder.step_pallas", "decoder.verify_pallas"),
     _capture_decoder_pallas, "K1 decoder step/verify"),
    (("disagg.stream",), _capture_disagg_stream,
     "disagg.stream (KV-block wire)"),
    (("serve.step",), _capture_serve, "serve.step (engine-driven trace)"),
    (("serve.kv_tier",), _capture_kv_tier,
     "serve.kv_tier (tiered-KV offload trace)"),
    (("serve.prefix_store",), _capture_prefix_store,
     "serve.prefix_store (publisher, then fetcher, on one store)"),
)


def capture(cfg: PerfConfig, writer=None) -> dict:
    """Run the registry on ``cfg.device`` and return one normalized
    snapshot."""
    from tpu_patterns_torch import obs
    from tpu_patterns_torch.perf.provenance import stamp_dict
    from tpu_patterns_torch.runtime import resolve_device

    names = _selected(cfg)
    dev = resolve_device(cfg.device)

    def say(msg: str) -> None:
        if writer is not None:
            writer.progress(msg)

    executables: dict[str, dict] = {}
    for fills, fn, what in _CAPTURES:
        if not set(fills) & set(names):
            continue
        say(f"perf capture: {what}")
        executables.update({n: m for n, m in fn(cfg, dev).items()
                            if n in names})

    for name, metrics in executables.items():
        _derive(metrics, cfg.dtype, dev)
        obs.gauge(
            "tpu_patterns_perf_step_ms", executable=name
        ).set(metrics.get("step_ms", -1.0))
        obs.gauge(
            "tpu_patterns_perf_analytic_flops", executable=name
        ).set(metrics.get("analytic_flops", 0.0))
        if "achieved_gflops" in metrics:
            obs.gauge(
                "tpu_patterns_perf_achieved_gflops", executable=name
            ).set(metrics["achieved_gflops"])
        if "achieved_gbps" in metrics:
            obs.gauge(
                "tpu_patterns_perf_achieved_gbps", executable=name
            ).set(metrics["achieved_gbps"])
    obs.counter("tpu_patterns_perf_captures_total").inc()

    mesh = {
        "shape": {"dp": 1, "sp": 1, "tp": 1},
        "devices": 1,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
    }
    card = card_line(dev)
    if card:
        mesh["card"] = card
    return {
        "run": stamp_dict(),
        "ts": wall_time_s(),
        "config": dataclasses.asdict(cfg),
        "mesh": mesh,
        "executables": executables,
    }
