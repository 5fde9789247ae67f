#!/usr/bin/env python3
"""Chip smoke of tpu_patterns_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of the
JAX package, and fails (nonzero exit, no result line) without a CUDA
device or away from the repository.  Phases, each one a printed line:

1. device and toolchain: torch/CUDA versions, ``nvcc --version``, and the
   card's name and power limit as ``nvidia-smi`` reports them;
2. build: every kernel compiled from the checkout's sources with nvcc;
3. kernel vs plain: the paged-attention kernel against its plain torch
   version on the card, for f32, bf16 and int8 pools, W=1 and W=4,
   G=1 and G=4, ragged pos0, TRASH pages, an inactive and an all-TRASH
   row, at a small shape and at the serve slice's shape; at the slice's
   shape the kernel's, the plain version's and one SDPA call's time
   (``scaled_dot_product_attention`` on the gathered window, a yardstick
   the package never calls) beside the device-memory bound;
4. serve at full width in bf16 (embed 1024, 8 heads x 128, depth 4,
   vocab 2048): 16 requests, prompts 64-512, 64 generated tokens, 8
   slots, block_len 16, attention through the kernel; continuous and
   sequential tokens/s, the kernel's launches during the timed
   continuous run (which must be depth x its decode steps), the pool
   against the dense rectangle and in place, peak device memory; ids
   against the dense oracle as a report (a flip only where the oracle's
   top-2 margin is below bf16 resolution); then the device's busy and
   idle share of the continuous run, from torch.profiler.  A second leg
   serves 8 requests with 2 K/V heads and an int8 pool;
5. exactness at full width in float32 with TF32 off: ``run_serve``'s
   Record, whose ids must equal the dense oracle's exactly;
6. the ``kernels`` line, then the device line, which is the last.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
BF16_RESOLUTION = 2.0**-7  # relative spacing of bfloat16 values
FULL_WIDTH = dict(
    vocab=2048, embed=1024, heads=8, head_dim=128, mlp_mult=4, depth=4,
    rope=True, slots=8, block_len=16, min_prompt=64, max_prompt=512,
    gen=64, device=DEVICE, paged_attn="kernel",
)


def emit(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                          check=True).stdout


# -- phase 3: the kernel against its plain version ---------------------------


def make_case(torch, *, kind, b, w, h, hkv, d, bl, n_pages, n_blocks,
              seed, q_bf16=False, lens=None):
    """Pool, q, tables, pos0 and active on the card.  ``lens`` (per-row
    prompt lengths) gives the serve path's tables: each row owns the
    blocks of its whole lifetime and sits at a position inside it; else
    random distinct tables with a TRASH tail page on row 0, an inactive
    row 1 and an all-TRASH row 2."""
    g = torch.Generator().manual_seed(seed)
    shape = (n_blocks, bl, hkv, d)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    if kind == "int8":
        pool = {
            "k": torch.randint(-127, 128, shape, generator=g).to(torch.int8),
            "v": torch.randint(-127, 128, shape, generator=g).to(torch.int8),
            "ks": torch.rand(shape[:3], generator=g) * 0.015 + 0.005,
            "vs": torch.rand(shape[:3], generator=g) * 0.015 + 0.005,
        }
        q_dt = torch.bfloat16 if q_bf16 else torch.float32
    else:
        pool = {n: torch.randn(shape, generator=g).to(dt[kind])
                for n in ("k", "v")}
        q_dt = dt[kind]
    q = torch.randn((b, w, h, d), generator=g).to(q_dt)
    perm = (1 + torch.randperm(n_blocks - 1, generator=g)).tolist()
    tables = torch.zeros((b, n_pages), dtype=torch.int32)
    active = torch.ones(b, dtype=torch.bool)
    if lens is not None:
        pos0 = torch.zeros(b, dtype=torch.int32)
        for i, n in enumerate(lens):
            need = -(-(n + 63) // bl)
            tables[i, :need] = torch.tensor(perm[:need], dtype=torch.int32)
            perm = perm[need:]
            # a decode position inside the lifetime: pos0 + w - 1 <= n + 62
            pos0[i] = n + int(torch.randint(0, 64 - w, (1,), generator=g))
    else:
        tables[:] = torch.tensor(perm[: b * n_pages]).reshape(b, n_pages)
        pos0 = torch.randint(0, n_pages * bl - w + 1, (b,), generator=g,
                             dtype=torch.int32)
        tables[0, -1] = 0
        active[1] = False
        tables[2] = 0
    return ({n: t.to(DEVICE) for n, t in pool.items()}, q.to(DEVICE),
            tables.to(DEVICE), pos0.to(DEVICE), active.to(DEVICE))


def kernel_bytes_and_ops(case, block_len):
    """Bytes the function must move (the K/V slots and scales that some
    query sees, q, tables and per-row ints in; o/m/l out) and its flops
    (q.k and p.v over the keys each query sees), for the bound.  Only
    visible keys count: slots of a live page past the row's last query
    position are masked and the output does not depend on them."""
    pool, q, tables, pos0, active = case
    b, w, h, d = q.shape
    hkv = pool["k"].shape[2]
    g = h // hkv
    first = tables.new_tensor(range(tables.shape[1]))[None, :] * block_len
    live = (tables != 0) & active[:, None]  # [B, n_pages]

    def visible_keys(last_pos):  # keys at positions <= last_pos, [B]
        n = (last_pos[:, None] + 1 - first).clamp(0, block_len)
        return (n * live).sum(dim=1)

    # bytes: keys seen by a row's last query; flops: each query's own
    n_bytes_keys = int(visible_keys(pos0 + w - 1).sum())
    n_op_keys = sum(int(visible_keys(pos0 + i).sum()) for i in range(w))
    slot = hkv * d * pool["k"].element_size() * 2
    if "ks" in pool:
        slot += hkv * 4 * 2
    nbytes = (
        n_bytes_keys * slot
        + q.numel() * q.element_size() + tables.numel() * 4 + b * 5
        + b * hkv * g * w * (d + 2) * 4
    )
    flops = n_op_keys * hkv * g * d * 4
    return nbytes, flops


def check_kernel(torch, pk, name, case, block_len, tol):
    """Launch the kernel and the plain version on one case; raise if
    they disagree or a dead row is not exactly zero."""
    pool, q, tables, pos0, active = case
    args = (q, pool["k"], pool["v"], tables, pos0, active)
    kw = dict(block_len=block_len, k_scale=pool.get("ks"),
              v_scale=pool.get("vs"))
    got = pk.paged_block(*args, **kw)
    want = pk.paged_block_reference(*args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for g, w_, what in zip(got, want, ("o", "m", "l")):
        if not torch.allclose(g, w_, rtol=tol, atol=tol):
            raise AssertionError(
                f"{name}: kernel {what} differs from the plain version by "
                f"{float((g - w_).abs().max())}"
            )
        err = max(err, float((g - w_).abs().max()))

    from tpu_patterns_torch.serve.paged import PagedLayout

    lay = PagedLayout(pool["k"].shape[0], block_len)
    out = pk.paged_attend(pool, q, tables, pos0, active, lay)
    dead = (~active) | (tables == 0).all(dim=1)
    if not torch.isfinite(out).all() or bool((out[dead] != 0).any()):
        raise AssertionError(f"{name}: a dead row is not exactly zero")
    return err


def phase_kernels(torch, pk, timing, spec):
    results = {"cases": 0, "max_abs_err": 0.0}
    tols = {"f32": 2e-5, "bf16": 1e-4, "int8": 1e-4}
    for kind in ("f32", "bf16", "int8"):
        for w in (1, 4):
            for g in (1, 4):
                name = f"small_{kind}_w{w}_g{g}"
                case = make_case(torch, kind=kind, b=4, w=w, h=4, hkv=4 // g,
                                 d=64, bl=8, n_pages=5, n_blocks=24,
                                 seed=len(name) * 7 + w + g)
                err = check_kernel(torch, pk, name, case, 8, tols[kind])
                results["cases"] += 1
                results["max_abs_err"] = max(results["max_abs_err"], err)
    # the serve slice's shape: 8 rows at their decode positions in
    # lifetimes of prompts 64-512 plus 64 generated tokens, block_len 16,
    # 36-page tables over a 217-block pool
    lens = [64, 512, 300, 128, 450, 77, 200, 389]
    n_blocks = 1 + sum(-(-(n + 63) // 16) for n in lens)
    slice_cases = {
        "slice_bf16_w1_g1": dict(kind="bf16", w=1, h=8, hkv=8),
        "slice_f32_w1_g1": dict(kind="f32", w=1, h=8, hkv=8),
        "slice_int8_w1_g4": dict(kind="int8", w=1, h=8, hkv=2, q_bf16=True),
        "slice_bf16_w4_g1": dict(kind="bf16", w=4, h=8, hkv=8),
    }
    cases = {}
    for name, kw in slice_cases.items():
        cases[name] = make_case(
            torch, b=8, d=128, bl=16, n_pages=36,
            n_blocks=max(n_blocks, 217), seed=17, lens=lens, **kw
        )
        err = check_kernel(torch, pk, name, cases[name], 16,
                           tols[kw["kind"]])
        results["cases"] += 1
        results["max_abs_err"] = max(results["max_abs_err"], err)
    emit({"phase": "kernel_vs_plain", **results})

    # time the main path's shape (bf16 pool, W=1, G=1), L2 flushed
    pool, q, tables, pos0, active = main = cases["slice_bf16_w1_g1"]
    args = (q, pool["k"], pool["v"], tables, pos0, active)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=DEVICE)
    kernel_ms = timing.cuda_time_ms(
        lambda: pk.paged_block(*args, block_len=16), before=flush.zero_
    )
    plain_ms = timing.cuda_time_ms(
        lambda: pk.paged_block_reference(*args, block_len=16),
        before=flush.zero_,
    )
    # the library yardstick: one SDPA call on the gathered window
    b, w, h, d = q.shape
    n_pages = tables.shape[1]
    kg = pool["k"][tables.long()].movedim(3, 1).reshape(b, h, n_pages * 16, d)
    vg = pool["v"][tables.long()].movedim(3, 1).reshape(b, h, n_pages * 16, d)
    k_pos = torch.arange(n_pages * 16, device=DEVICE)
    visible = ((k_pos[None, :] <= pos0[:, None])
               & (tables != 0).repeat_interleave(16, dim=1))
    mask = visible[:, None, None, :]
    qh = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = timing.cuda_time_ms(
        lambda: sdpa(qh, kg, vg, attn_mask=mask), before=flush.zero_
    )
    nbytes, flops = kernel_bytes_and_ops(main, 16)
    bytes_ms = nbytes / (spec["hbm_gbps"] * 1e9) * 1e3
    ops_ms = flops / (spec["f32_tflops"] * 1e12) * 1e3
    timed = {
        "phase": "kernel_time", "shape": "B8 W1 H8 Hkv8 D128 bl16 pages36 "
        "bf16, L2 flushed", "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bytes": nbytes, "flops": flops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    emit(timed)
    return results, timed


# -- phases 4 and 5: serving at full width ------------------------------------


def oracle_report(torch, mcfg, cfg, params, trace, got):
    """Per-request ids against the dense oracle; for each request that
    differs, the oracle's top-2 relative logit margin at the first
    differing step."""
    from tpu_patterns_torch.models.lm import make_lm_decoder

    pre, gen = make_lm_decoder(mcfg, cfg.vocab, 1, cfg.max_prompt, cfg.gen,
                               cache_int8=cfg.cache_int8)
    equal, flips = 0, []
    for r in trace:
        toks = torch.zeros((1, cfg.max_prompt), dtype=torch.int32)
        toks[0, : len(r.tokens)] = torch.tensor(r.tokens)
        lens = torch.tensor([len(r.tokens)], dtype=torch.int32)
        cache, t0, lg0 = pre(params, toks.to(DEVICE), lens, return_logits=True)
        _, ids, lgs = gen(params, cache, t0, (lens, 0), r.n_gen - 1,
                          return_logits=True)
        want = [int(t0[0])] + ids[0].tolist()
        if got[r.rid] == want:
            equal += 1
            continue
        k = next(i for i, (a, b_) in enumerate(zip(got[r.rid], want))
                 if a != b_)
        logits = torch.cat([lg0[:, None], lgs], dim=1)[0, k].float()
        top = logits.topk(2).values
        margin = float((top[0] - top[1]) / top[0].abs())
        flips.append({"rid": r.rid, "step": k, "rel_margin": margin,
                      "below_bf16_resolution": margin < BF16_RESOLUTION})
    return equal, flips


def serve_leg(torch, eng_mod, name, cfg, gate_flips=True):
    """Serve ``cfg`` continuous and sequential through the engine.  The
    launch count is that of the timed continuous run alone
    (``serve_legs`` sets the kernel's count to 0 just before that run
    and reads it just after) and must equal depth x its decode steps.
    With ``gate_flips`` an id flip against the oracle fails the leg
    unless the oracle's margin there is below bf16 resolution; without,
    flips are reported only (an int8 pool also quantizes keys that the
    two paths computed in bf16 through different matmul shapes)."""
    mcfg, decoder, params, trace = eng_mod.build_serve(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    legs = eng_mod.serve_legs(decoder, params, trace, cfg.slots)
    launches = legs.launches
    peak = torch.cuda.max_memory_allocated()
    steps = legs.engine.stats["steps"]
    total = sum(r.n_gen for r in trace)
    pool_mb, dense_mb = eng_mod.cache_mb(cfg, decoder)
    equal, flips = oracle_report(torch, mcfg, cfg, params, trace,
                                 legs.out_cont)
    row = {
        "phase": "serve", "leg": name, "dtype": cfg.dtype,
        "kv_heads": cfg.kv_heads, "cache_int8": cfg.cache_int8,
        "requests": len(trace),
        "tokens_per_s": total / legs.cont_s,
        "sequential_tokens_per_s": total / legs.seq_s,
        "speedup": legs.seq_s / legs.cont_s,
        "decode_steps": steps, "kernel_launches": launches,
        "depth_x_steps": cfg.depth * steps,
        "pool_MB": pool_mb, "dense_cache_MB": dense_mb,
        "pool_in_place": legs.in_place,
        "max_memory_allocated_MB": peak / 1e6,
        "continuous_equals_sequential": legs.out_cont == legs.out_seq,
        "oracle_equal": equal, "oracle_flips": flips,
    }
    emit(row)
    bad = []
    if not row["speedup"] > 1.0:
        bad.append("continuous batching not faster than sequential")
    if steps == 0 or launches != cfg.depth * steps:
        bad.append(f"kernel launched {launches} times in the timed run, "
                   f"not depth x steps = {cfg.depth * steps}")
    if not (legs.in_place and pool_mb < dense_mb):
        bad.append("pool not in place or not under the dense rectangle")
    if gate_flips and any(not f["below_bf16_resolution"] for f in flips):
        bad.append("an id flip against the oracle above bf16 resolution")
    if bad:
        raise AssertionError(f"serve leg {name}: " + "; ".join(bad))
    return row


def phase_profile(torch, eng_mod, timing, cfg, unprofiled_wall_s):
    """Device time of one continuous run of ``cfg``'s trace under
    torch.profiler: the device's busy and idle share against that same
    run's host wall (profiler overhead included), and the top kernels.
    ``unprofiled_wall_s`` (the timed serve run's wall, another run) is
    printed beside it with the idle share it would give."""
    from torch.profiler import ProfilerActivity, profile

    _, decoder, params, trace = eng_mod.build_serve(cfg)
    eng = eng_mod.ServeEngine(decoder, params, slots=cfg.slots)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = timing.clock_ns()
        eng.run([dataclasses.replace(r) for r in trace])
        torch.cuda.synchronize()
        wall_s = (timing.clock_ns() - t0) / 1e9

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies, memsets): a host op's own
    # device time repeats that of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    busy_s = sum(dev_us(e) for e in events) / 1e6
    if busy_s <= 0:
        raise AssertionError("the profile holds no device time")
    k1_s = sum(dev_us(e) for e in events
               if "paged_attention_kernel" in e.key) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:6]
    emit({
        "phase": "profile", "leg": cfg.dtype, "wall_s": wall_s,
        "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall_s,
        "unprofiled_wall_s": unprofiled_wall_s,
        "idle_share_vs_unprofiled_wall": 1 - busy_s / unprofiled_wall_s,
        "paged_attention_share_of_busy": k1_s / busy_s,
        "device_kernels": sum(e.count for e in events),
        "decode_steps": eng.stats["steps"],
        "top_device": [
            {"name": e.key[:60], "ms": dev_us(e) / 1e3, "calls": e.count}
            for e in top
        ],
    })


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tpu_patterns_torch.core import timing
    from tpu_patterns_torch.kernels import build
    from tpu_patterns_torch.runtime import match_device_spec
    from tpu_patterns_torch.serve import engine as eng_mod
    from tpu_patterns_torch.serve import paged_kernel as pk

    name = torch.cuda.get_device_name(0)
    spec = match_device_spec(name)
    if spec is None:
        raise RuntimeError(f"no datasheet entry for {name!r}")
    nvcc_line = next(
        (ln.strip() for ln in _run([build.find_nvcc(), "--version"])
         .splitlines() if "release" in ln), "?"
    )
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).strip().splitlines()[0]
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_line, "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    emit(smi)

    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = []
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln][:8]
    emit({"phase": "build", "seconds": build_s,
          "libs": {n: os.path.relpath(p, ROOT) for n, p in libs.items()},
          "ptxas": ptxas})

    kres, ktime = phase_kernels(torch, pk, timing, spec)

    base = eng_mod.ServeConfig(**FULL_WIDTH, dtype="bfloat16", requests=16)
    main_leg = serve_leg(torch, eng_mod, "bf16", base)
    phase_profile(torch, eng_mod, timing, base,
                  sum(r.n_gen for r in eng_mod.random_trace(base))
                  / main_leg["tokens_per_s"])
    serve_leg(torch, eng_mod, "gqa2_int8",
              dataclasses.replace(base, kv_heads=2, cache_int8=True,
                                  requests=8),
              gate_flips=False)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "exact_f32", "matmul.allow_tf32":
          torch.backends.cuda.matmul.allow_tf32,
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32})
    rec, = eng_mod.run_serve(
        dataclasses.replace(base, dtype="float32")
    )
    emit({"phase": "exact_f32", "verdict": rec.verdict.value,
          "metrics": rec.metrics, "notes": rec.notes})
    if rec.metrics["exact"] != 1.0 or not rec.verdict:
        raise AssertionError("float32 serve Record failed: "
                             + "; ".join(rec.notes))

    emit({"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "tpu_patterns_torch/serve/csrc/paged_attention.cu",
        "replaces": "tpu_patterns/serve/paged_kernel.py:93",
        "launches": main_leg["kernel_launches"],
        "max_abs_err": kres["max_abs_err"],
        "ms": ktime["kernel_ms"],
        "plain_ms": ktime["plain_ms"],
        "bound_ms": ktime["bound_ms"],
        "bound_by": ktime["bound_by"],
        "library_ms": ktime["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
