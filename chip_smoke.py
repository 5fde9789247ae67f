#!/usr/bin/env python3
"""Chip smoke of tpu_patterns_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of the
JAX package, and fails (nonzero exit, no result line) without a CUDA
device or away from the repository.  It drives the four ported paths:
the serve path (slice A), the flagship train step (slice B), the
one-device one-sided put (slice C) and the concurrency suite (slice D).
Phases, each one or more printed lines:

1. device and toolchain: torch/CUDA versions, ``nvcc --version``, and the
   card's name and power limit as ``nvidia-smi`` reports them;
2. build: every kernel compiled from the checkout's sources with nvcc,
   one process per source, all at once;
3. K1 vs plain: the paged-attention kernel against its plain torch
   version on the card, for f32, bf16 and int8 pools, W=1 and W=4,
   G=1 and G=4, ragged pos0, TRASH pages, an inactive and an all-TRASH
   row, at a small shape and at the serve slice's shape; at the slice's
   shape the kernel's, the plain version's and one SDPA call's time
   (``scaled_dot_product_attention`` on the gathered window, a yardstick
   the package never calls) beside the device-memory bound;
4. flash vs plain: K2 (``flash_attention``), K3 (``flash_block``) and
   K4 (``flash_block_bwd``: the dq and the dk/dv kernel) against their
   plain versions: causal and not, f32 and bf16, D 64 and 128, shard
   offsets (0,0,1), (16,32,1), (2,5,8), Lq != Lk, wholly masked rows,
   and the flagship's shape (32 folded heads x 4096 x 128, bf16,
   causal), where two runs must also agree bit for bit and the tile
   model must equal the kernels' own shared-memory sizes; then each
   flash kernel's time at that shape (L2 flushed) beside its plain
   version's, one SDPA call's (forward for K2/K3, its backward for K4)
   and its bound (bytes over 3.35 TB/s or visible-key flops over 989
   TFLOP/s), and the forward and backward at other tile pairs that fit;
5. serve at full width in bf16 (embed 1024, 8 heads x 128, depth 4,
   vocab 2048): 16 requests, prompts 64-512, 64 generated tokens, 8
   slots, block_len 16, attention through K1; continuous and sequential
   tokens/s, K1's launches during the timed continuous run (which must
   be depth x its decode steps), the pool against the dense rectangle
   and in place, peak device memory; ids against the dense oracle as a
   report (a flip only where the oracle's top-2 margin is below bf16
   resolution); then the device's busy and idle share of the continuous
   run, from torch.profiler.  A second leg serves 8 requests with 2 K/V
   heads and an int8 pool;
6. serve exactness at full width in float32 with TF32 off:
   ``run_serve``'s Record, whose ids must equal the dense oracle's;
7. the flagship train step at its full default width (bf16, batch 4,
   seq 4096, embed 1024, 8 heads x 128, causal, attention through the
   flash kernels): ``run_flagship``'s Record must read SUCCESS, and K3,
   dq and dk/dv each launch depth x its train steps times and K2 never;
   then the same config with dense attention for contrast; then one
   step under torch.profiler: device busy and idle share and each flash
   kernel's share of busy time;
8. flagship exactness at full width in float32 with TF32 off: one train
   step through the kernels against the same step through
   ``attention_reference`` (loss and every parameter's update), and one
   ``forward_shard`` under ``torch.no_grad``, which launches K2 once
   and matches the dense forward;
9. the one-sided put: the four put kernels K8a-K8d against their plain
   versions, bit for bit, on float32, bfloat16, int32 and int8 at edge
   shapes (0, 1, 2 and 97 rows, chunks above the row count, trailing
   dimensions of 100, 37 and 1001 elements, inputs one element into a
   buffer)
   and at the full 92,160 x 512 float32 buffer; each kernel's time there
   beside its plain version's, one ``copy_`` call's and its byte bound;
   then ``run_onesided`` at the reference's message size in auto mode
   (SUCCESS, checksum and plausibility gates, the launches of streamed,
   multi and inplace) and with ``kernel="mono"``, and the ``p2p`` CLI;
10. the concurrency suite: the busy-wait kernel K6 against its plain
    version bit for bit (rows 1, 3, 8, 9, 64 at 0-4000 trips), the
    copy-and-compute kernel K7 likewise in
    both modes ("C", "D2D", "C D2D", "D2D D2D C C"; copies of 128, 4224,
    4,194,304 and 33,554,432 elements, computes of 8 and 64 rows at 0, 3
    and 100 trips); S buffers checked to be managed memory;
    ``run_concurrency`` at the defaults (xla concurrent "C C" SUCCESS
    with K6 launched; xla serial "C C" and both serial modes held to at
    least 0.6 x the sum of their solos; "C H2D", "C S2D" and the
    dispatch modes on "M2D D2M" and "H2D D2H"; pallas "C D2D" in both
    modes with K7 launched; the balanced leg, 128 MiB copies against 400
    trips raised by auto-tune, dma_overlap SUCCESS), the xla concurrent
    and the pallas dma_overlap run again under torch.profiler, in a
    process of their own, for the device's idle share, and the
    ``concurrency`` CLI, default and
    balanced; then K6 at the default 8 x 128 and 40,000 trips and K7 at
    every pallas run's tuned commands, in both modes, bit for bit
    against their plain versions (the plain busy-waits of one tripcount
    run once, over their inputs stacked); K6's time at the
    defaults and K7's at the tuned commands of the run whose launches
    are reported, beside their bounds, K6's FMA chain floor, K7's
    copy-only launch beside one ``copy_`` and the host's time per K7
    launch; and the balanced shape's copy-only, compute-only and mixed
    launches queued with no host gaps, the device's own overlap;
11. the card's name and power limit again, the ``kernels`` line, then
    the device line, which is the last.
"""

from __future__ import annotations

import dataclasses
import io
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
# flash kernel vs plain: max |kernel - plain| over max |plain|
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# flagship exactness (f32, TF32 off): the loss, and each parameter's
# update p - p_new as max |kernel - dense| over max |dense|.  The two
# attention paths differ by ~3e-7 relative; where an MLP preactivation
# lies within that of zero, relu's gate flips between them and moves a
# few elements of w1's update by up to ~1e-3 of its max, so the update
# gate is 1e-2 (a wrong kernel is off by O(1)).
FLAGSHIP_LOSS_RTOL = 1e-4
FLAGSHIP_UPDATE_TOL = 1e-2
FLASH_KERNELS = {  # LAUNCHES key -> (source, the Pallas body it replaces)
    "flash_attention": ("tpu_patterns_torch/longctx/csrc/flash_attention.cu",
                        "tpu_patterns/longctx/flash.py:135"),
    "flash_block": ("tpu_patterns_torch/longctx/csrc/flash_attention.cu",
                    "tpu_patterns/longctx/flash.py:591"),
    "flash_block_bwd_dq": (
        "tpu_patterns_torch/longctx/csrc/flash_attention_bwd.cu",
        "tpu_patterns/longctx/flash.py:255"),
    "flash_block_bwd_dkv": (
        "tpu_patterns_torch/longctx/csrc/flash_attention_bwd.cu",
        "tpu_patterns/longctx/flash.py:279"),
}


PUT_SOURCE = "tpu_patterns_torch/comm/csrc/local_put.cu"
PUT_KERNELS = {  # wrapper -> the Pallas body it replaces
    "local_put": "tpu_patterns/comm/onesided.py:88",
    "local_put_streamed": "tpu_patterns/comm/onesided.py:108",
    "local_put_multi": "tpu_patterns/comm/onesided.py:229",
    "local_put_inplace": "tpu_patterns/comm/onesided.py:175",
}
PUT_FULL = (92160, 512)  # the reference's message size as rows x cols


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


# -- phase 4: the flash kernels against their plain versions ----------------


def _rel(got, want, rows=None):
    """(max |got - want| / max |want|, max |got - want|), over the [H, L]
    statistics' ``rows`` (a mask) when given."""
    g, w = got.float(), want.float()
    if rows is not None:
        g, w = g[rows], w[rows]
    diff = float((g - w).abs().max()) if w.numel() else 0.0
    top = float(w.abs().max()) if w.numel() else 0.0
    return diff / max(top, 1e-30), diff


def flash_case(torch, F, name, *, lq, lk, h, d, dtype, causal, q_off=0,
               k_off=0, stride=1, bq=1024, bk=1024, seed=0):
    """K3, K2 (zero offsets only) and K4 against their plain versions on
    one case; raise past FLASH_TOL or where a wholly masked row is not
    exactly zero.  Returns {kernel: (rel, abs)} and the inputs."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((lq, h, d), generator=g).to(DEVICE, dt)
    k, v = (torch.randn((lk, h, d), generator=g).to(DEVICE, dt)
            for _ in range(2))
    do = torch.randn((lq, h, d), generator=g).to(DEVICE, dt)
    kw = dict(causal=causal, block_q=bq, block_k=bk, pos_stride=stride)
    o, m, l = F.flash_block(q, k, v, q_off, k_off, **kw)
    ro, rm, rl = F.flash_block_reference(q, k, v, q_off, k_off, causal,
                                         None, stride)
    live = rl > 0  # [H, Lq] rows that see a key
    errs = {"flash_block": max(_rel(o, ro), _rel(m, rm, live), _rel(l, rl))}
    dead = ~live.T  # [Lq, H]
    dead_ok = bool((o[dead] == 0).all() and (l[~live] == 0).all()
                   and (m[~live] == F.NEG_INF).all())
    if (q_off, k_off, stride) == (0, 0, 1):
        out = F.flash_attention(q, k, v, causal=causal, block_q=bq,
                                block_k=bk)
        errs["flash_attention"] = _rel(
            out, F.flash_attention_reference(q, k, v, causal))
        dead_ok &= bool((out[dead] == 0).all())
    out_ref, lse = F._row_stats(ro, rm, rl)
    delta = F._delta(do, out_ref.to(dt))
    got = F.flash_block_bwd(q, k, v, do, lse, delta, q_off, k_off, **kw)
    want = F.flash_block_bwd_reference(q, k, v, do, lse, delta, q_off,
                                       k_off, causal, None, stride)
    errs["flash_block_bwd_dq"] = _rel(got[0], want[0])
    errs["flash_block_bwd_dkv"] = max(_rel(got[1], want[1]),
                                      _rel(got[2], want[2]))
    dead_ok &= bool((got[0][dead] == 0).all())
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    bad = [n for n, (r, _) in errs.items() if not r <= tol]
    if bad or not dead_ok:
        raise AssertionError(
            f"flash case {name}: {bad} past {tol} relative "
            f"({ {n: errs[n][0] for n in bad} }); wholly masked rows "
            f"exactly zero: {dead_ok}"
        )
    return errs, (q, k, v, do, lse, delta)


def phase_flash_kernels(torch, F, tuning):
    """Every case of phase 4; returns per-kernel max abs error and the
    flagship-shape inputs."""
    cases = []
    for dtype in ("float32", "bfloat16"):
        for d in (64, 128):
            for causal in (False, True):
                cases.append((f"{dtype}_d{d}_{'causal' if causal else 'full'}",
                              dict(lq=256, lk=256, h=4, d=d, dtype=dtype,
                                   causal=causal, bq=64, bk=32)))
        for causal in (False, True):
            for off in ((0, 0, 1), (16, 32, 1), (2, 5, 8)):
                cases.append((f"{dtype}_off{off}_{causal}",
                              dict(lq=64, lk=64, h=8, d=64, dtype=dtype,
                                   causal=causal, q_off=off[0],
                                   k_off=off[1], stride=off[2], bq=16,
                                   bk=16)))
        cases.append((f"{dtype}_lq64_lk192", dict(
            lq=64, lk=192, h=4, d=128, dtype=dtype, causal=False, bq=32,
            bk=64)))
        # rows 0-39 see no key: k_off 40 puts every key after them
        cases.append((f"{dtype}_masked_rows", dict(
            lq=64, lk=64, h=4, d=64, dtype=dtype, causal=True, k_off=40,
            bq=16, bk=16)))
    err = {n: 0.0 for n in FLASH_KERNELS}
    worst = {n: 0.0 for n in FLASH_KERNELS}
    by_dtype = {"float32": 0.0, "bfloat16": 0.0}
    for i, (name, kw) in enumerate(cases):
        errs, _ = flash_case(torch, F, name, seed=i, **kw)
        for n, (r, a) in errs.items():
            err[n] = max(err[n], a)
            worst[n] = max(worst[n], r)
            by_dtype[kw["dtype"]] = max(by_dtype[kw["dtype"]], r)
    # the flagship's shape: batch 4 x 8 heads folded, seq 4096, D 128
    flag = dict(lq=4096, lk=4096, h=32, d=128, dtype="bfloat16",
                causal=True)
    errs, inputs = flash_case(torch, F, "flagship", seed=99, **flag)
    for n, (r, a) in errs.items():
        err[n] = max(err[n], a)
        worst[n] = max(worst[n], r)
    q, k, v, do, lse, delta = inputs
    # no atomics: a second run gives the same bits
    again = (F.flash_block(q, k, v, 0, 0, causal=True),
             F.flash_block_bwd(q, k, v, do, lse, delta, causal=True,
                               block_q=1024, block_k=1024))
    first = (F.flash_block(q, k, v, 0, 0, causal=True),
             F.flash_block_bwd(q, k, v, do, lse, delta, causal=True,
                               block_q=1024, block_k=1024))
    bitwise = all(torch.equal(a, b) for x, y in zip(again, first)
                  for a, b in zip(x, y))
    # the shared-memory model in Python is the kernels' own
    fwd_t = F._blocks(q, k, ("fwd",), 1024, 1024)
    bwd_t = F._blocks(q, k, ("dq", "dkv"), 1024, 1024)
    lib_f, lib_b = F._library("flash_attention"), F._library(
        "flash_attention_bwd")
    model = {
        "fwd": (tuning.smem_bytes("fwd", *fwd_t, 128, 2),
                lib_f.flash_fwd_smem_bytes(2, *fwd_t, 128)),
        "dq": (tuning.smem_bytes("dq", *bwd_t, 128, 2),
               lib_b.flash_bwd_smem_bytes(0, 2, *bwd_t, 128)),
        "dkv": (tuning.smem_bytes("dkv", *bwd_t, 128, 2),
                lib_b.flash_bwd_smem_bytes(1, 2, *bwd_t, 128)),
    }
    emit({"phase": "flash_vs_plain", "cases": len(cases) + 1,
          "tolerance_rel": FLASH_TOL, "max_rel_err": worst,
          "max_rel_err_by_dtype": by_dtype,
          "max_abs_err": err, "flagship_rel_err": {
              n: r for n, (r, _) in errs.items()},
          "flagship_bitwise_repeat": bitwise, "tiles_fwd": fwd_t,
          "tiles_bwd": bwd_t, "smem_model_vs_kernel": model})
    if not bitwise:
        raise AssertionError("flash kernels: two runs differ in bits")
    if any(a != b for a, b in model.values()):
        raise AssertionError(f"shared-memory model differs: {model}")
    return err, inputs, fwd_t, bwd_t


def phase_flash_time(torch, F, timing, spec, inputs, fwd_t, bwd_t):
    """Each flash kernel at the flagship shape, L2 flushed before every
    launch: kernel, plain and SDPA ms, and the bound."""
    q, k, v, do, lse, delta = inputs
    lq, h, d = q.shape
    flush = torch.empty(64 << 20, dtype=torch.int32, device=DEVICE)

    def t(fn):
        return timing.cuda_time_ms(fn, reps=10, before=flush.zero_)

    kern = {
        "flash_block": t(lambda: F._launch_fwd(
            q, k, v, 0, 0, True, d**-0.5, *fwd_t, 1, emit_stats=True)),
        "flash_attention": t(lambda: F._launch_fwd(
            q, k, v, 0, 0, True, d**-0.5, *fwd_t, 1, emit_stats=False)),
    }
    for name in ("dq", "dkv"):
        kern[f"flash_block_bwd_{name}"] = t(lambda name=name: F._launch_bwd(
            q, k, v, do, lse, delta, 0, 0, True, d**-0.5, *bwd_t, 1,
            kernels=(name,)))
    plain_fwd = t(lambda: F.flash_block_reference(q, k, v, 0, 0, True))
    plain = {
        "flash_block": plain_fwd,
        "flash_attention": t(lambda: F.flash_attention_reference(
            q, k, v, True)),
    }
    plain_bwd = t(lambda: F.flash_block_bwd_reference(
        q, k, v, do, lse, delta, 0, 0, True))
    # the library yardstick on the same inputs, [1, BH, L, D] views
    sdpa = torch.nn.functional.scaled_dot_product_attention
    views = [a.transpose(0, 1)[None] for a in (q, k, v)]
    lib_fwd = t(lambda: sdpa(*views, is_causal=True))
    qh, kh, vh = (a.detach().requires_grad_(True) for a in views)
    out = sdpa(qh, kh, vh, is_causal=True)
    doh = do.transpose(0, 1)[None]
    lib_bwd = t(lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                            retain_graph=True))
    # bound: visible (query, key) pairs of the causal square
    pairs = h * lq * (lq + 1) // 2
    io = q.numel() * q.element_size()  # one [L, BH, D] bf16 tensor
    stats = h * lq * 4
    work = {  # kernel -> (bytes in + out, flops)
        "flash_block": (3 * io + 2 * io + 2 * stats, 2 * 2 * d * pairs),
        "flash_attention": (4 * io, 2 * 2 * d * pairs),
        "flash_block_bwd_dq": (4 * io + 2 * stats + 2 * io,
                               3 * 2 * d * pairs),
        "flash_block_bwd_dkv": (4 * io + 2 * stats + 4 * io,
                                4 * 2 * d * pairs),
    }
    rows = {}
    for name, (nbytes, flops) in work.items():
        bytes_ms = nbytes / (spec["hbm_gbps"] * 1e9) * 1e3
        ops_ms = flops / (spec["bf16_tflops"] * 1e12) * 1e3
        bwd = name.startswith("flash_block_bwd")
        rows[name] = {
            "ms": kern[name],
            "plain_ms": plain_bwd if bwd else plain[name],
            "library_ms": lib_bwd if bwd else lib_fwd,
            "bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
    # other tile pairs that fit, for the tuning of a later change
    sweep = {"fwd": {}, "bwd": {}}
    for tiles in ((64, 128), (128, 64), (64, 64), (32, 64), (32, 32)):
        sweep["fwd"][str(tiles)] = t(lambda tiles=tiles: F._launch_fwd(
            q, k, v, 0, 0, True, d**-0.5, *tiles, 1, emit_stats=True))
    for tiles in ((64, 64), (32, 64), (64, 32), (32, 32)):
        sweep["bwd"][str(tiles)] = t(lambda tiles=tiles: F._launch_bwd(
            q, k, v, do, lse, delta, 0, 0, True, d**-0.5, *tiles, 1))
    emit({"phase": "flash_tiles", "ms_by_tile": sweep,
          "chosen": {"fwd": fwd_t, "bwd": bwd_t}})
    emit({"phase": "flash_time", "shape": f"BH{h} L{lq} D{d} bf16 causal, "
          "L2 flushed", "tiles_fwd": fwd_t, "tiles_bwd": bwd_t,
          "k4_ms": kern["flash_block_bwd_dq"] + kern["flash_block_bwd_dkv"],
          "note": "K4 plain_ms and library_ms cover dq, dk and dv together",
          **{n: r for n, r in rows.items()}})
    return rows


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


# -- phases 7 and 8: the flagship train step ---------------------------------


def phase_flagship(torch, F, fl):
    """``run_flagship`` at its full default width through the kernels,
    with the flash launch counts of that run, then with dense attention.
    Returns the kernel run's row (launches by kernel)."""
    rows = {}
    for attn in ("kernel", "dense"):
        cfg = fl.FlagshipConfig(attn=attn, device=DEVICE)
        F.reset_launches()
        rec, = fl.run_flagship(cfg)
        torch.cuda.synchronize()
        launches = dict(F.LAUNCHES)
        steps = rec.config["train_steps"]
        row = {"phase": "flagship", "attn": attn,
               "verdict": rec.verdict.value, "train_steps": steps,
               "launches": launches, **rec.metrics, "config": rec.config,
               "notes": rec.notes}
        emit(row)
        want = ({"flash_attention": 0, "flash_block": cfg.depth * steps,
                 "flash_block_bwd_dq": cfg.depth * steps,
                 "flash_block_bwd_dkv": cfg.depth * steps}
                if attn == "kernel" else dict.fromkeys(launches, 0))
        if not rec.verdict or launches != want:
            raise AssertionError(
                f"flagship {attn}: verdict {rec.verdict.value} "
                f"({rec.notes}); launches {launches}, want {want}"
            )
        rows[attn] = row
    return rows


def _flagship_model(fl, tr, **kw):
    """The flagship's default width as a ModelConfig, and its x shape."""
    d = fl.FlagshipConfig()
    cfg = tr.ModelConfig(embed=d.embed, heads=d.heads, head_dim=d.head_dim,
                         mlp_mult=d.mlp_mult, causal=d.causal,
                         block_q=d.block_q, block_k=d.block_k, **kw)
    return cfg, (d.batch, d.seq, d.embed)


def phase_flagship_profile(torch, timing, fl, tr, unprofiled_step_s):
    """One full-width bf16 flagship step under torch.profiler: device
    busy time and idle share against that step's own wall (profiler
    overhead included), and each flash kernel's share of busy time.
    ``unprofiled_step_s`` (``run_flagship``'s step time, another run) is
    printed beside it with the idle share it would give."""
    from torch.profiler import ProfilerActivity, profile

    cfg, shape = _flagship_model(fl, tr, dtype="bfloat16", attn="kernel")
    params = tr.init_params(torch.Generator().manual_seed(0), cfg, DEVICE)
    x = torch.randn(shape, device=DEVICE, dtype=torch.bfloat16)
    step = tr.make_train_step(cfg, lr=1e-30)
    step(params, x)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = timing.clock_ns()
        step(params, x)
        torch.cuda.synchronize()
        wall_s = (timing.clock_ns() - t0) / 1e9

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    busy_s = sum(dev_us(e) for e in events) / 1e6
    if busy_s <= 0:
        raise AssertionError("the flagship profile holds no device time")
    share = {}
    for key in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                "flash_bwd_dkv_kernel"):
        share[key] = sum(dev_us(e) for e in events if key in e.key) / 1e6 \
            / busy_s
    top = sorted(events, key=dev_us, reverse=True)[:8]
    emit({"phase": "flagship_profile", "wall_s": wall_s,
          "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall_s,
          "unprofiled_step_s": unprofiled_step_s,
          "idle_share_vs_unprofiled_step": 1 - busy_s / unprofiled_step_s,
          "share_of_busy": share, "flash_share_of_busy": sum(share.values()),
          "device_kernels": sum(e.count for e in events),
          "top_device": [{"name": e.key[:60], "ms": dev_us(e) / 1e3,
                          "calls": e.count} for e in top]})


def phase_flagship_exact(torch, F, fl, tr):
    """Float32, TF32 off, full width: one train step through the kernels
    against the same step through attention_reference; then one forward
    without a gradient, which runs K2."""
    cfgs = {}
    for a in ("kernel", "dense"):
        cfgs[a], shape = _flagship_model(fl, tr, dtype="float32", attn=a)
    params = tr.init_params(torch.Generator().manual_seed(0),
                            cfgs["dense"], DEVICE)
    x = torch.randn(shape,
                    generator=torch.Generator().manual_seed(1)).to(DEVICE)
    out = {a: tr.make_train_step(c, lr=1e-2)(params, x)
           for a, c in cfgs.items()}
    loss_k, loss_d = float(out["kernel"][1]), float(out["dense"][1])
    upd_err, upd_norm_err = {}, {}
    for name, p in params.items():
        dk = p - out["kernel"][0][name]
        dd = p - out["dense"][0][name]
        upd_err[name] = float((dk - dd).abs().max() / dd.abs().max())
        upd_norm_err[name] = float((dk - dd).norm() / dd.norm())
    layer = {k: p[0] for k, p in params.items()}
    F.reset_launches()
    with torch.no_grad():
        yk = tr.forward_shard(layer, x, cfgs["kernel"])
        launches = dict(F.LAUNCHES)
        yd = tr.forward_shard(layer, x, cfgs["dense"])
    fwd_err = float((yk - yd).abs().max() / yd.abs().max())
    row = {"phase": "flagship_exact_f32",
           "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "loss_kernel": loss_k, "loss_dense": loss_d,
           "loss_rel_err": abs(loss_k - loss_d) / abs(loss_d),
           "update_rel_err": upd_err, "update_norm_rel_err": upd_norm_err,
           "no_grad_forward_rel_err": fwd_err,
           "no_grad_launches": launches,
           "tolerance": {"loss_rtol": FLAGSHIP_LOSS_RTOL,
                         "update": FLAGSHIP_UPDATE_TOL,
                         "forward": FLASH_TOL["float32"]}}
    emit(row)
    bad = []
    if not row["loss_rel_err"] <= FLAGSHIP_LOSS_RTOL:
        bad.append("loss")
    bad += [n for n, e in upd_err.items() if not e <= FLAGSHIP_UPDATE_TOL]
    if not fwd_err <= FLASH_TOL["float32"]:
        bad.append("no-grad forward")
    if launches != {"flash_attention": 1, "flash_block": 0,
                    "flash_block_bwd_dq": 0, "flash_block_bwd_dkv": 0}:
        bad.append(f"no-grad launches {launches}")
    if bad:
        raise AssertionError(f"flagship f32 exactness: {bad}")
    return launches


# -- phase 9: the one-sided put ----------------------------------------------


def _put_input(torch, shape, dtype, seed, offset=0):
    """Random bits of ``dtype`` on the card; with ``offset``, a view that
    starts ``offset`` elements into a larger buffer (contiguous, but not
    16-byte aligned)."""
    g = torch.Generator().manual_seed(seed)
    n = int(torch.Size(shape).numel())
    raw = torch.randint(-100, 100, (n + offset,), generator=g)
    return raw.to(dtype).to(DEVICE)[offset:].view(shape)


def phase_put_vs_plain(torch, op):
    """Every put kernel against its plain version, bit for bit."""
    lib = op._library()
    if lib.local_put_stage_bytes() != op.STAGE_BYTES:
        raise AssertionError("local_put.cu STAGE_BYTES differs from "
                             "onesided.STAGE_BYTES")
    cases = 0

    def same(name, got, want):
        nonlocal cases
        cases += 1
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"put kernel differs from its plain "
                                 f"version: {name}")

    def all_puts(tag, x):
        same(f"{tag} mono", op.local_put(x), op.local_put_reference(x))
        for br in (1, 4, 1024):
            same(f"{tag} streamed br{br}", op.local_put_streamed(x, br),
                 op.local_put_reference(x))
        for c in (1, 3, 8, 200):
            same(f"{tag} multi c{c}", op.local_put_multi(x, c),
                 op.local_put_reference(x))
            same(f"{tag} inplace c{c}", op.local_put_inplace(x.clone(), c),
                 op.local_put_inplace_reference(x.clone(), c))

    dtypes = (torch.float32, torch.bfloat16, torch.int32, torch.int8)
    # (300, 1001): segments of several stages with unaligned tails, and
    # streamed tiles at unaligned offsets (16-byte heads)
    shapes = ((0, 512), (1, 512), (2, 512), (97, 512), (16, 100), (97, 37),
              (300, 1001))
    for i, dt in enumerate(dtypes):
        for j, shape in enumerate(shapes):
            all_puts(f"{dt} {shape}", _put_input(torch, shape, dt, 10 * i + j))
        # one element in: a source not 16-byte aligned; (97, 37) copies
        # bytewise, (400, 512) in place keeps bulk copies behind a head
        for shape in ((97, 37), (400, 512)):
            all_puts(f"{dt} {shape} at offset 1",
                     _put_input(torch, shape, dt, 99, offset=1))
    full = _put_input(torch, PUT_FULL, torch.float32, 7)
    same("full mono", op.local_put(full), full)
    same("full streamed", op.local_put_streamed(full, 1024), full)
    same("full multi", op.local_put_multi(full, 8), full)
    same("full inplace", op.local_put_inplace(full.clone(), 8),
         op.local_put_inplace_reference(full.clone(), 8))
    torch.cuda.synchronize()
    emit({"phase": "put_vs_plain", "cases": cases, "bit_exact": True,
          "dtypes": [str(d) for d in dtypes], "shapes": [*shapes, PUT_FULL],
          "stage_bytes": op.STAGE_BYTES})
    return cases


def phase_put_time(torch, op, timing, spec):
    """Each put kernel at the full buffer (188.7 MB float32, 3.8x the L2,
    so no flush): kernel, plain and one ``copy_`` call's ms, and the byte
    bound (each byte moved read once and written once)."""
    x = _put_input(torch, PUT_FULL, torch.float32, 7)
    nbytes = x.numel() * x.element_size()
    n_chunks, chunk_rows, half = op._inplace_plan(PUT_FULL[0], 8)
    moved = {"local_put": nbytes, "local_put_streamed": nbytes,
             "local_put_multi": nbytes,
             "local_put_inplace": n_chunks * half * PUT_FULL[1] * 4}
    buf = x.clone()
    out = torch.empty_like(x)
    view = buf.view(n_chunks, chunk_rows, PUT_FULL[1])

    def t(fn):
        return timing.cuda_time_ms(fn, reps=10, warmup=2)

    kern = {
        "local_put": t(lambda: op.local_put(x)),
        "local_put_streamed": t(lambda: op.local_put_streamed(x, 1024)),
        "local_put_multi": t(lambda: op.local_put_multi(x, 8)),
        "local_put_inplace": t(lambda: op.local_put_inplace(buf, 8)),
    }
    plain_copy = t(lambda: op.local_put_reference(x))
    plain = {"local_put_inplace": t(
        lambda: op.local_put_inplace_reference(buf, 8))}
    lib_copy = t(lambda: out.copy_(x))
    library = {"local_put_inplace": t(
        lambda: view[:, chunk_rows - half:].copy_(view[:, :half]))}
    rows = {}
    for name in PUT_KERNELS:
        bound = 2 * moved[name] / (spec["hbm_gbps"] * 1e9) * 1e3
        rows[name] = {
            "ms": kern[name], "gbps": moved[name] / kern[name] / 1e6,
            "plain_ms": plain.get(name, plain_copy),
            "library_ms": library.get(name, lib_copy),
            "bytes_moved": moved[name], "bound_ms": bound,
            "bound_by": "bytes",
        }
    emit({"phase": "put_time", "shape": f"{PUT_FULL[0]}x{PUT_FULL[1]} "
          "float32, chunks 8, block_rows 1024 (clamped to "
          f"{op.streamed_block_rows(PUT_FULL[0], PUT_FULL[1] * 4, 1024)})",
          "library": "out.copy_(x); inplace: one strided copy_ of the "
          "chunk halves", **rows})
    return rows


def phase_onesided(torch, op):
    """``run_onesided`` at the reference's message size: auto mode, then
    mono; each with the put launch counts set to 0 just before and read
    just after; then the ``p2p`` CLI in a process of its own."""
    recs = {}
    for kernel in ("auto", "mono"):
        op.reset_launches()
        rec, = op.run_onesided(op.OneSidedConfig(kernel=kernel),
                               device=DEVICE)
        torch.cuda.synchronize()
        launches = op.launch_counts()
        row = {"phase": "onesided", "kernel": kernel,
               "verdict": rec.verdict.value, "commands": rec.commands,
               "selected": rec.config["kernel"],
               "bandwidth_GBps": rec.metrics["bandwidth_GBps"],
               "launches": launches, "metrics": rec.metrics,
               "notes": rec.notes}
        emit(row)
        need = (("local_put_streamed", "local_put_multi",
                 "local_put_inplace") if kernel == "auto" else ("local_put",))
        keys = ([f"bandwidth_GBps_{k}" for k in
                 ("streamed", "multi", "xla", "inplace")]
                if kernel == "auto" else ["bandwidth_GBps_mono"])
        bad = []
        if not rec.verdict or rec.metrics.get("checksum_ok") != 1.0 \
                or rec.metrics.get("hbm_plausible") != 1.0:
            bad.append("verdict, checksum_ok or hbm_plausible")
        bad += [k for k in keys if k not in rec.metrics]
        bad += [f"{k} never launched" for k in need if not launches[k] > 0]
        bad += [n for n in rec.notes if "failed" in n]
        if bad:
            raise AssertionError(f"run_onesided {kernel}: {bad}; {rec.notes}")
        recs[kernel] = row
    r = subprocess.run(
        [sys.executable, "-m", "tpu_patterns_torch", "p2p", "--transport",
         "one_sided", "--device", "cuda"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    emit({"phase": "p2p_cli", "rc": r.returncode,
          "stdout_tail": r.stdout.splitlines()[-3:]})
    if r.returncode != 0:
        raise AssertionError(f"p2p CLI exited {r.returncode}: {r.stderr}")
    return recs


# -- phase 10: the concurrency suite -------------------------------------------


CONC_KERNELS = {  # wrapper -> (source, the Pallas body it replaces)
    "busy_wait": ("tpu_patterns_torch/concurrency/csrc/busy_wait.cu",
                  "tpu_patterns/concurrency/kernels.py:49"),
    "dma_compute": ("tpu_patterns_torch/concurrency/csrc/dma_compute.cu",
                    "tpu_patterns/concurrency/backends.py:248"),
}
# cycles from one dependent f32 FMA to the next on this card (the FMA
# pipeline's latency): the chain floor of a busy-wait element is
# 64 x tripcount of them at the SM clock
FMA_LATENCY_CYCLES = 4
# a serial mode's group time must be at least this share of the sum of
# its commands' solo times, or the serial ordering was lost (the
# reference's own guard, tests/test_concurrency.py:177-215)
SERIAL_GUARD = 0.6
BALANCED = dict(copy_elements=1 << 25, tripcount=400)
CONC_KEYS = {"speedup", "theoretical_speedup", "serial_total_us", "mode_us",
             "bytes_per_iter", "timing_converged"}


def _conc_input(torch, rows, seed):
    """The suite's buffer (``default_rng(seed).random((rows, 128))`` in
    float32, as ``commands.alloc`` makes it) on the card."""
    import numpy as np

    a = np.random.default_rng(seed).random((rows, 128), dtype=np.float32)
    return torch.from_numpy(a).to(DEVICE)


def _same(torch, name, got, want):
    if len(got) != len(want) or any(
            g.shape != w.shape or not torch.equal(g, w)
            for g, w in zip(got, want)):
        raise AssertionError(f"{name}: kernel differs from its plain version")


def phase_busy_wait_vs_plain(torch, ck):
    """K6 against its plain version, bit for bit: rows 1, 3, 8, 9 and 64
    at tripcounts 0, 1, 3, 100 and 4000 (the plain version is
    elementwise, so one plain run over the rows stacked serves every row
    count of a tripcount).  The default 8 x 128 at 40,000 trips is held
    in :func:`phase_main_path_vs_plain`."""
    rows = (1, 3, 8, 9, 64)
    xs = [_conc_input(torch, r, 100 + r) for r in rows]
    stacked = torch.cat(xs)
    cases = 0
    for trips in (0, 1, 3, 100, 4000):
        want = ck.busy_wait_plain(stacked, trips).split(rows)
        _same(torch, f"busy_wait trips {trips}",
              [ck.busy_wait(x, trips) for x in xs], want)
        cases += len(rows)
    torch.cuda.synchronize()
    emit({"phase": "busy_wait_vs_plain", "cases": cases, "bit_exact": True,
          "rows": rows, "tripcounts": [0, 1, 3, 100, 4000]})
    return cases


def phase_dma_compute_vs_plain(torch, cb):
    """K7 against its plain version, bit for bit, in both modes, for the
    groups "C", "D2D", "C D2D" and "D2D D2D C C": copies of 128, 4224,
    4,194,304 and 33,554,432 elements (the auto-tune cap), computes of
    8 x 128 and 64 x 128 at tripcounts 0, 3 and 100."""
    lib = cb._dma_library()
    if (lib.dma_compute_max_copies(), lib.dma_compute_max_computes()) != (
            cb.MAX_COPIES, cb.MAX_COMPUTES):
        raise AssertionError("dma_compute.cu limits differ from backends.py")
    copy_sizes = (128, 4224, 1 << 22, 1 << 25)
    cases = 0
    for group in ("C", "D2D", "C D2D", "D2D D2D C C"):
        n_copy, n_comp = group.count("D2D"), group.split().count("C")
        for copy_n in (copy_sizes if n_copy else (None,)):
            copies = [_conc_input(torch, copy_n // 128, 10 + i)
                      for i in range(n_copy)]
            for comp_rows in ((8, 64) if n_comp else (None,)):
                comps = [_conc_input(torch, comp_rows, 20 + i)
                         for i in range(n_comp)]
                for trips in ((0, 3, 100) if n_comp else (0,)):
                    tr = [trips] * n_comp
                    want = cb.dma_compute_plain(copies, comps, tr)
                    for overlap in (False, True):
                        _same(torch, f"dma_compute {group!r} copy {copy_n} "
                              f"comp {comp_rows}x128 trips {trips} "
                              f"overlap {overlap}",
                              cb.dma_compute(copies, comps, tr, overlap),
                              want)
                        cases += 1
    torch.cuda.synchronize()
    emit({"phase": "dma_compute_vs_plain", "cases": cases, "bit_exact": True,
          "groups": ["C", "D2D", "C D2D", "D2D D2D C C"],
          "copy_elements": list(copy_sizes), "compute_rows": [8, 64],
          "tripcounts": [0, 3, 100], "modes": ["dma_serial", "dma_overlap"]})
    return cases


def _device_time_s(torch, fn):
    """``fn()`` under torch.profiler: its host wall, the summed device
    time of its kernels, copies and memsets by name, and the union of
    their intervals, the time the device was busy (work in flight
    together on two streams counts once there and twice in the sum); all
    in s; the number of device records by name, which tells whether the
    profile kept every launch; and the first record's start after the
    trace's, in ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    by_name: dict[str, float] = {}
    calls: dict[str, int] = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0:
            by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) \
                + dev_us(e) / 1e6
            calls[e.key[:60]] = calls.get(e.key[:60], 0) + e.count
    spans = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA
        and e.duration_ns() > 0)
    if not by_name or not spans:
        raise AssertionError("the profile holds no device time")
    busy_ns, (lo, hi) = 0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy_ns += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy_ns += hi - lo
    first_ms = (spans[0][0] - prof.profiler.kineto_results.trace_start_ns()
                ) / 1e6
    return wall, by_name, busy_ns / 1e9, calls, first_ms


def _queued_ms(torch, ck, fn, n=20):
    """Device ms of one ``fn()`` with no host gaps, and the host's ms to
    enqueue one: ``n`` calls queued behind a 40,000-trip busy-wait
    (~5 ms), so the host has enqueued them all before the device reaches
    the first, timed by a CUDA-event pair after the busy-wait.  Raises
    if the enqueueing outlasted the busy-wait, which would let host time
    back into the window."""
    x = torch.zeros((8, 128), device=DEVICE)
    fn()
    lead, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    lead.record()
    ck.busy_wait(x, 40_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    if host_ms >= lead.elapsed_time(start):
        raise AssertionError(f"enqueueing {n} calls took {host_ms:.2f} ms, "
                             "longer than the busy-wait ahead of them")
    return start.elapsed_time(end) / n, host_ms / n


def _k7_inputs(cc, tuned):
    """The buffers ``PallasBackend.build`` makes for a Record's tuned
    commands (copies from seeds 10+i, computes from 20+i) and the
    computes' tripcounts."""
    cmds = [dataclasses.replace(cc.parse_command(t["text"]),
                                tripcount=t["tripcount"],
                                elements=t["elements"],
                                copy_elements=t["copy_elements"])
            for t in tuned]
    copies = [cc.alloc(c, DEVICE, seed=10 + i) for i, c in
              enumerate(c for c in cmds if c.kind == "copy")]
    comps = [cc.alloc(c, DEVICE, seed=20 + i) for i, c in
             enumerate(c for c in cmds if c.kind == "compute")]
    return copies, comps, [c.tripcount for c in cmds if c.kind == "compute"]


def _k7_bound(ck, spec, copies, comps, trips):
    """K7's bound on these inputs: (bytes ms, operations ms, bytes) --
    each copy read and written once, each compute element read and
    written once, 2 x 64 x tripcount flops an element over f32's peak."""
    n_bytes = sum(2 * t.numel() * 4 for t in (*copies, *comps))
    flops = sum(ck.flops(x.numel(), t) for x, t in zip(comps, trips))
    return (n_bytes / (spec["hbm_gbps"] * 1e9) * 1e3,
            flops / (spec["f32_tflops"] * 1e12) * 1e3, n_bytes)


def phase_main_path_vs_plain(torch, ck, cb, cc, tuned_by_run):
    """K6 and K7 bit for bit against their plain versions at the shapes
    the main path launched them with: K6 at the default 8 x 128 and
    40,000 trips (the xla runs' first compute, seed 0), K7 at each pallas
    run's tuned commands, rebuilt as its build made them, in both modes.
    The plain busy-waits of one tripcount run once, over their inputs
    stacked (the plain version is elementwise, and its time is that of
    its 64 x tripcount launches, not of the elements), timed by CUDA
    events; a plain K7 is then ``dma_compute_plain`` of its copies and
    those outputs.  Returns the plain ms of K6 and of K7 by run."""
    jobs = {"busy_wait": ([], [_conc_input(torch, 8, 0)], [40_000])}
    job_of = {}
    for run, tuned in tuned_by_run.items():
        key = json.dumps(tuned, sort_keys=True)
        if key not in job_of:
            job_of[key] = run
            jobs[run] = _k7_inputs(cc, tuned)
    by_trips: dict[int, list] = {}
    for job, (_, comps, trips) in jobs.items():
        for i, (x, t) in enumerate(zip(comps, trips)):
            by_trips.setdefault(t, []).append((job, i, x))
    busy_out, ms = {}, {}
    for t, items in by_trips.items():
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        y = ck.busy_wait_plain(torch.cat([x for *_, x in items]), t)
        end.record()
        end.synchronize()
        for (job, i, _), part in zip(items, y.split(
                [x.shape[0] for *_, x in items])):
            busy_out[job, i] = part
        for job in {job for job, *_ in items}:
            ms[job] = ms.get(job, 0.0) + start.elapsed_time(end)
    copies, comps, trips = jobs["busy_wait"]
    _same(torch, "busy_wait 8x128 at 40000 trips",
          [ck.busy_wait(comps[0], trips[0])], [busy_out["busy_wait", 0]])
    plain_ms = {}
    for run, tuned in tuned_by_run.items():
        job = job_of[json.dumps(tuned, sort_keys=True)]
        copies, comps, trips = jobs[job]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = (*cb.dma_compute_plain(copies, [], []),
                *[busy_out[job, i] for i in range(len(comps))])
        end.record()
        end.synchronize()
        plain_ms[run] = ms.get(job, 0.0) + start.elapsed_time(end)
        for overlap in (False, True):
            _same(torch, f"dma_compute at the {run} run's tuned commands "
                  f"{tuned}, overlap {overlap}",
                  cb.dma_compute(copies, comps, trips, overlap), want)
    torch.cuda.synchronize()
    emit({"phase": "main_path_vs_plain", "bit_exact": True,
          "busy_wait": "8x128 at 40000 trips", "dma_compute": tuned_by_run,
          "modes": ["dma_serial", "dma_overlap"],
          "plain_busy_wait_runs": {t: sorted({job for job, *_ in items})
                                   for t, items in by_trips.items()},
          "busy_wait_plain_ms": ms["busy_wait"],
          "dma_compute_plain_ms": plain_ms})
    return ms["busy_wait"], plain_ms


def phase_concurrency_time(torch, ck, cb, cc, ch, timing, spec,
                           busy_plain_ms, k7_tuned, k7_plain_ms,
                           balanced_tuned):
    """K6 and K7 where the main path launches them, CUDA events: K6 at
    the suite's defaults (1024 elements at 40,000 trips), K7 at the
    tuned commands of the pallas dma_overlap "C D2D" run whose launches
    the ``kernels`` line counts (both modes, copy-only beside one
    ``copy_`` and compute-only), each beside its bound (flops over 67
    TFLOP/s of f32, bytes read and written once over 3.35 TB/s; for
    dma_serial also the sum of the two); K6's chain floor (64 x 40,000
    dependent FMAs of FMA_LATENCY_CYCLES at the SM's top clock); the
    copy-only launch also queued behind a busy-wait, which leaves out
    the host's launch path, with the host's ms per launch, bound once
    (as the backend launches) and marshalled per call; then the balanced
    leg's tuned shape queued the same way, copy-only, compute-only and
    mixed in both modes: the device's own overlap, held to the harness's
    verdict (speedup at least theoretical / 1.3) and dma_serial to its
    serial guard.  The plain ms come from :func:`phase_main_path_vs_plain`."""
    clock_mhz = float(_run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"]).split()[0])
    trips, n = 40_000, 1024
    x = _conc_input(torch, n // 128, 0)
    flops = ck.flops(n, trips)
    ops_ms = flops / (spec["f32_tflops"] * 1e12) * 1e3
    chain_ms = ck.FMAS_PER_TRIP * trips * FMA_LATENCY_CYCLES / (
        clock_mhz * 1e6) * 1e3

    def t(fn):
        return timing.cuda_time_ms(fn, reps=5, warmup=1)

    busy = {"ms": t(lambda: ck.busy_wait(x, trips)), "plain_ms": busy_plain_ms,
            "bound_ms": ops_ms, "bound_by": "operations",
            "chain_floor_ms": chain_ms, "library_ms": None,
            "flops": flops, "shape": "8x128 float32 at 40000 trips"}

    copies, comps, k7_trips = _k7_inputs(cc, k7_tuned)
    bytes_ms, k7_ops_ms, k7_bytes = _k7_bound(ck, spec, copies, comps,
                                              k7_trips)
    copy_bytes_ms, _, copy_bytes = _k7_bound(ck, spec, copies, [], [])
    dma = {
        "tuned": k7_tuned,
        "ms": t(lambda: cb.dma_compute(copies, comps, k7_trips, True)),
        "dma_serial_ms": t(lambda: cb.dma_compute(copies, comps, k7_trips,
                                                  False)),
        "plain_ms": k7_plain_ms, "bytes": k7_bytes,
        "bound_ms": max(k7_ops_ms, bytes_ms), "bound_by": "operations"
        if k7_ops_ms >= bytes_ms else "bytes",
        "dma_serial_floor_ms": k7_ops_ms + bytes_ms, "library_ms": None,
        "copy_only_ms": t(lambda: cb.dma_compute(copies, [], [], True)),
        "copy_only_bound_ms": copy_bytes_ms, "copy_only_bytes": copy_bytes,
        "compute_only_ms": t(lambda: cb.dma_compute([], comps, k7_trips,
                                                    True)),
    }
    outs = [torch.empty_like(c) for c in copies]
    dma["copy_only_library_ms"] = t(
        lambda: [o.copy_(c) for o, c in zip(outs, copies)])
    bound = cb.K7Launch(copies, [], [], True, outs, [])
    dma["copy_only_queued_ms"], dma["host_ms_per_bound_launch"] = \
        _queued_ms(torch, ck, bound)
    _, dma["host_ms_per_dma_compute_call"] = _queued_ms(
        torch, ck, lambda: cb.dma_compute(copies, [], [], True))
    dma["copy_only_library_queued_ms"], _ = _queued_ms(
        torch, ck, lambda: [o.copy_(c) for o, c in zip(outs, copies)])
    del copies, comps, outs, bound

    copies, comps, b_trips = _k7_inputs(cc, balanced_tuned)
    q = {}
    for name, args in (("copy_only", (copies, [], [], True)),
                       ("compute_only", ([], comps, b_trips, True)),
                       ("dma_overlap", (copies, comps, b_trips, True)),
                       ("dma_serial", (copies, comps, b_trips, False))):
        bound = cb.K7Launch(*args, [torch.empty_like(c) for c in args[0]],
                            [torch.empty_like(c) for c in args[1]])
        q[name], _ = _queued_ms(torch, ck, bound)
    solo_sum = q["copy_only"] + q["compute_only"]
    balanced = {"tuned": balanced_tuned, "queued_ms": q,
                "device_speedup": solo_sum / q["dma_overlap"],
                "device_theoretical": solo_sum / max(q["copy_only"],
                                                     q["compute_only"]),
                "dma_serial_share_of_solos": q["dma_serial"] / solo_sum}
    emit({"phase": "concurrency_time", "sm_clock_max_mhz": clock_mhz,
          "fma_latency_cycles": FMA_LATENCY_CYCLES, "busy_wait": busy,
          "dma_compute": dma, "balanced_device": balanced})
    # the harness's verdict and serial guard, on the device's own times
    if not balanced["device_speedup"] >= balanced["device_theoretical"] / (
            1 + ch.TOL_SPEEDUP):
        raise AssertionError(f"K7 dma_overlap does not overlap on the "
                             f"device: {balanced}")
    if not balanced["dma_serial_share_of_solos"] >= SERIAL_GUARD:
        raise AssertionError(f"K7 dma_serial lost its order: {balanced}")
    return busy, dma


def _conc_run(torch, ck, cb, ch, **kw):
    """One ``run_concurrency`` call with both launch counts set to 0 just
    before and read just after; returns its Record and the counts."""
    ck.busy_wait.launches = 0
    cb.dma_compute.launches = 0
    rec, = ch.run_concurrency(ch.ConcurrencyConfig(device=DEVICE, **kw))
    torch.cuda.synchronize()
    launches = {"busy_wait": ck.busy_wait.launches,
                "dma_compute": cb.dma_compute.launches}
    row = {"phase": "concurrency", "mode": rec.mode,
           "commands": rec.commands, "verdict": rec.verdict.value,
           "metrics": rec.metrics, "tuned": rec.config["tuned"],
           "launches": launches, "notes": rec.notes}
    emit(row)
    if set(rec.metrics) != CONC_KEYS:
        raise AssertionError(f"{rec.mode} {rec.commands}: metric keys "
                             f"{sorted(rec.metrics)}")
    return rec, launches


def _serial_guard(rec):
    m = rec.metrics
    if not m["mode_us"] >= SERIAL_GUARD * m["serial_total_us"]:
        raise AssertionError(
            f"{rec.mode} {rec.commands}: group {m['mode_us']:.1f} us < "
            f"{SERIAL_GUARD} x the solos' {m['serial_total_us']:.1f} us: the "
            "serial ordering was lost")


def phase_concurrency(torch, ck, cb, cc, ch):
    """``run_concurrency`` on the card at the reference's defaults unless
    stated: xla concurrent and serial "C C", concurrent "C H2D" and
    "C S2D", both dispatch modes on "M2D D2M" and "H2D D2H"; pallas
    dma_overlap and dma_serial on "C D2D"; the balanced leg (copies of
    128 MiB, computes from 400 trips, so auto-tune raises the compute to
    the copy); then the ``concurrency`` CLI, default and balanced.
    Returns the launch counts the ``kernels`` line reports and each
    pallas run's tuned commands."""
    s = cc.alloc(cc.parse_command("S2D"), DEVICE)
    d = cc.alloc(cc.parse_command("D2S"), DEVICE)
    if not cc.is_managed(s) or cc.is_managed(d):
        raise AssertionError("S is not managed memory, or D is")
    del s, d
    runs, k7_tuned = {}, {}
    rec, launches = _conc_run(torch, ck, cb, ch, mode="concurrent")
    if not rec.verdict or not launches["busy_wait"] > 0:
        raise AssertionError(f"xla concurrent 'C C': {rec.verdict.value}, "
                             f"{launches}; {rec.notes}")
    runs["busy_wait"] = launches["busy_wait"]
    # the same run, and the pallas one, under the profiler, in a
    # process of their own (see profile_concurrency_main)
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--profile-concurrency"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"concurrency profile exited {r.returncode}: "
                             f"{r.stdout}{r.stderr}")
    for ln in r.stdout.splitlines():
        if ln.startswith('{"phase": "concurrency_profile"'):
            emit(json.loads(ln))
    rec, _ = _conc_run(torch, ck, cb, ch, mode="serial")
    _serial_guard(rec)
    for mode, group in (("concurrent", "C H2D"), ("concurrent", "C S2D"),
                        ("dispatch_serial", "M2D D2M"),
                        ("dispatch_serial", "H2D D2H"),
                        ("dispatch_async", "M2D D2M"),
                        ("dispatch_async", "H2D D2H")):
        _conc_run(torch, ck, cb, ch, mode=mode, commands=(group,))
    for mode in ("dma_overlap", "dma_serial"):
        rec, launches = _conc_run(torch, ck, cb, ch, backend="pallas",
                                  mode=mode, commands=("C D2D",))
        if not launches["dma_compute"] > 0:
            raise AssertionError(f"pallas {mode}: K7 never launched")
        if mode == "dma_overlap":
            runs["dma_compute"] = launches["dma_compute"]
        k7_tuned[f"defaults {mode}"] = rec.config["tuned"]
    rec, _ = _conc_run(torch, ck, cb, ch, backend="pallas",
                       mode="dma_overlap", commands=("C D2D",), **BALANCED)
    if not rec.verdict:
        raise AssertionError(f"balanced pallas dma_overlap: {rec.notes}")
    k7_tuned["balanced dma_overlap"] = rec.config["tuned"]
    rec, _ = _conc_run(torch, ck, cb, ch, backend="pallas",
                       mode="dma_serial", commands=("C D2D",), **BALANCED)
    _serial_guard(rec)
    k7_tuned["balanced dma_serial"] = rec.config["tuned"]
    cli = [sys.executable, "-m", "tpu_patterns_torch", "concurrency",
           "--device", "cuda"]
    for argv in ([], ["--backend", "pallas", "--mode", "dma_overlap",
                      "--commands", "C D2D", "--copy_elements",
                      str(BALANCED["copy_elements"]), "--tripcount",
                      str(BALANCED["tripcount"])]):
        r = subprocess.run(cli + argv, cwd=ROOT, capture_output=True,
                           text=True, timeout=300)
        emit({"phase": "concurrency_cli", "argv": argv, "rc": r.returncode,
              "stdout_tail": r.stdout.splitlines()[-3:]})
        if r.returncode != 0:
            raise AssertionError(f"concurrency CLI {argv} exited "
                                 f"{r.returncode}: {r.stdout}{r.stderr}")
    return runs, k7_tuned


def profile_concurrency_main() -> int:
    """``python3 chip_smoke.py --profile-concurrency``, which the smoke
    runs in a process of its own: the xla concurrent "C C" run and the
    pallas dma_overlap "C D2D" run, each under torch.profiler, and the
    device's idle share of each, 1 - the union of its busy intervals
    over the host's wall.  (In the smoke's own process, after the
    earlier phases, the profiles dropped a few kernel records a run.)
    Each run goes once unprofiled first, so that the profiled one finds
    the kernel libraries loaded, as the main path did.  A profile that
    lost kernel records (fewer than the launches) only bounds the idle
    share from above; such a run is profiled again, up to 3 times, and
    the line says which it has."""
    import torch

    if not torch.cuda.is_available():
        return 2
    sys.path.insert(0, ROOT)
    from tpu_patterns_torch.concurrency import backends as cb
    from tpu_patterns_torch.concurrency import harness as ch
    from tpu_patterns_torch.concurrency import kernels as ck
    from tpu_patterns_torch.core.results import ResultWriter

    for kw, kname, prefix in (
            (dict(mode="concurrent"), "busy_wait", "busy::busy_wait_kernel"),
            (dict(backend="pallas", mode="dma_overlap", commands=("C D2D",)),
             "dma_compute", "dma::dma_compute_kernel")):
        ch.run_concurrency(ch.ConcurrencyConfig(device=DEVICE, **kw),
                           ResultWriter(stream=io.StringIO()))
        recorded_by_attempt = []
        for _ in range(3):
            ck.busy_wait.launches = 0
            cb.dma_compute.launches = 0
            wall, by_name, busy, calls, first_ms = _device_time_s(
                torch, lambda: ch.run_concurrency(
                    ch.ConcurrencyConfig(device=DEVICE, **kw),
                    ResultWriter(stream=io.StringIO())))
            launched = (ck.busy_wait.launches if kname == "busy_wait"
                        else cb.dma_compute.launches)
            recorded_by_attempt.append(sum(
                n for k, n in calls.items() if k.startswith(prefix)))
            if recorded_by_attempt[-1] == launched:
                break
        complete = recorded_by_attempt[-1] == launched
        emit({"phase": "concurrency_profile", **kw, "wall_s": wall,
              "device_busy_s": busy,
              "device_idle_share": 1 - busy / wall if complete else None,
              "device_idle_share_at_most": 1 - busy / wall,
              "device_time_sum_s": sum(by_name.values()),
              "launches": {kname: launched},
              "kernel_records_by_attempt": recorded_by_attempt,
              "profile_complete": complete, "first_record_ms": first_ms,
              "by_name_s": by_name, "calls_by_name": calls})
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tpu_patterns_torch.comm import onesided as op
    from tpu_patterns_torch.concurrency import backends as cb
    from tpu_patterns_torch.concurrency import commands as cc
    from tpu_patterns_torch.concurrency import harness as ch
    from tpu_patterns_torch.concurrency import kernels as ck
    from tpu_patterns_torch.core import timing
    from tpu_patterns_torch.kernels import build
    from tpu_patterns_torch.longctx import flash as F
    from tpu_patterns_torch.longctx import tuning
    from tpu_patterns_torch.models import flagship as fl
    from tpu_patterns_torch.models import transformer as tr
    from tpu_patterns_torch.runtime import match_device_spec
    from tpu_patterns_torch.serve import engine as eng_mod
    from tpu_patterns_torch.serve import paged_kernel as pk

    kind = torch.cuda.get_device_name(0)
    spec = match_device_spec(kind)
    if spec is None:
        raise RuntimeError(f"no datasheet entry for {kind!r}")
    nvcc_line = next(
        (ln.strip() for ln in _run([build.find_nvcc(), "--version"])
         .splitlines() if "release" in ln), "?"
    )
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).strip().splitlines()[0]
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_line, "name": kind,
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
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions
    flash_err, inputs, fwd_t, bwd_t = phase_flash_kernels(torch, F, tuning)
    ftime = phase_flash_time(torch, F, timing, spec, inputs, fwd_t, bwd_t)
    del inputs

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

    flag = phase_flagship(torch, F, fl)
    phase_flagship_profile(torch, timing, fl, tr,
                           flag["kernel"]["step_ms"] / 1e3)
    no_grad_launches = phase_flagship_exact(torch, F, fl, tr)

    phase_put_vs_plain(torch, op)
    ptime = phase_put_time(torch, op, timing, spec)
    puts = phase_onesided(torch, op)

    phase_busy_wait_vs_plain(torch, ck)
    phase_dma_compute_vs_plain(torch, cb)
    conc_launches, k7_tuned = phase_concurrency(torch, ck, cb, cc, ch)
    busy_plain_ms, k7_plain_ms = phase_main_path_vs_plain(torch, ck, cb, cc,
                                                          k7_tuned)
    conc_time = phase_concurrency_time(
        torch, ck, cb, cc, ch, timing, spec, busy_plain_ms,
        k7_tuned["defaults dma_overlap"], k7_plain_ms["defaults dma_overlap"],
        k7_tuned["balanced dma_overlap"])

    # launches: K1 in the timed serve run, K3 and K4 in the flagship
    # run, K2 in the no-grad forward (each count set to 0 just before)
    launches = {**flag["kernel"]["launches"],
                "flash_attention": no_grad_launches["flash_attention"]}
    kernels = [{
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
    }]
    for kname, (source, replaces) in FLASH_KERNELS.items():
        row = ftime[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": flash_err[kname], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    # launches: mono in its run_onesided call, the others in auto's
    for kname, replaces in PUT_KERNELS.items():
        row = ptime[kname]
        run = puts["mono" if kname == "local_put" else "auto"]
        kernels.append({
            "name": kname, "route": "cuda", "source": PUT_SOURCE,
            "replaces": replaces, "launches": run["launches"][kname],
            "max_abs_err": 0.0, "bit_exact": True, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    # launches: K6 in the xla concurrent "C C" run, K7 in the pallas
    # dma_overlap "C D2D" run, both at the defaults; K7's times are at
    # that run's tuned commands
    for (kname, (source, replaces)), row in zip(CONC_KERNELS.items(),
                                                conc_time):
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": conc_launches[kname],
            "max_abs_err": 0.0, "bit_exact": True, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    # the card's name and power limit again, beside the numbers, where a
    # tail of the output still holds them
    emit(_run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).strip().splitlines()[0])
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(profile_concurrency_main()
             if sys.argv[1:] == ["--profile-concurrency"] else main())
