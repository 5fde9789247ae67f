#!/usr/bin/env python3
"""Chip smoke of tpu_patterns_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX or of the
JAX package, and fails (nonzero exit, no result line) without a CUDA
device or away from the repository.  It drives both ported paths, the
serve path (slice A) and the flagship train step (slice B).  Phases,
each one or more printed lines:

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
9. the ``kernels`` line, then the device line, which is the last.
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
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
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
