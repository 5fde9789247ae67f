#!/usr/bin/env python3
"""Where the float32 flash kernels spend their time, phase by phase, on
one CUDA card.

    python3 scripts/flash_f32_phases.py [--kernel fwd|bwd] [--tree TREE]
                                        [--reps N]

Run from the root of a checkout.  Takes ``flash_attention.cu`` (``--kernel
fwd``, the default: K2 and K3) or ``flash_attention_bwd.cu`` (``bwd``:
K4's dq and dk/dv) of the checkout at TREE (default: this one; a parent
unpacked under ``build/`` for an A/B), builds a copy of it into
``build/flash_phases/`` with ``clock64()`` phase marks, and runs its
float32 kernels at longctx's shapes: K2 over a causal L4096 x 8 x 128
sequence, K3 and K4 on a 1024-token shard pair with no key masked and
on the diagonal.  Thread 0 of every block adds the cycles since its
previous mark to a ``__device__`` counter at each mark; the counters are
read back with ``cudaMemcpyFromSymbol``, so each phase's share is its
share of the blocks' cycles.

A source that carries its own marks (``FLASH_MARK(n)``, no-ops unless
this script's header defines them, and a ``// FLASH_MARK phases:`` line
naming them, ``// FLASH_MARK dq phases:`` and ``// FLASH_MARK dkv
phases:`` in the backward) is built as it is.  The scalar kernels
before the register-tiled redesigns had none: their marks are put in at
fixed statements (``OLD_ANCHORS``, ``OLD_BWD_ANCHORS``; a missing anchor
raises).  In the forward each mark follows the barrier that ends a
phase, so a phase is the block's time from one barrier to the next; in
the backward a mark also precedes each barrier, so thread 0's wait
there is a phase of its own (``barrier``), and the two products between
one pair of barriers are thread 0's own time on each.

Prints, per shape, a JSON line with the uninstrumented kernel's ms (the
tree's package, CUDA events, L2 flushed), the instrumented build's ms
and each phase's share; then the card's name and power limit.  Imports
nothing of JAX.  Exits 2 without a CUDA device."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("tpu_patterns_torch", "longctx", "csrc")
SRC = {"fwd": os.path.join(CSRC, "flash_attention.cu"),
       "bwd": os.path.join(CSRC, "flash_attention_bwd.cu")}

HEADER = r"""
#pragma once
#include <cuda_runtime.h>
#define FLASH_PHASES 16
__device__ unsigned long long flash_phase_cycles[FLASH_PHASES];
#define FLASH_MARK_START long long flash_mark_t0 = clock64()
#define FLASH_MARK(n)                                                  \
  do {                                                                 \
    if (threadIdx.x == 0) {                                            \
      const long long flash_mark_t = clock64();                        \
      atomicAdd(&flash_phase_cycles[n],                                \
                static_cast<unsigned long long>(flash_mark_t -         \
                                                flash_mark_t0));       \
      flash_mark_t0 = flash_mark_t;                                    \
    }                                                                  \
  } while (0)
extern "C" int flash_phase_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, flash_phase_cycles,
                                               sizeof(flash_phase_cycles)));
}
extern "C" int flash_phase_reset() {
  unsigned long long z[FLASH_PHASES] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(flash_phase_cycles, z,
                                             sizeof(z)));
}
"""

# The scalar f32 forward before the redesign (flash_fwd_kernel<float>):
# (statement, text put after it), in source order, and the phases the
# marks end
OLD_PHASES = ["prologue", "kv_staging", "qk", "softmax", "rescale", "pv",
              "epilogue"]
OLD_ANCHORS = [
    ("  const int row0 = blockIdx.x * bq;\n", "  FLASH_MARK_START;\n"),
    ("  }\n  __syncthreads();\n\n  const int nk = Lk / bk;\n",
     "  FLASH_MARK(0);\n"),
    ("    load_tile(v_s, ldt, v, col0, bk, H, h, D);\n"
     "    __syncthreads();\n", "    FLASH_MARK(1);\n"),
    ("    mm<false, true>(q_s, ldt, k_s, ldt, s_s, lds, bq, bk, D, false);\n"
     "    __syncthreads();\n", "    FLASH_MARK(2);\n"),
    ("        m_s[r] = m_cur;\n      }\n    }\n    __syncthreads();\n",
     "    FLASH_MARK(3);\n"),
    ("      acc[r * lda + c] *= a_s[r];\n    }\n    __syncthreads();\n",
     "    FLASH_MARK(4);\n"),
    ("    mm<false, false>(p_s, ldp, v_s, ldt, acc, lda, bq, D, bk, true);\n"
     "    __syncthreads();\n", "    FLASH_MARK(5);\n"),
    ("          from_f32<T>(acc[r * lda + c] / (l == 0.f ? 1.f : l));\n"
     "    }\n  }\n", "  FLASH_MARK(6);\n"),
]


# The scalar f32 backward before its redesign (flash_bwd_dq_kernel<float>
# and flash_bwd_dkv_kernel<float>), marked the same way, with a mark
# before and after each barrier: thread 0's wait there is ``barrier``
OLD_BWD_PHASES = {
    "dq": ["prologue", "kv_staging", "s", "dp", "ds", "dq", "epilogue",
           "barrier"],
    "dkv": ["prologue", "qdo_staging", "s", "dp", "p_ds", "dv", "dk",
            "epilogue", "barrier"],
}
_SYNC = "    __syncthreads();\n"
OLD_BWD_ANCHORS = [
    # dq: barrier phase 7
    ("  const int row0 = blockIdx.x * bq;\n", "  FLASH_MARK_START;\n"),
    ("  for (int i = tid; i < bq * lda; i += THREADS) acc[i] = 0.f;\n",
     "  FLASH_MARK(0);\n"),
    ("  __syncthreads();\n", "  FLASH_MARK(7);\n"),
    ("    load_tile(v_s, ldt, v, col0, bk, H, h, D);\n",
     "    FLASH_MARK(1);\n"),
    (_SYNC, "    FLASH_MARK(7);\n"),
    ("    mm<false, true>(q_s, ldt, k_s, ldt, s_s, lds, bq, bk, D, false);\n",
     "    FLASH_MARK(2);\n"),
    ("    mm<false, true>(do_s, ldt, v_s, ldt, dp_s, lds, bq, bk, D, "
     "false);\n", "    FLASH_MARK(3);\n"),
    (_SYNC, "    FLASH_MARK(7);\n"),
    ("      ds_s[r * ldp + c] = from_f32<T>(ds);\n    }\n",
     "    FLASH_MARK(4);\n"),
    (_SYNC, "    FLASH_MARK(7);\n"),
    ("    mm<false, false>(ds_s, ldp, k_s, ldt, acc, lda, bq, D, bk, "
     "true);\n", "    FLASH_MARK(5);\n"),
    (_SYNC, "    FLASH_MARK(7);\n"),
    ("        scale * acc[r * lda + c];\n  }\n", "  FLASH_MARK(6);\n"),
    # dk/dv: barrier phase 8
    ("  const int col0 = blockIdx.x * bk;\n", "  FLASH_MARK_START;\n"),
    ("    dv_acc[i] = 0.f;\n  }\n", "  FLASH_MARK(0);\n"),
    ("      continue;\n", "    FLASH_MARK(0);\n"),
    ("    __syncthreads();  // the previous tile's readers of q_s / do_s "
     "are done\n", "    FLASH_MARK(8);\n"),
    ("    load_row_stat(delta_s, delta, row0, bq, Lq, h);\n",
     "    FLASH_MARK(1);\n"),
    (_SYNC, "    FLASH_MARK(8);\n"),
    ("    mm<false, true>(q_s, ldt, k_s, ldt, s_s, lds, bq, bk, D, false);\n",
     "    FLASH_MARK(2);\n"),
    ("    mm<false, true>(do_s, ldt, v_s, ldt, dp_s, lds, bq, bk, D, "
     "false);\n", "    FLASH_MARK(3);\n"),
    (_SYNC, "    FLASH_MARK(8);\n"),
    ("      ds_s[r * ldp + c] = from_f32<T>(p * (dp_s[r * lds + c] - "
     "delta_s[r]));\n    }\n", "    FLASH_MARK(4);\n"),
    (_SYNC, "    FLASH_MARK(8);\n"),
    ("    mm<true, false>(p_s, ldp, do_s, ldt, dv_acc, lda, bk, D, bq, "
     "true);\n", "    FLASH_MARK(5);\n"),
    ("    mm<true, false>(ds_s, ldp, q_s, ldt, dk_acc, lda, bk, D, bq, "
     "true);\n", "    FLASH_MARK(6);\n"),
    ("  }\n  __syncthreads();\n", "  FLASH_MARK(8);\n"),
    ("    dv[off] = dv_acc[r * lda + c];\n  }\n", "  FLASH_MARK(7);\n"),
]


def _marked(text: str, anchors, src: str) -> str:
    pos = 0
    for anchor, mark in anchors:
        at = text.find(anchor, pos)
        if at < 0:
            raise RuntimeError(f"anchor not found in {src}: {anchor!r}")
        at += len(anchor)
        text = text[:at] + mark + text[at:]
        pos = at + len(mark)
    return text


def instrumented_source(text: str, kernel: str = "fwd"):
    """(source with phase marks, phase names): a list for the forward, a
    dict {"dq": [...], "dkv": [...]} for the backward."""
    if kernel == "bwd":
        own = dict(re.findall(r"// FLASH_MARK (dq|dkv) phases: (.+)", text))
        if own:
            return text, {k: [p.strip() for p in v.split(",")]
                          for k, v in own.items()}
        return (_marked(text, OLD_BWD_ANCHORS, SRC[kernel]),
                OLD_BWD_PHASES)
    m = re.search(r"// FLASH_MARK phases: (.+)", text)
    if m:
        return text, [p.strip() for p in m.group(1).split(",")]
    return _marked(text, OLD_ANCHORS, SRC[kernel]), OLD_PHASES


def build(tree: str, kernel: str = "fwd"):
    from tpu_patterns_torch.kernels import build as kb

    src = SRC[kernel]
    src_dir = os.path.join(tree, os.path.dirname(src))
    with open(os.path.join(tree, src)) as f:
        text, names = instrumented_source(f.read(), kernel)
    out = os.path.join(ROOT, "build", "flash_phases",
                       os.path.basename(os.path.abspath(tree)) or "tree")
    os.makedirs(out, exist_ok=True)
    hdr = os.path.join(out, "phases.cuh")
    cu = os.path.join(out, f"{kernel}.cu")
    with open(hdr, "w") as f:
        f.write(HEADER)
    with open(cu, "w") as f:
        f.write(text)
    lib = os.path.join(out, f"libflash_phases_{kernel}.so")
    cmd = [kb.find_nvcc(), *kb.NVCC_FLAGS, "-I", src_dir, "-include", hdr,
           "-o", lib, cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    print(json.dumps({"phase": "build", "tree": tree, "kernel": kernel,
                      "ptxas": regs[:24]}), flush=True)
    cdll = ctypes.CDLL(lib)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if kernel == "fwd":
        cdll.flash_fwd.restype = i32
        cdll.flash_fwd.argtypes = ([i32, i32] + [ptr] * 6 + [i32] * 10
                                   + [f32, ptr])
    else:
        for fn, n_ptr in ((cdll.flash_bwd_dq, 7), (cdll.flash_bwd_dkv, 8)):
            fn.restype = i32
            fn.argtypes = [i32] + [ptr] * n_ptr + [i32] * 10 + [f32, ptr]
    cdll.flash_phase_read.argtypes = [ptr]
    return cdll, names


def _phases(lib, names, reps, run, timing, flush) -> tuple[float, dict, float]:
    """The instrumented build's ms over ``reps`` launches of ``run``
    (after one untimed) and each phase's share of the blocks' cycles."""
    import torch

    run()
    torch.cuda.synchronize()
    lib.flash_phase_reset()
    ms = timing.cuda_time_ms(run, reps=reps, warmup=0, before=flush.zero_)
    buf = (ctypes.c_ulonglong * 16)()
    if lib.flash_phase_read(ctypes.cast(buf, ctypes.c_void_p)):
        raise RuntimeError("cudaMemcpyFromSymbol failed")
    cyc = [int(buf[i]) for i in range(len(names))]
    total = sum(cyc) or 1
    return ms, {p: c / total for p, c in zip(names, cyc)}, total / reps


def bwd_main(lib, names, F, timing, reps, normal, flush) -> None:
    """K4's dq and dk/dv on a 1024-token shard pair with no key masked
    and on the diagonal, the row statistics from the plain forward."""
    import torch

    n, h, d = 1024, 8, 128
    scale = d ** -0.5
    q, k, v, do = (normal(n) for _ in range(4))
    tiles = F._bwd_tiles(q, k, 512, 512)
    stream = torch.cuda.current_stream().cuda_stream
    dq = torch.empty((n, h, d), dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(dq), torch.empty_like(dq)
    ptrs = [t.data_ptr() for t in (q, k, v, do)]
    for case, q_off in (("full pair", n), ("diagonal", 0)):
        o, m, l = F.flash_block_reference(q, k, v, q_off, 0, True)
        out, lse = F._row_stats(o, m, l)
        lse, delta = lse.contiguous(), F._delta(do, out).contiguous()
        stats = [lse.data_ptr(), delta.data_ptr()]
        for name in ("dq", "dkv"):
            bq, bk = tiles[name]
            outs = [dq.data_ptr()] if name == "dq" else [dk.data_ptr(),
                                                        dv.data_ptr()]
            fn = lib.flash_bwd_dq if name == "dq" else lib.flash_bwd_dkv

            def marked():
                rc = fn(0, *ptrs, *stats, *outs, n, n, h, d, bq, bk, 1,
                        q_off, 0, 1, scale, stream)
                if rc:
                    raise RuntimeError(f"instrumented launch: CUDA error {rc}")

            ms = timing.cuda_time_ms(
                lambda: F._launch_bwd(q, k, v, do, lse, delta, q_off, 0, True,
                                      scale, tiles, 1, kernels=(name,)),
                reps=reps, before=flush.zero_)
            marked_ms, share, cycles = _phases(lib, names[name], reps, marked,
                                               timing, flush)
            print(json.dumps({
                "phase": "flash_f32_phases", "case": f"{name} {case}",
                "tiles": [bq, bk],
                "shape": f"Lq=Lk={n} H{h} D{d} f32, q_off {q_off}, causal",
                "ms": ms, "instrumented_ms": marked_ms, "share": share,
                "cycles_per_launch": cycles}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("fwd", "bwd"), default="fwd")
    ap.add_argument("--tree", default=".")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_f32_phases: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from tpu_patterns_torch.core import timing
    from tpu_patterns_torch.longctx import flash as F

    lib, names = build(tree, args.kernel)
    dev = "cuda"
    g = torch.Generator().manual_seed(400)
    seq, shard, h, d = 4096, 1024, 8, 128
    scale = d ** -0.5
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)

    def normal(n):
        return torch.randn((n, h, d), generator=g).to(dev)

    if args.kernel == "bwd":
        bwd_main(lib, names, F, timing, args.reps, normal, flush)
        cases = []
    else:
        cases = [("flash_attention L4096 causal", seq, 0, 0)]
        cases += [("flash_block full pair", shard, shard, 1),
                  ("flash_block diagonal", shard, 0, 1)]
    for name, n, q_off, stats in cases:
        q, k, v = normal(n), normal(n), normal(n)
        bq, bk = F._blocks(q, k, ("fwd",), 1024, 1024)
        o = torch.empty((n, h, d), dtype=torch.float32, device=dev)
        m = torch.empty((h, n), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
        stream = torch.cuda.current_stream().cuda_stream

        def marked():
            rc = lib.flash_fwd(0, stats, q.data_ptr(), k.data_ptr(),
                               v.data_ptr(), o.data_ptr(), m.data_ptr(),
                               l.data_ptr(), n, n, h, d, bq, bk, 1, q_off, 0,
                               1, scale, stream)
            if rc:
                raise RuntimeError(f"instrumented launch: CUDA error {rc}")

        ms = timing.cuda_time_ms(
            lambda: F._launch_fwd(q, k, v, q_off, 0, True, scale, bq, bk, 1,
                                  emit_stats=bool(stats)),
            reps=args.reps, before=flush.zero_)
        marked_ms, share, cycles = _phases(lib, names, args.reps, marked,
                                           timing, flush)
        print(json.dumps({
            "phase": "flash_f32_phases", "case": name, "tiles": [bq, bk],
            "shape": f"L{n} H{h} D{d} f32, q_off {q_off}, causal",
            "ms": ms, "instrumented_ms": marked_ms, "share": share,
            "cycles_per_launch": cycles}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
