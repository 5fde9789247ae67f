#!/usr/bin/env python3
"""Tile sweep of K10 (x + 1 over float32) on one CUDA card.

    python3 scripts/torch_k10_tile_sweep.py

Run from the root of a checkout.  Builds one library of streaming-tile
variants of ``tpu_patterns_torch/interop/csrc/add_one.cu``'s vector
kernel (threads a block x 16-byte vectors a thread, with and without
the n % 4 tail branch) with the package's nvcc flags into
``build/k10_tile_sweep/``, checks each against ``x + 1.0`` bit for bit
at 2^25 elements, and prints, beside the package's K10 and one
``torch.add(x, 1.0, out=)`` call, each variant's device ms queued
behind a busy-wait (``chip_smoke._queued_stats``: 5 readings of 20
calls, no host gaps), in two rounds; then the card's name and power
limit.  Imports nothing of JAX.  Exits 2 without a CUDA device."""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (threads, vectors a thread, with the tail branch)
VARIANTS = ((256, 4, 1), (256, 4, 0), (256, 2, 1), (256, 1, 1),
            (512, 1, 1), (1024, 1, 1), (128, 1, 1))
SOURCE = r"""
#include <cuda_runtime.h>
template <int THREADS, int VECS, int TAIL>
__global__ void __launch_bounds__(THREADS)
    k(const float* __restrict__ x, float* __restrict__ o, long long n) {
  const long long nv = n / 4;
  const long long v0 =
      static_cast<long long>(blockIdx.x) * (THREADS * VECS) + threadIdx.x;
  const float4* xv = reinterpret_cast<const float4*>(x);
  float4* ov = reinterpret_cast<float4*>(o);
  float4 a[VECS];
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const long long v = v0 + j * THREADS;
    if (v < nv) a[j] = xv[v];
  }
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const long long v = v0 + j * THREADS;
    if (v < nv) {
      float4 b;
      b.x = __fadd_rn(a[j].x, 1.0f);
      b.y = __fadd_rn(a[j].y, 1.0f);
      b.z = __fadd_rn(a[j].z, 1.0f);
      b.w = __fadd_rn(a[j].w, 1.0f);
      ov[v] = b;
    }
  }
  if (TAIL && blockIdx.x == gridDim.x - 1 && threadIdx.x < n - nv * 4) {
    const long long i = nv * 4 + threadIdx.x;
    o[i] = __fadd_rn(x[i], 1.0f);
  }
}
#define VARIANT(T, V, L)                                                  \
  extern "C" int run_t##T##_v##V##_l##L(const void* x, void* o,          \
                                        long long n, void* s) {           \
    const long long g = (n / 4 + T * V - 1) / (T * V);                    \
    k<T, V, L><<<(unsigned)g, T, 0, (cudaStream_t)s>>>(                   \
        (const float*)x, (float*)o, n);                                   \
    return (int)cudaGetLastError();                                       \
  }
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_k10_tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from tpu_patterns_torch.concurrency import kernels as ck
    from tpu_patterns_torch.interop import kernel as k10
    from tpu_patterns_torch.kernels import build

    out_dir = os.path.join(ROOT, "build", "k10_tile_sweep")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = (os.path.join(out_dir, f) for f in ("sweep.cu",
                                                        "libsweep.so"))
    with open(src, "w") as f:
        f.write(SOURCE + "".join(f"VARIANT({t}, {v}, {l})\n"
                                 for t, v, l in VARIANTS))
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib_path,
                    src], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    n = 1 << 25
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(n, generator=g, device="cuda")
    out = torch.empty_like(x)
    want = x + 1.0
    stream = torch.cuda.current_stream().cuda_stream
    calls = {"torch.add": lambda: torch.add(x, 1.0, out=out),
             "add_one (package)": lambda: k10.add_one(x, out=out)}
    for t, v, tail in VARIANTS:
        fn = getattr(lib, f"run_t{t}_v{v}_l{tail}")
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                               ctypes.c_void_p]
        out.zero_()
        fn(x.data_ptr(), out.data_ptr(), n, stream)
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"variant {t}x{v} tail {tail} is wrong")
        calls[f"{t} threads x {v} vectors, tail {tail}"] = (
            lambda fn=fn: fn(x.data_ptr(), out.data_ptr(), n, stream))
    rounds = {name: [] for name in calls}
    for _ in range(2):
        for name, fn in calls.items():
            rounds[name].append(cs._queued_stats(torch, ck, fn)["ms"])
    for name, ms in rounds.items():
        print(json.dumps({"k10_tile_sweep": name, "n": n,
                          "queued_ms": ms}), flush=True)
    print(cs._run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
