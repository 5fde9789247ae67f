"""tpu_patterns_torch: the PyTorch and CUDA port of ``tpu_patterns``.

A second package beside the JAX one, held against it module by module.
It imports ``torch`` and numpy, never JAX and nothing of ``tpu_patterns``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
each TPU kernel on a ported path is a kernel written by hand for Hopper
(``sm_90a``), with a plain-torch version beside it that CPU tensors run.

  runtime.py        device resolution (cuda, or cpu only when asked) and
                    the card's datasheet spec table
  core/             the native clock and CUDA-event timing; Records and
                    markers; the three config tiers (defaults <
                    TPU_PATTERNS_<FIELD> < CLI)
  models/           params, q/k/v, RoPE, int8 KV, MLP, attention, the
                    seeded per-row sampler (models/prng.py: threefry as
                    jax.random draws it), the dense per-request decoder
                    (the exactness oracle), the one-device train step,
                    the flagship workload, the resumable training loop
                    (models/train_loop.py), the long-context decode
                    pattern and the token LM's train-then-generate
                    pattern
  longctx/          dense attention twins, the flash tile model and the
                    flash-attention kernels (longctx/csrc/: forward, and
                    dq and dk/dv backward)
  serve/            paged pool, the fused paged-attention kernel
                    (serve/csrc/paged_attention.cu) and the
                    continuous-batching engine
  loadgen/          scenario presets, seeded arrivals, the percentile
                    sketch and the runner that drives the engine on the
                    wall clock into SLO Records
  obs/              the metrics registry, the SLO burn monitor and the
                    cost book
  comm/             dtypes, the fill and checksum verifier, the
                    one-device one-sided put with its four put kernels
                    (comm/csrc/local_put.cu, staging in bulk_copy.cuh),
                    the rank mesh, the ring collectives and the ring put
                    kernel K9 (comm/csrc/ring_put.cu), the two-sided pair
                    exchange and the hierarchical allreduce
  topo/             topology discovery (the C++ planes core
                    topo/csrc/topo.cc, built with g++ at first use), rank
                    placement over the cards, the multi-process bootstrap
  miniapps/         the miniapp framework and the ring-allreduce app;
                    its pallas variant's accumulate kernel K5
                    (miniapps/apps/allreduce/csrc/accumulate.cu)
  concurrency/      the serial-vs-concurrent suite: command language and
                    memory kinds, streams and dispatch (xla), the
                    busy-wait kernel K6 and the copy-and-compute kernel K7
                    (concurrency/csrc/), the harness
  interop/          the native C++ module (interop/csrc/
                    tpu_patterns_native.cc, built with g++ into
                    build/torch_native/ at first use; the host clock of
                    core/timing.py), its typed custom ops, the raw DLPack
                    probe, host staging from the card, and the kernel K10
                    (interop/csrc/add_one.cu) whose output the C++ reads
                    in place
  ckpt/             atomic checkpoints of tensor trees, in the JAX
                    package's on-disk format
  io/               the native prefetch batch loader (io/csrc/loader.cc,
                    built with g++ at first use)
  faults/           seeded fault sites and the ckpt retry policy
  kernels/build.py  nvcc build of every ``*.cu`` into build/torch_kernels/
  convert.py        numpy params/pools/fills from the JAX package ->
                    tensors (and params/grads back, as numpy)
  cli.py            ``python -m tpu_patterns_torch
                    serve|loadgen|flagship|train|ckpt|p2p|hier|topo|
                    concurrency|allreduce|miniapps|interop``
"""
