"""tpu_patterns_torch: the PyTorch and CUDA port of ``tpu_patterns``.

A second package beside the JAX one, held against it module by module.
It imports ``torch`` and numpy, never JAX and nothing of ``tpu_patterns``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
each TPU kernel on a ported path is a kernel written by hand for Hopper
(``sm_90a``), with a plain-torch version beside it that CPU tensors run.

  runtime.py        device resolution (cuda, or cpu only when asked) and
                    the card's datasheet spec table
  core/             clocks and CUDA-event timing; Records and markers
  models/           params, q/k/v, RoPE, int8 KV, MLP, attention, the
                    dense per-request decoder (the exactness oracle), the
                    one-device train step and the flagship workload
  longctx/          dense attention twins, the flash tile model and the
                    flash-attention kernels (longctx/csrc/: forward, and
                    dq and dk/dv backward)
  serve/            paged pool, the fused paged-attention kernel
                    (serve/csrc/paged_attention.cu) and the
                    continuous-batching engine
  comm/             dtypes, the fill and checksum verifier, and the
                    one-device one-sided put with its four put kernels
                    (comm/csrc/local_put.cu, staging in bulk_copy.cuh)
  concurrency/      the serial-vs-concurrent suite: command language and
                    memory kinds, streams and dispatch (xla), the
                    busy-wait kernel K6 and the copy-and-compute kernel K7
                    (concurrency/csrc/), the harness
  kernels/build.py  nvcc build of every ``*.cu`` into build/torch_kernels/
  convert.py        numpy params/pools/fills from the JAX package ->
                    tensors (and params/grads back, as numpy)
  cli.py            ``python -m tpu_patterns_torch
                    serve|flagship|p2p|concurrency``
"""
