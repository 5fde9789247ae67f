"""Continuous-batching decode over a paged KV cache.

  paged_kernel.py  fused paged attention: the CUDA kernel's wrapper and
                   its plain-torch version
  paged.py         block pool + block tables; prefill and step updating
                   the pool in place
  engine.py        FIFO admit / prefill / step / retire scheduler and the
                   ``serve`` measured pattern
"""
