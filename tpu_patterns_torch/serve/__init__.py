"""Continuous-batching decode over a paged KV cache.

  paged_kernel.py  fused paged attention: the CUDA kernel's wrapper and
                   its plain-torch version
  paged.py         block pool + block tables; prefill, step, the
                   speculative verify step and the CoW block copy,
                   updating the pool in place; optionally sampling
  prefix.py        the radix index of admitted prompts that prefix
                   sharing aliases blocks through (with host-resident
                   nodes for the kv tier)
  kvtier.py        the host KV tier: host copies of evicted blocks and
                   the session cache over ``ckpt/``
  engine.py        FIFO admit / prefill / step / retire scheduler (with
                   prefix sharing, speculative decoding, per-request
                   sampling, the request lifecycle, the burn monitor,
                   the cost book, the kv tier, priority preemption,
                   snapshots, retry and quarantine, the decode-health
                   breaker and slot leases, recorded by the obs plane)
                   and the ``serve`` measured patterns, with the
                   fleet prefix store's publish/fetch/prewarm hooks
  router.py        the prefix-aware consistent-hash router of the fleet
  store.py         the fleet prefix store: one atomic npz a block
  elastic.py       the elastic fleet's scale-out/scale-in policy
  replica.py       ``serve --replicas N``: N engine processes behind the
                   router, with fail-over, drain, the elastic reserve
                   and the fleet's obs shipping, and its three Records
"""
