"""Model math: transformer params and projections, decode attention and
KV quantization, the LM token boundary with its seeded sampler
(``prng.py``: threefry as ``jax.random`` draws it), the one-device train
step and the flagship workload."""
