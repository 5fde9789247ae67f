"""Model math: transformer params and projections, decode attention and
KV quantization, the LM token boundary with its seeded samplers
(``prng.py``: threefry as ``jax.random`` draws it), the one-device train
step and the flagship workload, the long-context ``decode`` pattern
(``decode.py``) and the token LM's ``lm`` pattern (``lm.py``)."""
