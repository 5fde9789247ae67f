"""Model math: transformer params and projections, decode attention and
KV quantization, the LM token boundary, the one-device train step and
the flagship workload."""
