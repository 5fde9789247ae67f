"""Model math of the serve path: transformer params and projections,
decode attention and KV quantization, the LM token boundary."""
