"""Host layer: timing (clocks, device barrier, CUDA events) and results
(Record, Verdict, ResultWriter)."""
