"""Host layer: timing (clocks, device barrier, CUDA events), results
(Record, Verdict, ResultWriter) and config (defaults < environment <
CLI)."""
