"""perf/ — the performance observatory, counterpart of
``tpu_patterns/perf/``.

  provenance.py  run_id + git SHA + env fingerprint stamped into every
                 Record and snapshot, so artifacts of different runs
                 join across time
  analytic.py    closed-form FLOP / HBM-byte floors of the entry
                 points (pure functions of the model config)
  registry.py    the executable registry: median-of-k measured times a
                 ported entry point, its analytic floors, and the
                 roofline position against the card's datasheet peaks
  history.py     one snapshot a run appended under the port's store,
                 and the timeline of snapshots and Records
  baseline.py    the ratchet: the committed ``perf/baseline.json`` with
                 noise-aware bands a metric class, gated by ``perf
                 diff`` (through ``core/ratchet.py``)
  report.py      the per-executable roofline table and the trajectory

This ``__init__`` stays light (provenance only): ``registry`` pulls in
the model stack and is imported at the call site, so stamping a Record
never costs a model import.
"""

from __future__ import annotations

from tpu_patterns_torch.perf.provenance import (  # noqa: F401
    RunStamp,
    current_stamp,
    mesh_fingerprint,
    new_run,
    stamp_dict,
)
