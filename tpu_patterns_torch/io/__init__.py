"""Input pipeline: the native prefetch loader.

Batches are synthesized by C++ producer threads (``io/csrc/loader.cc``)
into a ring of host buffers ahead of the device, and cross into numpy as
zero-copy views.  Deterministic and seekable, so it composes with
checkpoint/resume.
"""

from tpu_patterns_torch.io.loader import NativeLoader, fill_reference

__all__ = ["NativeLoader", "fill_reference"]
